"""Checkpoints of the whole training state, with resume.

Counterpart of ``dcvgan_tpu/train/checkpoint.py`` in torch's own format (the
JAX package's Orbax layout is not reproduced). One file per step,
``<directory>/step_<N>.pt``, holds every model's state dict (parameters and
BatchNorm statistics, which a GroupNorm model does not have), every
optimizer's state, the step and the EMA. A
file is written to a temporary name and moved into place with
``os.replace``, so a reader sees all of it or none.
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path
from typing import List, Optional, Union

import torch

from dcvgan_torch.train.state import GENERATOR_NAMES, GANState

_STEP_FILE = re.compile(r"step_(\d+)\.pt")


class CheckpointManager:
    def __init__(self, directory: Union[str, Path]):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def all_steps(self) -> List[int]:
        found = (_STEP_FILE.fullmatch(p.name) for p in self.directory.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: GANState, force: bool = False) -> None:
        """Write ``state`` under its step; a step already on disk is left as
        it is (an interval save and the final save can collide). ``force``
        is accepted for the JAX manager's signature: every save here is
        unconditional and complete when it returns."""
        del force
        step = int(state.step)
        path = self._path(step)
        if path.exists():
            return
        payload = {
            "step": step,
            "models": {name: m.state_dict() for name, m in state.models.items()},
            "opt": {name: o.state_dict() for name, o in state.opt.items()},
            "ema": state.ema,
        }
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def restore(self, template: GANState, step: Optional[int] = None) -> GANState:
        """Load a checkpoint into ``template`` (in place) and return it.

        EMA transitions:

        - ``template`` has an EMA and the file has none (EMA newly enabled on
          an existing run): the EMA is seeded at the restored generators.
        - ``template`` has none and the file has one (EMA disabled mid-run):
          the stored average is dropped with a warning.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        if step not in self.all_steps():
            raise FileNotFoundError(
                f"no checkpoint for step {step} under {self.directory}; "
                f"available steps: {self.all_steps()}"
            )
        device = next(template.ggen.parameters()).device
        payload = torch.load(self._path(step), map_location=device, weights_only=True)
        for name, module in template.models.items():
            module.load_state_dict(payload["models"][name])
            template.opt[name].load_state_dict(payload["opt"][name])
        template.step = int(payload["step"])
        disk_ema = payload.get("ema")
        if template.ema is None:
            if disk_ema is not None:
                logging.getLogger(__name__).warning(
                    "checkpoint step %d carries an EMA but EMA is disabled in "
                    "the config; dropping the stored average", step,
                )
        elif disk_ema is None:
            template.with_reseeded_ema()
        else:
            template.ema = {name: dict(disk_ema[name]) for name in GENERATOR_NAMES}
        return template
