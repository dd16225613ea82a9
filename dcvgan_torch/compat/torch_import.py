"""Reference (PyTorch) DCVGAN snapshots into the port.

The reference saves ``<result_dir>/models/<name>_params_<iter:05d>.pth``
state dicts, one per model. The port's modules keep the reference's
state-dict names (Sequential indices, BatchNorm buffers, ``nn.GRUCell``'s
four tensors), so a snapshot loads with ``load_state_dict(strict=True)``;
the GRU cell sums a loaded ``bias_hh``'s r and z parts into its single
r / z bias on the way in (``models/ggen.py``). This is the half of
``dcvgan_tpu/compat/torch_import.py`` that reads the reference's files; the
layout conversions there exist only for flax.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

import torch

from dcvgan_torch.train.state import GANState, MODEL_NAMES

# what a width mismatch of each model points at in the config
CONFIG_KEYS = {
    "ggen": "ggen.ngf, ggen.dim_z_content, ggen.dim_z_motion, geometric_info.channel",
    "cgen": "cgen.ngf, cgen.dim_z_color, geometric_info.channel",
    "idis": "idis.ndf, geometric_info.channel",
    "vdis": "vdis.ndf, geometric_info.channel",
    "gdis": "gdis.ndf, geometric_info.channel",
}


def load_reference_state_dicts(
    models_dir: Union[str, Path], iteration: int
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every ``<name>_params_<iter:05d>.pth`` of a reference run's
    ``models/`` directory, as ``{name: state dict}`` on the CPU (tensors
    only: ``weights_only=True``)."""
    out = {}
    for name in MODEL_NAMES:
        path = Path(models_dir) / f"{name}_params_{iteration:05d}.pth"
        if path.exists():
            out[name] = torch.load(path, map_location="cpu", weights_only=True)
    return out


def load_into_state(state: GANState, state_dicts: Dict[str, Dict[str, torch.Tensor]]) -> GANState:
    """Load reference state dicts into ``state``'s models (strict names and
    shapes); a mismatch raises, naming the model and the config keys that
    set its widths."""
    for name, sd in state_dicts.items():
        try:
            state.models[name].load_state_dict(sd, strict=True)
        except RuntimeError as e:
            raise ValueError(
                f"{name}: the reference weights do not fit the model built from the config; "
                f"check {CONFIG_KEYS[name]}\n{e}"
            ) from e
    return state
