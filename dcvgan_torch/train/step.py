"""The DCVGAN generator bundle and its eval-mode sampling.

Counterpart of ``DCVGAN.__init__``/``init_state``/``sample_videos`` in
``dcvgan_tpu/train/step.py``. The critics, losses and the train step arrive
with the training slice.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional, Tuple, Union

import torch

from dcvgan_torch import prng
from dcvgan_torch.compat.from_jax import cgen_from_jax, ggen_from_jax, read_weights_npz
from dcvgan_torch.config import ExperimentConfig
from dcvgan_torch.models.cgen import ColorVideoGenerator
from dcvgan_torch.models.ggen import GeometricVideoGenerator
from dcvgan_torch.models.layers import cast_for_compute
from dcvgan_torch.train.state import GeneratorState
from dcvgan_torch.utils.device import resolve_device


class Latents(NamedTuple):
    """Every random draw of one sampling round."""

    z_content: torch.Tensor  # (B, dim_z_content)
    e: torch.Tensor  # (B, T, dim_z_motion), GRU input noise
    h0: torch.Tensor  # (B, dim_z_motion), GRU initial state
    z_color: torch.Tensor  # (B, dim_z_color)


class DCVGAN:
    """The two generators built from a config, on one device.

    ``device`` defaults to ``cuda`` and raises without one; pass ``"cpu"``
    to run on the CPU. The compute dtype is bfloat16 when
    ``trainer.precision`` is ``bfloat16``, else float32.
    """

    def __init__(
        self,
        config: ExperimentConfig,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if config.trainer.norm != "batch":
            raise NotImplementedError(
                f"trainer.norm={config.trainer.norm!r} is not ported yet"
            )
        self.config = config
        self.device = resolve_device(device)
        self.dtype = (
            torch.bfloat16 if config.trainer.precision == "bfloat16" else torch.float32
        )
        self.geometric_info = config.geometric_info.name

    def _build(self) -> Tuple[GeometricVideoGenerator, ColorVideoGenerator]:
        cfg = self.config
        gi = cfg.geometric_info
        ggen = GeometricVideoGenerator(
            dim_z_content=cfg.ggen.dim_z_content,
            dim_z_motion=cfg.ggen.dim_z_motion,
            channel=gi.channel,
            geometric_info=gi.name,
            ngf=cfg.ggen.ngf,
            video_length=cfg.video_length,
            image_size=cfg.image_size,
        )
        cgen = ColorVideoGenerator(
            in_ch=gi.channel,
            dim_z=cfg.cgen.dim_z_color,
            geometric_info=gi.name,
            ngf=cfg.cgen.ngf,
            video_length=cfg.video_length,
            image_size=cfg.image_size,
        )
        return ggen, cgen

    def _place(self, module: torch.nn.Module) -> torch.nn.Module:
        return cast_for_compute(module, self.device, self.dtype).eval()

    def init_state(self, seed: int) -> GeneratorState:
        """Fresh generators with the reference init, seeded from ``seed``."""
        ggen, cgen = self._build()
        gen = prng.named(prng.base_key(seed), "params_init")
        ggen.reset_parameters(prng.for_step(gen, 0))
        cgen.reset_parameters(prng.for_step(gen, 1))
        return GeneratorState(ggen=self._place(ggen), cgen=self._place(cgen))

    def load_state(self, path: Union[str, Path]) -> GeneratorState:
        """Generators (and their EMA, when the file has one) from a weights
        npz written from a JAX state; see ``compat/from_jax.py``."""
        trees = read_weights_npz(path)
        ggen, cgen = self._build()
        convert = {"ggen": ggen_from_jax, "cgen": cgen_from_jax}
        modules = {"ggen": ggen, "cgen": cgen}
        ema = {}
        for name, module in modules.items():
            t = trees[name]
            module.load_state_dict(convert[name](t["params"], t["batch_stats"]))
            self._place(module)
            if "ema" in t:
                avg = convert[name](t["ema"], t["batch_stats"])
                ema[name] = {
                    k: avg[k].to(device=p.device, dtype=p.dtype)
                    for k, p in module.named_parameters()
                }
        if ema and set(ema) != set(modules):
            raise ValueError("a weights file carries an EMA of both generators or neither")
        return GeneratorState(ggen=ggen, cgen=cgen, ema=ema or None)

    def sample_latents(self, gen: torch.Generator, batchsize: int) -> Latents:
        """Draw one round's latents, all N(0, 1): ``z_content``, ``e`` and
        ``h0`` in that order from ``gen``'s "ggen_motion" stream, ``z_color``
        from its "cgen_color" stream, on ``gen``'s device."""
        cfg = self.config
        b, t = batchsize, cfg.video_length
        kg = prng.named(gen, "ggen_motion")
        kc = prng.named(gen, "cgen_color")

        def draw(g, *shape):
            return torch.randn(*shape, generator=g, device=g.device)

        z_content = draw(kg, b, cfg.ggen.dim_z_content)
        e = draw(kg, b, t, cfg.ggen.dim_z_motion)
        h0 = draw(kg, b, cfg.ggen.dim_z_motion)
        return Latents(z_content, e, h0, draw(kc, b, cfg.cgen.dim_z_color))

    def sample_videos(
        self,
        state: GeneratorState,
        gen: Optional[torch.Generator],
        batchsize: int,
        latents: Optional[Latents] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample (geometry, colour) videos ``(B, T, H, W, C)`` in [-1, 1].

        Always eval mode (running BatchNorm statistics, no dropout). The
        latents come from ``gen`` (a generator on ``self.device``) unless
        they are given.
        """
        if latents is None:
            latents = self.sample_latents(gen, batchsize)
        latents = Latents(*(t.to(self.device) for t in latents))
        with torch.inference_mode():
            xg = state.ggen(latents.z_content, latents.e, latents.h0)
            xc = state.cgen.forward_videos(xg, latents.z_color)
        return xg, xc
