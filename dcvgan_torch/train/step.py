"""The DCVGAN model bundle: sampling and the training iteration.

Counterpart of ``dcvgan_tpu/train/step.py``. One training iteration is

    ``train_step(state, batch, key) -> (state, metrics)``

run eagerly on one device; ``state`` is updated in place. The semantics are
the JAX step's at its parity defaults:

- the batch is ingested on the device: uint8 colour and depth together
  through one :func:`dequantize_videos` launch, uint8 segmentation labels
  to a one-hot, float16 flow and floats by a cast to the compute dtype;
- D phase: fakes drawn from the ``d_fake`` stream in train mode carry no
  gradient and write no generator statistics; each critic sees the real
  batch, then the fakes, and its running BatchNorm statistics advance over
  both, in that order; the three critics step when
  ``step % num_gen_update == 0`` (the reference's inverted names), with
  1-based steps;
- G phase: fresh fakes from the ``g_fake`` stream against the *updated*
  critics, whose forwards use batch statistics and write none; the
  generators' running statistics come from this phase only; both step when
  ``step % num_dis_update == 0``;
- one random frame index ``t_rand`` serves the image critic in both phases;
- a shut gate leaves Adam's state alone, while statistics still advance;
- the EMA of the generator parameters advances when the generators step.

Parameters, gradients and Adam's moments are float32; the forward and
backward passes run in the compute dtype (``models/layers.py``). The step
never synchronises with the host: its metrics are 0-dim device tensors.
Every random draw can be handed in (:class:`StepDraws`), so that a test can
feed this step and the JAX step the same numbers.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dcvgan_torch import prng
from dcvgan_torch.compat.from_jax import FROM_JAX, read_weights_npz
from dcvgan_torch.config import ExperimentConfig, OptimizerConfig
from dcvgan_torch.losses import get_loss
from dcvgan_torch.models.cgen import ColorVideoGenerator
from dcvgan_torch.models.discriminators import (
    GradientDiscriminator,
    ImageDiscriminator,
    VideoDiscriminator,
)
from dcvgan_torch.models.ggen import GeometricVideoGenerator
from dcvgan_torch.models.layers import cast_for_compute, place_for_training
from dcvgan_torch.ops.dequant import dequantize_video, dequantize_videos
from dcvgan_torch.train.state import (
    GENERATOR_NAMES,
    MODEL_NAMES,
    GANState,
    GeneratorState,
    _copy_params,
)
from dcvgan_torch.utils.device import resolve_device

NUM_SEGM_PARTS = 25
CRITIC_NAMES = ("idis", "vdis", "gdis")
NoiseDraws = Optional[Mapping[str, torch.Tensor]]


class Latents(NamedTuple):
    """Every random draw of one sampling round."""

    z_content: torch.Tensor  # (B, dim_z_content)
    e: torch.Tensor  # (B, T, dim_z_motion), GRU input noise
    h0: torch.Tensor  # (B, dim_z_motion), GRU initial state
    z_color: torch.Tensor  # (B, dim_z_color)


@dataclass
class StepDraws:
    """The random draws of one train step. An entry left ``None`` is drawn
    from the step's generator; a test fills them all.

    ``d_noise[critic]`` is ``{"real": draws, "fake": draws}`` and
    ``g_noise[critic]`` is ``draws``, where ``draws`` maps a Noise layer's
    name to its unit-normal tensor (``models/discriminators.py``). The
    dropout entries are the two keep masks of the colour generator.
    """

    t_rand: Optional[int] = None
    d_latents: Optional[Latents] = None
    g_latents: Optional[Latents] = None
    d_dropout: Optional[Sequence[torch.Tensor]] = None
    g_dropout: Optional[Sequence[torch.Tensor]] = None
    d_noise: Optional[Mapping[str, Mapping[str, NoiseDraws]]] = None
    g_noise: Optional[Mapping[str, NoiseDraws]] = None


def make_optimizer(cfg: OptimizerConfig, params) -> torch.optim.Adam:
    """Adam with coupled weight decay, added to the gradient before the
    moment updates, on every parameter (BatchNorm's too): what optax's
    ``add_decayed_weights -> scale_by_adam -> scale(-lr)`` computes."""
    return torch.optim.Adam(
        params, lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=cfg.eps, weight_decay=cfg.decay
    )


class DCVGAN:
    """The five models built from a config, on one device.

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
        self.loss = get_loss(config.loss)

    def _build(self, name: str) -> torch.nn.Module:
        cfg = self.config
        gi = cfg.geometric_info
        if name == "ggen":
            return GeometricVideoGenerator(
                dim_z_content=cfg.ggen.dim_z_content,
                dim_z_motion=cfg.ggen.dim_z_motion,
                channel=gi.channel,
                geometric_info=gi.name,
                ngf=cfg.ggen.ngf,
                video_length=cfg.video_length,
                image_size=cfg.image_size,
            )
        if name == "cgen":
            return ColorVideoGenerator(
                in_ch=gi.channel,
                dim_z=cfg.cgen.dim_z_color,
                geometric_info=gi.name,
                ngf=cfg.cgen.ngf,
                video_length=cfg.video_length,
                image_size=cfg.image_size,
            )
        critic = {
            "idis": ImageDiscriminator, "vdis": VideoDiscriminator, "gdis": GradientDiscriminator,
        }[name]
        c = getattr(cfg, name)
        return critic(
            ch_g=gi.channel, ch_c=3, use_noise=c.use_noise, noise_sigma=c.noise_sigma, ndf=c.ndf
        )

    def init_state(self, seed: int) -> GANState:
        """Fresh models with the reference init, seeded from ``seed``, their
        optimizers, and the EMA seeded at the generators' init values when
        ``trainer.ema_decay > 0``."""
        gen = prng.named(prng.base_key(seed), "params_init")
        models, opt = {}, {}
        for i, name in enumerate(MODEL_NAMES):
            module = self._build(name)
            module.reset_parameters(prng.for_step(gen, i))
            models[name] = place_for_training(module, self.device, self.dtype)
            opt[name] = make_optimizer(getattr(self.config, name).optimizer, module.parameters())
        ema = None
        if self.config.trainer.ema_decay > 0:
            ema = {name: _copy_params(models[name]) for name in GENERATOR_NAMES}
        return GANState(opt=opt, step=0, ema=ema, **models)

    def load_state(self, path: Union[str, Path]) -> GeneratorState:
        """Generators (and their EMA, when the file has one) for serving,
        from a weights npz written from a JAX state; see
        ``compat/from_jax.py``."""
        trees = read_weights_npz(path)
        modules, ema = {}, {}
        for name in GENERATOR_NAMES:
            t = trees[name]
            module = self._build(name)
            module.load_state_dict(FROM_JAX[name](t["params"], t["batch_stats"]))
            modules[name] = cast_for_compute(module, self.device, self.dtype)
            if "ema" in t:
                avg = copy.deepcopy(module)
                avg.load_state_dict(FROM_JAX[name](t["ema"], t["batch_stats"]))
                ema[name] = {
                    k: p.detach().to(q.dtype)
                    for (k, p), q in zip(avg.named_parameters(), module.parameters())
                }
        if ema and set(ema) != set(modules):
            raise ValueError("a weights file carries an EMA of both generators or neither")
        return GeneratorState(ggen=modules["ggen"], cgen=modules["cgen"], ema=ema or None)

    # ------------------------------------------------------------- sampling
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
        state: Union[GeneratorState, GANState],
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

    # ------------------------------------------------------------ train step
    def _refuse_levers(self) -> None:
        """The opt-in levers and the multi-device layouts are not ported."""
        cfg = self.config
        t = cfg.trainer
        on = [
            f"trainer.{k}" for k in
            ("shared_fakes", "critic_joint_batch", "critic_stat_reuse", "remat", "ggen_double_step")
            if getattr(t, k)
        ]
        if not t.sync_batchnorm:
            on.append("trainer.sync_batchnorm=false")
        if cfg.mesh.data not in (-1, 1):
            on.append("mesh.data")
        on += [f"mesh.{k}" for k in ("time", "dcn") if getattr(cfg.mesh, k) > 1]
        if on:
            raise NotImplementedError(f"not ported yet: {', '.join(on)}")

    def ingest(self, batch: Mapping[str, Union[torch.Tensor, np.ndarray]]) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(xg_real, xc_real)`` in the compute dtype on the device, from a
        loader batch ``{"color": ..., <geometric_info>: ...}``."""

        def on_device(x):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            return x.to(self.device, non_blocking=True)

        def ingest(x):
            if x.dtype == torch.uint8:
                return dequantize_video(x, self.dtype)
            return x.to(self.dtype)

        xc = on_device(batch["color"])
        xg = on_device(batch[self.geometric_info])
        if self.geometric_info == "segmentation" and xg.dtype == torch.uint8:
            # raw class labels -> one-hot; a label outside the range gives an
            # all-zero row, as in the JAX package
            classes = torch.arange(NUM_SEGM_PARTS, device=xg.device, dtype=torch.uint8)
            return (xg[..., :1] == classes).to(self.dtype), ingest(xc)
        if xc.dtype == torch.uint8 and xg.dtype == torch.uint8:
            # both batches in one kernel launch
            xc, xg = dequantize_videos([xc, xg], self.dtype)
            return xg, xc
        return ingest(xg), ingest(xc)

    def train_step(
        self,
        state: GANState,
        batch: Mapping[str, Union[torch.Tensor, np.ndarray]],
        key: torch.Generator,
        draws: Optional[StepDraws] = None,
    ) -> Tuple[GANState, Dict[str, torch.Tensor]]:
        """One full GAN iteration (see the module docstring); ``state`` is
        updated in place and returned. ``key`` is the run's base generator:
        the step's streams derive from it and the 1-based step number.
        Gradients stay on the parameters' ``.grad`` until the next step."""
        self._refuse_levers()
        cfg = self.config
        draws = draws or StepDraws()
        step = state.step + 1
        kstep = prng.on_device(prng.for_step(key, step), self.device)

        xg_real, xc_real = self.ingest(batch)
        b = xc_real.shape[0]

        t_rand = draws.t_rand
        if t_rand is None:
            # drawn on the host: indexing with a device scalar would synchronise
            host = prng.on_device(prng.named(kstep, "t_rand"), "cpu")
            t_rand = int(torch.randint(0, cfg.video_length, (), generator=host))

        def frame(x: torch.Tensor) -> torch.Tensor:
            return x[:, t_rand]

        def fakes(k: torch.Generator, latents, dropout, update_stats: bool):
            if latents is None:
                latents = self.sample_latents(k, b)
            latents = Latents(*(t.to(self.device) for t in latents))
            xg_f = state.ggen(
                latents.z_content, latents.e, latents.h0, train=True, update_stats=update_stats
            )
            xc_f = state.cgen.forward_videos(
                xg_f, latents.z_color, train=True, update_stats=update_stats,
                dropout_masks=dropout, generator=prng.named(k, "cgen_dropout"),
            )
            return xg_f, xc_f

        def critic(name, xg, xc, update_stats, noise, k):
            if name == "idis":
                xg, xc = frame(xg), frame(xc)
            return getattr(state, name)(
                xg, xc, train=True, update_stats=update_stats, noise=noise, generator=k
            )

        # ------------------------------------------------ phase discriminator
        with torch.no_grad():
            xg_fake, xc_fake = fakes(
                prng.named(kstep, "d_fake"), draws.d_latents, draws.d_dropout, False
            )
        d_losses = {}
        for name in CRITIC_NAMES:
            nkey = prng.named(kstep, f"{name}_noise")
            given = (draws.d_noise or {}).get(name, {})
            # real, then fake: the running statistics advance over both in turn
            y_real = critic(name, xg_real, xc_real, True, given.get("real"), prng.named(nkey, "d_fake"))
            y_fake = critic(name, xg_fake, xc_fake, True, given.get("fake"), prng.named(nkey, "g_fake"))
            d_losses[name] = self.loss.dis(y_real, y_fake)
        d_params = [p for name in CRITIC_NAMES for p in getattr(state, name).parameters()]
        d_total = d_losses["idis"] + d_losses["vdis"] + d_losses["gdis"]
        for p, g in zip(d_params, torch.autograd.grad(d_total, d_params)):
            p.grad = g
        if step % cfg.num_gen_update == 0:
            for name in CRITIC_NAMES:
                state.opt[name].step()

        # ---------------------------------------------------- phase generator
        kg = prng.named(kstep, "g_fake")
        xg_f, xc_f = fakes(kg, draws.g_latents, draws.g_dropout, True)
        g_noise = draws.g_noise or {}
        y = [
            critic(name, xg_f, xc_f, False, g_noise.get(name), prng.named(kg, f"{name}_noise"))
            for name in CRITIC_NAMES
        ]
        loss_gen = self.loss.gen(*y)
        g_params = [p for name in GENERATOR_NAMES for p in getattr(state, name).parameters()]
        g_grads = torch.autograd.grad(loss_gen, g_params, allow_unused=True)
        for p, g in zip(g_params, g_grads):
            p.grad = g if g is not None else torch.zeros_like(p)
        if step % cfg.num_dis_update == 0:
            for name in GENERATOR_NAMES:
                state.opt[name].step()
            if state.ema is not None:
                self._advance_ema(state)

        state.step = step
        metrics = {f"loss_{name}": d_losses[name].detach() for name in CRITIC_NAMES}
        metrics["loss_gen"] = loss_gen.detach()
        return state, metrics

    def _advance_ema(self, state: GANState) -> None:
        """``ema = ema * decay + params * (1 - decay)``, in float32."""
        decay = np.float32(self.config.trainer.ema_decay)
        rest = float(np.float32(1.0) - decay)
        with torch.no_grad():
            for name in GENERATOR_NAMES:
                avg = state.ema[name]
                names, params = zip(*getattr(state, name).named_parameters())
                averages = [avg[k] for k in names]
                torch._foreach_mul_(averages, float(decay))
                torch._foreach_add_(averages, [p.detach() for p in params], alpha=rest)
