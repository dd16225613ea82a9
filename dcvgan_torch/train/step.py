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

The JAX step's opt-in levers (``trainer.*``), each with its semantics and
stream names, so that an undrawn step replays from its key:

- ``shared_fakes``: one generator forward a step, from the ``g_fake``
  stream, with a graph and the generators' statistics written; the D phase
  sees it detached, the G phase's critics take it undetached and the
  generator gradient flows back through that one graph. There is no
  ``d_fake`` generator forward;
- ``critic_joint_batch``: each critic runs once in the D phase, on
  ``[real; fake]`` (batch 2B), so its statistics advance once, over the
  joint batch; its noise comes from the ``joint`` stream;
- ``critic_stat_reuse``: the G phase's critics run in eval mode, on the
  running statistics the D phase has just advanced, and write none (their
  Noise applies all the same);
- ``remat``: every generator forward that carries a graph is recomputed in
  the backward (``torch.utils.checkpoint``), ggen and cgen each on its own,
  as ``jax.checkpoint`` wraps them. The dropout masks are drawn before the
  checkpointed region and the recompute writes no statistics, so the step
  equals the step without it;
- ``ggen_double_step``: ggen's Adam steps twice on the same gradient (the
  second weight decay on the updated parameters), cgen once, the EMA once;
- ``trainer.norm: group``: every model's BatchNorms become
  :class:`ChannelGroupNorm` (``models/layers.py``).

**Data parallelism** (``parallel/mesh.py``): given a :class:`Layout` of W
ranks, each rank runs this step on its rows of the global batch and the
ranks reduce explicitly, in one SUM all-reduce of one flat buffer per
optimizer update, before Adam's step (``pmean`` precedes the optax chain):

- ``trainer.sync_batchnorm: true`` (the JAX ``jitted_train_step`` on a
  data-sharded batch): every BatchNorm takes the global batch's statistics
  (``models/layers.py``); each rank draws the *global* batch's latents,
  critic noise and dropout masks from the step's generators and keeps its
  rows, so W ranks at batch B compute what one rank computes at batch B.
  The gradients and the losses are averaged;
- ``trainer.sync_batchnorm: false`` (``sharded_train_step``, per-replica
  statistics): BatchNorm is local, each rank's fakes and noise come from
  its own stream, ``fold_in(step generator, rank)``, while ``t_rand`` and
  the gates stay shared; the gradients, the running statistics and the
  losses are averaged where the JAX step ``pmean``s them: after the D
  phase for the critics, after the G phase for the generators.

The EMA needs no collective: the parameters stay replica-identical.

**Time sharding** (``mesh.time > 1``, the JAX ``time_sharded_train_step``):
the layout's ``time`` ranks of a data row hold the row's batch; ingest, the
generators and the image critic run on it on every one of them, and the
video and gradient critics take the rank's ``T / time`` frames of the real
and fake clips and run time-sharded (``models/discriminators.py``), so
every time rank gets the row's whole logits and the row's losses. It needs
global-batch statistics (``trainer.sync_batchnorm: true``); the
generators' and image critic's BatchNorms sum over every rank, which counts
each row ``time`` times in both the sums and the count, so their
statistics are the row-deduplicated ones. The gradients are averaged over
all ``dcn * data * time`` ranks in the one all-reduce: each collective's
backward passes every rank's share, and the ranks' summed gradient is
``time`` times the sum over the rows, so the average is the unsharded
step's gradient.

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
import torch.utils.checkpoint

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
from dcvgan_torch.models.layers import (
    RowsOfBatch,
    cast_for_compute,
    place_for_training,
    running_statistics,
    sync_batch_norms,
)
from dcvgan_torch.ops.dequant import dequantize_video, dequantize_videos
from dcvgan_torch.parallel.mesh import SINGLE, Layout, all_reduce_mean_
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

    ``d_noise[critic]`` is ``{"real": draws, "fake": draws}``, or
    ``{"joint": draws}`` for the 2B batch under ``critic_joint_batch``, and
    ``g_noise[critic]`` is ``draws``, where ``draws`` maps a Noise layer's
    name to its unit-normal tensor (``models/discriminators.py``). The
    dropout entries are the two keep masks of the colour generator. Under
    ``shared_fakes`` the ``d_latents`` and ``d_dropout`` are not used.

    Under data parallelism with global-batch statistics the draws are the
    global batch's (every rank is handed the same) and the step keeps its
    rows; with per-replica statistics they are this rank's own.
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
    ``trainer.precision`` is ``bfloat16``, else float32. ``layout`` places
    this process among the data-parallel ranks (one rank by default).
    """

    def __init__(
        self,
        config: ExperimentConfig,
        device: Optional[Union[str, torch.device]] = None,
        layout: Layout = SINGLE,
    ):
        self.config = config
        self.layout = layout
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
                norm=cfg.trainer.norm,
            )
        if name == "cgen":
            return ColorVideoGenerator(
                in_ch=gi.channel,
                dim_z=cfg.cgen.dim_z_color,
                geometric_info=gi.name,
                ngf=cfg.cgen.ngf,
                video_length=cfg.video_length,
                image_size=cfg.image_size,
                norm=cfg.trainer.norm,
            )
        critic = {
            "idis": ImageDiscriminator, "vdis": VideoDiscriminator, "gdis": GradientDiscriminator,
        }[name]
        c = getattr(cfg, name)
        return critic(
            ch_g=gi.channel, ch_c=3, use_noise=c.use_noise, noise_sigma=c.noise_sigma, ndf=c.ndf,
            norm=cfg.trainer.norm,
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
            if self.global_batch:
                sync_batch_norms(module)
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
            stats = t.get("batch_stats", {})  # none under norm: group
            module = self._build(name)
            module.load_state_dict(FROM_JAX[name](t["params"], stats))
            modules[name] = cast_for_compute(module, self.device, self.dtype)
            if "ema" in t:
                avg = copy.deepcopy(module)
                avg.load_state_dict(FROM_JAX[name](t["ema"], stats))
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
    @property
    def global_batch(self) -> bool:
        """Whether the step's statistics and draws span every rank's rows."""
        return self.config.trainer.sync_batchnorm and self.layout.world > 1

    def _refuse_levers(self) -> None:
        """Raises for the settings the step does not take: ``mesh.time > 1``
        without ``time_sharded_train_step``'s conditions (its error texts),
        or on a layout without those time ranks (``trainer.norm: group``
        under ``mesh.time > 1`` fails the config's validation, as in JAX)."""
        cfg, lay = self.config, self.layout
        if cfg.mesh.time == 1 and lay.time == 1:
            return
        if not cfg.trainer.sync_batchnorm:
            raise ValueError("mesh.time > 1 requires trainer.sync_batchnorm=true")
        if cfg.mesh.dcn > 1 or lay.dcn > 1:
            raise NotImplementedError(
                "mesh.time > 1 with mesh.dcn > 1 is not supported: the "
                "time-sharded critics' inner shard_map would need the dcn "
                "axis threaded through its halo exchange"
            )
        if lay.time != cfg.mesh.time:
            raise ValueError(
                f"mesh.time={cfg.mesh.time} but this process's layout has {lay.time} "
                f"time ranks: launch dcn*data*time ranks and build the layout "
                f"with create_layout(config)"
            )
        # the critics' own checks, before the step computes anything
        t = cfg.video_length
        if t % lay.time:
            raise ValueError(f"T={t} not divisible by time axis {lay.time}")
        if t // lay.time < 3:
            raise ValueError(
                f"local time extent {t // lay.time} < halo 3; use fewer time shards"
            )

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
        lever = cfg.trainer
        lay = self.layout
        draws = draws or StepDraws()
        step = state.step + 1
        kstep = prng.on_device(prng.for_step(key, step), self.device)
        # per-replica statistics: this rank's own fakes and noise
        klocal = kstep if lever.sync_batchnorm else prng.fold_in(kstep, lay.rank)

        xg_real, xc_real = self.ingest(batch)
        b = xc_real.shape[0]
        # under global-batch statistics every draw is the global batch's, of
        # which this rank keeps ``rows``; else the draws are this rank's
        wide = self.global_batch
        n = b * lay.dcn * lay.data if wide else b
        rows = lay.rows(b, device=self.device) if wide else None
        t_local = cfg.video_length // lay.time
        t0 = lay.time_index * t_local

        t_rand = draws.t_rand
        if t_rand is None:
            # drawn on the host: indexing with a device scalar would synchronise
            host = prng.on_device(prng.named(kstep, "t_rand"), "cpu")
            t_rand = int(torch.randint(0, cfg.video_length, (), generator=host))

        def frame(x: torch.Tensor) -> torch.Tensor:
            return x[:, t_rand]

        def fakes(k: torch.Generator, latents, dropout, update_stats: bool):
            """A train-mode generator forward from stream ``k``. Under
            ``remat`` (only where it carries a graph) each generator is
            recomputed in the backward."""
            if latents is None:
                latents = self.sample_latents(k, n)
            z_content, e, h0, z_color = (t.to(self.device) for t in latents)
            if dropout is None:
                dropout = state.cgen.dropout_masks(
                    n * cfg.video_length, prng.named(k, "cgen_dropout"), self.device
                )
            if wide:
                z_content, e, h0, z_color = (t[rows] for t in (z_content, e, h0, z_color))
                dropout = [m.view(n, cfg.video_length, -1)[rows].reshape(b * cfg.video_length, -1)
                           for m in dropout]

            def ggen(update_stats):
                return state.ggen(z_content, e, h0, train=True, update_stats=update_stats)

            def cgen(update_stats, xg):
                return state.cgen.forward_videos(
                    xg, z_color, train=True, update_stats=update_stats, dropout_masks=dropout
                )

            if lever.remat and torch.is_grad_enabled():
                ggen, cgen = _recomputed(ggen), _recomputed(cgen)
            xg_f = ggen(update_stats)
            return xg_f, cgen(update_stats, xg_f)

        def critic(name, xg, xc, train, update_stats, noise, k, parts=1):
            if name == "idis":
                xg, xc = frame(xg), frame(xc)
            elif lay.time > 1:
                # this rank's frames; the critic draws its noise at the
                # unsharded shape and keeps its frames
                xg, xc = xg[:, t0: t0 + t_local], xc[:, t0: t0 + t_local]
            if wide:
                own = rows if parts == 1 else lay.rows(b, parts, self.device)
                noise = {layer: d[own] for layer, d in noise.items()} if noise else None
                k = RowsOfBatch(k, own, parts * n)
            return getattr(state, name)(
                xg, xc, train=train, update_stats=update_stats, noise=noise, generator=k,
                layout=None if name == "idis" else lay,
            )

        # ------------------------------------------------ phase discriminator
        kg = prng.named(klocal, "g_fake")
        if lever.shared_fakes:
            # the step's one generator forward; the G phase pulls its
            # gradient back through this graph
            xg_f, xc_f = fakes(kg, draws.g_latents, draws.g_dropout, True)
            xg_fake, xc_fake = xg_f.detach(), xc_f.detach()
        else:
            with torch.no_grad():
                xg_fake, xc_fake = fakes(
                    prng.named(klocal, "d_fake"), draws.d_latents, draws.d_dropout, False
                )
        if lever.critic_joint_batch:
            xg_joint = torch.cat([xg_real, xg_fake])
            xc_joint = torch.cat([xc_real, xc_fake])
        d_losses = {}
        for name in CRITIC_NAMES:
            nkey = prng.named(klocal, f"{name}_noise")
            given = (draws.d_noise or {}).get(name, {})
            if lever.critic_joint_batch:
                # one forward on [real; fake]: the statistics advance once
                y = critic(name, xg_joint, xc_joint, True, True, given.get("joint"),
                           prng.named(nkey, "joint"), parts=2)
                y_real, y_fake = y[:b], y[b:]
            else:
                # real, then fake: the running statistics advance over both in turn
                y_real = critic(name, xg_real, xc_real, True, True, given.get("real"),
                                prng.named(nkey, "d_fake"))
                y_fake = critic(name, xg_fake, xc_fake, True, True, given.get("fake"),
                                prng.named(nkey, "g_fake"))
            d_losses[name] = self.loss.dis(y_real, y_fake)
        d_params = [p for name in CRITIC_NAMES for p in getattr(state, name).parameters()]
        d_total = d_losses["idis"] + d_losses["vdis"] + d_losses["gdis"]
        d_grads = list(torch.autograd.grad(d_total, d_params))
        d_metrics = torch.stack([d_losses[name].detach() for name in CRITIC_NAMES])
        self._average(d_grads + [d_metrics], state, CRITIC_NAMES)
        for p, g in zip(d_params, d_grads):
            p.grad = g
        if step % cfg.num_gen_update == 0:
            for name in CRITIC_NAMES:
                state.opt[name].step()

        # ---------------------------------------------------- phase generator
        if not lever.shared_fakes:
            xg_f, xc_f = fakes(kg, draws.g_latents, draws.g_dropout, True)
        g_noise = draws.g_noise or {}
        g_train = not lever.critic_stat_reuse
        y = [
            critic(name, xg_f, xc_f, g_train, False, g_noise.get(name),
                   prng.named(kg, f"{name}_noise"))
            for name in CRITIC_NAMES
        ]
        loss_gen = self.loss.gen(*y)
        g_params = [p for name in GENERATOR_NAMES for p in getattr(state, name).parameters()]
        g_grads = [g if g is not None else torch.zeros_like(p) for p, g in zip(
            g_params, torch.autograd.grad(loss_gen, g_params, allow_unused=True))]
        g_metric = loss_gen.detach().reshape(1)
        self._average(g_grads + [g_metric], state, GENERATOR_NAMES)
        for p, g in zip(g_params, g_grads):
            p.grad = g
        if step % cfg.num_dis_update == 0:
            for name in GENERATOR_NAMES:
                state.opt[name].step()
            if lever.ggen_double_step:
                # the reference's second opt_ggen.step() on the same gradient
                state.opt["ggen"].step()
            if state.ema is not None:
                self._advance_ema(state)

        state.step = step
        metrics = {f"loss_{name}": d_metrics[i] for i, name in enumerate(CRITIC_NAMES)}
        metrics["loss_gen"] = g_metric[0]
        return state, metrics

    def _average(self, tensors, state: GANState, names) -> None:
        """``pmean`` over the ranks, in place, in one all-reduce: the
        gradients and losses in ``tensors`` and, under per-replica
        statistics, the running statistics of the models ``names``."""
        if self.layout.world == 1:
            return
        if not self.config.trainer.sync_batchnorm:
            tensors = tensors + [t for name in names for t in running_statistics(getattr(state, name))]
        all_reduce_mean_(tensors, self.layout)

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


def _recomputed(forward):
    """``forward(update_stats, *inputs)`` whose activations are recomputed in
    the backward instead of kept (``torch.utils.checkpoint``, as
    ``jax.checkpoint``). The recompute moves no running statistics: the
    forward did. Every random draw is made before the call, so the
    recompute computes what the forward did."""
    runs = []

    def run(update_stats, *inputs):
        first = not runs
        runs.append(None)
        return forward(update_stats and first, *inputs)

    def call(update_stats, *inputs):
        return torch.utils.checkpoint.checkpoint(
            run, update_stats, *inputs, use_reentrant=False, preserve_rng_state=False
        )

    return call
