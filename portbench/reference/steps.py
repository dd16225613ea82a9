"""The reference's train steps, sampling rounds and input batches.

Each follows the program's documented semantics and re-derives every draw
the program made inside itself (``streams``), in the program's order, on the
same device type:

- batches: the loader's epoch order ``default_rng((seed, epoch))`` and each
  sample's crop start ``default_rng((seed, epoch, batch, position))``, the
  frames decoded from the tree's files and scaled to [-1, 1] here;
- a train step: the D phase's fakes from the ``d_fake`` stream (no graph),
  each critic on the real batch then the fakes, the three critics' Adam
  steps; then fresh fakes from the ``g_fake`` stream against the updated
  critics and the generators' Adam steps. One frame ``t_rand`` (drawn on
  the host) serves the image critic in both phases. Every forward in a step
  takes batch statistics. Adam is torch's (coupled weight decay, bias
  correction), written out here;
- a sampling round: ggen and cgen in eval mode on the running statistics,
  quantised to uint8 as ``floor((clip(x, -1, 1) + 1) * 127.5)``.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, List, Optional

import cv2
import numpy as np
import torch

from portbench.reference import models, streams
from portbench.reference.models import F32, Arith, NoiseDraws, Stats


@contextlib.contextmanager
def full_f32():
    """Products in float32 with TF32 off, the caller's setting restored."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------- inputs
def clip_list(tree: Path):
    lines = (Path(tree) / "list.txt").read_text().split()
    return [(Path(tree) / lines[i], int(lines[i + 1])) for i in range(0, len(lines), 2)]


def batch_indices(n_clips: int, batchsize: int, seed: int, epoch: int, b: int) -> np.ndarray:
    order = np.arange(n_clips)
    np.random.default_rng((seed, epoch)).shuffle(order)
    return order[b * batchsize: (b + 1) * batchsize]


def read_batch(tree: Path, cfg, seed: int, epoch: int, b: int, device) -> Dict[str, torch.Tensor]:
    """Batch ``b`` of ``epoch`` as the loader orders and crops it, as float32
    ``(B, T, H, W, C)`` on ``device``: colour and the geometry in [-1, 1]
    (flow as its displacement / image size)."""
    clips = clip_list(tree)
    length, gi = cfg.video_length, cfg.geometric_info.name
    color, geo = [], []
    for pos, i in enumerate(batch_indices(len(clips), cfg.batchsize, seed, epoch, b)):
        path, n_frames = clips[i]
        t = int(np.random.default_rng((seed, epoch, b, pos)).integers(0, n_frames - length))
        frames = range(t, t + length)
        color.append(np.stack([_read(path / "color" / f"{j:03d}.jpg", False) for j in frames]))
        if gi == "depth":
            geo.append(np.stack([_read(path / "depth" / f"{j:03d}.jpg", True) for j in frames]))
        elif gi == "optical-flow":
            geo.append(np.load(path / "optical-flow.npy")[t: t + length] / np.float32(cfg.image_size))
        else:
            raise NotImplementedError(f"geometric_info {gi!r}")

    def scaled(x):
        x = np.stack(x)
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / np.float32(127.5) - np.float32(1.0)
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)

    return {"color": scaled(color), gi: scaled(geo)}


def _read(path: Path, gray: bool) -> np.ndarray:
    img = cv2.imread(str(path))
    if img is None:
        raise FileNotFoundError(path)
    if gray:
        return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)[..., None]
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


# ---------------------------------------------------------------- draws
def latents(cfg, k: torch.Generator, batchsize: int):
    """(z_content, e, h0, z_color) of one forward, from stream ``k``."""
    kg, kc = streams.named(k, "ggen_motion"), streams.named(k, "cgen_color")
    d = k.device
    z_content = torch.randn(batchsize, cfg.ggen.dim_z_content, generator=kg, device=d)
    e = torch.randn(batchsize, cfg.video_length, cfg.ggen.dim_z_motion, generator=kg, device=d)
    h0 = torch.randn(batchsize, cfg.ggen.dim_z_motion, generator=kg, device=d)
    return z_content, e, h0, torch.randn(batchsize, cfg.cgen.dim_z_color, generator=kc, device=d)


def dropout_masks(cfg, k: torch.Generator, frames: int) -> List[torch.Tensor]:
    g = streams.named(k, "cgen_dropout")
    widths = [cfg.cgen.ngf * m for m in models.up_mults(cfg.image_size)[:2]]
    return [torch.rand((frames, c), generator=g, device=k.device) >= 0.5 for c in widths]


def _noise(cfg, name: str, g: torch.Generator) -> NoiseDraws:
    c = getattr(cfg, name)
    return NoiseDraws(c.noise_sigma if c.use_noise else None, g)


# ---------------------------------------------------------------- training
class Adam:
    """torch.optim.Adam with coupled weight decay, on a dict of leaves."""

    def __init__(self, params: models.Params, opt_cfg):
        self.p, self.c = params, opt_cfg
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads: models.Params) -> models.Params:
        """Apply one step; returns the gradients as the moments took them
        (weight decay added)."""
        c = self.c
        self.t += 1
        bc1, bc2 = 1 - c.b1 ** self.t, 1 - c.b2 ** self.t
        seen = {}
        with torch.no_grad():
            for k, p in self.p.items():
                g = grads[k] + c.decay * p
                seen[k] = g
                self.m[k].mul_(c.b1).add_(g, alpha=1 - c.b1)
                self.v[k].mul_(c.b2).addcmul_(g, g, value=1 - c.b2)
                denom = self.v[k].sqrt() / bc2 ** 0.5 + c.eps
                p.addcdiv_(self.m[k], denom, value=-c.lr / bc1)
        return seen


def train_steps(cfg, weights: Dict[str, models.Params], batches: List[Dict[str, torch.Tensor]],
                seed: int, device, arith: Arith = F32, half_batch: bool = False) -> dict:
    """``len(batches)`` train steps from ``weights`` (copied). Returns the
    losses of each step ``[{loss_gen, loss_idis, loss_vdis, loss_gdis}]``,
    the gradients of step 1 as Adam took them, and the parameters after the
    last step. ``half_batch`` is a fault: each step on the first half of its
    batch, the means over it."""
    P = {m: {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
         for m, w in weights.items()}
    opt = {m: Adam(P[m], getattr(cfg, m).optimizer) for m in models.MODELS}
    base = streams.base_key(seed, device)
    losses, first = [], None
    with full_f32():
        for s, batch in enumerate(batches, start=1):
            out = _step(cfg, P, opt, batch, streams.fold_in(base, s), arith, half_batch, s)
            losses.append(out["losses"])
            if s == 1:
                first = out["grads"]
    return {"losses": losses, "grads1": first,
            "params": {m: {k: v.detach() for k, v in p.items()} for m, p in P.items()}}


def _step(cfg, P, opt, batch, kstep, arith, half_batch, step):
    gi = cfg.geometric_info.name
    xc_real, xg_real = batch["color"], batch[gi]
    b, t = xc_real.shape[:2]
    if half_batch:
        xc_real, xg_real, b = xc_real[: b // 2], xg_real[: b // 2], b // 2
    host = streams.on_device(streams.named(kstep, "t_rand"), "cpu")
    t_rand = int(torch.randint(0, cfg.video_length, (), generator=host))
    train = Stats("train")

    def fakes(k):
        z_content, e, h0, z_color = latents(cfg, k, b)
        masks = dropout_masks(cfg, k, b * t)
        xg = models.ggen(P["ggen"], z_content, e, h0, train, cfg, arith)
        return xg, models.cgen(P["cgen"], xg, z_color, train, cfg, masks, arith)

    with torch.no_grad():
        xg_fake, xc_fake = fakes(streams.named(kstep, "d_fake"))
    d_losses = {}
    for name in models.CRITICS:
        nkey = streams.named(kstep, f"{name}_noise")
        y_real = models.critic(name, P[name], xg_real, xc_real, t_rand, train,
                               _noise(cfg, name, streams.named(nkey, "d_fake")), arith)
        y_fake = models.critic(name, P[name], xg_fake, xc_fake, t_rand, train,
                               _noise(cfg, name, streams.named(nkey, "g_fake")), arith)
        d_losses[name] = models.dis_loss(cfg.loss, y_real, y_fake)
    d_leaves = [(m, k) for m in models.CRITICS for k in P[m]]
    d_grads = torch.autograd.grad(sum(d_losses.values()), [P[m][k] for m, k in d_leaves])
    grads = {m: {} for m in models.MODELS}
    for (m, k), g in zip(d_leaves, d_grads):
        grads[m][k] = g
    seen = {}
    if step % cfg.num_gen_update == 0:
        for m in models.CRITICS:
            seen[m] = opt[m].step(grads[m])

    kg = streams.named(kstep, "g_fake")
    xg_f, xc_f = fakes(kg)
    y = [models.critic(name, P[name], xg_f, xc_f, t_rand, train,
                       _noise(cfg, name, streams.named(kg, f"{name}_noise")), arith)
         for name in models.CRITICS]
    loss_gen = models.gen_loss(cfg.loss, *y)
    g_leaves = [(m, k) for m in ("ggen", "cgen") for k in P[m]]
    g_grads = torch.autograd.grad(loss_gen, [P[m][k] for m, k in g_leaves], allow_unused=True)
    for (m, k), g in zip(g_leaves, g_grads):
        grads[m][k] = torch.zeros_like(P[m][k]) if g is None else g
    if step % cfg.num_dis_update == 0:
        for m in ("ggen", "cgen"):
            seen[m] = opt[m].step(grads[m])
    losses = {"loss_gen": float(loss_gen.detach())}
    losses.update({f"loss_{m}": float(d_losses[m].detach()) for m in models.CRITICS})
    return {"losses": losses, "grads": seen}


# ---------------------------------------------------------------- sampling
def quantize(x: torch.Tensor) -> torch.Tensor:
    return torch.floor((x.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)


def sample_round(cfg, weights, running, k: torch.Generator, batchsize: int,
                 arith: Arith = F32, rows: Optional[List[int]] = None) -> torch.Tensor:
    """The uint8 colour videos ``(B, T, H, W, 3)`` of one sampling round
    from stream ``k``, in eval mode; ``rows`` computes only those videos,
    in that order."""
    z_content, e, h0, z_color = latents(cfg, k, batchsize)
    if rows is not None:
        z_content, e, h0, z_color = z_content[rows], e[rows], h0[rows], z_color[rows]
    with torch.no_grad(), full_f32():
        xg = models.ggen(weights["ggen"], z_content, e, h0, Stats("eval", running["ggen"]), cfg, arith)
        xc = models.cgen(weights["cgen"], xg, z_color, Stats("eval", running["cgen"]), cfg, None, arith)
        return quantize(xc)


def calibrate(cfg, weights, seed: int, device, batchsize: int = 32) -> Dict[str, tuple]:
    """Running BatchNorm statistics for sampling: the batch statistics of one
    train-mode pass of both generators over ``batchsize`` videos from the
    seed's ``sample`` stream (no dropout), as training would leave them."""
    k = streams.named(streams.base_key(seed, device), "sample")
    z_content, e, h0, z_color = latents(cfg, k, batchsize)
    rec_g, rec_c = Stats("record"), Stats("record")
    with torch.no_grad(), full_f32():
        xg = models.ggen(weights["ggen"], z_content, e, h0, rec_g, cfg)
        models.cgen(weights["cgen"], xg, z_color, rec_c, cfg)
    return {"ggen": rec_g.running, "cgen": rec_c.running}
