"""Gloo ranks for the port's data-parallel tests.

:func:`run_ranks` starts ``world`` Python processes that join one gloo group
and each run one *case* of this module, a function
``case(rank, world, payload) -> result``; payloads and results cross
through ``torch.save`` files in a temporary directory. The group meets at a
``TCPStore`` that the calling process serves on a port the OS picks and
holds until the ranks end, so two launches (of two test workers) can never
share a port. A rank sets ``torch.set_num_threads(1)``, imports nothing of
JAX, and the group and every process are bounded by timeouts, so that a
hung collective fails its test.
"""

from __future__ import annotations

import datetime
import importlib
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
GROUP_TIMEOUT_S = 60

_BOOT = r"""
import sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch_dist_util
torch_dist_util._rank_main(*sys.argv[3:])
"""


def run_ranks(case: str, world: int, payload, workdir: Path, timeout: float = 120.0) -> list:
    """Each rank's result of ``case`` over ``world`` gloo ranks, in rank
    order: a function of this module, or ``module.function`` of another
    module of ``tests/``. Raises with the failing rank's output if any rank
    fails or the ranks outlive ``timeout``; every process is ended either
    way."""
    import torch.distributed as dist

    workdir.mkdir(parents=True, exist_ok=True)
    src = workdir / f"{case}.in.pt"
    torch.save(payload, src)
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    port = str(store.port)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        log = open(workdir / f"{case}.rank{rank}.log", "w+")
        logs.append(log)
        out = workdir / f"{case}.rank{rank}.out.pt"
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _BOOT, str(TESTS), str(REPO), case, str(src), str(out),
             str(rank), str(world), port],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=workdir,
        ))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        del store
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} of {case} exited {p.returncode}:\n{text[-6000:]}")
    return [torch.load(workdir / f"{case}.rank{r}.out.pt", weights_only=False) for r in range(world)]


def _rank_main(case, src, out, rank, world, port) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    store = dist.TCPStore("127.0.0.1", int(port), world, is_master=False, timeout=timeout)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world, timeout=timeout)
    try:
        if "." in case:
            module, name = case.rsplit(".", 1)
            fn = getattr(importlib.import_module(module), name)
        else:
            fn = globals()[case]
        result = fn(rank, world, torch.load(src, weights_only=False))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, out)


# ------------------------------------------------------------------- cases
def state_payload(state) -> dict:
    """A ``GANState`` as plain tensors (``load_state_payload`` reads it)."""
    return {
        "step": state.step,
        "models": {n: m.state_dict() for n, m in state.models.items()},
        "opt": {n: o.state_dict() for n, o in state.opt.items()},
        "ema": state.ema,
    }


def load_state_payload(state, payload) -> None:
    for name, module in state.models.items():
        module.load_state_dict(payload["models"][name])
        state.opt[name].load_state_dict(payload["opt"][name])
    state.step = payload["step"]
    if payload["ema"] is not None:
        state.ema = {n: dict(v) for n, v in payload["ema"].items()}


def snapshot(state, metrics) -> dict:
    """The state after a step (``state_payload``), its gradients and its
    metrics as floats."""
    out = state_payload(state)
    out["grads"] = {n: {k: p.grad.clone() for k, p in m.named_parameters()}
                    for n, m in state.models.items()}
    out["metrics"] = {k: v.item() for k, v in metrics.items()}
    return out


def train_steps(rank, world, payload) -> dict:
    """A ``snapshot`` after each of ``payload["steps"]`` train steps of
    ``DCVGAN`` under the layout of
    ``payload["mesh"]`` from ``payload["state"]``: each step's global batch
    is sharded, and its draws are one global ``StepDraws`` (every rank the
    same), a list with one per rank, or None (the step draws its own).
    ``payload["global_batch_norm"]`` gives the BatchNorms the global-batch
    arithmetic in a world of one rank too; ``payload["local_backward"]``
    breaks it: the sums' backward keeps each rank's own gradient instead of
    all-reducing it (a lesion that the comparisons must catch)."""
    from dcvgan_torch import prng
    from dcvgan_torch.config import ExperimentConfig
    from dcvgan_torch.models.layers import sync_batch_norms
    from dcvgan_torch.parallel import create_layout, mesh, replicate, shard_batch
    from dcvgan_torch.train.step import DCVGAN

    if payload.get("local_backward"):
        mesh._AllReduceSum.backward = staticmethod(lambda ctx, grad: (grad.clone(), None))

    cfg = ExperimentConfig.from_dict(payload["config"])
    layout = create_layout(cfg, **payload.get("mesh", {}))
    assert layout.world == world and layout.rank == rank
    gan = DCVGAN(cfg, device="cpu", layout=layout)
    state = gan.init_state(0)
    load_state_payload(state, payload["state"])
    replicate(state, layout)
    if payload.get("global_batch_norm"):
        for module in state.models.values():
            sync_batch_norms(module)
    out = []
    for batch, draws in payload["steps"]:
        if isinstance(draws, list):
            draws = draws[rank]
        state, metrics = gan.train_step(state, shard_batch(batch, layout), prng.base_key(3), draws)
        out.append(snapshot(state, metrics))
    return out


def batch_norm_rows(rank, world, payload) -> dict:
    """One train-mode BatchNorm forward and backward with global-batch
    statistics over this rank's rows of ``payload["x"]`` (NCHW / NCDHW),
    against the cotangent ``payload["ct"]``."""
    from dcvgan_torch.models.layers import batch_norm, batch_norm3d, sync_batch_norms
    from dcvgan_torch.parallel import create_layout, shard_batch

    layout = create_layout(batchsize=payload["x"].shape[0])
    rows = shard_batch({"x": payload["x"], "ct": payload["ct"]}, layout)
    x = rows["x"].clone().requires_grad_(True)
    bn = (batch_norm if x.dim() == 4 else batch_norm3d)(x.shape[1])
    bn.load_state_dict(payload["bn"], strict=False)
    sync_batch_norms(bn)
    out = bn(x, train=True, update_stats=True)
    (out.float() * rows["ct"]).sum().backward()
    return {"out": out.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "mean": bn.running_mean.clone(), "var": bn.running_var.clone()}


def train_cli(rank, world, payload) -> dict:
    """``cli.train``'s ``main(payload["argv"])`` on this rank, from the
    directory ``payload["cwd"][rank]``, with the metrics of every train step
    recorded.
    ``payload["global_batch_norm"]`` gives a world of one rank the
    global-batch arithmetic and draws."""
    from dcvgan_torch.cli import train as cli_train
    from dcvgan_torch.train.step import DCVGAN

    os.chdir(payload["cwd"][rank])
    metrics = []
    step = DCVGAN.train_step

    def recording(self, *args, **kwargs):
        state, m = step(self, *args, **kwargs)
        metrics.append({k: v.item() for k, v in m.items()})
        return state, m

    DCVGAN.train_step = recording
    if payload.get("global_batch_norm"):
        DCVGAN.global_batch = property(lambda self: True)
    trainer = cli_train.main(payload["argv"])
    return {"metrics": metrics, "state": state_payload(trainer.state), "world": trainer.layout.world}


def evaluate(rank, world, payload) -> dict:
    """``Evaluator.evaluate`` of a seeded fresh state, its rounds split over
    the ranks, and the features rank 0 gathered."""
    from dcvgan_torch import prng
    from dcvgan_torch.config import ExperimentConfig
    from dcvgan_torch.data.dataset import VideoDataset
    from dcvgan_torch.eval.evaluator import Evaluator
    from dcvgan_torch.eval.features import FeatureExtractor
    from dcvgan_torch.parallel import create_layout
    from dcvgan_torch.train.step import DCVGAN

    cfg = ExperimentConfig.from_dict(payload["config"])
    gan = DCVGAN(cfg, device="cpu")
    state = gan.init_state(cfg.seed)
    dataset = VideoDataset(name="synthetic", processed_root=payload["data"], number_limit=8,
                           video_length=cfg.video_length, image_size=cfg.image_size)
    ev = Evaluator(["is", "fid"], num_samples=payload["num"], batchsize=payload["batch"],
                   dataset=dataset, extractor=FeatureExtractor(payload["weights"], device="cpu"),
                   max_real_samples=8)
    ev.set_layout(create_layout(batchsize=payload["batch"]))
    feats, _ = ev.sample_and_embed(gan, state, prng.base_key(7))
    return {"scores": ev.evaluate(gan, state, prng.base_key(7)), "feats": feats}

