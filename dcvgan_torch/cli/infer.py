"""Inference CLI: sample videos from a training run and write them as mp4.

    python -m dcvgan_torch.cli.infer <result_dir> <iteration> <save_dir> \
        [--n_samples N] [--batchsize B] [--seed S] [--no-ema] [--device cuda]

Counterpart of ``dcvgan_tpu/cli/infer.py``. ``result_dir`` is a run
directory of the port (``config.yml`` and ``models/step_<N>.pt``, as
``cli.train`` and ``cli.import_torch`` write them); ``iteration`` -1 takes
the latest checkpoint. Writes ``save_dir/{color,<geometric_info>}/NNNNNN.mp4``.
Samples the EMA generators when the checkpoint has them, unless
``--no-ema``. Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from dcvgan_torch import prng
from dcvgan_torch.config import load_config
from dcvgan_torch.eval.sampler import generate_samples
from dcvgan_torch.io.video import write_videos_parallel
from dcvgan_torch.train.checkpoint import CheckpointManager
from dcvgan_torch.train.step import DCVGAN


def load_run(result_dir: Path, iteration: int = -1, device=None):
    """(config, model bundle, training state) of a run directory at
    ``iteration`` (-1: the latest checkpoint)."""
    cfg = load_config(Path(result_dir) / "config.yml")
    gan = DCVGAN(cfg, device=device)
    ckpt = CheckpointManager(Path(result_dir) / "models")
    state = ckpt.restore(gan.init_state(cfg.seed), None if iteration < 0 else iteration)
    return cfg, gan, state


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("result_dir", type=Path)
    parser.add_argument("iteration", type=int)
    parser.add_argument("save_dir", type=Path)
    parser.add_argument("--n_samples", "-n", type=int, default=10000)
    parser.add_argument("--batchsize", "-b", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--no-ema", action="store_true",
        help="sample the live generators even when the checkpoint carries an EMA",
    )
    parser.add_argument("--device", default="cuda", help="torch device ('cpu' runs on the CPU)")
    args = parser.parse_args(argv)

    cfg, gan, state = load_run(args.result_dir, args.iteration, device=args.device)
    gens = state.generators()
    if not args.no_ema:
        gens = gens.with_ema_params()

    color_dir = args.save_dir / "color"
    geo_dir = args.save_dir / cfg.geometric_info.name
    color_dir.mkdir(parents=True, exist_ok=True)
    geo_dir.mkdir(parents=True, exist_ok=True)

    key = prng.base_key(args.seed, gan.device)
    for offset in range(0, args.n_samples, args.batchsize):
        n = min(args.batchsize, args.n_samples - offset)
        xg, xc = generate_samples(gan, gens, prng.for_step(key, offset), n, args.batchsize)
        write_videos_parallel(xg, [geo_dir / f"{offset + i:06d}.mp4" for i in range(n)])
        write_videos_parallel(xc, [color_dir / f"{offset + i:06d}.mp4" for i in range(n)])


if __name__ == "__main__":
    main()
