"""The head-to-head quality protocol through the port: train a config, sample
every snapshot as mp4 files, score the trajectory against the real set.

    python -m dcvgan_torch.tools.headtohead --config configs/headtohead-tpu.yml \
        --out result/headtohead-port [--metrics is fid prd] [--n 128] [--batch 32] \
        [--seed 0] [--ema] [--ref-limit N] [--device cpu]

The port's counterpart of three scripts of the repository's ``tools/``, with
their protocol (``HEADTOHEAD.md``): 128 videos an iteration written as mp4
and read back, the first 16 frames of each, embedded by the committed
extractor (``assets/extractor-synthetic.npz``, its fingerprint beside every
score) and scored against the real mp4 set of the synthetic tree.

- :func:`score_dirs` (``tools/headtohead_score.py``): one directory of mp4
  files against another;
- :func:`score_trajectory` (``tools/score_iters.py``): every ``iter_NNNNNN/``
  of a directory against one real set embedded once, one row an iteration,
  rounded to 4 decimals;
- :func:`sample_run` (``tools/headtohead_sample.py``): ``iter_NNNNNN/*.mp4``
  for each checkpoint of a run directory of the port, through the eval-mode
  sampling path.

:func:`main` trains the config through ``cli.train``'s path
(``build_dataset``, ``build_evaluator``, ``Trainer``) in ``<out>/work``,
because the configs name relative ``result/`` and ``data/`` paths; the
synthetic preprocessor writes the tree there on cold start, and the real
set is written from it as ``tools/run_reference.py`` writes it. Then it
samples every snapshot into ``<out>/samples``, scores the trajectory and
writes ``<out>/scores.json`` (``tools/score_iters.py``'s rows) and
``<out>/summary.json`` (train it/s, the seconds of each stage, the losses,
the card). ``--out`` should be a directory git ignores. Runs on ``cuda``
unless ``--device cpu`` is given. Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import re
import statistics
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dcvgan_torch import prng
from dcvgan_torch.config import load_config
from dcvgan_torch.eval.features import FeatureExtractor
from dcvgan_torch.eval.metrics import score_features
from dcvgan_torch.eval.sampler import generate_samples
from dcvgan_torch.io.image import read_img
from dcvgan_torch.io.video import read_videos_parallel, write_video, write_videos_parallel
from dcvgan_torch.logging.logger import Logger
from dcvgan_torch.train.checkpoint import CheckpointManager
from dcvgan_torch.train.step import DCVGAN
from dcvgan_torch.train.trainer import LOSS_NAMES, Trainer

REPO = Path(__file__).resolve().parents[2]
EXTRACTOR_WEIGHTS = REPO / "assets" / "extractor-synthetic.npz"
VIDEO_LENGTH = 16
_ITER_DIR = re.compile(r"iter_(\d+)")


@functools.lru_cache(maxsize=2)
def get_extractor(device: Optional[str] = None) -> FeatureExtractor:
    """The committed extractor on ``device``, loaded once per process. It
    embeds in float32 with cuDNN's TF32 off (``eval/features.py``)."""
    return FeatureExtractor(weights_path=EXTRACTOR_WEIGHTS, device=device)


def read_clips(paths: Sequence[Path], video_length: int = VIDEO_LENGTH) -> np.ndarray:
    """The first ``video_length`` frames of each mp4, stacked; raises on a
    shorter clip."""
    clips = []
    for p, v in zip(paths, read_videos_parallel(paths)):
        if v.shape[0] < video_length:
            raise ValueError(f"{p}: only {v.shape[0]} frames (< {video_length})")
        clips.append(v[:video_length])
    return np.stack(clips)


def embed_dir(d: Path, batchsize: int = 32, video_length: int = VIDEO_LENGTH,
              limit: Optional[int] = None, device: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(features, probabilities) of the directory's mp4 files in name order
    (the first ``limit`` of them), ``batchsize`` clips at a time."""
    paths = sorted(Path(d).glob("*.mp4"))
    if limit:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no .mp4 files in {d}")
    ex = get_extractor(device=device)
    feats: List[np.ndarray] = []
    probs: List[np.ndarray] = []
    for s in range(0, len(paths), batchsize):
        f, p = ex(read_clips(paths[s: s + batchsize], video_length), batchsize)
        feats.append(f)
        probs.append(p)
    return np.concatenate(feats), np.concatenate(probs)


def score_dirs(gen_dir: Path, ref_dir: Optional[Path] = None, metrics: Iterable[str] = ("is", "fid"),
               batchsize: int = 32, video_length: int = VIDEO_LENGTH, ref_limit: Optional[int] = None,
               device: Optional[str] = None) -> Dict[str, float]:
    """The metrics of ``gen_dir``'s mp4 files, against ``ref_dir``'s for fid
    and prd (``prd`` gives ``prd`` and ``prd_f1_8``)."""
    feats, probs = embed_dir(gen_dir, batchsize, video_length, device=device)
    ref = None
    if ref_dir is not None:
        ref = embed_dir(ref_dir, batchsize, video_length, ref_limit, device=device)[0]
    return score_features(metrics, feats, probs, ref)


def score_trajectory(samples_root: Path, ref_dir: Path, metrics: Iterable[str], batchsize: int = 32,
                     ref_limit: Optional[int] = None, device: Optional[str] = None) -> List[dict]:
    """One row ``{"iteration": N, <metric>: score rounded to 4 decimals}``
    for each ``iter_NNNNNN/`` under ``samples_root``; the real set is
    embedded once. Prints each row as it is scored."""
    metrics = list(metrics)
    found = ((_ITER_DIR.fullmatch(p.name), p) for p in Path(samples_root).iterdir() if p.is_dir())
    iters = sorted((int(m.group(1)), p) for m, p in found if m)
    if not iters:
        raise FileNotFoundError(f"no iter_* directories under {samples_root}")
    ref_feats = embed_dir(ref_dir, batchsize, limit=ref_limit, device=device)[0]
    rows = []
    for it, d in iters:
        feats, probs = embed_dir(d, batchsize, device=device)
        row = {"iteration": it}
        row.update({k: round(v, 4) for k, v in score_features(metrics, feats, probs, ref_feats).items()})
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def sample_run(run_dir: Path, out: Path, n: int = 128, batch: int = 32, seed: int = 0, ema: bool = False,
               device: Optional[str] = None) -> List[int]:
    """Write ``out/iter_NNNNNN/{000000..}.mp4``, ``n`` colour videos for each
    checkpoint of the port's run directory (``config.yml``,
    ``models/step_<N>.pt``), sampled in eval mode in rounds of ``batch``,
    round ``off`` from ``prng.for_step(base_key(seed), off)``; with ``ema``
    the checkpoints' EMA generators. A directory that already holds ``n``
    files is left as it is. Returns the iterations."""
    run_dir, out = Path(run_dir), Path(out)
    cfg = load_config(run_dir / "config.yml")
    gan = DCVGAN(cfg, device=device)
    ckpt = CheckpointManager(run_dir / "models")
    template = gan.init_state(cfg.seed)
    key = prng.base_key(seed, gan.device)
    iters = ckpt.all_steps()
    for it in iters:
        d = out / f"iter_{it:06d}"
        if len(list(d.glob("*.mp4"))) >= n:
            continue
        state = ckpt.restore(template, it)
        if ema:
            if state.ema is None:
                raise ValueError(f"ema: checkpoint {it} carries no EMA")
            state = state.with_ema_params()
        d.mkdir(parents=True, exist_ok=True)
        wrote = 0
        for off in range(0, n, batch):
            _, xc = generate_samples(gan, state, prng.for_step(key, off), batch, batch, with_geo=False)
            take = min(batch, n - wrote)
            write_videos_parallel(xc[:take], [d / f"{wrote + i:06d}.mp4" for i in range(take)])
            wrote += take
    return iters


def real_set(train: Path) -> Path:
    """``train/color/<video>.mp4`` for each video of a processed tree, from
    its ``color/*.jpg`` frames (written once): the real side of the
    protocol."""
    color_dir = train / "color"
    videos = sorted(p for p in train.iterdir() if p.is_dir() and p.name != "color")
    n_listed = len((train / "list.txt").read_text().split()) // 2
    if color_dir.exists() and len(list(color_dir.glob("*.mp4"))) >= n_listed:
        return color_dir
    color_dir.mkdir(exist_ok=True)
    for vid in videos:
        frames = sorted((vid / "color").glob("*.jpg"))
        if not frames:
            raise FileNotFoundError(f"no color/*.jpg frames in {vid}")
        write_video(np.stack([read_img(f) for f in frames]), color_dir / f"{vid.name}.mp4")
    return color_dir


class _Recorder(Logger):
    """A ``Logger`` that also keeps every value the trainer logs."""

    def __init__(self, *args):
        super().__init__(*args)
        self.seen: Dict[str, list] = {}

    def update(self, name, value):
        self.seen.setdefault(name, []).append(value)
        super().update(name, value)


def train(config: Path, work: Path, device: Optional[str] = None) -> Tuple[Trainer, Dict[str, list]]:
    """Train ``config`` as ``cli.train`` does, from the directory ``work``;
    returns the trainer and every value it logged."""
    from dcvgan_torch.cli.train import build_dataset, build_evaluator

    cfg = load_config(config)
    work.mkdir(parents=True, exist_ok=True)
    with contextlib.chdir(work):
        dataset = build_dataset(cfg)
        evaluator = build_evaluator(cfg, dataset, device=device)
        logger = _Recorder(Path(cfg.log_dir) / cfg.experiment_name,
                           Path(cfg.tensorboard_dir) / cfg.experiment_name)
        trainer = Trainer(cfg, dataset, logger=logger, evaluator=evaluator, device=device)
        trainer.train()
    return trainer, logger.seen


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu``."""
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", "-c", type=Path, required=True)
    parser.add_argument("--out", type=Path, required=True, help="output directory (git-ignored)")
    parser.add_argument("--metrics", nargs="+", default=["is", "fid", "prd"])
    parser.add_argument("--n", type=int, default=128, help="videos sampled a snapshot")
    parser.add_argument("--batch", type=int, default=32, help="sampling and embedding batch")
    parser.add_argument("--seed", type=int, default=0, help="sampling seed")
    parser.add_argument("--ema", action="store_true", help="sample the checkpoints' EMA generators")
    parser.add_argument("--ref-limit", type=int, default=None, help="embed only the first N real videos")
    parser.add_argument("--device", default=None, help="torch device (default cuda; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)

    out = args.out.resolve()
    config = args.config.resolve()
    work = out / "work"
    on_card = torch.device(args.device or "cuda").type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    seconds = {}

    t0 = time.perf_counter()
    trainer, seen = train(config, work, args.device)
    seconds["train"] = time.perf_counter() - t0
    cfg, run_dir = trainer.config, work / trainer.run_dir

    t0 = time.perf_counter()
    sample_run(run_dir, out / "samples", args.n, args.batch, args.seed, args.ema, args.device)
    seconds["sample"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    real = real_set(work / cfg.dataset.processed_root / cfg.dataset.name / "train")
    rows = score_trajectory(out / "samples", real, args.metrics, args.batch, args.ref_limit, args.device)
    seconds["score"] = time.perf_counter() - t0
    (out / "scores.json").write_text(json.dumps(rows, indent=1))

    windows = seen.get("iters_per_sec", [])
    losses = {k: seen.get(k, []) for k in LOSS_NAMES}
    summary = {
        "config": str(args.config),
        "card": card(),
        "extractor": get_extractor(device=args.device).fingerprint,
        "steps": trainer.state.step,
        # the windows after the first, which holds cuDNN's algorithm search
        "train_it_per_s": statistics.median(windows[1:]) if len(windows) > 1 else None,
        "seconds": seconds,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
        "first_losses": {k: v[0] for k, v in losses.items() if v},
        "last_losses": {k: v[-1] for k, v in losses.items() if v},
        "losses_finite": all(math.isfinite(x) for v in losses.values() for x in v),
        "in_training_eval": {m: seen[m] for m in cfg.evaluation.metrics if m in seen},
        "rows": rows,
    }
    (out / "summary.json").write_text(json.dumps({**summary, "losses": losses}, indent=1))
    print(json.dumps(summary), flush=True)
    return {**summary, "losses": losses}


if __name__ == "__main__":
    main()
