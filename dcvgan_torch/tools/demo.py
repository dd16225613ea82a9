"""Turn a training run of the port into charts, sample strips and an mp4.

    python -m dcvgan_torch.tools.demo <run_dir> <out_dir> [--no-samples] [--device cpu]

The port's counterpart of the repository's ``tools/train_demo.py``, with its
functions, arguments and artifacts. ``<run_dir>`` is the trainer's
``<log_dir>/<experiment_name>`` directory (``log``, ``config.yml``,
``models/step_<N>.pt``). Writes into ``<out_dir>``:

- ``metrics.csv``: the metric table of the run's ``log``;
- ``losses.png``, ``fid.png``, ``is.png``: loss and score trajectories
  (matplotlib, imported only to draw them);
- ``samples_step_NNNNNN.png`` for every checkpoint: 4 sampled videos, every
  2nd frame, geometry rows over colour rows, sampled in eval mode (the fused
  ``fused_norm_act_conv`` kernel on the card) from a generator seeded 123;
- ``final_samples.mp4``: the last checkpoint's 4 colour videos side by side.

Samples run on ``cuda`` unless ``--device cpu`` is given. Imports nothing of
the JAX package.
"""

from __future__ import annotations

import argparse
import csv
import re
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

# dataviz reference palette (validated categorical slots 1-4, light mode)
SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100"]
TEXT, TEXT2, GRID = "#0b0b0b", "#52514e", "#e6e5e1"
SAMPLE_SEED = 123


def parse_log(run_dir: Path):
    """(header, rows) of the fixed-width metric table in the run's log."""
    header = None
    rows = []
    for line in (Path(run_dir) / "log").read_text().splitlines():
        body = re.sub(r"^\[[^\]]+\]\s*", "", line)
        cols = body.split()
        if cols[:2] == ["epoch", "iteration"]:
            header = cols
            continue
        if header and len(cols) == len(header):
            try:
                rows.append([float(c) if c != "-" else None for c in cols[:-2]] + cols[-2:])
            except ValueError:
                continue
    if header is None:
        raise SystemExit(f"no metric table found in {run_dir}/log")
    return header, rows


def write_csv(header, rows, out: Path) -> None:
    with Path(out).open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for r in rows:
            w.writerow(["" if c is None else c for c in r])


def _style_axes(ax, title, xlabel, ylabel):
    ax.set_title(title, color=TEXT, fontsize=11, loc="left")
    ax.set_xlabel(xlabel, color=TEXT2, fontsize=9)
    ax.set_ylabel(ylabel, color=TEXT2, fontsize=9)
    ax.grid(True, color=GRID, linewidth=0.8)
    ax.set_axisbelow(True)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(GRID)
    ax.tick_params(colors=TEXT2, labelsize=8)


def plot_curves(header, rows, out_dir: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    col = {name: i for i, name in enumerate(header)}
    it = np.array([r[col["iteration"]] for r in rows], dtype=float)

    # losses: one axis, four series in fixed categorical order
    fig, ax = plt.subplots(figsize=(7, 3.4), dpi=150, facecolor="#fcfcfb")
    ax.set_facecolor("#fcfcfb")
    for name, c in zip(["loss_gen", "loss_idis", "loss_vdis", "loss_gdis"], SERIES):
        y = np.array([np.nan if r[col[name]] is None else r[col[name]] for r in rows], dtype=float)
        ax.plot(it, y, color=c, linewidth=1.4, label=name)
    _style_axes(ax, "Training losses", "iteration", "loss")
    ax.legend(frameon=False, fontsize=8, labelcolor=TEXT2)
    fig.tight_layout()
    fig.savefig(out_dir / "losses.png")
    plt.close(fig)

    # the scores: one series each, no legend
    for metric in ("fid", "is"):
        if metric not in col:
            continue
        pts = [(r[col["iteration"]], r[col[metric]]) for r in rows if r[col[metric]] is not None]
        if not pts:
            continue
        x, y = zip(*pts)
        fig, ax = plt.subplots(figsize=(7, 3.0), dpi=150, facecolor="#fcfcfb")
        ax.set_facecolor("#fcfcfb")
        ax.plot(x, y, color=SERIES[0], linewidth=2.0, marker="o", markersize=4)
        label = "relative FVD (seeded extractor)" if metric == "fid" else metric
        _style_axes(ax, label, "iteration", metric)
        fig.tight_layout()
        fig.savefig(out_dir / f"{metric}.png")
        plt.close(fig)


def sample_strip(xg: np.ndarray, xc: np.ndarray, stride: int = 2) -> np.ndarray:
    """One image of ``(N, T, H, W, 3)`` geometry and colour videos: a row a
    video, every ``stride``-th frame left to right, the geometry rows above
    the colour rows."""
    frames = list(range(0, xc.shape[1], stride))

    def rows(videos):
        return np.concatenate([np.concatenate([v[t] for t in frames], axis=1) for v in videos], axis=0)

    return np.concatenate([rows(xg), rows(xc)], axis=0)


def render_checkpoint_samples(run_dir: Path, out_dir: Path, n_samples: int = 4, stride: int = 2,
                              device=None) -> List[int]:
    """A (geometry | colour) frame-strip PNG for every checkpoint of the run,
    and ``final_samples.mp4`` of the last; returns the checkpoints' steps."""
    from dcvgan_torch import prng
    from dcvgan_torch.config import load_config
    from dcvgan_torch.eval.sampler import generate_samples
    from dcvgan_torch.io.image import write_img
    from dcvgan_torch.io.video import write_video
    from dcvgan_torch.train.checkpoint import CheckpointManager
    from dcvgan_torch.train.step import DCVGAN

    run_dir, out_dir = Path(run_dir), Path(out_dir)
    cfg = load_config(run_dir / "config.yml")
    gan = DCVGAN(cfg, device=device)
    template = gan.init_state(cfg.seed)
    ckpt = CheckpointManager(run_dir / "models")
    steps = ckpt.all_steps()
    gen = prng.base_key(SAMPLE_SEED, gan.device)

    for step in steps:
        state = ckpt.restore(template, step=step)
        xg, xc = generate_samples(gan, state, gen, n_samples, n_samples)
        write_img(sample_strip(xg, xc, stride), out_dir / f"samples_step_{step:06d}.png")
        print(f"step {step}: wrote samples strip")

    if steps:
        write_video(np.concatenate(list(xc), axis=2), out_dir / "final_samples.mp4")  # (T, H, n*W, 3)
    return steps


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("run_dir", type=Path)
    parser.add_argument("out_dir", type=Path)
    parser.add_argument("--no-samples", action="store_true")
    parser.add_argument("--device", default=None, help="torch device (default cuda; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)
    args.out_dir.mkdir(parents=True, exist_ok=True)

    header, rows = parse_log(args.run_dir)
    write_csv(header, rows, args.out_dir / "metrics.csv")
    plot_curves(header, rows, args.out_dir)
    print(f"wrote metrics.csv + charts ({len(rows)} rows)")
    if not args.no_samples:
        render_checkpoint_samples(args.run_dir, args.out_dir, device=args.device)


if __name__ == "__main__":
    main()
