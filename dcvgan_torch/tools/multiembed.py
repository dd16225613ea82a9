"""Re-score the committed head-to-head sample sets under several embeddings.

    python -m dcvgan_torch.tools.multiembed --real <real_color_mp4_dir> \
        --out <scores.json> [--weights assets/extractor-synthetic.npz ...] \
        [--seeds 1 2] [--widths 64] [--batchsize 32] [--device cpu]
    python -m dcvgan_torch.tools.multiembed --resummarize <scores.json> ...

The port's counterpart of the repository's ``tools/multiembed_score.py``,
with its functions, arguments, manifest and row format. Every committed
late-trajectory sample set (:data:`MANIFEST`: the three torch-reference
final evaluations and eight TPU late iterations) is decoded once, cut to its
first 16 frames (``tools/headtohead.read_clips``) and embedded under each
embedding, and scored (IS, FID) against the real set embedded once under the
same embedding. :func:`summarize` reports per embedding whether the TPU
side's FIDs are no worse than the reference's (``HEADTOHEAD.md``'s
no-regression flags).

Embeddings: each ``--weights`` npz through the port's ``FeatureExtractor``
(``trained:<stem>``, the fingerprint the JAX package gives that file), and
a seeded random tower for each ``--seeds`` x ``--widths``
(``random-torch:s<seed>w<width>``: the port's own draws,
``c3d-seeded-torch/...``, never the JAX package's ``random:`` rows).
``--out`` has no default, so that the committed
``results/multiembed_scores*.json`` are not written over by accident.
Runs on ``cuda`` unless ``--device cpu`` is given. Imports nothing of the
JAX package.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from dcvgan_torch.eval.features import FeatureExtractor
from dcvgan_torch.eval.metrics import score_features
from dcvgan_torch.tools.headtohead import read_clips

REPO = Path(__file__).resolve().parents[2]
H2H = REPO / "results" / "headtohead"

# (side, run label, path) for every committed head-to-head sample set that
# belongs to the live (non-EMA) readout comparison
MANIFEST = [
    ("reference", "seed0@final", H2H / "refrun/eval_samples/eval_008"),
    ("reference", "seed1@final", H2H / "refrun-seed1/eval_samples/eval_008"),
    ("reference", "seed2@final", H2H / "refrun-seed2/eval_samples/eval_008"),
    ("tpu", "seed0@1000", H2H / "tpurun_samples/iter_001000"),
    ("tpu", "seed0@1200", H2H / "tpurun_samples/iter_001200"),
    ("tpu", "seed0@1600", H2H / "tpurun_samples/iter_001600"),
    ("tpu", "seed1@1200", H2H / "tpurun_samples_seed1/iter_001200"),
    ("tpu", "seed1@1600", H2H / "tpurun_samples_seed1/iter_001600"),
    ("tpu", "seed2@1200", H2H / "tpurun_samples_seed2/iter_001200"),
    ("tpu", "seed2@1600", H2H / "tpurun_samples_seed2/iter_001600"),
    ("tpu", "seed3@1600", H2H / "tpurun_samples_seed3/iter_001600"),
]


def load_clips(d: Path, limit: Optional[int] = None) -> np.ndarray:
    """The directory's mp4 files in name order (the first ``limit``),
    decoded once and cut to 16 frames: every embedding reuses them."""
    paths = sorted(Path(d).glob("*.mp4"))
    if limit:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no .mp4 files in {d}")
    return read_clips(paths)


def embed_clips(extractor, clips: np.ndarray, batchsize: int = 32):
    feats, probs = [], []
    for s in range(0, len(clips), batchsize):
        f, p = extractor(clips[s: s + batchsize], batchsize)
        feats.append(f)
        probs.append(p)
    return np.concatenate(feats), np.concatenate(probs)


def build_embeddings(args) -> Dict[str, FeatureExtractor]:
    embeddings: Dict[str, FeatureExtractor] = {}
    for w in args.weights:
        embeddings[f"trained:{Path(w).stem}"] = FeatureExtractor(weights_path=w, device=args.device)
    for seed in args.seeds:
        for width in args.widths:
            embeddings[f"random-torch:s{seed}w{width}"] = FeatureExtractor(seed=seed, width=width,
                                                                            device=args.device)
    return embeddings


def summarize(rows: List[dict]) -> dict:
    """Per-embedding no-regression summary (the claim under test in
    ``HEADTOHEAD.md``).

    Two families of flags:

    - best-of-k (``tpu_no_regression_best`` / ``_median_per_seed``): biased
      toward the side with more late checkpoints (the reference side has one
      final evaluation a seed);
    - like-for-like (``tpu_no_regression_final_best`` / ``_final_median``):
      each seed gives exactly its last committed checkpoint ("@final", or
      the highest "@iter") on both sides.
    """
    def parse_run(run: str):
        """(seed, checkpoint order): no "@" or "@final" is the run's final
        evaluation; a non-numeric tag sorts before every numbered
        checkpoint."""
        seed, _, tag = run.partition("@")
        if tag in ("", "final"):
            return seed, float("inf")
        if tag.isdigit():
            return seed, int(tag)
        return seed, float("-inf")

    summ: dict = {}
    for side in ("reference", "tpu"):
        fids = [r["fid"] for r in rows if r["side"] == side]
        per_seed_best: Dict[str, float] = {}
        per_seed_final: Dict[str, float] = {}
        per_seed_last_order: Dict[str, float] = {}
        for r in rows:
            if r["side"] != side:
                continue
            seed, order = parse_run(r["run"])
            per_seed_best[seed] = min(per_seed_best.get(seed, float("inf")), r["fid"])
            if order >= per_seed_last_order.get(seed, float("-inf")):
                per_seed_last_order[seed] = order
                per_seed_final[seed] = r["fid"]
        summ[side] = {
            "best_fid": min(fids),
            "median_fid": float(np.median(fids)),
            "median_per_seed_best_fid": float(np.median(list(per_seed_best.values()))),
            "median_per_seed_final_fid": float(np.median(list(per_seed_final.values()))),
            "best_per_seed_final_fid": min(per_seed_final.values()),
        }
    summ["tpu_no_regression_best"] = bool(summ["tpu"]["best_fid"] <= summ["reference"]["best_fid"])
    summ["tpu_no_regression_median_per_seed"] = bool(
        summ["tpu"]["median_per_seed_best_fid"] <= summ["reference"]["median_per_seed_best_fid"])
    summ["tpu_no_regression_final_median"] = bool(
        summ["tpu"]["median_per_seed_final_fid"] <= summ["reference"]["median_per_seed_final_fid"])
    summ["tpu_no_regression_final_best"] = bool(
        summ["tpu"]["best_per_seed_final_fid"] <= summ["reference"]["best_per_seed_final_fid"])
    return summ


def resummarize(path: Path) -> dict:
    """Recompute the summaries of a scores JSON from its rows, in place."""
    data = json.loads(Path(path).read_text())
    data["summary"] = {name: summarize(rows) for name, rows in data["embeddings"].items()}
    Path(path).write_text(json.dumps(data, indent=1))
    return data


def score_all(args) -> dict:
    """Every set of :data:`MANIFEST` that exists, under every embedding;
    ``args.out`` is written after each embedding."""
    embeddings = build_embeddings(args)
    manifest = [(s, r, p) for s, r, p in MANIFEST if p.is_dir()]
    missing = [str(p) for _, _, p in MANIFEST if not p.is_dir()]
    out: dict = {"missing_sets": missing, "embeddings": {}, "summary": {},
                 "fingerprints": {name: ex.fingerprint for name, ex in embeddings.items()}}
    real_clips = load_clips(args.real)
    clip_sets = [(s, r, load_clips(p)) for s, r, p in manifest]
    for name, ex in embeddings.items():
        ref_feats, _ = embed_clips(ex, real_clips, args.batchsize)
        rows: List[dict] = []
        for side, run, clips in clip_sets:
            feats, probs = embed_clips(ex, clips, args.batchsize)
            scores = score_features(["is", "fid"], feats, probs, ref_feats)
            rows.append({"side": side, "run": run, **{k: round(v, 4) for k, v in scores.items()}})
            print(f"[{name}] {side}/{run}: {scores}", flush=True)
        out["embeddings"][name] = rows
        out["summary"][name] = summarize(rows)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return out


def main(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--real", type=Path,
                    help="real mp4 dir (data/processed/synthetic/train/color); required unless --resummarize")
    ap.add_argument("--weights", nargs="*", type=Path, default=[REPO / "assets/extractor-synthetic.npz"])
    ap.add_argument("--seeds", nargs="*", type=int, default=[1, 2])
    ap.add_argument("--widths", nargs="*", type=int, default=[64])
    ap.add_argument("--batchsize", type=int, default=32)
    ap.add_argument("--out", type=Path, help="scores JSON to write; required unless --resummarize")
    ap.add_argument("--resummarize", nargs="*", type=Path, default=None,
                    help="recompute summaries in existing scores JSONs (no re-embedding) and exit")
    ap.add_argument("--device", default=None, help="torch device (default cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    if args.resummarize is not None:
        if not args.resummarize:
            ap.error("--resummarize needs at least one scores-JSON path")
        for p in args.resummarize:
            out = resummarize(p)
            print(p)
            print(json.dumps(out["summary"], indent=1))
        return None
    if args.real is None or args.out is None:
        ap.error("--real and --out are required unless --resummarize")
    out = score_all(args)
    print(json.dumps(out["summary"], indent=1))
    return out


if __name__ == "__main__":
    main()
