"""Evaluation CLI over directories of mp4 files.

    python -m dcvgan_torch.cli.evaluate <gen_dir> --metrics is fid \
        [--ref-dir <real_mp4_dir>] [--batchsize 32] [--weights feats.npz] \
        [--device cuda]

Counterpart of ``dcvgan_tpu/cli/evaluate.py`` with the same flags, plus
``--device`` (default ``cuda``; ``cpu`` only when asked). Prints one JSON
object of scores with ``extractor``, the extractor's fingerprint: scores
compare only under one fingerprint. fid / fvd / prd need ``--ref-dir``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

from dcvgan_torch.eval.evaluator import Evaluator
from dcvgan_torch.eval.features import FeatureExtractor


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("gen_dir", type=Path)
    parser.add_argument("--ref-dir", type=Path, default=None)
    parser.add_argument("--metrics", nargs="+", default=["is"], choices=["is", "fid", "fvd", "prd"])
    parser.add_argument("--batchsize", type=int, default=32)
    parser.add_argument("--weights", default=None, help="extractor .npz")
    parser.add_argument(
        "--max-real-samples", type=int, default=0,
        help="cap on reference clips embedded for fid/prd; 0 (default) embeds all of --ref-dir",
    )
    parser.add_argument("--device", default="cuda", help="torch device ('cpu' runs on the CPU)")
    args = parser.parse_args(argv)

    needs_ref = {"fid", "fvd", "prd"} & set(args.metrics)
    if needs_ref and args.ref_dir is None:
        parser.error(f"--ref-dir required for metrics {sorted(needs_ref)}")

    extractor = FeatureExtractor(weights_path=args.weights, device=args.device)
    evaluator = Evaluator(
        metrics=args.metrics,
        num_samples=0,  # unused by the directory protocol
        batchsize=args.batchsize,
        extractor=extractor,
        max_real_samples=args.max_real_samples,
    )
    scores = evaluator.evaluate_dirs(args.gen_dir, args.ref_dir)
    record = {k: round(float(v), 6) for k, v in scores.items()}
    record["extractor"] = extractor.fingerprint
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
