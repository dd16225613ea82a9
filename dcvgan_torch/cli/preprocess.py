"""Preprocessing CLI: turn a raw dataset tree into the tree the dataset reads.

    python -m dcvgan_torch.cli.preprocess surreal data/raw/surreal \
        data/processed/surreal/train --mode train --img-size 64

Counterpart of ``dcvgan_tpu/cli/preprocess.py``, with the same arguments,
through the port's registry (``dcvgan_torch.data.preprocess``). Training
runs the same preprocessor on a cold start; this runs it on its own.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from dcvgan_torch.data.preprocess import get_preprocessor


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dataset", help="dataset name (surreal/isogd/mock/synthetic)")
    parser.add_argument("raw_path", type=Path)
    parser.add_argument("save_path", type=Path)
    parser.add_argument("--mode", default="train")
    parser.add_argument("--length", type=int, default=16)
    parser.add_argument("--img-size", type=int, default=64)
    parser.add_argument("--n-jobs", type=int, default=-1, help="threads; -1: all CPUs")
    args = parser.parse_args(argv)

    fn = get_preprocessor(args.dataset)
    args.save_path.mkdir(parents=True, exist_ok=True)
    fn(args.raw_path, args.save_path, args.mode, args.length, args.img_size, args.n_jobs)


if __name__ == "__main__":
    main()
