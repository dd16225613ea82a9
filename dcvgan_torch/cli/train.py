"""Training CLI.

Usage::

    python -m dcvgan_torch.cli.train --config configs/mug-depth.yml [--device cuda]

Counterpart of ``dcvgan_tpu/cli/train.py`` on one GPU. Runs on ``cuda``
unless ``--device cpu`` is given. The evaluator is not ported: when the
config lists ``evaluation.metrics`` the run logs which are skipped.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from dcvgan_torch.config import load_config
from dcvgan_torch.data.dataset import VideoDataset
from dcvgan_torch.data.preprocess import get_preprocessor
from dcvgan_torch.train.trainer import Trainer


def build_dataset(cfg) -> VideoDataset:
    # A dataset without a registered preprocessor is still trainable when its
    # preprocessed tree exists on disk; only a cold start needs the registry.
    try:
        preprocess_func = get_preprocessor(cfg.dataset.name)
    except KeyError:
        processed = Path(cfg.dataset.processed_root) / cfg.dataset.name / "train"
        if not processed.exists():
            raise
        preprocess_func = None

    return VideoDataset(
        name=cfg.dataset.name,
        dataset_path=cfg.dataset.path,
        preprocess_func=preprocess_func,
        video_length=cfg.video_length,
        image_size=cfg.image_size,
        number_limit=cfg.dataset.number_limit,
        geometric_info=cfg.geometric_info.name,
        processed_root=cfg.dataset.processed_root,
        extension=cfg.dataset.extension,
        # raw passthrough: uint8 modalities (color, non-surreal depth) ship
        # unnormalised, optical flow as float16, segmentation as class
        # labels; the train step ingests them on the device
        raw_uint8=cfg.trainer.device_normalize,
        cache_decoded=cfg.dataset.cache_decoded,
    )


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", "-c", required=True, help="training configuration YAML")
    parser.add_argument(
        "--device", default=None, help="torch device (default cuda; 'cpu' runs on the CPU)"
    )
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    dataset = build_dataset(cfg)
    trainer = Trainer(cfg, dataset, device=args.device)
    if cfg.evaluation.metrics:
        trainer.logger.info(
            "evaluation is not ported yet; skipping metrics: "
            + ", ".join(cfg.evaluation.metrics)
        )
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
