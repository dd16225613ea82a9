"""Training CLI.

Usage::

    python -m dcvgan_torch.cli.train --config configs/mug-depth.yml [--device cuda]

Counterpart of ``dcvgan_tpu/cli/train.py`` on one GPU. Runs on ``cuda``
unless ``--device cpu`` is given. When the config lists
``evaluation.metrics``, the trainer scores them at step 0 and every
``evaluation_interval`` steps against the training dataset.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from dcvgan_torch.config import load_config
from dcvgan_torch.data.dataset import VideoDataset
from dcvgan_torch.data.preprocess import get_preprocessor
from dcvgan_torch.train.trainer import Trainer

REPO_ROOT = Path(__file__).resolve().parents[2]


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


def build_evaluator(cfg, dataset, device=None):
    """The evaluator of ``cfg.evaluation`` on ``dataset``, or None without
    metrics. ``evaluation.extractor_weights`` is read as given, else
    relative to the repository's root (configs name repo-relative paths);
    a missing file raises."""
    if not cfg.evaluation.metrics:
        return None
    from dcvgan_torch.eval.evaluator import Evaluator
    from dcvgan_torch.eval.features import FeatureExtractor

    weights = None
    if cfg.evaluation.extractor_weights:
        weights = Path(cfg.evaluation.extractor_weights)
        if not weights.exists() and not weights.is_absolute() and (REPO_ROOT / weights).exists():
            weights = REPO_ROOT / weights
        if not weights.exists():
            raise FileNotFoundError(
                f"evaluation.extractor_weights not found: {cfg.evaluation.extractor_weights}"
            )
    return Evaluator(
        metrics=cfg.evaluation.metrics,
        num_samples=cfg.evaluation.num_samples,
        batchsize=cfg.evaluation.batchsize,
        dataset=dataset,
        extractor=FeatureExtractor(weights_path=weights, device=device),
        max_real_samples=cfg.evaluation.max_real_samples,
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
    evaluator = build_evaluator(cfg, dataset, device=args.device)
    trainer = Trainer(cfg, dataset, evaluator=evaluator, device=args.device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
