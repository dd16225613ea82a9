"""End-to-end evaluation: sample -> embed -> score.

Counterpart of ``dcvgan_tpu/eval/evaluator.py`` on one device (no mesh).
Two paths:

- **in memory**: generated videos and real dataset clips go straight
  through the feature extractor. With ``device_resident=True`` (the
  default) each sampling round is quantised and embedded on the device
  where it was sampled, and only features and probabilities come to the
  host; otherwise the videos come to the host as uint8 first
  (``eval/sampler.generate_samples``). The two score the same.
- **directories**: :meth:`Evaluator.evaluate_dirs` scores directories of
  mp4 files.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dcvgan_torch import prng
from dcvgan_torch.eval.features import FeatureExtractor, default_extractor
from dcvgan_torch.eval.metrics import score_features
from dcvgan_torch.eval.sampler import generate_samples
from dcvgan_torch.utils.video_np import videos_to_uint8


class Evaluator:
    def __init__(
        self,
        metrics: Sequence[str],
        num_samples: int,
        batchsize: int,
        dataset=None,
        extractor: Optional[FeatureExtractor] = None,
        max_real_samples: int = 512,
    ):
        self.metrics = list(metrics)
        self.num_samples = num_samples
        self.batchsize = batchsize
        self.dataset = dataset
        self.extractor = extractor or default_extractor()
        # <= 0 embeds every clip of the dataset
        self.max_real_samples = max_real_samples
        self._real_cache: Optional[np.ndarray] = None

    # ------------------------------------------------------------ real side
    def _real_features(self) -> np.ndarray:
        """Features of a seeded random subset of the dataset with random
        temporal crops, streamed ``batchsize`` clips at a time (the JAX
        package's draws: the same clips and crops)."""
        if self._real_cache is not None:
            return self._real_cache
        if self.dataset is None:
            raise ValueError("reference dataset required for fid/prd")
        n = len(self.dataset)
        if self.max_real_samples > 0:
            n = min(n, self.max_real_samples)
        rng = np.random.default_rng(0)
        idx = rng.choice(len(self.dataset), size=n, replace=False)
        feat_chunks = []
        for s in range(0, n, self.batchsize):
            clips = np.stack([
                videos_to_uint8(self.dataset.sample(int(i), rng)["color"])
                for i in idx[s: s + self.batchsize]
            ])
            f, _ = self.extractor(clips, self.batchsize)
            feat_chunks.append(f)
        self._real_cache = np.concatenate(feat_chunks)
        return self._real_cache

    # ------------------------------------------------------------ fake side
    def evaluate(self, gan, state, gen: torch.Generator, device_resident: bool = True) -> Dict[str, float]:
        """Sample ``num_samples`` videos from ``state`` (round i from
        ``prng.for_step(gen, i)``) and compute the configured metrics."""
        if device_resident:
            feats, probs = self.sample_and_embed(gan, state, gen)
            return self._score(feats, probs)
        _, xc = generate_samples(gan, state, gen, self.num_samples, self.batchsize, with_geo=False)
        return self.score_videos(xc)

    def sample_and_embed(self, gan, state, gen: torch.Generator, num: Optional[int] = None):
        """ceil(num / batchsize) sampling rounds, each quantised and embedded
        on the device; returns (features, probabilities) as numpy."""
        num = self.num_samples if num is None else num
        feats: List[torch.Tensor] = []
        probs: List[torch.Tensor] = []
        for i in range((num + self.batchsize - 1) // self.batchsize):
            _, xc = gan.sample_videos(state, prng.for_step(gen, i), self.batchsize)
            f, p = self.extractor.device_embed(xc)
            feats.append(f)
            probs.append(p)
        return torch.cat(feats)[:num].cpu().numpy(), torch.cat(probs)[:num].cpu().numpy()

    def score_videos(self, videos_uint8: np.ndarray) -> Dict[str, float]:
        """Score uint8 ``(N, T, H, W, 3)`` generated videos."""
        feats, probs = self.extractor(videos_uint8, self.batchsize)
        return self._score(feats, probs)

    def _score(self, feats: np.ndarray, probs: np.ndarray) -> Dict[str, float]:
        return score_features(self.metrics, feats, probs, self._real_features)

    # ---------------------------------------------------------- directories
    def _embed_paths(self, paths):
        """Read and embed mp4 files ``batchsize`` at a time."""
        from dcvgan_torch.io.video import read_videos_parallel

        feat_chunks, prob_chunks = [], []
        for s in range(0, len(paths), self.batchsize):
            videos = np.stack(read_videos_parallel(paths[s: s + self.batchsize]))
            f, p = self.extractor(videos, self.batchsize)
            feat_chunks.append(f)
            prob_chunks.append(p)
        return np.concatenate(feat_chunks), np.concatenate(prob_chunks)

    def evaluate_dirs(self, gen_dir: Path, ref_dir: Optional[Path] = None) -> Dict[str, float]:
        """Score a directory of generated mp4 files, against a directory of
        real ones for fid / prd."""
        gen_paths = sorted(Path(gen_dir).glob("*.mp4"))
        if not gen_paths:
            raise FileNotFoundError(f"no .mp4 files in {gen_dir}")
        feats, probs = self._embed_paths(gen_paths)

        def ref_feats():
            if ref_dir is None:
                return None  # score_features raises "fid/prd need ..."
            ref_paths = sorted(Path(ref_dir).glob("*.mp4"))
            if 0 < self.max_real_samples < len(ref_paths):
                # the seeded random subset of _real_features
                rng = np.random.default_rng(0)
                idx = rng.choice(len(ref_paths), size=self.max_real_samples, replace=False)
                ref_paths = [ref_paths[i] for i in sorted(idx)]
            return self._embed_paths(ref_paths)[0]

        return score_features(self.metrics, feats, probs, ref_feats)
