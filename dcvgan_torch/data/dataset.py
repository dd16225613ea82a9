"""Map-style video dataset with random temporal cropping.

Counterpart of ``dcvgan_tpu/data/dataset.py``, kept as the port's own copy:
the same files give the same bytes. The four modality branches and their
normalisations:

- color:       uint8 frames -> float32 / 127.5 - 1           in [-1, 1]
- depth:       grayscale frames -> float32 / 127.5 - 1        in [-1, 1]
- depth (surreal): ``depth.npy``, background (1e10) -> 1.0, human depth
                min-max normalized into [-1, 0.8]
- optical-flow: ``optical-flow.npy`` / image_size
- segmentation: ``segm.npy`` -> 25-class one-hot float32

Samples are **channels-last** ``(T, H, W, C)``, randomness comes from an
explicit ``np.random.Generator``, and preprocessing is dispatched through a
registry (``data/preprocess``).
"""

from __future__ import annotations

import shutil
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from dcvgan_torch import native
from dcvgan_torch.io.image import read_img

PreprocessFunc = Callable[[Path, Path, str, int, int, int], None]

NUM_SEGM_PARTS = 25
SURREAL_BACKGROUND = 1e10


class VideoDataset:
    """Fixed-length video dataset over a preprocessed directory tree.

    Directory contract (written by the preprocessors, read here):
    ``<processed_root>/<name>/<mode>/list.txt`` of ``<video_dir> <n_frames>``
    lines; each video dir holds ``color/NNN.<ext>`` frames plus the
    modality-specific geometry files.
    """

    def __init__(
        self,
        name: str,
        dataset_path: Union[str, Path, None] = None,
        preprocess_func: Optional[PreprocessFunc] = None,
        video_length: int = 16,
        image_size: int = 64,
        number_limit: int = -1,
        geometric_info: str = "depth",
        mode: str = "train",
        extension: str = "jpg",
        processed_root: Union[str, Path] = "data/processed",
        raw_uint8: bool = False,
        cache_decoded: bool = False,
    ):
        root_path = Path(processed_root) / name / mode
        if not root_path.exists():
            if preprocess_func is None:
                raise FileNotFoundError(
                    f"processed dataset missing at {root_path} and no "
                    f"preprocess_func given"
                )
            # cold-start preprocessing with rollback on failure
            print(f">> Preprocessing ... (->{root_path})")
            root_path.mkdir(parents=True, exist_ok=True)
            try:
                preprocess_func(
                    Path(dataset_path), root_path, mode, video_length, image_size, -1
                )
            except Exception:
                shutil.rmtree(str(root_path))
                raise

        with open(root_path / "list.txt") as f:
            lines = f.readlines()
        if number_limit != -1:
            lines = lines[:number_limit]

        video_list: List[Tuple[Path, int]] = []
        for line in lines:
            video_path, n_frames = line.strip().split(" ")
            video_list.append((root_path / video_path, int(n_frames)))

        self.name = name
        self.dataset_path = Path(dataset_path) if dataset_path else None
        self.root_path = root_path
        self.video_list = video_list
        self.video_length = video_length
        self.image_size = image_size
        self.geometric_info = geometric_info
        self.ext = extension
        # raw_uint8: skip the normalisation on the host for uint8 modalities
        # (color + non-surreal depth); the train step dequantises on the
        # device (ops/dequant.py), a quarter of the bytes to transfer.
        self.raw_uint8 = raw_uint8
        # cache_decoded: keep full decoded uint8 frame stacks in RAM (one
        # entry per video). Image decode is the hot loop on the host; for
        # datasets that fit memory this removes it entirely after the first
        # epoch. Thread-safe for the loader's worker pool.
        self.cache_decoded = cache_decoded
        self._cache: Dict[Tuple[str, int], np.ndarray] = {}
        self._cache_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.video_list)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        # Deterministic per-index crop so bare indexing is reproducible; the
        # loader drives per-(seed, epoch, batch, position) RNGs for training.
        return self.sample(i, np.random.default_rng((0xDC, i)))

    def sample(
        self, i: int, rng: np.random.Generator
    ) -> Dict[str, np.ndarray]:
        """Load sample ``i`` with an explicit RNG for the temporal crop.

        Returns ``{"color": (T, H, W, 3) f32, <geo>: (T, H, W, Cg) f32}``.
        """
        path, n_frames = self.video_list[i]

        # random temporal window: n_frames must exceed video_length, crop
        # start in [0, n - L)
        if n_frames < self.video_length + 1:
            raise ValueError(
                f"video length is insufficient: n:{n_frames}, path:{path}"
            )
        t = int(rng.integers(0, n_frames - self.video_length))
        frames_to_read = range(t, t + self.video_length)

        color_video = self._read_color(path, frames_to_read, n_frames)
        geo_video = self._read_geometry(path, frames_to_read, n_frames)
        return {"color": color_video, self.geometric_info: geo_video}

    # ------------------------------------------------------------ modalities
    def _decode_frames(
        self, kind: str, path: Path, frames: range, n_frames: int, grayscale: bool
    ) -> np.ndarray:
        """Decode the requested window; with cache_decoded, decode the full
        video once and serve windows from RAM."""
        placeholder = str(path / kind / ("{:03d}." + self.ext))
        if not self.cache_decoded:
            return np.stack(
                [read_img(placeholder.format(i), grayscale=grayscale) for i in frames]
            )
        key = (kind, str(path))
        video = self._cache.get(key)
        if video is None:
            video = np.stack(
                [
                    read_img(placeholder.format(i), grayscale=grayscale)
                    for i in range(n_frames)
                ]
            )
            with self._cache_lock:
                self._cache[key] = video
        return video[frames.start : frames.stop]

    def _read_color(self, path: Path, frames: range, n_frames: int) -> np.ndarray:
        video = self._decode_frames("color", path, frames, n_frames, False)
        if self.raw_uint8:
            return video  # (T, H, W, 3) uint8; device dequantizes
        return native.normalize_u8(video, 127.5, -1.0)  # (T, H, W, 3)

    def _read_geometry(self, path: Path, frames: range, n_frames: int) -> np.ndarray:
        gi = self.geometric_info
        if gi == "depth" and self.name == "surreal":
            return self._read_surreal_depth(path, frames)
        if gi == "depth":
            video = self._decode_frames(gi, path, frames, n_frames, True)
            if self.raw_uint8:
                return video  # (T, H, W, 1) uint8; device dequantizes
            return native.normalize_u8(video, 127.5, -1.0)  # (T, H, W, 1)
        if gi == "optical-flow":
            flow = np.load(str(path / (gi + ".npy")), mmap_mode="r")
            flow = np.asarray(flow[list(frames)], dtype=np.float32)
            flow = native.scale_f32(flow, 1.0 / self.image_size)  # (T, H, W, 2)
            if self.raw_uint8:
                # ship half precision: 2x less host->device transfer; the
                # train step upcasts on device. Normalized flow is raw
                # displacement / image_size, so |v| approaches 1.0 for
                # image-sized motion; the float16 rounding error there is
                # <= ~5e-4 absolute (half ulp for |v| <= 2) — still ~8x
                # finer than the color path's own uint8 quantization grid
                # (1/255 in [-1,1]). Typical small motion (|v| < 0.25)
                # rounds at <= 1.2e-4.
                return flow.astype(np.float16)
            return flow
        if gi == "segmentation":
            segm = np.load(str(path / "segm.npy"), mmap_mode="r")
            segm = np.asarray(segm[list(frames)])
            if self.raw_uint8:
                # ship class labels, not one-hot: 25x less host->device
                # transfer; the train step one-hots on device
                return segm[..., None]  # (T, H, W, 1) uint8
            return native.one_hot(segm, NUM_SEGM_PARTS)  # (T, H, W, 25)
        raise NotImplementedError(f"geometric_info {gi!r}")

    def _read_surreal_depth(self, path: Path, frames: range) -> np.ndarray:
        # background pixels (1e10) map to 1.0; human depth is min-max
        # normalised to [-1, 0.8]
        depth_raw = np.load(str(path / "depth.npy"), mmap_mode="r")
        depth_raw = np.asarray(depth_raw[list(frames)])

        human_masks = depth_raw < SURREAL_BACKGROUND
        human_depth = depth_raw[human_masks]

        t, h, w = depth_raw.shape
        geo_video = np.ones((t, h, w), dtype=np.float32)
        if len(human_depth) == 0:
            return geo_video[..., None]

        ma, mi = human_depth.max(), human_depth.min()
        if ma - mi > 0:
            human_depth = (human_depth - mi) / (ma - mi)
        human_depth = human_depth * 1.8 - 1.0  # [-1.0, 0.8]; 1.0 = background
        geo_video[human_masks] = human_depth
        return geo_video[..., None]  # (T, H, W, 1)
