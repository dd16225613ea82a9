"""Video feature extractor for IS / FID / PRD.

Counterpart of ``dcvgan_tpu/eval/features.py``. Two topologies:

- :class:`C3DFeatures`: a compact C3D-style tower over ``(B, T, H, W, 3)``
  videos on the [0, 1] scale (five 3x3x3 conv stages, a global mean, a
  hidden dense layer and a classifier head);
- :class:`C3D`: the canonical C3D (Tran et al. 2015) over 112x112 frames on
  the 0-255 scale, fc6 features and fc8 logits.

Weights are either **loaded** from an ``.npz`` written for the JAX package
(flax trees: ``<layer>/kernel``, ``<layer>/bias``, ``__meta__/...``), then
the fingerprint is the JAX package's own string for that file, so that
scores from the two packages under one file are comparable; or **seeded**
(no file): a fixed random projection drawn with torch, fingerprinted
``c3d-seeded-torch/seed=N``, never equal to the JAX package's seeded
extractor (whose flax init torch cannot redraw).

Public functions take and return the JAX package's channels-last layout;
the modules run channels-first (``NCDHW``) inside.

Precision: the extractor runs its float32 convolutions in full float32. On
CUDA it turns cuDNN's TF32 off for its own forward and restores the caller's
setting after (:func:`_full_f32`), so that features do not depend on the
global ``torch.backends.cudnn.allow_tf32`` and agree with the JAX package's
float32 features. Its dense layers follow ``torch.backends.cuda.matmul``,
whose default is full float32.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dcvgan_torch.utils.device import resolve_device

Device = Optional[Union[str, torch.device]]


def _max_pool_same(x: torch.Tensor, window: Tuple[int, int, int]) -> torch.Tensor:
    """flax ``max_pool(x, window, strides=window, padding="SAME")`` on
    ``NCDHW``: each odd extent is padded at its end with -inf, then pooled."""
    pads = []
    for size, w in zip(reversed(x.shape[2:]), reversed(window)):
        total = max(-(-size // w) * w - size, 0)
        pads += [total // 2, total - total // 2]
    if any(pads):
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool3d(x, window, window)


class C3DFeatures(nn.Module):
    """C3D-style tower: stages of width ``w, 2w, 4w, 4w, 8w``, each a 3x3x3
    conv + ReLU and a max pool of (1, 2, 2) for the first stage and (2, 2, 2)
    after; a global mean, ``fc`` + ReLU (the features) and ``head`` (the
    logits)."""

    def __init__(self, num_classes: int = 101, width: int = 64, feature_dim: int = 512):
        super().__init__()
        stages = [width, width * 2, width * 4, width * 4, width * 8]
        cin = 3
        for i, cout in enumerate(stages):
            setattr(self, f"conv{i}", nn.Conv3d(cin, cout, 3, padding=1))
            cin = cout
        self.n_stages = len(stages)
        self.fc = nn.Linear(cin, feature_dim)
        self.head = nn.Linear(feature_dim, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x``: ``(B, T, H, W, 3)`` -> (features ``(B, feature_dim)``,
        logits ``(B, num_classes)``)."""
        x = x.permute(0, 4, 1, 2, 3)
        for i in range(self.n_stages):
            x = F.relu(getattr(self, f"conv{i}")(x))
            x = _max_pool_same(x, (1 if i == 0 else 2, 2, 2))
        feats = F.relu(self.fc(x.mean(dim=(2, 3, 4))))
        return feats, self.head(feats)


class C3D(nn.Module):
    """Canonical C3D over ``(B, 16, 112, 112, 3)``: conv1-conv5b with
    (1, 2, 2) / (2, 2, 2) max pools, pool5 zero-padded by 1 on H and W,
    fc6 / fc7 (4096) and fc8. Returns (fc6 features, fc8 logits)."""

    LAYERS = [("conv1", 3, 64), ("conv2", 64, 128), ("conv3a", 128, 256), ("conv3b", 256, 256),
              ("conv4a", 256, 512), ("conv4b", 512, 512), ("conv5a", 512, 512), ("conv5b", 512, 512)]
    POOL_AFTER = {"conv1": 1, "conv2": 2, "conv3b": 2, "conv4b": 2}  # temporal window

    def __init__(self, num_classes: int = 487):
        super().__init__()
        for name, cin, cout in self.LAYERS:
            setattr(self, name, nn.Conv3d(cin, cout, 3, padding=1))
        self.fc6 = nn.Linear(8192, 4096)
        self.fc7 = nn.Linear(4096, 4096)
        self.fc8 = nn.Linear(4096, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 4, 1, 2, 3)
        for name, _, _ in self.LAYERS:
            x = F.relu(getattr(self, name)(x))
            if name in self.POOL_AFTER:
                t = self.POOL_AFTER[name]
                x = F.max_pool3d(x, (t, 2, 2), (t, 2, 2))
        return self.pool5_fc(x)

    def pool5_fc(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pool5, the flatten and fc6-fc8 from conv5b's ``NCDHW`` output."""
        x = F.max_pool3d(F.pad(x, (1, 1, 1, 1)), 2, 2)  # (B, 512, 1, 4, 4)
        # the flax weights flatten in (T, H, W, C) order
        x = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
        feats = F.relu(self.fc6(x))
        return feats, self.fc8(F.relu(self.fc7(feats)))


def _state_dict_from_flax(params: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """flax ``Conv`` kernels ``(kt, kh, kw, cin, cout)`` -> ``(cout, cin, kt,
    kh, kw)``; ``Dense`` kernels ``(in, out)`` -> ``(out, in)``; biases as
    they are."""
    sd = {}
    for layer, leaves in params.items():
        kernel = np.asarray(leaves["kernel"], np.float32)
        w = kernel.transpose(4, 3, 0, 1, 2) if kernel.ndim == 5 else kernel.T
        sd[f"{layer}.weight"] = torch.from_numpy(np.array(w, order="C"))
        sd[f"{layer}.bias"] = torch.from_numpy(np.array(leaves["bias"], np.float32))
    return sd


def _flax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of :func:`_state_dict_from_flax`: ``(cout, cin, kt, kh,
    kw)`` -> ``(kt, kh, kw, cin, cout)``, ``(out, in)`` -> ``(in, out)``, as
    float32 numpy, layers and leaves in sorted order (the flax tree's)."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for key in sorted(sd):
        layer, leaf = key.rsplit(".", 1)
        v = sd[key].detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            params.setdefault(layer, {})["kernel"] = np.ascontiguousarray(
                v.transpose(2, 3, 4, 1, 0) if v.ndim == 5 else v.T)
        else:
            params.setdefault(layer, {})["bias"] = v.copy()
    return {layer: dict(sorted(leaves.items())) for layer, leaves in params.items()}


def load_npz(path: Path) -> Tuple[Dict[str, Dict[str, np.ndarray]], Dict[str, object]]:
    """An extractor npz as (``{layer: {leaf: array}}``, ``{meta name:
    value}``)."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    meta: Dict[str, object] = {}
    with np.load(path, allow_pickle=False) as raw:
        for k in raw.files:
            v = raw[k]
            if k.startswith("__meta__/"):
                meta[k.split("/", 1)[1]] = str(v) if v.dtype.kind in "US" else np.asarray(v)
                continue
            layer, leaf = k.split("/")
            params.setdefault(layer, {})[leaf] = v
    return params, meta


def quantize(videos_pm1: torch.Tensor) -> torch.Tensor:
    """``[-1, 1]`` float videos -> float32 integers on the 0-255 scale, on
    their device. Equals the host path's ``videos_to_uint8`` bit for bit:
    the same float32 ``(clip(v, -1, 1) + 1) / 2 * 255``, truncated by
    ``floor`` (the operands are not negative)."""
    x = videos_pm1.to(torch.float32).clamp(-1.0, 1.0)
    return torch.floor((x + 1.0) / 2.0 * 255.0)


@contextlib.contextmanager
def _full_f32():
    """cuDNN convolutions in full float32 (TF32 off) inside, the caller's
    setting restored after."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class FeatureExtractor:
    """Fixed weights on one device; embeds videos into (features, class
    probabilities). ``device`` defaults to ``cuda`` and raises without one."""

    def __init__(
        self,
        weights_path: Optional[Union[str, Path]] = None,
        seed: int = 0,
        num_classes: int = 101,
        width: int = 64,
        device: Device = None,
    ):
        self.device = resolve_device(device)
        mean = None  # (3,) channel means on the 0-255 scale (C3D only)
        if weights_path is not None:
            params, meta = load_npz(Path(weights_path))
            topology = meta.get("topology", "small")
            if topology == "c3d":
                model: nn.Module = C3D(num_classes=int(params["fc8"]["bias"].shape[0]))
                mean = meta.get("mean")
            else:
                # width and feature size from the stored tree itself
                model = C3DFeatures(
                    num_classes=int(params["head"]["bias"].shape[0]),
                    width=int(params["conv0"]["bias"].shape[0]),
                    feature_dim=int(params["fc"]["bias"].shape[0]),
                )
            model.load_state_dict(_state_dict_from_flax(params))
            digest = hashlib.sha256(Path(weights_path).read_bytes()).hexdigest()
            self.fingerprint = f"{topology}-npz/sha256={digest[:16]}"
        else:
            model = C3DFeatures(num_classes=num_classes, width=width)
            _seed_parameters(model, seed)
            self.fingerprint = f"c3d-seeded-torch/seed={seed}"
            if width != 64:  # another tower is another embedding
                self.fingerprint += f",width={width}"
        self.model = model.to(self.device).eval()
        self.is_c3d = isinstance(model, C3D)
        self.mean = None if mean is None else torch.as_tensor(np.asarray(mean, np.float32),
                                                              device=self.device)

    def _apply(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x``: float32 ``(B, T, H, W, 3)`` holding integers on the 0-255
        scale, on the extractor's device -> (features, probabilities)."""
        if self.is_c3d:
            # the C3D protocol: 112x112 frames (bilinear, half-pixel
            # centres), 0-255 scale, channel means subtracted
            b, t, h, w, c = x.shape
            frames = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
            frames = F.interpolate(frames, size=(112, 112), mode="bilinear",
                                   align_corners=False, antialias=False)
            x = frames.permute(0, 2, 3, 1).reshape(b, t, 112, 112, c)
            if self.mean is not None:
                x = x - self.mean
        else:
            x = x / 255.0
        with torch.inference_mode(), _full_f32():
            f, logits = self.model(x)
        return f, torch.softmax(logits, dim=-1)

    def device_embed(self, videos_pm1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Embed generator output (``[-1, 1]`` float videos) on the
        extractor's device: only features and probabilities come out."""
        return self._apply(quantize(videos_pm1.to(self.device)))

    def __call__(self, videos_uint8: np.ndarray, batchsize: int = 32) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 ``(N, T, H, W, 3)`` on the host -> (features ``(N, D)``,
        probabilities ``(N, K)``) as numpy, in chunks of ``batchsize``."""
        feats, probs = [], []
        for s in range(0, videos_uint8.shape[0], batchsize):
            chunk = torch.from_numpy(np.ascontiguousarray(videos_uint8[s: s + batchsize]))
            f, p = self._apply(chunk.to(self.device).float())
            feats.append(f)
            probs.append(p)
        if not feats:
            raise ValueError("no videos to embed")
        return torch.cat(feats).cpu().numpy(), torch.cat(probs).cpu().numpy()


def _seed_parameters(model: nn.Module, seed: int) -> None:
    """Every weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's
    default bound for convolutions and linear layers), drawn on the CPU from
    ``seed``, so that the weights are the same on every device."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv3d, nn.Linear)):
                bound = m.weight[0].numel() ** -0.5
                for p in (m.weight, m.bias):
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))


@functools.lru_cache(maxsize=2)
def default_extractor(seed: int = 0, device: Optional[str] = None) -> FeatureExtractor:
    return FeatureExtractor(seed=seed, device=device)
