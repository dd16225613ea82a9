"""Experiment configuration: the part of the YAML schema that sampling reads.

Counterpart of ``dcvgan_tpu/config.py``, kept as the port's own copy. It
loads every file in ``configs/``: both YAML generations (the current schema
and the stale one with a merged ``gen:`` block and a string
``geometric_info``) migrate as in the JAX package. Keys of the full schema
that belong to later slices of the port (the critics, the dataset, the
optimizers, the training knobs) are accepted and dropped; any other unknown
key raises, as the JAX loader raises.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Union

import yaml

# geometric-info name -> channel count (depth, flow, 25-class one-hot)
GEOMETRIC_INFO_CHANNELS = {
    "depth": 1,
    "optical-flow": 2,
    "segmentation": 25,
}
VALID_PRECISIONS = ("float32", "bfloat16")

# Keys of the full schema that this port does not read yet, per section
# ("" is the top level). They load and are ignored.
_LATER_SLICE_KEYS = {
    "": {
        "batchsize", "n_epochs", "log_dir", "tensorboard_dir", "log_interval",
        "log_samples_interval", "snapshot_interval", "evaluation_interval",
        "loss", "num_gen_update", "num_dis_update", "dataset", "evaluation",
        "idis", "vdis", "gdis", "mesh", "config_path",
    },
    "ggen": {"optimizer"},
    "cgen": {"optimizer"},
    "trainer": {
        "sync_batchnorm", "ggen_double_step", "resume", "profile",
        "debug_nans", "remat", "donate_state", "device_normalize",
        "critic_stat_reuse", "shared_fakes", "critic_joint_batch",
        "ema_eval", "max_inflight_steps",
    },
}


class ConfigError(ValueError):
    """Raised when a config file fails schema validation."""


@dataclass
class GeometricInfoConfig:
    name: str = "depth"
    channel: int = 1

    def validate(self) -> None:
        if self.name not in GEOMETRIC_INFO_CHANNELS:
            raise ConfigError(
                f"geometric_info.name must be one of "
                f"{sorted(GEOMETRIC_INFO_CHANNELS)}, got {self.name!r}"
            )
        expected = GEOMETRIC_INFO_CHANNELS[self.name]
        if self.channel != expected:
            raise ConfigError(
                f"geometric_info.channel for {self.name!r} must be {expected}, "
                f"got {self.channel}"
            )


@dataclass
class GGenConfig:
    dim_z_content: int = 40
    dim_z_motion: int = 10
    ngf: int = 64

    def validate(self) -> None:
        for k in ("dim_z_content", "dim_z_motion", "ngf"):
            if getattr(self, k) <= 0:
                raise ConfigError(f"ggen.{k} must be positive")


@dataclass
class CGenConfig:
    dim_z_color: int = 10
    ngf: int = 64

    def validate(self) -> None:
        for k in ("dim_z_color", "ngf"):
            if getattr(self, k) <= 0:
                raise ConfigError(f"cgen.{k} must be positive")


@dataclass
class TrainerConfig:
    # compute dtype of the generators; parameters arrive as float32
    precision: str = "bfloat16"
    # "batch" (reference BatchNorm) or "group" (not ported yet)
    norm: str = "batch"
    # > 0 when a checkpoint carries an EMA of the generator parameters
    ema_decay: float = 0.0


@dataclass
class ExperimentConfig:
    experiment_name: str = "debug"
    seed: int = 0
    video_length: int = 16
    image_size: int = 64
    geometric_info: GeometricInfoConfig = field(default_factory=GeometricInfoConfig)
    ggen: GGenConfig = field(default_factory=GGenConfig)
    cgen: CGenConfig = field(default_factory=CGenConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    config_path: Optional[str] = None

    def validate(self) -> None:
        if self.video_length <= 1:
            raise ConfigError("video_length must be > 1")
        if self.image_size < 8 or self.image_size & (self.image_size - 1):
            raise ConfigError("image_size must be a power of two >= 8")
        if self.trainer.precision not in VALID_PRECISIONS:
            raise ConfigError(
                f"trainer.precision must be one of {VALID_PRECISIONS}, "
                f"got {self.trainer.precision!r}"
            )
        if self.trainer.norm not in ("batch", "group"):
            raise ConfigError(
                f"trainer.norm must be 'batch' or 'group', got {self.trainer.norm!r}"
            )
        if not 0.0 <= self.trainer.ema_decay < 1.0:
            raise ConfigError(
                f"trainer.ema_decay must be in [0, 1), got {self.trainer.ema_decay}"
            )
        for sub in (self.geometric_info, self.ggen, self.cgen):
            sub.validate()

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "ExperimentConfig":
        return _build_dataclass(cls, migrate_legacy_schema(dict(raw)), path="")


def _build_dataclass(cls, raw: Dict[str, Any], path: str):
    if not isinstance(raw, dict):
        raise ConfigError(f"expected mapping at {path or '<root>'}, got {type(raw)}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(raw) - set(fields) - _LATER_SLICE_KEYS.get(path, set())
    if unknown:
        raise ConfigError(
            f"unknown config key(s) at {path or '<root>'}: {sorted(unknown)}"
        )
    kwargs: Dict[str, Any] = {}
    for name, f in fields.items():
        if name not in raw:
            continue
        sub = f"{path}.{name}" if path else name
        target = _DATACLASS_NAMES.get(f.type) if isinstance(f.type, str) else None
        if target is not None:
            kwargs[name] = _build_dataclass(target, raw[name], sub)
        else:
            kwargs[name] = raw[name]
    return cls(**kwargs)


_DATACLASS_NAMES = {
    c.__name__: c
    for c in (GeometricInfoConfig, GGenConfig, CGenConfig, TrainerConfig)
}


def migrate_legacy_schema(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Migrate the stale reference schema: a merged ``gen:`` block becomes
    ``ggen``/``cgen``, a string or missing ``geometric_info`` a mapping."""
    if "gen" in raw:
        gen = raw.pop("gen")
        raw.setdefault(
            "ggen",
            {
                "dim_z_content": gen.get("dim_z_content", 40),
                "dim_z_motion": gen.get("dim_z_motion", 10),
                "ngf": gen.get("ngf", 64),
            },
        )
        raw.setdefault(
            "cgen",
            {"dim_z_color": gen.get("dim_z_color", 10), "ngf": gen.get("ngf", 64)},
        )
    gi = raw.get("geometric_info")
    if gi is None:
        raw["geometric_info"] = {"name": "depth", "channel": 1}
    elif isinstance(gi, str):
        if gi not in GEOMETRIC_INFO_CHANNELS:
            raise ConfigError(f"unknown geometric_info {gi!r}")
        raw["geometric_info"] = {"name": gi, "channel": GEOMETRIC_INFO_CHANNELS[gi]}
    return raw


def load_config(path: Union[str, Path]) -> ExperimentConfig:
    """Load, migrate and validate a YAML config; record its path."""
    path = Path(path)
    with open(path) as f:
        raw = yaml.safe_load(f)
    if not isinstance(raw, dict):
        raise ConfigError(f"config file {path} did not parse to a mapping")
    cfg = ExperimentConfig.from_dict(raw)
    cfg.config_path = str(path)
    cfg.validate()
    return cfg
