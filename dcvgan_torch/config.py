"""Experiment configuration: the YAML schema that sampling and training read.

Counterpart of ``dcvgan_tpu/config.py``, kept as the port's own copy. It
loads every file in ``configs/``: both YAML generations (the current schema
and the stale one with a merged ``gen:`` block and a string
``geometric_info``) migrate as in the JAX package, with the same defaults
and the same validation errors. Two keys are accepted and dropped:
``config_path`` (the loader's record of the file) and ``trainer.donate_state``
(eager PyTorch already updates the state in place); any other unknown key
raises, as the JAX loader raises. ``trainer.profile`` and
``trainer.debug_nans`` run in the trainer (``train/trainer.py``).

The opt-in levers (``shared_fakes``, ``critic_joint_batch``,
``critic_stat_reuse``, ``remat``, ``ggen_double_step``, ``norm: group``)
load here and run in the train step, as do the data-parallel layouts
(``sync_batchnorm``, ``mesh.data``, ``mesh.dcn``; ``parallel/mesh.py``)
and the time-sharded critics (``mesh.time``; ``parallel/temporal.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import yaml

# geometric-info name -> channel count (depth, flow, 25-class one-hot)
GEOMETRIC_INFO_CHANNELS = {
    "depth": 1,
    "optical-flow": 2,
    "segmentation": 25,
}
VALID_LOSSES = ("adversarial-loss", "hinge-loss")
VALID_METRICS = ("is", "fid", "prd", "fvd")
VALID_PRECISIONS = ("float32", "bfloat16")

# Keys of the full schema with no counterpart in the port, per section. They
# load and are ignored.
_IGNORED_KEYS = {
    "": {"config_path"},
    "trainer": {"donate_state"},
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
class OptimizerConfig:
    """Adam with coupled weight decay: ``torch.optim.Adam(lr, (b1, b2), eps,
    weight_decay=decay)``."""

    lr: float = 2e-4
    decay: float = 1e-5
    b1: float = 0.5
    b2: float = 0.999
    eps: float = 1e-8

    def validate(self) -> None:
        if self.lr <= 0:
            raise ConfigError(f"optimizer.lr must be positive, got {self.lr}")
        if self.decay < 0:
            raise ConfigError(f"optimizer.decay must be >= 0, got {self.decay}")


@dataclass
class GGenConfig:
    dim_z_content: int = 40
    dim_z_motion: int = 10
    ngf: int = 64
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)

    def validate(self) -> None:
        for k in ("dim_z_content", "dim_z_motion", "ngf"):
            if getattr(self, k) <= 0:
                raise ConfigError(f"ggen.{k} must be positive")
        self.optimizer.validate()


@dataclass
class CGenConfig:
    dim_z_color: int = 10
    ngf: int = 64
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)

    def validate(self) -> None:
        for k in ("dim_z_color", "ngf"):
            if getattr(self, k) <= 0:
                raise ConfigError(f"cgen.{k} must be positive")
        self.optimizer.validate()


@dataclass
class DiscriminatorConfig:
    """Shared schema of the idis / vdis / gdis blocks."""

    use_noise: bool = False
    noise_sigma: float = 0.0
    ndf: int = 64
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)

    def validate(self) -> None:
        if self.ndf <= 0:
            raise ConfigError("discriminator ndf must be positive")
        if self.noise_sigma < 0:
            raise ConfigError("noise_sigma must be >= 0")
        self.optimizer.validate()


@dataclass
class DatasetConfig:
    name: str = "mock"
    path: str = "data/raw/mock"
    n_workers: int = 4
    number_limit: int = -1
    processed_root: str = "data/processed"
    extension: str = "jpg"
    # keep decoded uint8 frame stacks in host RAM, one entry per video
    cache_decoded: bool = False

    def validate(self) -> None:
        if self.n_workers < 0:
            raise ConfigError("dataset.n_workers must be >= 0")


@dataclass
class EvaluationConfig:
    batchsize: int = 50
    num_samples: int = 200
    metrics: List[str] = field(default_factory=lambda: ["is", "fid"])
    extractor_weights: Optional[str] = None
    max_real_samples: int = 512

    def validate(self) -> None:
        if self.batchsize <= 0 or self.num_samples <= 0:
            raise ConfigError("evaluation.batchsize/num_samples must be positive")
        for m in self.metrics:
            if m not in VALID_METRICS:
                raise ConfigError(
                    f"evaluation.metrics entries must be in {VALID_METRICS}, got {m!r}"
                )


@dataclass
class MeshConfig:
    """The layout over the ranks of a process group
    (``parallel.create_layout``): ``data`` ranks (-1: all of them over
    ``dcn * time``, shrunk to a divisor of the batch) times an outer ``dcn``
    factor, times ``time`` ranks per data row that split the video critics'
    frames (it needs ``trainer.sync_batchnorm`` and ``dcn`` 1)."""

    data: int = -1
    time: int = 1
    dcn: int = 1

    def validate(self) -> None:
        if self.data == 0 or self.time <= 0 or self.dcn <= 0:
            raise ConfigError("mesh axes must be positive (data may be -1)")


@dataclass
class TrainerConfig:
    # compute dtype of the forward and backward passes; parameters,
    # gradients and Adam's moments stay float32
    precision: str = "bfloat16"
    # BatchNorm over the global batch of every rank; false: each rank's own
    # statistics (averaged into the running ones after each phase)
    sync_batchnorm: bool = True
    # "batch" (reference BatchNorm) or "group" (a lever)
    norm: str = "batch"
    ggen_double_step: bool = False
    # resume from the latest checkpoint in the run directory, if any
    resume: bool = True
    # a torch.profiler trace of the training loop into <run_dir>/profile
    profile: bool = False
    # raise FloatingPointError at the first step whose losses or gradients
    # are not finite (one device sync a step while on)
    debug_nans: bool = False
    remat: bool = False
    # ship uint8 frames to the device and dequantise there (ops/dequant.py)
    device_normalize: bool = True
    critic_stat_reuse: bool = False
    shared_fakes: bool = False
    critic_joint_batch: bool = False
    # > 0: the state carries an EMA of the generator parameters, advanced on
    # every generator optimizer step
    ema_decay: float = 0.0
    # sample logging reads the EMA generators when there are any
    ema_eval: bool = True
    # bound on train steps enqueued ahead of the device; 0 disables
    max_inflight_steps: int = 32


@dataclass
class ExperimentConfig:
    experiment_name: str = "debug"
    batchsize: int = 2
    n_epochs: int = 1
    seed: int = 0
    video_length: int = 16
    image_size: int = 64
    log_dir: str = "result/debug"
    tensorboard_dir: str = "result/debug/runs"
    log_interval: int = 1
    log_samples_interval: int = 1
    snapshot_interval: int = 1
    evaluation_interval: int = 1
    loss: str = "adversarial-loss"
    num_gen_update: int = 1
    num_dis_update: int = 1
    geometric_info: GeometricInfoConfig = field(default_factory=GeometricInfoConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    ggen: GGenConfig = field(default_factory=GGenConfig)
    cgen: CGenConfig = field(default_factory=CGenConfig)
    idis: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    vdis: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    gdis: DiscriminatorConfig = field(
        default_factory=lambda: DiscriminatorConfig(ndf=32, noise_sigma=0.2)
    )
    mesh: MeshConfig = field(default_factory=MeshConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    config_path: Optional[str] = None

    def validate(self) -> None:
        if self.batchsize <= 0:
            raise ConfigError("batchsize must be positive")
        if self.n_epochs <= 0:
            raise ConfigError("n_epochs must be positive")
        if self.video_length <= 1:
            raise ConfigError("video_length must be > 1")
        if self.image_size < 8 or self.image_size & (self.image_size - 1):
            raise ConfigError("image_size must be a power of two >= 8")
        if self.loss not in VALID_LOSSES:
            raise ConfigError(f"loss must be one of {VALID_LOSSES}, got {self.loss!r}")
        if self.num_gen_update <= 0 or self.num_dis_update <= 0:
            raise ConfigError("num_gen_update/num_dis_update must be positive")
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
        if self.trainer.norm == "group" and self.mesh.time > 1:
            raise ConfigError(
                "trainer.norm='group' is not supported with mesh.time > 1 "
                "(time-sharded critics implement masked batch statistics "
                "only)"
            )
        for sub in (
            self.geometric_info, self.dataset, self.evaluation, self.ggen, self.cgen,
            self.idis, self.vdis, self.gdis, self.mesh,
        ):
            sub.validate()

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "ExperimentConfig":
        return _build_dataclass(cls, migrate_legacy_schema(dict(raw)), path="")


def _build_dataclass(cls, raw: Dict[str, Any], path: str):
    if not isinstance(raw, dict):
        raise ConfigError(f"expected mapping at {path or '<root>'}, got {type(raw)}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(raw) - set(fields) - _IGNORED_KEYS.get(path, set())
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
    for c in (
        GeometricInfoConfig, OptimizerConfig, GGenConfig, CGenConfig,
        DiscriminatorConfig, DatasetConfig, EvaluationConfig, MeshConfig,
        TrainerConfig,
    )
}


def migrate_legacy_schema(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Migrate the stale reference schema: a merged ``gen:`` block becomes
    ``ggen``/``cgen``, a string or missing ``geometric_info`` a mapping."""
    if "gen" in raw:
        gen = raw.pop("gen")
        opt = gen.get("optimizer", {})
        raw.setdefault(
            "ggen",
            {
                "dim_z_content": gen.get("dim_z_content", 40),
                "dim_z_motion": gen.get("dim_z_motion", 10),
                "ngf": gen.get("ngf", 64),
                "optimizer": dict(opt),
            },
        )
        raw.setdefault(
            "cgen",
            {
                "dim_z_color": gen.get("dim_z_color", 10),
                "ngf": gen.get("ngf", 64),
                "optimizer": dict(opt),
            },
        )
    gi = raw.get("geometric_info")
    if gi is None:
        raw["geometric_info"] = {"name": "depth", "channel": 1}
    elif isinstance(gi, str):
        if gi not in GEOMETRIC_INFO_CHANNELS:
            raise ConfigError(f"unknown geometric_info {gi!r}")
        raw["geometric_info"] = {"name": gi, "channel": GEOMETRIC_INFO_CHANNELS[gi]}
    # optimizer keys the schema does not know are dropped, not refused
    known_opt = {f.name for f in dataclasses.fields(OptimizerConfig)}
    for block in ("ggen", "cgen", "idis", "vdis", "gdis"):
        opt = raw[block].get("optimizer") if isinstance(raw.get(block), dict) else None
        if isinstance(opt, dict):
            raw[block]["optimizer"] = {k: v for k, v in opt.items() if k in known_opt}
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


def save_config(cfg: ExperimentConfig, path: Union[str, Path]) -> None:
    """Write the resolved config back out: the run directory's copy."""
    d = cfg.to_dict()
    d.pop("config_path", None)
    with open(path, "w") as f:
        yaml.safe_dump(d, f, sort_keys=False)


def flatten_config(cfg: ExperimentConfig) -> Dict[str, str]:
    """Flatten to ``"a/b/c" -> str`` for TensorBoard hparams."""

    def _flat(item: Any, key: str) -> Dict[str, str]:
        if not isinstance(item, dict):
            return {key: str(item)}
        out: Dict[str, str] = {}
        for k, v in item.items():
            out.update(_flat(v, k if not key else f"{key}/{k}"))
        return out

    return _flat(cfg.to_dict(), "")
