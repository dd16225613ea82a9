"""Metric registry + console/file/TensorBoard logger.

The port's own copy of ``dcvgan_tpu/logging/logger.py``: a metric registry
with types (Integer/Float/Loss/Time), priorities for display ordering, loss
averaging between flushes, fixed-width table console output, and
tensorboardX scalars/histograms/videos/hparams.

- videos come in channels-last ``(B, T, H, W, C)`` and are transposed at the
  TB boundary (tensorboardX wants ``(B, T, C, H, W)``),
- tensorboardX is optional (gated import): without it only the console and
  the log file are written.
"""

from __future__ import annotations

import datetime
import enum
import logging
import sys
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

try:
    from tensorboardX import SummaryWriter

    _HAS_TB = True
except Exception:  # pragma: no cover
    SummaryWriter = None
    _HAS_TB = False


class _ColorFormatter(logging.Formatter):
    """Level-colored console lines via raw ANSI codes. Colors only when the
    stream is a tty so piped/captured output stays clean."""

    COLORS = {
        logging.DEBUG: "\x1b[36m",     # cyan
        logging.INFO: "\x1b[32m",      # green
        logging.WARNING: "\x1b[33m",   # yellow
        logging.ERROR: "\x1b[31m",     # red
        logging.CRITICAL: "\x1b[1;31m",
    }
    RESET = "\x1b[0m"

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        color = self.COLORS.get(record.levelno)
        if color:
            return f"{color}{msg}{self.RESET}"
        return msg


class MetricType(enum.IntEnum):
    Integer = 1
    Float = 2
    Loss = 3  # running list, averaged on flush
    Time = 4  # elapsed seconds since registration


class Metric:
    def __init__(self, mtype: MetricType, priority: int, tensorboard: bool):
        self.mtype = mtype
        self.priority = priority
        self.log_to_tensorboard = tensorboard
        self.params: Dict[str, Any] = {}
        self.value: Any = 0


class Logger:
    """Console + file + TensorBoard logger with a typed metric registry."""

    def __init__(self, out_path: Union[str, Path], tb_path: Union[str, Path, None] = None):
        out_path = Path(out_path)
        out_path.mkdir(parents=True, exist_ok=True)
        self.path = out_path
        # name by the FULL resolved path: two Loggers with the same leaf
        # directory name must not share (and clobber) each other's handlers
        self._logger = self._new_logging_module(
            f"dcvgan.{Path(out_path).resolve()}", out_path / "log"
        )

        self.metrics: "OrderedDict[str, Metric]" = OrderedDict()

        self.tb_path: Optional[Path] = None
        self.tf_writer = None
        if tb_path is not None and _HAS_TB:
            tb_path = Path(tb_path)
            tb_path.mkdir(parents=True, exist_ok=True)
            self.tb_path = tb_path
            self.tf_writer = SummaryWriter(str(tb_path))

        # default metrics
        self.define("epoch", MetricType.Integer, 100, tensorboard=False)
        self.define("iteration", MetricType.Integer, 99, tensorboard=False)
        self.define("elapsed_time", MetricType.Time, -1, tensorboard=False)

        self.indent = " " * 4

    @staticmethod
    def _new_logging_module(name: str, log_file: Path) -> logging.Logger:
        log_format = "[%(asctime)s] %(message)s"
        date_format = "%Y-%m-%d %H:%M:%S"
        logger = logging.getLogger(name)
        logger.setLevel(logging.DEBUG)
        for h in logger.handlers:  # re-created logger for the same dir
            h.close()
        logger.handlers.clear()
        ch = logging.StreamHandler()
        ch.setLevel(logging.DEBUG)
        use_color = hasattr(sys.stderr, "isatty") and sys.stderr.isatty()
        formatter_cls = _ColorFormatter if use_color else logging.Formatter
        ch.setFormatter(formatter_cls(log_format, datefmt=date_format))
        logger.addHandler(ch)
        fh = logging.FileHandler(str(log_file))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(log_format, datefmt=date_format))
        logger.addHandler(fh)
        logger.propagate = False
        return logger

    # --------------------------------------------------------------- registry
    def define(
        self,
        name: str,
        mtype: MetricType,
        priority: int = 0,
        tensorboard: bool = True,
    ) -> None:
        metric = Metric(mtype, priority, tensorboard)
        if mtype in (MetricType.Integer, MetricType.Float):
            metric.value = None
        elif mtype == MetricType.Loss:
            metric.value = []
        elif mtype == MetricType.Time:
            metric.value = 0
            metric.params["start_time"] = time.time()
        self.metrics[name] = metric
        self.metrics = OrderedDict(
            sorted(self.metrics.items(), key=lambda kv: kv[1].priority, reverse=True)
        )

    def metric_keys(self) -> List[str]:
        return list(self.metrics.keys())

    def update(self, name: str, value: Any) -> None:
        m = self.metrics[name]
        if m.mtype in (MetricType.Integer, MetricType.Float):
            m.value = value
        elif m.mtype == MetricType.Loss:
            m.value.append(float(value))
        elif m.mtype == MetricType.Time:
            m.value = value - m.params["start_time"]

    def clear(self) -> None:
        for m in self.metrics.values():
            if m.mtype in (MetricType.Integer, MetricType.Float):
                m.value = None
            elif m.mtype == MetricType.Loss:
                m.value = []

    # ---------------------------------------------------------------- output
    def _format(self, m: Metric) -> str:
        if m.mtype == MetricType.Integer:
            return "-" if m.value is None else f"{m.value}"
        if m.mtype == MetricType.Float:
            return "-" if m.value is None else f"{m.value:0.3f}"
        if m.mtype == MetricType.Loss:
            if not m.value:
                return " - "
            return f"{sum(m.value) / len(m.value):0.3f}"
        if m.mtype == MetricType.Time:
            return str(datetime.timedelta(seconds=int(m.value)))
        raise AssertionError(m.mtype)

    def print_header(self) -> None:
        self._header_columns = list(self.metrics)
        self.info("".join(f"{name:>15} " for name in self.metrics))

    def log(self, x_axis_metric: str = "iteration") -> None:
        """Flush: scalars to TB, one fixed-width row to console/file."""
        self.update("elapsed_time", time.time())
        self.tf_log_scalars(x_axis_metric)
        # metrics defined after the last header (e.g. evaluator-derived
        # scores) change the column set — reprint so rows stay aligned
        if getattr(self, "_header_columns", None) is not None and (
            self._header_columns != list(self.metrics)
        ):
            self.print_header()
        self.info("".join(f"{self._format(m):>15} " for m in self.metrics.values()))

    # ----------------------------------------------------------- tensorboard
    def tf_log_scalars(self, x_axis_metric: str = "iteration") -> None:
        if self.tf_writer is None:
            return
        x = self.metrics[x_axis_metric]
        if x.mtype not in (MetricType.Integer, MetricType.Float):
            raise ValueError(f"invalid x-axis metric type: {x.mtype!r}")
        step = x.value
        for name, m in self.metrics.items():
            if not m.log_to_tensorboard:
                continue
            if m.mtype in (MetricType.Integer, MetricType.Float):
                if m.value is None:
                    continue
                value = m.value
            elif m.mtype == MetricType.Loss:
                if not m.value:
                    continue
                value = sum(m.value) / len(m.value)
            else:
                continue
            self.tf_writer.add_scalar(name, value, step)

    def tf_log_histogram(self, x: np.ndarray, tag: str, step: int) -> None:
        if self.tf_writer is not None:
            self.tf_writer.add_histogram(tag, x, step)

    def tf_log_video(self, video: np.ndarray, tag: str, step: int, fps: int = 8) -> None:
        """Log a uint8 channels-last (B, T, H, W, C) video as a TB GIF."""
        if self.tf_writer is not None:
            self.tf_writer.add_video(
                tag, video.transpose(0, 1, 4, 2, 3), fps=fps, global_step=step
            )

    def tf_log_hparams(self, values: Dict[str, str]) -> None:
        if self.tf_writer is not None:
            self.tf_writer.add_hparams(values, {})

    # -------------------------------------------------------------- plumbing
    def info(self, msg: str, level: int = 0) -> None:
        self._logger.info(self.indent * level + msg)

    def debug(self, msg: str, level: int = 0) -> None:
        self._logger.debug(self.indent * level + msg)

    def warning(self, msg: str, level: int = 0) -> None:
        self._logger.warning(self.indent * level + msg)

    def error(self, msg: str, level: int = 0) -> None:
        self._logger.error(self.indent * level + msg)
