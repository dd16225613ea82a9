"""Training runtime: the epoch/step loop around the train step.

Counterpart of ``dcvgan_tpu/train/trainer.py`` on one device. Interval
semantics (log / log_samples / snapshot / evaluation) and the metric set are
the JAX trainer's:

- losses stay on the device and are fetched once per ``log_interval``, so
  the step loop does not wait for the device;
- batches come from the prefetching loader as numpy and cross to the device
  through pinned host memory with non-blocking copies;
- at most ``trainer.max_inflight_steps`` steps are enqueued ahead of the
  device (a CUDA event per step; the loop waits on the one recorded that
  many steps ago);
- checkpoints hold the whole state and resume, also inside an epoch;
- SIGTERM and SIGINT end the loop through a forced final checkpoint;
- with an evaluator (``eval/evaluator.py``), the configured metrics are
  scored at step 0 and every ``evaluation_interval`` steps.
"""

from __future__ import annotations

import signal
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from dcvgan_torch import prng
from dcvgan_torch.config import ExperimentConfig, flatten_config, save_config
from dcvgan_torch.data import host_ops
from dcvgan_torch.data.loader import VideoLoader
from dcvgan_torch.eval.sampler import generate_samples
from dcvgan_torch.logging.logger import Logger, MetricType
from dcvgan_torch.train.checkpoint import CheckpointManager
from dcvgan_torch.train.state import GANState, GeneratorState
from dcvgan_torch.train.step import DCVGAN, NUM_SEGM_PARTS
from dcvgan_torch.utils.video_np import (
    ensure_float_video,
    geometric_info_in_color_format,
    make_video_grid,
    videos_to_uint8,
)

LOSS_NAMES = ("loss_gen", "loss_idis", "loss_vdis", "loss_gdis")


class Trainer:
    NUM_LOG, ROWS_LOG, COLS_LOG = 25, 5, 5  # 5x5 TensorBoard sample grids

    def __init__(
        self,
        config: ExperimentConfig,
        dataset,
        logger: Optional[Logger] = None,
        evaluator=None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.config = config
        self.dataset = dataset
        self.evaluator = evaluator
        self._eval_fingerprint_logged = False
        self.geometric_info = config.geometric_info.name

        run_dir = Path(config.log_dir) / config.experiment_name
        tb_dir = Path(config.tensorboard_dir) / config.experiment_name
        self.run_dir = run_dir
        self.logger = logger or Logger(run_dir, tb_dir)

        # the run directory's copy of the config
        run_dir.mkdir(parents=True, exist_ok=True)
        save_config(config, run_dir / "config.yml")

        self.gan = DCVGAN(config, device=device)
        self.device = self.gan.device
        self.loader = VideoLoader(
            dataset,
            batchsize=config.batchsize,
            n_workers=config.dataset.n_workers,
            seed=config.seed,
        )
        self.ckpt = CheckpointManager(run_dir / "models")
        self.base_key = prng.base_key(config.seed, self.device)

        # init or resume
        state = self.gan.init_state(config.seed)
        if config.trainer.resume and self.ckpt.latest_step() is not None:
            state = self.ckpt.restore(state)
            self.logger.info(f"resumed from checkpoint at step {state.step}")
        self.state: GANState = state
        self.epoch = self.state.step // max(1, len(self.loader))
        # a mid-epoch checkpoint resumes INSIDE its epoch: the first iterator
        # after resume skips the batches already trained on (the shuffle and
        # crop draws per (seed, epoch, batch) make the remaining batches those
        # of the uninterrupted run)
        self._resume_skip = self.state.step % max(1, len(self.loader))

    # ------------------------------------------------------------------ logs
    def log_hparams(self) -> None:
        self.logger.tf_log_hparams(flatten_config(self.config))

    def _log_geo_histograms(self, x: np.ndarray, tag: str, step: int) -> None:
        """Channel-0 histogram under ``tag``, and a tag per further channel
        when the rendered geometry has several."""
        self.logger.tf_log_histogram(x[..., 0], tag, step)
        for c in range(1, x.shape[-1]):
            self.logger.tf_log_histogram(x[..., c], f"{tag}/ch{c}", step)

    @property
    def eval_state(self) -> Union[GANState, GeneratorState]:
        """The state sampling should read: the EMA generators when
        ``trainer.ema_decay > 0`` and ``trainer.ema_eval``, else the live
        state."""
        if self.config.trainer.ema_eval:
            return self.state.with_ema_params()
        return self.state

    def log_samples(self, iteration: int) -> None:
        """5x5 grids of geometry | colour sample videos and of a real batch,
        with histograms, to TensorBoard."""
        key = prng.named(prng.for_step(self.base_key, iteration), "sample")
        xg, xc = generate_samples(self.gan, self.eval_state, key, self.NUM_LOG, self.NUM_LOG)
        self._log_geo_histograms(xg, "geospace_fake", iteration)
        self.logger.tf_log_histogram(xc[..., 0], "colorspace_fake", iteration)
        grid_g = make_video_grid(xg, self.ROWS_LOG, self.COLS_LOG)
        grid_c = make_video_grid(xc, self.ROWS_LOG, self.COLS_LOG)
        fake = np.concatenate([grid_g, grid_c], axis=3)  # side by side on W
        self.logger.tf_log_video(fake, "fake_samples", iteration)

        # a real batch for comparison, from an epoch id outside the training
        # sequence so that its shuffle is independent
        real = self.loader.fetch_batch(epoch=2**31 + iteration, limit=self.NUM_LOG)
        n = min(self.NUM_LOG, real["color"].shape[0])
        rows = cols = int(np.sqrt(n))
        if rows * cols >= 1:
            xc_real = videos_to_uint8(real["color"][: rows * cols])
            xg_raw = real[self.geometric_info][: rows * cols]
            if self.geometric_info == "segmentation" and xg_raw.dtype == np.uint8:
                # raw class labels -> one-hot for the palette renderer
                xg_raw = host_ops.one_hot(xg_raw[..., 0], NUM_SEGM_PARTS)
            xg_real = geometric_info_in_color_format(
                ensure_float_video(xg_raw), self.geometric_info
            )
            self._log_geo_histograms(xg_real, "geospace_real", iteration)
            self.logger.tf_log_histogram(xc_real[..., 0], "colorspace_real", iteration)
            grid = np.concatenate(
                [make_video_grid(xg_real, rows, cols), make_video_grid(xc_real, rows, cols)],
                axis=3,
            )
            self.logger.tf_log_video(grid, "real_samples", iteration)

    def evaluate(self, iteration: int) -> None:
        """The configured metrics of the eval state's samples, logged; does
        nothing without an evaluator or metrics. The extractor's fingerprint
        is logged once: scores compare only under one fingerprint."""
        if self.evaluator is None or not self.config.evaluation.metrics:
            return
        if not self._eval_fingerprint_logged:
            self.logger.debug(f"eval extractor: {self.evaluator.extractor.fingerprint}")
            self._eval_fingerprint_logged = True
        key = prng.named(prng.for_step(self.base_key, iteration), "eval")
        scores = self.evaluator.evaluate(self.gan, self.eval_state, key)
        for name, score in scores.items():
            if name not in self.logger.metrics:
                # a score may emit derived metrics (prd_f1_8 beside prd)
                self.logger.define(name, MetricType.Float)
            self.logger.update(name, float(score))

    # -------------------------------------------------------------- transfer
    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A loader batch on the device: through pinned host memory with a
        non-blocking copy on CUDA, as it is on the CPU."""
        if self.device.type != "cuda":
            return {k: torch.from_numpy(v) for k, v in batch.items()}
        out = {}
        for k, v in batch.items():
            src = torch.from_numpy(v)
            pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            pinned.copy_(src)
            out[k] = pinned.to(self.device, non_blocking=True)
        return out

    # ------------------------------------------------------------------ loop
    def train(self) -> GANState:
        # SIGTERM (preemption) and SIGINT set a flag checked once per step, so
        # that train() leaves through the forced final checkpoint; resume then
        # continues from the trapped step.
        self._stop = threading.Event()
        prev_handlers = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, lambda *_: self._stop.set())
        try:
            return self._train_loop()
        finally:
            # restored only AFTER the final forced checkpoint: a repeated
            # SIGTERM during the save must not kill the write
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)

    def _flush(self, pending: List[Dict[str, torch.Tensor]]) -> None:
        """One transfer for the whole window's losses."""
        if not pending:
            return
        host = torch.stack([torch.stack([m[k] for k in LOSS_NAMES]) for m in pending]).cpu()
        for row in host.tolist():
            for k, v in zip(LOSS_NAMES, row):
                self.logger.update(k, v)

    def _train_loop(self) -> GANState:
        cfg, logger = self.config, self.logger
        for name in LOSS_NAMES:
            logger.define(name, MetricType.Loss)
        logger.define("iters_per_sec", MetricType.Float, priority=-2)
        for m in cfg.evaluation.metrics:
            logger.define(m, MetricType.Float)

        self.log_hparams()
        logger.debug("(trainer)")
        logger.debug(f"epochs: {cfg.n_epochs}", 1)
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        logger.debug(f"device: {self.device} ({name})", 1)
        logger.debug("(start training)")

        if self.state.step == 0:
            self.log_samples(0)
            self.evaluate(0)
        logger.print_header()

        pending: List[Dict[str, torch.Tensor]] = []
        inflight: deque = deque()
        t_last_flush = time.time()
        iters_since_flush = 0
        iteration = self.state.step
        k = cfg.trainer.max_inflight_steps if self.device.type == "cuda" else 0

        for _ in range(self.epoch, cfg.n_epochs):
            if self._stop.is_set():
                break
            self.epoch += 1
            skip, self._resume_skip = self._resume_skip, 0
            for batch in self.loader.epoch_iterator(epoch=self.epoch - 1, start_batch=skip):
                if self._stop.is_set():
                    break
                self.state, metrics = self.gan.train_step(
                    self.state, self.to_device(batch), self.base_key
                )
                pending.append(metrics)
                iters_since_flush += 1
                iteration += 1

                # backpressure: wait for the step enqueued k steps ago, so
                # that the buffers of the batches in flight stay bounded
                if k:
                    done = torch.cuda.Event()
                    done.record()
                    inflight.append(done)
                    if len(inflight) > k:
                        inflight.popleft().synchronize()

                if iteration % cfg.snapshot_interval == 0:
                    self.ckpt.save(self.state)
                if iteration % cfg.log_samples_interval == 0:
                    self.log_samples(iteration)
                if iteration % cfg.evaluation_interval == 0:
                    self.evaluate(iteration)
                if iteration % cfg.log_interval == 0:
                    self._flush(pending)
                    pending = []
                    now = time.time()
                    logger.update(
                        "iters_per_sec", iters_since_flush / max(1e-9, now - t_last_flush)
                    )
                    t_last_flush, iters_since_flush = now, 0
                    logger.update("iteration", iteration)
                    logger.update("epoch", self.epoch)
                    logger.log()
                    logger.clear()

        if self._stop.is_set():
            logger.info(
                f"interrupted (preemption/SIGTERM) at iteration {iteration}; "
                "saving checkpoint for resume"
            )
        # final snapshot and samples
        self.ckpt.save(self.state, force=True)
        self.ckpt.wait()
        if not self._stop.is_set():
            self.log_samples(self.state.step)
        return self.state
