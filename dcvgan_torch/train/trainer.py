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
  scored at step 0 and every ``evaluation_interval`` steps;
- ``trainer.profile`` traces the training loop with ``torch.profiler`` (CPU,
  and CUDA on a card) into a Chrome trace under ``<run_dir>/profile``, one
  file a rank, stopped in a ``finally`` as the JAX trainer stops its
  ``jax.profiler`` trace;
- ``trainer.debug_nans`` raises ``FloatingPointError`` at the first step
  whose losses or gradients are not finite, naming the step, the losses
  and the models, where the JAX trainer's ``jax_debug_nans`` raises; the
  check costs one device sync a step and runs only when the key is on.

Under a process group (``parallel/mesh.py``; ``torchrun`` and
``cli.train``) every rank runs this loop on its own device: the trainer
builds the layout from ``config.mesh``, gives the loader this rank's data
row's slice of each global batch (the ``time`` ranks of a row get the same
one), broadcasts rank 0's initial state and lets the train step reduce. Only rank 0 logs, writes TensorBoard, samples and writes
checkpoints; the others wait at a barrier until each checkpoint is on
disk. On resume rank 0 restores its latest checkpoint and the
broadcast of its state carries it to the others. The
evaluation runs over the ranks when its batch splits over them, else on
rank 0 alone. A stop signal on any rank ends every rank's loop at the same
step (a MAX all-reduce of the flag on the host each step).
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

from dcvgan_torch import native, prng
from dcvgan_torch.config import ExperimentConfig, flatten_config, save_config
from dcvgan_torch.data.loader import VideoLoader
from dcvgan_torch.eval.sampler import generate_samples
from dcvgan_torch.logging.logger import Logger, MetricType
from dcvgan_torch.parallel.mesh import (
    barrier,
    batch_size_divisor,
    broadcast_from_first,
    create_layout,
    replicate,
    stop_anywhere,
)
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


class _Silent:
    """The logger of a rank other than 0: every call does nothing."""

    def __init__(self):
        self.metrics: Dict[str, object] = {}

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def _zero_adam_states(state: GANState) -> None:
    """Zero Adam moments and step for every parameter, laid out as a
    restored checkpoint's (``CheckpointManager.restore`` maps every tensor,
    the step too, to the parameters' device): what ``replicate`` fills with
    rank 0's restored state on the other ranks."""
    for name, module in state.models.items():
        for p in module.parameters():
            state.opt[name].state[p] = {
                "step": torch.zeros((), device=p.device),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p),
            }


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
        self.layout = create_layout(config)
        self.main = self.layout.rank == 0
        if self.main:
            self.logger = logger or Logger(run_dir, tb_dir)
            # the run directory's copy of the config
            run_dir.mkdir(parents=True, exist_ok=True)
            save_config(config, run_dir / "config.yml")
            self.ckpt = CheckpointManager(run_dir / "models")
        else:
            self.logger, self.ckpt = _Silent(), None

        self.gan = DCVGAN(config, device=device, layout=self.layout)
        self.device = self.gan.device
        divisor = batch_size_divisor(self.layout)
        self.loader = VideoLoader(
            dataset,
            batchsize=config.batchsize,
            n_workers=config.dataset.n_workers,
            seed=config.seed,
            process_index=self.layout.row,
            process_count=divisor,
            shard_divisor=divisor,
        )
        if evaluator is not None and divisor > 1:
            # the evaluation's rounds split over the ranks where they can
            try:
                evaluator.set_layout(self.layout)
            except ValueError as e:
                self.logger.info(f"eval stays on rank 0: {e}")
        self.base_key = prng.base_key(config.seed, self.device)

        # init or resume: rank 0 restores, and replicate() carries its state
        # to the other ranks
        state = self.gan.init_state(config.seed)
        step = self.ckpt.latest_step() if self.main and config.trainer.resume else None
        step = broadcast_from_first(step, self.layout)
        if step is not None and self.main:
            state = self.ckpt.restore(state, step)
            self.logger.info(f"resumed from checkpoint at step {state.step}")
        elif step is not None:
            state.step = step
            _zero_adam_states(state)
        replicate(state, self.layout)
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
        with histograms, to TensorBoard; rank 0 only."""
        if not self.main:
            return
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
                xg_raw = native.one_hot(xg_raw[..., 0], NUM_SEGM_PARTS)
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
        is logged once: scores compare only under one fingerprint. Every
        rank takes part when the evaluator spans the ranks, else rank 0
        alone."""
        if self.evaluator is None or not self.config.evaluation.metrics:
            return
        if not self.main and self.evaluator.layout.world == 1:
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

    def save(self, force: bool = False) -> None:
        """Rank 0 writes the checkpoint; every rank leaves once it is on disk."""
        if self.main:
            self.ckpt.save(self.state, force=force)
            self.ckpt.wait()
        barrier(self.layout)

    def _flush(self, pending: List[Dict[str, torch.Tensor]]) -> None:
        """One transfer for the whole window's losses (rank 0; the losses
        are the ranks' mean)."""
        if not pending or not self.main:
            return
        host = torch.stack([torch.stack([m[k] for k in LOSS_NAMES]) for m in pending]).cpu()
        for row in host.tolist():
            for k, v in zip(LOSS_NAMES, row):
                self.logger.update(k, v)

    def _start_profile(self) -> torch.profiler.profile:
        """``trainer.profile``: start tracing the host and, on a card, the
        device."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof: torch.profiler.profile) -> None:
        """Stop the trace and write it as a Chrome trace, one file a rank."""
        prof.stop()
        out = self.run_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"rank{self.layout.rank}-{time.strftime('%Y%m%d-%H%M%S')}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        self.logger.info(f"profile: {path}")

    def _raise_if_not_finite(self, iteration: int, metrics: Dict[str, torch.Tensor]) -> None:
        """``trainer.debug_nans``: raise ``FloatingPointError`` if a loss of
        step ``iteration`` or a gradient the step left on a model's
        parameters is NaN or infinite. One transfer of the flags decides."""
        names = list(LOSS_NAMES) + [f"{name} gradients" for name in self.state.models]
        flags = [torch.isfinite(metrics[k]).all() for k in LOSS_NAMES]
        for module in self.state.models.values():
            grads = [p.grad for p in module.parameters() if p.grad is not None]
            flags.append(torch.stack([torch.isfinite(g).all() for g in grads]).all() if grads
                         else torch.ones((), dtype=torch.bool, device=self.device))
        bad = [name for name, ok in zip(names, torch.stack(flags).tolist()) if not ok]
        if bad:
            raise FloatingPointError(
                f"trainer.debug_nans: step {iteration} has NaN or infinite values in {', '.join(bad)}"
            )

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
        lay = self.layout
        axes = f"dcn {lay.dcn} x data {lay.data}" + (f" x time {lay.time}" if lay.time > 1 else "")
        logger.debug(f"ranks: {lay.world} ({axes}), "
                     f"{'global-batch' if self.gan.global_batch else 'per-rank'} BatchNorm", 1)
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

        stopped = False
        prof = self._start_profile() if cfg.trainer.profile else None
        try:
            for _ in range(self.epoch, cfg.n_epochs):
                if stopped:
                    break
                self.epoch += 1
                skip, self._resume_skip = self._resume_skip, 0
                for batch in self.loader.epoch_iterator(epoch=self.epoch - 1, start_batch=skip):
                    stopped = stop_anywhere(self._stop.is_set(), self.layout)
                    if stopped:
                        break
                    self.state, metrics = self.gan.train_step(
                        self.state, self.to_device(batch), self.base_key
                    )
                    pending.append(metrics)
                    iters_since_flush += 1
                    iteration += 1
                    if cfg.trainer.debug_nans:
                        self._raise_if_not_finite(iteration, metrics)

                    # backpressure: wait for the step enqueued k steps ago, so
                    # that the buffers of the batches in flight stay bounded
                    if k:
                        done = torch.cuda.Event()
                        done.record()
                        inflight.append(done)
                        if len(inflight) > k:
                            inflight.popleft().synchronize()

                    if iteration % cfg.snapshot_interval == 0:
                        self.save()
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
        finally:
            if prof is not None:
                self._stop_profile(prof)

        stopped = stopped or stop_anywhere(self._stop.is_set(), self.layout)
        if stopped:
            logger.info(
                f"interrupted (preemption/SIGTERM) at iteration {iteration}; "
                "saving checkpoint for resume"
            )
        # final snapshot and samples
        self.save(force=True)
        if not stopped:
            self.log_samples(self.state.step)
        return self.state
