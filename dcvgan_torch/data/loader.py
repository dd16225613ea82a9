"""Threaded, prefetching host data loader.

Counterpart of ``dcvgan_tpu/data/loader.py``, kept as the port's own copy:
the same seed gives the same batches. A thread-pool loader:

- per-epoch shuffling from an explicit seed (deterministic resume),
- sharding over processes: each decodes only its slice of the global batch
  (keyed by ``process_index``/``process_count``),
- a background prefetch queue, so that JPEG/PNG decode overlaps the device's
  compute,
- yields numpy dict batches ``{"color": (B, T, H, W, 3), <geo>: ...}``; the
  trainer copies them to the device through pinned memory.
"""

from __future__ import annotations

import queue
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from dcvgan_torch.data.dataset import VideoDataset


class VideoLoader:
    """Iterable over epoch batches of a :class:`VideoDataset`.

    One pass over the loader is one epoch (reshuffled each epoch);
    ``drop_last`` drops a trailing partial batch.
    """

    def __init__(
        self,
        dataset: VideoDataset,
        batchsize: int,
        n_workers: int = 4,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
        shard_divisor: int = 1,
    ):
        if batchsize % process_count != 0:
            raise ValueError(
                f"global batchsize {batchsize} not divisible by "
                f"process_count {process_count}"
            )
        self.dataset = dataset
        self.batchsize = batchsize
        self.local_batchsize = batchsize // process_count
        self.n_workers = max(1, n_workers)
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        # Any yielded global batch size must be divisible by this (the
        # number of data-parallel devices): a trailing partial batch that
        # cannot be split over them is dropped.
        self.shard_divisor = max(1, shard_divisor)
        self.epoch = 0
        # one long-lived decode pool (per-batch construction would churn
        # n_workers threads on the hot path)
        self._pool = ThreadPoolExecutor(max_workers=self.n_workers)
        # release the worker threads even when consumers forget close()
        self._finalizer = weakref.finalize(
            self, ThreadPoolExecutor.shutdown, self._pool, wait=False
        )

    def close(self) -> None:
        """Shut down the decode pool (idempotent). Throwaway consumers
        (tests, one-shot scripts) should call this — or use the loader as a
        context manager — instead of leaking idle worker threads until
        interpreter exit."""
        self._finalizer()

    def __enter__(self) -> "VideoLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __len__(self) -> int:
        n = len(self.dataset)
        full = n // self.batchsize
        rem = n % self.batchsize
        # a trailing partial batch is usable only when every process gets
        # an equal non-empty slice and shard_divisor divides it
        if (
            not self.drop_last
            and rem
            and rem % self.process_count == 0
            and rem % self.shard_divisor == 0
        ):
            full += 1
        return full

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            rng.shuffle(idx)
        return idx

    def _load_batch(
        self,
        indices: np.ndarray,
        epoch: int,
        b: int,
        pos_offset: int = 0,
    ) -> Dict[str, np.ndarray]:
        # Per-sample RNG derived from (seed, epoch, batch, GLOBAL position):
        # the temporal crop is deterministic given the loader config.
        # ``pos_offset`` maps this process's slice back to global batch
        # positions, so that a sharded run decodes the same samples as the
        # unsharded run of the same global batch.
        def load_one(pos_and_i):
            pos, i = pos_and_i
            rng = np.random.default_rng(
                (self.seed, epoch, b, pos_offset + int(pos))
            )
            return self.dataset.sample(int(i), rng)

        samples = list(self._pool.map(load_one, enumerate(indices)))
        return {
            k: np.stack([s[k] for s in samples]) for k in samples[0].keys()
        }

    def _local_slice(self, global_idx: np.ndarray) -> np.ndarray:
        """This process's equal share of a (possibly partial) global batch."""
        lb = len(global_idx) // self.process_count
        return global_idx[self.process_index * lb : (self.process_index + 1) * lb]

    def _local_offset(self, global_idx: np.ndarray) -> int:
        """Global batch position of this process's first local sample."""
        return self.process_index * (len(global_idx) // self.process_count)

    def fetch_batch(
        self, epoch: int, limit: Optional[int] = None
    ) -> Dict[str, np.ndarray]:
        """Load this process's first batch of ``epoch`` synchronously — no
        prefetch queue or producer thread. For one-shot consumers (sample
        logging, eval reals) that only need a single batch. ``limit`` caps
        the decoded sample count (a consumer wanting 25 videos shouldn't
        pay for a 256-video decode)."""
        order = self._epoch_indices(epoch)
        global_idx = order[: self.batchsize]
        local_idx = self._local_slice(global_idx)
        if limit is not None:
            local_idx = local_idx[:limit]
        return self._load_batch(
            local_idx, epoch, 0, pos_offset=self._local_offset(global_idx)
        )

    def epoch_iterator(
        self, epoch: Optional[int] = None, start_batch: int = 0
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield this process's batches for one epoch, with prefetching.

        ``start_batch`` skips the epoch's first batches without decoding
        them (mid-epoch checkpoint resume); batch numbering — and with it
        the per-(seed, epoch, batch) crop RNG — is unchanged.
        """
        if epoch is None:
            epoch = self.epoch
            self.epoch += 1
        order = self._epoch_indices(epoch)
        n_batches = len(self)

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        _SENTINEL = object()

        def put(item) -> bool:
            # bounded put that honors `stop` so an abandoned iterator never
            # leaves the producer blocked on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(start_batch, n_batches):
                    if stop.is_set():
                        return
                    global_idx = order[b * self.batchsize : (b + 1) * self.batchsize]
                    local_idx = self._local_slice(global_idx)
                    loaded = self._load_batch(
                        local_idx, epoch, b,
                        pos_offset=self._local_offset(global_idx),
                    )
                    if not put(loaded):
                        return
            except BaseException as e:  # surface worker errors to the consumer
                put(e)
            finally:
                put(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.epoch_iterator()
