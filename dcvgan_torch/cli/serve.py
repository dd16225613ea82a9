"""Serving CLI: sustained batched video generation on the GPU.

Counterpart of the chunk loop of ``dcvgan_tpu/cli/serve.py``: each chunk
runs ``iters`` sampling rounds (ggen + cgen) and quantizes to uint8 on the
device; at most ``queue_depth`` chunks are in flight, and the host drains
chunk k while the device generates chunk k+1. A chunk's outputs are copied
to pinned host memory on a side CUDA stream that waits on an event recorded
after the chunk, so the compute stream never blocks on a copy.

Usage::

    python -m dcvgan_torch.cli.serve --config configs/mug-depth.yml \\
        [--weights state.npz] [-b 256] [--iters-per-chunk 4] [--chunks 8] \\
        [--sink null|npy] [--out DIR] [--with-geo] [--seed 0] [--device cuda]

``--weights`` is an npz written from a JAX state (``compat/from_jax.py``);
without it the generators take a fresh init seeded from the config's seed.

Sinks: ``null`` drains only a per-chunk checksum (the sum of every quantized
pixel, mod 2**32, so the device provably produced every video); ``npy``
writes one ``color_NNNNN.npy`` shard per chunk (+ ``geo_NNNNN.npy`` with
``--with-geo``). Prints one JSON line with the generated videos/s.

An explicit seed replays the same bytes, within the port and on one device
type; bytes differ from the JAX package's, whose random streams differ.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from dcvgan_torch import prng
from dcvgan_torch.config import load_config
from dcvgan_torch.train.step import DCVGAN
from dcvgan_torch.train.state import GeneratorState


def quantize(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 as the JAX server computes it: clip, +1, *127.5 in
    ``x.dtype`` (bf16 arithmetic rounds in bf16), then a truncating cast."""
    return ((x.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)


def make_chunk_fn(gan: DCVGAN, batchsize: int, iters: int):
    """One serving chunk: ``iters`` sampling rounds on the device.

    ``chunk_fn(state, gen)`` returns ``(checksum, xg_u8, xc_u8)``: the videos
    are ``(iters, B, T, H, W, C)`` uint8 and the checksum is an int64 sum of
    every quantized pixel (take it mod 2**32). Round i draws from
    ``prng.for_step(gen, i)``.
    """

    def chunk_fn(state: GeneratorState, gen: torch.Generator):
        with torch.inference_mode():
            total = torch.zeros((), dtype=torch.int64, device=gan.device)
            xgs, xcs = [], []
            for i in range(iters):
                xg, xc = gan.sample_videos(state, prng.for_step(gen, i), batchsize)
                xg_u8, xc_u8 = quantize(xg), quantize(xc)
                total += xc_u8.sum(dtype=torch.int64) + xg_u8.sum(dtype=torch.int64)
                xgs.append(xg_u8)
                xcs.append(xc_u8)
            return total, torch.stack(xgs), torch.stack(xcs)

    return chunk_fn


class InFlight:
    """A dispatched chunk whose checksum (and videos, where wanted) are on
    their way to the host.

    On CUDA the copies run on ``copy_stream`` after an event recorded on the
    compute stream, into pinned memory; :meth:`result` waits for that copy
    alone. The device buffers stay referenced until then, so the allocator
    cannot hand them out while the copy reads them.
    """

    def __init__(self, chunk, copy_stream, color: bool, geo: bool):
        csum, xg, xc = chunk
        self._want = (color, geo)
        dev = [csum] + ([xc] if color else []) + ([xg] if geo else [])
        self._dev = dev
        if copy_stream is None:
            self._host, self._done = [t.clone() for t in dev], None
            return
        ready = torch.cuda.Event()
        ready.record()
        with torch.cuda.stream(copy_stream):
            copy_stream.wait_event(ready)
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in dev]
            for h, d in zip(self._host, dev):
                h.copy_(d, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record(copy_stream)

    def result(self) -> Tuple[int, Optional[np.ndarray], Optional[np.ndarray]]:
        """``(checksum mod 2**32, xg | None, xc | None)`` on the host."""
        if self._done is not None:
            self._done.synchronize()
        self._dev = None
        host = iter(self._host)
        csum = int(next(host)) % 2**32
        color, geo = self._want
        xc = next(host).numpy() if color else None
        xg = next(host).numpy() if geo else None
        return csum, xg, xc


def _copy_stream(gan: DCVGAN) -> Optional[torch.cuda.Stream]:
    return torch.cuda.Stream(gan.device) if gan.device.type == "cuda" else None


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


class Sink:
    """Writes drained chunks; returns the bytes delivered to the host."""

    def __init__(self, kind: str, out: Optional[Path], with_geo: bool = False):
        if kind not in ("null", "npy"):
            raise ValueError(f"unknown sink {kind!r}")
        if kind == "npy" and out is None:
            raise ValueError("the npy sink needs an output directory")
        self.kind = kind
        self.out = out
        self.with_geo = with_geo and kind != "null"
        self.wants_color = kind != "null"
        self.pool = ThreadPoolExecutor(max_workers=4)
        self.futures = []
        if out is not None and kind != "null":
            out.mkdir(parents=True, exist_ok=True)

    def write(self, chunk_idx: int, xg: Optional[np.ndarray], xc: Optional[np.ndarray]) -> int:
        if self.kind == "null":
            return 0
        self.futures.append(self.pool.submit(self._write, chunk_idx, xg, xc))
        return xc.nbytes + (xg.nbytes if xg is not None else 0)

    def _write(self, chunk_idx: int, xg, xc) -> None:
        np.save(self.out / f"color_{chunk_idx:05d}.npy", xc)
        if xg is not None:
            np.save(self.out / f"geo_{chunk_idx:05d}.npy", xg)

    def close(self) -> None:
        for f in self.futures:
            f.result()
        self.pool.shutdown()


def serve(
    gan: DCVGAN,
    state: GeneratorState,
    batchsize: int,
    iters_per_chunk: int,
    chunks: int,
    sink: Sink,
    seed: int = 0,
    queue_depth: int = 2,
) -> dict:
    """Run the double-buffered serving loop; return the stats record."""
    queue_depth = max(1, queue_depth)
    chunk_fn = make_chunk_fn(gan, batchsize, iters_per_chunk)
    copy_stream = _copy_stream(gan)
    key = prng.base_key(seed, gan.device)

    def dispatch(gen):
        return InFlight(chunk_fn(state, gen), copy_stream, sink.wants_color, sink.with_geo)

    # warm-up (kernel build, cuDNN algorithm choice) is outside the measurement
    dispatch(prng.for_step(key, 10**6)).result()

    pending: deque = deque()
    delivered_bytes = 0
    checksum = 0

    def drain() -> None:
        nonlocal delivered_bytes, checksum
        idx, flight = pending.popleft()
        csum, xg, xc = flight.result()
        checksum = (checksum + csum) % 2**32
        delivered_bytes += sink.write(idx, xg, xc)

    t0 = time.perf_counter()
    for k in range(chunks):
        pending.append((k, dispatch(prng.for_step(key, k))))
        # keep `queue_depth` chunks in flight; drain the oldest beyond that
        while len(pending) > queue_depth - 1:
            drain()
    while pending:
        drain()
    gen_dt = time.perf_counter() - t0
    sink.close()
    total_dt = time.perf_counter() - t0

    n_videos = batchsize * iters_per_chunk * chunks
    return {
        "metric": "serve_videos_per_sec_per_chip",
        "value": round(n_videos / gen_dt, 2),
        "unit": "videos/s",
        "sink": sink.kind,
        "videos": n_videos,
        "batchsize": batchsize,
        "iters_per_chunk": iters_per_chunk,
        "chunks": chunks,
        "generate_plus_drain_s": round(gen_dt, 3),
        "total_s_incl_writes": round(total_dt, 3),
        "delivered_videos_per_sec": (
            round(n_videos / total_dt, 2) if sink.kind != "null" else None
        ),
        "delivered_MB_per_sec": (
            round(delivered_bytes / 1e6 / total_dt, 2) if delivered_bytes else None
        ),
        "checksum": checksum,
        "n_chips": 1,
        "device": device_name(gan.device),
    }


class GenerationServer:
    """Request-oriented wrapper over the chunk generator.

    Requests needing more than one chunk pipeline them (dispatch chunk k+1
    before fetching chunk k); dispatch is serialised under a lock, since one
    device has one compute stream here, while the host side of a fetch runs
    outside it.
    """

    def __init__(
        self,
        gan: DCVGAN,
        state: GeneratorState,
        batchsize: int = 64,
        iters_per_chunk: int = 1,
        geo_name: str = "depth",
        queue_depth: int = 2,
    ):
        self.gan = gan
        self.state = state
        self.batchsize = batchsize
        self.iters = iters_per_chunk
        self.geo_name = geo_name
        self.queue_depth = max(1, queue_depth)
        self.chunk_fn = make_chunk_fn(gan, batchsize, iters_per_chunk)
        self._copy_stream = _copy_stream(gan)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        _, _, xc = self._dispatch(prng.base_key(0, gan.device), False).result()
        self.video_shape = tuple(xc.shape[2:])  # (T, H, W, C)

    def _dispatch(self, gen: torch.Generator, with_geo: bool) -> InFlight:
        with self._lock:
            return InFlight(self.chunk_fn(self.state, gen), self._copy_stream, True, with_geo)

    def generate_chunks(
        self, n: int, seed: int, with_geo: bool = False
    ) -> Iterator[Tuple[Optional[np.ndarray], np.ndarray]]:
        """Yield ``(geo | None, color)`` uint8 chunk arrays totalling exactly
        n videos, with at most ``queue_depth`` chunks in flight."""
        per_chunk = self.batchsize * self.iters
        key = prng.base_key(seed, self.gan.device)
        pending: deque = deque()
        produced = 0

        def fetch_one():
            nonlocal produced
            _, xg, xc = pending.popleft().result()
            color = xc.reshape((-1,) + xc.shape[2:])
            take = min(len(color), n - produced)
            produced += take
            geo = xg.reshape((-1,) + xg.shape[2:])[:take] if with_geo else None
            return geo, color[:take]

        for k in range((n + per_chunk - 1) // per_chunk):
            pending.append(self._dispatch(prng.for_step(key, k), with_geo))
            while len(pending) >= self.queue_depth:
                yield fetch_one()
        while pending:
            yield fetch_one()

    def generate(
        self, n: int, seed: int, with_geo: bool = False
    ) -> Tuple[Optional[np.ndarray], np.ndarray]:
        """``(geo | None, color)`` uint8 arrays of exactly n videos."""
        geos, colors = [], []
        for geo, color in self.generate_chunks(n, seed, with_geo):
            colors.append(color)
            geos.append(geo)
        return (np.concatenate(geos) if with_geo else None), np.concatenate(colors)

    def info(self) -> dict:
        return {
            "status": "ok",
            "device": device_name(self.gan.device),
            "n_chips": 1,
            "batchsize": self.batchsize,
            "iters_per_chunk": self.iters,
            "geometric_info": self.geo_name,
            "uptime_s": round(time.perf_counter() - self._t0, 1),
        }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--weights", type=Path, default=None)
    parser.add_argument("--batchsize", "-b", type=int, default=256)
    parser.add_argument("--iters-per-chunk", type=int, default=4)
    parser.add_argument("--chunks", type=int, default=8)
    parser.add_argument("--sink", choices=["null", "npy"], default="null")
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--with-geo", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--queue-depth", type=int, default=2)
    parser.add_argument(
        "--no-ema",
        action="store_true",
        help="serve the live generator params even when the weights carry an EMA",
    )
    parser.add_argument(
        "--device", default=None, help="torch device (default cuda; 'cpu' runs on the CPU)"
    )
    args = parser.parse_args(argv)
    if args.sink != "null" and args.out is None:
        parser.error(f"--sink {args.sink} requires --out DIR")

    cfg = load_config(args.config)
    gan = DCVGAN(cfg, device=args.device)
    if args.weights:
        state = gan.load_state(args.weights)
    else:
        # the serving copy of a fresh state: parameters cast once to the compute dtype
        state = gan.init_state(cfg.seed).generators()
    if not args.no_ema:
        state = state.with_ema_params()
    sink = Sink(args.sink, args.out, args.with_geo)
    stats = serve(
        gan,
        state,
        args.batchsize,
        args.iters_per_chunk,
        args.chunks,
        sink,
        seed=args.seed,
        queue_depth=args.queue_depth,
    )
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
