"""Serving CLI: sustained batched video generation on the GPU, and its HTTP
front end.

Counterpart of ``dcvgan_tpu/cli/serve.py``. Each chunk runs ``iters``
sampling rounds (ggen + cgen) and quantizes to uint8 on the device (a
segmentation geometry's codes come from ggen's fused softmax head, see
``make_chunk_fn``); at most
``queue_depth`` chunks are in flight, and the host drains chunk k while the
device generates chunk k+1. A chunk's outputs are copied to pinned host
memory on a side CUDA stream that waits on an event recorded after the
chunk, so the compute stream never blocks on a copy.

Usage::

    python -m dcvgan_torch.cli.serve <result_dir> <iteration> \\
        [-b 256] [--iters-per-chunk 4] [--chunks 8] [--sink null|npy|mp4] \\
        [--out DIR] [--with-geo] [--seed 0] [--no-ema] [--device cuda]
    python -m dcvgan_torch.cli.serve <result_dir> <iteration> --listen PORT \\
        [--max-request-videos 4096] [--max-concurrent 4] [--batch-window-ms 5]
    python -m dcvgan_torch.cli.serve --config configs/mug-depth.yml \\
        [--weights state.npz] ...

``result_dir`` is a run directory of the port (``config.yml`` and
``models/step_<N>.pt``, as ``cli.train`` and ``cli.import_torch`` write
them); ``iteration`` -1 takes the latest checkpoint. The ``--config`` form
takes the generators from ``--weights``, an npz written from a JAX state
(``compat/from_jax.py``), or without it from a fresh init seeded from the
config's seed. Both serve the EMA generators where there are any, unless
``--no-ema``.

Sinks: ``null`` drains only a per-chunk checksum (the sum of every quantized
pixel, mod 2**32, so the device provably produced every video); ``npy``
writes one ``color_NNNNN.npy`` shard per chunk (+ ``geo_NNNNN.npy`` with
``--with-geo``); ``mp4`` writes one file per video under ``out/color``
(+ the rendered geometry under ``out/<geometric_info>`` with
``--with-geo``), numbered as ``cli.infer`` numbers them. Prints one JSON
line with the generated videos/s.

HTTP mode: ``--listen PORT`` serves requests over the same chunks instead of
running a fixed number of them, and first prints ``{"listening": port, ...}``:

- ``GET /healthz`` -> JSON {status, device, model info}
- ``GET /stats`` -> JSON request and video counters
- ``GET /generate?n=16&seed=0`` -> ``.npy`` bytes, uint8 (n, T, H, W, 3)
- ``GET /generate?n=16&seed=0&geo=1`` -> ``.npz`` with ``color`` and ``geo``
- ``POST /generate`` with a JSON body ``{"n": 16, "seed": 0, "geo": false}``
  -> the same responses (query parameters are ignored on POST).

An explicit ``seed`` pins the request to its own chunk stream, which
replays the same bytes. Without one (or with ``seed=auto``) the request
goes to the micro-batcher: requests that wait within ``--batch-window-ms``
of each other share device chunks of only the rounds they need, dealt to
them first come, first served.

Bounds: at most ``queue_depth`` chunks in flight per request; a colour
request streams one chunk at a time into the socket, a ``geo`` request is
buffered (an npz does not stream) and so may ask for half as many videos;
above ``--max-request-videos`` a request gets 413, and beyond
``--max-concurrent`` requests at once 429 with ``Retry-After``.

An explicit seed replays the same bytes, within the port and on one device
type; bytes differ from the JAX package's, whose random streams differ.

``--mesh N`` (``mesh=`` a list of devices in the API) serves from one
replica of the generators on each of N devices (``cuda:0`` .. ``cuda:N-1``,
or N CPU replicas with ``--device cpu``; -1: every card): each round's
seeded latents are drawn once, their rows split N ways, each replica
samples its rows with no collective, and the videos are assembled in
order. JAX's ``make_chunk_fn(mesh=...)`` says its bytes equal the unsharded
chunk's bit for bit; here a replica's convolutions run at batch B/N, for
which cuDNN may pick other algorithms, so a byte may differ by the rounding
of the last quantisation step (the tests hold that bound).

Spans (``utils/trace.py``, recorded only after ``trace.enable()``): a
chunk's launch ``serve.chunk.enqueue``, and in ``InFlight`` its
``serve.chunk.copy_issue`` and ``serve.chunk.wait``; the micro-batcher's
``serve.batch.idle``, ``.window``, ``.fetch`` and ``.deal`` under the
round's index; ``serve.request.queue`` from a batched request's arrival to
the start of its first round's fetch, and the handler's
``serve.http.write`` (socket writes only), under the request's id.
"""

from __future__ import annotations

import argparse
import copy
import io
import itertools
import json
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from queue import SimpleQueue
from typing import Iterator, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from dcvgan_torch import prng
from dcvgan_torch.cli.infer import load_run
from dcvgan_torch.config import load_config
from dcvgan_torch.io.video import write_videos_parallel
from dcvgan_torch.models.ggen import codes_of
from dcvgan_torch.ops.softmax_codes import quantize
from dcvgan_torch.train.step import DCVGAN
from dcvgan_torch.train.state import GeneratorState
from dcvgan_torch.utils import trace
from dcvgan_torch.utils.device import resolve_device
from dcvgan_torch.utils.video_np import geometric_info_in_color_format


def place_replicas(state: GeneratorState, mesh: Sequence) -> List[GeneratorState]:
    """A copy of the serving generators (and their EMA) on each device of
    ``mesh``, a non-empty list of devices (one may appear more than once)."""
    if not isinstance(mesh, (list, tuple)) or not mesh:
        raise TypeError(f"mesh must be a non-empty list of devices, got {mesh!r}")
    out = []
    for device in mesh:
        dev = resolve_device(device)
        ema = None
        if state.ema is not None:
            ema = {n: {k: v.to(dev) for k, v in avg.items()} for n, avg in state.ema.items()}
        out.append(GeneratorState(copy.deepcopy(state.ggen).to(dev),
                                  copy.deepcopy(state.cgen).to(dev), ema))
    return out


def make_chunk_fn(gan: DCVGAN, batchsize: int, iters: int, mesh: Optional[Sequence] = None):
    """One serving chunk: ``iters`` sampling rounds on the device.

    ``chunk_fn(state, gen, rounds=None)`` returns ``(checksum, xg_u8,
    xc_u8)``: the videos are ``(rounds, B, T, H, W, C)`` uint8 (``rounds``
    defaults to ``iters``) and the checksum is an int64 sum of every
    quantized pixel (take it mod 2**32). Round i draws from
    ``prng.for_step(gen, i)``, so a short chunk's rows are the first rows of
    the whole chunk from the same ``gen``. The geometry codes are made every
    round, whether or not the sink takes them: a segmentation ggen whose
    decoder runs fused hands them and their sum on with its videos
    (``models.ggen.codes_of``: one ``softmax_codes`` launch wrote the
    probabilities and their codes); otherwise, and on the ``mesh`` path,
    whose rows come back as copies, :func:`quantize` makes them here.

    With ``mesh`` (a list of N devices) ``state`` is ``place_replicas``'s
    list: round i's latents are drawn on ``gan``'s device, replica r samples
    rows ``r*B/N .. (r+1)*B/N`` on its device, and the rows come back to
    ``gan``'s device in order.
    """
    if mesh is None:
        def sample(state, key):
            return gan.sample_videos(state, key, batchsize)
    else:
        if batchsize % len(mesh):
            raise ValueError(f"batchsize {batchsize} not divisible by the {len(mesh)} replicas")
        local = batchsize // len(mesh)
        bundles = [DCVGAN(gan.config, device=d) for d in mesh]

        def sample(states, key):
            latents = gan.sample_latents(key, batchsize)
            parts = []
            for r, (bundle, state) in enumerate(zip(bundles, states)):
                rows = type(latents)(*(t[r * local:(r + 1) * local] for t in latents))
                parts.append(bundle.sample_videos(state, None, local, latents=rows))
            return tuple(torch.cat([p[j].to(gan.device) for p in parts]) for j in (0, 1))

    def chunk_fn(state, gen: torch.Generator, rounds: Optional[int] = None):
        rounds = iters if rounds is None else rounds
        if not 1 <= rounds <= iters:
            raise ValueError(f"rounds must be in 1..{iters}, got {rounds}")
        with trace.span("serve.chunk.enqueue"), torch.inference_mode():
            total = torch.zeros((), dtype=torch.int64, device=gan.device)
            xgs, xcs = [], []
            for i in range(rounds):
                xg, xc = sample(state, prng.for_step(gen, i))
                codes = codes_of(xg)
                if codes is None:  # a tanh head, or rows assembled from replicas
                    xg_u8, xc_u8 = quantize(xg), quantize(xc)
                    total += xc_u8.sum(dtype=torch.int64) + xg_u8.sum(dtype=torch.int64)
                else:
                    xg_u8, xc_u8 = codes.u8, quantize(xc)
                    total += xc_u8.sum(dtype=torch.int64) + codes.total
                xgs.append(xg_u8)
                xcs.append(xc_u8)
                del xg, xc, codes  # the next round's sampling does not hold this round's videos
            return total, torch.stack(xgs), torch.stack(xcs)

    return chunk_fn


def chips(mesh: Optional[Sequence]) -> int:
    """The distinct devices a mesh occupies (1 without one)."""
    return 1 if mesh is None else len({str(resolve_device(d)) for d in mesh})


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
        with trace.span("serve.chunk.copy_issue"):
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
        with trace.span("serve.chunk.wait"):
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

    def __init__(self, kind: str, out: Optional[Path], geo_name: str, with_geo: bool):
        if kind not in ("null", "npy", "mp4"):
            raise ValueError(f"unknown sink {kind!r}")
        if kind != "null" and out is None:
            raise ValueError(f"the {kind} sink needs an output directory")
        self.kind = kind
        self.out = out
        self.geo_name = geo_name
        self.with_geo = with_geo and kind != "null"
        self.wants_color = kind != "null"
        self.pool = ThreadPoolExecutor(max_workers=4)
        self.futures = []
        if kind != "null":
            out.mkdir(parents=True, exist_ok=True)
            if kind == "mp4":
                (out / "color").mkdir(exist_ok=True)
                if self.with_geo:
                    (out / geo_name).mkdir(exist_ok=True)

    def write(self, chunk_idx: int, xg: Optional[np.ndarray], xc: Optional[np.ndarray]) -> int:
        if self.kind == "null":
            return 0
        self.futures.append(self.pool.submit(self._write, chunk_idx, xg, xc))
        return xc.nbytes + (xg.nbytes if xg is not None else 0)

    def _write(self, chunk_idx: int, xg, xc) -> None:
        if self.kind == "npy":
            np.save(self.out / f"color_{chunk_idx:05d}.npy", xc)
            if xg is not None:
                np.save(self.out / f"geo_{chunk_idx:05d}.npy", xg)
            return
        # mp4: (iters, B) flattened to videos, numbered as cli.infer numbers them
        videos = xc.reshape((-1,) + xc.shape[2:])
        base = chunk_idx * len(videos)
        write_videos_parallel(
            videos, [self.out / "color" / f"{base + i:06d}.mp4" for i in range(len(videos))]
        )
        if xg is not None:
            geo = xg.reshape((-1,) + xg.shape[2:]).astype(np.float32) / 127.5 - 1.0  # undo quantize
            geo = geometric_info_in_color_format(geo, self.geo_name)
            write_videos_parallel(
                geo, [self.out / self.geo_name / f"{base + i:06d}.mp4" for i in range(len(geo))]
            )

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
    mesh: Optional[Sequence] = None,
) -> dict:
    """Run the double-buffered serving loop; return the stats record. With
    ``mesh``, every chunk is split over one replica per device; the rate is
    per distinct device."""
    queue_depth = max(1, queue_depth)
    if mesh is not None:
        state = place_replicas(state, mesh)
    chunk_fn = make_chunk_fn(gan, batchsize, iters_per_chunk, mesh)
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
    n_chips = chips(mesh)
    return {
        "metric": "serve_videos_per_sec_per_chip",
        "value": round(n_videos / gen_dt / n_chips, 2),
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
        "n_chips": n_chips,
        "replicas": 1 if mesh is None else len(mesh),
        "device": device_name(gan.device),
    }


class GenerationServer:
    """Request-oriented wrapper over the chunk generator.

    Requests needing more than one chunk pipeline them (dispatch chunk k+1
    before fetching chunk k); dispatch is serialised under a lock, since one
    device has one compute stream here, while the host side of a fetch runs
    outside it. Counters, admission slots and the micro-batcher are the JAX
    server's. ``mesh``, a list of devices, splits every chunk over one
    replica per device (``make_chunk_fn``).
    """

    def __init__(
        self,
        gan: DCVGAN,
        state: GeneratorState,
        batchsize: int = 64,
        iters_per_chunk: int = 1,
        geo_name: str = "depth",
        mesh=None,
        queue_depth: int = 2,
        max_request_videos: int = 4096,
        max_concurrent: int = 4,
        batch_window_ms: float = 5.0,
    ):
        self.gan = gan
        self.state = state if mesh is None else place_replicas(state, mesh)
        self.mesh = mesh
        self.batchsize = batchsize
        self.iters = iters_per_chunk
        self.geo_name = geo_name
        self.queue_depth = max(1, queue_depth)
        self.max_request_videos = max_request_videos
        self._admission = threading.BoundedSemaphore(max(1, max_concurrent))
        self.chunk_fn = make_chunk_fn(gan, batchsize, iters_per_chunk, mesh)
        self._copy_stream = _copy_stream(gan)
        self._lock = threading.Lock()  # device dispatch order
        self._counter_lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.counters = {"requests": 0, "videos_served": 0, "errors": 0,
                         "rejected": 0, "batched_requests": 0, "batched_chunks": 0}
        _, _, xc = self._dispatch(prng.base_key(0, gan.device), False).result()
        self.video_shape = tuple(xc.shape[2:])  # (T, H, W, C)
        self.batcher = MicroBatcher(self, window_s=batch_window_ms / 1000.0)

    def close(self) -> None:
        self.batcher.close()

    def count(self, name: str, inc: int = 1) -> None:
        with self._counter_lock:
            self.counters[name] += inc

    def admit(self) -> bool:
        """Non-blocking admission slot; False means the caller should 429."""
        return self._admission.acquire(blocking=False)

    def release(self) -> None:
        self._admission.release()

    def _dispatch(self, gen: torch.Generator, with_geo: bool) -> InFlight:
        # the rounds the calling thread asked for (the micro-batcher's sets
        # them), else a whole chunk
        rounds = getattr(_rounds, "n", None)
        # InFlight records the chunk's event: it must stay inside the lock,
        # or one chunk's copy could wait on another chunk's event
        with self._lock:
            return InFlight(self.chunk_fn(self.state, gen, rounds=rounds), self._copy_stream,
                            True, with_geo)

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
        self.count("requests")
        self.count("videos_served", n)

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
            "n_chips": chips(self.mesh),
            "batchsize": self.batchsize,
            "iters_per_chunk": self.iters,
            "geometric_info": self.geo_name,
            "uptime_s": round(time.perf_counter() - self._t0, 1),
        }


class _PendingRequest:
    """One coalescable request: slices arrive on ``out`` as (geo, color)
    tuples; ``None`` terminates, an Exception propagates a chunk failure.
    ``queued`` is its open ``serve.request.queue`` span until the round
    dispatched for it starts."""

    __slots__ = ("remaining", "with_geo", "out", "dead", "id", "queued")

    def __init__(self, n: int, with_geo: bool, id: int):
        self.remaining = n
        self.with_geo = with_geo
        self.out: SimpleQueue = SimpleQueue()
        self.dead = False  # consumer abandoned (client disconnect)
        self.id = id
        self.queued = None


# the id of the batched request the calling handler thread answers (None
# for a seeded one), for its serve.http.write spans
_request = threading.local()
# the rounds GenerationServer._dispatch runs for the calling thread (unset:
# a whole chunk); only the micro-batcher's thread sets it
_rounds = threading.local()


class MicroBatcher:
    """Coalesces concurrent seedless requests into shared device chunks.

    One worker thread owns a server-side random stream. Each round it waits
    up to ``window_s`` while the live demand is under one chunk, dispatches
    ONE chunk of only the rounds that demand needs, ``min(iters,
    ceil(demand / batchsize))`` (under the server's device lock, so it
    interleaves with seeded requests), and deals the fetched videos to the
    waiting requests first come, first served, as copies (the pinned chunk
    is free at once). N concurrent small requests cost ``ceil(sum(n_i) /
    chunk)`` dispatches instead of N; ``dispatched_rounds`` counts the
    rounds they ran. Geometry is fetched only in rounds where the head of the
    queue wants it; a geo request behind colour-only traffic starts the
    next round.
    """

    def __init__(self, server: GenerationServer, window_s: float = 0.005, seed: int = 0):
        self.server = server
        self.window_s = max(0.0, window_s)
        self._cv = threading.Condition()
        self._waiting: deque = deque()
        self._closed = False
        # a stream of its own, apart from every client-pinned seed's stream
        self._key = prng.named(prng.base_key(seed, server.gan.device), "serve-microbatch")
        self._step = 0
        self.dispatched_rounds = 0  # apart from the server's counters, which are the JAX server's
        self._ids = itertools.count()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="serve-microbatcher")
        self._thread.start()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def submit(self, n: int, with_geo: bool = False):
        """Yield ``(geo | None, color)`` uint8 slices totalling n videos."""
        req = _PendingRequest(n, with_geo, next(self._ids))
        _request.id = req.id
        with self._cv:
            if self._closed:
                raise RuntimeError("server is shutting down")
            req.queued = trace.begin("serve.request.queue", req.id)
            self._waiting.append(req)
            self._cv.notify_all()
        try:
            while True:
                item = req.out.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
            self.server.count("requests")
            self.server.count("batched_requests")
            self.server.count("videos_served", n)
        finally:
            # consumer gone (disconnect or error): stop generating for it
            with self._cv:
                req.dead = True
                if req in self._waiting:
                    self._waiting.remove(req)

    def _live(self):
        return [r for r in self._waiting if not r.dead]

    def _loop(self) -> None:
        capacity = self.server.batchsize * self.server.iters
        while True:
            k = self._step
            with self._cv:
                with trace.span("serve.batch.idle", k):
                    while not self._live() and not self._closed:
                        self._cv.wait()
                if self._closed:
                    for r in self._live():
                        r.out.put(RuntimeError("server is shutting down"))
                    self._waiting.clear()
                    return
                # coalescing window: let concurrent arrivals join this chunk
                with trace.span("serve.batch.window", k):
                    deadline = time.perf_counter() + self.window_s
                    while sum(r.remaining for r in self._live()) < capacity:
                        left = deadline - time.perf_counter()
                        if left <= 0:
                            break
                        self._cv.wait(timeout=left)
                live = self._live()
                if not live:  # every waiter died during the window
                    continue
                want_geo = live[0].with_geo
                demand = sum(r.remaining for r in live)
                rounds = min(self.server.iters, max(1, -(-demand // self.server.batchsize)))
            self._step += 1
            for r in live:
                trace.end(r.queued)
                r.queued = None
            try:
                with trace.span("serve.batch.fetch", k):
                    gen = prng.for_step(self._key, k)
                    _rounds.n = rounds
                    _, xg, xc = self.server._dispatch(gen, want_geo).result()
                    color = xc.reshape((-1,) + xc.shape[2:])
                    geo = xg.reshape((-1,) + xg.shape[2:]) if want_geo else None
            except Exception as e:
                # fail only the requests this chunk was dispatched for;
                # arrivals during it stay queued for the next round
                self.server.count("errors")
                with self._cv:
                    for r in live:
                        if not r.dead:
                            r.out.put(e)
                        if r in self._waiting:
                            self._waiting.remove(r)
                continue
            self.server.count("batched_chunks")
            self.dispatched_rounds += rounds
            off = 0
            with self._cv, trace.span("serve.batch.deal", k):
                while off < len(color) and self._waiting:
                    r = self._waiting[0]
                    if r.dead:
                        self._waiting.popleft()
                        continue
                    if r.with_geo and geo is None:
                        break  # the next round fetches geometry for this head
                    take = min(r.remaining, len(color) - off)
                    r.out.put((
                        geo[off:off + take].copy() if r.with_geo else None,
                        color[off:off + take].copy(),
                    ))
                    r.remaining -= take
                    off += take
                    if r.remaining == 0:
                        r.out.put(None)
                        self._waiting.popleft()


class _Handler(BaseHTTPRequestHandler):
    server_version = "dcvgan-torch-serve/1.0"
    gen: GenerationServer  # set on the handler class by serve_http

    def log_message(self, fmt, *args):  # quiet: the stats endpoint instead
        pass

    def _json(self, code: int, payload: dict, headers: Sequence[Tuple[str, str]] = ()) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in headers:
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        url = urlparse(self.path)
        if url.path == "/healthz":
            self._json(200, self.gen.info())
            return
        if url.path == "/stats":
            with self.gen._counter_lock:
                counters = dict(self.gen.counters)
            self._json(200, dict(counters, **self.gen.info()))
            return
        if url.path != "/generate":
            self._json(404, {"error": f"unknown path {url.path}"})
            return
        self._generate(parse_qs(url.query))

    def do_POST(self) -> None:
        """POST /generate with a JSON body {"n": .., "seed": .., "geo": ..}."""
        url = urlparse(self.path)
        if url.path != "/generate":
            self._json(404, {"error": f"unknown path {url.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
            if length > 1_000_000:
                self._json(413, {"error": "request body too large"})
                return
            if length < 0:
                # rfile.read(-1) would block until EOF, holding this handler
                # thread for as long as the client keeps the socket open
                raise ValueError(f"bad Content-Length {length}")
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:  # json.JSONDecodeError is a ValueError
            self.gen.count("errors")
            self._json(400, {"error": f"bad JSON body: {e}"})
            return
        self._generate({k: [str(v)] for k, v in body.items()})

    def _generate(self, q: dict) -> None:
        try:
            n = int(q.get("n", ["16"])[0])
            raw_seed = q.get("seed", ["auto"])[0]
            seed = None if str(raw_seed).lower() in ("auto", "none", "") else int(raw_seed)
            with_geo = q.get("geo", ["0"])[0].lower() not in ("0", "", "false", "none")
            if n < 1:
                raise ValueError(f"n={n} must be >= 1")
        except ValueError as e:
            self.gen.count("errors")
            self._json(400, {"error": str(e)})
            return
        limit = self.gen.max_request_videos
        if with_geo:
            limit //= 2  # npz responses are buffered and carry two arrays
        if n > limit:
            self.gen.count("rejected")
            self._json(413, {
                "error": f"n={n} exceeds the per-request limit {limit}"
                + (" (geo responses are buffered)" if with_geo else ""),
                "max_request_videos": limit,
            })
            return
        if not self.gen.admit():
            self.gen.count("rejected")
            self._json(429, {"error": "server at max concurrent generate requests"},
                       headers=[("Retry-After", "1")])
            return
        _request.id = None  # MicroBatcher.submit sets it for a batched request
        try:
            if seed is None:  # server-picked stream: coalescable
                chunks = self.gen.batcher.submit(n, with_geo)
            else:  # pinned stream: replayable chunks of its own
                chunks = self.gen.generate_chunks(n, seed, with_geo)
            if with_geo:
                self._respond_npz(chunks)
            else:
                self._stream_npy(n, chunks)
        finally:
            self.gen.release()

    def _respond_npz(self, chunks) -> None:
        """Buffered npz response (color + geo); bounded by the videos cap."""
        try:
            geos, colors = [], []
            for geo, color in chunks:
                geos.append(geo)
                colors.append(color)
            geo, color = np.concatenate(geos), np.concatenate(colors)
            buf = io.BytesIO()
            np.savez(buf, color=color, geo=geo)
        except Exception as e:  # device or copy failure: 500, keep serving
            self.gen.count("errors")
            self._json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        body = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Type", "application/x-npz")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Video-Shape", "x".join(map(str, color.shape)))
        self.end_headers()
        with trace.span("serve.http.write", _request.id):
            self.wfile.write(body)

    def _stream_npy(self, n: int, chunks) -> None:
        """Stream an npy payload chunk by chunk: the npy header is computed
        from the known video shape, so Content-Length is exact and the host
        holds one device chunk at a time, not the payload."""
        shape = (n,) + self.gen.video_shape
        hdr = io.BytesIO()
        np.lib.format.write_array_header_1_0(
            hdr, {"descr": "|u1", "fortran_order": False, "shape": shape}
        )
        header = hdr.getvalue()
        total = len(header) + int(np.prod(shape))
        try:
            first = next(chunks)  # surface device failures before headers go out
        except Exception as e:
            self.gen.count("errors")
            self._json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-npy")
        self.send_header("Content-Length", str(total))
        self.send_header("X-Video-Shape", "x".join(map(str, shape)))
        self.end_headers()
        try:
            with trace.span("serve.http.write", _request.id):
                self.wfile.write(header)
                self.wfile.write(np.ascontiguousarray(first[1]).data)
            for _, color in chunks:
                with trace.span("serve.http.write", _request.id):
                    self.wfile.write(np.ascontiguousarray(color).data)
        except Exception:  # mid-stream failure: the connection dies, the server lives
            self.gen.count("errors")
            self.close_connection = True


def serve_http(gen: GenerationServer, port: int) -> ThreadingHTTPServer:
    """Bind a ThreadingHTTPServer for ``gen`` on ``port`` (0 = ephemeral)."""
    handler = type("BoundHandler", (_Handler,), {"gen": gen})
    return ThreadingHTTPServer(("", port), handler)


def replica_devices(n: int, device: Optional[str]) -> Optional[List[str]]:
    """``--mesh n`` as a list of devices: None for 1, ``cuda:0`` ..
    ``cuda:n-1`` (every card for -1), or n CPU replicas with ``--device
    cpu``."""
    if n == 1:
        return None
    cpu = device is not None and torch.device(device).type == "cpu"
    if n == -1:
        if cpu:
            raise ValueError("--mesh -1 takes every card; give a count with --device cpu")
        n = torch.cuda.device_count()
    if n < 1:
        raise ValueError(f"--mesh {n}: give a positive count or -1")
    if cpu:
        return ["cpu"] * n
    if n > torch.cuda.device_count():
        raise ValueError(f"--mesh {n} exceeds the {torch.cuda.device_count()} visible cards")
    return [f"cuda:{i}" for i in range(n)]


def main(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("result_dir", type=Path, nargs="?", help="a run directory of the port")
    parser.add_argument("iteration", type=int, nargs="?", help="its checkpoint step (-1: the latest)")
    parser.add_argument("--config", type=Path, default=None,
                        help="start from a config instead of a run directory")
    parser.add_argument("--weights", type=Path, default=None,
                        help="with --config: an npz written from a JAX state")
    parser.add_argument("--batchsize", "-b", type=int, default=256)
    parser.add_argument("--iters-per-chunk", type=int, default=4)
    parser.add_argument("--chunks", type=int, default=8)
    parser.add_argument("--sink", choices=["null", "npy", "mp4"], default="null")
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--with-geo", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--queue-depth", type=int, default=2)
    parser.add_argument("--listen", type=int, default=None, metavar="PORT",
                        help="start the HTTP serving endpoint instead of a fixed-chunk run")
    parser.add_argument("--max-request-videos", type=int, default=4096,
                        help="per-request n cap (413 beyond it); geo requests are capped "
                        "at half of it because npz responses are buffered")
    parser.add_argument("--max-concurrent", type=int, default=4,
                        help="concurrent /generate requests admitted before 429")
    parser.add_argument("--batch-window-ms", type=float, default=5.0,
                        help="micro-batching window: how long an unseeded request waits "
                        "for concurrent arrivals to share its device chunk")
    parser.add_argument("--mesh", type=int, default=1, metavar="N",
                        help="replicas to split each chunk over, one per device: cuda:0..N-1, "
                        "or N CPU replicas with --device cpu; -1: every card")
    parser.add_argument("--no-ema", action="store_true",
                        help="serve the live generator params even when the weights carry an EMA")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)
    if (args.config is None) == (args.result_dir is None):
        parser.error("give either <result_dir> <iteration> or --config")
    if args.result_dir is not None and args.iteration is None:
        parser.error("a run directory needs an iteration (-1: the latest)")
    if args.weights is not None and args.config is None:
        parser.error("--weights goes with --config")
    if args.sink != "null" and args.out is None:
        parser.error(f"--sink {args.sink} requires --out DIR")
    mesh = replica_devices(args.mesh, args.device)

    if args.config is not None:
        cfg = load_config(args.config)
        gan = DCVGAN(cfg, device=args.device)
        # the serving copy of a fresh state: parameters cast once to the compute dtype
        state = gan.load_state(args.weights) if args.weights else gan.init_state(cfg.seed).generators()
    else:
        cfg, gan, run = load_run(args.result_dir, args.iteration, device=args.device)
        state = run.generators()
    if not args.no_ema:
        state = state.with_ema_params()

    if args.listen is not None:
        gen = GenerationServer(
            gan,
            state,
            batchsize=args.batchsize,
            iters_per_chunk=args.iters_per_chunk,
            geo_name=cfg.geometric_info.name,
            queue_depth=args.queue_depth,
            max_request_videos=args.max_request_videos,
            max_concurrent=args.max_concurrent,
            batch_window_ms=args.batch_window_ms,
            mesh=mesh,
        )
        httpd = serve_http(gen, args.listen)
        print(json.dumps({"listening": httpd.server_address[1], **gen.info()}), flush=True)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
            gen.close()
        return None
    sink = Sink(args.sink, args.out, cfg.geometric_info.name, args.with_geo)
    stats = serve(
        gan,
        state,
        args.batchsize,
        args.iters_per_chunk,
        args.chunks,
        sink,
        seed=args.seed,
        queue_depth=args.queue_depth,
        mesh=mesh,
    )
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
