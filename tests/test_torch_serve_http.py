"""The port's HTTP serving front end against the JAX package's.

Both servers run on the CPU at a tiny width (ngf 8, T = 4, chunks of 2
videos). The same request table goes to both: status codes, headers, JSON
keys and counters must agree. The micro-batchers of both packages run
against stub servers whose chunks stamp every video with its round and
index, under gates that make the first-come-first-served dealing
deterministic; each request must receive the same stamps on both sides,
and the port's batcher dispatches only the rounds the waiting demand needs.
The mp4 sinks write the same uint8 chunk, and the CLI's two forms start.
"""

import http.client
import io
import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from dcvgan_torch import prng
from dcvgan_torch.cli import serve as port_serve
from dcvgan_torch.config import ExperimentConfig
from dcvgan_torch.io.video import read_video
from dcvgan_torch.train.checkpoint import CheckpointManager
from dcvgan_torch.train.step import DCVGAN
from dcvgan_tpu import prng as jax_prng
from dcvgan_tpu.cli import serve as jax_serve
from dcvgan_tpu.config import ExperimentConfig as JaxConfig
from dcvgan_tpu.io.video import read_video as jax_read_video
from dcvgan_tpu.train.step import DCVGAN as JaxDCVGAN
from torch_port_util import NGF
from torch_port_util import one_intra_op_thread  # noqa: F401
from torch_port_util import tracing  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

T = 4
TINY = {
    "video_length": T,
    "image_size": 64,
    "geometric_info": {"name": "depth", "channel": 1},
    "ggen": {"dim_z_content": 8, "dim_z_motion": 4, "ngf": NGF},
    "cgen": {"dim_z_color": 4, "ngf": NGF},
    "idis": {"ndf": NGF},
    "vdis": {"ndf": NGF},
    "gdis": {"ndf": NGF},
    "trainer": {"precision": "float32"},
}
LIMITS = {"batchsize": 2, "iters_per_chunk": 1, "max_request_videos": 8, "max_concurrent": 2,
          "batch_window_ms": 1.0}
HEADERS = ("Content-Type", "Retry-After", "X-Video-Shape")


def _port_gan():
    cfg = ExperimentConfig.from_dict(TINY)
    cfg.validate()
    return cfg, DCVGAN(cfg, device="cpu")


def _listen(module, gen):
    httpd = module.serve_http(gen, 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread


@pytest.fixture(scope="module")
def servers():
    """{"jax": ..., "port": ...}: each a GenerationServer and its port."""
    jcfg = JaxConfig.from_dict(TINY)
    jcfg.validate()
    jgan = JaxDCVGAN(jcfg)
    _, pgan = _port_gan()
    gens = {
        "jax": jax_serve.GenerationServer(jgan, jgan.init_state(jax_prng.base_key(0)), **LIMITS),
        "port": port_serve.GenerationServer(pgan, pgan.init_state(0).generators(), **LIMITS),
    }
    running = {k: _listen(jax_serve if k == "jax" else port_serve, g) for k, g in gens.items()}
    yield {k: SimpleNamespace(gen=g, port=running[k][0].server_address[1]) for k, g in gens.items()}
    for k, (httpd, thread) in running.items():
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        gens[k].close()


def _send(port, method, path, body=None, content_length=None):
    """(status, the HEADERS present, body bytes) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.putrequest(method, path)
        if body is not None or content_length is not None:
            conn.putheader("Content-Length", str(len(body or b"") if content_length is None
                                                 else content_length))
        conn.endheaders(body)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, {h: resp.getheader(h) for h in HEADERS}, data
    finally:
        conn.close()


def _npy(array: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, array)
    return buf.getvalue()


# (id, method, path, body, Content-Length override, admission slots taken first)
TABLE = [
    ("healthz", "GET", "/healthz", None, None, False),
    ("stats", "GET", "/stats", None, None, False),
    ("get seeded", "GET", "/generate?n=3&seed=7", None, None, False),
    ("post seeded", "POST", "/generate", b'{"n": 3, "seed": 7, "geo": false}', None, False),
    ("get geo", "GET", "/generate?n=2&seed=0&geo=1", None, None, False),
    ("get unseeded", "GET", "/generate?n=2", None, None, False),
    ("n=0", "GET", "/generate?n=0", None, None, False),
    ("bad seed", "GET", "/generate?n=2&seed=abc", None, None, False),
    ("bad JSON", "POST", "/generate", b"{not json", None, False),
    ("body not an object", "POST", "/generate", b"[1, 2]", None, False),
    ("negative Content-Length", "POST", "/generate", None, -1, False),
    ("body over 1 MB", "POST", "/generate", None, 1_000_001, False),
    ("n over the cap", "GET", "/generate?n=9", None, None, False),
    ("geo over half the cap", "GET", "/generate?n=5&geo=1", None, None, False),
    ("admission full", "GET", "/generate?n=2", None, None, True),
    ("unknown GET path", "GET", "/nope", None, None, False),
    ("unknown POST path", "POST", "/nope", b"{}", None, False),
]


@pytest.mark.parametrize("row", TABLE, ids=[r[0] for r in TABLE])
def test_request_gets_the_jax_answer(servers, row):
    _, method, path, body, length, hold = row
    answers = {}
    for side, s in servers.items():
        if hold:
            assert s.gen.admit() and s.gen.admit()
        try:
            status, headers, data = _send(s.port, method, path, body, length)
        finally:
            if hold:
                s.gen.release()
                s.gen.release()
        keys = sorted(json.loads(data)) if headers["Content-Type"] == "application/json" else None
        if headers["Content-Type"] == "application/x-npy":
            # the hand-framed stream is exactly np.save's format
            vids = np.load(io.BytesIO(data))
            assert vids.dtype == np.uint8 and _npy(vids) == data, side
        if headers["Content-Type"] == "application/x-npz":
            npz = np.load(io.BytesIO(data))
            assert npz["color"].shape == (2, T, 64, 64, 3) and npz["geo"].shape == (2, T, 64, 64, 1)
        answers[side] = (status, headers, keys)
    assert answers["port"] == answers["jax"]
    if hold:
        assert answers["port"][1]["Retry-After"] == "1"


def _settled(gens, timeout=60.0):
    """The counters of each server once they agree (a handler counts a
    request after its last byte is written, so a client can read the body
    a moment before the count moves)."""
    deadline = time.monotonic() + timeout
    while True:
        snap = {}
        for k, g in gens.items():
            with g._counter_lock:
                snap[k] = dict(g.counters)
        if snap["port"] == snap["jax"] or time.monotonic() > deadline:
            return snap
        time.sleep(0.01)


def test_counters_match_after_the_table(servers):
    snap = _settled({k: s.gen for k, s in servers.items()})
    assert snap["port"] == snap["jax"]
    assert set(snap["port"]) == {"requests", "videos_served", "errors", "rejected",
                                 "batched_requests", "batched_chunks"}
    with urllib.request.urlopen(f"http://127.0.0.1:{servers['port'].port}/stats") as r:
        stats = json.loads(r.read())
    assert {k: stats[k] for k in snap["port"]} == snap["port"]


def test_seeded_bytes_equal_generate(servers):
    s = servers["port"]
    status, headers, body = _send(s.port, "GET", "/generate?n=3&seed=11")
    assert status == 200 and headers["X-Video-Shape"] == f"3x{T}x64x64x3"
    _, color = s.gen.generate(3, 11)
    assert body == _npy(color)
    status, _, posted = _send(s.port, "POST", "/generate", b'{"n": 3, "seed": 11}')
    assert status == 200 and posted == body
    status, headers, npz = _send(s.port, "GET", "/generate?n=3&seed=11&geo=1")
    geo, color = s.gen.generate(3, 11, with_geo=True)
    got = np.load(io.BytesIO(npz))
    assert headers["Content-Type"] == "application/x-npz"
    np.testing.assert_array_equal(got["color"], color)
    np.testing.assert_array_equal(got["geo"], geo)


# unseeded n = 3 (two rounds of a 2-video chunk), unseeded n = 1, seeded,
# unseeded with geometry: batched requests 0, 1, 2 in rounds 0-1, 2, 3
EXCHANGE = ["/generate?n=3", "/generate?n=1", "/generate?n=3&seed=5", "/generate?n=2&geo=1"]


def _exchange():
    """The EXCHANGE's replies, one request at a time, from a fresh port
    server, and its /stats once every request is counted."""
    _, pgan = _port_gan()
    gen = port_serve.GenerationServer(pgan, pgan.init_state(0).generators(), **LIMITS)
    httpd, thread = _listen(port_serve, gen)
    port = httpd.server_address[1]
    try:
        replies = [_send(port, "GET", path) for path in EXCHANGE]
        deadline = time.monotonic() + 60  # a handler counts after its last byte
        while gen.counters["requests"] < len(EXCHANGE) and time.monotonic() < deadline:
            time.sleep(0.01)
        _, _, stats = _send(port, "GET", "/stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        gen.close()
    stats = json.loads(stats)
    stats.pop("uptime_s")
    return replies, stats


def test_tracing_changes_no_reply_and_no_counter(tracing):
    on = _exchange()
    tracing.disable()
    assert on == _exchange()
    replies, stats = on
    assert [status for status, _, _ in replies] == [200] * 4
    assert (stats["requests"], stats["batched_requests"], stats["batched_chunks"]) == (4, 3, 4)


def test_a_batched_request_records_its_queue_rounds_and_writes(tracing):
    _exchange()
    recs = tracing.records()
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    fetch = {r.id: r for r in by["serve.batch.fetch"]}
    assert sorted(fetch) == [0, 1, 2, 3]
    for k in fetch:  # each round's phases, in order
        window, deal = ([r for r in by[name] if r.id == k] for name in ("serve.batch.window",
                                                                       "serve.batch.deal"))
        assert len(window) == len(deal) == 1
        assert window[0].end_ns <= fetch[k].start_ns <= fetch[k].end_ns <= deal[0].start_ns
    inside = [r for r in recs if r.parent == "serve.batch.fetch"]
    assert {r.name for r in inside} == {"serve.chunk.enqueue", "serve.chunk.copy_issue",
                                        "serve.chunk.wait"}
    # each batched request's queue span ends where its first round's fetch starts
    queue = {r.id: r for r in by["serve.request.queue"]}
    assert sorted(queue) == [0, 1, 2]
    for rid, first_round in ((0, 0), (1, 2), (2, 3)):
        q, f = queue[rid], fetch[first_round]
        assert q.start_ns <= q.end_ns <= f.start_ns
        assert all(other.start_ns < q.start_ns for k, other in fetch.items() if k < first_round)
        assert f.start_ns - q.end_ns < 1e9
    # the writes of its 200 reply under its id; the seeded request's under none
    writes = [r.id for r in by["serve.http.write"]]
    assert sorted(writes, key=str) == [0, 0, 1, 2, None, None]


class _StampServer:
    """The part of a GenerationServer a MicroBatcher reads, with a chunk
    function that stamps video i of call r with (r, i) (colour pixel
    (r, i, 0), geometry 16 r + i). Call r first waits on ``gates[r]``, and
    raises where r is in ``fail``; ``made`` lists each call's rounds."""

    def __init__(self, gates=None, fail=(), batchsize=4, iters=2):
        self.batchsize, self.iters = batchsize, iters
        self.gates = gates or {}
        self.fail = set(fail)
        self.calls = 0
        self.made = []
        self.state = None
        self._lock = threading.Lock()
        self._counter_lock = threading.Lock()
        self.counters = dict.fromkeys(["requests", "videos_served", "errors", "rejected",
                                       "batched_requests", "batched_chunks"], 0)

    def count(self, name, inc=1):
        with self._counter_lock:
            self.counters[name] += inc

    def stamps(self, rounds=None):
        rounds = self.iters if rounds is None else rounds
        r = self.calls
        self.calls += 1
        self.made.append(rounds)
        if r in self.gates:
            assert self.gates[r].wait(timeout=60), f"round {r}'s gate never opened"
        if r in self.fail:
            raise RuntimeError(f"round {r} failed")
        n = self.batchsize * rounds
        xc = np.zeros((n, 1, 1, 1, 3), np.uint8)
        xc[:, 0, 0, 0, 0], xc[:, 0, 0, 0, 1] = r, np.arange(n)
        xg = (16 * r + np.arange(n, dtype=np.uint8)).reshape(n, 1, 1, 1, 1)
        shape = (rounds, self.batchsize, 1, 1, 1)
        return np.uint32(0), xg.reshape(shape + (1,)), xc.reshape(shape + (3,))


class _JaxStamps(_StampServer):
    def chunk_fn(self, state, key):
        return self.stamps()


class _PortStamps(_StampServer):
    gan = SimpleNamespace(device=torch.device("cpu"))
    _copy_stream = None
    _dispatch = port_serve.GenerationServer._dispatch  # the real dispatch, on the CPU

    def chunk_fn(self, state, gen, rounds=None):
        csum, xg, xc = self.stamps(rounds)
        return torch.tensor(int(csum)), torch.from_numpy(xg), torch.from_numpy(xc)


def _decode(item):
    geo, color = item
    got = [(int(v[0, 0, 0, 0]), int(v[0, 0, 0, 1])) for v in color]
    if geo is not None:
        assert [(int(g.flat[0]) // 16, int(g.flat[0]) % 16) for g in geo] == got
    return got


def _run_script(batcher, server, script, gates):
    """Submit ``script`` [(name, n, geo, abandon)] one after another (each
    waiting in the queue before the next), open round 0's gate, and return
    {name: stamps received or the exception}, with the counters. Closes
    ``batcher``."""
    got = {name: [] for name, *_ in script}

    def consume(name, n, geo, abandon):
        it = batcher.submit(n, geo)
        try:
            for item in it:
                got[name] += _decode(item)
                if abandon:
                    it.close()
                    gates["abandoned"].set()
                    return
        except RuntimeError as e:
            got[name] = str(e)

    def until(cond):
        deadline = time.monotonic() + 60
        while not cond() and time.monotonic() < deadline:
            time.sleep(0.001)
        assert cond()

    def queued():
        with batcher._cv:
            return len(batcher._waiting)

    threads = []
    try:
        for i, (name, n, geo, abandon) in enumerate(script):
            threads.append(threading.Thread(target=consume, args=(name, n, geo, abandon)))
            threads[-1].start()
            until(lambda: queued() == i + 1)
            if i == 0:  # round 0 starts with the first request alone, and waits
                until(lambda: server.calls == 1)
        gates[0].set()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        batcher.close()
    return got, server.counters


# A: 3, B: 6, X: 10 (leaves after its first slice), C: 2, G: 4 with
# geometry, D: 9, in chunks of one round of 8 videos
SCRIPT = [("A", 3, False, False), ("B", 6, False, False), ("X", 10, False, True),
          ("C", 2, False, False), ("G", 4, True, False), ("D", 9, False, False)]
EXPECTED = {
    "A": [(0, 0), (0, 1), (0, 2)],
    "B": [(0, i) for i in range(3, 8)] + [(1, 0)],
    "X": [(1, i) for i in range(1, 8)],
    "C": [(2, 0), (2, 1)],  # round 2 stops at G: it fetched no geometry
    "G": [(3, i) for i in range(4)],
    "D": [(3, i) for i in range(4, 8)] + [(4, i) for i in range(5)],
}
# the port's own dealing of SCRIPT in chunks of 2 rounds of 4: call 0, for A
# alone, makes one round, so B's first video comes from it; every later
# call's waiting demand needs both rounds
EXPECTED_SHORT = {
    "A": [(0, 0), (0, 1), (0, 2)],
    "B": [(0, 3)] + [(1, i) for i in range(5)],
    "X": [(1, 5), (1, 6), (1, 7)],
    "C": [(2, 0), (2, 1)],
    "G": [(3, i) for i in range(4)],
    "D": [(3, i) for i in range(4, 8)] + [(4, i) for i in range(5)],
}


@pytest.mark.parametrize("case", ["dealing", "dealing-short", "failure"])
def test_micro_batcher_deals_as_the_jax_one(case):
    """The same arrival script through both packages' MicroBatcher. Round 0
    waits until the whole script is queued; in the dealing cases round 2
    waits until X has left, and in the failure case round 0 raises: only
    the request it was dispatched for (A, alone in the queue when it
    started) fails, and B is served by round 1. In the dealing case a chunk
    is one round, so the port's short dispatches deal as JAX's whole chunks;
    the dealing-short case runs the port alone on chunks of 2 rounds."""
    script = SCRIPT if case != "failure" else [("A", 2, False, False), ("B", 2, False, False)]
    sides = (("jax", jax_serve.MicroBatcher, _JaxStamps),
             ("port", port_serve.MicroBatcher, _PortStamps))
    results, stubs, batchers = {}, {}, {}
    for side, batcher_cls, stub in sides[1:] if case == "dealing-short" else sides:
        gates = {0: threading.Event(), "abandoned": threading.Event()}
        if case == "dealing":
            server = stub(gates={0: gates[0], 2: gates["abandoned"]}, batchsize=8, iters=1)
        elif case == "dealing-short":
            server = stub(gates={0: gates[0], 2: gates["abandoned"]})
        else:
            server = stub(gates={0: gates[0]}, fail={0})
        stubs[side] = server
        batchers[side] = batcher_cls(server, window_s=0.001)
        results[side] = _run_script(batchers[side], server, script, gates)
    if case != "dealing-short":
        assert results["port"] == results["jax"]
    got, counters = results["port"]
    if case == "failure":
        assert got == {"A": "round 0 failed", "B": [(1, 0), (1, 1)]}
        assert counters["errors"] == 1 and counters["batched_chunks"] == 1
        return
    assert got == (EXPECTED if case == "dealing" else EXPECTED_SHORT)
    assert counters == {"requests": 5, "videos_served": 24, "errors": 0, "rejected": 0,
                        "batched_requests": 5, "batched_chunks": 5}
    dealt = [stamp for stamps in got.values() for stamp in stamps]
    assert len(dealt) == len(set(dealt))  # no video dealt twice
    made = [1] * 5 if case == "dealing" else [1, 2, 2, 2, 2]
    assert stubs["port"].made == made
    assert batchers["port"].dispatched_rounds == sum(made)


# (demand, the rounds of each dispatch) for chunks of 3 rounds of B = 4
DEMANDS = [(1, [1]), (4, [1]), (5, [2]), (12, [3]), (13, [3, 1])]


@pytest.mark.parametrize("demand,made", DEMANDS, ids=["1", "B", "B+1", "B*iters", "above"])
def test_batcher_dispatches_the_rounds_its_demand_needs(demand, made):
    """One request of ``demand`` videos: each dispatch runs min(iters,
    ceil(remaining / B)) rounds, and the request gets the calls' videos in
    order."""
    server = _PortStamps(batchsize=4, iters=3)
    batcher = port_serve.MicroBatcher(server, window_s=0.001)
    try:
        got = [stamp for item in batcher.submit(demand) for stamp in _decode(item)]
    finally:
        batcher.close()
    assert server.made == made
    assert batcher.dispatched_rounds == sum(made) == -(-demand // 4)
    assert got == [(r, i) for r, rounds in enumerate(made) for i in range(4 * rounds)][:demand]
    assert server.counters["batched_chunks"] == len(made)


def test_short_dispatch_equals_the_chunks_first_rounds():
    """A 1-round and a 2-round dispatch from the batcher's thread are the
    first rows of the whole chunk from the same stream, byte for byte, and
    each checksum is the sum of its own rows."""
    _, gan = _port_gan()
    server = port_serve.GenerationServer(gan, gan.init_state(0).generators(), batchsize=2,
                                         iters_per_chunk=3)
    gen = prng.for_step(prng.base_key(5), 3)
    try:
        whole = server._dispatch(gen, True).result()

        def short(rounds):
            out = []

            def run():  # as the micro-batcher's thread dispatches
                port_serve._rounds.n = rounds
                out.append(server._dispatch(gen, True).result())

            thread = threading.Thread(target=run)
            thread.start()
            thread.join(timeout=60)
            assert not thread.is_alive()
            return out[0]

        parts = {rounds: short(rounds) for rounds in (1, 2)}
    finally:
        server.close()
    assert whole[2].shape == (3, 2, T, 64, 64, 3)
    for rounds, (csum, xg, xc) in parts.items():
        assert xc.shape == (rounds, 2, T, 64, 64, 3) and xg.shape == (rounds, 2, T, 64, 64, 1)
        assert xc.tobytes() == whole[2][:rounds].tobytes()
        assert xg.tobytes() == whole[1][:rounds].tobytes()
        assert csum == (int(xc.sum(dtype=np.int64)) + int(xg.sum(dtype=np.int64))) % 2**32
    assert whole[0] == (int(whole[2].sum(dtype=np.int64))
                        + int(whole[1].sum(dtype=np.int64))) % 2**32


def test_mp4_sink_writes_the_jax_files(tmp_path):
    rng = np.random.default_rng(0)
    xc = rng.integers(0, 256, (1, 2, T, 64, 64, 3), dtype=np.uint8)
    xg = rng.integers(0, 256, (1, 2, T, 64, 64, 1), dtype=np.uint8)
    jsink = jax_serve.Sink("mp4", tmp_path / "jax", "depth", with_geo=True)
    jsink.drain(3, np.uint32(0), xg, xc)
    jsink.close()
    psink = port_serve.Sink("mp4", tmp_path / "port", "depth", with_geo=True)
    assert psink.write(3, xg, xc) == xc.nbytes + xg.nbytes
    psink.close()
    for sub in ("color", "depth"):
        names = sorted(p.name for p in (tmp_path / "port" / sub).iterdir())
        assert names == sorted(p.name for p in (tmp_path / "jax" / sub).iterdir())
        assert names == ["000006.mp4", "000007.mp4"]  # chunk 3 of 2 videos
        for name in names:
            got = read_video(tmp_path / "port" / sub / name)
            assert got.shape == (T, 64, 64, 3)
            np.testing.assert_array_equal(got, jax_read_video(tmp_path / "jax" / sub / name))


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A port run directory (config.yml, models/step_1.pt) of a fresh state."""
    run = tmp_path_factory.mktemp("run")
    (run / "config.yml").write_text(yaml.safe_dump(TINY))
    _, gan = _port_gan()
    state = gan.init_state(0)
    state.step = 1
    CheckpointManager(run / "models").save(state)
    return run


def test_cli_serves_a_run_directory_into_mp4(run_dir, tmp_path):
    out = tmp_path / "served"
    stats = port_serve.main([str(run_dir), "-1", "-b", "2", "--iters-per-chunk", "1", "--chunks", "2",
                             "--sink", "mp4", "--out", str(out), "--with-geo", "--device", "cpu"])
    assert stats["videos"] == 4 and stats["sink"] == "mp4"
    for sub in ("color", "depth"):
        files = sorted((out / sub).glob("*.mp4"))
        assert [p.name for p in files] == [f"{i:06d}.mp4" for i in range(4)]
        assert read_video(files[-1]).shape == (T, 64, 64, 3)


def test_cli_listen_prints_its_port_and_serves(run_dir, monkeypatch, capsys):
    real = ThreadingHTTPServer.serve_forever
    seen = []

    def serve_briefly(httpd, poll_interval=0.5):
        thread = threading.Thread(target=real, args=(httpd,), daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            with urllib.request.urlopen(f"{url}/healthz") as r:
                seen.append(json.loads(r.read()))
            with urllib.request.urlopen(f"{url}/generate?n=3") as r:
                seen.append(np.load(io.BytesIO(r.read())).shape)
        finally:
            httpd.shutdown()
            thread.join(timeout=10)

    monkeypatch.setattr(ThreadingHTTPServer, "serve_forever", serve_briefly)
    port_serve.main([str(run_dir), "1", "--listen", "0", "-b", "2", "--iters-per-chunk", "1",
                     "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert printed["listening"] > 0 and printed["device"] == "cpu" and printed["batchsize"] == 2
    assert seen[0]["status"] == "ok" and seen[0]["geometric_info"] == "depth"
    assert seen[1] == (3, T, 64, 64, 3)


@pytest.mark.parametrize("argv", [
    ["--mesh", "2"],
    ["--mesh", "-1", "--listen", "0"],
])
def test_mesh_is_not_ported(run_dir, argv, capsys):
    """``--mesh`` is ported: 2 CPU replicas serve the run (the bytes are
    held against one replica in ``test_torch_trainer_dist.py``); -1 means
    every card, which the CPU has none of, so it is refused there."""
    argv = [str(run_dir), "-1", "--device", "cpu", "-b", "2", "--iters-per-chunk", "1",
            "--chunks", "1"] + argv
    if "-1" in argv[1:] and argv[-3:] == ["-1", "--listen", "0"]:
        with pytest.raises(ValueError, match="--mesh -1"):
            port_serve.main(argv)
        return
    stats = port_serve.main(argv)
    assert stats["replicas"] == 2 and stats["n_chips"] == 1 and stats["videos"] == 2
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == stats


def test_server_with_a_mesh_raises():
    """A mesh is a list of devices; anything else raises."""
    _, gan = _port_gan()
    with pytest.raises(TypeError, match="list of devices"):
        port_serve.GenerationServer(gan, gan.init_state(0).generators(), mesh=object())


@pytest.mark.parametrize("argv", [
    [],  # neither form
    ["RUN"],  # a run directory without an iteration
    ["RUN", "-1", "--config", "CFG"],  # both forms
    ["RUN", "-1", "--weights", "w.npz"],  # weights without a config
    ["RUN", "-1", "--sink", "npy"],  # a sink without --out
])
def test_cli_refuses_ambiguous_arguments(run_dir, argv):
    argv = [str(run_dir) if a == "RUN" else str(run_dir / "config.yml") if a == "CFG" else a
            for a in argv]
    with pytest.raises(SystemExit):
        port_serve.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("extra", [["--chunks", "1"], ["--listen", "0"]])
def test_run_directory_form_raises_without_cuda(run_dir, monkeypatch, extra):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.main([str(run_dir), "-1"] + extra)
