"""Traffic ``closed_http``: closed-loop clients against the program's HTTP
front end (``cli/serve.py``: ``serve_http`` -> ``_Handler`` ->
``MicroBatcher`` -> ``GenerationServer``).

Set-up draws the benchmark's weights and the reference's running
statistics (as ``sample``), builds a ``GenerationServer`` with the cell's
chunk, window and admission slots, and serves it on port 0 in this process.
The clients run in a process of their own (this file run as a script: no
torch, its own interpreter lock): ``clients`` threads, each sending an
unseeded colour request, reading the npy reply to its last byte and sending
again, ``n`` drawn from the seed uniformly from ``n_mix``. Requests that
complete within ``[start + warm_s, start + warm_s + --seconds]`` are the
window's. A request's latency is from its first send to its last byte. A
client that sends again at once can find its slot not yet released (the
handler releases it after the reply's last byte): a 429 is sent again after
1 ms, within the same request, and counted.

For the output check the harness wraps the server's chunk dispatch from
outside and keeps, for each generated video, a digest of its first frame's
first rows and where it came from (the chunk's stream and row). Each client keeps the
bytes of the requests a seed-drawn sample names; after the window each
sampled video is found by its digest, recomputed by the reference from the
same stream and compared, and no video may be dealt twice.

Parameters: ``batchsize``, ``rounds``, ``window_ms``, ``slots``,
``clients``, ``n_mix``, ``warm_s``, ``sampled_requests``,
``trace_warm_s``, ``trace_s``; limit: ``video_gap``.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve()


def _digest(frame: np.ndarray) -> bytes:
    """A video's key: its first frame's first four rows, hashed (cheap
    enough to take for every video a chunk makes)."""
    return hashlib.blake2b(np.ascontiguousarray(frame[:4]).tobytes(), digest_size=16).digest()


def _npy_header(n: int, shape: tuple) -> int:
    import io

    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, {"descr": "|u1", "fortran_order": False, "shape": (n,) + shape})
    return len(buf.getvalue())


# ---------------------------------------------------------------- clients
def clients_main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--clients", type=int, required=True)
    ap.add_argument("--n-mix", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--start", type=float, required=True)
    ap.add_argument("--end", type=float, required=True)
    ap.add_argument("--keep", type=int, required=True)
    ap.add_argument("--video-shape", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    mix = [int(x) for x in a.n_mix.split(",")]
    shape = tuple(int(x) for x in a.video_shape.split(","))
    per_video = int(np.prod(shape))
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    records, lock = [], threading.Lock()

    def client(c: int) -> None:
        rng = np.random.default_rng((a.seed, c))
        # the sample: this client's requests, counted from the window's
        # start, whose bytes are kept: its first, its first of the largest n
        # and ``keep`` drawn from its first 300
        keep = {0} | set(int(i) for i in rng.integers(0, 300, a.keep))
        longest_kept, j = False, 0
        conn = http.client.HTTPConnection("127.0.0.1", a.port, timeout=120)
        i = 0
        while time.time() < a.end:
            n = int(rng.choice(mix))
            t0 = time.time()
            retries = 0
            while True:
                conn.request("GET", f"/generate?n={n}")
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 429:
                    break
                retries += 1
                time.sleep(0.001)
            t1 = time.time()
            ok = resp.status == 200 and len(body) == _npy_header(n, shape) + n * per_video
            kept = None
            if a.start <= t0:
                if ok and (j in keep or (n == max(mix) and not longest_kept)):
                    longest_kept = longest_kept or n == max(mix)
                    kept = str(out / f"c{c}-{i}.npy")
                    Path(kept).write_bytes(body)
                j += 1
            with lock:
                records.append({"client": c, "i": i, "n": n, "t0": t0, "t1": t1,
                                "status": resp.status, "bytes": len(body), "ok": ok, "kept": kept,
                                "retries": retries})
            i += 1
        conn.close()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(a.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    (out / "records.json").write_text(json.dumps(records))
    return 0


# ---------------------------------------------------------------- server side
def measure(ctx):
    import torch

    import dcvgan_torch.cli.serve as serve_mod
    from dcvgan_torch.train.step import DCVGAN
    from portbench import judge, weights
    from portbench.harness import Outcome, Readings
    from portbench.reference import steps, streams
    from portbench.yardstick import percentile

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    w = weights.draw(cfg, ctx.seed, dev)
    running = steps.calibrate(cfg, w, ctx.seed, dev)
    gan = DCVGAN(cfg, device=dev)
    state = gan.init_state(ctx.seed)
    for m in ("ggen", "cgen"):
        weights.load_into(getattr(state, m), w[m], m)
        weights.load_running(getattr(state, m), running[m])
    server = serve_mod.GenerationServer(
        gan, state.generators(), batchsize=p["batchsize"], iters_per_chunk=p["rounds"],
        geo_name=cfg.geometric_info.name, max_concurrent=p["slots"], batch_window_ms=p["window_ms"])
    del state

    origin = {}  # first-frame digest -> (chunk stream seed, round, row)
    dispatch = server._dispatch

    def recorded_dispatch(gen, with_geo):
        flight = dispatch(gen, with_geo)
        result = flight.result

        def traced_result():
            csum, xg, xc = result()
            seed = gen.initial_seed()
            for r in range(xc.shape[0]):
                for j in range(xc.shape[1]):
                    origin[_digest(xc[r, j, 0])] = (seed, r, j)
            return csum, xg, xc

        flight.result = traced_result
        return flight

    server._dispatch = recorded_dispatch
    httpd = serve_mod.serve_http(server, 0)
    port = httpd.server_address[1]
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()

    def stats():
        with server._counter_lock:
            return dict(server.counters)

    out_dir = ctx.work / "http" / ctx.cell
    shutil.rmtree(out_dir, ignore_errors=True)  # the last run's kept replies
    start = time.time() + p["warm_s"]
    # a traced run's untraced part lasts --seconds of its own
    traced_part = p["trace_warm_s"] + p["trace_s"] + 2.0 if ctx.trace else 0.0
    end = start + traced_part + ctx.seconds
    child = subprocess.Popen(
        [sys.executable, str(HERE), "--port", str(port), "--clients", str(p["clients"]),
         "--n-mix", ",".join(map(str, p["n_mix"])), "--seed", str(ctx.seed),
         "--start", repr(start), "--end", repr(end), "--keep", str(p["sampled_requests"]),
         "--video-shape", ",".join(map(str, server.video_shape)), "--out", str(out_dir)])
    t_rest, traced = start, None
    try:
        time.sleep(max(0.0, start - time.time()))
        at_start = stats()
        if ctx.trace:
            from portbench.trace import Span

            span = Span()
            span.open()
            time.sleep(p["trace_warm_s"])
            span.measure()
            traced = time.time()
            time.sleep(p["trace_s"])
            span.close()
            time.sleep(max(0.0, start + traced_part - time.time()))
            t_rest = time.time()
        at_rest = stats()
        time.sleep(max(0.0, end - time.time()))
        at_end = stats()
        if child.wait(timeout=ctx.seconds + 120) != 0:
            raise RuntimeError(f"the client process exited with {child.returncode}")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        httpd.shutdown()
        httpd.server_close()
        server.close()
        serving.join(timeout=10)

    records = json.loads((out_dir / "records.json").read_text())
    window = [r for r in records if t_rest <= r["t1"] <= end]
    rest = window
    lat = [1e3 * (r["t1"] - r["t0"]) for r in window]
    chunk = p["batchsize"] * p["rounds"]
    d_chunks = at_end["batched_chunks"] - at_rest["batched_chunks"]
    d_videos = at_end["videos_served"] - at_rest["videos_served"]
    readings = Readings(
        spans={"request": [r["t1"] - r["t0"] for r in rest]},
        counters={"delivered_share": d_videos / (d_chunks * chunk) if d_chunks else 0.0,
                  "retries_429": sum(r["retries"] for r in window),
                  "traced_s": (t_rest - traced) if traced else 0.0,
                  "window_chunks": at_end["batched_chunks"] - at_start["batched_chunks"]},
        trace=span.summarize() if ctx.trace else None)
    holder = {"server": server, "gan": gan}

    def release():
        holder.clear()

    def check():
        dealt, gaps = set(), []
        need = {}
        for r in records:  # every sampled request of the run, traced part or not
            if not r["kept"]:
                continue
            body = np.load(r["kept"])
            rows = []
            for v in range(body.shape[0]):
                src = origin.get(_digest(body[v, 0]))
                if src is None or src in dealt:
                    return [("video_gap", float("inf"), p["limits"]["video_gap"])]
                dealt.add(src)
                rows.append(src)
                need.setdefault(src[:2], []).append((src[2], body[v]))
        for (seed, rnd), vids in need.items():
            gen = streams.fold_in(streams.generator(seed, dev), rnd)
            want = steps.sample_round(cfg, w, running, gen, p["batchsize"],
                                      rows=[j for j, _ in vids]).cpu().numpy()
            gaps.append(judge.video_gap(np.stack([v for _, v in vids]), want))
        if not gaps:
            return [("video_gap", float("inf"), p["limits"]["video_gap"])]
        return [("video_gap", max(gaps), p["limits"]["video_gap"])]

    return Outcome(end_to_end={"request_p95_ms": percentile(lat, 95) if lat else float("inf")},
                   t_window=start, attempted=len(window),
                   failed=sum(1 for r in window if not r["ok"]),
                   readings=readings, check=check, release=release)


if __name__ == "__main__":
    sys.exit(clients_main())
