"""The port's serving loop: quantize, checksum, seeded replay, CLI, device rule."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dcvgan_torch import prng
from dcvgan_torch.cli import serve as port_serve
from dcvgan_torch.cli.serve import GenerationServer, Sink, make_chunk_fn, quantize, serve
from dcvgan_torch.config import ExperimentConfig
from dcvgan_torch.models import ggen as ggen_mod
from dcvgan_torch.models import layers
from dcvgan_torch.ops import softmax_codes as sc
from dcvgan_torch.train.step import DCVGAN
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
    "trainer": {"precision": "bfloat16"},
}


def _jax_quantize(x):
    # the expression of dcvgan_tpu/cli/serve.py's make_chunk_fn
    return ((jnp.clip(x, -1.0, 1.0) + 1.0) * 127.5).astype(jnp.uint8)


def _quantize_inputs():
    rng = np.random.default_rng(0)
    # integers k/127.5 - 1 and points just below them, where a truncating
    # cast and a rounding one part, plus values outside [-1, 1]
    k = np.arange(256, dtype=np.float64)
    edges = k / 127.5 - 1.0
    vals = np.concatenate([
        edges, np.nextafter(edges, -2.0), edges - 1e-3, edges + 1e-3,
        rng.uniform(-1.5, 1.5, 4096), [-1.0, 1.0, -2.0, 2.0, 0.0, -0.0],
    ])
    return vals.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_is_byte_identical_to_jax(dtype):
    x = _quantize_inputs()
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    # the same inputs on both sides (bf16 rounding of f32 is round-to-nearest-even in both)
    np.testing.assert_array_equal(np.asarray(jx.astype(jnp.float32)), tx.float().numpy())
    got = quantize(tx).numpy()
    np.testing.assert_array_equal(got, np.asarray(_jax_quantize(jx)))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(_jax_quantize)(jx)))
    assert got.dtype == np.uint8
    # the cast truncates: somewhere a rounding cast would give another byte
    rounded = np.round((np.clip(x, -1, 1) + 1) * 127.5).astype(np.uint8)
    assert (got != rounded).any()


def _gan(geometric_info=None):
    cfg = ExperimentConfig.from_dict({**TINY, "geometric_info": geometric_info or TINY["geometric_info"]})
    cfg.validate()
    gan = DCVGAN(cfg, device="cpu")
    return gan, gan.init_state(0)


def test_serve_replays_and_checksums_every_pixel(tmp_path):
    gan, state = _gan()
    a = serve(gan, state, 2, 2, 2, Sink("null", None, "depth", False), seed=3)
    b = serve(gan, state, 2, 2, 2, Sink("null", None, "depth", False), seed=3)
    assert a["videos"] == 8 and a["device"] == "cpu" and a["value"] > 0
    assert a["checksum"] == b["checksum"]
    out = tmp_path / "shards"
    c = serve(gan, state, 2, 2, 2, Sink("npy", out, "depth", with_geo=True), seed=3)
    assert c["checksum"] == a["checksum"]
    color = [np.load(p) for p in sorted(out.glob("color_*.npy"))]
    geo = [np.load(p) for p in sorted(out.glob("geo_*.npy"))]
    assert len(color) == 2 and color[0].shape == (2, 2, T, 64, 64, 3)
    assert geo[0].shape == (2, 2, T, 64, 64, 1) and geo[0].dtype == np.uint8
    total = sum(int(x.sum(dtype=np.int64)) for x in color + geo)
    assert total % 2**32 == a["checksum"]


@pytest.fixture
def head_on_cpu(monkeypatch):
    """ggen's decoder taken as fused on the CPU (the ops run their plain
    versions); ``.calls`` counts ``softmax_codes``' calls."""
    state = types.SimpleNamespace(calls=0)

    def decodes_fused(x, train, norm):
        return layers.decodes_fused(types.SimpleNamespace(dtype=x.dtype, is_cuda=True), train, norm)

    def counted(raw):
        state.calls += 1
        return sc.softmax_codes(raw)

    monkeypatch.setattr(ggen_mod, "decodes_fused", decodes_fused)
    monkeypatch.setattr(ggen_mod, "softmax_codes", counted)
    return state


@pytest.mark.parametrize("geometry", [{"name": "segmentation", "channel": 25}, {"name": "depth", "channel": 1}],
                         ids=["segmentation", "depth"])
def test_chunk_takes_the_geometry_codes_of_the_softmax_head(head_on_cpu, geometry):
    """A chunk's geometry codes are quantize of each round's geometry, and
    its checksum counts them and the colour codes, whether they come from
    the fused softmax head (segmentation: one call a round) or from
    quantize (a tanh head: no call, no launch)."""
    gan, state = _gan(geometry)
    before = sc.softmax_codes.launches
    total, xg_u8, xc_u8 = make_chunk_fn(gan, 2, 3)(state, prng.base_key(4))
    assert head_on_cpu.calls == (3 if geometry["name"] == "segmentation" else 0)
    assert sc.softmax_codes.launches == before
    assert xg_u8.shape == (3, 2, T, 64, 64, geometry["channel"]) and xg_u8.dtype == torch.uint8
    assert int(total) == int(xg_u8.sum(dtype=torch.int64)) + int(xc_u8.sum(dtype=torch.int64))
    for i in range(3):
        xg, xc = gan.sample_videos(state, prng.for_step(prng.base_key(4), i), 2)
        assert torch.equal(xg_u8[i], quantize(xg)) and torch.equal(xc_u8[i], quantize(xc))


def test_serve_records_each_chunks_spans(tracing):
    """serve() over 3 chunks at queue depth 2: each chunk (and the warm-up
    chunk) is enqueued, its copy issued, and waited for once, in the loop's
    order."""
    gan, state = _gan()
    serve(gan, state, 2, 2, 3, Sink("null", None, "depth", False), seed=3)
    recs = [r for r in tracing.records() if r.name.startswith("serve.")]
    launch = ["serve.chunk.enqueue", "serve.chunk.copy_issue"]
    wait = ["serve.chunk.wait"]
    assert [r.name for r in recs] == launch + wait + launch + launch + wait + launch + wait + wait
    assert all(r.start_ns <= r.end_ns and r.parent is None and r.id is None for r in recs)
    # the colour generator's own spans lie inside the enqueues: its fused
    # down path once a round (2 rounds x 4 chunks), the CPU running its plain version
    inner = [r for r in tracing.records() if not r.name.startswith("serve.")]
    assert [r.name for r in inner] == ["cgen.down"] * 8
    assert {r.parent for r in inner} == {"serve.chunk.enqueue"}


def test_generation_server_replays_an_explicit_seed():
    gan, state = _gan()
    server = GenerationServer(gan, state, batchsize=2, iters_per_chunk=1, geo_name="depth")
    assert server.video_shape == (T, 64, 64, 3)
    geo, color = server.generate(3, seed=7, with_geo=True)
    geo2, color2 = server.generate(3, seed=7, with_geo=True)
    assert color.shape == (3, T, 64, 64, 3) and geo.shape == (3, T, 64, 64, 1)
    np.testing.assert_array_equal(color, color2)
    np.testing.assert_array_equal(geo, geo2)
    none, color3 = server.generate(3, seed=7)
    assert none is None
    np.testing.assert_array_equal(color3, color)
    assert server.info()["device"] == "cpu"


def test_cli_writes_npy_shards(tmp_path, capsys):
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(yaml.safe_dump(TINY))
    out = tmp_path / "out"
    stats = port_serve.main([
        "--config", str(cfg), "-b", "2", "--iters-per-chunk", "1", "--chunks", "2",
        "--sink", "npy", "--out", str(out), "--device", "cpu",
    ])
    assert stats["videos"] == 4
    assert len(list(out.glob("color_*.npy"))) == 2
    assert '"metric": "serve_videos_per_sec_per_chip"' in capsys.readouterr().out


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ExperimentConfig.from_dict(TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DCVGAN(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        DCVGAN(cfg, device="cuda")
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.main(["--config", str(path), "--chunks", "1"])
