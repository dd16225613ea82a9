"""The port's dataset, loader and preprocessors against ``dcvgan_tpu.data``:
the same seed gives the same bytes."""

import numpy as np
import pytest

from dcvgan_torch.data import host_ops
from dcvgan_torch.data.dataset import VideoDataset as PortDataset
from dcvgan_torch.data.loader import VideoLoader as PortLoader
from dcvgan_torch.data.mock import generate_mock_dataset as port_mock
from dcvgan_torch.data.preprocess import get_preprocessor as port_preprocessor
from dcvgan_torch.io.image import read_img as port_read_img
from dcvgan_torch.utils import video_np as port_video_np
from dcvgan_tpu import native
from dcvgan_tpu.data.dataset import VideoDataset as JaxDataset
from dcvgan_tpu.data.loader import VideoLoader as JaxLoader
from dcvgan_tpu.data.preprocess import get_preprocessor as jax_preprocessor
from dcvgan_tpu.io.image import read_img as jax_read_img
from dcvgan_tpu.utils import video_np as jax_video_np
from torch_port_util import jax_native_built  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_native_built")

S = 32  # frame size of the synthetic trees here


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """``{name: (port root, jax root)}``: each package preprocesses its own."""
    base = tmp_path_factory.mktemp("data")
    out = {}
    for name, size, length in (("mock", 64, 16), ("synthetic", S, 16)):
        roots = []
        for tag, get in (("port", port_preprocessor), ("jax", jax_preprocessor)):
            root = base / tag
            get(name)(base / "raw", root / name / "train", "train", length, size, -1)
            roots.append(root)
        out[name] = tuple(roots)
    return out


def _pair(trees, name, **kw):
    size, ext = (64, "png") if name == "mock" else (S, "jpg")
    args = dict(name=name, preprocess_func=None, video_length=16, image_size=size, extension=ext)
    args.update(kw)
    port_root, jax_root = trees[name]
    return (PortDataset(processed_root=port_root, **args), JaxDataset(processed_root=jax_root, **args))


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_preprocessors_write_the_same_files(trees):
    for name, (port_root, jax_root) in trees.items():
        port_files = sorted(p.relative_to(port_root) for p in port_root.rglob("*") if p.is_file())
        jax_files = sorted(p.relative_to(jax_root) for p in jax_root.rglob("*") if p.is_file())
        assert port_files == jax_files and len(port_files) > 100
        for rel in port_files[:: max(1, len(port_files) // 40)]:
            assert (port_root / rel).read_bytes() == (jax_root / rel).read_bytes(), rel
    frame = next((trees["synthetic"][0] / "synthetic" / "train" / "1" / "color").glob("*.jpg"))
    np.testing.assert_array_equal(port_read_img(frame), jax_read_img(frame))
    np.testing.assert_array_equal(port_read_img(frame, True), jax_read_img(frame, True))


def test_registry_offers_the_ported_preprocessors_only():
    """Every dataset name of the JAX package's registry (since the SURREAL
    and IsoGD preprocessors and the MUG stub were ported), and no other."""
    from dcvgan_torch.data import preprocess as port_registry
    from dcvgan_tpu.data import preprocess as jax_registry

    for name in ("mock", "synthetic", "synthetic-large", "surreal", "isogd", "mug"):
        assert callable(port_preprocessor(name)) and callable(jax_preprocessor(name))
    assert set(port_registry._REGISTRY) == set(jax_registry._REGISTRY)
    with pytest.raises(KeyError, match="no preprocessor"):
        port_preprocessor("kinetics")


@pytest.mark.parametrize("raw_uint8", [True, False], ids=["uint8", "float"])
@pytest.mark.parametrize("name,geo", [
    ("mock", "depth"), ("mock", "optical-flow"), ("mock", "segmentation"),
    ("synthetic", "depth"), ("synthetic", "segmentation"),
])
def test_samples_and_batches_equal_the_jax_packages(trees, name, geo, raw_uint8):
    port, ref = _pair(trees, name, geometric_info=geo, raw_uint8=raw_uint8)
    assert len(port) == len(ref)
    _same(port[1], ref[1])
    _same(port.sample(0, np.random.default_rng(3)), ref.sample(0, np.random.default_rng(3)))
    sample = port[0]
    assert sample["color"].dtype == (np.uint8 if raw_uint8 else np.float32)
    b = 2 if name == "mock" else 8
    with PortLoader(port, b, n_workers=2, seed=5) as pl, JaxLoader(ref, b, n_workers=2, seed=5) as jl:
        assert len(pl) == len(jl) >= 1
        port_batches, jax_batches = list(pl.epoch_iterator(1)), list(jl.epoch_iterator(1))
        assert len(port_batches) == len(jl)
        for x, y in zip(port_batches, jax_batches):
            _same(x, y)
        _same(pl.fetch_batch(epoch=2**31 + 4, limit=3), jl.fetch_batch(epoch=2**31 + 4, limit=3))


def test_mid_epoch_start_batch_continues_the_same_epoch(trees):
    port, ref = _pair(trees, "synthetic", geometric_info="depth", raw_uint8=True, cache_decoded=True)
    with PortLoader(port, 8, n_workers=2, seed=1) as pl, JaxLoader(ref, 8, n_workers=2, seed=1) as jl:
        full = list(pl.epoch_iterator(3))
        rest = list(pl.epoch_iterator(3, start_batch=5))
        assert len(full) == 8 and len(rest) == 3
        for x, y in zip(full[5:], rest):
            _same(x, y)
        for x, y in zip(rest, jl.epoch_iterator(3, start_batch=5)):
            _same(x, y)
        # another epoch is another order
        assert not np.array_equal(full[0]["color"], next(iter(pl.epoch_iterator(4)))["color"])


def test_cache_decoded_serves_the_same_windows(trees):
    cached, _ = _pair(trees, "synthetic", raw_uint8=True, cache_decoded=True)
    plain, _ = _pair(trees, "synthetic", raw_uint8=True)
    for i in (0, 5, 0):
        _same(cached.sample(i, np.random.default_rng(i)), plain.sample(i, np.random.default_rng(i)))


def test_mock_generator_is_the_pixel_oracle(tmp_path):
    root = port_mock(tmp_path / "mock" / "train")
    ds = PortDataset("mock", preprocess_func=None, extension="png", processed_root=tmp_path)
    assert root.exists() and len(ds) == 3
    color = ds.sample(0, np.random.default_rng(0))["color"]
    assert set(np.unique(color)) == {-1.0, 1.0}  # pure R/G/B frames
    with pytest.raises(FileNotFoundError):
        PortDataset("absent", preprocess_func=None, processed_root=tmp_path)


def test_host_helpers_equal_the_native_library():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (3, 5, 7), dtype=np.uint8)
    np.testing.assert_array_equal(host_ops.normalize_u8(x, 127.5, -1.0), native.normalize_u8(x, 127.5, -1.0))
    labels = rng.integers(0, 40, (4, 6), dtype=np.uint8)  # some outside the range
    np.testing.assert_array_equal(host_ops.one_hot(labels, 25), native.one_hot(labels, 25))
    f = rng.normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_array_equal(host_ops.scale_f32(f, 1 / 64), native.scale_f32(f, 1 / 64))


def test_video_helpers_equal_the_jax_packages():
    rng = np.random.default_rng(1)
    v = rng.integers(0, 256, (6, 4, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(port_video_np.make_video_grid(v, 2, 3), jax_video_np.make_video_grid(v, 2, 3))
    np.testing.assert_array_equal(port_video_np.ensure_float_video(v), jax_video_np.ensure_float_video(v))
    f = rng.uniform(-1.2, 1.2, (2, 4, 8, 8, 1)).astype(np.float32)
    assert port_video_np.ensure_float_video(f) is not None
    np.testing.assert_array_equal(port_video_np.videos_to_uint8(f), jax_video_np.videos_to_uint8(f))
