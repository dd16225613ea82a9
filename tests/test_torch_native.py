"""The port's host library (``dcvgan_torch.native``) against its numpy forms
(``dcvgan_torch.data.host_ops``) and the JAX package's library: equal bit for
bit, on odd sizes, out-of-range labels, an empty array, and 1 and 8 threads
(set through ``native._threads``, which alone picks a call's count).
A source that does not compile makes the build raise with the compiler's
message; nothing falls back to numpy.
"""

import numpy as np
import pytest

from dcvgan_torch import native
from dcvgan_torch.data import host_ops
from dcvgan_tpu import native as jax_native
from torch_port_util import jax_native_built  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_native_built")

SHAPES = [(16, 64, 64), (3, 5, 7), (1,), (0, 4)]


@pytest.fixture
def threads(monkeypatch, request):
    """Every call of the library takes ``request.param`` threads; None keeps
    the count by size."""
    if request.param is not None:
        monkeypatch.setattr(native, "_threads", lambda size: request.param)
    return request.param


def _same(got, *wants):
    for want in wants:
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got, want, equal_nan=True)
        assert got.tobytes() == want.tobytes()  # -0.0 and NaN bits too


def test_the_library_builds_into_the_port_build_dir():
    assert native.available()
    path = native.build()
    assert path == native.target() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libdcvgan_host-") and path.exists()
    assert native.SOURCE.read_bytes() != b"" and native.SOURCE.parent.name == "native"


@pytest.mark.parametrize("threads", [1, 8, None], indirect=True)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_normalize_u8_equals_numpy(shape, threads):
    x = np.random.default_rng(0).integers(0, 256, shape + (3,), dtype=np.uint8)
    for divisor, shift in ((127.5, -1.0), (255.0, 0.0), (0.5, 1.0), (3.0, -0.25)):
        got = native.normalize_u8(x, divisor, shift)
        _same(got, host_ops.normalize_u8(x, divisor, shift), jax_native.normalize_u8(x, divisor, shift))


@pytest.mark.parametrize("threads", [1, 8, None], indirect=True)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_one_hot_equals_numpy_with_out_of_range_labels(shape, threads):
    labels = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    labels.reshape(-1)[::3] %= 25  # most in range, the rest >= 25 become zero rows
    for n_classes in (25, 1, 300):
        got = native.one_hot(labels, n_classes)
        _same(got, host_ops.one_hot(labels, n_classes), jax_native.one_hot(labels, n_classes))
    if labels.size:
        rows = native.one_hot(labels, 25).reshape(-1, 25).sum(-1)
        assert np.array_equal(rows, (labels.reshape(-1) < 25).astype(np.float32))


@pytest.mark.parametrize("threads", [1, 8, None], indirect=True)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_scale_f32_equals_numpy(shape, threads):
    x = np.random.default_rng(2).normal(scale=30.0, size=shape + (2,)).astype(np.float32)
    if x.size:
        x.reshape(-1)[:4] = [np.inf, -0.0, np.nan, 1e-42][: x.size]
    for scale in (1 / 64, 1 / 3, -2.0):
        got = native.scale_f32(x, scale)
        _same(got, host_ops.scale_f32(x, scale), jax_native.scale_f32(x, scale))


def test_inputs_are_taken_as_contiguous_arrays_of_the_stated_dtype():
    x = np.random.default_rng(3).integers(0, 256, (8, 6, 3), dtype=np.uint8)
    view = x[:, ::2, ::-1]  # not contiguous
    _same(native.normalize_u8(view, 127.5, -1.0), host_ops.normalize_u8(view, 127.5, -1.0))
    f = x.astype(np.float64)[::2]
    _same(native.scale_f32(f, 0.5), host_ops.scale_f32(f, 0.5))
    _same(native.one_hot(x[..., 0].astype(np.int64) % 25, 25), host_ops.one_hot(x[..., 0] % 25, 25))
    with pytest.raises(ValueError):
        native.one_hot(x[..., 0], 0)


def test_a_source_that_does_not_compile_raises_with_the_compiler_message(tmp_path):
    broken = tmp_path / "host_pipeline.cc"
    broken.write_text(native.SOURCE.read_text().replace("int64_t chunk", "int64_t chunk = ;", 1))
    with pytest.raises(RuntimeError, match=r"(?s)failed: g\+\+ exit 1.*error"):
        native.build(broken, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))  # nothing half-written left
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_an_edited_source_builds_anew_and_an_unchanged_one_is_reused(tmp_path):
    src = tmp_path / "host_pipeline.cc"
    src.write_text(native.SOURCE.read_text())
    first = native.build(src, tmp_path)
    mtime = first.stat().st_mtime_ns
    assert native.build(src, tmp_path) == first and first.stat().st_mtime_ns == mtime
    src.write_text(native.SOURCE.read_text() + "\n// edited\n")
    second = native.build(src, tmp_path)
    assert second != first and second.exists()
    lib = native.load(second)
    x = np.arange(7, dtype=np.float32)
    out = np.empty_like(x)
    lib.scale_f32(x.ctypes.data, out.ctypes.data, x.size, 2.0, 2)
    assert np.array_equal(out, 2 * x)


def test_a_call_takes_threads_by_its_size_unless_told():
    per = native.MIN_ELEMENTS_PER_THREAD
    assert native._threads(0) == native._threads(per - 1) == 1
    assert native._threads(2 * per) == min(2, native.DEFAULT_THREADS)
    assert native._threads(1 << 40) == native.DEFAULT_THREADS
