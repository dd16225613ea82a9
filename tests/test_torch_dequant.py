"""The port's uint8 dequantisation against the JAX package's, bit for bit.

On the CPU ``dcvgan_torch.ops.dequant.dequantize_video`` runs its plain
version; it is held against ``dcvgan_tpu.ops.dequant.dequantize_video`` both
through the Pallas kernel in interpret mode and through the XLA branch, on
the same numpy bytes. ``dequantize_videos`` (several tensors in one launch)
is held against the plain version per tensor, its argument list against a
stand-in for the kernel library, and the train step's ingest of a uint8
batch against the same batch as floats. The CUDA kernel itself is held
against the plain version on the card (``gpu`` marker here, and
``chip_smoke.py``).

The function is ``float32(x) / 127.5 - 1`` with an IEEE division. The XLA
branch, run op by op, computes exactly that, and the port equals it bit for
bit in both dtypes. The Pallas kernel in interpret mode runs under
``jax.jit`` on the CPU, where XLA turns the division by a constant into a
multiply by its reciprocal and fuses it with the subtraction into one FMA
(``fma(x, float32(1/127.5), -1)`` reproduces its output exactly): that is
the CPU compiler's rewrite, up to one float32 ulp from the division
(1.2e-7 at |value| <= 1). So the float32 comparison with that route allows
one ulp; in bfloat16 the rounding absorbs it and the comparison is exact.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvgan_torch.config import ExperimentConfig
from dcvgan_torch.ops import dequant as port
from dcvgan_torch.train.step import DCVGAN
from dcvgan_tpu.ops.dequant import dequantize_video as jax_dequantize

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bytes(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


ONE_F32_ULP = 2.0**-23  # of values in [-1, 1]


def _same_bits(got: torch.Tensor, want) -> None:
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def _same_as_interpreted_kernel(got: torch.Tensor, want) -> None:
    """Exact in bfloat16; within one float32 ulp in float32 (module docstring)."""
    if got.dtype == torch.bfloat16:
        return _same_bits(got, want)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ONE_F32_ULP)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("interpret", [True, None], ids=["pallas-interpret", "xla"])
def test_all_256_values_equal_jax_bit_for_bit(dtype, interpret):
    jdt, tdt = DTYPES[dtype]
    x = np.arange(256, dtype=np.uint8)
    got = port.dequantize_video(torch.from_numpy(x), tdt)
    assert got.dtype == tdt
    want = jax_dequantize(jnp.asarray(x), jdt, interpret=interpret)
    (_same_as_interpreted_kernel if interpret else _same_bits)(got, want)
    assert got[0].item() == -1.0 and got[255].item() == 1.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "shape", [(2, 4, 16, 16, 3), (3, 7, 11, 5), (1,), (1001,), (17, 1, 3)],
    ids=["video", "ragged", "one", "odd", "odd3d"],
)
def test_shapes_equal_jax_bit_for_bit(dtype, shape):
    jdt, tdt = DTYPES[dtype]
    x = _bytes(shape, seed=len(shape))
    got = port.dequantize_video(torch.from_numpy(x), tdt)
    _same_as_interpreted_kernel(got, jax_dequantize(jnp.asarray(x), jdt, interpret=True))
    _same_bits(got, jax_dequantize(jnp.asarray(x), jdt))


def test_plain_version_is_a_division_not_a_reciprocal():
    # float32(x) / 127.5 and float32(x) * (1 / 127.5) round differently for
    # some bytes; the function is the division
    x = np.arange(256, dtype=np.uint8)
    got = port.reference_dequantize(torch.from_numpy(x), torch.float32).numpy()
    np.testing.assert_array_equal(got, x.astype(np.float32) / np.float32(127.5) - np.float32(1.0))
    recip = x.astype(np.float32) * np.float32(1.0 / 127.5) - np.float32(1.0)
    assert (got != recip).any()


def test_rejects_a_float_input_and_an_unknown_dtype():
    with pytest.raises(TypeError, match="uint8"):
        port.dequantize_video(torch.zeros(2, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        port.dequantize_video(torch.zeros(2, dtype=torch.uint8), torch.float16)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    before = port.dequantize_video.launches
    out = port.dequantize_video(torch.from_numpy(_bytes((4, 5))), torch.float32)
    assert port.dequantize_video.launches == before
    assert out.shape == (4, 5)
    assert port.dequantize_video(torch.zeros(0, dtype=torch.uint8)).shape == (0,)


# segment lists: odd counts, empty segments, 1 to 4 tensors
SEGMENTS = {
    "one": [(20, 3, 5, 5, 3)],
    "colour+depth": [(2, 16, 8, 8, 3), (2, 16, 8, 8, 1)],
    "odd, empty, odd": [(1001,), (0,), (17, 3)],
    "four": [(7,), (0,), (3, 5, 11), (256,)],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(SEGMENTS))
def test_several_tensors_equal_the_plain_version_per_tensor(case, dtype):
    xs = [torch.from_numpy(_bytes(shape, seed=i)) for i, shape in enumerate(SEGMENTS[case])]
    got = port.dequantize_videos(xs, dtype)
    assert len(got) == len(xs)
    for x, g in zip(xs, got):
        assert g.shape == x.shape and g.dtype == dtype
        assert torch.equal(g, port.reference_dequantize(x, dtype))
        assert torch.equal(g, port.dequantize_video(x, dtype))


def test_several_tensors_reject_a_bad_list():
    u8 = torch.zeros(3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="1 to 4"):
        port.dequantize_videos([])
    with pytest.raises(ValueError, match="1 to 4"):
        port.dequantize_videos([u8] * 5)
    with pytest.raises(TypeError, match="uint8"):
        port.dequantize_videos([u8, torch.zeros(3)])


class _StandIn:
    """The C entry of ``csrc/dequant.cu`` in Python, over host memory: reads
    each (input, output, count) triple of the argument array and writes the
    plain version's bytes where the kernel would."""

    def __init__(self):
        self.calls = []

    def __call__(self, dtype_code, count, args, device, stream):
        triples = [tuple(args[3 * k: 3 * k + 3]) for k in range(count)]
        self.calls.append((dtype_code, triples, device, stream))
        dtype = {0: torch.float32, 1: torch.bfloat16}[dtype_code]
        for x_ptr, out_ptr, n in triples:
            x = torch.tensor(list(ctypes.string_at(x_ptr, n)), dtype=torch.uint8)
            y = port.reference_dequantize(x, dtype).contiguous()
            ctypes.memmove(out_ptr, y.data_ptr(), y.numel() * y.element_size())
        return 0


def test_one_launch_for_several_tensors_with_a_stand_in_library(monkeypatch):
    stand_in = _StandIn()
    monkeypatch.setattr(port, "_kernel", lambda: stand_in)
    monkeypatch.setattr(port, "_raw_stream", lambda device: 1234)
    xs = [torch.from_numpy(_bytes(s, seed=3)) for s in [(2, 16, 8, 8, 3), (0,), (2, 16, 8, 8, 1)]]
    outs = [torch.empty(x.shape, dtype=torch.bfloat16) for x in xs]
    before = port.dequantize_video.launches
    port._launch(xs, outs, torch.bfloat16)
    assert port.dequantize_video.launches == before + 1  # one launch, three tensors
    (code, triples, _, stream), = stand_in.calls
    assert code == 1 and stream == 1234
    assert triples == [(x.data_ptr(), o.data_ptr(), x.numel()) for x, o in zip(xs, outs)]
    for x, o in zip(xs, outs):
        assert torch.equal(o, port.reference_dequantize(x, torch.bfloat16))
    monkeypatch.setattr(port, "_kernel", lambda: lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        port._launch(xs[:1], outs[:1], torch.float32)
    assert port.dequantize_video.launches == before + 1


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_ingest_of_a_uint8_batch_equals_the_same_batch_as_floats(precision):
    cfg = ExperimentConfig.from_dict({
        "geometric_info": {"name": "depth", "channel": 1}, "trainer": {"precision": precision}})
    gan = DCVGAN(cfg, device="cpu")
    batch = {"color": _bytes((2, 16, 8, 8, 3), seed=5), "depth": _bytes((2, 16, 8, 8, 1), seed=6)}
    as_float = {k: v.astype(np.float32) / np.float32(127.5) - np.float32(1.0) for k, v in batch.items()}
    xg, xc = gan.ingest(batch)
    fg, fc = gan.ingest(as_float)
    assert xg.dtype == xc.dtype == gan.dtype
    assert torch.equal(xg, fg) and torch.equal(xc, fc)
    assert xg.shape == (2, 16, 8, 8, 1) and xc.shape == (2, 16, 8, 8, 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(20, 16, 64, 64, 3), (256,), (1,), (3, 1001), (0,)])
def test_kernel_matches_plain_on_gpu(cuda, dtype, shape):
    x = torch.from_numpy(_bytes(shape) if shape != (256,) else np.arange(256, dtype=np.uint8)).to(cuda)
    before = port.dequantize_video.launches
    got = port.dequantize_video(x, dtype)
    assert port.dequantize_video.launches == before + (1 if x.numel() else 0)
    assert torch.equal(got, port.reference_dequantize(x, dtype))
    assert torch.equal(got.cpu(), port.reference_dequantize(x.cpu(), dtype))


@pytest.mark.gpu
def test_kernel_reads_an_unaligned_view_on_gpu(cuda):
    x = torch.from_numpy(_bytes((4099,))).to(cuda)
    for off in (1, 3, 8):
        v = x[off:]
        assert torch.equal(port.dequantize_video(v, torch.bfloat16),
                           port.reference_dequantize(v, torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        port.dequantize_video(x[::2])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(SEGMENTS))
def test_several_tensors_in_one_launch_on_gpu(cuda, dtype, case):
    xs = [torch.from_numpy(_bytes(shape, seed=i)).to(cuda) for i, shape in enumerate(SEGMENTS[case])]
    # an unaligned view beside aligned tensors: each segment decides for itself
    if len(xs) < 4:
        xs.append(torch.from_numpy(_bytes((4099,))).to(cuda)[3:])
    before = port.dequantize_video.launches
    got = port.dequantize_videos(xs, dtype)
    assert port.dequantize_video.launches == before + 1
    for x, g in zip(xs, got):
        assert torch.equal(g, port.reference_dequantize(x, dtype))
    empty = port.dequantize_videos([torch.zeros(0, dtype=torch.uint8, device=cuda)] * 2, dtype)
    assert port.dequantize_video.launches == before + 1 and [e.numel() for e in empty] == [0, 0]
