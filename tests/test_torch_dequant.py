"""The port's uint8 dequantisation against the JAX package's, bit for bit.

On the CPU ``dcvgan_torch.ops.dequant.dequantize_video`` runs its plain
version; it is held against ``dcvgan_tpu.ops.dequant.dequantize_video`` both
through the Pallas kernel in interpret mode and through the XLA branch, on
the same numpy bytes. The CUDA kernel itself is held against the plain
version on the card (``gpu`` marker here, and ``chip_smoke.py``).

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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvgan_torch.ops import dequant as port
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
