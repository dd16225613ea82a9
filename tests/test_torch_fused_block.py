"""The port's fused BN-affine + LeakyReLU + conv4x4s2 against the JAX package.

On the CPU ``dcvgan_torch.ops.fused_block.fused_norm_act_conv`` runs its
plain version; it is held against the Pallas kernel in interpret mode and
against ``reference_norm_act_conv``, on the same numpy inputs. The CUDA
kernel itself is held against the plain version on the card (``gpu``
marker here, and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvgan_torch.ops import fused_block as port
from dcvgan_tpu.ops.fused_block import (
    fused_norm_act_conv as jax_fused,
    pack_weights,
    reference_norm_act_conv as jax_reference,
)
from torch_port_util import ATOL_F32, hwio_to_torch, nchw, nhwc, within

# bf16: both sides sum the same bf16 products in f32, in another order, and
# round the sum to bf16: at most one bf16 ulp apart (2^-7 relative), plus a
# small absolute term for sums near zero.
BF16_ATOL, BF16_RTOL = 1e-3, 2.0**-7


def _case(b, h, w, c, cout, seed=0, shift_offset=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    w4 = (rng.normal(size=(4, 4, c, cout)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = (rng.normal(size=c) * 0.2 + shift_offset).astype(np.float32)
    return x, scale, shift, w4


def _port(x, scale, shift, w4, slope=0.2, dtype=torch.float32, xn_out=None):
    out = port.fused_norm_act_conv(
        nchw(x).to(dtype),
        torch.from_numpy(scale),
        torch.from_numpy(shift),
        hwio_to_torch(w4).to(dtype),
        slope,
        xn_out=xn_out,
    )
    assert out.is_contiguous(memory_format=torch.channels_last)
    return nhwc(out)


@pytest.mark.parametrize(
    "b,h,w,c,cout",
    [(2, 64, 64, 8, 16), (3, 32, 32, 16, 32), (1, 16, 16, 4, 8), (4, 2, 2, 16, 8)],
)
def test_plain_matches_pallas_and_reference(b, h, w, c, cout):
    x, scale, shift, w4 = _case(b, h, w, c, cout)
    got = _port(x, scale, shift, w4)
    want_ref = jax_reference(x, scale, shift, w4)
    within(got, want_ref, ATOL_F32)
    want_pallas = jax_fused(x, scale, shift, pack_weights(w4), interpret=True)
    within(got, want_pallas, ATOL_F32)
    assert got.shape == (b, h // 2, w // 2, cout)


def test_negative_slope_and_large_shift():
    # a shift large enough that the activation branches, and padding must
    # contribute 0, not leaky_relu(shift)
    x, scale, shift, w4 = _case(2, 32, 32, 8, 8, seed=3, shift_offset=1.0)
    got = _port(x, scale, shift, w4, slope=0.01)
    within(got, jax_reference(x, scale, shift, w4, negative_slope=0.01), ATOL_F32)
    want = jax_fused(x, scale, shift, pack_weights(w4), negative_slope=0.01, interpret=True)
    within(got, want, ATOL_F32)


def test_xn_out_is_the_activation():
    x, scale, shift, w4 = _case(2, 8, 8, 16, 8, seed=4, shift_offset=0.5)
    xn = torch.empty_like(nchw(x))
    _port(x, scale, shift, w4, slope=0.2, xn_out=xn)
    act = x * scale + shift
    act = np.where(act >= 0, act, act * 0.2)
    np.testing.assert_array_equal(nhwc(xn), act)


def test_bf16_matches_jax_bf16():
    x, scale, shift, w4 = _case(2, 16, 16, 32, 16, seed=5)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # bf16-exact inputs
    wb = np.asarray(jnp.asarray(w4, jnp.bfloat16).astype(jnp.float32))
    want = jax_reference(
        jnp.asarray(xb, jnp.bfloat16), scale, shift, jnp.asarray(wb, jnp.bfloat16)
    )
    xn = torch.empty(2, 32, 16, 16, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last
    )
    got = _port(xb, scale, shift, wb, dtype=torch.bfloat16, xn_out=xn)
    within(got, np.asarray(want, np.float32), BF16_ATOL, BF16_RTOL)
    act = jnp.asarray(xb) * scale + shift
    act = jnp.where(act >= 0, act, act * 0.2).astype(jnp.bfloat16)
    np.testing.assert_array_equal(nhwc(xn), np.asarray(act, np.float32))


def test_rejects_bad_inputs():
    x, scale, shift, w4 = _case(1, 16, 16, 4, 8)
    xt, st, sh, wt = nchw(x), torch.from_numpy(scale), torch.from_numpy(shift), hwio_to_torch(w4)
    with pytest.raises(ValueError, match="even"):
        port.fused_norm_act_conv(xt[:, :, :15], st, sh, wt)
    with pytest.raises(ValueError, match="channels_last"):
        port.fused_norm_act_conv(xt.contiguous(), st, sh, wt)
    with pytest.raises(TypeError):
        port.fused_norm_act_conv(xt.to(torch.bfloat16), st, sh, wt)
    with pytest.raises(ValueError):
        port.fused_norm_act_conv(xt, st[:2], sh, wt)
    with pytest.raises(ValueError, match="xn_out"):
        port.fused_norm_act_conv(xt, st, sh, wt, xn_out=torch.empty(1))


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    x, scale, shift, w4 = _case(1, 8, 8, 8, 8)
    before = port.fused_norm_act_conv.launches
    _port(x, scale, shift, w4)
    assert port.fused_norm_act_conv.launches == before


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain version's f32 conv must run in f32, not TF32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c,cout", [(32, 64, 128), (2, 256, 256), (8, 24, 40), (4, 12, 8)])
def test_kernel_matches_plain_on_gpu(cuda, dtype, h, c, cout):
    x, scale, shift, w4 = _case(3, h, h, c, cout, seed=6, shift_offset=0.5)
    xt = nchw(x).to(cuda, dtype)
    st, sh = torch.from_numpy(scale).to(cuda), torch.from_numpy(shift).to(cuda)
    wt = hwio_to_torch(w4).to(cuda, dtype)
    xn_k, xn_p = torch.empty_like(xt), torch.empty_like(xt)
    before = port.fused_norm_act_conv.launches
    got = port.fused_norm_act_conv(xt, st, sh, wt, 0.2, xn_out=xn_k)
    want = port.reference_norm_act_conv(xt, st, sh, wt, 0.2, xn_out=xn_p)
    torch.cuda.synchronize()
    assert port.fused_norm_act_conv.launches == before + 1
    atol, rtol = (1e-4, 2.0**-7) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    within(nhwc(got.cpu()), nhwc(want.cpu()), atol, rtol)
    assert torch.equal(xn_k, xn_p)
