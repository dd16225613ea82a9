"""ggen's segmentation head and its serving codes (``dcvgan_torch.ops.softmax_codes``):
``softmax(raw, 1)``, ``quantize`` of it and the codes' int64 sum in one op.

On the CPU ``softmax_codes`` runs its plain version, the module chain. These
cases hold it to ``torch.softmax`` -> ``serve.quantize`` -> the int64 sum
byte for byte, hold the kernel's code arithmetic (bfloat16x2 add and mul,
the bit pattern less 0x4280) to ``quantize`` at every bfloat16 value in [0,
1], and check what the wrapper refuses. The CUDA kernel itself is held to
``torch.softmax`` and ``quantize`` on the card (``gpu`` marker, and
``chip_smoke.py --softmax-codes``). The file imports no JAX, so on the
card's machine it runs with ``--noconftest``.
"""

import pytest
import torch

from dcvgan_torch.cli.serve import quantize
from dcvgan_torch.ops import softmax_codes as sc

CL = torch.channels_last


def _raw(n, c, h, w, seed, dtype=torch.bfloat16, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=g, device=device) * 3
    return x.to(dtype).contiguous(memory_format=CL)


# (N, C, H, W): the serving classes at a small N, 2 and 33 classes, W != H,
# pixel counts that are not a whole number of 256-pixel tiles
SHAPES = [(2, 25, 64, 64), (3, 2, 5, 7), (1, 33, 9, 4), (2, 25, 1, 6), (5, 25, 32, 32), (1, 7, 3, 3)]
IDS = [f"n{s[0]}-c{s[1]}-{s[2]}x{s[3]}" for s in SHAPES]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_cpu_op_is_the_module_chain_byte_for_byte(shape, dtype):
    raw = _raw(*shape, seed=sum(shape), dtype=dtype)
    before = sc.softmax_codes.launches
    got = sc.softmax_codes(raw)
    assert sc.softmax_codes.launches == before
    probs = torch.softmax(raw, 1)
    codes = quantize(probs)
    assert got.probs.dtype == dtype and got.codes.dtype == torch.uint8 and got.total.dtype == torch.int64
    assert got.probs.is_contiguous(memory_format=CL) and got.codes.is_contiguous(memory_format=CL)
    assert got.probs.shape == got.codes.shape == shape and got.total.shape == ()
    assert torch.equal(got.probs, probs) and torch.equal(got.codes, codes)
    assert int(got.total) == int(codes.sum(dtype=torch.int64))


def _kernel_codes(p):
    """The kernel's codes of bfloat16 probabilities: ``(p + 1) * 127.5`` with
    each operation rounded to bfloat16, then the bit pattern less 0x4280,
    whose low byte is the code."""
    q = ((p + 1.0) * 127.5).to(torch.bfloat16)
    bits = q.view(torch.int16).to(torch.int32) & 0xFFFF
    return ((bits - 0x4280) & 0xFF).to(torch.uint8)


def test_kernel_code_arithmetic_is_quantize_at_every_probability():
    bits = torch.arange(0, 0x3F81, dtype=torch.int32).to(torch.int16)  # +0 up to 1.0
    p = bits.view(torch.bfloat16)
    assert p.float().min() == 0.0 and p.float().max() == 1.0 and p.numel() == 0x3F81
    p = torch.cat([p, torch.tensor([-0.0], dtype=torch.bfloat16)])
    want = quantize(p)
    assert torch.equal(_kernel_codes(p), want)
    assert want.min() == 127 and want.max() == 255


def test_smem_and_what_the_kernel_does_not_take():
    assert sc.smem_bytes(25) == 2 * sc.TILE * 25 * 2
    with pytest.raises(ValueError, match="shared memory"):
        sc.smem_bytes(300)
    raw = _raw(1, 5, 4, 4, seed=0)
    with pytest.raises(ValueError, match="channels_last"):
        sc.softmax_codes(raw.contiguous())
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        sc.softmax_codes(raw[0])
    with pytest.raises(ValueError, match="empty"):
        sc.softmax_codes(raw[:0])
    with pytest.raises(TypeError, match="floating"):
        sc.softmax_codes(torch.zeros(1, 5, 4, 4, dtype=torch.int32).contiguous(memory_format=CL))


# ---- the CUDA kernel against torch.softmax and quantize (on the card)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ulp_bf16(v):
    """One bfloat16 ulp at |v| (8 significant bits)."""
    a = v.abs().clamp(min=2.0**-126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


# the serving shape, then one frame, 2 and 33 classes (the kernel's
# runtime-class route), W = 32, pixel counts off the 256-pixel tile with
# ragged ends off the 8-element store
GPU_SHAPES = [(4096, 25, 64, 64), (1, 25, 64, 64), (3, 2, 64, 64), (2, 33, 64, 64), (5, 25, 32, 32),
              (7, 25, 5, 3), (3, 33, 9, 7), (2, 25, 64, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES, ids=[f"n{s[0]}-c{s[1]}-{s[2]}x{s[3]}" for s in GPU_SHAPES])
def test_kernel_on_gpu(cuda, shape):
    raw = _raw(*shape, seed=shape[1] + shape[2], device=cuda)
    before = sc.softmax_codes.launches
    got = sc.softmax_codes(raw)
    again = sc.softmax_codes(raw)
    want = torch.softmax(raw, 1)
    torch.cuda.synchronize()
    assert sc.softmax_codes.launches == before + 2
    assert got.probs.is_contiguous(memory_format=CL) and got.codes.is_contiguous(memory_format=CL)
    assert torch.equal(got.probs, again.probs) and torch.equal(got.codes, again.codes)
    assert int(got.total) == int(again.total)
    d = (got.probs.float() - want.float()).abs()
    ulp = _ulp_bf16(torch.maximum(got.probs.float().abs(), want.float().abs()))
    exact = (d == 0).float().mean().item()
    print(f"softmax_codes {shape}: {exact:.6%} of probabilities equal torch.softmax's")
    assert (d <= ulp).all(), d.max().item()
    assert torch.equal(got.codes, quantize(got.probs))
    assert int(got.total) == int(got.codes.sum(dtype=torch.int64))


@pytest.mark.gpu
def test_kernel_refuses_on_gpu(cuda):
    raw = _raw(2, 25, 8, 8, seed=1, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        sc.softmax_codes(raw.contiguous())
    with pytest.raises(TypeError, match="bfloat16"):
        sc.softmax_codes(raw.float())
    n, c, h, w = raw.shape
    buf = torch.empty(raw.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:]
    shifted = buf.view(n, h, w, c).permute(0, 3, 1, 2)  # channels-last, 2 bytes off 16
    assert shifted.is_contiguous(memory_format=CL)
    with pytest.raises(ValueError, match="16-byte"):
        sc.softmax_codes(shifted)
