"""The colour generator's dense input conv (``dcvgan_torch.ops.inconv``):
``leaky_relu(conv2d(x, w, padding=1), 0.01)`` in one op, for a depth (Cin 1)
or optical-flow (Cin 2) input.

On the CPU ``inconv3x3`` runs its plain version, the conv and LeakyReLU as
two ops. These cases hold it against the colour generator's own inconv
modules, and an emulation of the kernel's arithmetic (f32 products summed in
tap order, LeakyReLU in f32, one rounding) against ``F.conv2d`` in float64;
check the planner and what the op refuses; and hold the colour generator's
eval forward on the op against its modules. The CUDA kernel itself is held
against the plain version on the card (``gpu`` marker, and ``chip_smoke.py
--inconv``). The file imports no JAX, so on the card's machine it runs with
``--noconftest``.
"""

import re
import types
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from dcvgan_torch.models import cgen as cgen_mod
from dcvgan_torch.models.cgen import ColorVideoGenerator
from dcvgan_torch.models.layers import cast_for_compute, inconv_fused
from dcvgan_torch.ops import inconv as ic

CL = torch.channels_last
SLOPE = 0.01


def _frames(n, cin, h, w, seed):
    """Channels-last geometry-like frames in [-1, 1]."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, cin, h, w, generator=g) * 2 - 1).contiguous(memory_format=CL)


def _weight(cout, cin, seed):
    g = torch.Generator().manual_seed(seed + 1000)
    return torch.randn(cout, cin, 3, 3, generator=g) * 0.3


def _modules(cin, cout, w):
    """The colour generator's inconv as its modules build it: Conv2d (no bias) + LeakyReLU(0.01)."""
    m = cgen_mod._Block(cgen_mod.Conv2d(cin, cout, 3, 1, 1, bias=False), torch.nn.LeakyReLU(0.01))
    with torch.no_grad():
        m.main[0].weight.copy_(w)
    return m.main


def _emulated(x, w, slope=SLOPE):
    """The kernel's arithmetic: per output channel, the f32 products of the
    9 taps (row-major) and Cin channels summed in that order from 0 (a bf16
    times a bf16 is exact in f32, so each step is the kernel's FMA), the
    zero padding adding nothing, LeakyReLU in f32, one rounding to ``x``'s
    dtype."""
    n, cin, h, wd = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros(n, w.shape[0], h, wd, dtype=torch.float32)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        for ci in range(cin):
            acc = acc + wf[:, ci, ky, kx][None, :, None, None] * xp[:, ci:ci + 1, ky:ky + h, kx:kx + wd]
    out = torch.where(acc > 0, acc, acc * slope)
    return out.to(x.dtype)


def _f64(x, w, slope=SLOPE):
    return F.leaky_relu(F.conv2d(x.double(), w.double(), padding=1), slope)


def _ulp_bf16(v):
    """One bfloat16 ulp at |v| (8 significant bits)."""
    a = v.abs().clamp(min=2.0**-126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _within_one_ulp(got, want_f64, atol):
    """|got - want| within one bf16 ulp of the larger magnitude, plus
    ``atol`` where cancellation leaves values near 0."""
    got, want = got.double(), want_f64.double()
    tol = _ulp_bf16(torch.maximum(got.abs(), want.abs())) + atol
    return ((got - want).abs() <= tol).all(), (got - want).abs().max().item()


# (N, Cin, H, W, Cout): the serving widths at a small N for depth and flow,
# W not a multiple of 8, an image of one row, one frame, Cout 8 and 136, and
# Cin 3 and 4 (four channels a thread)
SHAPES = [(2, 1, 64, 64, 64), (2, 2, 64, 64, 64), (3, 1, 9, 7, 64), (2, 2, 1, 16, 64), (1, 1, 8, 8, 8),
          (2, 2, 5, 12, 136), (2, 2, 7, 7, 8), (2, 3, 6, 10, 16), (1, 4, 7, 5, 24)]
IDS = [f"n{s[0]}-c{s[1]}-{s[2]}x{s[3]}-o{s[4]}" for s in SHAPES]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_version_is_the_inconv_modules(shape):
    n, cin, h, w_, cout = shape
    x = _frames(n, cin, h, w_, seed=cin + h)
    w = _weight(cout, cin, seed=w_)
    got = ic.reference_inconv3x3(x, w)
    assert got.shape == (n, cout, h, w_) and got.is_contiguous(memory_format=CL)
    with torch.no_grad():
        want = _modules(cin, cout, w)(x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got.double(), _f64(x, w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_emulated_kernel_is_within_one_ulp_of_the_f32_conv(shape):
    n, cin, h, w_, cout = shape
    x = _frames(n, cin, h, w_, seed=cin * h).to(torch.bfloat16)
    w = _weight(cout, cin, seed=h).to(torch.bfloat16)
    got = _emulated(x, w)
    ok, worst = _within_one_ulp(got, _f64(x.float(), w.float()), atol=1e-5)
    assert ok, worst
    # the f32 sums round once: the same bytes as the plain version in f32, rounded once
    want = ic.reference_inconv3x3(x.float().contiguous(memory_format=CL), w.float()).to(torch.bfloat16)
    assert ((got.float() - want.float()).abs() <= _ulp_bf16(want.float())).all()


def test_plan_at_the_serving_shapes_and_its_edges():
    depth = ic.plan(4096, 64, 64, 1, 64)
    # 8 rows + 2 halo rows of 64 inputs between 8 zeros a side, two buffers
    assert depth == ic.Plan(rows=8, vec=True, threads=256, smem=2 * 10 * (64 + 16) * 2)
    assert ic.plan(4096, 64, 64, 2, 64) == ic.Plan(rows=8, vec=True, threads=256, smem=2 * 10 * (128 + 16) * 2)
    assert not ic.plan(4096, 64, 64, 1, 64, aligned=False).vec
    assert not ic.plan(3, 9, 7, 1, 64).vec  # W * Cin = 7: no whole 16-byte pieces
    assert ic.plan(2, 5, 12, 2, 136).threads == 17 * 15  # 17 channel groups x 15 pixels a pass
    assert ic.plan(1, 8, 8, 1, 8).threads == 256  # one group, 256 pixels a pass
    assert ic.plan(2, 6, 10, 3, 16).threads == 256 and ic.channels_a_thread(3) == 4
    assert ic.plan(2, 9, 4, 1, 64).rows == 9  # a small image is one tile
    assert ic.plan(2, 3, 600, 1, 64).rows == 1  # a wide one a row a tile
    assert ic.plan(1, 3, 640, 4, 1024).threads == 256


@pytest.mark.parametrize("cin,cout,match", [(1, 12, "multiple of 8"), (2, 4, "multiple of 8"), (0, 64, "Cin"),
                                            (5, 64, "Cin"), (1, 2056, "at most"), (3, 1032, "at most")])
def test_plan_refuses_what_the_kernel_does_not_take(cin, cout, match):
    with pytest.raises(ValueError, match=match):
        ic.plan(2, 8, 8, cin, cout)


def test_plan_refuses_a_row_over_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        ic.plan(1, 2, 20000, 4, 64)


def test_rejects_what_the_op_does_not_take():
    x = _frames(1, 2, 4, 4, seed=0)
    w = _weight(8, 2, seed=0)
    with pytest.raises(ValueError, match="w must be"):
        ic.inconv3x3(x, w[:, :1])
    with pytest.raises(ValueError, match="w must be"):
        ic.inconv3x3(x, torch.zeros(8, 2, 5, 5))
    with pytest.raises(ValueError, match="x must be"):
        ic.inconv3x3(x[0], w)
    with pytest.raises(TypeError, match="dtype"):
        ic.inconv3x3(x, w.double())
    with pytest.raises(ValueError, match="must be on"):
        ic.inconv3x3(x, torch.zeros(8, 2, 3, 3, device="meta"))
    with pytest.raises(ValueError, match="channels_last"):
        ic.inconv3x3(x.contiguous(), w)


def test_cpu_op_is_the_plain_version_and_counts_no_launch():
    x = _frames(2, 1, 16, 16, seed=4).to(torch.bfloat16)
    w = _weight(64, 1, seed=4).to(torch.bfloat16)
    before = ic.inconv3x3.launches
    got = ic.inconv3x3(x, w)
    assert ic.inconv3x3.launches == before
    assert torch.equal(got, ic.reference_inconv3x3(x, w))


def test_instance_names_the_cuda_sources_specialised_instances():
    # the source's dispatch, read from its text: each branch's shape test and the instance it launches
    src = (Path(ic.__file__).resolve().parents[1] / "csrc" / "inconv.cu").read_text()
    branches = re.findall(r"if \(cout == (\d+) && wd == (\d+) && cin == (\d+)\)\s*"
                          r"return launch<(\d+), (\d+), (\d+)>", src)
    for cout, w, cin, *launched in branches:
        assert [cin, cout, w] == launched
    assert sorted((int(cin), int(cout), int(w)) for cout, w, cin, *_ in branches) == sorted(ic.SPECIALISED)
    assert ic.instance(1, 64, 64) == "1x64x64" and ic.instance(2, 64, 64) == "2x64x64"
    # any other shape takes its Cin's generic instance
    assert ic.instance(1, 64, 32) == ic.instance(3, 64, 64) == ic.instance(2, 96, 64) == "generic"


def test_cpu_op_counts_no_instance():
    x = _frames(2, 1, 16, 16, seed=5).to(torch.bfloat16)
    before = dict(ic.inconv3x3.instances)
    ic.inconv3x3(x, _weight(96, 1, seed=5).to(torch.bfloat16))
    assert dict(ic.inconv3x3.instances) == before


def test_inconv_fused_takes_eval_bf16_on_cuda_and_not_segmentation():
    assert not inconv_fused(torch.zeros(1, 1, 2, 2, dtype=torch.bfloat16), False, "depth")  # the CPU
    on_cuda = types.SimpleNamespace(dtype=torch.bfloat16, is_cuda=True)
    assert inconv_fused(on_cuda, False, "depth")
    assert inconv_fused(on_cuda, False, "optical-flow")
    assert not inconv_fused(on_cuda, False, "segmentation")
    assert not inconv_fused(on_cuda, True, "depth")
    assert not inconv_fused(types.SimpleNamespace(dtype=torch.float32, is_cuda=True), False, "depth")


# ---- the colour generator's eval forward on the op (the CPU runs its plain version)


@pytest.fixture
def inconv_on_cpu(monkeypatch):
    """The colour generator's choice with a CPU tensor taken as on CUDA
    while ``.on``; ``.calls`` the op's calls."""
    state = types.SimpleNamespace(on=True, calls=[])

    def on_cpu(x, train, geometric_info):
        return inconv_fused(types.SimpleNamespace(dtype=x.dtype, is_cuda=state.on), train, geometric_info)

    def counted(x, w, slope=SLOPE):
        state.calls.append((tuple(x.shape), tuple(w.shape), slope))
        return ic.inconv3x3(x, w, slope)

    monkeypatch.setattr(cgen_mod, "inconv_fused", on_cpu)
    monkeypatch.setattr(cgen_mod, "inconv3x3", counted)
    return state


def _cgen(in_ch, geometric_info, seed, dtype=torch.bfloat16):
    cgen = ColorVideoGenerator(in_ch=in_ch, dim_z=4, geometric_info=geometric_info, ngf=8)
    g = torch.Generator().manual_seed(seed)
    cgen.reset_parameters(g)
    with torch.no_grad():
        for m in cgen.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.3)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
    return cast_for_compute(cgen, torch.device("cpu"), dtype).eval()


def _inputs(in_ch, seed, n=3):
    g = torch.Generator().manual_seed(seed + 50)
    return torch.rand(n, in_ch, 64, 64, generator=g) * 2 - 1, torch.randn(n, 4, generator=g)


@pytest.mark.parametrize("geometry", [("depth", 1), ("optical-flow", 2)], ids=["depth", "flow"])
@pytest.mark.parametrize("seed", [0, 1])
def test_cgen_eval_forward_on_the_op_matches_its_modules(inconv_on_cpu, geometry, seed):
    name, in_ch = geometry
    cgen = _cgen(in_ch, name, seed)
    x, z = _inputs(in_ch, seed)
    got = cgen(x, z)
    assert inconv_on_cpu.calls == [((3, in_ch, 64, 64), (8, in_ch, 3, 3), 0.01)]
    inconv_on_cpu.on = False
    want = cgen(x, z)
    assert len(inconv_on_cpu.calls) == 1 and got.shape == want.shape == (3, 3, 64, 64)
    # the same two ops both times; the CPU's convolutions need not agree to
    # the bit from one call to the next
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("case", ["segmentation", "train", "float32", "cpu"])
def test_the_op_is_not_called_off_its_path(inconv_on_cpu, case):
    geometric_info, in_ch = ("segmentation", 25) if case == "segmentation" else ("depth", 1)
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    inconv_on_cpu.on = case != "cpu"
    cgen = _cgen(in_ch, geometric_info, 3, dtype)
    x, z = _inputs(in_ch, 3, n=2)
    if case == "train":
        masks = cgen.dropout_masks(2, torch.Generator().manual_seed(5), x.device)
        out = cgen(x, z, train=True, update_stats=False, dropout_masks=masks)
    else:
        out = cgen(x, z)
    assert inconv_on_cpu.calls == [] and out.shape == (2, 3, 64, 64)


def test_the_op_runs_inside_its_span(inconv_on_cpu):
    from dcvgan_torch.utils import trace

    cgen = _cgen(1, "depth", 4)
    x, z = _inputs(1, 4, n=2)
    trace.enable()
    try:
        at = trace.mark()
        cgen(x, z)
        names = [r.name for r in trace.records(at)]
    finally:
        trace.disable()
    # the inconv's span, then the fused down path's (the CPU runs its plain version)
    assert names == ["cgen.inconv", "cgen.down"] and len(inconv_on_cpu.calls) == 1


# ---- the CUDA kernel against its plain version (on the card)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the serving shapes of depth and flow, the CPU cases' shapes, a 600-wide
# image (a row a tile), W * Cin = 8 at Cin 2, and an input that is not
# 16-byte aligned (staged an element at a time); surreal-depth3's serving
# shape (cgen ngf 96: 1 -> 96)
GPU_SHAPES = [(4096, 1, 64, 64, 64), (4096, 2, 64, 64, 64)] + SHAPES + [(2, 1, 3, 600, 64), (3, 2, 6, 4, 32),
                                                                         (4096, 1, 64, 64, 96)]


def _gpu_inputs(n, cin, h, w_, cout, device, offset=0):
    g = torch.Generator(device=device).manual_seed(cin + h)
    base = torch.empty(n * cin * h * w_ + offset, dtype=torch.bfloat16, device=device)
    x = base[offset:].view(n, h, w_, cin).permute(0, 3, 1, 2)
    x.copy_(torch.rand(n, cin, h, w_, generator=g, device=device) * 2 - 1)
    w = (torch.randn(cout, cin, 3, 3, generator=g, device=device) * 0.3).to(torch.bfloat16)
    return x, w


def _held_to_plain(x, w):
    before = ic.inconv3x3.launches
    got = ic.inconv3x3(x, w)
    again = ic.inconv3x3(x, w)
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    assert ic.inconv3x3.launches == before + 2
    n, _, h, w_ = x.shape
    assert got.is_contiguous(memory_format=CL) and got.shape == (n, w.shape[0], h, w_)
    assert torch.equal(got, again)
    # the plain version in f32 on the same bf16 inputs and weights: one
    # rounding to bf16, as the kernel rounds once; 512 frames at a time,
    # so that the float64 comparison of a serving call fits the card
    for i in range(0, n, 512):
        want = ic.reference_inconv3x3(x[i:i + 512].float().contiguous(memory_format=CL), w.float())
        ok, worst = _within_one_ulp(got[i:i + 512], want, atol=1e-5)
        assert ok, (i, worst)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES, ids=[f"n{s[0]}-c{s[1]}-{s[2]}x{s[3]}-o{s[4]}" for s in GPU_SHAPES])
def test_kernel_matches_plain_on_gpu(cuda, shape):
    _held_to_plain(*_gpu_inputs(*shape, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("cin", [1, 2])
def test_kernel_takes_an_unaligned_input_on_gpu(cuda, cin):
    x, w = _gpu_inputs(4, cin, 64, 64, 64, cuda, offset=1)
    assert x.data_ptr() % 16 and x.is_contiguous(memory_format=CL)
    _held_to_plain(x, w)


@pytest.mark.gpu
def test_kernel_takes_the_weights_in_any_layout_on_gpu(cuda):
    x, w = _gpu_inputs(8, 2, 16, 16, 64, cuda)
    got = ic.inconv3x3(x, w.to(memory_format=CL))
    assert torch.equal(got, ic.inconv3x3(x, w))


@pytest.mark.gpu
def test_refused_shape_raises_before_any_launch_on_gpu(cuda):
    x, w = _gpu_inputs(2, 1, 8, 8, 12, cuda)
    before = ic.inconv3x3.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        ic.inconv3x3(x, w)
    with pytest.raises(TypeError, match="bfloat16"):
        ic.inconv3x3(x.float(), w.float())
    assert ic.inconv3x3.launches == before
