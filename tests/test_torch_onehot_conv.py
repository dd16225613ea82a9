"""The colour generator's one-hot input conv (``dcvgan_torch.ops.onehot_conv``):
``leaky_relu(conv2d(2 * one_hot(argmax_c p) - 1, w, padding=1), 0.01)`` in one op.

On the CPU ``onehot_conv3x3`` runs its plain version, the unfused chain.
These cases hold it, and an emulation of the kernel's arithmetic (its
argmax rule and the gather of the f32 table's rows over the in-image taps),
against ``F.conv2d`` in float64 on the materialised one-hot; check the
planner; and hold the colour generator's eval forward on the op against its
modules. The CUDA kernel itself is held against the plain version on the
card (``gpu`` marker, and ``chip_smoke.py --onehot-conv``). The file imports
no JAX, so on the card's machine it runs with ``--noconftest``.
"""

import types

import pytest
import torch
import torch.nn.functional as F

from dcvgan_torch.models import cgen as cgen_mod
from dcvgan_torch.models.cgen import ColorVideoGenerator
from dcvgan_torch.models.layers import cast_for_compute, onehot_fused
from dcvgan_torch.ops import onehot_conv as oh

CL = torch.channels_last
SLOPE = 0.01


def _scores(n, c, h, w, seed, ties=False):
    """Channels-last class scores; with ``ties``, a few levels only, so that
    most pixels have two or more classes at their maximum."""
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(n, c, h, w, generator=g)
    if ties:
        p = torch.floor(p * 3) / 3
    return p.contiguous(memory_format=CL)


def _weight(cout, c, seed):
    g = torch.Generator().manual_seed(seed + 1000)
    return torch.randn(cout, c, 3, 3, generator=g) * 0.05


def _materialised(p, w, slope=SLOPE):
    """The chain in float64 on the +-1 one-hot of ``torch.argmax``."""
    x = F.one_hot(p.argmax(1), p.shape[1]).double().permute(0, 3, 1, 2) * 2.0 - 1.0
    return F.leaky_relu(F.conv2d(x, w.double(), padding=1), slope)


def _kernel_labels(p):
    """The kernel's argmax: the first class at the maximum, a NaN over any number."""
    best, arg = p[:, 0].float(), torch.zeros(p.shape[0], *p.shape[2:], dtype=torch.long)
    for k in range(1, p.shape[1]):
        v = p[:, k].float()
        take = (v > best) | (torch.isnan(v) & ~torch.isnan(best))
        best, arg = torch.where(take, v, best), torch.where(take, torch.full_like(arg, k), arg)
    return arg


def _emulated(p, w, slope=SLOPE):
    """The kernel's arithmetic: per pixel, the f32 table rows of its in-image
    taps summed in tap order, LeakyReLU, one rounding to ``p``'s dtype."""
    n, c, h, wd = p.shape
    t = oh.table(w)  # (9, C, Cout) f32
    lab = F.pad(_kernel_labels(p), (1, 1, 1, 1), value=-1)  # -1: the zero padding
    acc = torch.zeros(n, h, wd, w.shape[0], dtype=torch.float32)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        sl = lab[:, ky:ky + h, kx:kx + wd]
        rows = t[tap][sl.clamp(min=0)]  # (n, h, w, Cout)
        acc = acc + torch.where((sl >= 0)[..., None], rows, torch.zeros_like(rows))
    out = torch.where(acc > 0, acc, acc * slope)
    return out.to(p.dtype).permute(0, 3, 1, 2)


def _ulp_bf16(v):
    """One bfloat16 ulp at |v| (8 significant bits)."""
    a = v.abs().clamp(min=2.0**-126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _within_one_ulp(got, want_f64, atol):
    """|got - want| within one bf16 ulp of the larger magnitude, plus
    ``atol`` where cancellation leaves values near 0 (the f32 sums of C x 9
    weights round at ~1e-7 of their terms)."""
    got, want = got.double(), want_f64.double()
    tol = _ulp_bf16(torch.maximum(got.abs(), want.abs())) + atol
    return ((got - want).abs() <= tol).all(), (got - want).abs().max().item()


# (N, C, H, W, Cout): the serving widths at a small N, class counts 2, 5
# and 25, Cout 8 and 64, W != H, images of one row or column, a tile that
# is not a whole number of rows of the image
SHAPES = [(2, 25, 64, 64, 64), (3, 2, 5, 7, 8), (2, 5, 9, 4, 64), (1, 25, 1, 6, 8), (2, 5, 7, 1, 64),
          (2, 2, 13, 40, 64), (1, 25, 3, 3, 8)]
IDS = [f"n{s[0]}-c{s[1]}-{s[2]}x{s[3]}-o{s[4]}" for s in SHAPES]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_version_is_the_conv_of_the_one_hot(shape, ties):
    n, c, h, w_, cout = shape
    p = _scores(n, c, h, w_, seed=c + h, ties=ties)
    w = _weight(cout, c, seed=c)
    got = oh.reference_onehot_conv3x3(p, w)
    assert got.shape == (n, cout, h, w_) and got.is_contiguous(memory_format=CL)
    torch.testing.assert_close(got.double(), _materialised(p, w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_emulated_kernel_is_the_conv_of_the_one_hot(shape, ties):
    n, c, h, w_, cout = shape
    p = _scores(n, c, h, w_, seed=c * h, ties=ties).to(torch.bfloat16)
    w = _weight(cout, c, seed=h).to(torch.bfloat16)
    ok, worst = _within_one_ulp(_emulated(p, w), _materialised(p.float(), w.float()), atol=1e-5)
    assert ok, worst


def test_kernel_argmax_takes_the_first_maximum_as_torch_does():
    p = _scores(4, 25, 8, 8, seed=3, ties=True)
    assert (p.amax(1, keepdim=True) == p).sum(1).gt(1).float().mean() > 0.5  # most pixels tie
    assert torch.equal(_kernel_labels(p), p.argmax(1))
    p[0, 7, 2, 3] = float("nan")  # a NaN wins, as in torch.argmax
    p[0, 9, 2, 3] = float("nan")
    assert torch.equal(_kernel_labels(p), p.argmax(1)) and p.argmax(1)[0, 2, 3] == 7


def test_table_is_twice_the_weight_less_its_sum_over_classes():
    w = _weight(8, 5, seed=1)
    t = oh.table(w)
    assert t.shape == (9, 5, 8) and t.dtype == torch.float32
    for kh in range(3):
        for kw in range(3):
            torch.testing.assert_close(t[kh * 3 + kw], (2 * w[:, :, kh, kw] - w[:, :, kh, kw].sum(1, keepdim=True)).T)


def test_gather_table_is_built_once_per_weight_version():
    w = torch.nn.Parameter(_weight(8, 5, seed=2))
    first = oh.gather_table(w)
    assert oh.gather_table(w) is first
    with torch.no_grad():
        w.mul_(2.0)  # an in-place update moves the version: built anew
    second = oh.gather_table(w)
    assert second is not first
    torch.testing.assert_close(second, 2.0 * first)
    with torch.inference_mode():
        t = w.detach() * 1.0  # an inference tensor has no version: built at each call
        assert oh.gather_table(t) is not oh.gather_table(t)


def test_plan_at_the_serving_shape_and_what_it_refuses():
    p = oh.plan(4096, 64, 64, 25, 64)
    assert p.rows == 8 and p.vec
    # the table once, and each group's staged scores (8 + 2 rows) and labels with halo
    assert p.smem == 9 * 25 * 64 * 4 + oh.GROUPS * (10 * 64 * 25 * 2 + 1328) <= oh.SMEM_LIMIT
    assert not oh.plan(4096, 64, 64, 25, 64, aligned=False).vec
    assert not oh.plan(3, 5, 7, 2, 8).vec  # W * C = 14: no whole 16-byte pieces
    assert oh.plan(2, 9, 4, 5, 64).rows == 9  # a small image is one tile
    big = oh.plan(2, 64, 64, 40, 64)  # a table of 92 KB leaves room for each group's 4 + 2 rows
    assert big.rows == 4 and big.smem <= oh.SMEM_LIMIT
    with pytest.raises(ValueError, match="multiple of 8"):
        oh.plan(2, 8, 8, 25, 12)
    with pytest.raises(ValueError, match="shared memory"):
        oh.plan(2, 64, 64, 80, 64)


def test_cpu_op_is_the_plain_version_and_counts_no_launch():
    p = _scores(2, 25, 16, 16, seed=4).to(torch.bfloat16)
    w = _weight(64, 25, seed=4).to(torch.bfloat16)
    before = oh.onehot_conv3x3.launches
    got = oh.onehot_conv3x3(p, w)
    assert oh.onehot_conv3x3.launches == before
    assert torch.equal(got, oh.reference_onehot_conv3x3(p, w))


def test_rejects_what_the_kernel_does_not_take():
    p = _scores(1, 5, 4, 4, seed=0)
    w = _weight(8, 5, seed=0)
    with pytest.raises(ValueError, match="w must be"):
        oh.onehot_conv3x3(p, w[:, :4])
    with pytest.raises(ValueError, match="w must be"):
        oh.onehot_conv3x3(p, torch.zeros(8, 5, 4, 4))
    with pytest.raises(TypeError, match="dtype"):
        oh.onehot_conv3x3(p, w.double())
    with pytest.raises(ValueError, match="channels_last"):
        oh.onehot_conv3x3(p.contiguous(), w)


def test_onehot_fused_takes_eval_bf16_on_cuda_only():
    assert not onehot_fused(torch.zeros(1, 5, 2, 2, dtype=torch.bfloat16), False)  # the CPU
    on_cuda = types.SimpleNamespace(dtype=torch.bfloat16, is_cuda=True)
    assert onehot_fused(on_cuda, False)
    assert not onehot_fused(on_cuda, True)
    assert not onehot_fused(types.SimpleNamespace(dtype=torch.float32, is_cuda=True), False)


# ---- the colour generator's eval forward on the op (the CPU runs its plain version)


@pytest.fixture
def onehot_on_cpu(monkeypatch):
    """The colour generator's choice with a CPU tensor taken as on CUDA
    while ``.on``; ``.calls`` the op's calls."""
    state = types.SimpleNamespace(on=True, calls=[])

    def on_cpu(x, train):
        return onehot_fused(types.SimpleNamespace(dtype=x.dtype, is_cuda=state.on), train)

    def counted(p, w, slope=SLOPE):
        state.calls.append((tuple(p.shape), tuple(w.shape), slope))
        return oh.onehot_conv3x3(p, w, slope)

    monkeypatch.setattr(cgen_mod, "onehot_fused", on_cpu)
    monkeypatch.setattr(cgen_mod, "onehot_conv3x3", counted)
    return state


def _cgen(in_ch, geometric_info, seed, dtype=torch.bfloat16, norm="batch"):
    cgen = ColorVideoGenerator(in_ch=in_ch, dim_z=4, geometric_info=geometric_info, ngf=8, norm=norm)
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
    x = torch.softmax(torch.randn(n, in_ch, 64, 64, generator=g) * 3, 1)
    return x, torch.randn(n, 4, generator=g)


@pytest.mark.parametrize("classes", [5, 25])
@pytest.mark.parametrize("seed", [0, 1])
def test_cgen_eval_forward_on_the_op_matches_its_modules(onehot_on_cpu, classes, seed):
    cgen = _cgen(classes, "segmentation", seed)
    x, z = _inputs(classes, seed)
    got = cgen(x, z)
    assert onehot_on_cpu.calls == [((3, classes, 64, 64), (8, classes, 3, 3), 0.01)]
    onehot_on_cpu.on = False
    want = cgen(x, z)
    assert len(onehot_on_cpu.calls) == 1 and got.shape == want.shape == (3, 3, 64, 64)
    # the same chain of ops both times; the CPU's convolutions need not
    # agree to the bit from one call to the next
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("case", ["depth", "optical-flow", "train", "float32", "cpu"])
def test_the_op_is_not_called_off_its_path(onehot_on_cpu, case):
    geometric_info, in_ch = {"depth": ("depth", 1), "optical-flow": ("optical-flow", 2)}.get(
        case, ("segmentation", 25))
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    onehot_on_cpu.on = case != "cpu"
    cgen = _cgen(in_ch, geometric_info, 3, dtype)
    x, z = _inputs(in_ch, 3, n=2)
    if case == "train":
        masks = cgen.dropout_masks(2, torch.Generator().manual_seed(5), x.device)
        out = cgen(x, z, train=True, update_stats=False, dropout_masks=masks)
    else:
        out = cgen(x, z)
    assert onehot_on_cpu.calls == [] and out.shape == (2, 3, 64, 64)


def test_the_op_runs_inside_its_span(onehot_on_cpu):
    from dcvgan_torch.utils import trace

    cgen = _cgen(5, "segmentation", 4)
    x, z = _inputs(5, 4, n=2)
    trace.enable()
    try:
        at = trace.mark()
        cgen(x, z)
        names = [r.name for r in trace.records(at)]
    finally:
        trace.disable()
    # the one-hot input's span, then the fused down path's (the CPU runs its plain version)
    assert names == ["cgen.onehot_conv", "cgen.down"] and len(onehot_on_cpu.calls) == 1


# ---- the CUDA kernel against its plain version (on the card)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


GPU_SHAPES = [(4096, 25, 64, 64, 64)] + SHAPES + [(5, 25, 64, 64, 64), (3, 7, 33, 17, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES, ids=[f"n{s[0]}-c{s[1]}-{s[2]}x{s[3]}-o{s[4]}" for s in GPU_SHAPES])
def test_kernel_matches_plain_on_gpu(cuda, shape):
    n, c, h, w_, cout = shape
    g = torch.Generator(device=cuda).manual_seed(c + h)
    p = torch.softmax(torch.randn(n, c, h, w_, generator=g, device=cuda) * 3, 1)
    p = p.to(torch.bfloat16).contiguous(memory_format=CL)
    w = (torch.randn(cout, c, 3, 3, generator=g, device=cuda) * 0.05).to(torch.bfloat16)
    before = oh.onehot_conv3x3.launches
    got = oh.onehot_conv3x3(p, w)
    again = oh.onehot_conv3x3(p, w)
    torch.backends.cudnn.allow_tf32 = False
    # the plain version in f32 on the same bf16 scores and weights: one
    # rounding to bf16, as the kernel rounds once
    want = oh.reference_onehot_conv3x3(p.float().contiguous(memory_format=CL), w.float())
    torch.cuda.synchronize()
    assert oh.onehot_conv3x3.launches == before + 2
    assert got.is_contiguous(memory_format=CL) and got.shape == (n, cout, h, w_)
    assert torch.equal(got, again)
    ok, worst = _within_one_ulp(got, want, atol=1e-5)
    assert ok, worst
