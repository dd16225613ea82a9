"""The fused decoder stage (``dcvgan_torch.ops.fused_up``): BatchNorm-affine +
ReLU, the U-Net skip and a transposed conv in one op.

On the CPU ``fused_norm_act_up_conv`` runs its plain version. These cases
hold it, and emulations of the kernels' arithmetic, against
``F.conv_transpose2d`` on the materialised ``cat([relu(x * scale + shift),
skip])``: for k4s2 the packed weight and the per-phase taps of
``csrc/fused_up.cu``, for k3s1 the tap-partials GEMM and 3 x 3 stencil of
``csrc/outconv.cu`` (``ops/outconv.py``); check both planners as pure
Python (the k4s2 tile tables, the outconv's row walk); and hold the
generators' eval-mode decode on the fused op against their unfused modules.
The CUDA kernels themselves are held against the plain version on the card
(``gpu`` marker, and ``chip_smoke.py``).
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dcvgan_torch.models import cgen as cgen_mod
from dcvgan_torch.models import ggen as ggen_mod
from dcvgan_torch.models.cgen import ColorVideoGenerator
from dcvgan_torch.models.ggen import GeometricVideoGenerator
from dcvgan_torch.models import layers
from dcvgan_torch.models.layers import cast_for_compute
from dcvgan_torch.ops import fused_up as up
from dcvgan_torch.ops import outconv as oc

# The serving path's ten sites at mug-depth width (ngf 64): (H of x, C_x,
# C_skip, Cout, route). ggen's four k4 s2 stages, cgen's up1-up5 and outconv.
SERVING_SITES = [
    (4, 512, 0, 256, "k4s2"),
    (8, 256, 0, 128, "k4s2"),
    (16, 128, 0, 64, "k4s2"),
    (32, 64, 0, 1, "k4s2"),
    (2, 256, 256, 256, "k4s2"),
    (4, 256, 256, 256, "k4s2"),
    (8, 256, 256, 128, "k4s2"),
    (16, 128, 128, 64, "k4s2"),
    (32, 64, 64, 64, "k4s2"),
    (64, 64, 64, 3, "k3s1"),
]
# surreal-segm's four ggen sites (ngf 96, 25 segmentation classes): K 768
# and 384 streamed, Cout 96 and 25 short of a whole tile, C_x 96 a chunk
# and a half
SEGM_SITES = [
    (4, 768, 0, 384, "k4s2"),
    (8, 384, 0, 192, "k4s2"),
    (16, 192, 0, 96, "k4s2"),
    (32, 96, 0, 25, "k4s2"),
]
# surreal-depth3's six cgen sites (cgen ngf 96): up1-2 K 768 with a skip,
# up3 Cout 192 on a skip-concatenated input, up4-5 and the outconv on
# channel runs of 192 and 96 (a chunk and a half each)
WIDE_CGEN_SITES = [
    (2, 384, 384, 384, "k4s2"),
    (4, 384, 384, 384, "k4s2"),
    (8, 384, 384, 192, "k4s2"),
    (16, 192, 192, 96, "k4s2"),
    (32, 96, 96, 96, "k4s2"),
    (64, 96, 96, 3, "k3s1"),
]
# other shapes: Cout 1, 2, 3, no skip, channel runs that are not whole
# 64-channel chunks, W != H, images smaller than a tile's rows, borders
EDGE_SITES = [
    (2, 8, 0, 1, "k4s2", 3, 2),
    (5, 8, 16, 2, "k4s2", 3, 7),
    (6, 24, 8, 3, "k4s2", 2, 5),
    (3, 16, 0, 40, "k4s2", 4, 3),
    (6, 16, 8, 3, "k3s1", 2, 5),
    (1, 8, 8, 2, "k3s1", 5, 1),
]
KERNEL = {"k4s2": (4, 2, 1), "k3s1": (3, 1, 1)}


def _taps(route):
    """Per output phase (py, px) (one for k3s1), the (dy, dx, weight tap
    kh * k + kw) it sums: output pixel (S*a + py, S*b + px) takes input
    (a + dy, b + dx) times that tap. The sub-pixel form of a k4 s2 p1
    transposed conv, and k3 s1 p1 as a conv with the flipped kernel."""
    if route == "k4s2":
        return [[(py - i, px - j, (2 * i + 1 - py) * 4 + (2 * j + 1 - px)) for i in range(2) for j in range(2)]
                for py in range(2) for px in range(2)]
    return [[(t // 3 - 1, t % 3 - 1, 8 - t) for t in range(9)]]


def _case(n, h, w, c1, c2, cout, route, seed=0, dtype=torch.float32):
    k = KERNEL[route][0]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c1, h, w, generator=g)
    skip = torch.randn(n, c2, h, w, generator=g) if c2 else None
    wt = torch.randn(c1 + c2, cout, k, k, generator=g) * 0.1
    scale = torch.rand(c1, generator=g) + 0.5
    shift = torch.randn(c1, generator=g) * 0.5
    cl = torch.channels_last
    return (x.to(dtype).contiguous(memory_format=cl), scale, shift, wt.to(dtype),
            None if skip is None else skip.to(dtype).contiguous(memory_format=cl))


def _materialised(x, scale, shift, w, skip, route):
    """``F.conv_transpose2d`` in float64 on the materialised activation."""
    _, stride, padding = KERNEL[route]
    xn = torch.relu(x.float() * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)).to(x.dtype)
    if skip is not None:
        xn = torch.cat([xn, skip], 1)
    return F.conv_transpose2d(xn.double(), w.double(), stride=stride, padding=padding)


def _tap_partials(x, scale, shift, w, skip, acc=torch.float32):
    """The outconv kernel's algorithm (``csrc/outconv.cu``): each input
    pixel's K channels ``A = cat(relu(x * scale + shift) rounded to x's
    dtype, skip)`` times the packed W27 (all nine taps x Cout at once) into
    partials ``T`` in ``acc``; then each output pixel sums the partials of
    its 3 x 3 neighbourhood, tap t reading neighbour (t // 3 - 1, t % 3 - 1)
    in tap order from 0 (a neighbour outside the image adds nothing). In
    float32 the sum is rounded once to bfloat16, as the kernel's is; in
    float64 it is returned as it is."""
    n, c1, h, wd = x.shape
    cout = w.shape[1]
    xn = torch.relu(x.float() * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)).to(x.dtype)
    g = oc.pack_weight(w, c1)  # (chunks, BN, 64)
    chunks1 = -(-c1 // oc.CHUNK)
    a = torch.zeros(n, h, wd, g.shape[0] * oc.CHUNK, dtype=acc)  # pixels x the packed K
    a[..., :c1] = xn.permute(0, 2, 3, 1).to(acc)
    if skip is not None:
        a[..., chunks1 * oc.CHUNK:chunks1 * oc.CHUNK + skip.shape[1]] = skip.permute(0, 2, 3, 1).to(acc)
    w27 = g.transpose(1, 2).reshape(-1, g.shape[1]).to(acc)  # (K, BN)
    t = F.pad(a @ w27, (0, 0, 1, 1, 1, 1))  # (n, h + 2, w + 2, BN): zero partials around the image
    out = torch.zeros(n, h, wd, cout, dtype=acc)
    for tap in range(9):
        dy, dx = tap // 3 - 1, tap % 3 - 1
        out = out + t[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + wd, tap * cout:(tap + 1) * cout]
    out = out.permute(0, 3, 1, 2)
    return out.to(torch.bfloat16) if acc == torch.float32 else out


def _emulated(x, scale, shift, w, skip, route):
    """The kernel's arithmetic in float64: for k4s2 the activation, then per
    output phase and tap a GEMM of the shifted input with the packed
    weight's rows; for k3s1 the tap partials and their stencil."""
    if route == "k3s1":
        return _tap_partials(x, scale, shift, w, skip, torch.float64)
    n, c1, h, wd = x.shape
    xn = torch.relu(x.float() * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)).to(x.dtype)
    g = up.pack_weight(w, c1).double()  # (Cout, taps, K)
    off = up.CHUNK * -(-c1 // up.CHUNK)
    k_in = torch.zeros(n, g.shape[2], h + 2, wd + 2, dtype=torch.float64)  # zero border: the padding
    k_in[:, :c1, 1:-1, 1:-1] = xn.double()
    if skip is not None:
        k_in[:, off:off + skip.shape[1], 1:-1, 1:-1] = skip.double()
    s = 2 if route == "k4s2" else 1
    out = torch.zeros(n, w.shape[1], s * h, s * wd, dtype=torch.float64)
    for phase, taps in enumerate(_taps(route)):
        py, px = divmod(phase, 2) if s == 2 else (0, 0)
        for dy, dx, wtap in taps:
            shifted = k_in[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + wd]
            out[:, :, py::s, px::s] += torch.einsum("nkhw,ok->nohw", shifted, g[:, wtap])
    return out


@pytest.mark.parametrize("site", SERVING_SITES + SEGM_SITES + WIDE_CGEN_SITES,
                         ids=[f"{s[4]}-h{s[0]}-{s[1]}+{s[2]}-{s[3]}"
                              for s in SERVING_SITES + SEGM_SITES + WIDE_CGEN_SITES])
def test_emulated_kernel_matches_the_materialised_conv_at_the_serving_sites(site):
    h, c1, c2, cout, route = site
    n = 2 if h <= 32 else 1
    x, scale, shift, w, skip = _case(n, h, h, c1, c2, cout, route, seed=h)
    want = _materialised(x, scale, shift, w, skip, route)
    got = _emulated(x, scale, shift, w, skip, route)
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("site", EDGE_SITES, ids=[f"{s[4]}-h{s[0]}w{s[6]}-{s[1]}+{s[2]}-{s[3]}" for s in EDGE_SITES])
def test_emulated_kernel_matches_the_materialised_conv_at_edge_shapes(site):
    h, c1, c2, cout, route, n, w = site
    x, scale, shift, wt, skip = _case(n, h, w, c1, c2, cout, route, seed=c1 + cout)
    torch.testing.assert_close(_emulated(x, scale, shift, wt, skip, route),
                               _materialised(x, scale, shift, wt, skip, route), rtol=1e-9, atol=1e-9)


# the outconv's shapes in bf16, as the card runs them: (N, H, W, C_x,
# C_skip, Cout). Both serving sites (64 + 64 and 96 + 96 -> 3), W != H, a
# column image, Cout 1 / 2 / 8 (tap columns 16, 32, 96), channel runs that
# end inside a chunk and inside a k step, no skip, a row wider than the
# kernel's 64-column tile
OUTCONV_CASES = [
    (2, 64, 64, 64, 64, 3), (1, 64, 64, 96, 96, 3), (3, 5, 7, 8, 16, 3), (5, 6, 1, 8, 8, 2),
    (2, 6, 5, 16, 8, 1), (2, 4, 9, 24, 40, 8), (1, 7, 70, 24, 0, 3), (2, 3, 3, 96, 8, 2),
]


@pytest.mark.parametrize("n,h,w,c1,c2,cout", OUTCONV_CASES)
def test_tap_partials_in_f32_rounded_once_match_the_materialised_conv(n, h, w, c1, c2, cout):
    """The outconv's arithmetic: f32 partials, the stencil's f32 sum in tap
    order, one rounding to bf16. Against the exact (float64) transposed conv
    of the same bf16 activation: within that one rounding (half an ulp,
    held at one: 2^-7 relative) and the f32 sums' own error (K up to 192
    products, then nine partials: held at 1e-5)."""
    x, scale, shift, w_, skip = _case(n, h, w, c1, c2, cout, "k3s1", seed=c1 + c2 + cout, dtype=torch.bfloat16)
    got = _tap_partials(x, scale, shift, w_, skip)
    want = _materialised(x, scale, shift, w_, skip, "k3s1")
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (n, cout, h, w)
    torch.testing.assert_close(got.double(), want, rtol=2.0**-7, atol=1e-5)


def test_tap_partials_keep_a_nan_in_x_in_its_neighbourhood():
    """A NaN in one channel of x poisons every partial of its pixel, so the
    3 x 3 neighbourhood of outputs around it is NaN, as in the plain conv,
    and nothing else is."""
    x, scale, shift, w_, skip = _case(2, 8, 8, 64, 64, 3, "k3s1", seed=4, dtype=torch.bfloat16)
    x[1, 5, 0, 3] = float("nan")
    got = _tap_partials(x, scale, shift, w_, skip).double()
    want = up.reference_norm_act_up_conv(x, scale, shift, w_, skip, 1, 1).double()
    nan = torch.zeros_like(got, dtype=torch.bool)
    nan[1, :, 0:2, 2:5] = True
    assert torch.equal(got.isnan(), nan) and torch.equal(want.isnan(), nan)
    torch.testing.assert_close(got[~nan], want[~nan], rtol=2.0**-7, atol=1e-3)


def test_outconv_pack_weight_is_w27_by_chunk():
    """W27's chunk cc, column t * Cout + c, channel j is w[k, c, 2 - t // 3,
    2 - t % 3] at packed input channel 64 cc + j: x's channels from chunk 0,
    the skip's from the next whole chunk, zeros elsewhere."""
    w = torch.randn(96 + 8, 3, 3, 3)
    g = oc.pack_weight(w, 96)
    assert g.shape == (3, 32, 64)
    for k, packed in ((0, 0), (95, 95), (96, 128), (103, 135)):
        cc, j = divmod(packed, 64)
        for t in range(9):
            for c in range(3):
                assert g[cc, t * 3 + c, j] == w[k, c, 2 - t // 3, 2 - t % 3]
    assert not g[1, :, 32:].any() and not g[2, :, 8:].any() and not g[:, 27:].any()


@pytest.mark.parametrize("site", SERVING_SITES, ids=[f"{s[4]}-h{s[0]}-{s[1]}+{s[2]}-{s[3]}" for s in SERVING_SITES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_op_is_the_plain_version_and_counts_no_launch(site, dtype):
    h, c1, c2, cout, route = site
    x, scale, shift, w, skip = _case(1, h, h, c1, c2, cout, route, seed=1, dtype=dtype)
    _, stride, padding = KERNEL[route]
    before = up.fused_norm_act_up_conv.launches
    got = up.fused_norm_act_up_conv(x, scale, shift, w, skip, stride, padding)
    assert up.fused_norm_act_up_conv.launches == before
    assert got.is_contiguous(memory_format=torch.channels_last) and got.dtype == dtype
    assert got.shape == (1, cout, stride * h, stride * h)
    want = up.reference_norm_act_up_conv(x, scale, shift, w, skip, stride, padding)
    torch.testing.assert_close(got, want)  # two calls of one conv: the CPU's need not agree to the bit
    # the materialised transposed conv in float64, rounded once to the dtype:
    # f32 sums in another order (K up to 2,048 products) or, in bf16, one
    # rounding step apart
    atol, rtol = (1e-4, 1e-5) if dtype == torch.float32 else (1e-3, 2.0**-7)
    torch.testing.assert_close(got.double(), _materialised(x, scale, shift, w, skip, route).to(dtype).double(),
                               atol=atol, rtol=rtol)


def test_relu_prologue_zero_pads_the_activation_not_relu_of_shift():
    # with a positive shift relu(shift) > 0; padded taps must still read 0
    x, scale, shift, w, skip = _case(2, 4, 4, 8, 8, 3, "k4s2", seed=9)
    shift = shift.abs() + 1.0
    got = up.fused_norm_act_up_conv(x, scale, shift, w, skip)
    torch.testing.assert_close(got.double(), _emulated(x, scale, shift, w, skip, "k4s2"), rtol=1e-5, atol=1e-5)


def test_rejects_what_the_kernel_does_not_take():
    x, scale, shift, w, skip = _case(1, 4, 4, 8, 8, 2, "k4s2")
    with pytest.raises(ValueError, match="k4 s2 p1 or k3 s1 p1"):
        up.fused_norm_act_up_conv(x, scale, shift, w, skip, stride=1)
    with pytest.raises(ValueError, match="w must be"):
        up.fused_norm_act_up_conv(x, scale, shift, w[:8], skip)
    with pytest.raises(ValueError, match="channels_last"):
        up.fused_norm_act_up_conv(x.contiguous(), scale, shift, w, skip)
    with pytest.raises(ValueError, match="scale"):
        up.fused_norm_act_up_conv(x, scale.double(), shift, w, skip)
    with pytest.raises(ValueError, match="skip must be"):
        up.fused_norm_act_up_conv(x, scale, shift, w, skip[:, :, :2])
    with pytest.raises(ValueError, match="multiples of 8"):
        up.plan(2, 4, 4, 12, 0, 8)
    with pytest.raises(ValueError, match="TMA box"):
        up.plan(1, 2, 300, 8, 0, 8)
    with pytest.raises(ValueError, match="aligned"):
        up.plan(2, 4, 4, 8, 0, 8, aligned=False)


# ---- the planner (ops/fused_up.py: plan, tile_table), as pure Python

SCHEDULE_CASES = [(3, h, h, c1, c2, co, r)
                  for h, c1, c2, co, r in SERVING_SITES + SEGM_SITES + WIDE_CGEN_SITES] + [
    (300, 2, 2, 256, 256, 256, "k4s2"),
    (5, 4, 12, 64, 0, 64, "k4s2"),
    (7, 6, 6, 8, 0, 3, "k4s2"),
    (40, 6, 10, 64, 64, 64, "k4s2"),
    (3, 5, 7, 8, 16, 2, "k3s1"),
]


def _reads(n, h, w):
    """Per input position: the lowest and highest flattened input row its
    valid k4s2 taps read, over every phase."""
    img, a, b = (t.ravel() for t in np.meshgrid(np.arange(n), np.arange(h), np.arange(w), indexing="ij"))
    lo, hi = img * h + a, img * h + a
    for taps in _taps("k4s2"):
        for dy, dx, _ in taps:
            ok = (a + dy >= 0) & (a + dy < h) & (b + dx >= 0) & (b + dx < w)
            row = img * h + a + dy
            lo = np.where(ok, np.minimum(lo, row), lo)
            hi = np.where(ok, np.maximum(hi, row), hi)
    return lo, hi


def _stencil_walk(h, g0, g1, lo, hi):
    """The outconv's stencil loop as ``csrc/outconv.cu`` runs it, over one
    CTA's walk: per step i (walk row lo + i, its partials now written) the
    output rows it emits, each with the partial rows it reads, and the walk
    row whose partials it then frees (i - 2)."""
    steps = []
    for i in range(hi - lo + 1):
        v, emits = lo + i, []
        for o, ok in ((v - 1, v % h != 0 and v - 1 >= g0), (v, v % h == h - 1 and g0 <= v < g1)):
            if ok:
                emits.append((o, [r for r in (o - 1, o, o + 1) if r // h == o // h]))
        steps.append((v, emits, v - 2 if i >= 2 else None))
    return steps


def _check_outconv_walk(n, h, w, c1, c2, cout, sms=up.H100_SMS):
    """Every output row written once, by a CTA that computed (and had not
    yet freed) each partial row it reads; shares within one row."""
    p = oc.plan(n, h, w, c1, c2, cout, sms=sms)
    assert p.strips == (1 if w <= oc.TILE_W else -(-w // oc.STRIP)) and p.rows == n * p.strips * h
    walks = oc.cta_rows(p.rows, h, p.grid)
    assert len(walks) == p.grid == min(p.rows, sms)
    written = np.zeros(p.rows, np.int32)
    for g0, g1, lo, hi in walks:
        assert g0 - 1 <= lo <= g0 < g1 <= hi + 1 <= g1 + 1 and lo // h == g0 // h and hi // h == (g1 - 1) // h
        freed = set()
        for v, emits, free in _stencil_walk(h, g0, g1, lo, hi):
            for o, reads in emits:
                written[o] += 1
                assert all(lo <= r <= v and r not in freed for r in reads), (o, reads, v)
            freed.add(free)
    np.testing.assert_array_equal(written, 1)
    sizes = [g1 - g0 for g0, g1, _, _ in walks]
    assert max(sizes) - min(sizes) <= 1
    return p


@pytest.mark.parametrize("n,h,w,c1,c2,cout,route", SCHEDULE_CASES)
def test_tile_table_covers_every_output_once_and_stages_every_row_read(n, h, w, c1, c2, cout, route):
    if route == "k3s1":  # the outconv's kernel walks rows, not a tile table
        _check_outconv_walk(n, h, w, c1, c2, cout)
        return
    p = up.plan(n, h, w, c1, c2, cout)
    phases, groups = up.PHASES, up.PHASES // p.phases
    tile_m = up.TILE_M * p.mblocks
    t = up.tile_table(n, h, w, p.bn, cout, groups, tile_m).numpy().astype(np.int64)
    assert t.shape == (p.units, len(up.TILE_COLUMNS)) and p.units == p.m_tiles * groups * -(-cout // p.bn)
    cols = dict(zip(up.TILE_COLUMNS, t.T))
    m = n * h * w
    nt = -(-cout // p.bn)
    covered = np.zeros((m, phases, nt * p.bn), np.int32)
    lo, hi = _reads(n, h, w)
    for m0, m1, n0, p_lo, group in zip(*(cols[c] for c in up.TILE_COLUMNS)):
        assert 0 <= m0 < m1 <= min(m0 + tile_m, m) and n0 % p.bn == 0 and 0 <= group < groups
        # a one-phase unit computes its group's phase, a four-phase unit all four
        for ph in ([group] if p.phases == 1 else range(phases)):
            covered[m0:m1, ph, n0:n0 + p.bn] += 1
        # every row a position of the tile reads lies in the staged box
        assert lo[m0:m1].min() >= p_lo and hi[m0:m1].max() < p_lo + p.region_rows
    np.testing.assert_array_equal(covered, 1)
    # a tile's units are neighbours in the walk
    np.testing.assert_array_equal(cols["m0"], np.repeat(np.arange(p.m_tiles) * tile_m, groups * nt))
    assert 1 <= p.grid <= min(p.units, up.H100_SMS)


def _sites(ggen, cgen, image_size=64):
    """Every fused launch of one sampling round: (H, C_x, C_skip, Cout, route)."""
    convs = [m for m in ggen.main if isinstance(m, torch.nn.ConvTranspose2d)]
    sites, h = [], 4
    for conv in convs[1:]:
        sites.append((h, conv.in_channels, 0, conv.out_channels, "k4s2"))
        h *= 2
    h = 2
    for i in range(1, len(cgen.up_blocks)):
        c1 = cgen.up_blocks[i - 1].main[0].out_channels
        conv = cgen.up_blocks[i].main[0]
        sites.append((h, c1, conv.in_channels - c1, conv.out_channels, "k4s2"))
        h *= 2
    c1 = cgen.up_blocks[-1].main[0].out_channels
    sites.append((image_size, c1, cgen.outconv.main[0].in_channels - c1, 3, "k3s1"))
    return sites


@pytest.mark.parametrize("geometric_info,channel", [("depth", 1), ("optical-flow", 2), ("segmentation", 5),
                                                    ("segmentation", 25)])
@pytest.mark.parametrize("ngf", [8, 32, 64, 96])
def test_plan_takes_every_site_of_every_width_in_shared_memory(ngf, geometric_info, channel):
    ggen = GeometricVideoGenerator(channel=channel, geometric_info=geometric_info, ngf=ngf)
    cgen = ColorVideoGenerator(in_ch=channel, geometric_info=geometric_info, ngf=ngf)
    sites = _sites(ggen, cgen)
    assert len(sites) == 10
    for n in (16, 320, 4096):
        for h, c1, c2, cout, route in sites:
            if route == "k3s1":  # the outconv's own planner
                p = oc.plan(n, h, h, c1, c2, cout)
                assert p.smem <= oc.SMEM_LIMIT and oc.MIN_STAGES <= p.stages <= oc.MAX_STAGES
                assert p.slots in (oc.SLOTS, oc.MIN_SLOTS) and p.bn == 32
                continue
            p = up.plan(n, h, h, c1, c2, cout)
            assert p.smem <= up.SMEM_LIMIT and up.MIN_REGION_STAGES <= p.region_stages <= up.MAX_REGION_STAGES
            assert p.resident or up.MIN_W_STAGES <= p.w_stages <= up.MAX_W_STAGES
            assert p.region_rows <= 256 and p.bn in (16, 32, 64, 96, 128)


@pytest.mark.parametrize("n,h,w,c1,c2,cout,route", SCHEDULE_CASES + [
    (4096, h, h, c1, c2, co, r) for h, c1, c2, co, r in SERVING_SITES + SEGM_SITES + WIDE_CGEN_SITES])
def test_resident_plans_keep_each_cta_on_one_phase_and_cout_tile(n, h, w, c1, c2, cout, route):
    if route == "k3s1":
        # the outconv's W27 always stays resident (loaded once a CTA) and
        # each CTA walks one contiguous run of rows, one CTA an SM at most
        p = _check_outconv_walk(n, h, w, c1, c2, cout)
        assert p.grid == min(p.rows, up.H100_SMS)
        return
    p = up.plan(n, h, w, c1, c2, cout)
    if not p.resident:
        assert p.region_stages == up.MIN_REGION_STAGES and p.w_stages >= up.MIN_W_STAGES
        return
    chunks = -(-c1 // up.CHUNK) + -(-c2 // up.CHUNK)
    # a unit's whole weights: one stage a chunk and (phase, tap)
    assert p.w_stages == chunks * p.phases * len(_taps(route)[0])
    t = up.tile_table(n, h, w, p.bn, cout, up.PHASES // p.phases, up.TILE_M * p.mblocks).numpy()
    for b in range(p.grid):  # CTA b walks units b, b + grid, ...: one phase and Cout tile
        assert len({(int(r[2]), int(r[4])) for r in t[b::p.grid]}) == 1


def test_flagship_plans_keep_the_small_k_sites_weights_resident():
    plans = {(h, c1 + c2): up.plan(4096, h, h, c1, c2, co) for h, c1, c2, co, r in SERVING_SITES if r == "k4s2"}
    # K = 512 at 128 output channels a tile: 512 KB a phase, streamed
    assert not any(p.resident for (h, k), p in plans.items() if k == 512)
    assert all(p.resident for (h, k), p in plans.items() if k <= 256 and h >= 16)
    # all four phases a unit where four phases' weights fit: ggen's 16 and 32 px stages, cgen's up5
    assert [k for k, p in plans.items() if p.phases == 4] == [(16, 128), (32, 64), (32, 128)]
    # two m-blocks where one tile of at most 64 channels covers Cout: cgen's up4
    assert [k for k, p in plans.items() if p.mblocks == 2] == [(16, 256)]
    assert all(p.phases * p.mblocks * p.bn <= 128 for p in plans.values())
    # the outconv (k3s1, ops/outconv.py) keeps its weights (W27, 8 KB at K =
    # 128) resident for every CTA's whole walk, beside eight row stages
    assert oc.plan(4096, 64, 64, 64, 64, 3).stages == oc.MAX_STAGES


# mug-depth's ten plans at N = 4096, field for field: a change for another
# configuration's shapes leaves these as they are. The k4s2 sites' (phases,
# m-blocks, bn, region stages, weight stages, resident, region rows, grid,
# smem, M tiles, units); the outconv's (bn, stages, slots, strips, rows,
# grid, smem)
FLAGSHIP_PLANS = [
    (1, 1, 128, 2, 12, False, 32, 132, 230768, 512, 4096),
    (1, 1, 128, 2, 12, False, 16, 132, 230768, 2048, 8192),
    (4, 1, 32, 5, 32, True, 9, 132, 225016, 8192, 16384),
    (4, 1, 16, 6, 16, True, 6, 132, 181776, 32768, 32768),
    (1, 1, 128, 2, 12, False, 64, 132, 230768, 128, 1024),
    (1, 1, 128, 2, 12, False, 32, 132, 230768, 512, 4096),
    (1, 1, 128, 2, 12, False, 16, 132, 230768, 2048, 8192),
    (1, 2, 64, 3, 16, True, 16, 132, 230856, 4096, 16384),
    (4, 1, 32, 4, 32, True, 6, 132, 231136, 32768, 65536),
    (32, 8, 6, 1, 262144, 132, 204384),
]


@pytest.mark.parametrize("site,want", list(zip(SERVING_SITES, FLAGSHIP_PLANS)),
                         ids=[f"{s[4]}-h{s[0]}-{s[1]}+{s[2]}-{s[3]}" for s in SERVING_SITES])
def test_flagship_plans_are_pinned(site, want):
    h, c1, c2, cout, route = site
    if route == "k3s1":
        p = oc.plan(4096, h, h, c1, c2, cout)
        assert (p.bn, p.stages, p.slots, p.strips, p.rows, p.grid, p.smem) == want
        return
    p = up.plan(4096, h, h, c1, c2, cout)
    assert (p.phases, p.mblocks, p.bn, p.region_stages, p.w_stages, p.resident, p.region_rows, p.grid, p.smem,
            p.m_tiles, p.units) == want


# surreal-segm's four ggen plans at N = 4096, field for field (its cgen, at
# ngf 64, is mug-depth's)
SEGM_PLANS = [
    (1, 1, 128, 2, 12, False, 32, 132, 230768, 512, 6144),
    (1, 1, 96, 2, 12, False, 16, 132, 181616, 2048, 16384),
    (1, 1, 96, 4, 12, True, 9, 132, 222624, 8192, 32768),
    (4, 1, 32, 4, 32, True, 6, 132, 231136, 32768, 32768),
]


@pytest.mark.parametrize("site,want", list(zip(SEGM_SITES, SEGM_PLANS)),
                         ids=[f"{s[4]}-h{s[0]}-{s[1]}+{s[2]}-{s[3]}" for s in SEGM_SITES])
def test_surreal_segm_plans_are_pinned(site, want):
    h, c1, c2, cout, route = site
    p = up.plan(4096, h, h, c1, c2, cout)
    assert route == "k4s2"
    assert (p.phases, p.mblocks, p.bn, p.region_stages, p.w_stages, p.resident, p.region_rows, p.grid, p.smem,
            p.m_tiles, p.units) == want


def test_ngf96_plans_take_whole_96_channel_tiles():
    plans = [up.plan(4096, h, h, c1, c2, co) for h, c1, c2, co, r in SEGM_SITES]
    # K 768 at Cout 384: three whole 128-channel tiles, streamed, as at K = 512
    assert (plans[0].phases, plans[0].bn, plans[0].resident) == (1, 128, False)
    # Cout 192 and 96: 96-channel tiles, K 192's weights resident
    assert [(p.phases, p.mblocks, p.bn, p.resident) for p in plans[1:3]] == [(1, 1, 96, False), (1, 1, 96, True)]
    # the segmentation head, 25 classes: all four phases a unit, resident
    assert (plans[3].phases, plans[3].bn, plans[3].resident) == (4, 32, True)
    # a small grid splits a 96-channel tile into 32-channel ones
    assert up.plan(2, 2, 2, 192, 0, 96).bn in (16, 32)


def test_wide_cgen_plans_take_two_96_channel_m_blocks():
    plans = [up.plan(4096, h, h, c1, c2, co) if r == "k4s2" else oc.plan(4096, h, h, c1, c2, co)
             for h, c1, c2, co, r in WIDE_CGEN_SITES]
    # up1-5: a skip at a Cout that 96 divides: two m-blocks of 96 channels, the weights streamed
    assert [(p.phases, p.mblocks, p.bn, p.resident) for p in plans[:5]] == [(1, 2, 96, False)] * 5
    assert all(p.region_stages == up.MIN_REGION_STAGES and p.smem <= up.SMEM_LIMIT for p in plans[:5])
    # the outconv (96 + 96 -> 3) on its own kernel: 27 tap columns in 32,
    # four row stages of four chunks (two half live) beside six partial rows
    assert (plans[5].bn, plans[5].stages, plans[5].slots, plans[5].grid) == (32, 4, 6, 132)
    # where two m-blocks of 96 channels' weights fit, they stay resident; small grids split Cout
    assert up.plan(200, 9, 9, 48, 48, 96).resident
    assert up.plan(40, 6, 10, 96, 192, 96).bn == 32
    # without a skip (the geometry generator's stages), the unit is as before
    assert up.plan(4096, 8, 8, 384, 0, 192).mblocks == 1


# the outconv's walk where CTA ranges cut frames: (N, H, W, C_x, C_skip,
# Cout, SMs): a range that starts and ends inside a frame, a last range cut
# short at the end of N, frames of one row, rows cut into column strips,
# more CTAs than a frame has rows
OUTCONV_WALKS = [
    (3, 5, 7, 8, 16, 2, 4), (1, 64, 64, 64, 64, 3, 7), (4, 1, 64, 64, 64, 3, 3), (2, 3, 130, 8, 8, 3, 5),
    (5, 6, 1, 8, 8, 2, 132), (7, 64, 64, 96, 96, 3, 132), (1, 2, 200, 8, 0, 1, 11),
]


@pytest.mark.parametrize("n,h,w,c1,c2,cout,sms", OUTCONV_WALKS)
def test_outconv_walk_writes_every_row_once_where_ranges_cut_frames(n, h, w, c1, c2, cout, sms):
    p = _check_outconv_walk(n, h, w, c1, c2, cout, sms)
    assert p.grid == min(sms, p.rows)


def test_outconv_plan_refuses_what_its_kernel_does_not_take():
    assert oc.plan(4096, 64, 64, 64, 64, 8).bn == 96  # 72 tap columns: the widest it takes
    with pytest.raises(ValueError, match="at most 8 output channels"):
        oc.plan(4096, 64, 64, 64, 64, 9)
    with pytest.raises(ValueError, match="TMA box"):
        oc.plan(2, 4, 257, 8, 8, 3)
    with pytest.raises(ValueError, match="multiples of 8"):
        oc.plan(2, 4, 4, 12, 8, 3)
    with pytest.raises(ValueError, match="aligned"):
        oc.plan(2, 4, 4, 8, 8, 3, aligned=False)
    with pytest.raises(ValueError, match="do not fit"):
        oc.plan(2, 4, 64, 640, 640, 3)


def test_plan_splits_cout_for_small_grids_and_pads_small_cout_to_16():
    assert up.plan(4096, 4, 4, 512, 0, 256).bn == 128
    # the outconv's 9 x 3 tap columns pad to 32, one wgmma m64n32 a k step
    assert oc.plan(4096, 64, 64, 64, 64, 3).bn == 32
    assert up.plan(4096, 32, 32, 64, 0, 1).bn == 16
    small = up.plan(2, 2, 2, 256, 256, 256)  # 1 M tile x 4 phases: split to cover half the card
    assert small.bn == 16 and small.units == 4 * 16 and small.phases == 1


# ---- the generators' eval-mode decode on the fused op (the CPU runs its plain version)


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """The decoders' choice with a CPU tensor taken as on CUDA while
    ``.on`` (the plain version runs); ``.calls`` the fused op's calls."""
    state = types.SimpleNamespace(on=True, calls=[])

    def decodes_fused(x, train, norm):
        return layers.decodes_fused(types.SimpleNamespace(dtype=x.dtype, is_cuda=state.on), train, norm)

    def counted(*args, **kwargs):
        state.calls.append(args[0].shape)
        return up.fused_norm_act_up_conv(*args, **kwargs)

    for mod in (cgen_mod, ggen_mod):
        monkeypatch.setattr(mod, "decodes_fused", decodes_fused)
        monkeypatch.setattr(mod, "fused_norm_act_up_conv", counted)
    return state


def _redrawn(module, seed):
    """``module`` with seeded weights and running statistics away from (0, 1)."""
    g = torch.Generator().manual_seed(seed)
    module.reset_parameters(g)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.3)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.num_features, generator=g) * 0.2)
    return module


GEOMETRY = [("depth", 1), ("optical-flow", 2), ("segmentation", 5)]
# bf16, fused against unfused: the fused prologue computes relu(x * scale +
# shift) in f32 and rounds once, where the modules round BatchNorm's output
# and ReLU takes that; a one-ulp difference in an activation passes through
# the later stages. Measured max |diff| over seeds 0-3 and the three
# geometries: ggen 0, cgen 4.9e-4 (outputs in [-1, 1] after tanh); held at
# one bf16 ulp of 1.0 (2^-8).
BF16_ATOL = 2.0**-8


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("geometric_info,channel", GEOMETRY)
def test_ggen_eval_decode_on_the_fused_op_matches_the_modules(fused_on_cpu, geometric_info, channel, seed):
    ggen = _redrawn(GeometricVideoGenerator(channel=channel, geometric_info=geometric_info, ngf=8), seed)
    cast_for_compute(ggen, torch.device("cpu"), torch.bfloat16).eval()
    z = torch.randn(6, ggen.dim_z, generator=torch.Generator().manual_seed(seed + 10))
    got = ggen.decode(z)
    assert len(fused_on_cpu.calls) == 4
    fused_on_cpu.on = False
    want = ggen.decode(z)
    assert len(fused_on_cpu.calls) == 4 and got.shape == want.shape == (6, 64, 64, channel)
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= BF16_ATOL, diff


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("geometric_info,in_ch", GEOMETRY)
def test_cgen_eval_forward_on_the_fused_op_matches_the_modules(fused_on_cpu, geometric_info, in_ch, seed):
    cgen = _redrawn(ColorVideoGenerator(in_ch=in_ch, dim_z=4, geometric_info=geometric_info, ngf=8), seed)
    cast_for_compute(cgen, torch.device("cpu"), torch.bfloat16).eval()
    g = torch.Generator().manual_seed(seed + 20)
    x = torch.rand(4, in_ch, 64, 64, generator=g) * 2 - 1
    z = torch.randn(4, 4, generator=g)
    got = cgen(x, z)
    assert len(fused_on_cpu.calls) == 6 and got.is_contiguous(memory_format=torch.channels_last)
    fused_on_cpu.on = False
    want = cgen(x, z)
    assert len(fused_on_cpu.calls) == 6 and got.shape == want.shape == (4, 3, 64, 64)
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= BF16_ATOL, diff


def test_cgen_outconv_runs_inside_its_span(fused_on_cpu):
    from dcvgan_torch.utils import trace

    cgen = _redrawn(ColorVideoGenerator(in_ch=1, dim_z=4, ngf=8), 0)
    cast_for_compute(cgen, torch.device("cpu"), torch.bfloat16).eval()
    x, z = torch.rand(2, 1, 64, 64) * 2 - 1, torch.randn(2, 4)
    trace.enable()
    try:
        at = trace.mark()
        cgen(x, z)
        recs = trace.records(at)
    finally:
        trace.disable()
    # the k3s1 call is the last of the up path's six, in its own span inside cgen.up
    assert [r.name for r in recs] == ["cgen.down", "cgen.outconv", "cgen.up"]
    assert recs[1].parent == "cgen.up" and len(fused_on_cpu.calls) == 6


def _train_forwards(cgen, ggen, x, z, zg):
    masks = cgen.dropout_masks(x.shape[0], torch.Generator().manual_seed(5), x.device)
    return [cgen(x, z, train=True, update_stats=False, dropout_masks=masks), ggen.decode(zg, train=True, update_stats=False)]


@pytest.mark.parametrize("case", ["train", "group", "float32"])
def test_train_group_norm_and_f32_forwards_keep_the_unfused_path(fused_on_cpu, case):
    norm = "group" if case == "group" else "batch"
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    cgen = _redrawn(ColorVideoGenerator(in_ch=1, dim_z=4, ngf=8, norm=norm), 3)
    ggen = _redrawn(GeometricVideoGenerator(ngf=8, norm=norm), 3)
    for m in (cgen, ggen):
        cast_for_compute(m, torch.device("cpu"), dtype)
    g = torch.Generator().manual_seed(4)
    x, z, zg = torch.rand(2, 1, 64, 64, generator=g), torch.randn(2, 4, generator=g), torch.randn(2, 50, generator=g)

    def forwards():
        if case == "train":
            return _train_forwards(cgen, ggen, x, z, zg)
        return [cgen(x, z), ggen.decode(zg)]

    got = forwards()
    assert fused_on_cpu.calls == []
    fused_on_cpu.on = False
    again = forwards()
    assert fused_on_cpu.calls == []
    # the same modules both times; the CPU's f32 convolutions are not bitwise
    # reproducible from one call to the next (seen: ~1e-7 apart)
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b)


def test_decodes_fused_takes_eval_batch_norm_bf16_on_cuda_only():
    assert not layers.decodes_fused(torch.zeros(1, 8, 2, 2, dtype=torch.bfloat16), False, "batch")  # the CPU
    on_cuda = types.SimpleNamespace(dtype=torch.bfloat16, is_cuda=True)
    assert layers.decodes_fused(on_cuda, False, "batch")
    assert not layers.decodes_fused(on_cuda, True, "batch")
    assert not layers.decodes_fused(on_cuda, False, "group")
    assert not layers.decodes_fused(types.SimpleNamespace(dtype=torch.float32, is_cuda=True), False, "batch")


def test_gemm_weight_is_packed_once_per_weight_version():
    w = torch.nn.Parameter(torch.randn(16, 8, 4, 4))
    first = up.gemm_weight(w, 8)
    assert up.gemm_weight(w, 8) is first
    torch.testing.assert_close(first, up.pack_weight(w.detach(), 8))
    with torch.no_grad():
        w.mul_(2.0)  # an in-place update moves the version: packed anew
    second = up.gemm_weight(w, 8)
    assert second is not first
    torch.testing.assert_close(second, 2.0 * first)
    assert up.gemm_weight(w, 16) is not second  # another split of the channels
    with torch.inference_mode():
        t = w.detach() * 1.0  # an inference tensor has no version: packed at each call
        assert up.gemm_weight(t, 8) is not up.gemm_weight(t, 8)


# ---- the CUDA sources (read as text: nothing here compiles them)

# the Hopper layer both TMA kernels take from csrc/hopper.cuh
SHARED_HELPERS = {
    "smem_u32", "swz", "mbar_init", "mbar_expect_tx", "mbar_arrive", "mbar_try_wait", "mbar_test",
    "mbar_wait", "global_ns", "tma_load", "ldmatrix_x4", "wgmma_fence", "wgmma_commit", "wgmma_wait",
    "smem_desc", "wgmma_rs", "EncodeTiled", "encode_tiled", "encode_3d",
}


def _defined_names(source: str) -> set:
    """Functions a CUDA source defines (a type, then the name, then ``(`` or a
    template argument list), and the aliases it declares with ``using``."""
    decl = re.compile(r"^[ \t]*(?:template\s*<[^>\n]*>\s*)?(?:(?:__device__|__host__|__forceinline__|inline|static)\s+)*"
                      r"(?!(?:asm|const|else|if|return)\b)[A-Za-z_][\w:]*(?:\s*[*&])?\s+(?!constexpr\b)(\w+)"
                      r"\s*(?:<[^>\n]*>)?\s*\(", re.M)
    return set(decl.findall(source)) | set(re.findall(r"^\s*using\s+(\w+)\s*=", source, re.M))


def test_no_kernel_source_defines_what_hopper_cuh_defines():
    csrc = Path(up.__file__).resolve().parents[1] / "csrc"
    shared = _defined_names((csrc / "hopper.cuh").read_text())
    assert SHARED_HELPERS <= shared, SHARED_HELPERS - shared
    for src in sorted(csrc.glob("*.cu")):
        text = src.read_text()
        assert not _defined_names(text) & shared, (src.name, _defined_names(text) & shared)
        if "wgmma" in text:  # a Hopper TMA kernel takes the layer from the header
            assert '#include "hopper.cuh"' in text, src.name


# ---- the CUDA kernel against its plain version (on the card)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# and persistent CTAs that each walk several units
GPU_CASES = SCHEDULE_CASES + [(512, 4, 4, 512, 0, 256, "k4s2"), (64, 32, 32, 64, 64, 64, "k4s2"),
                              (512, 16, 16, 128, 128, 64, "k4s2"), (32, 64, 64, 64, 64, 3, "k3s1")] + [
    (4096, h, h, c1, c2, co, r) for h, c1, c2, co, r in SEGM_SITES + WIDE_CGEN_SITES] + [
    # two m-blocks of 96 channels at their edges: x and skip runs that end
    # at other points of a chunk, tiles across images and a partial last
    # tile, several units a CTA, weights resident, Cout split for a small grid
    (300, 5, 7, 96, 96, 192, "k4s2"), (200, 9, 9, 96, 96, 96, "k4s2"), (512, 4, 4, 384, 384, 384, "k4s2"),
    (200, 9, 9, 48, 48, 96, "k4s2"), (40, 6, 10, 96, 192, 96, "k4s2"), (1000, 8, 8, 96, 192, 96, "k4s2")] + [
    # the outconv: mug-depth's serving site at N = 4096 (surreal-depth3's is
    # above), its other shapes on the CPU (tap columns 16 / 32 / 96, runs
    # ending inside a k step, no skip, rows cut into column strips), ranges
    # cut short inside frames
    (4096, 64, 64, 64, 64, 3, "k3s1")] + [(n, h, w, c1, c2, co, "k3s1") for n, h, w, c1, c2, co in OUTCONV_CASES] + [
    (3, 5, 200, 24, 40, 2, "k3s1"), (133, 64, 64, 64, 64, 3, "k3s1"), (2, 7, 64, 8, 8, 4, "k3s1")]


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,c1,c2,cout,route", GPU_CASES)
def test_kernel_matches_plain_on_gpu(cuda, n, h, w, c1, c2, cout, route):
    x, scale, shift, wt, skip = _case(n, h, w, c1, c2, cout, route, seed=6, dtype=torch.bfloat16)
    x, scale, shift, wt = x.to(cuda), scale.to(cuda), shift.to(cuda), wt.to(cuda)
    skip = None if skip is None else skip.to(cuda)
    _, stride, padding = KERNEL[route]
    before = up.fused_norm_act_up_conv.launches
    got = up.fused_norm_act_up_conv(x, scale, shift, wt, skip, stride, padding)
    again = up.fused_norm_act_up_conv(x, scale, shift, wt, skip, stride, padding)
    want = up.reference_norm_act_up_conv(x, scale, shift, wt, skip, stride, padding)
    torch.cuda.synchronize()
    assert up.fused_norm_act_up_conv.launches == before + 2
    assert torch.equal(got, again)  # no atomics: the same bytes
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-7, atol=1e-3)


@pytest.mark.gpu
def test_outconv_keeps_a_nan_in_x_in_its_neighbourhood_on_gpu(cuda):
    x, scale, shift, wt, skip = _case(3, 64, 64, 64, 64, 3, "k3s1", seed=8, dtype=torch.bfloat16)
    x[1, 7, 0, 63] = float("nan")
    x, scale, shift, wt, skip = (t.to(cuda) for t in (x, scale, shift, wt, skip))
    got = up.fused_norm_act_up_conv(x, scale, shift, wt, skip, 1, 1).float()
    want = up.reference_norm_act_up_conv(x, scale, shift, wt, skip, 1, 1).float()
    nan = torch.zeros_like(got, dtype=torch.bool)
    nan[1, :, 0:2, 62:64] = True
    assert torch.equal(got.isnan(), nan) and torch.equal(want.isnan(), nan)
    torch.testing.assert_close(got[~nan], want[~nan], rtol=2.0**-7, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("ngf", [8, 96])
def test_cgen_forward_takes_the_outconv_kernel_once_on_gpu(cuda, ngf):
    """One eval forward in bf16 on the card: six fused up launches, the
    outconv's the one k3s1 among them."""
    cgen = _redrawn(ColorVideoGenerator(in_ch=1, dim_z=4, ngf=ngf), 0)
    cast_for_compute(cgen, cuda, torch.bfloat16).eval()
    g = torch.Generator().manual_seed(3)
    x, z = (torch.rand(4, 1, 64, 64, generator=g) * 2 - 1).to(cuda), torch.randn(4, 4, generator=g).to(cuda)
    launches, routes = up.fused_norm_act_up_conv.launches, dict(up.fused_norm_act_up_conv.routes)
    with torch.inference_mode():
        got = cgen(x, z)
    torch.cuda.synchronize()
    assert up.fused_norm_act_up_conv.launches == launches + 6
    assert up.fused_norm_act_up_conv.routes["k3s1"] == routes.get("k3s1", 0) + 1
    assert up.fused_norm_act_up_conv.routes["k4s2"] == routes.get("k4s2", 0) + 5
    assert got.shape == (4, 3, 64, 64) and got.isfinite().all()
