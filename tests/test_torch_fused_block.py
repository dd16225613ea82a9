"""The port's fused BN-affine + LeakyReLU + conv4x4s2 against the JAX package.

On the CPU ``dcvgan_torch.ops.fused_block.fused_norm_act_conv`` runs its
plain version; it is held against the Pallas kernel in interpret mode and
against ``reference_norm_act_conv``, on the same numpy inputs. The CUDA
kernel itself is held against the plain version on the card (``gpu``
marker here, and ``chip_smoke.py``). The card's machine has no JAX, so the
JAX package is imported in the cases that compare with it, and the ``gpu``
cases run there with ``--noconftest``.
"""

import numpy as np
import pytest
import torch

from dcvgan_torch.ops import fused_block as port
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


def _jax():
    """jax.numpy and the JAX package's ``ops.fused_block``."""
    import jax.numpy as jnp

    from dcvgan_tpu.ops import fused_block

    return jnp, fused_block


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
    _, ref = _jax()
    x, scale, shift, w4 = _case(b, h, w, c, cout)
    got = _port(x, scale, shift, w4)
    want_ref = ref.reference_norm_act_conv(x, scale, shift, w4)
    within(got, want_ref, ATOL_F32)
    want_pallas = ref.fused_norm_act_conv(x, scale, shift, ref.pack_weights(w4), interpret=True)
    within(got, want_pallas, ATOL_F32)
    assert got.shape == (b, h // 2, w // 2, cout)


def test_negative_slope_and_large_shift():
    # a shift large enough that the activation branches, and padding must
    # contribute 0, not leaky_relu(shift)
    _, ref = _jax()
    x, scale, shift, w4 = _case(2, 32, 32, 8, 8, seed=3, shift_offset=1.0)
    got = _port(x, scale, shift, w4, slope=0.01)
    within(got, ref.reference_norm_act_conv(x, scale, shift, w4, negative_slope=0.01), ATOL_F32)
    want = ref.fused_norm_act_conv(x, scale, shift, ref.pack_weights(w4), negative_slope=0.01, interpret=True)
    within(got, want, ATOL_F32)


def test_xn_out_is_the_activation():
    x, scale, shift, w4 = _case(2, 8, 8, 16, 8, seed=4, shift_offset=0.5)
    xn = torch.empty_like(nchw(x))
    _port(x, scale, shift, w4, slope=0.2, xn_out=xn)
    act = x * scale + shift
    act = np.where(act >= 0, act, act * 0.2)
    np.testing.assert_array_equal(nhwc(xn), act)


def test_bf16_matches_jax_bf16():
    jnp, ref = _jax()
    x, scale, shift, w4 = _case(2, 16, 16, 32, 16, seed=5)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # bf16-exact inputs
    wb = np.asarray(jnp.asarray(w4, jnp.bfloat16).astype(jnp.float32))
    want = ref.reference_norm_act_conv(
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
@pytest.mark.parametrize(
    "n,h,w,c,cout",
    [
        (3, 32, 32, 64, 128),
        (3, 2, 2, 256, 256),
        (3, 8, 8, 24, 40),  # Cout = 40: no plan, the op raises
        (3, 4, 4, 12, 8),  # C = 12, Cout = 8: no plan, the op raises
        (3, 16, 16, 128, 256),  # a partial last tile and an odd tile count
        (300, 2, 2, 256, 256),  # down5's 2x2 input, 3 tiles
        (5, 4, 12, 64, 64),  # OW < 8, W != H
        (7, 6, 6, 8, 16),  # C = 8: half of the 64-channel chunk is the box's zero fill
        (40, 6, 10, 64, 64),  # OH*OW = 15: tiles span images, shapes repeat every 15 tiles
    ],
)
def test_kernel_matches_plain_on_gpu(cuda, dtype, n, h, w, c, cout):
    _held_to_plain(cuda, dtype, n, h, w, c, cout)


def _held_to_plain(cuda, dtype, n, h, w, c, cout, bf16_atol=1e-4):
    x, scale, shift, w4 = _case(n, h, w, c, cout, seed=6, shift_offset=0.5)
    xt = nchw(x).to(cuda, dtype)
    st, sh = torch.from_numpy(scale).to(cuda), torch.from_numpy(shift).to(cuda)
    wt = hwio_to_torch(w4).to(cuda, dtype)
    xn_k, xn_p = torch.empty_like(xt), torch.empty_like(xt)
    before = port.fused_norm_act_conv.launches
    if port.plan(n, h, w, c, cout, dtype) is None:
        with pytest.raises(ValueError, match="no plan"):
            port.fused_norm_act_conv(xt, st, sh, wt, 0.2, xn_out=xn_k)
        assert port.fused_norm_act_conv.launches == before
        return
    got = port.fused_norm_act_conv(xt, st, sh, wt, 0.2, xn_out=xn_k)
    want = port.reference_norm_act_conv(xt, st, sh, wt, 0.2, xn_out=xn_p)
    torch.cuda.synchronize()
    assert port.fused_norm_act_conv.launches == before + 1
    atol, rtol = (bf16_atol, 2.0**-7) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    within(nhwc(got.cpu()), nhwc(want.cpu()), atol, rtol)
    assert torch.equal(xn_k, xn_p)


# surreal-depth3's serving call (cgen ngf 96, bf16: C 96 a chunk and a half,
# Cout 192 and 384 on 192-wide tiles, down5 on 128), and the 192-wide
# tile's edges: a partial last tile with tiles across images and C 96, and
# a partial last tile at K 6144
WIDE_GPU_CASES = [(4096, 32, 32, 96, 192), (4096, 16, 16, 192, 384), (4096, 8, 8, 384, 384),
                  (4096, 4, 4, 384, 384), (4096, 2, 2, 384, 384), (1000, 6, 10, 96, 192), (300, 8, 8, 384, 384)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,c,cout", WIDE_GPU_CASES)
def test_wide_tiles_match_plain_on_gpu(cuda, n, h, w, c, cout):
    # The absolute term grows with K = 16 C: each wgmma k step truncates its
    # f32 sum, so near 0 the kernel's sum drifts from cuDNN's by up to K / 16
    # truncations at the partial sums' size. 1e-4 holds K <= 4096 (ngf 64);
    # K = 6144 (C 384) takes 1.5e-4. With the +0.5 shift, one output of 25M
    # at 8 px reads 2.04e-4 where cuDNN reads 0.99e-4 and float64 1.17e-4,
    # the same on 128- and 192-wide tiles and on the kernel before them.
    _held_to_plain(cuda, torch.bfloat16, n, h, w, c, cout, bf16_atol=1e-4 * max(1.0, 16 * c / 4096))


# ---- the TMA kernel's schedule (ops/fused_block.py: plan, tile_table)

# cgen down1..down5 at 64 px: (H of x, C, Cout) for colour-generator width ngf
def _cgen_sites(ngf, image_size=64):
    mults = [1, 2] + [4] * (int(np.log2(image_size)) - 2)
    sites, h = [], image_size // 2
    for i in range(1, len(mults)):
        sites.append((h, ngf * mults[i - 1], ngf * mults[i]))
        h //= 2
    return sites


FLAGSHIP_SITES = _cgen_sites(64)
# surreal-depth3's (cgen ngf 96): 96 -> 192 at 32 px, then 192 -> 384 and 384 -> 384
WIDE_CGEN_SITES = _cgen_sites(96)
# small N, so that tiles are partial (N*OH*OW not a multiple of 128) and
# tile counts odd
SCHEDULE_CASES = [(3, h, h, c, co) for h, c, co in FLAGSHIP_SITES + WIDE_CGEN_SITES] + [
    (300, 2, 2, 256, 256),  # down5: 2x2 input, 3 tiles
    (5, 4, 12, 64, 64),  # W != H, OW < 8
    (7, 6, 6, 8, 16),  # C = 8 (one 16-channel chunk, half of it the box's zero fill)
    (40, 6, 10, 64, 64),  # OH*OW = 15: the tiles' shapes repeat every 15 tiles
]


def _tma_plan(n, h, w, c, cout, dtype=torch.bfloat16):
    p = port.plan(n, h, w, c, cout, dtype)
    assert p.route == {torch.bfloat16: "tma", torch.float32: "tf32x3"}[dtype], p
    return p


def _table(p, n, h, w, cout):
    t = port.tile_table(n, h, w, p.bn, cout).numpy()
    assert t.dtype == np.int32 and t.shape == (p.units, len(port.TILE_COLUMNS))
    return dict(zip(port.TILE_COLUMNS, t.T.astype(np.int64)))


def _reads(n, h, w):
    """Per output pixel: the lowest and highest flattened input row it reads,
    and the taps (bit 4 * kh + kw) that read the image."""
    img, oh, ow = np.meshgrid(np.arange(n), np.arange(h // 2), np.arange(w // 2), indexing="ij")
    img, oh, ow = img.ravel(), oh.ravel(), ow.ravel()
    taps = np.zeros_like(oh)
    for kh in range(4):
        for kw in range(4):
            ih, iw = 2 * oh - 1 + kh, 2 * ow - 1 + kw
            taps |= ((ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)) << (4 * kh + kw)
    lo = img * h + np.maximum(2 * oh - 1, 0)
    hi = img * h + np.minimum(2 * oh + 2, h - 1)
    return lo, hi, taps


def _tiles_partition_the_output_once(n, h, w, c, cout, dtype):
    p = _tma_plan(n, h, w, c, cout, dtype)
    t = _table(p, n, h, w, cout)
    m = n * (h // 2) * (w // 2)
    covered = np.zeros((m, cout), np.int32)
    for m0, m1, n0 in zip(t["m0"], t["m1"], t["n0"]):
        assert 0 <= m0 < m1 <= min(m0 + port.TILE_M, m) and n0 % p.bn == 0 and n0 + p.bn <= cout
        covered[m0:m1, n0 : n0 + p.bn] += 1
    np.testing.assert_array_equal(covered, 1)
    # CTA b runs units b, b + grid, ...: every unit once
    assert 1 <= p.grid <= min(p.units, port.H100_SMS) and p.m_tiles * (cout // p.bn) == p.units


@pytest.mark.parametrize("n,h,w,c,cout", SCHEDULE_CASES)
def test_plan_tiles_partition_the_output_once(n, h, w, c, cout):
    _tiles_partition_the_output_once(n, h, w, c, cout, torch.bfloat16)


@pytest.mark.parametrize("n,h,w,c,cout", SCHEDULE_CASES)
def test_f32_plan_tiles_partition_the_output_once(n, h, w, c, cout):
    # 32 channels a stage and tiles at most 64 channels wide
    _tiles_partition_the_output_once(n, h, w, c, cout, torch.float32)


def _every_input_pixel_has_one_xn_out_owner(n, h, w, c, cout, dtype):
    p = _tma_plan(n, h, w, c, cout, dtype)
    t = _table(p, n, h, w, cout)
    oh, ow = h // 2, w // 2
    lo, hi, _ = _reads(n, h, w)
    owners = np.zeros(n * h * w, np.int32)
    for m0, m1, n0, p_lo in zip(t["m0"], t["m1"], t["n0"], t["p_lo"]):
        # the rows the tile's pixels read lie inside its staged region
        assert p_lo == lo[m0:m1].min() and hi[m0:m1].max() < p_lo + p.region_rows
        if n0 != 0:
            continue
        # the kernel transforms every pixel of the staged rows and writes those it owns
        px = np.arange(p_lo * w, min((p_lo + p.region_rows) * w, n * h * w))
        row, iw = px // w, px % w
        img, ih = row // h, row % h
        m_own = (img * oh + ih // 2) * ow + iw // 2
        owners[px[(m_own >= m0) & (m_own < m1)]] += 1
    np.testing.assert_array_equal(owners, 1)


@pytest.mark.parametrize("n,h,w,c,cout", SCHEDULE_CASES)
def test_plan_gives_every_input_pixel_one_xn_out_owner(n, h, w, c, cout):
    _every_input_pixel_has_one_xn_out_owner(n, h, w, c, cout, torch.bfloat16)


@pytest.mark.parametrize("n,h,w,c,cout", SCHEDULE_CASES)
def test_f32_plan_gives_every_input_pixel_one_xn_out_owner(n, h, w, c, cout):
    _every_input_pixel_has_one_xn_out_owner(n, h, w, c, cout, torch.float32)


def _fits_shared_memory(ngf, n, dtype):
    for h, c, cout in _cgen_sites(ngf):
        p = _tma_plan(n, h, h, c, cout, dtype)
        assert p.smem <= port.SMEM_LIMIT == 232_448
        assert port.MIN_W_STAGES <= p.w_stages <= port.MAX_W_STAGES
        assert p.region_rows <= 256 and p.bn <= port.MAX_BN[dtype] and cout % p.bn == 0
        # the CUDA layout: two region stages of 128-byte rows, w_stages
        # weight stages of bn 128-byte rows a part, a zero row, the barriers
        parts = {torch.bfloat16: 1, torch.float32: 2}[dtype]
        region = -(-p.region_rows * h * 128 // 1024) * 1024
        assert p.smem == 1024 + 2 * region + p.w_stages * parts * p.bn * 128 + 128 + 8 * (6 + 2 * p.w_stages)


@pytest.mark.parametrize("ngf", [8, 32, 64, 96])
@pytest.mark.parametrize("n", [16, 320, 4096])
def test_plan_fits_shared_memory_at_every_cgen_site(ngf, n):
    _fits_shared_memory(ngf, n, torch.bfloat16)


@pytest.mark.parametrize("ngf", [8, 32, 64, 96])
@pytest.mark.parametrize("n", [16, 320, 4096])
def test_f32_plan_fits_shared_memory_at_every_cgen_site(ngf, n):
    _fits_shared_memory(ngf, n, torch.float32)


def _config_cgen_sites():
    """(config name, frames of one batch, H, C, Cout) of every config's cgen sites."""
    from pathlib import Path

    from dcvgan_torch.config import load_config

    paths = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.yml"))
    assert paths
    for path in paths:
        cfg = load_config(path)
        for h, c, cout in _cgen_sites(cfg.cgen.ngf, cfg.image_size):
            yield path.name, cfg.batchsize * cfg.video_length, h, c, cout


def test_every_config_cgen_site_takes_the_tma_route():
    for name, n, h, c, cout in _config_cgen_sites():
        p = port.plan(n, h, h, c, cout, torch.bfloat16)
        assert p.route == "tma", (name, h, c, cout, p)


def test_every_config_cgen_site_in_f32_takes_the_tf32x3_route():
    # trainer.precision: float32 (debug-mock-depth and every config run in f32)
    for name, n, h, c, cout in _config_cgen_sites():
        for frames in (n, 25 * 16, 4096):  # a batch, log_samples' round, the flagship serve call
            p = port.plan(frames, h, h, c, cout, torch.float32)
            assert p.route == "tf32x3", (name, frames, h, c, cout, p)


# mug-depth's five bf16 plans at N = 4096 (its serving call), field for
# field: a change for another configuration's shapes leaves these as they are
FLAGSHIP_PLANS = [
    ("tma", 128, 5, 17, 132, 222464, 8192, 8192),
    ("tma", 128, 6, 32, 132, 230672, 2048, 4096),
    ("tma", 128, 6, 64, 132, 230672, 512, 1024),
    ("tma", 128, 6, 128, 132, 230672, 128, 256),
    ("tma", 64, 8, 256, 128, 197936, 32, 128),
]


@pytest.mark.parametrize("site,want", list(zip(FLAGSHIP_SITES, FLAGSHIP_PLANS)),
                         ids=[f"h{h}-{c}-{co}" for h, c, co in FLAGSHIP_SITES])
def test_flagship_plans_are_pinned(site, want):
    h, c, cout = site
    p = port.plan(4096, h, h, c, cout, torch.bfloat16)
    assert (p.route, p.bn, p.w_stages, p.region_rows, p.grid, p.smem, p.m_tiles, p.units) == want


def test_bf16_plans_take_192_wide_tiles_where_192_divides_cout():
    plans = [port.plan(4096, h, h, c, co, torch.bfloat16) for h, c, co in WIDE_CGEN_SITES]
    # down1-4 at ngf 96: one or two whole 192-wide tiles; down5's 32 M tiles take 128 for the grid
    assert [p.bn for p in plans] == [192, 192, 192, 192, 128]
    assert all(p.w_stages >= port.MIN_W_STAGES and p.smem <= port.SMEM_LIMIT for p in plans)
    assert port.plan(4096, 32, 32, 96, 192, torch.float32).bn == 64  # f32 keeps its 64-channel tiles
    assert port.plan(4096, 8, 8, 96, 96, torch.bfloat16).bn == 96
    assert port.plan(16, 32, 32, 96, 192, torch.bfloat16).bn == 64  # a small grid narrows the tiles
    for h, c, co in WIDE_CGEN_SITES + [(6, 96, 192)]:
        for n in (3, 300, 1000):
            _tiles_partition_the_output_once(n, h, h + (4 if h == 6 else 0), c, co, torch.bfloat16)


def test_plan_is_none_for_shapes_the_tma_kernel_cannot_take():
    assert port.plan(3, 8, 8, 12, 8, torch.bfloat16) is None  # C % 8
    assert port.plan(3, 8, 8, 24, 40, torch.bfloat16) is None  # Cout % 16
    assert port.plan(3, 32, 32, 64, 128, torch.bfloat16, aligned=False) is None
    # f32: the TMA kernel on error-compensated TF32, except where TMA cannot go
    assert port.plan(3, 32, 32, 64, 128, torch.float32).route == "tf32x3"
    assert port.plan(3, 8, 8, 12, 16, torch.float32).route == "tf32x3"  # C % 4 == 0 is enough
    assert port.plan(3, 8, 8, 6, 16, torch.float32) is None  # C % 4
    assert port.plan(3, 8, 8, 12, 8, torch.float32) is None  # Cout % 16
    assert port.plan(3, 32, 32, 64, 128, torch.float32, aligned=False) is None
    assert port.plan(2, 4, 512, 64, 64, torch.float32) is None  # W > 256: wider than a box
    # the flagship sites: one CTA per SM at most, every SM but a few busy
    for h, c, cout in FLAGSHIP_SITES:
        p = _tma_plan(4096, h, h, c, cout)
        assert port.H100_SMS // 2 <= p.grid <= port.H100_SMS
    assert _tma_plan(4096, 2, 2, 256, 256).bn < 128  # down5 splits Cout further to fill the card


@pytest.mark.parametrize("n,h,w,c,cout", SCHEDULE_CASES)
def test_skipping_dead_taps_is_exact(n, h, w, c, cout):
    p = _tma_plan(n, h, w, c, cout)
    t = _table(p, n, h, w, cout)
    _, _, taps = _reads(n, h, w)
    rng = np.random.default_rng(7)
    x = nchw(rng.normal(size=(n, h, w, c)).astype(np.float32))
    wt = torch.from_numpy(rng.normal(size=(cout, c, 4, 4)).astype(np.float32) * 0.1)
    wt = wt.contiguous(memory_format=torch.channels_last)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    shift = torch.from_numpy((rng.normal(size=c) + 1.0).astype(np.float32))  # act(pad) != 0
    full = nhwc(port.reference_norm_act_conv(x, scale, shift, wt)).reshape(-1, cout)
    by_mask = {}
    for m0, m1, live in zip(t["m0"], t["m1"], t["live"]):
        # the live taps are exactly those some pixel of the tile reads the image with
        assert live == np.bitwise_or.reduce(taps[m0:m1])
        by_mask.setdefault(int(live), []).append((m0, m1))
    for mask, spans in by_mask.items():
        dead = torch.tensor([not (mask >> tap) & 1 for tap in range(16)]).reshape(4, 4)
        pruned = nhwc(port.reference_norm_act_conv(x, scale, shift, wt * ~dead)).reshape(-1, cout)
        for m0, m1 in spans:
            np.testing.assert_array_equal(pruned[m0:m1], full[m0:m1])
    if h == 2:  # down5: only the 4 centre taps touch a 2x2 image
        assert set(by_mask) == {0b0000_0110_0110_0000}


@pytest.mark.parametrize("n,h,w", [(4096, 32, 32), (4096, 2, 2), (1000, 6, 10), (3, 256, 256)])
def test_tile_table_at_full_size_matches_the_pixel_rule(n, h, w):
    # the periodic shortcut for the live taps against every pixel of every tile
    lo, hi, taps = _reads(n, h, w)
    t = port.tile_table(n, h, w, 64, 128).numpy()[::2]  # Cout tile 0 of each M tile
    m = len(taps)
    pad = -m % port.TILE_M
    tiles = np.concatenate([taps, np.zeros(pad, taps.dtype)]).reshape(-1, port.TILE_M)
    np.testing.assert_array_equal(t[:, 4], np.bitwise_or.reduce(tiles, axis=1))
    np.testing.assert_array_equal(t[:, 3], lo[t[:, 0]])


# ---- the tf32x3 route's arithmetic (csrc/fused_block.cu), emulated in numpy

# |kernel - plain| <= atol + rtol * |plain| for f32 outputs (chip_smoke.py's OUT_TOL)
F32_ATOL, F32_RTOL = 1e-4, 1e-4


def _tf32(v):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to nearest,
    ties away from zero (on the bits: add half of the dropped part, clear it)."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(v):
    """v = hi + lo, each part TF32 (v - hi is exact in float32)."""
    hi = _tf32(v)
    return hi, _tf32(np.asarray(v, np.float32) - hi)


def _patches(act, h, c):
    """im2col of a (N, H, H, C) activation for conv4x4 s2 p1: (N*OH*OW, 16*C)
    in (kh, kw, c) order, padded taps 0."""
    n, oh = act.shape[0], h // 2
    padded = np.zeros((n, h + 2, h + 2, c), act.dtype)
    padded[:, 1:-1, 1:-1] = act
    cols = [padded[:, kh:kh + 2 * oh:2, kw:kw + 2 * oh:2] for kh in range(4) for kw in range(4)]
    return np.concatenate(cols, axis=-1).reshape(n * oh * oh, 16 * c)


def _kernel_sum(a_parts, b_parts, c):
    """The kernel's accumulation: per tap (C consecutive K entries) the sum
    of the given products, as an f32 partial sum, added into an f32
    accumulator rounded to nearest. TF32 x TF32 products are exact in f32."""
    acc = np.zeros((a_parts[0].shape[0], b_parts[0].shape[0]), np.float32)
    for t in range(16):
        k = slice(t * c, (t + 1) * c)
        part = sum(a[:, k].astype(np.float64) @ b[:, k].T.astype(np.float64)
                   for a, b in zip(a_parts, b_parts))
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


def test_tf32_split_is_two_tf32_parts():
    v = np.random.default_rng(7).normal(size=10_000).astype(np.float32) * 10.0 ** np.arange(-4, 6).repeat(1000)
    hi, lo = _split(v)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(lo) <= 2.0**-11 * np.abs(v)).all()
    # the parts keep 21 or more bits of v, one TF32 value 11
    assert (np.abs(v.astype(np.float64) - hi - lo) <= 2.0**-21 * np.abs(v)).all()
    assert (np.abs(v.astype(np.float64) - hi) > 2.0**-14 * np.abs(v)).any()


def test_three_tf32_products_hold_the_f32_tolerance_where_one_does_not():
    # down3's shape (C = 256: 4096 products an output) at 2 frames and 16 output channels
    rng = np.random.default_rng(8)
    n, h, c, cout = 2, 8, 256, 16
    x = rng.normal(size=(n, h, h, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = (rng.normal(size=c) * 0.2).astype(np.float32)
    act = x * scale + shift
    act = np.where(act >= 0, act, act * np.float32(0.2)).astype(np.float32)
    a = _patches(act, h, c)
    b = (rng.normal(size=(cout, 16 * c)) / np.sqrt(16 * c)).astype(np.float32)  # Cout x (kh, kw, c)
    want = a.astype(np.float64) @ b.T.astype(np.float64)
    tol = F32_ATOL + F32_RTOL * np.abs(want)
    (ah, al), (bh, bl) = _split(a), _split(b)
    # the small terms first: a_lo * b_hi + a_hi * b_lo + a_hi * b_hi
    three = _kernel_sum([al, ah, ah], [bh, bl, bh], c)
    assert (np.abs(three - want) <= tol).all()
    assert np.abs(three - want).max() <= 2e-5
    one = _kernel_sum([ah], [bh], c)  # one TF32 product: the control
    assert (np.abs(one - want) > tol).any()


@pytest.mark.gpu
@pytest.mark.parametrize("slope,shift_offset", [(0.2, 0.5), (0.01, 1.0)])
@pytest.mark.parametrize(
    "n,h,w,c,cout,route",
    [
        (3, 16, 16, 128, 256, "tf32x3"),  # a partial last tile and an odd tile count
        (300, 2, 2, 256, 256, "tf32x3"),  # down5's 2x2 input, 3 tiles
        (5, 4, 12, 64, 64, "tf32x3"),  # OW < 8, W != H
        (7, 6, 6, 8, 16, "tf32x3"),  # C = 8 (debug-mock-depth's ngf): a quarter chunk
        (40, 6, 10, 64, 64, "tf32x3"),  # OH*OW = 15: tiles span images
        (3, 8, 8, 12, 8, None),  # Cout % 16: no plan, the op raises
    ],
)
def test_f32_routes_match_plain_on_gpu(cuda, n, h, w, c, cout, route, slope, shift_offset):
    x, scale, shift, w4 = _case(n, h, w, c, cout, seed=9, shift_offset=shift_offset)
    xt = nchw(x).to(cuda)
    st, sh = torch.from_numpy(scale).to(cuda), torch.from_numpy(shift).to(cuda)
    wt = hwio_to_torch(w4).to(cuda)
    xn_k, xn_p = torch.empty_like(xt), torch.empty_like(xt)
    out = torch.empty(n, cout, h // 2, w // 2, device=cuda, memory_format=torch.channels_last)
    p = port.plan_for(xt, wt, out, xn_k)
    assert (p and p.route) == route
    before = port.fused_norm_act_conv.launches
    if p is None:
        with pytest.raises(ValueError, match="no plan"):
            port.fused_norm_act_conv(xt, st, sh, wt, slope, xn_out=xn_k)
        assert port.fused_norm_act_conv.launches == before
        return
    got = port.fused_norm_act_conv(xt, st, sh, wt, slope, xn_out=xn_k)
    want = port.reference_norm_act_conv(xt, st, sh, wt, slope, xn_out=xn_p)
    torch.cuda.synchronize()
    assert port.fused_norm_act_conv.launches == before + 1
    within(nhwc(got.cpu()), nhwc(want.cpu()), F32_ATOL, F32_RTOL)
    assert torch.equal(xn_k, xn_p)
