// Fused BatchNorm affine + ReLU + U-Net skip + ConvTranspose2d k4 s2 p1 for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the decoders' transposed
// convs, the BatchNorm and ReLU between them and the colour generator's skip
// concatenations to XLA. It was added because under cuDNN those four passes
// took most of a sampling round's device time on the H100 (PERF.md): a
// dgrad kernel per transposed conv, then a BatchNorm pass, a ReLU pass and a
// `cat` copy per stage, each a round trip of the activation through device
// memory. One decoder stage is one launch here:
//
//     out = conv_transpose2d(cat([relu(x * scale + shift), skip]), w, stride=2, padding=1)
//
// on NHWC bf16 activations: `scale`/`shift` are the previous stage's
// eval-mode BatchNorm folded per channel in f32, the activation is rounded
// to bf16 before the product (as the BatchNorm's bf16 output was), `skip`
// (optional) is read as it is, zero padding applies to the activation, the
// products accumulate in f32 in a fixed order (no split-K, no atomics: the
// same inputs give the same bytes) and the output is the raw conv result in
// bf16. The wrapper is ops/fused_up.py; it plans the schedule by shape.
//
// Every decoder stage but the colour generator's last is k4 s2 p1: output
// pixel (2a + py, 2b + px) is a 2x2 conv of the input around (a, b), one per
// output parity ("phase"): tap (i, j) reads input (a + py - i, b + px - j)
// with weight tap (2i + 1 - py, 2j + 1 - px). So it is an implicit GEMM: M =
// input positions, N = Cout, K = taps x (C_x + C_skip). The weight is
// repacked once per weight version into a (Cout, taps, K) row-major matrix
// (K-major for the tensor cores, each of x's and the skip's channel runs
// padded to 64). The colour generator's outconv (k3 s1 p1 to 3 channels) is
// another algorithm, in outconv.cu.
//
// The design is fused_block.cu's kernel (its notes say why), on the Hopper
// layer both take from hopper.cuh: a persistent kernel of 512 threads walking
// a host-planned table of units; one producer thread streams the staged input
// rows of a unit (64 channels a stage, x's chunks then the skip's, by two
// tensor maps) and the weights by TMA into mbarrier rings; seven transform
// warps apply the affine + ReLU in place to x's chunks (the skip's need
// none); two consumer warpgroups gather A with ldmatrix (padding taps point
// at a zero row) and run wgmma m64nBNk16 with B from the swizzled weight
// stage, then store the tile's rows at their output pixels, only the real
// channels (Cout of 1, 2 or 3 runs on 16-wide tiles).
// A unit is 128 or 256 input positions (one or two m-blocks of 64 rows a
// warpgroup) x one or all four output phases x up to 128 output channels,
// or two m-blocks of 96 (the ngf-96 colour generator's up stages, 96 f32
// accumulators a thread and no spill); the host picks the shape per call
// (ops/fused_up.py: plan).
//
// What holds it on an H100 (bf16, N = 4096 frames; measured, PERF.md): at
// the small-K, small-Cout stages, the consumers' fixed cost per gathered
// offset (address, ldmatrix, the wgmma group's issue and wait), not the
// bytes: a lesioned build that loads and synchronises but gathers and
// multiplies nothing keeps most of the time, and the same with no TMA at
// all. So the design raises the products per gather: the offsets' row
// addresses are computed once a unit; a unit of all four phases gathers the
// 9 offsets of a 3x3 neighbourhood once for 16 products, and loads and
// transforms its rows once instead of four times; two m-blocks halve the
// staged halo rows a position reads; the weights of a unit stay resident in
// shared memory where they fit (the grid is a multiple of the units of one
// M tile, so each CTA keeps one phase group and Cout tile) and are loaded
// once a CTA. At K = 512 and 128 output channels (512 KB of weights a
// phase) the weights stream through a ring, and each SM takes in a unit's
// weights from L2 (1/128 byte a flop) at roughly 25 bytes a cycle, which
// caps those stages near 75% of the tensor cores' peak.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;         // input positions per tile and m-block a warpgroup (64 rows each)
constexpr int kRB = 128;         // bytes of one staged pixel or weight row: TMA's widest swizzle
constexpr int kCK = kRB / 2;     // channels per stage: 64 bf16
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = 512;
constexpr int kTransformWarps = kThreads / 32 - kConsumers / 32 - 1;
constexpr int kAuxRegs = 96, kConsumerRegs = 160;
static_assert((kThreads - kConsumers) * kAuxRegs + kConsumers * kConsumerRegs <= 65536, "register split");
constexpr int kTileColumns = 5;  // m0, m1, n0, p_lo, phase: ops/fused_up.py TILE_COLUMNS

struct Params {
  const float* scale;
  const float* shift;
  bf16* out;
  const int* tiles;  // n_units rows of kTileColumns: the host's tile table
  int n, h, w, c1, c2, cout;
  int chunks1, chunks;  // x's 64-channel chunks; x's and the skip's
  int region_stages, w_stages, region_rows;
  int resident;  // 1: the CTA's weights stay in shared memory (see the note above the kernel)
  int region_bytes, wstage_bytes;  // ring strides, multiples of 1024
  int zero_off, bar_off;           // byte offsets in shared memory
  int n_units;
};

// The shared-memory layout, from a 1024-byte aligned base: [region x
// region_stages][weight stage x w_stages][zero row][mbarriers]; `total`
// includes 1024 bytes of slack for aligning the base.
struct Layout {
  int region_bytes, wstage_bytes, zero_off, bar_off, total;
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

inline Layout layout(int w, int bn, int region_stages, int w_stages, int region_rows) {
  Layout l;
  l.region_bytes = round_up(region_rows * w * kRB, 1024);
  l.wstage_bytes = round_up(bn * kRB, 1024);
  l.zero_off = region_stages * l.region_bytes + w_stages * l.wstage_bytes;
  l.bar_off = l.zero_off + 128;
  l.total = 1024 + l.bar_off + 8 * (3 * region_stages + 2 * w_stages);
  return l;
}

// First and last flattened input row (n * H + a) that positions [m0, m1) read.
void tile_rows(int m0, int m1, int H, int W, int& lo, int& hi) {
  const int q0 = m0 / W, q1 = (m1 - 1) / W;
  const int n0 = q0 / H, a0 = q0 % H, n1 = q1 / H, a1 = q1 % H;
  lo = n0 * H + (a0 > 0 ? a0 - 1 : 0);
  hi = n1 * H + (a1 + 1 < H ? a1 + 1 : H - 1);
}

// The most input rows a tile of tile_m positions reads. The tiles' shapes
// repeat every H*W / gcd(tile_m, H*W) tiles; only the last may be shorter.
int max_region_rows(int n, int h, int w, int tile_m) {
  const int hw = h * w;
  const long long m = static_cast<long long>(n) * hw;
  int a = tile_m, b = hw;
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  const long long tiles = (m + tile_m - 1) / tile_m;
  const int period = hw / a;
  auto rows_of = [&](long long t) {
    int lo, hi;
    const long long m0 = t * tile_m, m1 = m0 + tile_m < m ? m0 + tile_m : m;
    tile_rows(static_cast<int>(m0), static_cast<int>(m1), h, w, lo, hi);
    return hi - lo + 1;
  };
  int rows = tiles > 0 ? rows_of(tiles - 1) : 0;
  for (long long t = 0; t < tiles && t < period; ++t) rows = rows_of(t) > rows ? rows_of(t) : rows;
  return rows;
}

// The prologue on one 16-byte granule of x (8 channels), in place:
// relu(v * scale + shift) with a separate multiply and add, as the plain
// version computes it, rounded to bf16. NaN stays NaN, as under F.relu.
__device__ __forceinline__ uint4 transform16(uint4 v, const float (&sc)[8], const float (&sh)[8]) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lo = __fadd_rn(__fmul_rn(__uint_as_float(w[i] << 16), sc[2 * i]), sh[2 * i]);
    float hi = __fadd_rn(__fmul_rn(__uint_as_float(w[i] & 0xffff0000u), sc[2 * i + 1]), sh[2 * i + 1]);
    lo = lo < 0.f ? 0.f : lo;
    hi = hi < 0.f ? 0.f : hi;
    const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
    w[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
  return v;
}

struct Tile {
  int m0, m1, n0, p_lo;  // input positions [m0, m1), channels [n0, n0 + BN), first staged input row
  int phase;             // a one-phase k4 s2 unit's output parity py * 2 + px; else 0
};

__device__ __forceinline__ Tile tile_of(int u, const Params& p) {
  const int* row = p.tiles + kTileColumns * u;
  return Tile{__ldg(row), __ldg(row + 1), __ldg(row + 2), __ldg(row + 3), __ldg(row + 4)};
}

// A unit computes P output phases of its positions (P = 1, the tile
// table's phase, or P = 4, every phase). Per chunk the consumers gather A
// once per input offset (dy, dx) the unit reads (P = 1: 4; P = 4: the 9
// offsets of a 3x3 neighbourhood) and run, for each (phase, weight tap) that
// reads it, the wgmmas into that phase's accumulator: P = 4 gathers 9
// offsets for 16 products.
template <int P>
struct Geometry {
  static_assert(P == 1 || P == 4, "one phase or all four");
  static constexpr int kOffsets = P == 1 ? 4 : 9;
  static constexpr int kStageTaps = 4 * P;  // weight stages a chunk
};

// Offset o of a unit of phase `phase` (P = 1) as (dy, dx).
template <int P>
__device__ __forceinline__ void offset_of(int o, int phase, int& dy, int& dx) {
  if constexpr (P == 1) {
    dy = (phase >> 1) - (o >> 1);
    dx = (phase & 1) - (o & 1);
  } else {
    dy = o / 3 - 1;
    dx = o % 3 - 1;
  }
}

// The weight tap (kh * 4 + kw) of a chunk's weight stage `idx`, which is the
// order the producer loads them in: P = 1: offset idx = (i, j) of `phase`;
// P = 4: tap idx itself.
template <int P>
__device__ __forceinline__ int stage_tap(int idx, int phase) {
  if constexpr (P == 1) {
    const int py = phase >> 1, px = phase & 1, i = idx >> 1, j = idx & 1;
    return (2 * i + 1 - py) * 4 + (2 * j + 1 - px);
  } else {
    return idx;
  }
}

// The weights come in one of two ways (Params::resident, planned on the host):
// - streamed (P = 1): a ring of w_stages stages, one tap x one chunk each,
//   refilled as the consumers free them, for the sites whose weights of one
//   unit's phases and Cout tile exceed the budget (K = 512, BN = 128: 512 KB);
// - resident: the grid is a multiple of the units of one M tile, so every
//   unit a CTA walks has the same phases and Cout tile; the producer loads
//   their weights (chunks x kStageTaps stages) once and the consumers keep
//   them, so the CTA takes in only its rows from L2. Neighbouring CTAs run
//   the units of one M tile at once, which keeps the rows' reads in L2.
// MB: m-blocks of 64 rows a consumer warpgroup takes (a unit is MB * 128
// input positions): 2 halves the weight bytes a product takes in and the
// staged halo rows a position reads, at twice the accumulators.
template <int P, int MB, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    fused_up_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_s,
                    const __grid_constant__ CUtensorMap tm_w, const Params p) {
  using G = Geometry<P>;
  static_assert(P * MB * BN <= 128 || (P == 1 && MB == 2 && BN == 96),
                "P x MB accumulators of 64 x BN f32 in the consumers' registers");
  // A buffers in flight: four where the accumulators leave room
  constexpr int NB = P * MB * BN <= 32 ? 4 : 2;
  // the unit of two m-blocks x 96 channels (the ngf-96 colour generator's
  // sites, whose channel runs of 96 and 192 end inside a chunk) skips the k
  // steps past a run's end, which multiply the box's zero fill by zero
  // weights; every other instance runs all four k steps of every chunk
  constexpr bool kRunEnds = MB == 2 && BN == 96;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(smem);
  const uint32_t wbase = sbase + p.region_stages * p.region_bytes;
  const uint32_t zero_addr = sbase + p.zero_off;  // 128 bytes of zeros
  const uint32_t bars = sbase + p.bar_off;
  auto r_full = [&](int s) { return bars + 8 * s; };                      // copied
  auto r_ready = [&](int s) { return bars + 8 * (p.region_stages + s); };  // transformed
  auto r_empty = [&](int s) { return bars + 8 * (2 * p.region_stages + s); };
  auto w_full = [&](int s) { return bars + 8 * (3 * p.region_stages + s); };
  auto w_empty = [&](int s) { return bars + 8 * (3 * p.region_stages + p.w_stages + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid < 32) reinterpret_cast<uint32_t*>(smem + p.zero_off)[tid] = 0u;
  if (tid == 0) {
    for (int s = 0; s < p.region_stages; ++s) {
      mbar_init(r_full(s), 1);
      mbar_init(r_ready(s), kTransformWarps);
      mbar_init(r_empty(s), kConsumers / 32);
    }
    for (int s = 0; s < p.w_stages; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int u0 = blockIdx.x, stride = gridDim.x;

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kAuxRegs));
    if (warp == kConsumers / 32) {
      // ---- producer: one thread starts every copy; the whole warp keeps the
      // schedule. A region goes out as soon as its stage is free, ahead of the
      // weights of earlier chunks; the weights follow as their ring frees up.
      const uint32_t region_tx = static_cast<uint32_t>(p.region_rows * p.w * kRB);
      auto ready = [&](uint32_t bar, uint32_t parity) {
        return __shfl_sync(0xffffffffu, lane == 0 ? static_cast<int>(mbar_test(bar, parity)) : 0, 0) != 0;
      };
      int rs = 0, ws = 0, ru = u0, rc = 0, wu = u0, wc = 0, wt_i = 0;
      uint32_t rph = 0, wph = 0;
      Tile rt = tile_of(ru, p), wt = rt;
      uint64_t idle_since = 0;
      // the weight ring may run chunks ahead of the region ring: the loop ends
      // when both have issued their last copy
      while (wu < p.n_units || ru < p.n_units) {
        bool progress = false;
        if (ru < p.n_units && ready(r_empty(rs), rph ^ 1)) {
          if (lane == 0) {
            const uint32_t dst = sbase + rs * p.region_bytes;
            mbar_expect_tx(r_full(rs), region_tx);
            if (rc < p.chunks1) {
              tma_load(dst, &tm_x, r_full(rs), rc * kCK, 0, rt.p_lo);
            } else {
              tma_load(dst, &tm_s, r_full(rs), (rc - p.chunks1) * kCK, 0, rt.p_lo);
            }
          }
          if (++rs == p.region_stages) {
            rs = 0;
            rph ^= 1;
          }
          if (++rc == p.chunks) {
            rc = 0;
            ru += stride;
            if (ru < p.n_units) rt = tile_of(ru, p);
          }
          progress = true;
        }
        if (wu < p.n_units && ready(w_empty(ws), wph ^ 1)) {
          if (lane == 0) {
            mbar_expect_tx(w_full(ws), BN * kRB);
            tma_load(wbase + ws * p.wstage_bytes, &tm_w, w_full(ws), wc * kCK, stage_tap<P>(wt_i, wt.phase),
                     wt.n0);
          }
          if (++ws == p.w_stages) {
            ws = 0;
            wph ^= 1;
          }
          if (++wt_i == G::kStageTaps) {
            wt_i = 0;
            if (++wc == p.chunks) {
              wc = 0;
              wu = p.resident ? p.n_units : wu + stride;  // resident: every unit's weights are loaded
              if (wu < p.n_units) wt = tile_of(wu, p);
            }
          }
          progress = true;
        }
        if (progress) {
          idle_since = 0;
        } else {  // nothing free yet: a schedule fault if it lasts, as in mbar_wait
          const uint64_t now = global_ns();
          if (idle_since == 0) idle_since = now;
          if (now - idle_since > 2000000000ull) __trap();
          __nanosleep(64);
        }
      }
    } else {
      // ---- transform warps: the affine + ReLU in place on x's chunks
      const int tt = tid - kConsumers - 32;
      const int my_j = tt & 7;  // this thread's 16-byte granule of every staged pixel
      const int px_step = 32 * kTransformWarps / 8;
      const int n_px = p.region_rows * p.w;
      int rs = 0;
      uint32_t rph = 0;
      for (int u = u0; u < p.n_units; u += stride) {
        for (int cc = 0; cc < p.chunks; ++cc) {
          const int ch = cc * kCK + 8 * my_j;
          mbar_wait(r_full(rs), rph);
          if (cc < p.chunks1 && ch < p.c1) {  // channels past C stay 0 (the box's fill)
            unsigned char* region = smem + rs * p.region_bytes;
            float sc[8], sh[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              sc[e] = __ldg(p.scale + ch + e);
              sh[e] = __ldg(p.shift + ch + e);
            }
            // four granules at a time: independent work that hides the latencies of so few warps
            for (int px0 = tt >> 3; px0 < n_px; px0 += 4 * px_step) {
              uint4 v[4] = {};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int px = px0 + i * px_step;
                if (px < n_px) v[i] = *reinterpret_cast<const uint4*>(region + swz(px * kRB + 16 * my_j));
              }
#pragma unroll
              for (int i = 0; i < 4; ++i) v[i] = transform16(v[i], sc, sh);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int px = px0 + i * px_step;
                if (px < n_px) *reinterpret_cast<uint4*>(region + swz(px * kRB + 16 * my_j)) = v[i];
              }
            }
          }
          // order this thread's writes before the TMA copies that refill the stage
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(r_ready(rs));
          if (++rs == p.region_stages) {
            rs = 0;
            rph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    constexpr int NO = G::kOffsets;
    constexpr int NQ = P * MB;  // accumulators: m-block mb, phase q at mb * P + q
    // this warp's 16 rows of m-block mb: 64 * (MB * wg + mb) + 16 * (warp % 4)
    const int row0 = 64 * MB * (warp >> 2) + 16 * (warp & 3);
    // descriptor of weight stage 0; stage s adds s * wstage_bytes, k step kk 32 bytes
    const uint64_t desc0 = smem_desc(wbase, 1, 8 * kRB);
    const uint32_t desc_stage = static_cast<uint32_t>(p.wstage_bytes) >> 4;
    const int hw = p.h * p.w;
    int rs = 0, ws = 0;
    uint32_t rph = 0, wph = 0;
    float acc[NQ][BN / 2];
    uint32_t af[NB][4][4];  // A fragments of one (offset, m-block)'s 4 k steps, NB in flight
    if (p.resident) {       // the CTA's weights, loaded once: wait for them once
      for (int s = 0; s < p.w_stages; ++s) mbar_wait(w_full(s), 0);
    }

    for (int u = u0; u < p.n_units; u += stride) {
      const Tile t = tile_of(u, p);
      // this lane's A row for each m-block and offset: the swizzled byte offset
      // in a region stage (stage bases are 1024-byte aligned, so the swizzle of
      // base + offset is base + the swizzle of offset), or -1 where it is padding
      int toff[MB][NO];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        const int m = t.m0 + row0 + 64 * mb + (lane & 15);
        const bool in = m < t.m1;
        const int mm = in ? m : t.m0;
        const int n = mm / hw, r = mm - n * hw, a = r / p.w, b = r - a * p.w;
        const int a_off = ((n * p.h + a - t.p_lo) * p.w + b) * kRB + 16 * (lane >> 4);
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          int dy, dx;
          offset_of<P>(o, t.phase, dy, dx);
          const bool ok = in && a + dy >= 0 && a + dy < p.h && b + dx >= 0 && b + dx < p.w;
          toff[mb][o] = ok ? static_cast<int>(swz(static_cast<uint32_t>(a_off + (dy * p.w + dx) * kRB))) : -1;
        }
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[q][i] = 0.f;
      int prev_ws = -1;

      for (int cc = 0; cc < p.chunks; ++cc) {
        mbar_wait(r_ready(rs), rph);
        const uint32_t region_addr = sbase + rs * p.region_bytes;
        const uint64_t wdesc = desc0 + static_cast<uint64_t>(cc * G::kStageTaps * desc_stage);
        // k steps of 16 channels that hold some of the chunk's run (x's or the skip's)
        const int live = cc < p.chunks1 ? p.c1 - cc * kCK : p.c2 - (cc - p.chunks1) * kCK;
        const int nk = kRunEnds ? min(4, (live + 15) / 16) : 4;
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          // P = 1: resident stage cc * taps + o, or the ring's next stage
          uint64_t desc1 = wdesc + static_cast<uint64_t>(o * desc_stage);
          if (P == 1 && !p.resident) {
            mbar_wait(w_full(ws), wph);
            desc1 = desc0 + static_cast<uint64_t>(ws * desc_stage);
          }
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            uint32_t(&fa)[4][4] = af[(o * MB + mb) % NB];
            const uint32_t a = toff[mb][o] >= 0 ? region_addr + static_cast<uint32_t>(toff[mb][o]) : zero_addr;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              if (kk < nk) ldmatrix_x4(fa[kk], a ^ (32u * kk));
            wgmma_fence();
            if constexpr (P == 1) {
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                if (kk < nk) wgmma_rs<BN>(acc[mb], fa[kk], desc1 + 2 * kk, 1);
            } else {
              // every (phase, tap) that reads offset (dy, dx): phase (py, px)
              // with tap (i, j) = (py - dy, px - dx) in {0, 1}^2, weight tap
              // (2i + 1 - py, 2j + 1 - px), resident stage cc * 16 + that tap
              const int dy = o / 3 - 1, dx = o % 3 - 1;
#pragma unroll
              for (int py = 0; py < 2; ++py) {
#pragma unroll
                for (int px = 0; px < 2; ++px) {
                  const int i = py - dy, j = px - dx;
                  if (i < 0 || i > 1 || j < 0 || j > 1) continue;
                  const int wtap = (2 * i + 1 - py) * 4 + (2 * j + 1 - px);
                  const uint64_t desc = wdesc + static_cast<uint64_t>(wtap * desc_stage);
#pragma unroll
                  for (int kk = 0; kk < 4; ++kk) wgmma_rs<BN>(acc[mb * P + 2 * py + px], fa[kk], desc + 2 * kk, 1);
                }
              }
            }
            wgmma_commit();
            // NB - 1 groups may stay in flight: the oldest one's A buffer is
            // free (streamed weights wait for all but the last, see below)
            if (P == 1 && !p.resident) {
              wgmma_wait<1>();
            } else {
              wgmma_wait<NB - 1>();
            }
            // streamed weights: once this offset's first group is issued, the
            // previous offset's groups are done with their stage
            if (P == 1 && !p.resident && mb == 0) {
              if (prev_ws >= 0 && lane == 0) mbar_arrive(w_empty(prev_ws));
              prev_ws = -1;
            }
          }
          if (P == 1 && !p.resident) {
            prev_ws = ws;
            if (++ws == p.w_stages) {
              ws = 0;
              wph ^= 1;
            }
          }
        }
        // a chunk whose group count is not a multiple of NB ends on another
        // buffer than the next chunk begins on: drain first
        if constexpr ((NO * MB) % NB != 0) wgmma_wait<0>();
        __syncwarp();  // this warp's ldmatrix reads of the region are done
        if (lane == 0) mbar_arrive(r_empty(rs));
        if (++rs == p.region_stages) {
          rs = 0;
          rph ^= 1;
        }
      }
      wgmma_wait<0>();
      if (prev_ws >= 0 && lane == 0) mbar_arrive(w_empty(prev_ws));
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[q][i])::"memory");

      // epilogue: fragment (rows g and g + 8, columns 8j + 2q, +1) of each
      // m-block and phase to the rows' output pixels, the real channels only
      const int g = lane >> 2, cq = lane & 3;
      const int ow = 2 * p.w;
      const bool pairs = (p.cout & 1) == 0;  // even Cout: 4-byte aligned pairs
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = t.m0 + row0 + 64 * mb + g + 8 * hh;
          if (m >= t.m1) continue;
          const int n = m / hw, r = m - n * hw, a = r / p.w, b = r - a * p.w;
#pragma unroll
          for (int q = 0; q < P; ++q) {
            const int phase = P == 4 ? q : t.phase;
            const int py = phase >> 1, px = phase & 1;
            const long long pix = (static_cast<long long>(n) * 2 * p.h + 2 * a + py) * ow + 2 * b + px;
            bf16* o = p.out + pix * p.cout;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int co = t.n0 + 8 * j + 2 * cq;
              const float v0 = acc[mb * P + q][4 * j + 2 * hh], v1 = acc[mb * P + q][4 * j + 2 * hh + 1];
              if (pairs) {
                if (co < p.cout) *reinterpret_cast<__nv_bfloat162*>(o + co) = __floats2bfloat162_rn(v0, v1);
              } else {
                if (co < p.cout) o[co] = __float2bfloat16_rn(v0);
                if (co + 1 < p.cout) o[co + 1] = __float2bfloat16_rn(v1);
              }
            }
          }
        }
      }
    }
  }
}

template <int P, int MB, int BN>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_s, const CUtensorMap& tm_w, const Params& p, int grid,
           int smem, cudaStream_t s) {
  const cudaError_t err =
      cudaFuncSetAttribute(fused_up_kernel<P, MB, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_up_kernel<P, MB, BN>
      <<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(smem), s>>>(tm_x, tm_s, tm_w, p);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations the planner uses: P * MB * BN <= 128.
template <int P, int MB>
int launch_bn(int bn, const CUtensorMap& tm_x, const CUtensorMap& tm_s, const CUtensorMap& tm_w, const Params& p,
              int grid, int smem, cudaStream_t s) {
  switch (bn) {
    case 16: return launch<P, MB, 16>(tm_x, tm_s, tm_w, p, grid, smem, s);
    case 32: return launch<P, MB, 32>(tm_x, tm_s, tm_w, p, grid, smem, s);
    case 64:
      if constexpr (P * MB <= 2) return launch<P, MB, 64>(tm_x, tm_s, tm_w, p, grid, smem, s);
      return static_cast<int>(cudaErrorInvalidValue);
    case 96:  // whole 96-channel tiles where 128 would leave a quarter empty; two m-blocks of them
      if constexpr (P == 1) return launch<P, MB, 96>(tm_x, tm_s, tm_w, p, grid, smem, s);
      return static_cast<int>(cudaErrorInvalidValue);
    case 128:
      if constexpr (P * MB == 1) return launch<P, MB, 128>(tm_x, tm_s, tm_w, p, grid, smem, s);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One k4 s2 p1 decoder stage, with the schedule planned on the host
// (dcvgan_torch/ops/fused_up.py: plan, tile_table). x (n, h, w, c1) and skip (n, h, w, c2, or
// null with c2 = 0) are NHWC bf16; scale and shift are (c1,) float32;
// w_gemm is the packed weight (cout, 16, k_pad) bf16 with x's channels at
// [0, c1) and the skip's at [64 * ceil(c1 / 64), ...), zeros between; out is
// (n, 2 * h, 2 * w, cout) bf16. `phases` output phases a unit (1 or 4),
// `mblocks` m-blocks of 64 rows a warpgroup (a unit is 128 *
// mblocks input positions), bn output channels per tile, region_stages staged regions,
// w_stages weight stages (with `resident`, a unit's chunks x taps, loaded
// once a CTA), region_rows input rows per staged region, `tiles` the device
// copy of the n_units x kTileColumns int32 tile table, `grid` CTAs and `smem`
// bytes of dynamic shared memory. Returns cudaGetLastError(), -2 when `smem`
// is not this source's layout for the plan, -3 when libcuda has no
// cuTensorMapEncodeTiled, -4 when a tensor map is refused, -5 when
// region_rows is fewer than the rows a tile reads.
int fused_up_conv(const void* x, const void* skip, const void* scale, const void* shift, const void* w_gemm,
                  void* out, int n, int h, int w_in, int c1, int c2, int cout, int phases, int mblocks, int bn,
                  int region_stages, int w_stages, int resident, int region_rows, const void* tiles, int n_units,
                  int grid, int smem, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(skip) |
                         reinterpret_cast<uintptr_t>(w_gemm) | reinterpret_cast<uintptr_t>(out);
  const int tile_m = kBM * mblocks;
  const long long m_tiles = (static_cast<long long>(n) * h * w_in + tile_m - 1) / tile_m;
  const int taps = 16;
  // units of one M tile: its phase groups x Cout tiles
  const int group = 4 / phases * ((cout + bn - 1) / bn);
  const bool ok = (phases == 1 || (phases == 4 && resident)) &&
                  (mblocks == 1 || mblocks == 2) && (phases * mblocks * bn <= 128 || (phases == 1 && bn == 96)) &&
                  c1 > 0 && c1 % 8 == 0 && c2 >= 0 && c2 % 8 == 0 &&
                  (c2 == 0) == (skip == nullptr) && cout >= 1 && (bn == 16 || bn == 32 || bn == 64 || bn == 96 || bn == 128) &&
                  region_stages >= 2 && w_stages >= 1 && region_rows >= 1 && region_rows <= 256 && w_in <= 256 &&
                  n_units == m_tiles * group && grid >= 1 && grid <= n_units && tiles != nullptr && ptrs % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (region_rows < max_region_rows(n, h, w_in, tile_m)) return -5;
  const Layout l = layout(w_in, bn, region_stages, w_stages, region_rows);
  if (l.total != smem) return -2;
  if (encode_tiled() == nullptr) return -3;
  const int chunks1 = (c1 + kCK - 1) / kCK, chunks2 = (c2 + kCK - 1) / kCK;
  // resident weights: one stage per chunk and tap of a unit, and a grid that
  // keeps each CTA on one phase group and Cout tile
  if (resident && (w_stages != (chunks1 + chunks2) * 4 * phases || grid % group != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t k_pad = static_cast<cuuint64_t>(kCK) * (chunks1 + chunks2);
  const CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tm_x, tm_s, tm_w;
  // x and skip as (C, W, N * H): a box is one chunk of channels of region_rows whole rows
  const cuuint64_t rows = static_cast<cuuint64_t>(n) * h;
  const cuuint32_t box[3] = {kCK, static_cast<cuuint32_t>(w_in), static_cast<cuuint32_t>(region_rows)};
  if (!encode_3d(&tm_x, type, x, {cuuint64_t(c1), cuuint64_t(w_in), rows},
                 {cuuint64_t(c1) * 2, cuuint64_t(w_in) * c1 * 2}, box))
    return -4;
  tm_s = tm_x;  // unused without a skip
  if (c2 > 0 &&
      !encode_3d(&tm_s, type, skip, {cuuint64_t(c2), cuuint64_t(w_in), rows},
                 {cuuint64_t(c2) * 2, cuuint64_t(w_in) * c2 * 2}, box))
    return -4;
  // the packed weight as (K, taps, Cout): a box is one chunk of channels of one
  // tap for bn output channels; rows past Cout are the box's zero fill
  if (!encode_3d(&tm_w, type, w_gemm, {k_pad, cuuint64_t(taps), cuuint64_t(cout)}, {k_pad * 2, taps * k_pad * 2},
                 {kCK, 1, static_cast<cuuint32_t>(bn)}))
    return -4;
  Params p;
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.out = static_cast<bf16*>(out);
  p.tiles = static_cast<const int*>(tiles);
  p.n = n;
  p.h = h;
  p.w = w_in;
  p.c1 = c1;
  p.c2 = c2;
  p.cout = cout;
  p.chunks1 = chunks1;
  p.chunks = chunks1 + chunks2;
  p.region_stages = region_stages;
  p.w_stages = w_stages;
  p.resident = resident;
  p.region_rows = region_rows;
  p.region_bytes = l.region_bytes;
  p.wstage_bytes = l.wstage_bytes;
  p.zero_off = l.zero_off;
  p.bar_off = l.bar_off;
  p.n_units = n_units;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (phases == 4) return launch_bn<4, 1>(bn, tm_x, tm_s, tm_w, p, grid, smem, s);
  return mblocks == 2 ? launch_bn<1, 2>(bn, tm_x, tm_s, tm_w, p, grid, smem, s)
                      : launch_bn<1, 1>(bn, tm_x, tm_s, tm_w, p, grid, smem, s);
}

}  // namespace

// See fused_up_conv.
extern "C" int dcvgan_fused_up_conv(const void* x, const void* skip, const void* scale, const void* shift,
                                    const void* w_gemm, void* out, int n, int h, int w_in, int c1, int c2, int cout,
                                    int phases, int mblocks, int bn, int region_stages, int w_stages, int resident,
                                    int region_rows, const void* tiles, int n_units, int grid, int smem,
                                    void* stream) {
  return fused_up_conv(x, skip, scale, shift, w_gemm, out, n, h, w_in, c1, c2, cout, phases, mblocks, bn,
                       region_stages, w_stages, resident, region_rows, tiles, n_units, grid, smem, stream);
}
