// Fused BatchNorm affine + LeakyReLU + Conv2d(k=4, s=2, p=1) for Hopper (sm_90a).
//
// Replaces dcvgan_tpu/ops/fused_block.py::_fused_kernel, the Pallas TPU kernel
// launched by fused_norm_act_conv there. It computes
//
//     out = conv2d_k4s2p1(leaky_relu(x * scale + shift, slope))
//
// on NHWC activations: no bias, f32 accumulation, output in x's type. The
// normalised activation is rounded to x's type before the product, as the
// Pallas kernel does, and is never written to device memory unless the caller
// passes xn_out (the U-Net skip of the colour generator's down path).
//
// One kernel, an implicit GEMM: M = N*OH*OW output pixels, N_gemm = Cout and
// K = 16*C in (kh, kw, c) order, which is the memory order of a channels-last
// torch Conv2d weight (Cout, C, 4, 4): the weight is read as a row-major
// Cout x K matrix (K-major for the tensor cores) with no repacking. A padded
// tap contributes 0, not leaky_relu(shift): zero padding applies to the
// activation. Each input pixel's activation is written to xn_out once, by the
// tile that owns output pixel (ih/2, iw/2), on the first Cout tile; the stored
// value is the one fed to the product. Its schedule is planned on the host, by
// shape, before the launch (ops/fused_block.py: plan), which also refuses a
// shape the kernel cannot take (C not a multiple of 8 in bf16 or 4 in f32,
// Cout not of 16, pointers not 16-byte aligned, rows wider than a TMA box):
//
// - bf16 (route "tma", the serving path; the section "TMA" below): a
//   persistent, warp-specialised kernel. Tiles of 128 output pixels x up to
//   192 output channels; one producer thread streams the input rows of a
//   tile (64 channels a stage) and the weights (one tap x 64 channels a
//   stage) by TMA into mbarrier rings; seven transform warps apply the
//   prologue in place once per staged element and send the owned rows to
//   xn_out by TMA store; two consumer warpgroups gather A into registers by
//   ldmatrix and run wgmma m64nBNk16 with B read from the swizzled weight
//   stage. Taps that are padding for every pixel of a tile are skipped;
//   small sites split Cout so the grid covers the card.
// - f32 (route "tf32x3"): the same kernel on f32 (32 channels a stage), its
//   products error-compensated TF32 on wgmma m64nBNk8 (three TF32 products
//   of split operands per f32 product; see "TMA" below), which keeps the
//   results within f32 tolerance of a full-f32 convolution.
//
// What bounds it on an H100 at the flagship shapes (bf16, N = 4096 frames,
// with xn_out): by bytes from device memory, down1 (32x32x64 -> 16x16x128,
// 1.3 GB for 0.27 TFLOP), down4 and down5; by the tensor cores, down2 and
// down3. Measured (PERF.md), the kernel is held by what each SM must take
// in: the weights of all 16 taps for every 128-pixel tile (256 KB at down1,
// 512 KB a 128-channel tile at down2..4) plus the tile's rows, at roughly 25
// bytes a cycle per SM from L2. The design keeps x's DRAM traffic at one read
// and the skip at one write, overlaps the loads, the prologue and the MMAs in
// separate warps, runs on wgmma, and skips dead taps (3/4 of the work at
// down5). Weight multicast over a cluster of 2 CTAs halves the L2 reads of
// the weights but not the bytes each SM takes in; it measured slower at every
// site, so the kernel has no clusters. The f32 route does three TF32 products
// for each f32 one, so its bound is the tensor cores' TF32 rate at
// down1..down3 (3 x the live-tap flops over 495 TFLOP/s) and its weight
// stages carry 4 times the bf16 bytes. Times against the bounds and cuDNN in
// PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float act(float v, float scale, float shift, float slope) {
  // separate multiply and add (no FMA contraction), as the plain version computes
  const float f = __fadd_rn(__fmul_rn(v, scale), shift);
  return f >= 0.f ? f : __fmul_rn(f, slope);
}

// The most input rows any tile of `tile_m` output pixels reads. Tile t starts
// at pixel t * tile_m, so the tiles' shapes repeat every
// OH*OW / gcd(tile_m, OH*OW) tiles; only the last may be shorter.
int max_region_rows(int n, int h, int w_in, int tile_m) {
  const int OH = h / 2, OW = w_in / 2, ohw = OH * OW, M = n * ohw;
  int a = tile_m, b = ohw;
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  const int tiles = (M + tile_m - 1) / tile_m, period = ohw / a;
  // rows n * H + ih from the first to the last that output pixels [m0, m1) read
  auto rows_of = [&](int t) {
    const int m0 = t * tile_m, m1 = m0 + tile_m < M ? m0 + tile_m : M;
    const int q0 = m0 / OW, q1 = (m1 - 1) / OW;  // flattened output rows
    const int lo = q0 / OH * h + (q0 % OH > 0 ? 2 * (q0 % OH) - 1 : 0);
    const int hi = q1 / OH * h + (2 * (q1 % OH) + 2 < h ? 2 * (q1 % OH) + 2 : h - 1);
    return hi - lo + 1;
  };
  int rows = tiles > 0 ? rows_of(tiles - 1) : 0;
  for (int t = 0; t < tiles && t < period; ++t) rows = rows_of(t) > rows ? rows_of(t) : rows;
  return rows;
}

// ------------------------------------------------------ TMA (bf16, f32) ----
//
// A persistent, warp-specialised kernel of 512 threads in three roles:
// - two consumer warpgroups, 64 output pixels x BN channels each with the
//   f32 accumulators in registers: for each live tap they gather A from the
//   transformed region into registers with ldmatrix (rows of padding point
//   at a zero row: padding is 0 after the prologue) and run wgmma with B
//   read from a weight stage, then write the tile straight to `out`;
// - one producer warp, of which one thread starts every TMA load;
// - seven transform warps, which apply the prologue in place to each staged
//   region element once, while the consumers multiply the previous chunk,
//   and send the rows the tile owns to xn_out (one TMA store per tile and
//   chunk where tiles hold whole output rows, else 16-byte stores).
// A "unit" is one 128-pixel M tile at one BN-wide Cout tile: a row of the
// table the host plans (ops/fused_block.py: tile_table) with its pixels,
// channels, first staged input row and live taps. CTA b walks units b,
// b + grid, ..., so one unit's epilogue overlaps the next unit's loads.
//
// Two rings in shared memory, with mbarriers:
// - the region: the input rows a tile reads, one 128-byte row of channels
//   each (64 bf16 or 32 f32), copied by one TMA box (channel, column,
//   flattened row) per (tile, chunk); full -> transformed -> empty. The
//   producer sends a region out as soon as its stage is free, ahead of the
//   weights of earlier chunks;
// - the weights: one tap x one chunk of channels x BN rows per part, in the
//   128-byte swizzled K-major layout a wgmma B descriptor reads; full ->
//   empty.
// Taps that are padding for every pixel of a unit are skipped by all roles.
//
// The element type T picks the products:
// - bf16: wgmma m64nBNk16 .bf16, A fragments as ldmatrix gathers them;
// - float ("3xTF32", the f32 route): one TF32 product keeps about 11 bits
//   of each operand, too few for f32 results. Each operand is split into two
//   TF32 parts, v = v_hi + v_lo with v_hi = tf32(v) and v_lo = tf32(v -
//   v_hi) (cvt.rna; v - v_hi is exact in f32), and three wgmma m64nBNk8
//   .tf32 products, a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, accumulate in f32;
//   the dropped a_lo*b_lo and the parts' rounding leave a relative error
//   near 2^-21 a product, against 2^-24 for an f32 FMA. The same ldmatrix
//   gather serves: an 8x8 b16 matrix is an 8x4 f32 one, and lane l
//   receives element (l / 4, l % 4) of each, which is the TF32 A
//   fragment's layout. A is split in the consumers' registers after
//   the gather (the region keeps the f32 activation for xn_out). B is the
//   same for every tile, so split_tf32_kernel splits the weight once a call
//   into a scratch tensor the wrapper allocates ([hi; lo], each laid out as
//   the weight), and a weight stage holds both parts of one tap and chunk.
//   Against the bf16 kernel the tensor cores do 6 times the work for the
//   same pixels (three products at half the bf16 rate) and each stage
//   streams 4 times the weight bytes. That stream holds it: with the
//   products removed the kernel keeps most of its time (PERF.md,
//   tools/fused_block_lesions.py --dtype float32). A build that streamed the
//   raw weights instead and split each stage in shared memory with three of
//   the transform warps halved those bytes but ran slower on the card: four
//   region warps instead of seven, and spills.
//   The tensor cores truncate as they accumulate (each wgmma rounds its sum
//   toward zero), so the error grows with the number of accumulating steps
//   into one sum. a_hi * b_hi accumulates alone in `acc` and the two
//   correction terms in `part`, 2^-11 of its size, which adds little; the
//   two meet in the epilogue. All three in one sum (the lesion tool's
//   `one_sum`) triples the steps and about triples the error. Adding each
//   tap's sum into a register accumulator, rounded to nearest, beat the error
//   of a full-f32 FMA kernel, but ptxas serialises wgmmas whose accumulators
//   other instructions read inside the loop (C7514), even after a wait for
//   all of them; so neither sum is read before the unit ends. Two accumulators and
//   a tap's split A fragments, double-buffered, fit the 128 registers a
//   thread (ptxas allocates no more under this launch, setmaxnreg or not) at
//   64 output channels a tile (kMaxBN): the f32 plan's tiles are at most 64
//   wide, which also gives down1 five weight stages where 128 gave two.

namespace tma {

constexpr int kBM = 128;         // output pixels per tile
constexpr int kRB = 128;         // bytes of one staged pixel or weight row: TMA's widest swizzle
constexpr int kConsumers = 256;  // two warpgroups
// Two consumer warpgroups, one producer warp and seven transform warps: with
// at most 192 output channels a tile, the consumers' 96 f32 accumulators
// leave registers for two more warpgroups (setmaxnreg: the launch gives 128 a
// thread; consumers take 160, the others keep 96; ptxas spills nothing at
// 192).
constexpr int kThreads = 512;
constexpr int kTransformWarps = kThreads / 32 - kConsumers / 32 - 1;
constexpr int kAuxRegs = 96, kConsumerRegs = 160;
static_assert((kThreads - kConsumers) * kAuxRegs + kConsumers * kConsumerRegs <= 65536, "register split");
constexpr int kRegionStages = 2;

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;
template <typename T>
constexpr int kCK = kRB / sizeof(T);  // input channels per stage: 64 bf16, 32 f32
template <typename T>
constexpr int kParts = kF32<T> ? 2 : 1;  // weight parts per stage: f32 holds hi and lo
// output channels per tile at most. f32 keeps two accumulators and a tap's
// split A fragments, double-buffered; at 128 channels that spills (ptxas
// allocates 128 registers a thread under this launch, setmaxnreg or not).
// bf16 takes 192, one tile for a Cout of 192 (cgen ngf 96's down1), so that
// its A is gathered and multiplied once an M tile, not three times
template <typename T>
constexpr int kMaxBN = kF32<T> ? 64 : 192;

struct Params {
  const float* scale;
  const float* shift;
  void* out;
  void* xn_out;  // may be null
  const int* tiles;  // n_units rows of kTileColumns: the host's tile table
  int n, h, w, c, cout;
  float slope;
  int w_stages, region_rows;
  int region_bytes, wstage_bytes, wpart_bytes;  // ring strides, multiples of 1024
  int zero_off, bar_off;                        // byte offsets in shared memory
  int n_units;
  int xn_rows;  // input rows of a tile's xn_out box by TMA store; 0: per-thread stores
};

// The shared-memory layout, from a 1024-byte aligned base: [region x 2]
// [weight stage x w_stages, each `parts` parts][zero row][mbarriers];
// `total` includes 1024 bytes of slack for aligning the base.
struct Layout {
  int region_bytes, wpart_bytes, wstage_bytes, zero_off, bar_off, total;
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

inline Layout layout(int w, int bn, int w_stages, int region_rows, int parts) {
  Layout l;
  l.region_bytes = round_up(region_rows * w * kRB, 1024);
  l.wpart_bytes = round_up(bn * kRB, 1024);
  l.wstage_bytes = parts * l.wpart_bytes;
  l.zero_off = kRegionStages * l.region_bytes + w_stages * l.wstage_bytes;
  l.bar_off = l.zero_off + 128;
  l.total = 1024 + l.bar_off + 8 * (3 * kRegionStages + 2 * w_stages);
  return l;
}

// A box from shared memory to the tensor at (c0, c1, c2), then the bulk group's waits.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// acc(64 x N, f32) += A(64 x 8, TF32 registers) * B(8 x N, TF32 K-major in shared memory)
template <int N>
__device__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc, int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {" WG_D8 "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : WG_ACC4(0), WG_ACC4(4)
      : WG_A4, "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" WG_D16 "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : WG_ACC4(0), WG_ACC4(4), WG_ACC4(8), WG_ACC4(12)
      : WG_A4, "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" WG_D32 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_ACC4(0), WG_ACC4(4), WG_ACC4(8), WG_ACC4(12), WG_ACC4(16), WG_ACC4(20), WG_ACC4(24), WG_ACC4(28)
      : WG_A4, "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" WG_D64 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_ACC4(0), WG_ACC4(4), WG_ACC4(8), WG_ACC4(12), WG_ACC4(16), WG_ACC4(20), WG_ACC4(24), WG_ACC4(28),
        WG_ACC4(32), WG_ACC4(36), WG_ACC4(40), WG_ACC4(44), WG_ACC4(48), WG_ACC4(52), WG_ACC4(56), WG_ACC4(60)
      : WG_A4, "l"(desc), "r"(accumulate));
}

// The prologue on one 16-byte granule of x, in place: 8 bf16 or 4 f32 channels.
template <typename T>
__device__ __forceinline__ uint4 transform16(uint4 v, const float (&sc)[16 / sizeof(T)],
                                             const float (&sh)[16 / sizeof(T)], float slope) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kF32<T>) {
      w[i] = __float_as_uint(act(__uint_as_float(w[i]), sc[i], sh[i], slope));
    } else {
      const float lo = __uint_as_float(w[i] << 16), hi = __uint_as_float(w[i] & 0xffff0000u);
      const __nv_bfloat162 r = __floats2bfloat162_rn(act(lo, sc[2 * i], sh[2 * i], slope),
                                                     act(hi, sc[2 * i + 1], sh[2 * i + 1], slope));
      w[i] = *reinterpret_cast<const uint32_t*>(&r);
    }
  }
  return v;
}

__device__ __forceinline__ uint32_t tf32_rna(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
  return r;
}

// An f32 A fragment into its TF32 parts: a keeps the high part, lo gets the low.
__device__ __forceinline__ void split_tf32(uint32_t (&a)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float f = __uint_as_float(a[i]);
    const uint32_t hi = tf32_rna(f);
    lo[i] = tf32_rna(__fsub_rn(f, __uint_as_float(hi)));
    a[i] = hi;
  }
}

// The weight's TF32 parts, once a call: parts[i] = hi(w[i]), parts[n + i] = lo(w[i]).
__global__ void split_tf32_kernel(const float* __restrict__ w, float* __restrict__ parts, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float f = w[i];
    const uint32_t hi = tf32_rna(f);
    parts[i] = __uint_as_float(hi);
    parts[n + i] = __uint_as_float(tf32_rna(__fsub_rn(f, __uint_as_float(hi))));
  }
}

__device__ __forceinline__ void store2(bf16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

constexpr int kTileColumns = 5;  // m0, m1, n0, p_lo, live: ops/fused_block.py TILE_COLUMNS

struct Tile {
  int m0, m1, n0, p_lo;  // output pixels [m0, m1), channels [n0, n0 + BN), first staged input row
  uint32_t live;         // taps (bit 4 * kh + kw) that read the image for some pixel of the tile
};

__device__ __forceinline__ Tile tile_of(int u, const Params& p) {
  const int* row = p.tiles + kTileColumns * u;
  return Tile{__ldg(row), __ldg(row + 1), __ldg(row + 2), __ldg(row + 3), static_cast<uint32_t>(__ldg(row + 4))};
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    fused_tma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_xn, const Params p) {
  constexpr int kCK = tma::kCK<T>;
  constexpr int kGE = 16 / sizeof(T);  // channels per 16-byte granule
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(smem);
  const uint32_t wbase = sbase + kRegionStages * p.region_bytes;
  const uint32_t zero_addr = sbase + p.zero_off;  // 128 bytes of zeros
  const uint32_t bars = sbase + p.bar_off;
  auto r_full = [&](int s) { return bars + 8 * s; };                       // copied
  auto r_ready = [&](int s) { return bars + 8 * (kRegionStages + s); };    // transformed
  auto r_empty = [&](int s) { return bars + 8 * (2 * kRegionStages + s); };
  auto w_full = [&](int s) { return bars + 8 * (3 * kRegionStages + s); };
  auto w_empty = [&](int s) { return bars + 8 * (3 * kRegionStages + p.w_stages + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid < 32) reinterpret_cast<uint32_t*>(smem + p.zero_off)[tid] = 0u;
  if (tid == 0) {
    for (int s = 0; s < kRegionStages; ++s) {
      mbar_init(r_full(s), 1);
      mbar_init(r_ready(s), kTransformWarps);
      mbar_init(r_empty(s), kConsumers / 32 + (p.xn_rows > 0 ? 1 : 0));  // + the xn_out store
    }
    for (int s = 0; s < p.w_stages; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), kConsumers / 32);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int OH = p.h / 2, OW = p.w / 2;
  const int chunks = (p.c + kCK - 1) / kCK;
  const int u0 = blockIdx.x, stride = gridDim.x;

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kAuxRegs));
    if (warp == kConsumers / 32) {
      // ---- producer: one thread starts every copy; the whole warp keeps the
      // schedule. The region of a chunk goes out as soon as its stage is free,
      // ahead of the weights of earlier chunks, so the transform warps have it
      // early; the weights follow as their ring frees up.
      const uint32_t region_tx = static_cast<uint32_t>(p.region_rows * p.w * kRB);
      auto next_tap = [](uint32_t live, int tap) {
        do {
          ++tap;
        } while (tap < 16 && !((live >> tap) & 1u));
        return tap;
      };
      // test a barrier on lane 0 and give every lane its answer
      auto ready = [&](uint32_t bar, uint32_t parity) {
        return __shfl_sync(0xffffffffu, lane == 0 ? static_cast<int>(mbar_test(bar, parity)) : 0, 0) != 0;
      };
      int rs = 0, ws = 0, ru = u0, rc = 0, wu = u0, wc = 0;
      uint32_t rph = 0, wph = 0;
      Tile rt = tile_of(ru, p), wt = rt;
      int wtap = next_tap(wt.live, -1);
      uint64_t idle_since = 0;
      while (wu < p.n_units) {
        bool progress = false;
        if (ru < p.n_units && ready(r_empty(rs), rph ^ 1)) {
          if (lane == 0) {
            mbar_expect_tx(r_full(rs), region_tx);
            tma_load(sbase + rs * p.region_bytes, &tm_x, r_full(rs), rc * kCK, 0, rt.p_lo);
          }
          if (++rs == kRegionStages) {
            rs = 0;
            rph ^= 1;
          }
          if (++rc == chunks) {
            rc = 0;
            ru += stride;
            if (ru < p.n_units) rt = tile_of(ru, p);
          }
          progress = true;
        }
        if (ready(w_empty(ws), wph ^ 1)) {
          if (lane == 0) {
            const uint32_t dst = wbase + ws * p.wstage_bytes;
            mbar_expect_tx(w_full(ws), kParts<T> * BN * kRB);
            tma_load(dst, &tm_w, w_full(ws), wc * kCK, wtap, wt.n0);
            // f32: the low parts, the weight's second half in the split scratch
            if (kParts<T> == 2) tma_load(dst + p.wpart_bytes, &tm_w, w_full(ws), wc * kCK, wtap, p.cout + wt.n0);
          }
          if (++ws == p.w_stages) {
            ws = 0;
            wph ^= 1;
          }
          wtap = next_tap(wt.live, wtap);
          if (wtap == 16) {
            if (++wc == chunks) {
              wc = 0;
              wu += stride;
              if (wu < p.n_units) wt = tile_of(wu, p);
            }
            wtap = next_tap(wt.live, -1);
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
      // ---- transform warps: the prologue in place, and the owner's xn_out
      T* const xn_out = static_cast<T*>(p.xn_out);
      const int tt = tid - kConsumers - 32;
      const int my_j = tt & 7;  // this thread's 16-byte granule of every staged pixel
      const int px_step = 32 * kTransformWarps / 8;
      const int n_px = p.region_rows * p.w;
      const int w_shift = (p.w & (p.w - 1)) == 0 ? __ffs(p.w) - 1 : -1;
      const int h_shift = (p.h & (p.h - 1)) == 0 ? __ffs(p.h) - 1 : -1;
      int rs = 0, pending_rs = -1;
      uint32_t rph = 0;
      for (int u = u0; u < p.n_units; u += stride) {
        const Tile t = tile_of(u, p);
        const bool write_xn = xn_out != nullptr && t.n0 == 0;
        for (int cc = 0; cc < chunks; ++cc) {
          const int ch = cc * kCK + kGE * my_j;
          mbar_wait(r_full(rs), rph);
          if (ch < p.c) {  // channels past C stay 0 (the box's fill), as do their weights
            unsigned char* region = smem + rs * p.region_bytes;
            float sc[kGE], sh[kGE];
#pragma unroll
            for (int e = 0; e < kGE; ++e) {
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
              for (int i = 0; i < 4; ++i) v[i] = transform16<T>(v[i], sc, sh, p.slope);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int px = px0 + i * px_step;
                if (px >= n_px) break;
                *reinterpret_cast<uint4*>(region + swz(px * kRB + 16 * my_j)) = v[i];
                if (write_xn && p.xn_rows == 0) {  // owned by the tile of output pixel (ih / 2, iw / 2)
                  const int rr = w_shift >= 0 ? px >> w_shift : px / p.w, iw = px - rr * p.w;
                  const int row = t.p_lo + rr, n = h_shift >= 0 ? row >> h_shift : row / p.h, ih = row - n * p.h;
                  const int m_own = (n * OH + (ih >> 1)) * OW + (iw >> 1);
                  if (m_own >= t.m0 && m_own < t.m1)
                    *reinterpret_cast<uint4*>(xn_out + (static_cast<long long>(row) * p.w + iw) * p.c + ch) = v[i];
                }
              }
            }
          }
          // order this thread's writes before the TMA copies that read or refill the stage
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(r_ready(rs));
          if (p.xn_rows > 0) {
            // xn_out: the rows the tile owns leave by one TMA store. Whole output
            // rows per tile: output pixels [m0, m1) own input rows 2 * (m0 / OW)
            // onwards, a box of the transformed region (the store clips at N * H).
            asm volatile("bar.sync 2, %0;\n" ::"n"(32 * kTransformWarps) : "memory");
            if (tt == 0) {
              bulk_wait_read();  // the previous store has read its stage: it may be refilled
              if (pending_rs >= 0) mbar_arrive(r_empty(pending_rs));
              if (write_xn) {
                const int own_lo = 2 * (t.m0 / OW);
                tma_store(&tm_xn, sbase + rs * p.region_bytes + (own_lo - t.p_lo) * p.w * kRB, cc * kCK, 0, own_lo);
              }
            }
            pending_rs = rs;
          }
          if (++rs == kRegionStages) {
            rs = 0;
            rph ^= 1;
          }
        }
      }
      if (tt == 0 && p.xn_rows > 0) bulk_wait_all();
    }
  } else {
    // ---- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int row_in_tile = 64 * (warp >> 2) + 16 * (warp & 3);  // this warp's 16 rows
    // descriptor of weight stage 0; stage s adds s * wstage_bytes, k step kk
    // adds 32 bytes (16 bf16 or 8 f32 channels), the f32 low part wpart_bytes
    const uint64_t desc0 = smem_desc(wbase, 1, 8 * kRB);
    const uint32_t desc_stage = static_cast<uint32_t>(p.wstage_bytes) >> 4;
    const uint32_t desc_part = static_cast<uint32_t>(p.wpart_bytes) >> 4;
    int rs = 0, ws = 0;
    uint32_t rph = 0, wph = 0;
    float acc[BN / 2];
    float part[BN / 2];    // f32: the correction terms' accumulator (acc takes a_hi * b_hi)
    uint32_t af[2][4][4];  // A fragments of a tap's 4 k steps, double-buffered over taps
    uint32_t al[2][4][4];  // f32: their low TF32 parts (af keeps the high ones)

    auto release_w = [&](int s) {
      if (lane == 0) mbar_arrive(w_empty(s));
    };

    for (int u = u0; u < p.n_units; u += stride) {
      const Tile t = tile_of(u, p);
      // this lane's A row: byte offset of tap (0, 0) in the region, valid kh / kw bits
      int a_off = 0;
      uint32_t a_valid = 0;  // bits 0-3: kh valid, bits 4-7: kw valid
      {
        const int m = t.m0 + row_in_tile + (lane & 15);
        if (m < t.m1) {
          const int n = m / (OH * OW), r = m - n * (OH * OW), oh = r / OW, ow = r - oh * OW;
          a_off = ((n * p.h + 2 * oh - 1 - t.p_lo) * p.w + 2 * ow - 1) * kRB + 16 * (lane >> 4);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (2 * oh - 1 + k >= 0 && 2 * oh - 1 + k < p.h) a_valid |= 1u << k;
            if (2 * ow - 1 + k >= 0 && 2 * ow - 1 + k < p.w) a_valid |= 16u << k;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        acc[i] = 0.f;
        part[i] = 0.f;
      }
      int prev_ws = -1, buf = 0;

      // A of one tap into af[B] (4 ldmatrix; f32 splits it into af / al),
      // then its wgmmas on weight stage ws. f32: three TF32 products a k
      // step, the correction terms into part, a_hi * b_hi into acc.
      auto tap_mma = [&](auto bsel, uint32_t region_addr, int tap) {
        constexpr int B = decltype(bsel)::value;
        const int kh = tap >> 2, kw = tap & 3;
        const bool ok = ((a_valid >> kh) & (a_valid >> (4 + kw)) & 1u) != 0;
        const uint32_t a = ok ? region_addr + swz(static_cast<uint32_t>(a_off + (kh * p.w + kw) * kRB)) : zero_addr;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(af[B][kk], a ^ (32u * kk));
        if constexpr (kF32<T>) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) split_tf32(af[B][kk], al[B][kk]);
        }
        mbar_wait(w_full(ws), wph);
        const uint64_t desc = desc0 + static_cast<uint64_t>(ws * desc_stage);
        wgmma_fence();
        if constexpr (kF32<T>) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_tf32<BN>(part, al[B][kk], desc + 2 * kk, 1);
            wgmma_tf32<BN>(part, af[B][kk], desc + desc_part + 2 * kk, 1);
            wgmma_tf32<BN>(acc, af[B][kk], desc + 2 * kk, 1);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_rs<BN>(acc, af[B][kk], desc + 2 * kk, 1);
        }
        wgmma_commit();
      };

      for (int cc = 0; cc < chunks; ++cc) {
        mbar_wait(r_ready(rs), rph);
        const uint32_t region_addr = sbase + rs * p.region_bytes;
        for (int tap = 0; tap < 16; ++tap) {
          if (!((t.live >> tap) & 1u)) continue;
          if (buf == 0) {
            tap_mma(std::integral_constant<int, 0>{}, region_addr, tap);
          } else {
            tap_mma(std::integral_constant<int, 1>{}, region_addr, tap);
          }
          buf ^= 1;
          wgmma_wait<1>();  // the previous tap's wgmmas are done: free its stage
          if (prev_ws >= 0) release_w(prev_ws);
          prev_ws = ws;
          if (++ws == p.w_stages) {
            ws = 0;
            wph ^= 1;
          }
        }
        __syncwarp();  // this warp's ldmatrix reads of the region are done
        if (lane == 0) mbar_arrive(r_empty(rs));
        if (++rs == kRegionStages) {
          rs = 0;
          rph ^= 1;
        }
      }
      wgmma_wait<0>();
      if (prev_ws >= 0) release_w(prev_ws);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
      if constexpr (kF32<T>) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          asm volatile("" : "+f"(part[i])::"memory");
          acc[i] = __fadd_rn(acc[i], part[i]);
        }
      }

      // epilogue: fragment (row g / g + 8, columns 8j + 2q, +1) straight to out
      const int g = lane >> 2, q = lane & 3;
      const int r0 = t.m0 + row_in_tile + g;
      T* o = static_cast<T*>(p.out) + static_cast<long long>(r0) * p.cout + t.n0 + 2 * q;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (r0 < t.m1) store2(o + 8 * j, acc[4 * j], acc[4 * j + 1]);
        if (r0 + 8 < t.m1) store2(o + 8 * p.cout + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

template <typename T, int BN>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const CUtensorMap& tm_xn, const Params& p, int grid,
           int smem, cudaStream_t s) {
  const cudaError_t err =
      cudaFuncSetAttribute(fused_tma_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_tma_kernel<T, BN>
      <<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(smem), s>>>(tm_x, tm_w, tm_xn, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bn(int bn, const CUtensorMap& tm_x, const CUtensorMap& tm_w, const CUtensorMap& tm_xn, const Params& p,
              int grid, int smem, cudaStream_t s) {
  switch (bn) {
    case 16: return launch<T, 16>(tm_x, tm_w, tm_xn, p, grid, smem, s);
    case 32: return launch<T, 32>(tm_x, tm_w, tm_xn, p, grid, smem, s);
    case 64: return launch<T, 64>(tm_x, tm_w, tm_xn, p, grid, smem, s);
    case 96:  // bf16, Cout 96 or 192: whole tiles where 64 would triple the gathers
      if constexpr (!kF32<T>) return launch<T, 96>(tm_x, tm_w, tm_xn, p, grid, smem, s);
      return static_cast<int>(cudaErrorInvalidValue);
    case 128:
      if constexpr (!kF32<T>) return launch<T, 128>(tm_x, tm_w, tm_xn, p, grid, smem, s);
      return static_cast<int>(cudaErrorInvalidValue);
    case 192:
      if constexpr (!kF32<T>) return launch<T, 192>(tm_x, tm_w, tm_xn, p, grid, smem, s);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tma

}  // namespace

// The kernel, with the schedule planned on the host (dcvgan_torch/ops/
// fused_block.py: plan, tile_table). dtype: 0 = float32 (3xTF32 products;
// `w_split` is scratch of 2 * cout * 16 * c floats that receives the weight's
// TF32 parts first), 1 = bfloat16 (`w_split` unused). bn output channels per
// tile, w_stages weight stages, region_rows input rows per staged region,
// `tiles` the device copy of the n_units x kTileColumns int32 tile table,
// `grid` CTAs and `smem` bytes of dynamic shared memory. Returns
// cudaGetLastError(), -2 when `smem` is not this source's layout for the
// plan, -3 when libcuda has no cuTensorMapEncodeTiled, -4 when a tensor map
// is refused, -5 when region_rows is fewer than the rows a tile reads.
extern "C" int dcvgan_fused_norm_act_conv_tma(int dtype, const void* x, const void* scale, const void* shift,
                                              const void* w, void* w_split, void* out, void* xn_out, int n, int h,
                                              int w_in, int c, int cout, float slope, int bn, int w_stages,
                                              int region_rows, const void* tiles, int n_units, int grid, int smem,
                                              void* stream) {
  using namespace tma;
  const bool f32 = dtype == 0;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(xn_out) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(w_split);
  const int m_tiles = static_cast<int>((static_cast<long long>(n) * (h / 2) * (w_in / 2) + kBM - 1) / kBM);
  const int max_bn = f32 ? kMaxBN<float> : kMaxBN<bf16>;
  const bool ok = (dtype == 0 || dtype == 1) && c % (f32 ? 4 : 8) == 0 && (!f32 || w_split != nullptr) &&
                  bn >= 16 && bn <= max_bn && cout % bn == 0 && w_stages >= 1 && region_rows >= 1 &&
                  region_rows <= 256 && w_in <= 256 && n_units == m_tiles * (cout / bn) && grid >= 1 &&
                  grid <= n_units && tiles != nullptr && ptrs % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (region_rows < max_region_rows(n, h, w_in, kBM)) return -5;
  const Layout l = layout(w_in, bn, w_stages, region_rows, f32 ? kParts<float> : kParts<bf16>);
  if (l.total != smem) return -2;
  if (encode_tiled() == nullptr) return -3;
  const CUtensorMapDataType type = f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint32_t ck = static_cast<cuuint32_t>(f32 ? kCK<float> : kCK<bf16>);
  CUtensorMap tm_x, tm_w, tm_xn;
  // x as (C, W, N * H): a box is one chunk of channels of region_rows whole rows
  if (!encode_3d(&tm_x, type, x, {cuuint64_t(c), cuuint64_t(w_in), cuuint64_t(n) * h},
                 {c * es, cuuint64_t(w_in) * c * es}, {ck, cuuint32_t(w_in), cuuint32_t(region_rows)}))
    return -4;
  // w as (C, 16 taps, Cout): a box is one chunk of channels of one tap for bn
  // output channels; f32 reads the split scratch as (C, 16, 2 * Cout), the
  // high parts in rows [0, Cout) and the low parts in [Cout, 2 * Cout)
  if (!encode_3d(&tm_w, type, f32 ? w_split : w, {cuuint64_t(c), 16, cuuint64_t(cout) * (f32 ? 2 : 1)},
                 {c * es, 16 * c * es}, {ck, 1, cuuint32_t(bn)}))
    return -4;
  Params p;
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.out = out;
  p.xn_out = xn_out;
  p.tiles = static_cast<const int*>(tiles);
  p.n = n;
  p.h = h;
  p.w = w_in;
  p.c = c;
  p.cout = cout;
  p.slope = slope;
  p.w_stages = w_stages;
  p.region_rows = region_rows;
  p.region_bytes = l.region_bytes;
  p.wstage_bytes = l.wstage_bytes;
  p.wpart_bytes = l.wpart_bytes;
  p.zero_off = l.zero_off;
  p.bar_off = l.bar_off;
  p.n_units = n_units;
  // xn_out by TMA store when every tile starts on an output row (128 % OW == 0)
  // and its owned rows start 1024-byte aligned in the staged region (rows of
  // 8 or more pixels, or tiles of whole images)
  const int ow = w_in / 2, ohw = (h / 2) * ow;
  const bool rows_ok = kBM % ow == 0 && 2 * (kBM / ow) <= 256 && (w_in % 8 == 0 || kBM % ohw == 0);
  p.xn_rows = xn_out != nullptr && rows_ok ? 2 * (kBM / ow) : 0;
  tm_xn = tm_x;  // unused unless xn_rows > 0
  if (p.xn_rows > 0 &&
      !encode_3d(&tm_xn, type, xn_out, {cuuint64_t(c), cuuint64_t(w_in), cuuint64_t(n) * h},
                 {c * es, cuuint64_t(w_in) * c * es}, {ck, cuuint32_t(w_in), cuuint32_t(p.xn_rows)}))
    return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!f32) return launch_bn<bf16>(bn, tm_x, tm_w, tm_xn, p, grid, smem, s);
  const int numel = cout * 16 * c;
  const int blocks = (numel + 255) / 256 < 1024 ? (numel + 255) / 256 : 1024;
  split_tf32_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(w), static_cast<float*>(w_split), numel);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_bn<float>(bn, tm_x, tm_w, tm_xn, p, grid, smem, s);
}
