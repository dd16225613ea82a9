// The colour generator's outconv for Hopper (sm_90a): BatchNorm affine + ReLU,
// the U-Net skip and a ConvTranspose2d k3 s1 p1 to a few output channels,
//
//     out = conv_transpose2d(cat([relu(x * scale + shift), skip]), w, stride=1, padding=1)
//
// on NHWC bf16 activations, as one GEMM to tap partials and a 3x3 stencil sum:
//
//     A[q]       = cat(bf16(relu(x[q] * scale + shift)), skip[q])   (K channels of input pixel q)
//     T[q, t, c] = sum_k A[q, k] * W27[k, t * Cout + c]              (f32, all nine taps at once)
//     out[p, c]  = sum_t T[p + offset(t), t, c]                      (t = 0..8 in order, f32; one bf16 rounding)
//
// with offset(t) = (t / 3 - 1, t % 3 - 1) and W27[k, t * Cout + c] = w[k, c,
// 2 - t / 3, 2 - t % 3] (the flipped kernel of the transposed conv), its
// 9 * Cout columns padded to 16, 32, 64 or 96. Padding taps read zeros: a
// neighbour outside the image adds nothing. `scale`/`shift` are the previous
// stage's eval-mode BatchNorm folded per channel in f32, applied with a
// separate multiply and add and rounded to bf16 before the product, as the
// plain version (ops/fused_up.py: reference_norm_act_up_conv) computes it;
// NaN stays NaN. The sums run in a fixed order (no split-K, no atomics: the
// same inputs give the same bytes). The wrapper is ops/outconv.py, which
// ops/fused_up.py's k3s1 route calls; it plans the schedule by shape.
//
// It replaces no Pallas kernel: the JAX package leaves this conv to XLA.
//
// Bound: bytes. A pixel's K input channels are read once (256 bytes at 64 +
// 64, 384 at 96 + 96) and its Cout outputs written once (6 bytes at Cout 3);
// the products are 9 * Cout * K a pixel, 0.14 ms of the tensor cores at N =
// 4096 x 64 x 64 and K = 128 against 1.31 ms for the 4.3 GB. A design that
// multiplies per tap (nine 16-wide products a pixel with 3 live columns, the
// k4 s2 kernel of fused_up.cu with one phase) gathers each staged pixel nine
// times from shared memory: ~1.9 KB of shared-memory traffic per 128 bytes of
// input, above the byte bound before any barrier. Here each pixel's A row is
// gathered once, for all nine taps and every output channel: one wgmma
// m64nBNk16 per 16 channels of a 64-pixel image row, with W27 resident in
// shared memory for the CTA's whole walk; a k step past a channel run's end
// is skipped (runs of 96 take 6 of 16, not 8).
//
// Schedule. A CTA of 384 threads walks a contiguous range of image rows,
// balanced over the grid to within one row, across frames (one CTA per SM;
// 4096 frames of 64 rows on 132 SMs: 1,985 or 1,986 rows each). One producer
// thread loads each row once by TMA (x's 64-channel chunks, then the
// skip's) into a ring of row stages; two consumer warpgroups take alternate
// rows: ldmatrix each pixel's A once, apply the affine + ReLU to x's
// fragments in registers, run the products into f32 accumulators and write
// the row's partials to a ring of partial rows in shared memory. Three
// stencil warps turn three consecutive partial rows into an output row:
// each lane sums two outputs' nine taps, four lanes gather 16 bytes, so a
// row of 64 pixels x 3 channels leaves as 24 16-byte stores. A CTA whose
// range starts or ends inside a frame computes the partials of the one row
// beyond each end again, so every input row is read from device memory
// about once. Rows wider than the 64-pixel tile are cut into strips of 62
// output columns whose tiles overlap by one column a side.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kRB = 128;               // bytes of one staged pixel of a chunk: TMA's widest swizzle
constexpr int kCK = kRB / 2;           // channels a chunk: 64 bf16
constexpr int kTileW = 64;             // input columns a row's GEMM takes: one m64 tile
constexpr int kStrip = kTileW - 2;     // output columns a strip of a row wider than the tile
constexpr int kSlotCols = kTileW + 2;  // a partial row's columns: local -1 .. 64 (the ends stay 0)
constexpr int kConsumers = 256;        // two warpgroups, alternate rows
constexpr int kStencilWarps = 3;
constexpr int kStencilLanes = 32 * kStencilWarps;
constexpr int kThreads = kConsumers + 32 + kStencilLanes;  // consumers, the producer warp, the stencil warps
constexpr int kMaxCout = 8;

struct Params {
  const float* scale;
  const float* shift;
  bf16* out;
  int h, w, c1, c2, cout;
  int chunks1, chunks;  // x's 64-channel chunks; x's and the skip's
  int strips, box_w;    // column strips a row; staged columns a chunk
  int rows;             // image rows x strips: the walk's rows (n * strips * h)
  int stages, slots;    // row stages; partial rows
  int chunk_bytes, stage_bytes, slot_bytes;
  int w_off, p_off, ss_off, bar_off;  // byte offsets in shared memory
};

// The shared-memory layout from a 1024-byte aligned base: [row stage x
// stages: chunk x chunks][W27: chunk x chunks, BN rows of 128 bytes][partial
// row x slots][scale, shift: 64 * chunks1 floats each][mbarriers]; `total`
// includes 1024 bytes of slack for aligning the base.
struct Layout {
  int chunk_bytes, stage_bytes, w_off, slot_bytes, p_off, ss_off, bar_off, total;
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

inline Layout layout(int box_w, int chunks, int chunks1, int bn, int stages, int slots) {
  Layout l;
  l.chunk_bytes = round_up(box_w * kRB, 1024);
  l.stage_bytes = chunks * l.chunk_bytes;
  l.w_off = stages * l.stage_bytes;
  l.p_off = l.w_off + chunks * bn * kRB;
  l.slot_bytes = kSlotCols * (bn + 8) * 4;
  l.ss_off = l.p_off + slots * l.slot_bytes;
  l.bar_off = l.ss_off + 2 * 4 * kCK * chunks1;
  l.total = 1024 + l.bar_off + 8 * 2 * (stages + slots);
  return l;
}

// W27's columns, 9 * Cout, padded to a wgmma width
inline int tap_columns(int cout) {
  const int n = 9 * cout;
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 96;
}

// The prologue on one register of an A fragment (two neighbouring channels):
// relu(v * scale + shift) with a separate multiply and add, rounded to bf16.
// NaN stays NaN, as under F.relu.
__device__ __forceinline__ uint32_t affine_relu2(uint32_t v, float2 sc, float2 sh) {
  float lo = __fadd_rn(__fmul_rn(__uint_as_float(v << 16), sc.x), sh.x);
  float hi = __fadd_rn(__fmul_rn(__uint_as_float(v & 0xffff0000u), sc.y), sh.y);
  lo = lo < 0.f ? 0.f : lo;
  hi = hi < 0.f ? 0.f : hi;
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// A position in a ring of `size` buffers that a walk's rows take in turn:
// the buffer of the current row and the parity of its use (its mbarrier's
// phase), advanced without a division.
struct Ring {
  int index, phase;
  __device__ Ring(int first, int size) : index(first % size), phase((first / size) & 1) {}
  __device__ void step(int by, int size) {
    index += by;
    if (index >= size) {
      index -= size;
      phase ^= 1;
    }
  }
};

// BN: W27's padded columns (tap_columns(Cout)), the wgmma's N. C1, C2, COUT:
// the serving shapes' channel counts as compile-time constants, or 0 for the
// runtime values of any shape. With them every k step's presence is known
// at compile time, so the wgmmas of a row issue back to back; the runtime
// instance's k steps past a run's end are skipped by branches, around which
// ptxas serializes the wgmmas (C7520).
template <int BN, int C1, int C2, int COUT>
__global__ void __launch_bounds__(kThreads, 1)
    outconv_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_s,
                   const bf16* __restrict__ w27, const Params p) {
  constexpr int PS = BN + 8;  // floats a pixel's partials take: conflict-free float2 writes
  constexpr bool kFixed = C1 > 0;
  constexpr int kChunks1 = (C1 + kCK - 1) / kCK, kChunks = kChunks1 + (C2 + kCK - 1) / kCK;
  const int c1 = kFixed ? C1 : p.c1, c2 = kFixed ? C2 : p.c2, cout = COUT ? COUT : p.cout;
  const int chunks1 = kFixed ? kChunks1 : p.chunks1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(smem);
  float* part = reinterpret_cast<float*>(smem + p.p_off);
  float* s_scale = reinterpret_cast<float*>(smem + p.ss_off);
  float* s_shift = s_scale + kCK * chunks1;
  const uint32_t bars = sbase + p.bar_off;
  auto in_full = [&](int s) { return bars + 8 * s; };                // a row's chunks copied
  auto in_empty = [&](int s) { return bars + 8 * (p.stages + s); };  // its GEMM done with them
  auto p_full = [&](int s) { return bars + 8 * (2 * p.stages + s); };            // partials written
  auto p_empty = [&](int s) { return bars + 8 * (2 * p.stages + p.slots + s); };  // no output needs them
  const int slot_floats = p.slot_bytes / 4;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // once a CTA: W27 into its K-major swizzled tiles (one per chunk), scale and
  // shift with zeros past c1 (a k step's channels past the run stay 0), and
  // the partial rows zeroed: their end columns are never written again
  for (int i = tid; i < p.chunks * BN * 8; i += kThreads) {
    const int row = i >> 3, cc = row / BN;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(w27) + i);
    *reinterpret_cast<uint4*>(smem + p.w_off + cc * BN * kRB + swz((row - cc * BN) * kRB + 16 * (i & 7))) = v;
  }
  for (int i = tid; i < kCK * chunks1; i += kThreads) {
    s_scale[i] = i < c1 ? __ldg(p.scale + i) : 0.f;
    s_shift[i] = i < c1 ? __ldg(p.shift + i) : 0.f;
  }
  for (int i = tid; i < p.slots * p.slot_bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(part)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(in_full(s), 1);
      mbar_init(in_empty(s), 4);  // the warps of the warpgroup that took the row
    }
    for (int s = 0; s < p.slots; ++s) {
      mbar_init(p_full(s), 4);
      mbar_init(p_empty(s), kStencilWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // W27's generic-proxy writes before the wgmmas read it through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // This CTA's output rows [g0, g1) of the walk's rows (frame, strip, y), y
  // fastest, and the rows whose partials it computes, [lo, hi]: one more a
  // side where its range starts or ends inside a frame.
  const int g0 = static_cast<int>(static_cast<long long>(blockIdx.x) * p.rows / gridDim.x);
  const int g1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * p.rows / gridDim.x);
  const int lo = g0 % p.h != 0 ? g0 - 1 : g0;
  const int hi = (g1 - 1) % p.h != p.h - 1 ? g1 : g1 - 1;
  const int nrows = hi - lo + 1;

  if (warp < kConsumers / 32) {
    // ---- consumers: warpgroup wg takes walk rows wg, wg + 2, ...
    const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, cq = lane & 3;
    // this lane's ldmatrix row: column m of the staged row (a column past the
    // staged box reads column 0; its partials are written as 0)
    const int m = 16 * wq + (lane & 15);
    const uint32_t a_off = swz(static_cast<uint32_t>((m < p.box_w ? m : 0) * kRB + 16 * (lane >> 4)));
    // descriptor of W27's chunk 0; chunk cc adds cc * BN * 128 bytes, k step kk 32 bytes
    const uint64_t desc0 = smem_desc(sbase + p.w_off, 1, 8 * kRB);
    float acc[BN / 2];
    uint32_t af[2][4][4];  // A fragments of one chunk's 4 k steps, two chunks in flight
    Ring stage_of(wg, p.stages), slot_of(wg, p.slots);  // walk row i's row stage and partial row

    for (int i = wg; i < nrows; i += 2, stage_of.step(2, p.stages), slot_of.step(2, p.slots)) {
      const int s = stage_of.index;
      mbar_wait(in_full(s), stage_of.phase);
      const uint32_t stage = sbase + s * p.stage_bytes;
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
      // one chunk: gather, the prologue on x's fragments, the products
      auto chunk = [&](uint32_t(&fa)[4][4], int cc) {
        wgmma_wait<1>();  // the group that last read fa is done (the newest reads the other buffer)
        const bool is_x = cc < chunks1;
        const int live = is_x ? c1 - cc * kCK : c2 - (cc - chunks1) * kCK;
        const int nk = min(4, (live + 15) / 16);  // k steps that hold some of the run
        const uint32_t a = stage + cc * p.chunk_bytes + a_off;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < nk) ldmatrix_x4(fa[kk], a ^ (32u * kk));
        if (is_x) {
          // fragment register r holds row g (+ 8 for odd r), channels
          // 16 kk + 8 (r >> 1) + 2 cq and the next
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (kk >= nk) continue;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int ch = cc * kCK + 16 * kk + 8 * (r >> 1) + 2 * cq;
              fa[kk][r] = affine_relu2(fa[kk][r], *reinterpret_cast<const float2*>(s_scale + ch),
                                       *reinterpret_cast<const float2*>(s_shift + ch));
            }
          }
        }
        wgmma_fence();
        const uint64_t desc = desc0 + static_cast<uint64_t>((cc * BN * kRB) >> 4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < nk) wgmma_rs<BN>(acc, fa[kk], desc + 2 * kk, 1);
        wgmma_commit();
      };
      if constexpr (kFixed) {
#pragma unroll
        for (int cc = 0; cc < kChunks; ++cc) chunk(af[cc & 1], cc);
      } else {
#pragma unroll 1
        for (int cc = 0; cc < p.chunks; cc += 2) {
          chunk(af[0], cc);
          if (cc + 1 < p.chunks) chunk(af[1], cc + 1);
        }
      }
      wgmma_wait<0>();
      __syncwarp();  // this warp's ldmatrix reads of the stage are done
      if (lane == 0) mbar_arrive(in_empty(s));

      // the row's partials: local column j is image column xs + j; columns
      // outside the image are written as 0 (padding)
      const int slot = slot_of.index;
      if (i >= p.slots) mbar_wait(p_empty(slot), slot_of.phase ^ 1);
      const int xs = p.strips == 1 ? 0 : (lo + i) / p.h % p.strips * kStrip - 1;
      float* prow = part + slot * slot_floats;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = 16 * wq + g + 8 * hh;
        const bool in = xs + col >= 0 && xs + col < p.w;
        float* dst = prow + (col + 1) * PS + 2 * cq;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          *reinterpret_cast<float2*>(dst + 8 * j) =
              in ? make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]) : make_float2(0.f, 0.f);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(p_full(slot));
    }
  } else if (warp == kConsumers / 32) {
    // ---- producer: one thread loads each walk row's chunks into the next free stage
    if (lane == 0) {
      const uint32_t row_tx = static_cast<uint32_t>(p.chunks * p.box_w * kRB);
      int y = lo % p.h, fs = lo / p.h;  // walk row lo + i is row y of frame-strip fs
      Ring stage_of(0, p.stages);
      for (int i = 0; i < nrows; ++i, stage_of.step(1, p.stages)) {
        const int s = stage_of.index;
        if (i >= p.stages) mbar_wait(in_empty(s), stage_of.phase ^ 1);
        const int frame = p.strips == 1 ? fs : fs / p.strips, strip = fs - frame * p.strips;
        const int x0 = p.strips == 1 ? 0 : strip * kStrip - 1;  // -1: TMA fills the column left of the image with 0
        const uint32_t dst = sbase + s * p.stage_bytes;
        mbar_expect_tx(in_full(s), row_tx);
        for (int cc = 0; cc < p.chunks; ++cc) {
          if (cc < chunks1) {
            tma_load(dst + cc * p.chunk_bytes, &tm_x, in_full(s), cc * kCK, x0, frame * p.h + y);
          } else {
            tma_load(dst + cc * p.chunk_bytes, &tm_s, in_full(s), (cc - chunks1) * kCK, x0, frame * p.h + y);
          }
        }
        if (++y == p.h) {
          y = 0;
          ++fs;
        }
      }
    }
  } else {
    // ---- stencil warps: an output row from the partials of its row and the
    // rows above and below in its frame. Lane sl of the three warps sums the
    // outputs 2 sl and 2 sl + 1 of the row (then + 192, ...), nine taps each
    // in tap order; four lanes' pairs leave as one 16-byte store.
    const int sl = (warp - kConsumers / 32 - 1) * 32 + lane;
    const bool vec = p.strips == 1 && (p.w * cout) % 8 == 0;  // 16-byte aligned rows
    const int lc0 = p.strips == 1 ? 0 : 1;                   // local column of a strip's first output column
    int tap_off[9];  // tap t's partial, from the entry of the output's left neighbour's column
#pragma unroll
    for (int t = 0; t < 9; ++t) tap_off[t] = (t % 3) * PS + t * cout;
    // output row y of frame-strip fs from the partial rows in slots sm (the
    // row above: read only if y > 0), s0 and sp (below: only if y < h - 1)
    auto emit = [&](int y, int fs, int sm, int s0, int sp) {
      const int frame = p.strips == 1 ? fs : fs / p.strips, strip = fs - frame * p.strips;
      const int ox0 = strip * kStrip;
      const int ox1 = p.strips == 1 ? p.w : min(p.w, ox0 + kStrip);
      const bool up = y > 0, down = y < p.h - 1;
      const float* rows[3] = {part + sm * slot_floats, part + s0 * slot_floats, part + sp * slot_floats};
      const int e_row = (ox1 - ox0) * cout;
      bf16* orow = p.out + ((static_cast<long long>(frame) * p.h + y) * p.w + ox0) * cout;
      for (int e0 = 2 * sl; e0 - 2 * sl < e_row; e0 += 2 * kStencilLanes) {  // the same trip count in every lane
        float r[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          r[e] = 0.f;
          const int el = e0 + e;
          if (el >= e_row) continue;
          const int px = el / cout;
          const int base = (lc0 + px) * PS + el - px * cout;  // the left neighbour's entry, tap column c
          float sum = 0.f;
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const int dy = t / 3 - 1;
            if ((dy < 0 && !up) || (dy > 0 && !down)) continue;
            sum += rows[dy + 1][base + tap_off[t]];
          }
          r[e] = sum;
        }
        const __nv_bfloat162 pr = __floats2bfloat162_rn(r[0], r[1]);
        const uint32_t pk = *reinterpret_cast<const uint32_t*>(&pr);
        if (vec) {
          const uint32_t p1 = __shfl_down_sync(0xffffffffu, pk, 1);
          const uint32_t p2 = __shfl_down_sync(0xffffffffu, pk, 2);
          const uint32_t p3 = __shfl_down_sync(0xffffffffu, pk, 3);
          if ((lane & 3) == 0 && e0 < e_row) *reinterpret_cast<uint4*>(orow + e0) = make_uint4(pk, p1, p2, p3);
        } else {
          if (e0 < e_row) orow[e0] = pr.x;
          if (e0 + 1 < e_row) orow[e0 + 1] = pr.y;
        }
      }
    };
    int y = lo % p.h, fs = lo / p.h;  // walk row lo + i is row y of frame-strip fs
    Ring slot_of(0, p.slots);
    int s1 = 0, s2 = 0;  // the slots of walk rows i - 1 and i - 2
    for (int i = 0; i < nrows; ++i, slot_of.step(1, p.slots)) {
      const int v = lo + i, s0 = slot_of.index;
      mbar_wait(p_full(s0), slot_of.phase);
      if (y != 0 && v - 1 >= g0) emit(y - 1, fs, s2, s1, s0);      // the row above is complete
      if (y == p.h - 1 && v >= g0 && v < g1) emit(y, fs, s1, s0, s0);  // the frame's last row
      // no later output reads the partials of walk row i - 2
      if (i >= 2) {
        __syncwarp();
        if (lane == 0) mbar_arrive(p_empty(s2));
      }
      s2 = s1;
      s1 = s0;
      if (++y == p.h) {
        y = 0;
        ++fs;
      }
    }
  }
}

template <int BN, int C1 = 0, int C2 = 0, int COUT = 0>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_s, const void* w27, const Params& p, int grid, int smem,
           cudaStream_t s) {
  auto* kernel = outconv_kernel<BN, C1, C2, COUT>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(smem), s>>>(
      tm_x, tm_s, static_cast<const bf16*>(w27), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (n, h, w, c1) and skip (n, h, w, c2, or null with c2 = 0) NHWC bf16;
// scale, shift (c1,) float32; w27 the packed weight (chunks, BN, 64) bf16:
// chunk cc, column t * cout + c, channel j is W27[64 cc + j, t * cout + c]
// with x's channels in chunks [0, ceil(c1 / 64)) and the skip's after (zeros
// past each run and past 9 * cout), BN = 9 * cout padded to 16, 32, 64 or
// 96; out (n, h, w, cout) bf16. `stages` row stages, `slots` partial rows,
// `grid` CTAs and `smem` bytes of dynamic shared memory are the wrapper's
// plan (ops/outconv.py). Launches on `stream`; returns cudaGetLastError(),
// -2 when `smem` is not this source's layout for the plan, -3 when libcuda
// has no cuTensorMapEncodeTiled, -4 when a tensor map is refused.
int dcvgan_outconv(const void* x, const void* skip, const void* scale, const void* shift, const void* w27,
                   void* out, int n, int h, int w, int c1, int c2, int cout, int stages, int slots, int grid,
                   int smem, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(skip) |
                         reinterpret_cast<uintptr_t>(w27) | reinterpret_cast<uintptr_t>(out);
  const int strips = w <= kTileW ? 1 : (w + kStrip - 1) / kStrip;
  const long long rows = static_cast<long long>(n) * strips * h;
  const bool ok = n >= 1 && h >= 1 && w >= 1 && w <= 256 && c1 > 0 && c1 % 8 == 0 && c2 >= 0 && c2 % 8 == 0 &&
                  (c2 == 0) == (skip == nullptr) && cout >= 1 && cout <= kMaxCout && stages >= 2 && slots >= 4 &&
                  grid >= 1 && grid <= rows && rows < (1ll << 31) && ptrs % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks1 = (c1 + kCK - 1) / kCK, chunks = chunks1 + (c2 + kCK - 1) / kCK;
  const int box_w = w < kTileW ? w : kTileW;
  const int bn = tap_columns(cout);
  const Layout l = layout(box_w, chunks, chunks1, bn, stages, slots);
  if (l.total != smem) return -2;
  if (encode_tiled() == nullptr) return -3;
  const CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tm_x, tm_s;
  // x and skip as (C, W, N * H): a box is one chunk of channels of box_w columns of one row
  const cuuint64_t img_rows = static_cast<cuuint64_t>(n) * h;
  const cuuint32_t box[3] = {kCK, static_cast<cuuint32_t>(box_w), 1};
  if (!encode_3d(&tm_x, type, x, {cuuint64_t(c1), cuuint64_t(w), img_rows},
                 {cuuint64_t(c1) * 2, cuuint64_t(w) * c1 * 2}, box))
    return -4;
  tm_s = tm_x;  // unused without a skip
  if (c2 > 0 && !encode_3d(&tm_s, type, skip, {cuuint64_t(c2), cuuint64_t(w), img_rows},
                           {cuuint64_t(c2) * 2, cuuint64_t(w) * c2 * 2}, box))
    return -4;
  Params p;
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.out = static_cast<bf16*>(out);
  p.h = h;
  p.w = w;
  p.c1 = c1;
  p.c2 = c2;
  p.cout = cout;
  p.chunks1 = chunks1;
  p.chunks = chunks;
  p.strips = strips;
  p.box_w = box_w;
  p.rows = static_cast<int>(rows);
  p.stages = stages;
  p.slots = slots;
  p.chunk_bytes = l.chunk_bytes;
  p.stage_bytes = l.stage_bytes;
  p.slot_bytes = l.slot_bytes;
  p.w_off = l.w_off;
  p.p_off = l.p_off;
  p.ss_off = l.ss_off;
  p.bar_off = l.bar_off;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the colour generator's outconv at ngf 64 and 96
  if (c1 == 64 && c2 == 64 && cout == 3) return launch<32, 64, 64, 3>(tm_x, tm_s, w27, p, grid, smem, s);
  if (c1 == 96 && c2 == 96 && cout == 3) return launch<32, 96, 96, 3>(tm_x, tm_s, w27, p, grid, smem, s);
  switch (bn) {
    case 16: return launch<16>(tm_x, tm_s, w27, p, grid, smem, s);
    case 32: return launch<32>(tm_x, tm_s, w27, p, grid, smem, s);
    case 64: return launch<64>(tm_x, tm_s, w27, p, grid, smem, s);
    default: return launch<96>(tm_x, tm_s, w27, p, grid, smem, s);
  }
}

}  // extern "C"
