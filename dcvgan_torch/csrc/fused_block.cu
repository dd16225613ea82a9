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
// Design: an implicit GEMM. M = N*OH*OW output pixels, N_gemm = Cout and
// K = 16*C in (kh, kw, c) order, which is the memory order of a channels-last
// torch Conv2d weight (Cout, C, 4, 4): the weight is read as a row-major
// Cout x K matrix with no repacking. The TPU kernel's column pairing and
// 12-slab weight packing were a Mosaic workaround and have no counterpart.
// A padded tap contributes 0, not leaky_relu(shift): zero padding applies to
// the activation. Each input pixel's activation is written to xn_out once, by
// the block that owns output pixel (ih/2, iw/2), on the first Cout tile; the
// stored value is the one fed to the product.
//
// bf16 (the serving path) -- see the bf16 section below: 256 x 128 output
// tiles, 16-channel slices of the input rows staged once per slice (so the
// prologue runs once per input element and tile, not once per tap), weights
// of all 16 taps of a slice staged beside them, cp.async double buffering,
// mma.sync m16n8k16 with f32 accumulators on ldmatrix-gathered fragments,
// and the output tile written through shared memory with 16-byte stores.
// f32: 128 x 128 tiles with the patches staged through registers and FMA on
// the CUDA cores (the f32 reference path runs in full f32, so no TF32).
//
// What bounds it on an H100: at the flagship shapes (bf16, N = 4096 frames)
// the first site (32x32x64 -> 16x16x128) must move about 1.3 GB for
// 0.26 TFLOP and is bound by memory; the deeper sites do 2-4x more operations
// per byte and are bound by the tensor cores. This design reads x from device
// memory about once and writes only the output and the skip, but re-reads
// the weights from L2 for every 256-pixel tile and runs on mma.sync, which
// reaches a fraction of the wgmma peak; it stays well above the bound (times
// in PERF.md). Weight multicast across a cluster, TMA and wgmma are the next
// steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBN = 128;  // output channels per block

struct Args {
  const void* x;
  const float* scale;
  const float* shift;
  const void* w;
  void* out;
  void* xn_out;  // may be null
  int n, h, w_in, c, cout;
  float slope;
  int vec_ok;  // channel count and pointers allow 16-byte vector access
};

// One 16-byte vector of elements.
template <typename T>
struct __align__(16) Vec {
  T e[16 / sizeof(T)];
  __device__ __forceinline__ uint4& bits() { return *reinterpret_cast<uint4*>(e); }
};

__device__ __forceinline__ float act(float v, float scale, float shift, float slope) {
  // separate multiply and add (no FMA contraction), as the plain version computes
  const float f = __fadd_rn(__fmul_rn(v, scale), shift);
  return f >= 0.f ? f : __fmul_rn(f, slope);
}

// ---------------------------------------------------------------- bf16 ----
//
// A block of 512 threads owns 256 output pixels x 128 output channels and
// walks the input channels in 16-channel slices. While slice s multiplies,
// cp.async copies into the other half of a double buffer the slab of input
// rows the block's pixels read for slice s + 1 (the "region": contiguous in
// NHWC memory) and that slice's weights for all 16 taps; halfway through
// slice s's taps each thread applies the prologue, in place, to the chunks it
// copied. After the slice's one barrier the 16 warps (4 x 4, 64 x 32 each)
// run the 16 taps, gathering each tap's A fragments from the region by
// ldmatrix row addresses; a padded tap points at a zero row.

constexpr int kThreadsB = 512;
constexpr int kBMB = 256;                      // output pixels per block
constexpr int kBKB = 16;                       // channels per slice
constexpr int kBTileBytes = kBN * kBKB * 2;    // one tap's weights for a slice: 4 KB
constexpr int kBSlabBytes = 16 * kBTileBytes;  // all 16 taps: 64 KB
constexpr int kLdOut = kBN + 8;                // staged output row stride (272 B)

// Shared-memory slot (16 bytes) of half h of row p in a tile of 32-byte rows,
// XOR-swizzled within each 128-byte group so that ldmatrix reads of rows
// r, r+1, ..., r+7 or r, r+2, ..., r+14 hit eight different bank groups.
__device__ __forceinline__ int slot(int p, int h) {
  return (p >> 2) * 8 + ((((p & 3) << 1) | h) ^ ((p >> 2) & 3));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// First and last flattened input row (n * H + ih) read by output pixels [m0, m1).
__host__ __device__ inline void region_rows(int m0, int m1, int H, int OH, int OW, int& lo, int& hi) {
  const int q0 = m0 / OW, q1 = (m1 - 1) / OW;  // flattened output rows
  const int n0 = q0 / OH, oh0 = q0 % OH, n1 = q1 / OH, oh1 = q1 % OH;
  lo = n0 * H + (oh0 > 0 ? 2 * oh0 - 1 : 0);
  hi = n1 * H + (2 * oh1 + 2 < H ? 2 * oh1 + 2 : H - 1);
}

__global__ void __launch_bounds__(kThreadsB, 1) fused_bf16_kernel(const Args a, int region_cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  // [weights 0][weights 1][region 0][region 1][zero row][scale][shift]
  unsigned char* slabs = smem;
  unsigned char* regions = slabs + 2 * kBSlabBytes;
  const int region_bytes = ((region_cap + 3) / 4) * 128;
  unsigned char* zero_row = regions + 2 * region_bytes;
  float* s_scale = reinterpret_cast<float*>(zero_row + 32);
  float* s_shift = s_scale + a.c;

  const bf16* __restrict__ x = static_cast<const bf16*>(a.x);
  const bf16* __restrict__ w = static_cast<const bf16*>(a.w);
  bf16* __restrict__ xn_out = static_cast<bf16*>(a.xn_out);
  bf16* __restrict__ out = static_cast<bf16*>(a.out);
  const int Cin = a.c, Cout = a.cout, K = 16 * Cin, H = a.h, W = a.w_in;
  const int OH = H / 2, OW = W / 2, M = a.n * OH * OW;
  const int n_tiles = (Cout + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / n_tiles) * kBMB;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int m1 = min(m0 + kBMB, M);
  const int tid = threadIdx.x;
  const bool vec_ok = a.vec_ok != 0;
  const bool write_xn = xn_out != nullptr && n0 == 0;

  int p_lo, p_hi;
  region_rows(m0, m1, H, OH, OW, p_lo, p_hi);
  const int region_px = (p_hi - p_lo + 1) * W;  // <= region_cap
  const long long region_base = static_cast<long long>(p_lo) * W;  // first pixel

  for (int i = tid; i < Cin; i += kThreadsB) {
    s_scale[i] = a.scale[i];
    s_shift[i] = a.shift[i];
  }
  if (tid < 8) reinterpret_cast<uint32_t*>(zero_row)[tid] = 0u;

  const int slices = (Cin + kBKB - 1) / kBKB;

  // The raw 16-channel slice `s` of the region: pixel chunks of 8 channels.
  auto copy_region = [&](int s) {
    unsigned char* dst = regions + (s & 1) * region_bytes;
    const int c0 = s * kBKB;
    for (int idx = tid; idx < 2 * region_px; idx += kThreadsB) {
      const int p = idx >> 1, h = idx & 1, c = c0 + 8 * h;
      const long long off = (region_base + p) * Cin + c;
      unsigned char* d = dst + slot(p, h) * 16;
      if (vec_ok) {
        cp_async16(d, c < Cin ? x + off : x, c < Cin ? 16 : 0);
      } else {
        bf16* de = reinterpret_cast<bf16*>(d);
        for (int e = 0; e < 8; ++e) de[e] = c + e < Cin ? x[off + e] : __float2bfloat16_rn(0.f);
      }
    }
  };

  // Region pixel p -> (row in region, column): a shift when W is a power of two.
  const int w_shift = (W & (W - 1)) == 0 ? __ffs(W) - 1 : -1;

  // The prologue, in place, on the chunks of slice `s` this thread copied;
  // the owner of each input pixel also writes it to xn_out.
  auto transform_region = [&](int s) {
    unsigned char* dst = regions + (s & 1) * region_bytes;
    const int c0 = s * kBKB;
    for (int idx = tid; idx < 2 * region_px; idx += kThreadsB) {
      const int p = idx >> 1, h = idx & 1, c = c0 + 8 * h;
      if (c >= Cin) continue;  // channels past C stay 0
      Vec<bf16>* q = reinterpret_cast<Vec<bf16>*>(dst + slot(p, h) * 16);
      Vec<bf16> v = *q;
      if (c + 8 <= Cin && (Cin & 3) == 0) {  // float4 reads of scale and shift
        const float4* sc = reinterpret_cast<const float4*>(s_scale + c);
        const float4* sh = reinterpret_cast<const float4*>(s_shift + c);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 a4 = sc[j], b4 = sh[j];
          const int e = 4 * j;
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(v.e + e);
          o[0] = __floats2bfloat162_rn(act(__bfloat162float(v.e[e]), a4.x, b4.x, a.slope),
                                       act(__bfloat162float(v.e[e + 1]), a4.y, b4.y, a.slope));
          o[1] = __floats2bfloat162_rn(act(__bfloat162float(v.e[e + 2]), a4.z, b4.z, a.slope),
                                       act(__bfloat162float(v.e[e + 3]), a4.w, b4.w, a.slope));
        }
      } else {
        for (int e = 0; e < 8; ++e) {
          const int ch = c + e;
          const float f = ch < Cin ? act(__bfloat162float(v.e[e]), s_scale[ch], s_shift[ch], a.slope) : 0.f;
          v.e[e] = __float2bfloat16_rn(f);
        }
      }
      *q = v;
      if (write_xn) {
        // owned by the block of output pixel (ih / 2, iw / 2)
        const int rr = w_shift >= 0 ? p >> w_shift : p / W, iw = p - rr * W;
        const int row = p_lo + rr, n = row / H, ih = row - n * H;  // row = n * H + ih
        const int m_own = (n * OH + ih / 2) * OW + iw / 2;
        if (m_own >= m0 && m_own < m1) {
          const long long off = (region_base + p) * Cin + c;
          if (vec_ok) {
            *reinterpret_cast<uint4*>(xn_out + off) = v.bits();
          } else {
            for (int e = 0; e < 8 && c + e < Cin; ++e) xn_out[off + e] = v.e[e];
          }
        }
      }
    }
  };

  // The weights of slice `s` for all 16 taps: per tap 128 rows of 16 channels.
  auto copy_weights = [&](int s) {
    unsigned char* dst = slabs + (s & 1) * kBSlabBytes;
    for (int idx = tid; idx < 16 * 2 * kBN; idx += kThreadsB) {
      const int tap = idx / (2 * kBN), r = (idx >> 1) % kBN, h = idx & 1;
      const int c = s * kBKB + 8 * h, co = n0 + r;
      const bool ok = co < Cout && c < Cin;
      const long long off = static_cast<long long>(co) * K + tap * Cin + c;
      unsigned char* d = dst + tap * kBTileBytes + slot(r, h) * 16;
      if (vec_ok) {
        cp_async16(d, ok ? w + off : w, ok ? 16 : 0);
      } else {
        bf16* de = reinterpret_cast<bf16*>(d);
        for (int e = 0; e < 8; ++e) de[e] = ok && c + e < Cin ? w[off + e] : __float2bfloat16_rn(0.f);
      }
    }
  };

  // Per lane: the 4 A rows it addresses for ldmatrix, as region pixel of tap
  // (0, 0) plus bit masks of the valid kh and kw.
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp % 4) * 64, wn = (warp / 4) * 32;
  const int half = lane >> 4;
  int a_base[4];
  uint32_t a_valid[4];  // bits 0-3: kh valid, bits 4-7: kw valid
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int m = m0 + wm + mi * 16 + (lane & 15);
    const int mm = m < M ? m : 0;
    const int n = mm / (OH * OW), r = mm % (OH * OW), oh = r / OW, ow = r % OW;
    a_base[mi] = (n * H + 2 * oh - 1 - p_lo) * W + 2 * ow - 1;
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (2 * oh - 1 + k >= 0 && 2 * oh - 1 + k < H) v |= 1u << k;
      if (2 * ow - 1 + k >= 0 && 2 * ow - 1 + k < W) v |= 16u << k;
    }
    a_valid[mi] = m < M ? v : 0u;
  }
  const uint32_t zero_addr = static_cast<uint32_t>(__cvta_generic_to_shared(zero_row)) + 16 * half;
  const uint32_t slab_addr = static_cast<uint32_t>(__cvta_generic_to_shared(slabs));
  const uint32_t region_addr = static_cast<uint32_t>(__cvta_generic_to_shared(regions));
  const int b_row = wn + (lane & 7) + ((lane >> 4) << 3);
  const int b_half = (lane >> 3) & 1;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Slice s + 1 is copied while slice s multiplies; each thread transforms its
  // own chunks of slice s + 1 halfway through slice s's taps, so the prologue
  // of some warps overlaps the MMAs of others. One barrier per slice.
  copy_region(0);
  copy_weights(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // scale, shift and the zero row are in shared memory
  transform_region(0);
  __syncthreads();

  auto mma_taps = [&](int s, int tap0) {
    const uint32_t reg = region_addr + (s & 1) * region_bytes;
    const uint32_t slab = slab_addr + (s & 1) * kBSlabBytes;
#pragma unroll 4
    for (int tap = tap0; tap < tap0 + 8; ++tap) {
      const int kh = tap >> 2, kw = tap & 3;
      uint32_t af[4][4], bfrag[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const bool ok = ((a_valid[mi] >> kh) & (a_valid[mi] >> (4 + kw)) & 1u) != 0;
        const int p = a_base[mi] + kh * W + kw;
        ldmatrix_x4(af[mi], ok ? reg + slot(p, half) * 16 : zero_addr);
      }
      const uint32_t bt = slab + tap * kBTileBytes;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t r[4];
        ldmatrix_x4(r, bt + slot(b_row + q * 16, b_half) * 16);
        bfrag[2 * q][0] = r[0];
        bfrag[2 * q][1] = r[1];
        bfrag[2 * q + 1][0] = r[2];
        bfrag[2 * q + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfrag[ni]);
    }
  };

  for (int s = 0; s < slices; ++s) {
    const bool next = s + 1 < slices;
    if (next) {  // the buffers of slice s - 1 were freed by the last barrier
      copy_region(s + 1);
      copy_weights(s + 1);
    }
    cp_async_commit();
    mma_taps(s, 0);
    if (next) {
      cp_async_wait<0>();  // this thread's copies of slice s + 1 have landed
      transform_region(s + 1);
    }
    mma_taps(s, 8);
    __syncthreads();  // slice s + 1 is ready; the buffers of slice s are free
  }

  // Stage the output tile through shared memory, then write rows with 16-byte stores.
  cp_async_wait<0>();
  __syncthreads();
  bf16* tile = reinterpret_cast<bf16*>(smem);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm + mi * 16 + g + hh * 8, col = wn + ni * 8 + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(tile + r * kLdOut + col) =
            __floats2bfloat162_rn(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      }
  __syncthreads();
  const bool vec_out = (Cout % 8 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  for (int idx = tid; idx < kBMB * (kBN / 8); idx += kThreadsB) {
    const int r = idx / (kBN / 8), col = (idx % (kBN / 8)) * 8;
    const int m = m0 + r, n = n0 + col;
    if (m >= M || n >= Cout) continue;
    bf16* dst = out + static_cast<long long>(m) * Cout + n;
    const bf16* src = tile + r * kLdOut + col;
    if (vec_out && n + 8 <= Cout) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < Cout; ++e) dst[e] = src[e];
    }
  }
}

// Shared memory the bf16 kernel needs for this shape (the largest region of any tile).
size_t bf16_smem_bytes(int n, int h, int w_in, int c, int& region_cap) {
  const int OH = h / 2, OW = w_in / 2, M = n * OH * OW;
  int rows = 0;
  for (int m0 = 0; m0 < M; m0 += kBMB) {
    int lo, hi;
    region_rows(m0, m0 + kBMB < M ? m0 + kBMB : M, h, OH, OW, lo, hi);
    rows = hi - lo + 1 > rows ? hi - lo + 1 : rows;
  }
  region_cap = rows * w_in;
  const size_t region_bytes = static_cast<size_t>((region_cap + 3) / 4) * 128;
  const size_t pipe = 2 * size_t(kBSlabBytes) + 2 * region_bytes + 32 + 2 * sizeof(float) * c;
  const size_t tile = size_t(kBMB) * kLdOut * sizeof(bf16);
  return pipe > tile ? pipe : tile;
}

// ----------------------------------------------------------------- f32 ----

constexpr int kThreads = 256;
constexpr int kBM = 128;                             // output pixels per block
constexpr int kVecPerRow = 4;                        // 16-byte vectors per tile row
constexpr int kRowsPerPass = kThreads / kVecPerRow;  // 64
constexpr int kLoads = kBM / kRowsPerPass;           // 2 vectors per thread and operand

// The output pixels (A-tile rows) a thread stages, decoded once per block.
struct Rows {
  int img[kLoads], ih0[kLoads], iw0[kLoads];  // image; input row/col of tap (0, 0)
  bool in[kLoads];

  __device__ Rows(int m0, int tid, int M, int OH, int OW) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int m = m0 + tid / kVecPerRow + i * kRowsPerPass;
      in[i] = m < M;
      const int mm = in[i] ? m : 0;
      img[i] = mm / (OH * OW);
      const int r = mm % (OH * OW);
      ih0[i] = 2 * (r / OW) - 1;
      iw0[i] = 2 * (r % OW) - 1;
    }
  }

  // Whether row i reads a real input pixel at tap (kh, kw), channel c; its offset.
  __device__ __forceinline__ bool at(int i, int kh, int kw, int c, const Args& a, long long& off) const {
    const int ih = ih0[i] + kh, iw = iw0[i] + kw;
    off = ((static_cast<long long>(img[i]) * a.h + ih) * a.w_in + iw) * a.c + c;
    return in[i] && c < a.c && ih >= 0 && ih < a.h && iw >= 0 && iw < a.w_in;
  }
};

constexpr int kBK32 = 16;  // channels per K step
constexpr int kLd32 = 17;  // odd stride: column reads without conflicts

__global__ void __launch_bounds__(kThreads) fused_f32_kernel(const Args a) {
  __shared__ float As[2][kBM][kLd32];
  __shared__ float Bs[2][kBN][kLd32];

  const float* __restrict__ x = static_cast<const float*>(a.x);
  const float* __restrict__ w = static_cast<const float*>(a.w);
  float* __restrict__ xn_out = static_cast<float*>(a.xn_out);
  float* __restrict__ out = static_cast<float*>(a.out);
  const int Cin = a.c, Cout = a.cout, K = 16 * Cin;
  const int OH = a.h / 2, OW = a.w_in / 2, M = a.n * OH * OW;
  const int n_tiles = (Cout + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int tid = threadIdx.x;
  const int vcol = (tid % kVecPerRow) * 4;
  const bool vec_ok = a.vec_ok != 0;
  const bool write_xn = xn_out != nullptr && n0 == 0;
  const Rows rows(m0, tid, M, OH, OW);
  const int chunks = (Cin + kBK32 - 1) / kBK32;
  const int steps = 16 * chunks;

  Vec<float> a_raw[kLoads], b_raw[kLoads];
  bool a_ok[kLoads];
  long long a_off[kLoads];
  int stage_tap = 0, stage_c = 0;

  auto load = [&](int step) {
    const int tap = step / chunks, c = (step % chunks) * kBK32 + vcol;
    stage_tap = tap;
    stage_c = c;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      a_ok[i] = rows.at(i, tap >> 2, tap & 3, c, a, a_off[i]);
      const int co = n0 + tid / kVecPerRow + i * kRowsPerPass;
      const bool okb = co < Cout && c < Cin;
      const long long woff = static_cast<long long>(co) * K + tap * Cin + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a_raw[i].e[e] = 0.f;
        b_raw[i].e[e] = 0.f;
      }
      if (vec_ok) {
        if (a_ok[i]) a_raw[i].bits() = __ldg(reinterpret_cast<const uint4*>(x + a_off[i]));
        if (okb) b_raw[i].bits() = __ldg(reinterpret_cast<const uint4*>(w + woff));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (a_ok[i] && c + e < Cin) a_raw[i].e[e] = x[a_off[i] + e];
          if (okb && c + e < Cin) b_raw[i].e[e] = w[woff + e];
        }
      }
    }
  };

  auto store = [&](int buf) {
    const int kh = stage_tap >> 2, kw = stage_tap & 3;
    const bool owner = write_xn && (kh == 1 || kh == 2) && (kw == 1 || kw == 2);
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int row = tid / kVecPerRow + i * kRowsPerPass;
      Vec<float>& v = a_raw[i];
      if (a_ok[i]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = stage_c + e;
          v.e[e] = ch < Cin ? act(v.e[e], __ldg(a.scale + ch), __ldg(a.shift + ch), a.slope) : 0.f;
        }
        if (owner) {
          for (int e = 0; e < 4 && stage_c + e < Cin; ++e) xn_out[a_off[i] + e] = v.e[e];
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        As[buf][row][vcol + e] = v.e[e];
        Bs[buf][row][vcol + e] = b_raw[i].e[e];
      }
    }
  };

  // thread (ty, tx) owns rows ty + 16i and columns tx + 16j of the tile
  const int ty = tid / 16, tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load(step + 1);
#pragma unroll
    for (int k = 0; k < kBK32; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[buf][ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[buf][tx + 16 * j][k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (step + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < Cout) out[static_cast<long long>(m) * Cout + col] = acc[i][j];
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x (n, h, w, c), xn_out (same or null) and
// out (n, h/2, w/2, cout) are NHWC; w is (cout, 4, 4, c); scale and shift are
// (c,) float32. Launches on `stream`; returns cudaGetLastError(), or -1 when
// the input rows a bf16 tile reads do not fit in shared memory.
extern "C" int dcvgan_fused_norm_act_conv(int dtype, const void* x, const void* scale, const void* shift,
                                          const void* w, void* out, void* xn_out, int n, int h, int w_in,
                                          int c, int cout, float slope, void* stream) {
  Args a;
  a.x = x;
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.w = w;
  a.out = out;
  a.xn_out = xn_out;
  a.n = n;
  a.h = h;
  a.w_in = w_in;
  a.c = c;
  a.cout = cout;
  a.slope = slope;
  const int vec_elems = dtype == 1 ? 8 : 4;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(xn_out);
  a.vec_ok = (c % vec_elems == 0) && (ptrs % 16 == 0);
  const long long m = static_cast<long long>(n) * (h / 2) * (w_in / 2);
  const int tile_m = dtype == 1 ? kBMB : kBM;
  const long long blocks = (m + tile_m - 1) / tile_m * ((cout + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    int region_cap = 0;
    const size_t smem = bf16_smem_bytes(n, h, w_in, c, region_cap);
    if (smem > 227 * 1024) return -1;
    const cudaError_t err =
        cudaFuncSetAttribute(fused_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_bf16_kernel<<<static_cast<unsigned>(blocks), kThreadsB, smem, s>>>(a, region_cap);
  } else if (dtype == 0) {
    fused_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
