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
// All routes are implicit GEMMs: M = N*OH*OW output pixels, N_gemm = Cout and
// K = 16*C in (kh, kw, c) order, which is the memory order of a channels-last
// torch Conv2d weight (Cout, C, 4, 4): the weight is read as a row-major
// Cout x K matrix (K-major for the tensor cores) with no repacking. A padded
// tap contributes 0, not leaky_relu(shift): zero padding applies to the
// activation. Each input pixel's activation is written to xn_out once, by the
// tile that owns output pixel (ih/2, iw/2), on the first Cout tile; the stored
// value is the one fed to the product. The route is chosen on the host, by
// shape, before the launch (ops/fused_block.py: plan):
//
// - bf16, TMA route (the serving path; the section "TMA" below): a
//   persistent, warp-specialised kernel. Tiles of 128 output pixels x up to
//   128 output channels; one producer thread streams the input rows of a
//   tile (64 channels a stage) and the weights (one tap x 64 channels a
//   stage) by TMA into mbarrier rings; seven transform warps apply the
//   prologue in place once per staged element and send the owned rows to
//   xn_out by TMA store; two consumer warpgroups gather A into registers by
//   ldmatrix and run wgmma m64nBNk16 with B read from the swizzled weight
//   stage. Taps that are padding for every pixel of a tile are skipped;
//   small sites split Cout so the grid covers the card.
// - bf16, mma.sync route (shapes TMA cannot take: C or Cout not a multiple
//   of 8 or 16, pointers not 16-byte aligned, rows wider than a TMA box):
//   256 x 128 tiles, 16-channel slices staged by cp.async, mma.sync m16n8k16.
// - f32, TMA route ("tf32x3"): the same kernel on f32 (32 channels a stage),
//   its products error-compensated TF32 on wgmma m64nBNk8 (three TF32
//   products of split operands per f32 product; see "TMA" below), which
//   keeps the results within f32 tolerance of a full-f32 convolution.
// - f32, FMA route (f32 shapes TMA cannot take: C not a multiple of 4, Cout
//   not of 16, pointers not 16-byte aligned, rows wider than a TMA box):
//   128 x 128 tiles with the patches staged through registers and FMA on the
//   CUDA cores, in full f32.
//
// What bounds it on an H100 at the flagship shapes (bf16, N = 4096 frames,
// with xn_out): by bytes from device memory, down1 (32x32x64 -> 16x16x128,
// 1.3 GB for 0.27 TFLOP), down4 and down5; by the tensor cores, down2 and
// down3. Measured (PERF.md), the TMA route is held by what each SM must
// take in: the weights of all 16 taps for every 128-pixel tile (256 KB at
// down1, 512 KB a 128-channel tile at down2..4) plus the tile's rows, at
// roughly 25 bytes a cycle per SM from L2. The design keeps x's DRAM traffic
// at one read and the skip at one write, overlaps the loads, the prologue
// and the MMAs in separate warps, runs on wgmma, and skips dead taps (3/4 of
// the work at down5). Weight multicast over a cluster of 2 CTAs halves the
// L2 reads of the weights but not the bytes each SM takes in; it measured
// slower at every site, so the kernel has no clusters. The f32 route does
// three TF32 products for each f32 one, so its bound is the tensor cores'
// TF32 rate at down1..down3 (3 x the live-tap flops over 495 TFLOP/s) and
// its weight stages carry 4 times the bf16 bytes. Times against the bounds,
// the mma.sync and FMA kernels and cuDNN in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ------------------------------------------------------- bf16, mma.sync ----
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
  auto rows_of = [&](int t) {
    int lo, hi;
    region_rows(t * tile_m, t * tile_m + tile_m < M ? t * tile_m + tile_m : M, h, OH, OW, lo, hi);
    return hi - lo + 1;
  };
  int rows = tiles > 0 ? rows_of(tiles - 1) : 0;
  for (int t = 0; t < tiles && t < period; ++t) rows = rows_of(t) > rows ? rows_of(t) : rows;
  return rows;
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
  region_cap = max_region_rows(n, h, w_in, kBMB) * w_in;
  const size_t region_bytes = static_cast<size_t>((region_cap + 3) / 4) * 128;
  const size_t pipe = 2 * size_t(kBSlabBytes) + 2 * region_bytes + 32 + 2 * sizeof(float) * c;
  const size_t tile = size_t(kBMB) * kLdOut * sizeof(bf16);
  return pipe > tile ? pipe : tile;
}

// ------------------------------------------------------------ f32, FMA ----

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
//   tap's sum into a register accumulator, rounded to nearest, beat the FMA
//   kernel's error, but ptxas serialises wgmmas whose accumulators other
//   instructions read inside the loop (C7514), even after a wait for all of
//   them; so neither sum is read before the unit ends. Two accumulators and
//   a tap's split A fragments, double-buffered, fit the 128 registers a
//   thread (ptxas allocates no more under this launch, setmaxnreg or not) at
//   64 output channels a tile (kMaxBN): the f32 plan's tiles are at most 64
//   wide, which also gives down1 five weight stages where 128 gave two.

namespace tma {

constexpr int kBM = 128;         // output pixels per tile
constexpr int kRB = 128;         // bytes of one staged pixel or weight row: TMA's widest swizzle
constexpr int kConsumers = 256;  // two warpgroups
// Two consumer warpgroups, one producer warp and seven transform warps: with
// at most 128 output channels a tile, the consumers' 64 f32 accumulators
// leave registers for two more warpgroups (setmaxnreg: the launch gives 128 a
// thread; consumers take 160, the others keep 96).
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
// allocates 128 registers a thread under this launch, setmaxnreg or not)
template <typename T>
constexpr int kMaxBN = kF32<T> ? 64 : 128;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// TMA's and wgmma's 128-byte swizzle, on byte offsets from a 1024-byte
// aligned base: 16-byte granule bits [4, 7) ^= bits [7, 10).
__device__ __forceinline__ uint32_t swz(uint32_t o) { return o ^ ((o >> 3) & 0x70u); }

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Whether the phase with parity `parity` has completed. A thread whose phase
// is not complete sleeps in try_wait until it completes (or a time limit),
// so waiting warps leave the schedulers to the warps that work.
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity), "r"(0x989680u)
      : "memory");
  return done != 0;
}
// Whether the phase with parity `parity` has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// A phase that never completes is a schedule fault: trap (the launch then
// fails and the wrapper raises) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 2000000000ull) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
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

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma shared-memory descriptor of a K-major, swizzled tile: start address,
// leading offset (unused for swizzled K-major), 8-row stride, layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint64_t layout_type, uint32_t row8_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (static_cast<uint64_t>(row8_bytes >> 4) << 32) | (layout_type << 62);
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define A4 "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])
#define D8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define D16 D8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define D32 D16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define D64                                                                                   \
  D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, " \
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// acc(64 x N, f32) += A(64 x 16, bf16 registers) * B(16 x N, bf16 K-major in shared memory)
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc, int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : F4(0), F4(4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : F4(0), F4(4), F4(8), F4(12)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20), F4(24), F4(28)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20), F4(24), F4(28),
        F4(32), F4(36), F4(40), F4(44), F4(48), F4(52), F4(56), F4(60)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// acc(64 x N, f32) += A(64 x 8, TF32 registers) * B(8 x N, TF32 K-major in shared memory)
template <int N>
__device__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc, int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {" D8 "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : F4(0), F4(4)
      : A4, "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" D16 "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : F4(0), F4(4), F4(8), F4(12)
      : A4, "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" D32 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20), F4(24), F4(28)
      : A4, "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" D64 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20), F4(24), F4(28),
        F4(32), F4(36), F4(40), F4(44), F4(48), F4(52), F4(56), F4(60)
      : A4, "l"(desc), "r"(accumulate));
}

#undef F4
#undef A4
#undef D8
#undef D16
#undef D32
#undef D64

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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; reach it through the runtime, no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 3-D map, dims innermost first, strides of dims 1 and 2 in bytes.
bool encode_3d(CUtensorMap* map, CUtensorMapDataType type, const void* base, const cuuint64_t (&dims)[3],
               const cuuint64_t (&strides)[2], const cuuint32_t (&box)[3]) {
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
    case 128:
      if constexpr (kMaxBN<T> == 128) return launch<T, 128>(tm_x, tm_w, tm_xn, p, grid, smem, s);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tma

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

// The TMA route, with the schedule planned on the host (dcvgan_torch/ops/
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
  const int m_tiles = static_cast<int>((static_cast<long long>(n) * (h / 2) * (w_in / 2) + tma::kBM - 1) / tma::kBM);
  const int max_bn = f32 ? kMaxBN<float> : kMaxBN<bf16>;
  const bool ok = (dtype == 0 || dtype == 1) && c % (f32 ? 4 : 8) == 0 && (!f32 || w_split != nullptr) &&
                  bn >= 16 && bn <= max_bn && cout % bn == 0 && w_stages >= 1 && region_rows >= 1 &&
                  region_rows <= 256 && w_in <= 256 && n_units == m_tiles * (cout / bn) && grid >= 1 &&
                  grid <= n_units && tiles != nullptr && ptrs % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (region_rows < max_region_rows(n, h, w_in, tma::kBM)) return -5;
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
  const bool rows_ok = tma::kBM % ow == 0 && 2 * (tma::kBM / ow) <= 256 && (w_in % 8 == 0 || tma::kBM % ohw == 0);
  p.xn_rows = xn_out != nullptr && rows_ok ? 2 * (tma::kBM / ow) : 0;
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
