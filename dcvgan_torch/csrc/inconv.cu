// The colour generator's input conv on a dense geometric input (depth, Cin 1;
// optical flow, Cin 2) and its LeakyReLU:
//
//   out = leaky_relu(conv2d(x, w, padding=1), slope)
//
// x (N, Cin, H, W) bfloat16, channels-last; w (Cout, Cin, 3, 3) bfloat16 with
// any strides; out (N, Cout, H, W) bfloat16, channels-last.
//
// It replaces no Pallas kernel: the JAX package leaves this conv to XLA. It
// was added because on the H100 the library chain (cuDNN's fprop, which at
// one input channel also copies between layouts, and a separate LeakyReLU
// that reads and writes the whole output once more) took 18.2 ms a serving
// chunk of 4 rounds, against 2.6 ms of bound.
//
// Bound: bytes. A pixel reads Cin * 2 bytes and writes Cout * 2. At the
// serving shape (N = 4096, 64 x 64, Cin 1, Cout 64) a round reads 33.6 MB and
// writes 2,147.5 MB: 2.18 GB, 0.651 ms at 3.35 TB/s. Arithmetic: 9 * Cin *
// Cout FMAs a pixel, 9.7 G a round at Cin 1, ~0.29 ms of the card's f32 rate:
// under the byte bound but at 45% of it, so the inner loop holds little
// besides the FMAs.
//
// Design. Persistent CTAs walk tiles of `rows` whole image rows of one image
// (8 at W = 64). Each thread owns CPT output channels (8; 4 at Cin 3 and 4)
// and holds their 9 * Cin * CPT weights in f32 registers, loaded once per
// CTA; a CTA is Cout / CPT channel groups times the pixels of one pass. A
// tile's input rows and one halo row above and below are copied into shared
// memory with cp.async in 16-byte pieces (zeros for a row outside the
// image), each row between columns of zeros, so no tap tests the image's
// edge; two buffers, so that the next tile's copy overlaps this tile's
// stores. The threads of one pixel read its 9 * Cin inputs (a shared-memory
// broadcast), accumulate in f32 in tap order, apply LeakyReLU in f32, round
// once to bfloat16 and store CPT * 2 bytes: at Cout 64 a warp stores 4
// pixels x 128 B, 512 contiguous bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // a CTA: channel groups x pixels a pass (ops/inconv.py MAX_THREADS)
constexpr int kPad = 8;  // zeros before a staged row (16 bytes, so the row's copies stay aligned); as many after

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    // copies src_bytes (0 or 16) and fills the rest of the 16 bytes with zeros
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// LeakyReLU of two f32 values, rounded once to a bfloat16 pair
__device__ __forceinline__ uint32_t leaky_bf16x2(float a, float b, float slope) {
    a = a > 0.f ? a : a * slope;
    b = b > 0.f ? b : b * slope;
    __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&v);
}

// CIN input channels; COUT, W the output channels and the image width as
// compile-time constants (the serving shapes' 64 and 64), or 0 for the
// runtime values of any shape.
template <int CIN, int COUT, int W>
__global__ void __launch_bounds__(kMaxThreads) inconv_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt, __nv_bfloat16* __restrict__ out,
    int n, int h, int w_rt, int cout_rt, int ws0, int ws1, int ws2, int ws3, int rows, int vec, float slope) {
    constexpr int CPT = CIN <= 2 ? 8 : 4;  // output channels a thread
    const int w = W ? W : w_rt, cout = COUT ? COUT : cout_rt;
    const int groups = cout / CPT;
    const int ppp = blockDim.x / groups;  // pixels a pass
    const int j = threadIdx.x % groups, pix0 = threadIdx.x / groups;
    const int row_elems = w * CIN;
    const int srow = (row_elems + 7) / 8 * 8 + 2 * kPad;  // elements a staged row
    const int buf_elems = (rows + 2) * srow;
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(smem);  // two tile buffers

    // zero both buffers once: the columns around each row are never written again
    for (int i = threadIdx.x; i < 2 * buf_elems / 8; i += blockDim.x) {
        reinterpret_cast<uint4*>(bufs)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    float wr[9][CIN][CPT];  // this thread's weights, w[j * CPT + c, ci, t / 3, t % 3]
#pragma unroll
    for (int t = 0; t < 9; ++t) {
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci) {
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                wr[t][ci][c] = __bfloat162float(wt[(j * CPT + c) * ws0 + ci * ws1 + (t / 3) * ws2 + (t % 3) * ws3]);
            }
        }
    }
    __syncthreads();

    const int tiles_per_image = (h + rows - 1) / rows;
    const int tiles = n * tiles_per_image;
    // starts the copy of a tile's rows and its halo rows into buf (synchronous where not vec)
    auto stage = [&](__nv_bfloat16* buf, int tile) {
        const int img = tile / tiles_per_image;
        const int r0 = (tile - img * tiles_per_image) * rows;
        const int nrows = min(rows, h - r0) + 2;
        const __nv_bfloat16* src = x + static_cast<size_t>(img) * h * row_elems;
        if (vec) {  // x 16-byte aligned and a row a whole number of 16-byte pieces
            const int pieces = row_elems / 8;
            for (int i = threadIdx.x; i < nrows * pieces; i += blockDim.x) {
                const int r = i / pieces, q = i - r * pieces;
                const int y = r0 - 1 + r;
                const bool in = y >= 0 && y < h;
                cp_async16(buf + r * srow + kPad + q * 8, in ? src + static_cast<size_t>(y) * row_elems + q * 8 : src,
                           in ? 16 : 0);
            }
        } else {
            for (int i = threadIdx.x; i < nrows * row_elems; i += blockDim.x) {
                const int r = i / row_elems, e = i - r * row_elems;
                const int y = r0 - 1 + r;
                buf[r * srow + kPad + e] =
                    y >= 0 && y < h ? src[static_cast<size_t>(y) * row_elems + e] : __ushort_as_bfloat16(0);
            }
        }
    };

    int t = blockIdx.x;
    if (t < tiles) stage(bufs, t);
    cp_async_commit();
    for (int k = 0; t < tiles; t += gridDim.x, ++k) {
        const __nv_bfloat16* buf = bufs + (k & 1) * buf_elems;
        // the other buffer's last tile was read before the barrier that ended the last iteration
        const int next = t + static_cast<int>(gridDim.x);
        if (next < tiles) stage(bufs + ((k + 1) & 1) * buf_elems, next);
        cp_async_commit();
        cp_async_wait_one();  // this tile's copies, not the next one's
        __syncthreads();
        const int img = t / tiles_per_image;
        const int r0 = (t - img * tiles_per_image) * rows;
        const int npix = min(rows, h - r0) * w;
        __nv_bfloat16* o = out + (static_cast<size_t>(img) * h + r0) * w * cout + j * CPT;
        for (int p = pix0; p < npix; p += ppp) {
            const int py = p / w, px = p - py * w;
            // staged row py is image row r0 + py - 1: the pixel's taps are rows py .. py + 2
            const __nv_bfloat16* s = buf + py * srow + kPad + px * CIN;
            float acc[CPT];
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
                for (int ci = 0; ci < CIN; ++ci) {
                    const float v = __bfloat162float(s[(tap / 3) * srow + (tap % 3 - 1) * CIN + ci]);
#pragma unroll
                    for (int c = 0; c < CPT; ++c) acc[c] = fmaf(wr[tap][ci][c], v, acc[c]);
                }
            }
            uint32_t packed[CPT / 2];
#pragma unroll
            for (int c = 0; c < CPT / 2; ++c) packed[c] = leaky_bf16x2(acc[2 * c], acc[2 * c + 1], slope);
            __nv_bfloat16* dst = o + static_cast<size_t>(p) * cout;
            if constexpr (CPT == 8) {
                *reinterpret_cast<uint4*>(dst) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
            } else {
                *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
            }
        }
        __syncthreads();
    }
}

template <int CIN, int COUT, int W>
int launch(const void* x, const void* w, void* out, int n, int h, int wd, int cout, int ws0, int ws1, int ws2,
           int ws3, int rows, int vec, int threads, int smem, float slope, void* stream) {
    auto* kernel = inconv_kernel<CIN, COUT, W>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
        return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = static_cast<long long>(n) * ((h + rows - 1) / rows);
    const long long fit = static_cast<long long>(sms) * per_sm;
    const int grid = static_cast<int>(tiles < fit ? tiles : fit);
    if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
        n, h, wd, cout, ws0, ws1, ws2, ws3, rows, vec, slope);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns 0 or the CUDA error of the set-up or launch.
// ws0..ws3 are w's strides in elements; `rows`, `vec` (16-byte staging: x
// 16-byte aligned and W * Cin a multiple of 8), `threads` (Cout / CPT
// channel groups times the pixels a pass) and `smem` (two tile buffers) are
// the wrapper's plan (ops/inconv.py); the grid is every CTA that fits on the
// card at once, at most one a tile.
int dcvgan_inconv3x3(const void* x, const void* w, void* out, int n, int h, int wd, int cin, int cout, int ws0,
                     int ws1, int ws2, int ws3, int rows, int vec, int threads, int smem, float slope, void* stream) {
    if (cout == 64 && wd == 64 && cin == 1)
        return launch<1, 64, 64>(x, w, out, n, h, wd, cout, ws0, ws1, ws2, ws3, rows, vec, threads, smem, slope, stream);
    if (cout == 64 && wd == 64 && cin == 2)
        return launch<2, 64, 64>(x, w, out, n, h, wd, cout, ws0, ws1, ws2, ws3, rows, vec, threads, smem, slope, stream);
    switch (cin) {
        case 1: return launch<1, 0, 0>(x, w, out, n, h, wd, cout, ws0, ws1, ws2, ws3, rows, vec, threads, smem, slope, stream);
        case 2: return launch<2, 0, 0>(x, w, out, n, h, wd, cout, ws0, ws1, ws2, ws3, rows, vec, threads, smem, slope, stream);
        case 3: return launch<3, 0, 0>(x, w, out, n, h, wd, cout, ws0, ws1, ws2, ws3, rows, vec, threads, smem, slope, stream);
        case 4: return launch<4, 0, 0>(x, w, out, n, h, wd, cout, ws0, ws1, ws2, ws3, rows, vec, threads, smem, slope, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // extern "C"
