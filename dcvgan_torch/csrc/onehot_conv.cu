// The colour generator's input conv on a segmentation input:
//
//   out = leaky_relu(conv2d(2 * one_hot(argmax_c p) - 1, w, padding=1), slope)
//
// p (N, C, H, W) bfloat16 class scores, channels-last; w (Cout, C, 3, 3);
// out (N, Cout, H, W) bfloat16, channels-last. Ties take the first class, as
// torch.argmax does (a NaN counts as the largest value).
//
// It replaces no Pallas kernel: the JAX package leaves the argmax, the
// one-hot, the cast and the conv to XLA. It was added because on the H100
// that chain is five passes over device memory (an int64 one-hot of 3.36 GB
// for a round of 4,096 frames of 64 x 64 x 25, its cast and affine, cuDNN's
// conv on 25 channels, which is not a multiple of 8, and a separate
// LeakyReLU), some 19 GB of traffic a round.
//
// The conv of a +-1 one-hot is a gather. With c(q) the class at input pixel
// q and T[t][c][:] = 2 * w[:, c, t] - sum_c' w[:, c', t] (the wrapper builds
// this f32 table once per weight version),
//
//   conv(q)[:] = sum over the taps t whose pixel q + t lies in the image of T[t][c(q + t)][:]
//
// (a tap that falls in the zero padding adds nothing). So a pixel's output
// is at most 9 f32 row additions, and no product is left.
//
// Bound: bytes. A pixel reads C * 2 bytes of scores and writes Cout * 2
// bytes; 9 * Cout f32 additions a pixel are far under the card's rate. At
// the serving shape (N = 4096, C = 25, Cout = 64) that is 2.99 GB a round,
// 0.89 ms at 3.35 TB/s.
//
// Design. Persistent CTAs of kGroups groups of 256 threads; the CTA holds
// the whole table in shared memory once (9 x C x Cout floats: 57.6 KB at
// 25 x 64) for all its groups, and each group walks tiles of `rows` image
// rows of one image (8 at W = 64) on its own, between barriers of its own
// 8 warps, so that one group's copies and argmaxes overlap another's sums.
// For each tile a group copies the tile's rows of scores and one row of
// halo above and below, a contiguous run of device memory, into its part of
// shared memory in 16-byte pieces (a pixel's 50 bytes of scores at C = 25
// straddle 16-byte boundaries, and per-pixel loads from device memory
// would touch a dozen cache lines per warp load); computes each label of
// the tile and its one-pixel halo (-1 outside the image) once from there;
// then each thread takes one (pixel, j) item: output channels [4j, 4j + 4)
// and [Cout/2 + 4j, Cout/2 + 4j + 4), two 16-byte table reads a tap. That
// split puts the 8 threads of a quarter-warp, one pixel at Cout = 64, on
// 128 contiguous bytes of a table row, so the table reads do not collide
// in a bank; the stores are two 8-byte pieces a thread, whole 32-byte
// sectors a warp. The sum is f32 in tap order, then LeakyReLU, then one
// rounding to bfloat16. The table reads, 9 x Cout x 4 bytes of shared
// memory a pixel, are the kernel's largest traffic after the bound's bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroupThreads = 256;  // one group walks one tile at a time
constexpr int kGroups = 4;  // groups a CTA: they share its one copy of the table (ops/onehot_conv.py GROUPS)
constexpr int kThreads = kGroupThreads * kGroups;

// a barrier over one group's 8 warps (id 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int g) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "n"(kGroupThreads) : "memory");
}

template <int C>
__device__ __forceinline__ int argmax_class(const __nv_bfloat16* __restrict__ q, int c) {
    float best = __bfloat162float(q[0]);
    int arg = 0;
#pragma unroll
    for (int k = 1; k < (C ? C : c); ++k) {
        float v = __bfloat162float(q[k]);
        // first maximum; a NaN wins over any number, the first NaN over later ones
        if (v > best || (v != v && best == best)) {
            best = v;
            arg = k;
        }
    }
    return arg;
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
}

__device__ __forceinline__ uint2 leaky_bf16x4(float4 v, float slope) {
    v.x = v.x > 0.f ? v.x : v.x * slope;
    v.y = v.y > 0.f ? v.y : v.y * slope;
    v.z = v.z > 0.f ? v.z : v.z * slope;
    v.w = v.w > 0.f ? v.w : v.w * slope;
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 out;
    out.x = *reinterpret_cast<uint32_t*>(&lo);
    out.y = *reinterpret_cast<uint32_t*>(&hi);
    return out;
}

// C, COUT, W: the classes, output channels and image width as compile-time
// constants (the serving shape's 25, 64 and 64: the divisions by W and by
// the threads a pixel become shifts and the argmax unrolls), or 0 for the
// runtime values of any shape.
template <int C, int COUT, int W>
__global__ void __launch_bounds__(kThreads, 1) onehot_conv_kernel(
    const __nv_bfloat16* __restrict__ p, const float* __restrict__ table, __nv_bfloat16* __restrict__ out,
    int n, int h, int w_rt, int c_rt, int cout_rt, int rows, int vec, float slope) {
    const int c = C ? C : c_rt, cout = COUT ? COUT : cout_rt, w = W ? W : w_rt;
    extern __shared__ __align__(16) unsigned char smem[];
    float* tab = reinterpret_cast<float*>(smem);
    const int table_floats = 9 * c * cout;
    const int g = threadIdx.x / kGroupThreads, tid = threadIdx.x % kGroupThreads;
    // each group's own staged scores and labels, after the table
    const int stage_bytes = ((rows + 2) * w * c * 2 + 15) / 16 * 16;
    const int label_bytes = ((rows + 2) * (w + 2) * 2 + 15) / 16 * 16;
    unsigned char* mine = smem + static_cast<size_t>(table_floats) * sizeof(float) + g * (stage_bytes + label_bytes);
    __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(mine);
    short* labels = reinterpret_cast<short*>(mine + stage_bytes);

    // the table, once per CTA (a multiple of 8 floats: Cout is)
    for (int i = threadIdx.x * 4; i < table_floats; i += kThreads * 4) {
        *reinterpret_cast<float4*>(tab + i) = __ldg(reinterpret_cast<const float4*>(table + i));
    }
    __syncthreads();

    const int lw = w + 2;  // label row: the image row and a pixel of halo at each end
    const int groups = cout / 8;  // threads a pixel
    const int half = cout / 2;
    const int tiles_per_image = (h + rows - 1) / rows;
    const int tiles = n * tiles_per_image;
    for (int tile = blockIdx.x * kGroups + g; tile < tiles; tile += gridDim.x * kGroups) {
        const int img = tile / tiles_per_image;
        const int r0 = (tile - img * tiles_per_image) * rows;
        const int nr = min(rows, h - r0);
        const int y_lo = max(r0 - 1, 0), y_hi = min(r0 + nr, h - 1);  // the rows read, inclusive
        const __nv_bfloat16* src = p + (static_cast<size_t>(img) * h + y_lo) * w * c;
        const int n_stage = (y_hi - y_lo + 1) * w * c;
        group_sync(g);  // the group's last tile's stage and labels are read
        if (vec) {  // the run starts 16-byte aligned and is a whole number of 16-byte pieces
            const uint4* s4 = reinterpret_cast<const uint4*>(src);
            uint4* d4 = reinterpret_cast<uint4*>(stage);
            for (int i = tid; i < n_stage / 8; i += kGroupThreads) d4[i] = __ldg(s4 + i);
        } else {
            for (int i = tid; i < n_stage; i += kGroupThreads) stage[i] = src[i];
        }
        group_sync(g);
        const int n_labels = (nr + 2) * lw;
        for (int i = tid; i < n_labels; i += kGroupThreads) {
            const int ly = i / lw;
            const int x = i - ly * lw - 1;
            const int y = r0 - 1 + ly;
            short lab = -1;
            if (y >= 0 && y < h && x >= 0 && x < w) {
                lab = static_cast<short>(argmax_class<C>(stage + ((y - y_lo) * w + x) * c, c));
            }
            labels[i] = lab;
        }
        group_sync(g);
        const int items = nr * w * groups;
        for (int i = tid; i < items; i += kGroupThreads) {
            const int pix = i / groups;
            const int j = i - pix * groups;
            const int py = pix / w;
            const int px = pix - py * w;
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
            float4 b = a;
#pragma unroll
            for (int t = 0; t < 9; ++t) {
                const int lab = labels[(py + t / 3) * lw + px + t % 3];
                if (lab >= 0) {
                    const float* row = tab + (t * c + lab) * cout + 4 * j;
                    add4(a, *reinterpret_cast<const float4*>(row));
                    add4(b, *reinterpret_cast<const float4*>(row + half));
                }
            }
            __nv_bfloat16* o = out + ((static_cast<size_t>(img) * h + r0 + py) * w + px) * cout + 4 * j;
            *reinterpret_cast<uint2*>(o) = leaky_bf16x4(a, slope);
            *reinterpret_cast<uint2*>(o + half) = leaky_bf16x4(b, slope);
        }
    }
}

template <int C, int COUT, int W>
int launch(const void* p, const void* table, void* out, int n, int h, int w, int c, int cout, int rows, int vec,
           int smem, float slope, void* stream) {
    auto* kernel = onehot_conv_kernel<C, COUT, W>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
        return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long ctas = (static_cast<long long>(n) * ((h + rows - 1) / rows) + kGroups - 1) / kGroups;
    const int grid = static_cast<int>(ctas < static_cast<long long>(sms) * per_sm ? ctas : sms * per_sm);
    if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(p), static_cast<const float*>(table), static_cast<__nv_bfloat16*>(out), n,
        h, w, c, cout, rows, vec, slope);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns 0 or the CUDA error of the set-up or launch.
// `rows`, `vec` (16-byte staging: p 16-byte aligned and W * C a multiple of
// 8) and `smem` are the wrapper's plan (ops/onehot_conv.py); the grid is
// every CTA that fits on the card at once, at most one for every kGroups tiles.
int dcvgan_onehot_conv3x3(const void* p, const void* table, void* out, int n, int h, int w, int c, int cout,
                          int rows, int vec, int smem, float slope, void* stream) {
    if (c == 25 && cout == 64 && w == 64)
        return launch<25, 64, 64>(p, table, out, n, h, w, c, cout, rows, vec, smem, slope, stream);
    return launch<0, 0, 0>(p, table, out, n, h, w, c, cout, rows, vec, smem, slope, stream);
}

}  // extern "C"
