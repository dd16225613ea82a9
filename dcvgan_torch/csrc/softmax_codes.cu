// The geometry generator's segmentation head and its serving codes in one
// pass over the head conv's output:
//
//   probs = softmax(raw, dim=1)            bfloat16, channels-last
//   codes = quantize(probs)                uint8, channels-last
//   total += sum(codes)                    int64
//
// raw (N, C, H, W) bfloat16 scores, channels-last, so a pixel's C scores are
// contiguous and the op is a softmax over the rows of an (N*H*W, C) matrix.
// quantize is the serving quantisation (ops/softmax_codes.py): clamp to
// [-1, 1], + 1 and * 127.5 each rounded to bfloat16, a truncating cast.
//
// It replaces no Pallas kernel: the JAX package leaves the softmax and the
// quantisation to XLA. It was added because on the H100 the PyTorch chain
// (a copy of the channels-last scores to NCHW for the softmax, the softmax,
// a strided clamp / add / mul / cast over the permuted probabilities and an
// int64 checksum) took ~40 ms a serving chunk of 4 rounds, against the
// bound below of 2.5.
//
// Bound: bytes. A round of 4,096 frames of 64 x 64 x 25 reads 0.84 GB of
// scores and writes 0.84 GB of probabilities and 0.42 GB of codes: 2.10 GB,
// 0.63 ms at 3.35 TB/s. Arithmetic: ~10 instructions an element.
//
// Design. Persistent CTAs of 256 threads walk tiles of 256 pixels (a tile
// of C = 25 is 12.8 KB of scores, a multiple of 16 bytes for any C). Each
// CTA keeps two tiles in flight: the next tile's scores are copied into
// shared memory with cp.async in 16-byte pieces while the current one is
// computed and stored. Each thread computes one pixel's softmax in f32 as
// PyTorch's kernel does (the max, exp(x - max) and their sum in class
// order, then exp(x - max) / sum rounded to bfloat16, with the same expf
// and IEEE division) and writes its probabilities back over its scores in
// shared memory. Then the CTA stores the tile with 16-byte stores, each
// thread 8 probabilities and their 8 codes, computed from the bfloat16
// probabilities in bfloat16x2 arithmetic (one rounding an operation, as
// PyTorch's float arithmetic rounded to bfloat16 does). For a probability in
// [0, 1] the value q = bf16(bf16(p + 1) * 127.5) lies in [127.5, 255], where
// trunc(q) is q's bit pattern less 0x4280: in [128, 256) the exponent is 7
// and q = 128 + mantissa; the one value below 128 is 127.5 = 0x42FF. Each
// thread sums its codes (dp4a) and the CTA adds its sum to the total with
// one integer atomic, so the total does not depend on the order of the CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one pixel a thread; a tile is kThreads pixels (ops/softmax_codes.py TILE)

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    // copies src_bytes (0..16) and fills the rest of the 16 bytes with zeros
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// starts the copy of `bytes` (even, from a 16-byte aligned address) into the tile buffer `dst`
__device__ __forceinline__ void load_tile(void* dst, const void* src, int bytes) {
    for (int i = threadIdx.x; i * 16 < bytes; i += kThreads) {
        const int left = bytes - i * 16;
        cp_async16(static_cast<char*>(dst) + i * 16, static_cast<const char*>(src) + i * 16, left < 16 ? left : 16);
    }
}

// one pixel's softmax over its c scores at q, in place; C the class count as
// a compile-time constant (the scores kept in registers) or 0 for any count
template <int C>
__device__ __forceinline__ void softmax_pixel(__nv_bfloat16* q, int c_rt) {
    if constexpr (C > 0) {
        float e[C];
        float m = __bfloat162float(q[0]);
#pragma unroll
        for (int k = 0; k < C; ++k) {
            e[k] = __bfloat162float(q[k]);
            m = fmaxf(m, e[k]);
        }
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < C; ++k) {
            e[k] = expf(e[k] - m);
            s += e[k];
        }
#pragma unroll
        for (int k = 0; k < C; ++k) q[k] = __float2bfloat16_rn(e[k] / s);
    } else {
        float m = __bfloat162float(q[0]);
        for (int k = 1; k < c_rt; ++k) m = fmaxf(m, __bfloat162float(q[k]));
        float s = 0.f;
        for (int k = 0; k < c_rt; ++k) s += expf(__bfloat162float(q[k]) - m);
        for (int k = 0; k < c_rt; ++k) q[k] = __float2bfloat16_rn(expf(__bfloat162float(q[k]) - m) / s);
    }
}

// bf16(bf16(p + 1) * 127.5) for two bfloat16 probabilities (a 32-bit word)
__device__ __forceinline__ uint32_t scaled2(uint32_t p2) {
    const __nv_bfloat162 one = __floats2bfloat162_rn(1.f, 1.f);
    const __nv_bfloat162 k = __floats2bfloat162_rn(127.5f, 127.5f);
    __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&p2);
    v = __hmul2(__hadd2(v, one), k);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// the codes of four probabilities (two words) as four bytes, in order
__device__ __forceinline__ uint32_t codes4(uint32_t lo, uint32_t hi) {
    const uint32_t a = scaled2(lo) - 0x42804280u, b = scaled2(hi) - 0x42804280u;
    return __byte_perm(a, b, 0x6420);  // the low byte of each of the four halves
}

__device__ __forceinline__ uint8_t code1(__nv_bfloat16 p) {
    const uint16_t bits = static_cast<uint16_t>(scaled2(static_cast<uint32_t>(__bfloat16_as_ushort(p))));
    return static_cast<uint8_t>(bits - 0x4280u);
}

// stores a tile of `elems` probabilities from shared memory with their codes; returns the codes' sum
__device__ __forceinline__ uint32_t store_tile(const __nv_bfloat16* tile, __nv_bfloat16* __restrict__ probs,
                                               uint8_t* __restrict__ codes, int elems) {
    uint32_t sum = 0;
    const int pieces = elems / 8;  // 16 bytes of probabilities, 8 bytes of codes
    for (int i = threadIdx.x; i < pieces; i += kThreads) {
        const uint4 p = reinterpret_cast<const uint4*>(tile)[i];
        reinterpret_cast<uint4*>(probs)[i] = p;
        uint2 c;
        c.x = codes4(p.x, p.y);
        c.y = codes4(p.z, p.w);
        reinterpret_cast<uint2*>(codes)[i] = c;
        sum = __dp4a(c.x, 0x01010101u, sum);
        sum = __dp4a(c.y, 0x01010101u, sum);
    }
    for (int i = pieces * 8 + threadIdx.x; i < elems; i += kThreads) {  // the last tile's ragged end
        probs[i] = tile[i];
        const uint8_t c = code1(tile[i]);
        codes[i] = c;
        sum += c;
    }
    return sum;
}

template <int C>
__global__ void __launch_bounds__(kThreads) softmax_codes_kernel(
    const __nv_bfloat16* __restrict__ raw, __nv_bfloat16* __restrict__ probs, uint8_t* __restrict__ codes,
    unsigned long long* __restrict__ total, long long pixels, int c_rt) {
    const int c = C ? C : c_rt;
    extern __shared__ __align__(16) unsigned char smem[];
    const int tile_elems = kThreads * c;
    __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(smem);  // two tiles
    const long long tiles = (pixels + kThreads - 1) / kThreads;
    auto tile_pixels = [&](long long t) { return static_cast<int>(min(static_cast<long long>(kThreads), pixels - t * kThreads)); };

    unsigned long long sum = 0;
    long long t = blockIdx.x;
    if (t < tiles) load_tile(bufs, raw + t * tile_elems, tile_pixels(t) * c * 2);
    cp_async_commit();
    for (int k = 0; t < tiles; t += gridDim.x, ++k) {
        __nv_bfloat16* tile = bufs + (k & 1) * tile_elems;
        const long long next = t + gridDim.x;
        // the other buffer's last tile was stored before the barrier that ended the last iteration
        if (next < tiles) load_tile(bufs + ((k + 1) & 1) * tile_elems, raw + next * tile_elems, tile_pixels(next) * c * 2);
        cp_async_commit();
        cp_async_wait_one();  // this tile's copies, not the next one's
        __syncthreads();
        const int n = tile_pixels(t);
        if (static_cast<int>(threadIdx.x) < n) softmax_pixel<C>(tile + threadIdx.x * c, c);
        __syncthreads();
        sum += store_tile(tile, probs + t * tile_elems, codes + t * tile_elems, n * c);
        __syncthreads();
    }

    __shared__ unsigned long long warp_sums[kThreads / 32];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned long long cta = 0;
        for (int w = 0; w < kThreads / 32; ++w) cta += warp_sums[w];
        atomicAdd(total, cta);
    }
}

template <int C>
int launch(const void* raw, void* probs, void* codes, void* total, long long pixels, int c, int smem, void* stream) {
    auto* kernel = softmax_codes_kernel<C>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
        return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = (pixels + kThreads - 1) / kThreads;
    const long long fit = static_cast<long long>(sms) * per_sm;
    const int grid = static_cast<int>(tiles < fit ? tiles : fit);
    if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(raw), static_cast<__nv_bfloat16*>(probs), static_cast<uint8_t*>(codes),
        static_cast<unsigned long long*>(total), pixels, c);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns 0 or the CUDA error of the set-up or launch.
// raw 16-byte aligned; probs, codes (N*H*W*C each) and total (one int64,
// added to) from the wrapper (ops/softmax_codes.py), which also gives
// `smem`, the two tiles' bytes; the grid is every CTA that fits on the card
// at once, at most one a tile.
int dcvgan_softmax_codes(const void* raw, void* probs, void* codes, void* total, long long pixels, int c, int smem,
                         void* stream) {
    if (c == 25) return launch<25>(raw, probs, codes, total, pixels, c, smem, stream);
    return launch<0>(raw, probs, codes, total, pixels, c, smem, stream);
}

}  // extern "C"
