// uint8 -> [-1, 1] dequantisation: out[i] = float(x[i]) / 127.5f - 1.0f in
// float32 or bfloat16, elementwise over a flat stream of n bytes.
//
// Counterpart of the Pallas kernel in dcvgan_tpu/ops/dequant.py. It computes
// the same function and keeps none of that kernel's tiling: no (rows, 128)
// reshape and no padded copy. One grid-stride loop takes 16 bytes per step
// (one 16-byte load, 32 or 64 bytes of stores) when the input pointer is
// 16-byte aligned, and a scalar loop takes the tail, or all of it when the
// input is a view that starts off alignment. The output is the wrapper's own
// fresh allocation, so it is always aligned.
//
// Bound: bytes. Each element is one byte read and 2 or 4 written, against two
// float operations. At a train step's sizes (1.3 M and 3.9 M elements) that
// is a few microseconds of traffic, less than a launch costs, so the kernel
// is as simple as it can be and its time is the launch's.
//
// The arithmetic is IEEE: a correctly rounded division (never a multiply by
// a reciprocal), a correctly rounded subtraction, then round-to-nearest-even
// to bfloat16. The build uses no fast-math flag.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;  // bytes per vector step

__device__ __forceinline__ float dequant(uint32_t byte) {
    return __fsub_rn(__fdiv_rn(static_cast<float>(byte), 127.5f), 1.0f);
}

__device__ __forceinline__ void store16(float* out, const float (&v)[kVec]) {
    float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        o[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
}

__device__ __forceinline__ void store16(__nv_bfloat16* out, const float (&v)[kVec]) {
    uint4* o = reinterpret_cast<uint4*>(out);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const __nv_bfloat16 lo = __float2bfloat16_rn(v[8 * j + 2 * k]);
            const __nv_bfloat16 hi = __float2bfloat16_rn(v[8 * j + 2 * k + 1]);
            w[k] = static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
                   (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
        }
        o[j] = make_uint4(w[0], w[1], w[2], w[3]);
    }
}

__device__ __forceinline__ void store1(float* out, float v) { *out = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, float v) {
    *out = __float2bfloat16_rn(v);
}

// n_vec: how many leading groups of 16 bytes take the vector path (0 when x
// is not 16-byte aligned).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const uint8_t* __restrict__ x, T* __restrict__ out, long long n, long long n_vec) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (long long i = tid; i < n_vec; i += stride) {
        const uint4 p = xv[i];
        const uint32_t words[4] = {p.x, p.y, p.z, p.w};
        float v[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
            v[j] = dequant((words[j >> 2] >> (8 * (j & 3))) & 0xffu);
        }
        store16(out + i * kVec, v);
    }
    for (long long i = n_vec * kVec + tid; i < n; i += stride) {
        store1(out + i, dequant(x[i]));
    }
}

template <typename T>
int launch(const void* x, void* out, long long n, cudaStream_t stream) {
    const bool aligned = (reinterpret_cast<uintptr_t>(x) % kVec == 0) &&
                         (reinterpret_cast<uintptr_t>(out) % (kVec * sizeof(T)) == 0);
    const long long n_vec = aligned ? n / kVec : 0;
    const long long work = n_vec + (n - n_vec * kVec);  // loop iterations in all
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    long long blocks = (work + kThreads - 1) / kThreads;
    const long long cap = static_cast<long long>(sms) * 8;
    if (blocks > cap) blocks = cap;
    dequant_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(x), static_cast<T*>(out), n, n_vec);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Returns 0, a CUDA error code, or -2
// for an unknown dtype code. n == 0 launches nothing.
extern "C" int dcvgan_dequant(int dtype_code, const void* x, void* out, long long n, void* stream) {
    if (dtype_code != 0 && dtype_code != 1) return -2;
    if (n <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype_code == 0 ? launch<float>(x, out, n, s) : launch<__nv_bfloat16>(x, out, n, s);
}
