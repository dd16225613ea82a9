// uint8 -> [-1, 1] dequantisation: out[i] = float(x[i]) / 127.5f - 1.0f in
// float32 or bfloat16, elementwise, over up to four tensors in one launch.
//
// Counterpart of the Pallas kernel `_dequant_kernel` in
// dcvgan_tpu/ops/dequant.py. It computes the same function and keeps none of
// that kernel's tiling: no (rows, 128) reshape and no padded copy.
//
// Bound: bytes. Each element is one byte read and 2 or 4 written, against two
// float operations. A train step dequantises two batches (colour 3.9 MB,
// depth 1.3 MB of uint8): a few microseconds of traffic, about what a launch
// costs. So the step's batches share ONE launch: each tensor is a segment
// (input pointer, output pointer, element count) in a struct passed by value,
// and the blocks are shared out among the segments by their bytes, each
// non-empty segment at least one block, so that a small segment runs beside
// a large one, not after it. The grid stays within one wave: SMs x the blocks
// of this kernel that fit on an SM, as the occupancy calculator gives them
// for its build (registers and the 32 KB table below). A lane's vector step reads 16 / sizeof(T) bytes and writes 16, so
// that each store instruction of a warp writes 512 contiguous bytes, whole
// 32-byte sectors (16-byte pieces at a 32- or 64-byte lane stride write half
// or quarter sectors, and L2 then takes twice or four times the write
// operations). Each thread issues kUnroll independent loads before it
// converts and stores any, so that it waits out one memory latency for
// kUnroll vectors, not one per vector; the first are issued before the
// table below is built. Stores use the default write-back: the critics read
// the outputs right away, and L2 holds them.
//
// An input byte has 256 values, so each block first computes the 256
// results once (one IEEE division each) into a table in shared memory and
// then looks every element up: per element a division costs a dozen
// instructions, and with the few warps a one-wave grid puts on an SM that
// issue time was as long as the memory traffic. The table holds one copy per
// lane (256 x 32 floats, 32 KB; entry v of lane l in bank l), so a warp's
// lookups never collide in a bank whatever its bytes.
//
// A segment whose input is aligned to its vector step and whose output is
// 16-byte aligned takes the vector path for its leading steps and a scalar
// loop for its tail; otherwise (a view that starts off alignment) it takes
// the scalar loop throughout. Each segment decides for itself.
//
// The arithmetic is IEEE: a correctly rounded division (never a multiply by
// a reciprocal) and a correctly rounded subtraction, in the table, then
// round-to-nearest-even to bfloat16. The build uses no fast-math flag.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // vector loads in flight per thread
constexpr int kMaxSegments = 4;

// A vector step of a lane: 16 bytes of output, so that a warp's store
// instruction writes 512 contiguous bytes (whole 32-byte sectors), from
// 16 / sizeof(T) input bytes (8 for bfloat16, 4 for float32).
template <typename T> struct Vec;
template <> struct Vec<float> { using In = uint32_t; static constexpr int kElems = 4; };
template <> struct Vec<__nv_bfloat16> { using In = uint2; static constexpr int kElems = 8; };

struct Segment {
    const uint8_t* x;
    void* out;
    long long n;      // elements
    long long n_vec;  // leading vector steps on the vector path (0: unaligned)
    int first_block;  // the segment's blocks are [first_block, first_block + blocks)
    int blocks;
};

struct Segments {
    Segment seg[kMaxSegments];
    int count;
};

__device__ __forceinline__ float dequant(uint32_t byte) {
    return __fsub_rn(__fdiv_rn(static_cast<float>(byte), 127.5f), 1.0f);
}

// table[v][lane]: the result for byte v, one copy per lane
using Table = float[256][32];
static_assert(kThreads == 256, "one thread per byte value fills the table");

__device__ __forceinline__ float look_up(const Table& table, uint32_t word, int j, int lane) {
    return table[(word >> (8 * j)) & 0xffu][lane];
}

__device__ __forceinline__ void convert_store(float* out, uint32_t in, const Table& table, int lane) {
    *reinterpret_cast<float4*>(out) = make_float4(
        look_up(table, in, 0, lane), look_up(table, in, 1, lane),
        look_up(table, in, 2, lane), look_up(table, in, 3, lane));
}

__device__ __forceinline__ void convert_store(__nv_bfloat16* out, uint2 in, const Table& table, int lane) {
    const uint32_t words[2] = {in.x, in.y};
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t word = words[k >> 1];
        const int j = 2 * (k & 1);
        const __nv_bfloat162 pair =
            __floats2bfloat162_rn(look_up(table, word, j, lane), look_up(table, word, j + 1, lane));
        w[k] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store1(float* out, float v) { *out = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, float v) {
    *out = __float2bfloat16_rn(v);
}

// the kUnroll vectors of one step of a thread's loop, loaded back to back
template <typename In>
__device__ __forceinline__ void load_vectors(In (&p)[kUnroll], const In* xv, long long base,
                                             long long stride, long long n_vec) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * stride;
        if (i < n_vec) p[u] = xv[i];
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const __grid_constant__ Segments segs) {
    using In = typename Vec<T>::In;
    constexpr int kElems = Vec<T>::kElems;
    // this block's segment: the last whose first block is at or below it
    // (selected field by field, so that no parameter is indexed at run time)
    const int block = static_cast<int>(blockIdx.x);
    Segment s = segs.seg[0];
#pragma unroll
    for (int k = 1; k < kMaxSegments; ++k) {
        if (k < segs.count && block >= segs.seg[k].first_block) s = segs.seg[k];
    }
    const long long stride = static_cast<long long>(s.blocks) * kThreads;
    const long long tid = static_cast<long long>(block - s.first_block) * kThreads + threadIdx.x;
    const In* xv = reinterpret_cast<const In*>(s.x);
    T* out = static_cast<T*>(s.out);

    // the first loads are in flight while the table is built
    In p[kUnroll];
    load_vectors(p, xv, tid, stride, s.n_vec);

    // each thread fills its byte value's row, lanes staggered across banks
    __shared__ Table table;
    const int lane = threadIdx.x & 31;
    {
        const float v = dequant(threadIdx.x);
#pragma unroll 8
        for (int k = 0; k < 32; ++k) table[threadIdx.x][(k + lane) & 31] = v;
    }
    __syncthreads();

    for (long long base = tid; base < s.n_vec; base += stride * kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const long long i = base + u * stride;
            if (i < s.n_vec) convert_store(out + i * kElems, p[u], table, lane);
        }
        load_vectors(p, xv, base + stride * kUnroll, stride, s.n_vec);
    }
    for (long long i = s.n_vec * kElems + tid; i < s.n; i += stride) {
        store1(out + i, table[s.x[i]][lane]);
    }
}

// Blocks of dequant_kernel<T> resident on the device at once (SMs x blocks
// an SM holds), asked once per device; 0 when the runtime cannot say.
template <typename T>
int wave_blocks(int device) {
    static int cached[64] = {0};
    if (device >= 0 && device < 64 && cached[device]) return cached[device];
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dequant_kernel<T>, kThreads, 0) !=
            cudaSuccess) {
        return 0;
    }
    const int wave = sms * per_sm;
    if (device >= 0 && device < 64) cached[device] = wave;
    return wave;
}

// Fills segs (empty segments dropped) and returns the grid size, 0 when
// there is nothing to do. `wave` is the blocks resident at once.
template <typename T>
int plan(const long long* args, int count, int wave_size, Segments& segs) {
    long long units[kMaxSegments];  // vector steps each segment's loops walk
    long long total = 0;
    segs.count = 0;
    for (int k = 0; k < count; ++k) {
        const long long n = args[3 * k + 2];
        if (n <= 0) continue;
        Segment& s = segs.seg[segs.count];
        s.x = reinterpret_cast<const uint8_t*>(args[3 * k]);
        s.out = reinterpret_cast<void*>(args[3 * k + 1]);
        s.n = n;
        constexpr int kElems = Vec<T>::kElems;
        const bool aligned = (reinterpret_cast<uintptr_t>(s.x) % kElems == 0) &&
                             (reinterpret_cast<uintptr_t>(s.out) % 16 == 0);
        s.n_vec = aligned ? n / kElems : 0;
        units[segs.count] = (n + kElems - 1) / kElems;
        total += units[segs.count];
        ++segs.count;
    }
    if (segs.count == 0) return 0;
    // enough blocks for kUnroll vectors a thread, at most one wave in all;
    // each segment's share by its bytes, rounded up, at least one block (the
    // rounding adds at most count - 1 blocks, kept inside the wave)
    const long long per_block = static_cast<long long>(kThreads) * kUnroll;
    long long want = (total + per_block - 1) / per_block;
    long long wave = static_cast<long long>(wave_size) - (segs.count - 1);
    if (wave < 1) wave = 1;
    if (want > wave) want = wave;
    int first = 0;
    for (int k = 0; k < segs.count; ++k) {
        long long b = (want * units[k] + total - 1) / total;
        if (b < 1) b = 1;
        segs.seg[k].first_block = first;
        segs.seg[k].blocks = static_cast<int>(b);
        first += static_cast<int>(b);
    }
    return first;
}

template <typename T>
int launch(const long long* args, int count, int device, cudaStream_t stream) {
    const int wave = wave_blocks<T>(device);
    if (wave == 0) return -4;
    Segments segs;
    const int grid = plan<T>(args, count, wave, segs);
    if (grid == 0) return 0;
    dequant_kernel<T><<<grid, kThreads, 0, stream>>>(segs);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// args: `count` triples (input pointer, output pointer, element count) as
// 64-bit integers, count in 1..4; dtype_code: 0 = float32, 1 = bfloat16; the
// kernel runs on `device` (made current for the launch and restored after)
// on `stream`. Returns 0, a CUDA error code, -2 for an unknown dtype code,
// -3 for a count out of range or -4 when the kernel's occupancy could not be
// read. Segments with no elements are skipped; with none left, nothing is
// launched.
extern "C" int dcvgan_dequant_segments(int dtype_code, int count, const long long* args, int device,
                                       void* stream) {
    if (dtype_code != 0 && dtype_code != 1) return -2;
    if (count < 1 || count > kMaxSegments) return -3;
    int previous = 0;
    cudaError_t err = cudaGetDevice(&previous);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (previous != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int rc = dtype_code == 0 ? launch<float>(args, count, device, s)
                                   : launch<__nv_bfloat16>(args, count, device, s);
    if (previous != device) cudaSetDevice(previous);
    return rc;
}
