// The Hopper (sm_90a) layer that fused_block.cu's and fused_up.cu's TMA
// kernels share: shared-memory addresses and the 128-byte swizzle, mbarriers,
// TMA loads and their tensor maps, ldmatrix, and wgmma with A in registers and
// B a K-major swizzled tile in shared memory. What differs between the two
// kernels (their prologues, parameters, tiles and layouts) stays in their own
// files. ops/build.py folds every csrc/*.cuh into each library's hash.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

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

// Operand lists of a wgmma m64nN: accumulator registers d[i..i+3], the four
// A registers a[0..3], and the PTX operand numbers of N / 2 accumulators.
// They stay defined for an includer's own wgmma forms (fused_block's TF32).
#define WG_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_A4 "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])
#define WG_D8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_D16 WG_D8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_D32 WG_D16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_D48 WG_D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define WG_D64 WG_D48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_D80 WG_D64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define WG_D96 WG_D80 ", %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"

// acc(64 x N, f32) (+)= A(64 x 16, bf16 registers) * B(16 x N, bf16 K-major in
// shared memory); the product overwrites acc where `accumulate` is 0.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc, int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" WG_D8 "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : WG_ACC4(0), WG_ACC4(4)
      : WG_A4, "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" WG_D16 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : WG_ACC4(0), WG_ACC4(4), WG_ACC4(8), WG_ACC4(12)
      : WG_A4, "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_D32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WG_ACC4(0), WG_ACC4(4), WG_ACC4(8), WG_ACC4(12), WG_ACC4(16), WG_ACC4(20), WG_ACC4(24), WG_ACC4(28)
      : WG_A4, "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {" WG_D48 "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : WG_ACC4(0), WG_ACC4(4), WG_ACC4(8), WG_ACC4(12), WG_ACC4(16), WG_ACC4(20), WG_ACC4(24), WG_ACC4(28),
        WG_ACC4(32), WG_ACC4(36), WG_ACC4(40), WG_ACC4(44)
      : WG_A4, "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_D64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WG_ACC4(0), WG_ACC4(4), WG_ACC4(8), WG_ACC4(12), WG_ACC4(16), WG_ACC4(20), WG_ACC4(24), WG_ACC4(28),
        WG_ACC4(32), WG_ACC4(36), WG_ACC4(40), WG_ACC4(44), WG_ACC4(48), WG_ACC4(52), WG_ACC4(56), WG_ACC4(60)
      : WG_A4, "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {" WG_D96 "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : WG_ACC4(0), WG_ACC4(4), WG_ACC4(8), WG_ACC4(12), WG_ACC4(16), WG_ACC4(20), WG_ACC4(24), WG_ACC4(28),
        WG_ACC4(32), WG_ACC4(36), WG_ACC4(40), WG_ACC4(44), WG_ACC4(48), WG_ACC4(52), WG_ACC4(56), WG_ACC4(60),
        WG_ACC4(64), WG_ACC4(68), WG_ACC4(72), WG_ACC4(76), WG_ACC4(80), WG_ACC4(84), WG_ACC4(88), WG_ACC4(92)
      : WG_A4, "l"(desc), "r"(accumulate));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; reach it through the runtime, no -lcuda.
inline EncodeTiled encode_tiled() {
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

// A 3-D map with the 128-byte swizzle, dims innermost first, strides of dims
// 1 and 2 in bytes.
inline bool encode_3d(CUtensorMap* map, CUtensorMapDataType type, const void* base, const cuuint64_t (&dims)[3],
                      const cuuint64_t (&strides)[2], const cuuint32_t (&box)[3]) {
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
