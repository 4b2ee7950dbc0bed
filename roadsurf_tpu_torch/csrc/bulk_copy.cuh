// Bulk copies from global to shared memory (cp.async.bulk, the non-tensor
// TMA, and its 2-D and 4-D tensor forms) whose bytes complete on a
// shared-memory mbarrier, the mbarrier operations, and the host's encoder of
// tensor maps, for the kernels of roi_align_staged.cuh, nms.cu,
// int8_gemm.cu, roi_align_backward.cu and rel_attention.cu. A barrier of a
// copy counts one arrival (the thread that issues the copies) and the bytes
// it expects; a consumer waits on the barrier's phase parity.

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace bulk {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Initialize `bar` for `count` arrivals a phase; call fence_init() after
// the block's barriers are initialized and before any copy is issued.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on `bar` and make its current phase wait for `bytes` of copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive on `bar` (one of its `count` arrivals).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed. A wait
// of more than 2^31 cycles (about a second) traps, so that a fault shows
// as a launch error and not as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  while (true) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 31)) __trap();
  }
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; the copy's bytes complete on `bar`.
__device__ __forceinline__ void copy(void* dst, const void* src,
                                     unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 2-D tensor copy of the box at (c0 along the inner dimension, c1) of `map`
// into shared memory (128-byte aligned); the box's bytes, those the tensor
// map fills with zeros past its edges included, complete on `bar`.
__device__ __forceinline__ void tensor_copy_2d(void* dst,
                                               const CUtensorMap* map,
                                               int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// 4-D tensor copy of the box at (c0 along the inner dimension, c1, c2, c3)
// of `map`, as tensor_copy_2d.
__device__ __forceinline__ void tensor_copy_4d(void* dst,
                                               const CUtensorMap* map,
                                               int c0, int c1, int c2, int c3,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda); nullptr when the driver lacks it.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace bulk
