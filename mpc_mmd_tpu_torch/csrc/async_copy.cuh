// Asynchronous global -> shared copies (cp.async, sm_80 and later; TMA bulk
// copies onto an mbarrier, sm_90), shared by the kernels that stage their
// operands through shared memory while they compute (K3 topk_kernel.cu, K4
// and K4n rollout.cu, kernels (d) outer_project.cu and (f)
// inner_prologue.cu).  A copy is issued by one
// thread, lands in shared memory without passing through its registers, and
// is waited for per thread with a commit group; a __syncthreads() after the
// wait makes every thread's copies visible to the block.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mmd_async {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes, cached in L1 and L2 (.ca: the only variant below 16 bytes)
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes, both addresses 16-byte aligned; L2 only (.cg)
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- TMA bulk copies onto an mbarrier (kernels (d) and (f)): one thread
// initialises the barrier, fences, arms it with the bytes to come and
// issues the copies; every thread waits on its phase 0 ----
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// bytes (a multiple of 16) from a 16-byte aligned source to a 16-byte
// aligned destination in shared memory
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

}  // namespace mmd_async
