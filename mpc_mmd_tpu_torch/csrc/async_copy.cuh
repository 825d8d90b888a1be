// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by the kernels that stage their operands through shared memory while they
// compute (K3 topk_kernel.cu, K4 rollout.cu).  A copy is issued by one
// thread, lands in shared memory without passing through its registers, and
// is waited for per thread with a commit group; a __syncthreads() after the
// wait makes every thread's copies visible to the block.

#pragma once

#include <cuda_runtime.h>

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

}  // namespace mmd_async
