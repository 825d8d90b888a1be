// Kernel (c)'s "fused" form (inner_cem.cu's note): its instantiations, for
// the laplace kernel at every k and column count, in a translation unit of
// their own so that nvcc builds them beside the other forms'.

#include <cuda_runtime.h>

#include "inner_cem_body.cuh"

namespace mmd_cem {

int launch_fused(const Args& a, const Layout (&L)[3], int C, int k, int slots,
                 cudaStream_t stream) {
  return launch_k<true>(a, L, C, k, slots, stream);
}

}  // namespace mmd_cem
