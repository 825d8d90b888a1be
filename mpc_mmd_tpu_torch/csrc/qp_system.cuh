// K2's solve of one tiny equality-constrained QP on one thread, shared by
// K2 (eq_qp.cu, both layouts) and kernel (c) (inner_cem.cu), so that equal
// systems give equal bits in all three.  eq_qp.cu's note has the method.

#pragma once

#include <cuda_runtime.h>

namespace mmd_qp {

// The Pallas body's arithmetic on one system, step for step: a holds C's
// lower triangle on entry and L after; b and mu out.  Both entries run it,
// so equal systems give equal bits in either layout (and in kernel (c)).
template <int N>
__device__ __forceinline__ float solve_system(float (&a)[N][N], const float (&rv)[N],
                                              float (&bv)[N]) {
  float inv_diag[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float sj = a[j][j];
#pragma unroll
    for (int p = 0; p < j; ++p) sj = sj - a[j][p] * a[j][p];
    const float inv_d = rsqrtf(sj);
    inv_diag[j] = inv_d;
    a[j][j] = sj * inv_d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float t = a[i][j];
#pragma unroll
      for (int p = 0; p < j; ++p) t = t - a[i][p] * a[j][p];
      a[i][j] = t * inv_d;
    }
  }

  float z[N], w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {  // forward: L y = v
    float sz = rv[i];
    float sw = 1.0f;
#pragma unroll
    for (int p = 0; p < i; ++p) {
      sz = sz - a[i][p] * z[p];
      sw = sw - a[i][p] * w[p];
    }
    z[i] = sz * inv_diag[i];
    w[i] = sw * inv_diag[i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {  // backward: L^T x = y
    float sz = z[i];
    float sw = w[i];
#pragma unroll
    for (int p = i + 1; p < N; ++p) {
      sz = sz - a[p][i] * z[p];
      sw = sw - a[p][i] * w[p];
    }
    z[i] = sz * inv_diag[i];
    w[i] = sw * inv_diag[i];
  }

  float sum_z = z[0], sum_w = w[0];
#pragma unroll
  for (int i = 1; i < N; ++i) {
    sum_z = sum_z + z[i];
    sum_w = sum_w + w[i];
  }
  const float m = (sum_z - 1.0f) / sum_w;
#pragma unroll
  for (int i = 0; i < N; ++i) bv[i] = z[i] - m * w[i];
  return m;
}

}  // namespace mmd_qp
