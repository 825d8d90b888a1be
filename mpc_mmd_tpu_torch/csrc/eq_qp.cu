// K2: batched tiny equality-constrained QP, one thread per system.
//
// Replaces the TPU kernel mpc_mmd_tpu/ops/qp_pallas.py::eq_qp_solve_pallas
// and its lane-major entry eq_qp_solve_pallas_t (pl.pallas_call at
// qp_pallas.py:109, body _qp_kernel at :31-81).  Both TPU entries share that
// body; this kernel is its one port.
//
// Solves  min_b 1/2 b^T C b - r^T b  s.t.  sum(b) = 1  for SPD C (n x n):
// Cholesky C = L L^T unrolled with rsqrt of the pivot, z = C^-1 r and
// w = C^-1 1 by forward and backward substitution, mu = (sum z - 1)/sum w,
// b = z - mu w.  The arithmetic sequence is the Pallas body's, step for
// step.  C is read row-major (batch, n, n), only its lower triangle.
//
// What bounds it on the card: at the main path's shape (3648 systems of
// n = 10) the kernel moves 1.6 MB and does about 3648 * 700 flops: both are
// microseconds, so it is bound by the latency of each thread's dependent
// chain of ~n^3/6 multiply-adds and by the launch.  The design keeps the
// whole factor in registers (template on n, fully unrolled, the factor
// overwrites the lower triangle in place) so nothing but C, r, b and mu
// touches memory.  Each thread reads its own 400-byte system, so a warp's
// loads are strided, not coalesced; at 1.6 MB per call that costs little
// and is left for a later change (stage through shared memory).

#include <cuda_runtime.h>

namespace {

template <int N>
__global__ void eq_qp_kernel(const float* __restrict__ C,
                             const float* __restrict__ r,
                             float* __restrict__ b, float* __restrict__ mu,
                             int batch) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= batch) return;
  const float* Cs = C + static_cast<long long>(s) * N * N;
  const float* rs = r + static_cast<long long>(s) * N;

  float a[N][N];  // lower triangle: C on entry, L after the factorisation
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) a[i][j] = Cs[i * N + j];

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
    float sz = rs[i];
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
  float* bs = b + static_cast<long long>(s) * N;
#pragma unroll
  for (int i = 0; i < N; ++i) bs[i] = z[i] - m * w[i];
  mu[s] = m;
}

template <int N>
int launch(const float* C, const float* r, float* b, float* mu, int batch,
           cudaStream_t stream) {
  constexpr int kThreads = 128;
  eq_qp_kernel<N><<<(batch + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      C, r, b, mu, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n must be one of the instantiated sizes; returns cudaErrorInvalidValue
// otherwise (the wrapper checks first).
extern "C" int mmd_eq_qp_solve(const float* C, const float* r, float* b,
                               float* mu, int batch, int n, void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4: return launch<4>(C, r, b, mu, batch, st);
    case 10: return launch<10>(C, r, b, mu, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
