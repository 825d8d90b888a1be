// K2: batched tiny equality-constrained QP, one thread per system, a block's
// systems staged through shared memory.
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
// step, and the earlier one-system-per-thread kernel's, so b and mu are
// bit-equal to that kernel's.  C is read row-major (batch, n, n), only its
// lower triangle.
//
// What bounds it on the card: at the fastrt selection's shape (3,648
// systems of n = 10) a call moves 1.8 MB and does about 3,648 * 700 flops:
// 0.53 us of HBM time.  The rest is the latency of the loads and of each
// thread's dependent chain of ~n^3/6 multiply-adds, and the launch.  The
// earlier kernel (4.0 us) ran 128 systems a block, 29 blocks on 132 SMs at
// 3,648 systems, and each thread read its own 400-byte system with scalar
// loads 400 bytes apart: 55 loads a thread, each touching 32 sectors.  The
// design:
// - a block is two warps, 64 systems (kThreads): 57 blocks at 3,648
//   systems and 157 at 10,000.  One warp a block (114 and 313 blocks)
//   would put the fewest systems on the busiest SM, but measured 0.1-0.3 us
//   slower at every path size (PERF.md), and 128 threads need more
//   than the 48 KB of static shared memory;
// - the block's C and r are contiguous spans, copied into shared memory
//   with cp.async (16-byte copies where the source address allows, 4-byte
//   ones elsewhere: a view of r at an odd system offset is not 16-byte
//   aligned);
// - in shared memory a system of C takes kStride floats, a multiple of 4
//   whose quarter is odd (100 for n = 10, 20 for n = 4), so thread s reads
//   its own C as float4s and the 8 threads of each quarter-warp hit 8
//   distinct groups of 4 banks; r (and then b, in r's place) is read and
//   written as float2 (n = 10) or float4 (n = 4) vectors, conflict-free by
//   the same count;
// - the factor stays in registers (template on n, fully unrolled, the
//   factor overwrites the lower triangle in place), and b goes back to
//   device memory as one coalesced span.
// Measured (PERF.md): 2.5 us at 3,648 systems (the earlier kernel: 4.0).
// A build without the copies reads 1.8-1.9 us, one without the
// factorisation 2.1 us, an empty launch 1.0 us: the staging and the launch
// set the time, not the per-thread chain (~0.4 us), so a system is not
// split over lanes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 64;  // systems per block

template <int N>
struct Layout {
  static_assert(N % 2 == 0, "systems are staged as float4 and float2 vectors");
  static constexpr int kC = N * N;  // floats of C per system, a multiple of 4
  static constexpr int kStride = (kC / 4) % 2 == 1 ? kC : kC + 4;
  static constexpr int kVec = N % 4 == 0 ? 4 : 2;  // r's and b's vector width
  static constexpr int kFloats = kThreads * (kStride + N);  // per block
};

// kVec floats at p (aligned to their size) into and out of registers
template <int kVec>
__device__ __forceinline__ void load_vec(float* dst, const float* p) {
  if constexpr (kVec == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    dst[0] = v.x; dst[1] = v.y;
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float* src) {
  if constexpr (kVec == 4)
    *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(src[0], src[1]);
}

// n floats from src to dst (dst 16-byte aligned), 16-byte copies where src
// allows, the tail and an unaligned src by 4-byte copies
__device__ __forceinline__ void copy_span(float* dst, const float* src, int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    const int n4 = n / 4 * 4;
    for (int i = 4 * threadIdx.x; i < n4; i += 4 * blockDim.x)
      mmd_async::copy16(dst + i, src + i);
    for (int i = n4 + threadIdx.x; i < n; i += blockDim.x)
      mmd_async::copy4(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) mmd_async::copy4(dst + i, src + i);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
eq_qp_kernel(const float* __restrict__ C, const float* __restrict__ r,
             float* __restrict__ b, float* __restrict__ mu, int batch) {
  using L = Layout<N>;
  __shared__ __align__(16) float sm[L::kFloats];
  float* Cs = sm;                          // (kThreads, kStride)
  float* rs = sm + kThreads * L::kStride;  // (kThreads, N): r, then b

  const long long s0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int here = static_cast<int>(min(static_cast<long long>(kThreads), batch - s0));
  const float* Cg = C + s0 * L::kC;
  // n = 10 keeps the span as it is; the per-system mapping below costs a
  // division per copy, 0.2 us of the kernel's 2.5 (PERF.md)
  if (L::kStride == L::kC) {
    copy_span(Cs, Cg, here * L::kC);
  } else if ((reinterpret_cast<uintptr_t>(Cg) & 15u) == 0) {
    for (int i = threadIdx.x; i < here * (L::kC / 4); i += blockDim.x) {
      const int s = i / (L::kC / 4), q = i % (L::kC / 4);
      mmd_async::copy16(Cs + s * L::kStride + 4 * q, Cg + 4 * i);
    }
  } else {
    for (int i = threadIdx.x; i < here * L::kC; i += blockDim.x)
      mmd_async::copy4(Cs + i / L::kC * L::kStride + i % L::kC, Cg + i);
  }
  copy_span(rs, r + s0 * N, here * N);
  mmd_async::commit();
  mmd_async::wait<0>();
  __syncthreads();

  const int s = threadIdx.x;
  if (s < here) {
    float a[N][N];  // lower triangle: C on entry, L after the factorisation
    {
      float c[L::kC];  // the upper triangle's loads are dead and dropped
#pragma unroll
      for (int q = 0; q < L::kC / 4; ++q)
        load_vec<4>(c + 4 * q, Cs + s * L::kStride + 4 * q);
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) a[i][j] = c[i * N + j];
    }
    float rv[N];
#pragma unroll
    for (int q = 0; q < N; q += L::kVec) load_vec<L::kVec>(rv + q, rs + s * N + q);

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
    float bv[N];
#pragma unroll
    for (int i = 0; i < N; ++i) bv[i] = z[i] - m * w[i];
#pragma unroll
    for (int q = 0; q < N; q += L::kVec)  // b in r's place
      store_vec<L::kVec>(rs + s * N + q, bv + q);
    mu[s0 + s] = m;
  }
  __syncthreads();
  float* bg = b + s0 * N;
  for (int i = threadIdx.x; i < here * N; i += blockDim.x) bg[i] = rs[i];
}

template <int N>
int launch(const float* C, const float* r, float* b, float* mu, int batch,
           cudaStream_t stream) {
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
