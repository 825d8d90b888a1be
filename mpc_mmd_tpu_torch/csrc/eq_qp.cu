// K2: batched tiny equality-constrained QP, one thread per system, in two
// layouts.
//
// Replaces the TPU kernel mpc_mmd_tpu/ops/qp_pallas.py: its pl.pallas_call
// (qp_pallas.py:109, body _qp_kernel at :31-81) is reached by the row-major
// entry eq_qp_solve_pallas (:131, which transposes) and by the lane-major
// eq_qp_solve_pallas_t (:85).  Here mmd_eq_qp_solve takes the row-major
// operands (a block's systems staged through shared memory, below) and
// mmd_eq_qp_solve_t the lane-major ones (the "xt" selection's, see
// eq_qp_t_kernel).  Both run one body, solve_system.
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
//   slower at every path size up to n = 10 (PERF.md);
// - the block's C and r are contiguous spans, copied into shared memory
//   with cp.async (16-byte copies where the source address allows, 4-byte
//   ones elsewhere: a view of r at an odd system offset is not 16-byte
//   aligned);
// - in shared memory a system of C takes kStride floats.  For even n a
//   multiple of 4 whose quarter is odd (100 for n = 10, 20 for n = 4), so
//   thread s reads its own C as float4s and the 8 threads of each
//   quarter-warp hit 8 distinct groups of 4 banks.  For odd n, C's own n^2,
//   odd, so the span is copied as it lies and thread s reads its lower
//   triangle as scalars, a warp's 32 reads in 32 distinct banks: mapping
//   each element to a padded stride took 4-byte copies with a division
//   each and read 11.2 us at 8,900 systems of n = 15, the span copy 4.6 us.
//   r (and then b, in r's place) is read and written as float4, float2 or
//   scalars by n mod 4;
// - the factor stays in registers (template on n, fully unrolled, the
//   factor overwrites the lower triangle in place), and b goes back to
//   device memory as one coalesced span.
// Measured (PERF.md): 2.5 us at 3,648 systems (the earlier kernel: 4.0).
// A build without the copies reads 1.8-1.9 us, one without the
// factorisation 2.1 us, an empty launch 1.0 us: the staging and the launch
// set the time, not the per-thread chain (~0.4 us), so a system is not
// split over lanes.
//
// Every n = 2 ... 16 is instantiated (the Pallas body unrolls any n; its
// docstring gives the range n <= ~16).  Past n = 13, 64 systems would
// stage 53.8-70.7 KB, above the 48 KB of static shared memory.  Of the two
// ways out, 64 systems on dynamic shared memory past 48 KB read 3.72 and
// 5.25 us at 8,900 systems of n = 14 and 16, 32 systems a block (one warp,
// static) 3.65 and 5.11 (utils/kernel_ab.py in turns on an H100, PERF.md):
// n >= 14 takes 32 a block (Layout::kSystems).  The factor's lower
// triangle, n(n+1)/2 floats, is n = 16's largest array: nvcc -Xptxas -v
// gives 210 registers a thread there (192 at n = 15, 189 at 14) and a
// 0-byte stack frame at every n in both entries, so a system stays on one
// thread with its factor in registers; neither a split over two threads
// nor a factor in shared memory is needed.  The solve keeps the Pallas
// body's arithmetic: a non-positive pivot gives NaN under rsqrt, as there.
//
// The lane-major entry moves the same bytes.  There the layout itself
// coalesces: one element of C for 32 consecutive systems is 32 consecutive
// words, so each thread loads its lower triangle straight from device
// memory (55 loads for n = 10, each a full 128-byte line per warp) and
// writes b the same way, with no shared memory and no barrier.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "qp_system.cuh"

namespace {

using mmd_qp::solve_system;

constexpr int kThreads = 64;  // systems per block (half that past 48 KB of staging)
constexpr int kMinN = 2, kMaxN = 16;  // the sizes instantiated
constexpr int kStaticSmem = 48 * 1024;  // bytes of static shared memory a block gets

template <int N>
struct Layout {
  static constexpr int kC = N * N;                  // floats of C per system
  // Even n: a multiple of 4 whose quarter is odd, so that a thread's float4
  // reads of its own system are conflict-free.  Odd n: C's own stride, odd,
  // so that a warp's scalar reads hit 32 distinct banks, and the block's
  // span is copied as it lies.
  static constexpr int kStride = N % 2 == 1 ? kC : (kC / 4) % 2 == 1 ? kC : kC + 4;
  // r's and b's vector width: a system's r starts at a multiple of it
  static constexpr int kVec = N % 4 == 0 ? 4 : N % 2 == 0 ? 2 : 1;
  // systems a block: 64, or 32 where 64 would stage more than 48 KB (n >= 14)
  static constexpr int kSystems =
      kThreads * (kStride + N) * 4 <= kStaticSmem ? kThreads : kThreads / 2;
  static constexpr int kFloats = kSystems * (kStride + N);  // per block
};

// kVec floats at p (aligned to their size) into and out of registers
template <int kVec>
__device__ __forceinline__ void load_vec(float* dst, const float* p) {
  if constexpr (kVec == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else if constexpr (kVec == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    dst[0] = v.x; dst[1] = v.y;
  } else {
    dst[0] = *p;
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float* src) {
  if constexpr (kVec == 4)
    *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
  else if constexpr (kVec == 2)
    *reinterpret_cast<float2*>(p) = make_float2(src[0], src[1]);
  else
    *p = src[0];
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
__global__ void __launch_bounds__(Layout<N>::kSystems)
eq_qp_kernel(const float* __restrict__ C, const float* __restrict__ r,
             float* __restrict__ b, float* __restrict__ mu, int batch) {
  using L = Layout<N>;
  constexpr int kSys = L::kSystems;
  __shared__ __align__(16) float sm[L::kFloats];
  float* Cs = sm;                      // (kSys, kStride)
  float* rs = sm + kSys * L::kStride;  // (kSys, N): r, then b

  const long long s0 = static_cast<long long>(blockIdx.x) * kSys;
  const int here = static_cast<int>(min(static_cast<long long>(kSys), batch - s0));
  const float* Cg = C + s0 * L::kC;
  // where the stride is C's own (odd n, and n = 2, 6, 10, 14) the span is
  // copied as it is; the per-system mapping below costs a division per
  // copy, 0.2 us of the kernel's 2.5 at n = 10 (PERF.md)
  if constexpr (L::kStride == L::kC) {
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
    if constexpr (N % 2 == 1) {
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) a[i][j] = Cs[s * L::kStride + i * N + j];
    } else {
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

    float bv[N];
    const float m = solve_system<N>(a, rv, bv);
#pragma unroll
    for (int q = 0; q < N; q += L::kVec)  // b in r's place
      store_vec<L::kVec>(rs + s * N + q, bv + q);
    mu[s0 + s] = m;
  }
  __syncthreads();
  float* bg = b + s0 * N;
  for (int i = threadIdx.x; i < here * N; i += blockDim.x) bg[i] = rs[i];
}

// The lane-major entry: C_t (n*n, batch) with row i*n+j = C[..., i, j], r_t
// and b_t (n, batch).  Thread s reads element (i, j) of its system at
// C_t[(i*n + j)*batch + s], so a warp's loads of one element are 32
// consecutive words: coalesced straight from device memory, with nothing to
// stage.  Only the lower triangle is read.
template <int N>
__global__ void __launch_bounds__(kThreads)
eq_qp_t_kernel(const float* __restrict__ C_t, const float* __restrict__ r_t,
               float* __restrict__ b_t, float* __restrict__ mu, int batch) {
  const long long B = batch;
  const long long s = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= B) return;
  float a[N][N];  // lower triangle: C on entry, L after the factorisation
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) a[i][j] = __ldg(C_t + (i * N + j) * B + s);
  float rv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) rv[i] = __ldg(r_t + i * B + s);
  float bv[N];
  const float m = solve_system<N>(a, rv, bv);
#pragma unroll
  for (int i = 0; i < N; ++i) b_t[i * B + s] = bv[i];
  mu[s] = m;
}

template <int N, bool kLaneMajor>
int launch(const float* C, const float* r, float* b, float* mu, int batch,
           cudaStream_t stream) {
  if (kLaneMajor) {
    eq_qp_t_kernel<N><<<(batch + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        C, r, b, mu, batch);
  } else {
    constexpr int kSys = Layout<N>::kSystems;
    eq_qp_kernel<N><<<(batch + kSys - 1) / kSys, kSys, 0, stream>>>(C, r, b, mu, batch);
  }
  return static_cast<int>(cudaGetLastError());
}

// n = N, N + 1, ... kMaxN: the instantiation whose size is n
template <bool kLaneMajor, int N = kMinN>
int launch_n(const float* C, const float* r, float* b, float* mu, int batch, int n,
             cudaStream_t stream) {
  if (n == N) return launch<N, kLaneMajor>(C, r, b, mu, batch, stream);
  if constexpr (N < kMaxN)
    return launch_n<kLaneMajor, N + 1>(C, r, b, mu, batch, n, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kLaneMajor>
int solve(const float* C, const float* r, float* b, float* mu, int batch, int n,
          void* stream) {
  if (batch <= 0) return 0;
  return launch_n<kLaneMajor>(C, r, b, mu, batch, n, static_cast<cudaStream_t>(stream));
}

}  // namespace

// n must be one of the instantiated sizes, 2 ... 16; returns
// cudaErrorInvalidValue otherwise (the wrappers check first).  Row-major: C
// (batch, n, n), r and b (batch, n).
extern "C" int mmd_eq_qp_solve(const float* C, const float* r, float* b,
                               float* mu, int batch, int n, void* stream) {
  return solve<false>(C, r, b, mu, batch, n, stream);
}

// Lane-major: C_t (n*n, batch), r_t and b_t (n, batch); mu (batch,) either way.
extern "C" int mmd_eq_qp_solve_t(const float* C_t, const float* r_t, float* b_t,
                                 float* mu, int batch, int n, void* stream) {
  return solve<true>(C_t, r_t, b_t, mu, batch, n, stream);
}
