// Kernel (g): the Frenet coordinates (s, l) of the on-road solve's rollout
// points, four threads a point, in one launch an outer iteration.
//
// Replaces what XLA fuses from the JAX package's conversion of the
// rollouts (mpc_mmd_tpu/frenet.py:229 global_to_frenet_points through
// _frame_at :168, called at solver_frenet.py:197), which the port ran as
// frenet.global_to_frenet_points (frenet.py: _nearest's two (points, path)
// distance buffers and argmin, the gathers, interp's searchsorted, wheres
// and arithmetic twice, the lateral offset): about 78 PyTorch launches an
// outer iteration at Path D.  Like kernels (a) to (f) it replaces an XLA
// lowering, not a Pallas kernel.
//
// Per point (x, y), against the path (x_path, y_path, Fx_dot, Fy_dot,
// arc_vec) staged in shared memory (600 points, 12 KB at Path D):
//   idx = argmin_j (x - x_j)^2 + (y - y_j)^2, the first index of the
//     least value, a NaN distance counting as least (torch.argmin);
//   s = arc_vec[idx];
//   tx, ty = interp(s, arc_vec, Fx_dot / Fy_dot) in frenet.interp's own
//     arithmetic: the right-side insertion point of s (PyTorch's binary
//     search) clipped to [1, n - 1], the interval's slope, an interval no
//     wider than spacing(eps) taking its left value, both end clamps;
//   l = (-ty (x - x_idx) + tx (y - y_idx)) / sqrt(ty ty + tx tx).
// Every operation rounds on its own, as PyTorch's elementwise kernels do
// (__f*_rn: no contraction into fused multiply-adds; IEEE division and
// square root), so that s and l carry the chain's bits.
//
// What bounds it on the card: at Path D (20,000 points, a path of 600) it
// reads 0.17 MB and writes 0.16 MB (0.1 us at 3.35 TB/s) and does about 5
// operations a (point, path point) pair, 6e7 in all: 0.9 us at 67
// TFLOP/s.  The scan over the path is split over four neighbouring
// threads, a quarter of the path each in order (each keeps its quarter's
// first least distance), merged by shuffles under argmin's rule: a NaN
// first, then the smaller value, then the lower index.  The threads of a
// warp read the same path point (a broadcast); the chain replaced the scan
// with two 48 MB buffers.  (One thread a point took 19.9 us at Path D,
// PERF.md §6: 79 CTAs, each thread's 600 dependent steps.)

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSplit = 4;                    // threads a point
constexpr int kPoints = kThreads / kSplit;   // points a CTA
constexpr size_t kMaxSmem = 227 * 1024;

// Whether (d, j) comes before (best, idx) under torch.argmin's rule.
__device__ __forceinline__ bool before(float d, int j, float best, int idx) {
  if (d != d) return best == best || j < idx;
  if (best != best) return false;
  return d < best || (d == best && j < idx);
}

// PyTorch's searchsorted(right=True) on the card: the first index whose
// value is greater than v
__device__ __forceinline__ int upper_bound(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(a[mid] > v)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// frenet.interp(s, xp, fp) at the insertion point of s
__device__ __forceinline__ float interp(float s, const float* xp, const float* fp, int n,
                                        float tiny) {
  const int i = min(max(upper_bound(xp, n, s), 1), n - 1);
  const float df = __fsub_rn(fp[i], fp[i - 1]);
  const float dx = __fsub_rn(xp[i], xp[i - 1]);
  const float delta = __fsub_rn(s, xp[i - 1]);
  float f = fabsf(dx) <= tiny ? fp[i - 1]
                              : __fadd_rn(fp[i - 1], __fmul_rn(__fdiv_rn(delta, dx), df));
  if (s < xp[0]) f = fp[0];
  if (s > xp[n - 1]) f = fp[n - 1];
  return f;
}

__global__ void __launch_bounds__(kThreads)
frenet_points_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ x_path, const float* __restrict__ y_path,
                     const float* __restrict__ fx, const float* __restrict__ fy,
                     const float* __restrict__ arc, float* __restrict__ s_out,
                     float* __restrict__ l_out, int points, int n, float tiny) {
  extern __shared__ float path[];  // x, y, Fx_dot, Fy_dot, arc_vec: n each
  float* px = path;
  float* py = path + n;
  float* pfx = path + 2 * n;
  float* pfy = path + 3 * n;
  float* pa = path + 4 * n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    px[j] = x_path[j];
    py[j] = y_path[j];
    pfx[j] = fx[j];
    pfy[j] = fy[j];
    pa[j] = arc[j];
  }
  __syncthreads();
  const int p = blockIdx.x * kPoints + threadIdx.x / kSplit;
  const int part = threadIdx.x % kSplit;
  const bool live = p < points;
  const float xq = live ? x[p] : 0.0f, yq = live ? y[p] : 0.0f;
  // this thread's quarter of the path, in order: its first least distance
  const int per = (n + kSplit - 1) / kSplit;
  const int j0 = part * per, j1 = min(n, j0 + per);
  float best = INFINITY;
  int idx = 0x7fffffff;   // an empty quarter loses to any path point
  for (int j = j0; j < j1; ++j) {
    const float dx = __fsub_rn(xq, px[j]);
    const float dy = __fsub_rn(yq, py[j]);
    const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    if (before(d, j, best, idx)) {
      best = d;
      idx = j;
    }
  }
#pragma unroll
  for (int off = kSplit / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (before(ob, oi, best, idx)) {
      best = ob;
      idx = oi;
    }
  }
  if (!live || part != 0) return;
  const float s = pa[idx];
  const float tx = interp(s, pa, pfx, n, tiny);
  const float ty = interp(s, pa, pfy, n, tiny);
  const float num = __fadd_rn(__fmul_rn(-ty, __fsub_rn(xq, px[idx])),
                              __fmul_rn(tx, __fsub_rn(yq, py[idx])));
  const float den = __fsqrt_rn(__fadd_rn(__fmul_rn(ty, ty), __fmul_rn(tx, tx)));
  s_out[p] = s;
  l_out[p] = __fdiv_rn(num, den);
}

}  // namespace

// tiny: frenet.interp's spacing(eps) bound on an interval's width
extern "C" int mmd_frenet_points(const float* x, const float* y, const float* x_path,
                                 const float* y_path, const float* fx, const float* fy,
                                 const float* arc, float* s, float* l, int points, int n,
                                 float tiny, void* stream) {
  if (points <= 0) return 0;
  const size_t smem = 5 * static_cast<size_t>(n) * sizeof(float);
  if (n < 2 || smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool opted = false;  // past the 48 KB default, once
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        frenet_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  frenet_points_kernel<<<(points + kPoints - 1) / kPoints, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      x, y, x_path, y_path, fx, fy, arc, s, l, points, n, tiny);
  return static_cast<int>(cudaGetLastError());
}
