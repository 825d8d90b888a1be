// The JAX package's random numbers on the card: threefry-2x32 keys to bits,
// uniforms and normals (kernel a), and Beta draws (kernel b).
//
// Not TPU kernels: the JAX package draws through XLA's lowering of
// jax.random (threefry2x32 at jax/_src/prng.py:1092, normal at
// jax/_src/random.py:867, gamma's _gamma_one at random.py:1398 and beta at
// random.py:1133), called at mpc_mmd_tpu/solver.py:186,202,299,
// dynamics.py:91-120, sampling.py:38,142-150, reduced_set.py:432-466,
// solver_frenet.py:56-58 and validate.py:45-57,127.  The plain twins are
// mpc_mmd_tpu_torch/prng.py::draws and ::beta_draws.
//
// threefry-2x32: 20 rounds (rotations 13, 15, 26, 6 / 17, 29, 16, 24) with
// a key injection after every 4; the key schedule's third word is
// k0 ^ k1 ^ 0x1BD11BDA.  Partitionable bits (jax_threefry_partitionable, the
// default since jax 0.5): element i of a draw is out0 ^ out1 of the hash of
// the counter (i >> 32, i & 0xffffffff); split(key, n)[j] is the hash of
// (j >> 32, j) itself.  A uniform is the bits' 23 high bits as the mantissa
// of a float in [1, 2), minus 1; a normal maps that to [nextafter(-1, 0), 1)
// and applies sqrt(2) times the float32 erfinv polynomial lax.erf_inv lowers
// to (XLA's ErfInv32).
//
// Kernel a, one thread per (key, element) in a grid-stride loop: about 73
// integer operations a hash (3 a round, 2 an injection) and, for a normal,
// about 50 float operations.  What bounds it on the card: the integer
// operations.  At the Monte-Carlo validator's chunk (768 keys x 50,000
// normals) it writes 153.6 MB, 45.9 us at 3.35 TB/s, but hashes 38.4
// million counters, about 2.8 G integer operations, 168 us at the 16.7
// T/s of the H100's 64 INT32 lanes an SM.  Nothing to stage: every thread
// reads its key (L1-resident) and writes one word, neighbours on
// neighbouring addresses.
//
// Kernel b, one thread per element: derives the element's two keys (the
// halves of split(key), then split(half, n)[e]) and runs _gamma_one's
// Marsaglia-Tsang loops for a and for b in log space, with alpha < 1
// boosted to alpha + 1 and the boost log(u) / alpha added, as jax.random's
// loggamma does; the draw is G_a / (G_a + G_b) from the logs.  A round of
// the outer loop costs 3 hashes (split(key, 3)) plus 3 per round of the
// inner one (split, then the normal's bits); at the solves' parameters
// (alpha + 1 >= 1, so d >= 2/3) about 1.05 outer and 1.01 inner rounds an
// element, about 11 hashes a gamma, 26 an element with the key
// derivation: about 1,900 integer operations.  The candidates of a key
// share those hashes and the normals (a round's keys and bits depend only
// on the key, the element and the round), so the function needs them once
// a (key, element) and is bound by the candidates' own float operations
// (about 110 an element and 60 an outer round; chip_smoke.py phase 15
// counts this data's rounds).  This kernel redoes the chain for every
// candidate, about a hundred times the hashes the function needs at a
// solve's 100 candidates: sharing it (a warp an element) is open.  The
// loops diverge only where an element is rejected, about one lane in
// twenty.
//
// Built without fast-math.  XLA contracts three multiply-adds into one
// rounding (the uniform's affine map, the erfinv polynomial's steps and the
// gamma loop's 1 + x c): those are __fmaf_rn here, as the twin's prng.fma,
// and every other float operation is written with the _rn intrinsics, so
// nvcc contracts nothing else.  logf, log1pf, expf and sqrtf are the
// IEEE-accurate library functions, the ones PyTorch's own CUDA kernels
// call, so on the card the twin and the kernels agree bit for bit but for
// the twin's double-rounded fma (a tie about once in 2^29 operations;
// chip_smoke.py phase 15).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNormalLo = -0.99999994f;  // nextafter(-1, 0)
constexpr float kSqrt2 = 1.41421354f;
constexpr float kOneThird = 0.333333343f;
constexpr float kSqueeze = 0.0331f;

__constant__ float kErfInvLt5[9] = {
    2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f,
    0.00021858087f, -0.00125372503f, -0.00417768164f, 0.246640727f,
    1.50140941f};
__constant__ float kErfInvGe5[9] = {
    -0.000200214257f, 0.000100950558f, 0.00134934322f, -0.00367342844f,
    0.00573950773f, -0.0076224613f, 0.00943887047f, 1.00167406f,
    2.83297682f};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint2 threefry(uint2 k, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k.x ^ k.y ^ 0x1BD11BDAu;
  x0 += k.x;
  x1 += k.y;
#define MMD_ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
  MMD_ROUND(13) MMD_ROUND(15) MMD_ROUND(26) MMD_ROUND(6)
  x0 += k.y; x1 += k2 + 1u;
  MMD_ROUND(17) MMD_ROUND(29) MMD_ROUND(16) MMD_ROUND(24)
  x0 += k2; x1 += k.x + 2u;
  MMD_ROUND(13) MMD_ROUND(15) MMD_ROUND(26) MMD_ROUND(6)
  x0 += k.x; x1 += k.y + 3u;
  MMD_ROUND(17) MMD_ROUND(29) MMD_ROUND(16) MMD_ROUND(24)
  x0 += k.y; x1 += k2 + 4u;
  MMD_ROUND(13) MMD_ROUND(15) MMD_ROUND(26) MMD_ROUND(6)
  x0 += k2; x1 += k.x + 5u;
#undef MMD_ROUND
  return make_uint2(x0, x1);
}

// split(key, n)[i], or the hash behind element i of a draw
__device__ __forceinline__ uint2 hash_index(uint2 k, unsigned long long i) {
  return threefry(k, static_cast<uint32_t>(i >> 32), static_cast<uint32_t>(i));
}

__device__ __forceinline__ uint32_t bits_at(uint2 k, unsigned long long i) {
  const uint2 h = hash_index(k, i);
  return h.x ^ h.y;
}

__device__ __forceinline__ float unit(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

__device__ __forceinline__ float erfinv32(float x) {
  float w = -log1pf(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? kErfInvLt5[0] : kErfInvGe5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    p = __fmaf_rn(p, w, lt ? kErfInvLt5[i] : kErfInvGe5[i]);
  }
  return fabsf(x) == 1.0f ? __fmul_rn(x, INFINITY) : __fmul_rn(p, x);
}

__device__ __forceinline__ float normal_of(uint32_t bits) {
  // uniform on [lo, 1): u * (1 - lo) + lo with 1 - lo rounded to 2
  const float u = fmaxf(kNormalLo, __fmaf_rn(unit(bits), 2.0f, kNormalLo));
  return __fmul_rn(kSqrt2, erfinv32(u));
}

__device__ __forceinline__ uint2 load_key(const long long* keys, long long k) {
  return make_uint2(static_cast<uint32_t>(keys[2 * k]),
                    static_cast<uint32_t>(keys[2 * k + 1]));
}

// dist: 0 bits (uint32 words), 1 uniform, 2 normal (float32); out (K, n)
__global__ void draws_kernel(const long long* __restrict__ keys, long long K,
                             long long n, int dist, void* __restrict__ out) {
  for (long long k = blockIdx.y; k < K; k += gridDim.y) {
    const uint2 key = load_key(keys, k);
    for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
         i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
      const uint32_t b = bits_at(key, static_cast<unsigned long long>(i));
      const long long at = k * n + i;
      if (dist == 0) {
        static_cast<uint32_t*>(out)[at] = b;
      } else {
        static_cast<float*>(out)[at] = dist == 1 ? unit(b) : normal_of(b);
      }
    }
  }
}

// _gamma_one's loop condition: both acceptance tests fail
__device__ __forceinline__ bool rejected(float X, float V, float U, float d) {
  const bool squeeze = U >= __fsub_rn(1.0f, __fmul_rn(kSqueeze, __fmul_rn(X, X)));
  const float rhs = __fadd_rn(__fmul_rn(X, 0.5f),
                              __fmul_rn(d, __fadd_rn(__fsub_rn(1.0f, V), logf(V))));
  return squeeze && logf(U) >= rhs;
}

// log of a Gamma(alpha) draw from the element key k (jax.random.loggamma)
__device__ float gamma_log(uint2 k, float alpha) {
  const bool boost = alpha >= 1.0f;
  const float a = boost ? alpha : __fadd_rn(alpha, 1.0f);
  const float d = __fsub_rn(a, kOneThird);
  const float c = __fdiv_rn(kOneThird, __fsqrt_rn(d));
  const uint2 sub = hash_index(k, 1);
  k = hash_index(k, 0);
  float X = 0.0f, V = 1.0f, U = 2.0f;
  while (rejected(X, V, U, d)) {
    uint2 xk = hash_index(k, 1);
    const uint2 uk = hash_index(k, 2);
    k = hash_index(k, 0);
    float x = 0.0f, v = -1.0f;
    while (v <= 0.0f) {
      const uint2 s = hash_index(xk, 1);
      xk = hash_index(xk, 0);
      x = normal_of(bits_at(s, 0));
      v = __fmaf_rn(x, c, 1.0f);
    }
    X = __fmul_rn(x, x);
    V = __fmul_rn(__fmul_rn(v, v), v);
    U = unit(bits_at(uk, 0));
  }
  const float log_u = log1pf(-unit(bits_at(sub, 0)));
  const float log_boost = (boost || log_u == 0.0f)
                              ? 0.0f
                              : __fmul_rn(log_u, __fdiv_rn(1.0f, alpha));
  return __fadd_rn(__fadd_rn(logf(d), logf(V)), log_boost);
}

// out (K, B, n): row (k, b), element e from keys[k] with parameters
// alpha, beta (K, B, P) at (k, b, e mod P)
__global__ void beta_kernel(const long long* __restrict__ keys,
                            const float* __restrict__ alpha,
                            const float* __restrict__ beta, long long K,
                            long long B, long long n, long long P,
                            float* __restrict__ out) {
  const long long total = K * B * n;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = idx / n;
    const long long e = idx - row * n;
    const long long p = row * P + e % P;
    const uint2 root = load_key(keys, row / B);
    const unsigned long long ue = static_cast<unsigned long long>(e);
    const float lga = gamma_log(hash_index(hash_index(root, 0), ue), alpha[p]);
    const float lgb = gamma_log(hash_index(hash_index(root, 1), ue), beta[p]);
    const float log_max = (isnan(lga) || isnan(lgb)) ? NAN : fmaxf(lga, lgb);
    const float ga = expf(__fsub_rn(lga, log_max));
    const float gb = expf(__fsub_rn(lgb, log_max));
    out[idx] = __fdiv_rn(ga, __fadd_rn(ga, gb));
  }
}

int blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < 65535 ? (b > 0 ? b : 1) : 65535);
}

}  // namespace

extern "C" int mmd_prng_draws(const long long* keys, long long K, long long n,
                              int dist, void* out, void* stream) {
  if (K <= 0 || n <= 0) return 0;
  if (dist < 0 || dist > 2) return cudaErrorInvalidValue;
  const dim3 grid(blocks_for(n), static_cast<unsigned>(K < 65535 ? K : 65535));
  draws_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, K, n, dist, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mmd_prng_beta(const long long* keys, const float* alpha,
                             const float* beta, long long K, long long B,
                             long long n, long long P, float* out,
                             void* stream) {
  if (K <= 0 || B <= 0 || n <= 0) return 0;
  if (P <= 0 || n % P != 0) return cudaErrorInvalidValue;
  beta_kernel<<<blocks_for(K * B * n), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(keys, alpha, beta, K, B, n,
                                                     P, out);
  return static_cast<int>(cudaGetLastError());
}
