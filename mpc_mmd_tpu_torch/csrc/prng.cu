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
// Kernel a's plan form: every Gaussian draw of a solve in one launch.  A
// solve's normals depend on nothing but its key table (threefry is
// counter-based), so the draws that the JAX package makes inside its outer
// loop (rollout noise and resample an iteration, the noisy initial states
// once) are drawn at the head of the solve: up to kPlanSegments segments,
// each a strided view of up to three axes of int64 key pairs read straight
// from the device key table, n draws a key, written to one buffer at the
// segment's offset.  The grid is 1-d over the concatenated (segment, key,
// element) space; a thread takes kPlanPer elements kPlanThreads apart, so
// that each store instruction of a warp writes neighbouring words and the
// thread's independent 20-round hash chains overlap on the INT32 pipe.
// Each element is draws_kernel's: the same bits_at, unit and normal_of.
//
// Kernel b, Beta draws for K keys x B candidates x n elements.  Element e
// of every candidate of key k draws from the same keys: the halves of
// split(key), then split(half, n)[e], and from there each gamma's chain of
// Marsaglia-Tsang rounds (an outer round: split(key, 3), a uniform U and
// the inner loop's normals from their own split chain).  A chain's keys,
// U and normals depend only on (key, element, half, round); a candidate
// brings only its alpha, hence its d and c, and its two acceptance tests.
// At the solves' parameters (alpha + 1 >= 1, d >= 2/3) a candidate takes
// about 1.05 outer and 1.01 inner rounds; a chain, the rounds its slowest
// candidate takes, about 2.1 and 2.1 at 100 candidates.  Hashing a chain
// once for all candidates leaves about 2 hashes a key and 23 a chain
// (73 integer operations each), against about 26 a candidate element
// (about 1,900 integer operations) when each candidate redoes its chain:
// the function is bound by the candidates' float operations (about 110 an
// element and 60 an outer round; chip_smoke.py phase 15 counts this
// data's rounds).  A kernel that shares the chains then waits on their
// latency: a round's key lies r + 3 dependent hashes from the root.
//
// B > 1, beta_shared_kernel: a block takes one key, a tile of ET elements
// and BT candidates (BT ET <= 512 pairs, 2 a thread).  Chain phase, lanes
// over (chain, round): one task a (half, element, round) for the first
// kRounds = 3 outer rounds, each deriving its round's key from the root
// and writing U, log U and the inner normals up to the first that c =
// 0.408 (alpha = 0, the largest c of any alpha >= 0) accepts, at most two,
// to shared memory.  Candidate phase, lanes over (candidate, element),
// after one barrier: each thread runs its four gammas' rounds with its own
// d and c from there; past the cached normals, or past the cached rounds
// (a candidate rejected three times, about 1e-4 of them), a candidate
// walks its chain's keys on itself, as beta_kernel does, so the result is
// exact at any depth.  No round is computed on demand: a block-wide vote
// a round (measured: 12.5 us at Path A's shape) cost more barriers than
// the rounds it saves.  Every candidate runs the float operations of
// beta_kernel in the same order (logf(U) taken once a chain, logf(d) and
// 1 / alpha once a candidate in both, the same values), so the two give
// the same bits.  What bounds it now is a block's latency: clock64() stamps
// (utils/kernel_ab.py --diagnose) put about half of a block's cycles in
// the chain phase's dependent hashes (a round-2 task hashes 7 deep before
// its normal), a fifth in the candidates' rounds, and the rest in the
// candidates' constants (sqrt, two divisions, logf) and the output.
//
// B = 1 (the validator's chunks), beta_kernel: nothing to share; one
// thread an element derives the keys and runs both gammas' loops.
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

// _gamma_one's loop condition: both acceptance tests fail (given the logs
// of V and U)
__device__ __forceinline__ bool rejected_logs(float X, float V, float log_V, float U,
                                              float log_U, float d) {
  const bool squeeze = U >= __fsub_rn(1.0f, __fmul_rn(kSqueeze, __fmul_rn(X, X)));
  const float rhs = __fadd_rn(__fmul_rn(X, 0.5f),
                              __fmul_rn(d, __fadd_rn(__fsub_rn(1.0f, V), log_V)));
  return squeeze && log_U >= rhs;
}

__device__ __forceinline__ bool rejected(float X, float V, float U, float d) {
  return rejected_logs(X, V, logf(V), U, logf(U), d);
}

// a candidate's Marsaglia-Tsang constants: alpha < 1 boosted to alpha + 1;
// logf(d) and 1 / alpha for the result
struct GammaParams {
  float d, c, log_d, inv_alpha;
  bool boost;
};

__device__ __forceinline__ GammaParams gamma_params(float alpha) {
  GammaParams g;
  g.boost = alpha >= 1.0f;
  const float a = g.boost ? alpha : __fadd_rn(alpha, 1.0f);
  g.d = __fsub_rn(a, kOneThird);
  g.c = __fdiv_rn(kOneThird, __fsqrt_rn(g.d));
  g.log_d = logf(g.d);
  g.inv_alpha = __fdiv_rn(1.0f, alpha);
  return g;
}

// the log of the draw once the loop has left logf(V), with the boost
// log(u) / alpha
__device__ __forceinline__ float gamma_finish(const GammaParams& g, float log_V,
                                              float log_u) {
  const float log_boost = (g.boost || log_u == 0.0f) ? 0.0f
                                                     : __fmul_rn(log_u, g.inv_alpha);
  return __fadd_rn(__fadd_rn(g.log_d, log_V), log_boost);
}

// the inner loop from key xk: the first normal x with v = 1 + x c > 0
__device__ __forceinline__ void inner_walk(uint2 xk, float c, float& x, float& v) {
  while (v <= 0.0f) {
    const uint2 s = hash_index(xk, 1);
    xk = hash_index(xk, 0);
    x = normal_of(bits_at(s, 0));
    v = __fmaf_rn(x, c, 1.0f);
  }
}

// log of a Gamma(alpha) draw from the element key k (jax.random.loggamma)
__device__ float gamma_log(uint2 k, float alpha) {
  const GammaParams g = gamma_params(alpha);
  const uint2 sub = hash_index(k, 1);
  k = hash_index(k, 0);
  float X = 0.0f, V = 1.0f, U = 2.0f;
  while (rejected(X, V, U, g.d)) {
    const uint2 xk = hash_index(k, 1);
    const uint2 uk = hash_index(k, 2);
    k = hash_index(k, 0);
    float x = 0.0f, v = -1.0f;
    inner_walk(xk, g.c, x, v);
    X = __fmul_rn(x, x);
    V = __fmul_rn(__fmul_rn(v, v), v);
    U = unit(bits_at(uk, 0));
  }
  return gamma_finish(g, logf(V), log1pf(-unit(bits_at(sub, 0))));
}

__device__ __forceinline__ float beta_ratio(float lga, float lgb) {
  const float log_max = (isnan(lga) || isnan(lgb)) ? NAN : fmaxf(lga, lgb);
  const float ga = expf(__fsub_rn(lga, log_max));
  const float gb = expf(__fsub_rn(lgb, log_max));
  return __fdiv_rn(ga, __fadd_rn(ga, gb));
}

// B = 1 (the validator's chunks): one thread an element, nothing to share.
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
    out[idx] = beta_ratio(gamma_log(hash_index(hash_index(root, 0), ue), alpha[p]),
                          gamma_log(hash_index(hash_index(root, 1), ue), beta[p]));
  }
}

// B > 1: a block is a tile of one key's elements e0 .. e0 + ET - 1 and
// candidates b0 .. b0 + BT - 1 (BT * ET <= kTilePairs).  A chain is
// (half, element): its keys, each round's uniform U and the round's inner
// normals depend on nothing else.  Chain phase: one task a (chain, round)
// for the first kRounds rounds, spread over the block's threads, each
// deriving its round's key from the root and writing the round to shared
// memory.  Candidate phase: each thread runs its pairs' rounds from there.
constexpr int kBetaThreads = 256;
constexpr int kPairs = 2;            // (candidate, element) pairs a thread
constexpr int kRounds = 3;           // outer rounds a chain caches
constexpr int kCachedNormals = 2;    // inner normals a chain caches a round
constexpr int kMaxElements = 32;     // ET
constexpr int kMaxChains = 2 * kMaxElements;
constexpr int kTilePairs = kPairs * kBetaThreads;
// c = 1/3 / sqrt(d) of alpha = 0 (d = 2/3), the largest of any alpha >= 0:
// a round caches inner normals up to the first this c accepts, so every
// candidate with alpha >= 0 finds its normal in the cache
constexpr float kMaxC = 0.4082483f;

// a round of a chain, as the candidates read it
struct ChainRound {
  float U, log_U;
  float x[kCachedNormals];
  int nx;
  uint2 xk;                          // the inner key past the cached normals
};

__global__ void __launch_bounds__(kBetaThreads)
beta_shared_kernel(const long long* __restrict__ keys,
                   const float* __restrict__ alpha, const float* __restrict__ beta,
                   int B, int n, int P, int ET, int BT, unsigned tiles_e,
                   unsigned tiles_b, float* __restrict__ out) {
  __shared__ ChainRound s_round[kRounds][kMaxChains];
  __shared__ uint2 s_key_end[kMaxChains];   // the outer key past the cached rounds
  __shared__ float s_log_u[kMaxChains];     // the final uniform's log1p(-u)

  const unsigned tb = blockIdx.x % tiles_b;
  const unsigned te = (blockIdx.x / tiles_b) % tiles_e;
  const long long k = blockIdx.x / (tiles_b * tiles_e);
  const int e0 = te * ET, b0 = tb * BT;
  const int ne = n - e0 < ET ? n - e0 : ET;
  const int nb = B - b0 < BT ? B - b0 : BT;
  const int tid = threadIdx.x;

  // the pairs: pair p = (candidate b0 + p / ET, element e0 + el[j]), both
  // halves; row (k, b) of the output
  float par[kPairs][2];
  int el[kPairs];
  long long row[kPairs];
  bool valid[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int p = tid + j * kBetaThreads;
    el[j] = p % ET;
    valid[j] = p < nb * ET && el[j] < ne;
    row[j] = k * B + b0 + p / ET;
    const long long at = row[j] * P + (e0 + el[j]) % P;
    par[j][0] = valid[j] ? alpha[at] : 1.0f;
    par[j][1] = valid[j] ? beta[at] : 1.0f;
  }

  // chain phase: task t is round t / (2 ET) of chain t % (2 ET)
  const uint2 root = load_key(keys, k);
  for (int t = tid; t < 2 * ET * kRounds; t += kBetaThreads) {
    const int c = t % (2 * ET), r = t / (2 * ET);
    if (c % ET >= ne) continue;
    const uint2 ke = hash_index(hash_index(root, c / ET),
                                static_cast<unsigned long long>(e0 + c % ET));
    if (r == 0) s_log_u[c] = log1pf(-unit(bits_at(hash_index(ke, 1), 0)));
    uint2 kr = hash_index(ke, 0);
    for (int i = 0; i < r; ++i) kr = hash_index(kr, 0);
    ChainRound& cr = s_round[r][c];
    uint2 xk = hash_index(kr, 1);
    const uint2 uk = hash_index(kr, 2);
    if (r == kRounds - 1) s_key_end[c] = hash_index(kr, 0);
    cr.U = unit(bits_at(uk, 0));
    cr.log_U = logf(cr.U);
    int nx = 0;
    float x;
    do {
      const uint2 s = hash_index(xk, 1);
      xk = hash_index(xk, 0);
      x = normal_of(bits_at(s, 0));
      cr.x[nx++] = x;
    } while (nx < kCachedNormals && __fmaf_rn(x, kMaxC, 1.0f) <= 0.0f);
    cr.nx = nx;
    cr.xk = xk;
  }

  // the candidates' constants
  GammaParams g[kPairs][2];
  float lg[kPairs][2];
  bool live[kPairs][2];
  bool mine = false;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      g[j][h] = gamma_params(par[j][h]);
      live[j][h] = valid[j] && rejected(0.0f, 1.0f, 2.0f, g[j][h].d);
      mine |= live[j][h];
    }
  }
  __syncthreads();

  // candidate phase: the cached rounds, each candidate with its own d and
  // c, logf(U) taken once a chain; past the cached normals a candidate
  // walks its chain's inner keys on itself.  A candidate that never enters
  // the loop (d NaN or infinite) keeps V = 1.
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lg[j][h] = gamma_finish(g[j][h], 0.0f, s_log_u[h * ET + el[j]]);   // logf(1)
    }
  }
  for (int r = 0; r < kRounds && mine; ++r) {
    float x[kPairs][2], v[kPairs][2];
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const ChainRound& cr = s_round[r][h * ET + el[j]];
        x[j][h] = cr.x[0];
        v[j][h] = __fmaf_rn(x[j][h], g[j][h].c, 1.0f);
        if (v[j][h] <= 0.0f && cr.nx > 1) {
          x[j][h] = cr.x[1];
          v[j][h] = __fmaf_rn(x[j][h], g[j][h].c, 1.0f);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (live[j][h] && v[j][h] <= 0.0f) {
          inner_walk(s_round[r][h * ET + el[j]].xk, g[j][h].c, x[j][h], v[j][h]);
        }
      }
    }
    mine = false;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const ChainRound& cr = s_round[r][h * ET + el[j]];
        const float X = __fmul_rn(x[j][h], x[j][h]);
        const float V = __fmul_rn(__fmul_rn(v[j][h], v[j][h]), v[j][h]);
        const float log_V = logf(V);
        const bool again = rejected_logs(X, V, log_V, cr.U, cr.log_U, g[j][h].d);
        if (live[j][h] && !again) {
          lg[j][h] = gamma_finish(g[j][h], log_V, s_log_u[h * ET + el[j]]);
        }
        live[j][h] = live[j][h] && again;
        mine |= live[j][h];
      }
    }
  }
  // past the cached rounds (a candidate rejected kRounds times), the
  // chain's outer keys on from the last cached round, as beta_kernel
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!live[j][h]) continue;
      uint2 kr = s_key_end[h * ET + el[j]];
      float X, V, U;
      do {
        const uint2 xk = hash_index(kr, 1);
        const uint2 uk = hash_index(kr, 2);
        kr = hash_index(kr, 0);
        float x = 0.0f, v = -1.0f;
        inner_walk(xk, g[j][h].c, x, v);
        X = __fmul_rn(x, x);
        V = __fmul_rn(__fmul_rn(v, v), v);
        U = unit(bits_at(uk, 0));
      } while (rejected(X, V, U, g[j][h].d));
      lg[j][h] = gamma_finish(g[j][h], logf(V), s_log_u[h * ET + el[j]]);
    }
  }

#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    if (valid[j]) out[row[j] * n + e0 + el[j]] = beta_ratio(lg[j][0], lg[j][1]);
  }
}

// the plan: segments back to back in the output, each a key view of sizes
// size[0] x size[1] x size[2] (row-major, strides in int64 words) with n
// draws a key from element start on; passed by value
constexpr int kPlanSegments = 4;
constexpr int kPlanThreads = 128;
constexpr int kPlanPer = 4;            // elements a thread
constexpr int kPlanFields = 10;        // int64 fields a segment, as the entry takes them

struct PlanSegment {
  const long long* keys;
  unsigned size1, size2;               // the view's inner two sizes
  long long stride[3];
  unsigned n, start;
  int dist;                            // 1 uniform, 2 normal
};

struct Plan {
  PlanSegment seg[kPlanSegments];
  int count;
  unsigned total;
};

__global__ void __launch_bounds__(kPlanThreads) plan_kernel(const Plan p,
                                                            float* __restrict__ out) {
  const unsigned base = blockIdx.x * (kPlanThreads * kPlanPer) + threadIdx.x;
  float v[kPlanPer];
  // the draws first, every element's chain independent of the others;
  // the stores after, so that no store stands between two chains' loads
#pragma unroll
  for (int j = 0; j < kPlanPer; ++j) {
    const unsigned g = base + j * kPlanThreads;
    v[j] = 0.0f;
    if (g >= p.total) continue;
    int s = 0;
#pragma unroll
    for (int q = 1; q < kPlanSegments; ++q) {
      if (q < p.count && g >= p.seg[q].start) s = q;
    }
    const PlanSegment& S = p.seg[s];
    const unsigned local = g - S.start;
    const unsigned k = local / S.n, i = local - k * S.n;
    const unsigned c = k % S.size2, ab = k / S.size2;
    const unsigned b = ab % S.size1, a = ab / S.size1;
    const long long at = a * S.stride[0] + b * S.stride[1] + c * S.stride[2];
    const uint2 key = make_uint2(static_cast<uint32_t>(S.keys[at]),
                                 static_cast<uint32_t>(S.keys[at + 1]));
    const uint32_t bits = bits_at(key, i);
    v[j] = S.dist == 1 ? unit(bits) : normal_of(bits);
  }
#pragma unroll
  for (int j = 0; j < kPlanPer; ++j) {
    const unsigned g = base + j * kPlanThreads;
    if (g < p.total) out[g] = v[j];
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 1) {
    beta_kernel<<<blocks_for(K * n), kThreads, 0, s>>>(keys, alpha, beta, K, B, n,
                                                        P, out);
    return static_cast<int>(cudaGetLastError());
  }
  // a tile: up to kTilePairs candidates, and as many elements as fit beside
  // them (at most kMaxElements)
  const long long bt = B < kTilePairs ? B : kTilePairs;
  const long long per = kTilePairs / bt;
  const long long et = per < kMaxElements ? per : kMaxElements;
  const long long tiles_e = (n + et - 1) / et, tiles_b = (B + bt - 1) / bt;
  const long long tiles = K * tiles_e * tiles_b;
  if (tiles > 0x7FFFFFFFLL || n > 0x7FFFFFFFLL || B > 0x7FFFFFFFLL) {
    return cudaErrorInvalidValue;
  }
  beta_shared_kernel<<<static_cast<unsigned>(tiles), kBetaThreads, 0, s>>>(
      keys, alpha, beta, static_cast<int>(B), static_cast<int>(n), static_cast<int>(P),
      static_cast<int>(et), static_cast<int>(bt), static_cast<unsigned>(tiles_e),
      static_cast<unsigned>(tiles_b), out);
  return static_cast<int>(cudaGetLastError());
}


// A solve's draws in one launch (kernel a's plan form).  fields: count
// segments of kPlanFields int64 each, host memory: the key pointer, the
// key view's three sizes and three strides (int64 words; a view of fewer
// axes pads with size 1), n draws a key, the segment's first element in
// out (the previous segments' elements), and the distribution (1 uniform,
// 2 normal).  out: float32, every segment's elements back to back.
extern "C" int mmd_prng_plan(const long long* fields, int count, float* out,
                             void* stream) {
  if (count < 1 || count > kPlanSegments) return cudaErrorInvalidValue;
  Plan p = {};
  p.count = count;
  long long total = 0;
  for (int s = 0; s < count; ++s) {
    const long long* f = fields + s * kPlanFields;
    const long long keys = f[1] * f[2] * f[3], n = f[7];
    if (f[0] == 0 || f[1] < 1 || f[2] < 1 || f[3] < 1 || n < 1 || f[8] != total ||
        (f[9] != 1 && f[9] != 2) || f[2] > 0x7FFFFFFFLL || f[3] > 0x7FFFFFFFLL) {
      return cudaErrorInvalidValue;
    }
    PlanSegment& S = p.seg[s];
    S.keys = reinterpret_cast<const long long*>(f[0]);
    S.size1 = static_cast<unsigned>(f[2]);
    S.size2 = static_cast<unsigned>(f[3]);
    for (int d = 0; d < 3; ++d) S.stride[d] = f[4 + d];
    S.n = static_cast<unsigned>(n);
    S.start = static_cast<unsigned>(total);
    S.dist = static_cast<int>(f[9]);
    total += keys * n;
    if (total > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  }
  p.total = static_cast<unsigned>(total);
  const long long per_block = static_cast<long long>(kPlanThreads) * kPlanPer;
  const unsigned blocks = static_cast<unsigned>((total + per_block - 1) / per_block);
  plan_kernel<<<blocks, kPlanThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}
