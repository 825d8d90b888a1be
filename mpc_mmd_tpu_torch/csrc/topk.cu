// K1: row-wise top-k indices, k rounds of two warp reductions on order keys
// per row; K5: the same rounds that also write each round's one-hot row.
//
// K1 replaces the TPU kernel mpc_mmd_tpu/ops/topk_pallas.py::topk_indices_pallas
// (pl.pallas_call at topk_pallas.py:116), which runs k max-and-mask rounds per
// row block in VMEM.  K5 replaces topk_pallas.py::topk_onehot_pallas
// (pl.pallas_call at topk_pallas.py:146), whose rounds are the same and which
// writes the f32 indicator (rows, k, m) of every round's winner beside the
// indices.  One kernel body serves both, behind the kOneHot template flag: with
// it, every round ends with the warp writing the m floats of that round's
// one-hot row, coalesced (lane l writes columns l, l+32, ...).  That write,
// rows * k * m * 4 bytes (40 MB at 10^4 rows, k = 10, m = 100), bounds K5;
// no path of the package calls it (reduced_set.py:535-539 of the JAX package
// says why).
//
// Semantics (identical to the Pallas kernel and lax.top_k on NaN-free rows):
// indices of the k largest values in descending order; equal values go to
// the lowest index (-0.0 and +0.0 are equal); NaN is mapped to -inf before
// the first round, so a NaN lane never wins while a lane above -inf
// remains; each round's winner is masked to -inf, so once the lanes above
// -inf run out every later round emits the lowest column, 0 (an all-NaN row
// emits 0 k times).  With `absolute` the ranking key is |x|; only the first `m` of the
// row's `width` lanes are ranked.
//
// What bounds it on the card: at the selection's shape (3,648 rows of 101
// floats, k = 10) one call reads 1.5 MB and writes 146 KB, 0.48 us of HBM
// time; any launch costs about 1 us of device time (an empty fill_).  The
// rest is k dependent rounds per row, issue slots at 3,648 rows and more
// (28 warps an SM), the latency of one row's chain at the elite pick's 64
// to 100 rows.  The earlier kernel (5.4 us at 3,648 rows) ran a round as a
// 5-step shuffle of two registers (~30 cycles a step), one row per warp,
// and stored one index per round.  The design:
// - a lane holds columns l, l+32, l+64, l+96 of the row as order keys
//   (unsigned integers that order as the floats compare, -0.0 and +0.0
//   alike), loaded coalesced once; NaN gets -inf's key, the columns at or
//   past m get 0, below -inf's key, so they never win; the lane sorts its
//   slots once, so its head is its best (the lower column on a tie);
// - a round is two redux.sync (~47 cycles each): the max of the heads'
//   keys, then the least column holding it.  The winner's lane drops its
//   head: the Pallas kernel masks a winner to -inf instead, which changes
//   no later round while a lane above -inf is left, and once none is, the
//   lowest -inf lane, masked winners included, is column 0, which the
//   kernel emits from then on;
// - a warp runs one row while the card holds all of them at once; past
//   that, two rows, round r of each before round r+1, without a branch per
//   row, so their reductions interleave (launch_rows);
// - a template on the slots a lane needs (ceil(m / 32)) keeps the narrower
//   rows of the elite pick (m = 64) from sorting empty slots;
// - lane i keeps round i's winner and lanes 0..k-1 store the row's indices
//   at once, one coalesced store per row (per 32 rounds when k > 32).
// Each instantiation keeps every array in registers (a 0-byte stack frame
// in nvcc -Xptxas -v).  Measured (PERF.md): 3.5 us at 3,648 rows (the
// earlier kernel: 5.5), 6.2 us at 8,900 (11.4), 1.8-2.3 us at the elite
// pick's 64-100 rows (2.1-2.7).  Rows wider than 128 are refused by the
// wrapper.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;                    // warps per block
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNegInfKey = 0x007fffffu;  // order_key(-inf)
constexpr unsigned kPadKey = 0u;              // columns at or past m

// A non-NaN float mapped to an unsigned key in the same order (+0 and -0
// map alike, as they compare equal); as in topk_kernel.cu.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Warp w of block b holds rows b * kWarps * kRows + w + r * kWarps.
template <int kSlots, int kRows, bool kOneHot>
__global__ void __launch_bounds__(kWarps * kWarp)
topk_rounds_kernel(const float* __restrict__ x, int* __restrict__ out,
                   float* __restrict__ onehot, int rows, int width, int m,
                   int k, int absolute) {
  const int lane = threadIdx.x % kWarp;
  const long long row0 = static_cast<long long>(blockIdx.x) * kWarps * kRows +
                         threadIdx.x / kWarp;
  // a lane's slots as (order key, column), sorted by key, descending; a
  // stable bubble network keeps the lower column first on a tie
  unsigned key[kRows][kSlots], col[kRows][kSlots];
  bool live[kRows];  // uniform over the warp
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = row0 + r * kWarps;
    live[r] = row < rows;
    const float* xr = x + row * width;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int c = lane + t * kWarp;
      unsigned kk = kPadKey;
      if (live[r] && c < m) {
        float v = xr[c];
        if (absolute) v = fabsf(v);
        kk = isnan(v) ? kNegInfKey : order_key(v);
      }
      key[r][t] = kk;
      col[r][t] = c;
    }
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
#pragma unroll
      for (int j = 0; j + 1 < kSlots - i; ++j) {
        const bool swap = key[r][j + 1] > key[r][j];
        const unsigned k0 = key[r][j], c0 = col[r][j];
        key[r][j] = swap ? key[r][j + 1] : k0;
        col[r][j] = swap ? col[r][j + 1] : c0;
        key[r][j + 1] = swap ? k0 : key[r][j + 1];
        col[r][j + 1] = swap ? c0 : col[r][j + 1];
      }
  }

  // Rounds in runs of 32: lane i keeps the winner of round base + i, and
  // the run is stored at once.  No branch per row: a row past the end ranks
  // its padding keys and stores nothing, so the rows' rounds interleave.
  for (int base = 0; base < k; base += kWarp) {
    const int run = min(kWarp, k - base);
    int sel[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sel[r] = 0;
    for (int i = 0; i < run; ++i) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const unsigned top = __reduce_max_sync(kFull, key[r][0]);
        const unsigned win =
            __reduce_min_sync(kFull, key[r][0] == top ? col[r][0] : 0xffffffffu);
        // the winner leaves its lane's list (the Pallas kernel masks it to
        // -inf); once only -inf lanes are left, masked winners among them,
        // the lowest of them is column 0, in every later round
        const bool pop = col[r][0] == win;
#pragma unroll
        for (int t = 0; t + 1 < kSlots; ++t) {
          key[r][t] = pop ? key[r][t + 1] : key[r][t];
          col[r][t] = pop ? col[r][t + 1] : col[r][t];
        }
        key[r][kSlots - 1] = pop ? kPadKey : key[r][kSlots - 1];
        const int w = top > kNegInfKey ? static_cast<int>(win) : 0;
        if (lane == i) sel[r] = w;
        if (kOneHot && live[r]) {
          float* oh = onehot + ((row0 + r * kWarps) * k + base + i) * m;
          for (int c = lane; c < m; c += kWarp) oh[c] = c == w ? 1.0f : 0.0f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (live[r] && lane < run) out[(row0 + r * kWarps) * k + base + lane] = sel[r];
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 1;
  }
  return sms;
}

// Blocks of one instantiation an SM holds at once (registers set it).
template <int kSlots, int kRows>
int resident_blocks() {
  static int n = 0;
  if (n == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, topk_rounds_kernel<kSlots, kRows, false>, kWarps * kWarp,
                    0) != cudaSuccess)
    n = 1;
  return n;
}

struct Args {
  const float* x;
  int* out;
  float* onehot;
  int rows, width, m, k, absolute;
};

template <int kSlots, int kRows, bool kOneHot>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int per_block = kWarps * kRows;
  topk_rounds_kernel<kSlots, kRows, kOneHot>
      <<<(a.rows + per_block - 1) / per_block, kWarps * kWarp, 0, stream>>>(
          a.x, a.out, a.onehot, a.rows, a.width, a.m, a.k, a.absolute);
  return static_cast<int>(cudaGetLastError());
}

// One row per warp while the card holds all those warps at once: its chain
// of rounds is the shortest.  Past that a second wave would cost a whole
// chain, and two rows per warp cost less (measured: PERF.md).
template <int kSlots>
int launch_rows(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.rows + kWarps - 1) / kWarps;
  if (blocks <= static_cast<long long>(resident_blocks<kSlots, 1>()) * sm_count())
    return launch<kSlots, 1, false>(a, stream);
  return launch<kSlots, 2, false>(a, stream);
}

}  // namespace

extern "C" int mmd_topk_indices(const float* x, int* out, int rows, int width,
                                int m, int k, int absolute, void* stream) {
  if (rows <= 0) return 0;
  const Args a{x, out, nullptr, rows, width, m, k, absolute};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((m + kWarp - 1) / kWarp) {  // the wrapper keeps m <= 128
    case 1: return launch_rows<1>(a, st);
    case 2: return launch_rows<2>(a, st);
    case 3: return launch_rows<3>(a, st);
    default: return launch_rows<4>(a, st);
  }
}

extern "C" int mmd_topk_onehot(const float* x, int* out, float* onehot,
                               int rows, int width, int m, int k, int absolute,
                               void* stream) {
  if (rows <= 0) return 0;
  return launch<4, 1, true>(Args{x, out, onehot, rows, width, m, k, absolute},
                            static_cast<cudaStream_t>(stream));
}
