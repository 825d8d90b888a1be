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
// - a lane holds columns l, l+32, ... (at most 8: m <= 256) of the row as
//   order keys (unsigned integers that order as the floats compare, -0.0
//   and +0.0 alike), loaded coalesced once; NaN gets -inf's key, the
//   columns at or past m get 0, below -inf's key, so they never win; the
//   lane sorts its slots once, so its head is its best (the lower column
//   on a tie);
// - a round is two redux.sync (~47 cycles each): the max of the heads'
//   keys, then the least column holding it.  The winner's lane drops its
//   head: the Pallas kernel masks a winner to -inf instead, which changes
//   no later round while a lane above -inf is left, and once none is, the
//   lowest -inf lane, masked winners included, is column 0, which the
//   kernel emits from then on;
// - a warp runs one row while the card holds all of them at once; past
//   that, two rows, round r of each before round r+1, without a branch per
//   row, so their reductions interleave (launch_rows);
// - a template on the slots a lane needs (ceil(m / 32), 1 ... 8) keeps
//   the narrower rows (the elite pick's m = 64, N = 5's m = 25) from
//   sorting empty slots, and lets the widest, m = N^2 = 225 and 256 at
//   reduced-set sizes N = 15 and 16, keep 8 keys and columns a lane;
// - lane i keeps round i's winner and lanes 0..k-1 store the row's indices
//   at once, one coalesced store per row (per 32 rounds when k > 32).
// Each instantiation keeps every array in registers (a 0-byte stack frame
// in nvcc -Xptxas -v, 29-46 registers; two rows a warp at 8 slots hold 16
// keys and 16 columns a lane in 46).  Measured (PERF.md): 3.5 us at 3,648
// rows (the earlier kernel: 5.5), 6.2 us at 8,900 (11.4), 1.8-2.3 us at
// the elite pick's 64-100 rows (2.1-2.7); at N = 15, 13.5 us at (100, 89,
// 226), k = 15, against a bound of 2.6 (the rounds' chain, 1.5x k = 10's,
// and the sort of 8 slots).  Rows wider than 256 are refused by the
// wrapper (and by the C entry).

#include <cuda_runtime.h>
#include <math.h>

#include "topk_rounds.cuh"

namespace {

using mmd_topk::kPadKey;

constexpr int kWarp = 32;
constexpr int kWarps = 4;                    // warps per block
constexpr int kMaxSlots = 8;                 // columns a lane holds: m <= 256

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
        kk = mmd_topk::rank_key(v);
      }
      key[r][t] = kk;
      col[r][t] = c;
    }
    mmd_topk::sort_slots<kSlots>(key[r], col[r]);
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
        const int w = mmd_topk::round_winner<kSlots>(key[r], col[r]);
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

// K5: one row a warp, on the slots that m needs
template <int kSlots = 1>
int onehot_slots(const Args& a, int slots, cudaStream_t stream) {
  if (slots == kSlots) return launch<kSlots, 1, true>(a, stream);
  if constexpr (kSlots < kMaxSlots) return onehot_slots<kSlots + 1>(a, slots, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// m at most kMaxSlots * 32 = 256 (the wrapper checks first); returns
// cudaErrorInvalidValue otherwise.
extern "C" int mmd_topk_indices(const float* x, int* out, int rows, int width,
                                int m, int k, int absolute, void* stream) {
  if (rows <= 0) return 0;
  const Args a{x, out, nullptr, rows, width, m, k, absolute};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((m + kWarp - 1) / kWarp) {
    case 1: return launch_rows<1>(a, st);
    case 2: return launch_rows<2>(a, st);
    case 3: return launch_rows<3>(a, st);
    case 4: return launch_rows<4>(a, st);
    case 5: return launch_rows<5>(a, st);
    case 6: return launch_rows<6>(a, st);
    case 7: return launch_rows<7>(a, st);
    case 8: return launch_rows<8>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int mmd_topk_onehot(const float* x, int* out, float* onehot,
                               int rows, int width, int m, int k, int absolute,
                               void* stream) {
  if (rows <= 0) return 0;
  const Args a{x, out, onehot, rows, width, m, k, absolute};
  return onehot_slots(a, (m + kWarp - 1) / kWarp, static_cast<cudaStream_t>(stream));
}
