// K4: systematic-resampling parents, a block per run of positions.
//
// Replaces gen_tpu/ops/resample.py::_pallas_kernel (launched from
// systematic_resample). For the normalized cdf of the particle weights and
// one uniform u, it writes
//
//     parents[i] = min(#{j : cdf[j] < (i + u) / N}, N - 1)
//
// (searchsorted-left, clamped), with the position computed as the plain
// version computes it: ((T)i + u) * (1 / (T)N), the reciprocal rounded
// once in T (XLA turns the division by the constant N into that product).
//
// The TPU kernel counts all N x N comparisons in (1024, 1024) VMEM blocks:
// 1.7e10 comparisons at 131,072 particles. Here the count comes from
// narrowing the cdf and counting within a window of it, which gives the
// same integer whenever the cdf is nondecreasing (gen_tpu's
// jnp.searchsorted path assumes the same). The card's parallel cumsum can
// dip by one ulp where two partial sums meet, and did at 131,072 float32
// particles; the wrapper's running max (ops/resample.py::normalized_cdf)
// removes such dips, and chip_smoke.py holds this kernel to the literal
// count, where any other would show.
//
// What bounds it on the H100: not its bytes (N cdf values read, N int32
// written: 1 MiB at 131,072 float32 particles, 0.31 us at 3.35 TB/s) but
// the latency of dependent loads, several hundred SM clocks an L2 round
// trip. A binary search per position is a chain of ceil(log2(N + 1)) of
// them (18 at 131,072, 21 at 1M), and one position a thread took 3.88
// waves of the card at 1M, each paying the whole chain.
// So:
//
// - A block owns a run of RESAMPLE_BLOCK_RUN consecutive positions, lane l
//   of warp w the positions run0 + 32 r + l (run0 = block0 + w
//   RESAMPLE_RUN, r < RESAMPLE_R: coalesced stores). The run's parents lie
//   between the lower bounds of its first and last position.
// - Warp 0 narrows that bracket by a 32-ary search: each round lane l
//   reads one of 32 pivots that cut the bracket into 33 pieces, and two
//   ballots (pivot < first position, pivot < last position) give both new
//   ends. One L2 round trip cuts the bracket ~33-fold where the run's
//   parents are close (2 rounds at 131,072 and at 1M).
// - The block reads a window of RESAMPLE_TILE entries from the bracket's
//   start into shared memory (every load issued before the first store:
//   one round trip), and each lane counts its positions there by a
//   branch-free lower bound whose R searches' loads overlap. (Written with
//   a bounds test per step, ptxas put each load behind a branch, and the R
//   searches ran one after another and took most of the kernel's time.)
// - Where a round fails to halve the bracket (runs of zero weight make
//   many equal cdf entries, so a run's parents can lie far apart), the
//   rounds go on for the first position alone. A position whose count
//   reaches the window's end before the bracket's end goes on to another
//   pass, whose rounds skip the zero-weight run and whose window starts
//   where this one ended.
//
// No limit on N beyond int32 indices: the TPU's 65,536 cap and multiple of
// 1,024 were VMEM limits. u is read through a pointer, so the caller never
// synchronizes to pass it.

#include <cuda_runtime.h>
#include <stdint.h>

#define RESAMPLE_WARPS 4    // warps a block
#define RESAMPLE_R 4        // positions a lane
#define RESAMPLE_RUN (32 * RESAMPLE_R)  // positions a warp
#define RESAMPLE_BLOCK_RUN (RESAMPLE_WARPS * RESAMPLE_RUN)
#define RESAMPLE_TILE 1024  // cdf entries of a block's window

namespace {

constexpr unsigned kFull = 0xffffffffu;

// pivot l (< 32) of a round over [lo, lo + span): the pivots cut it into
// 33 pieces. lo + (l + 1) span / 33 in 32-bit arithmetic: with span = 33 a
// + b, it is lo + (l + 1) a + (l + 1) b / 33.
__device__ __forceinline__ int pivot(int lo, int span, int l) {
  const int a = span / 33, b = span - 33 * a;
  return lo + (l + 1) * a + (l + 1) * b / 33;
}

// A warp's 32-ary rounds. [lo, hi] holds the lower bounds of first_pos
// and last_pos, [lo, hi_first] that of first_pos. While a round at least
// halves [lo, hi], both ends narrow together; once one does not, the rounds
// go on for first_pos alone. They stop when hi_first - lo < width, so that
// a window of width entries from lo holds the lower bound of first_pos.
template <typename T>
__device__ __forceinline__ void narrow(const T* __restrict__ cdf,
                                       T first_pos, T last_pos, int width,
                                       int lane, int& lo, int& hi,
                                       int& hi_first) {
  bool both = true;
  while (hi_first - lo >= width) {
    const int span = hi_first - lo;
    const T c = __ldg(cdf + pivot(lo, span, lane));
    const int below_first = __popc(__ballot_sync(kFull, c < first_pos));
    const int new_lo =
        below_first > 0 ? pivot(lo, span, below_first - 1) + 1 : lo;
    const int new_hi_first =
        below_first < 32 ? pivot(lo, span, below_first) : hi_first;
    if (both) {
      const int below_last = __popc(__ballot_sync(kFull, c < last_pos));
      hi = below_last < 32 ? pivot(lo, span, below_last) : hi;
      both = hi - new_lo <= span / 2;
      hi_first = both ? hi : new_hi_first;
    } else {
      hi_first = new_hi_first;
    }
    lo = new_lo;
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * RESAMPLE_WARPS)
    resample_systematic_kernel(const T* __restrict__ cdf,
                               const T* __restrict__ u_ptr,
                               int32_t* __restrict__ parents, int n) {
  __shared__ T tile[RESAMPLE_TILE];
  __shared__ int bracket[2];
  __shared__ long long next_first[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long block0 =
      static_cast<long long>(blockIdx.x) * RESAMPLE_BLOCK_RUN;
  const long long run0 = block0 + warp * RESAMPLE_RUN;
  const long long last =
      min(block0 + RESAMPLE_BLOCK_RUN, static_cast<long long>(n)) - 1;
  const long long none = static_cast<long long>(n);
  const T recip = (T)1 / (T)n;
  const T u = __ldg(u_ptr);
  T pos[RESAMPLE_R];
  int lb[RESAMPLE_R];  // the parent's lower bound, -1 until found
#pragma unroll
  for (int r = 0; r < RESAMPLE_R; ++r) {
    pos[r] = ((T)(run0 + 32 * r + lane) + u) * recip;
    lb[r] = run0 + 32 * r + lane <= last ? -1 : 0;
  }
  if (threadIdx.x == 0) next_first[0] = next_first[1] = none;
  // Each pass: the block's rounds narrow the bracket of its first position
  // without a parent and its last position; the block reads the RESAMPLE_TILE
  // entries from the bracket's start into shared memory (every load issued
  // before the first store, from addresses clamped into the cdf); each lane
  // counts its positions there, a branch-free lower bound whose loads of
  // the R positions overlap. A position whose count reaches the window's
  // end before the bracket's end goes on to the next pass, whose window
  // starts where this one ended.
  int lo = 0, hi = n;
  long long first = block0;
  for (int pass = 0;; ++pass) {
    if (warp == 0) {
      int hi_first = hi;
      narrow(cdf, ((T)first + u) * recip, ((T)last + u) * recip,
             RESAMPLE_TILE, lane, lo, hi, hi_first);
      if (lane == 0) {
        bracket[0] = lo;
        bracket[1] = hi;
      }
    }
    __syncthreads();
    lo = bracket[0];
    hi = bracket[1];
    if (threadIdx.x == 0) next_first[(pass + 1) & 1] = none;
    const int width = hi - lo < RESAMPLE_TILE ? hi - lo : RESAMPLE_TILE;
    constexpr int kLoads = RESAMPLE_TILE / (32 * RESAMPLE_WARPS);
    const int room = n - 1 - lo;
    T v[kLoads];
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      const int j = threadIdx.x + 32 * RESAMPLE_WARPS * t;
      v[t] = __ldg(cdf + lo + (j < room ? j : room));
    }
#pragma unroll
    for (int t = 0; t < kLoads; ++t)
      tile[threadIdx.x + 32 * RESAMPLE_WARPS * t] = v[t];
    __syncthreads();
    int off[RESAMPLE_R];
#pragma unroll
    for (int r = 0; r < RESAMPLE_R; ++r) off[r] = 0;
    for (int len = width; len > 1;) {
      const int half = len >> 1;
#pragma unroll
      for (int r = 0; r < RESAMPLE_R; ++r)
        off[r] = tile[off[r] + half] < pos[r] ? off[r] + half : off[r];
      len -= half;
    }
    const bool whole = lo + width == hi;  // the window reaches the end
#pragma unroll
    for (int r = 0; r < RESAMPLE_R; ++r) {
      const int cnt =
          width > 0 ? off[r] + (tile[off[r]] < pos[r] ? 1 : 0) : 0;
      if (lb[r] < 0 && (cnt < width || whole)) lb[r] = lo + cnt;
    }
    // the block's first position without a parent (they form a suffix)
#pragma unroll
    for (int r = 0; r < RESAMPLE_R; ++r) {
      const unsigned open = __ballot_sync(kFull, lb[r] < 0);
      if (open) {
        if (lane == 0)
          atomicMin(&next_first[pass & 1], run0 + 32 * r + __ffs(open) - 1);
        break;
      }
    }
    __syncthreads();
    first = next_first[pass & 1];
    if (first == none) break;
    lo += width;
  }
#pragma unroll
  for (int r = 0; r < RESAMPLE_R; ++r) {
    const long long i = run0 + 32 * r + lane;
    if (i <= last) parents[i] = lb[r] < n - 1 ? lb[r] : n - 1;
  }
}

}  // namespace

// blocks of a launch over n positions
static int resample_blocks(int n) {
  const int per_block = RESAMPLE_BLOCK_RUN;
  return static_cast<int>((static_cast<long long>(n) + per_block - 1) /
                          per_block);
}

template <typename T>
static int launch(const void* cdf, const void* u, void* parents, int n,
                  void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  resample_systematic_kernel<T><<<resample_blocks(n), 32 * RESAMPLE_WARPS,
                                  0, (cudaStream_t)stream>>>(
      (const T*)cdf, (const T*)u, (int32_t*)parents, n);
  return (int)cudaGetLastError();
}

extern "C" int resample_systematic_f32(const void* cdf, const void* u,
                                       void* parents, int n, void* stream) {
  return launch<float>(cdf, u, parents, n, stream);
}

extern "C" int resample_systematic_f64(const void* cdf, const void* u,
                                       void* parents, int n, void* stream) {
  return launch<double>(cdf, u, parents, n, stream);
}
