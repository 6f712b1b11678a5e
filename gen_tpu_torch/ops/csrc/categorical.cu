// K5: batched categorical draws by Gumbel-argmax, rows packed into
// sub-warps.
//
// Replaces gen_tpu/ops/categorical.py::_kernel (line 46; the Pallas TPU
// kernel behind batched_categorical and categorical_fast). For each row r
// of an (N, K) float32 logit matrix it writes
//
//     out[r] = min(lowest c with x[r, c] == max_c x[r, c], K - 1),
//     x[r, c] = logits[r, c] - log(-log(max(u[r, c], FLT_MIN))),
//
// and K - 1 where a row holds a NaN (the plain version's max is then NaN
// and no column equals it). u is uniform on [0, 1) from the 23 mantissa
// bits of a Philox4x32-10 word, the construction of gen_tpu's kernel and
// of jax.random, or, in injected mode, read from an (N, K) input, where
// the kernel equals ops/categorical.py::batched_categorical_plain index
// for index (precise logf, -fmad=false).
//
// The design is Hopper's, not the TPU's. What bounds it at the port's
// shapes (the cipher-decode example's 432 and 4,672 rows of 27) is issue,
// not bytes: a lane takes 4 columns, so one warp per row kept 7 of 32
// lanes busy at K = 27 while the warp issued the whole Philox call, eight
// logs and a five-step shuffle tree. So:
//
// - A row takes G lanes, the smallest power of two >= ceil(K / 4), at most
//   32 (cat_group): K = 27 gives 8 lanes and 4 rows a warp, K <= 4 one
//   lane and 32 rows. Lane g of a group takes the column groups 4g, 4g +
//   4G, ...: one pass where G < 32, a loop for K > 128 (K has no cap; the
//   TPU padded K to 128 lanes, a VMEM tile). Each lane keeps its running
//   (largest value, lowest index) and whether it saw a NaN; a shuffle tree
//   of log2(G) steps within the group (width G) reduces them with the same
//   tie rule, and one ballot gives the group's NaN flag. Rows past N are
//   masked, never returned from, so every shuffle runs with a full mask.
// - The logits are loaded before the Philox call, which does not depend on
//   them, so their latency hides behind it.
// - The noise never touches device memory: Philox keyed by the row's key
//   (keys[b] serves rows b * rows_per_key .. (b + 1) * rows_per_key - 1,
//   one key per leading batch index of a vmapped call), counter (row within
//   its key's rows, column group, 0, 0), one call per 4 columns. gen_tpu
//   mixed the tile id into the seed instead. The kernel reads the key as
//   the port holds it, int64 words with uint32 values, and takes their low
//   32 bits, so a call launches this kernel and nothing else.
//
// Bound: bytes at large N (N * K * 4 read + N * 4 written at 3.35 TB/s);
// at the decode example's shapes a launch costs more than either bound.

#include <cuda_runtime.h>
#include <stdint.h>

// @@NUTS_COMMON@@

#define CAT_WARPS 4   // warps a block

// lanes a row: the smallest power of two >= ceil(k / 4), at most 32
static inline int cat_group(int k) {
  int g = 1;
  while (g < 32 && 4 * g < k) g *= 2;
  return g;
}

namespace {

// keep the larger value; on a tie, the lower index (NaN never wins)
__device__ __forceinline__ void take(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

template <bool INJECTED, int G>
__global__ void __launch_bounds__(32 * CAT_WARPS) categorical_kernel(
    const float* __restrict__ logits, const float* __restrict__ u_in,
    const long long* __restrict__ keys, int n, int k, int rows_per_key,
    int32_t* __restrict__ out) {
  constexpr int kRowsPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const int row0 = (blockIdx.x * CAT_WARPS + (threadIdx.x >> 5)) *
                   kRowsPerWarp;
  if (row0 >= n) return;  // uniform across the warp
  const int row = row0 + lane / G;
  const bool live = row < n;
  const size_t base = static_cast<size_t>(row) * k;
  uint2 key = make_uint2(0u, 0u);
  uint32_t local = 0u;
  if (!INJECTED && live) {
    const int b = row / rows_per_key;
    key = make_uint2(static_cast<uint32_t>(__ldg(keys + 2 * b)),
                     static_cast<uint32_t>(__ldg(keys + 2 * b + 1)));
    local = static_cast<uint32_t>(row - b * rows_per_key);
  }
  float bv = neg_inf();
  int bi = k;
  bool nan = false;
  for (int c0 = 4 * g; live && c0 < k; c0 += 4 * G) {
    float x[4], u[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      x[t] = c0 + t < k ? __ldg(logits + base + c0 + t) : 0.0f;
    if (INJECTED) {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        u[t] = c0 + t < k ? __ldg(u_in + base + c0 + t) : 0.0f;
    } else {
      const uint4 b = philox4x32_10(
          make_uint4(local, static_cast<uint32_t>(c0 >> 2), 0u, 0u), key);
      u[0] = u01(b.x);
      u[1] = u01(b.y);
      u[2] = u01(b.z);
      u[3] = u01(b.w);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = c0 + t;
      if (c < k) {
        const float gum = -logf(-logf(fmaxf(u[t], kTiny)));
        const float v = x[t] + gum;
        nan = nan || isnan(v);
        take(bv, bi, v, c);
      }
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off, G);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off, G);
    take(bv, bi, ov, oi);
  }
  const unsigned nans = __ballot_sync(0xffffffffu, nan);
  const unsigned group =
      G == 32 ? 0xffffffffu : ((1u << (G & 31)) - 1u) << (lane & ~(G - 1));
  if (live && g == 0)
    out[row] = (nans & group) ? k - 1 : (bi < k - 1 ? bi : k - 1);
}

}  // namespace

// blocks of a launch over n rows of k columns
static int cat_blocks(int n, int k) {
  const int rows = CAT_WARPS * (32 / cat_group(k));
  return (n + rows - 1) / rows;
}

template <bool INJECTED>
static void launch(int grid, cudaStream_t st, const float* logits,
                   const float* u, const long long* keys, int n, int k,
                   int rows_per_key, int32_t* out) {
  const dim3 block(32 * CAT_WARPS);
#define CAT_CASE(G)                                                      \
  case G:                                                                \
    categorical_kernel<INJECTED, G><<<grid, block, 0, st>>>(            \
        logits, u, keys, n, k, rows_per_key, out);                      \
    break;
  switch (cat_group(k)) {
    CAT_CASE(1)
    CAT_CASE(2)
    CAT_CASE(4)
    CAT_CASE(8)
    CAT_CASE(16)
    CAT_CASE(32)
  }
#undef CAT_CASE
}

// logits (n, k) float32; u (n, k) float32, or null for Philox noise from
// keys (n / rows_per_key, 2) int64 words with uint32 values (not read in
// injected mode); out (n,) int32. Returns cudaGetLastError().
extern "C" int categorical_launch(const void* logits, const void* u,
                                  const void* keys, int n, int k,
                                  int rows_per_key, void* out,
                                  void* stream) {
  if (n <= 0 || k <= 0 || rows_per_key <= 0 || (u == nullptr && !keys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  const long long* ks = static_cast<const long long*>(keys);
  int32_t* o = static_cast<int32_t*>(out);
  if (u != nullptr)
    launch<true>(cat_blocks(n, k), st, lg, static_cast<const float*>(u), ks,
                 n, k, rows_per_key, o);
  else
    launch<false>(cat_blocks(n, k), st, lg, nullptr, ks, n, k, rows_per_key,
                  o);
  return static_cast<int>(cudaGetLastError());
}
