// K5: batched categorical draws by Gumbel-argmax, one warp per row.
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
// The design is Hopper's, not the TPU's:
//
// - One warp per row, 8 rows per 256-thread block. Lane l takes the
//   column groups 4l, 4l + 128, ... in a loop, so K has no cap (the TPU
//   padded K to 128 lanes, a VMEM tile). Each lane keeps its running
//   (largest value, lowest index) and whether it saw a NaN; a shuffle tree
//   reduces them with the same tie rule.
// - The noise never touches device memory: Philox keyed by the row's key
//   (two 32-bit words; keys[b] serves rows b * rows_per_key ..
//   (b + 1) * rows_per_key - 1, one key per leading batch index of a
//   vmapped call), counter (row within its key's rows, column group, 0, 0),
//   one call per 4 columns. gen_tpu mixed the tile id into the seed
//   instead.
// - The logits are read once, coalesced (a warp reads 128 consecutive
//   floats per step); one int32 is written per row.
//
// Bound: bytes at large N (N * K * 4 read + N * 4 written at 3.35 TB/s);
// at the decode example's shapes (432 and 4,672 rows of 27) a launch costs
// more than either bound.

#include <cuda_runtime.h>
#include <stdint.h>

// @@NUTS_COMMON@@

#define CAT_WARPS 8

namespace {

// keep the larger value; on a tie, the lower index (NaN never wins)
__device__ __forceinline__ void take(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

template <bool INJECTED>
__global__ void __launch_bounds__(32 * CAT_WARPS) categorical_kernel(
    const float* __restrict__ logits, const float* __restrict__ u_in,
    const uint32_t* __restrict__ keys, int n, int k, int rows_per_key,
    int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * CAT_WARPS + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const size_t base = static_cast<size_t>(row) * k;
  uint2 key = make_uint2(0u, 0u);
  uint32_t local = 0u;
  if (!INJECTED) {
    const int b = row / rows_per_key;
    key = make_uint2(keys[2 * b], keys[2 * b + 1]);
    local = static_cast<uint32_t>(row - b * rows_per_key);
  }
  float bv = neg_inf();
  int bi = k;
  bool nan = false;
  for (int c0 = 4 * lane; c0 < k; c0 += 128) {
    float u[4];
    if (INJECTED) {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        u[t] = c0 + t < k ? u_in[base + c0 + t] : 0.0f;
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
        const float g = -logf(-logf(fmaxf(u[t], kTiny)));
        const float x = logits[base + c] + g;
        nan = nan || isnan(x);
        take(bv, bi, x, c);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take(bv, bi, ov, oi);
  }
  nan = __any_sync(0xffffffffu, nan);
  if (lane == 0) out[row] = nan ? k - 1 : (bi < k - 1 ? bi : k - 1);
}

}  // namespace

// logits (n, k) float32; u (n, k) float32 or null (Philox); keys
// (n / rows_per_key, 2) uint32; out (n,) int32. Returns cudaGetLastError().
extern "C" int categorical_launch(const void* logits, const void* u,
                                  const void* keys, int n, int k,
                                  int rows_per_key, void* out,
                                  void* stream) {
  if (n <= 0 || k <= 0 || rows_per_key <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + CAT_WARPS - 1) / CAT_WARPS);
  const dim3 block(32 * CAT_WARPS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u != nullptr)
    categorical_kernel<true><<<grid, block, 0, st>>>(
        static_cast<const float*>(logits), static_cast<const float*>(u),
        static_cast<const uint32_t*>(keys), n, k, rows_per_key,
        static_cast<int32_t*>(out));
  else
    categorical_kernel<false><<<grid, block, 0, st>>>(
        static_cast<const float*>(logits), nullptr,
        static_cast<const uint32_t*>(keys), n, k, rows_per_key,
        static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
