// One evaluation of a streamed likelihood's value and gradient per chain:
// the staged code of gen_tpu_torch/ops/scalarize.py (staging part c, the
// loop over the data table) on its own, in the layout that fills the card
// for the chains it is given. staged_eval.cu serves every other staged
// program; both are timed per gradient and held to their torch rendering
// without a sampler around them.
//
// What bounds it: instruction issue of the loop body. Per point and chain
// the body is a few dozen float operations, and the build uses -fmad=false
// (the kernels round as their plain version), so the FP32 pipe issues
// about half the 67 TFLOP/s it could with fused multiply-adds. Each IEEE
// division compiles to MUFU.RCP, five FFMA, FCHK and a branch around the
// slow path's call, in a convergence region that the compiler does not
// overlap with the next point's (layout_timing.py --stream prints this
// kernel's SASS opcode counts). The design spends as few instructions
// and as little latency as it can around that body:
//
// - A warp per chain; lane l evaluates a block of points of every tile
//   (8 for the robust-t body; staged_partial in the spliced code), adds
//   them by a pairwise tree and the tile's total into its Kahan sum: one
//   compensated add per block instead of four instructions a point and
//   sum, and no dependence between points but the tree's. The divisions'
//   regions keep the compiler from overlapping the points, so the warps
//   hide the latency: 80 registers, 24 warps an SM.
// - The chains of a block (blockDim.x / 32, up to 8) share one ring of
//   data tiles in shared memory (16-byte cp.async copies), so the table
//   crosses L2 once per block, not once per chain.
// - When chains are few, each chain's tiles are split over `splits`
//   blocks (block g walks tiles g, g + splits, ...), which write their
//   partial sums to `part`; staged_combine_kernel adds them in block order
//   and runs the code after the loop. The launch shape (chains a block,
//   splits) is chosen per call from the chain and point counts
//   (scalarize.eval_layout: ~12,672 warps launched), so 128 chains fill
//   132 SMs as 1,024 do.
// - A block's chains past n repeat chain n - 1 (its barriers need every
//   warp) and store nothing.
// Built with -fmad=false, as the kernels that embed the same code.

#include <cuda_runtime.h>
#include <stdint.h>

// @@DEFINES@@

// @@STAGED_VAG@@

namespace {

__global__ void __launch_bounds__(SE_THREADS) staged_stream_kernel(
    const float* __restrict__ x,      // (D, n)
    float* __restrict__ lp_out,       // (n,)
    float* __restrict__ g_out,        // (D, n)
    float* __restrict__ part,         // (n, splits, K) when splits > 1
    const float* __restrict__ res,    // (R,)
    const float* __restrict__ sd,     // (rows, padded n_pts)
    int n_pts, int n, int splits) {
  __shared__ float r[SE_R];
  for (int k = threadIdx.x; k < SE_R; k += blockDim.x) r[k] = res[k];
  __syncthreads();
  const int chains = (int)blockDim.x / 32;
  const int g0 = (int)blockIdx.x % splits;
  const int i0 = (int)blockIdx.x / splits * chains + (int)threadIdx.x / 32;
  const int i = min(i0, n - 1);
  const bool store = i0 < n && (threadIdx.x & 31u) == 0;
  const size_t N = (size_t)n;
  float v[SE_D], s[SE_K];
#pragma unroll
  for (int k = 0; k < SE_D; ++k) v[k] = x[k * N + i];
  staged_partial(v, r, s, sd, n_pts, g0, splits);
  if (splits == 1) {
    float lp, g[SE_D];
    staged_finish(v, r, s, lp, g);
    if (store) {
      lp_out[i] = lp;
#pragma unroll
      for (int k = 0; k < SE_D; ++k) g_out[k * N + i] = g[k];
    }
  } else if (store) {
#pragma unroll
    for (int k = 0; k < SE_K; ++k)
      part[((size_t)i * splits + g0) * SE_K + k] = s[k];
  }
}

// a thread per chain: the blocks' partial sums in block order, then the
// code after the loop
__global__ void __launch_bounds__(128) staged_combine_kernel(
    const float* __restrict__ x, float* __restrict__ lp_out,
    float* __restrict__ g_out, const float* __restrict__ part,
    const float* __restrict__ res, int n, int splits) {
  __shared__ float r[SE_R];
  for (int k = threadIdx.x; k < SE_R; k += blockDim.x) r[k] = res[k];
  __syncthreads();
  const int i = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const size_t N = (size_t)n;
  float v[SE_D], s[SE_K], lp, g[SE_D];
#pragma unroll
  for (int k = 0; k < SE_D; ++k) v[k] = x[k * N + i];
  const float* p = part + (size_t)i * splits * SE_K;
#pragma unroll
  for (int k = 0; k < SE_K; ++k) s[k] = p[k];
  for (int b = 1; b < splits; ++b) {
#pragma unroll
    for (int k = 0; k < SE_K; ++k) s[k] = s[k] + p[b * SE_K + k];
  }
  staged_finish(v, r, s, lp, g);
  lp_out[i] = lp;
#pragma unroll
  for (int k = 0; k < SE_D; ++k) g_out[k * N + i] = g[k];
}

}  // namespace

extern "C" int staged_stream_launch(const float* x, float* lp_out,
                                    float* g_out, float* part,
                                    const float* res, const float* sd,
                                    int n_pts, int n, int chains, int splits,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((n + chains - 1) / chains * splits);
  staged_stream_kernel<<<blocks, 32 * chains, 0, st>>>(
      x, lp_out, g_out, part, res, sd, n_pts, n, splits);
  if (splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    staged_combine_kernel<<<(unsigned)((n + 127) / 128), 128, 0, st>>>(
        x, lp_out, g_out, part, res, n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
