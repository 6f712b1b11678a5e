// One evaluation of a staged model's value and gradient per chain: the
// body that gen_tpu_torch/ops/scalarize.py writes into K1, K3 and K6, on
// its own. It times the staged code (a straight-line program, or the
// rolled Kalman recursion of part b: a forward loop over time that keeps
// the carry on a tape in local memory, then a backward loop that
// recomputes each step from it) per gradient, and holds it to its torch
// rendering without any sampler around it. A streamed likelihood (part c)
// runs staged_stream.cu instead, in a layout of its own.
//
// Launch shape: one thread per chain. What bounds it is the program's
// arithmetic, in registers (the scan loops' tape aside). Built with
// -fmad=false, as the kernels that embed it.

#include <cuda_runtime.h>
#include <stdint.h>

// @@DEFINES@@

// @@STAGED_VAG@@

namespace {

__global__ void __launch_bounds__(SE_BLOCK) staged_eval_kernel(
    const float* __restrict__ x,      // (D, n)
    float* __restrict__ lp_out,       // (n,)
    float* __restrict__ g_out,        // (D, n)
    const float* __restrict__ res,    // (R,)
    int n) {
  __shared__ float r[SE_R];
  for (int k = threadIdx.x; k < SE_R; k += blockDim.x) r[k] = res[k];
  __syncthreads();
  const int i = (int)((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const size_t N = (size_t)n;
  float v[SE_D], g[SE_D], lp;
#pragma unroll
  for (int k = 0; k < SE_D; ++k) v[k] = x[k * N + i];
  staged_vag(v, r, lp, g, nullptr, 0);
  lp_out[i] = lp;
#pragma unroll
  for (int k = 0; k < SE_D; ++k) g_out[k * N + i] = g[k];
}

}  // namespace

extern "C" int staged_eval_launch(const float* x, float* lp_out,
                                  float* g_out, const float* res, int n,
                                  void* stream) {
  const dim3 grid((unsigned)(((size_t)n + SE_BLOCK - 1) / SE_BLOCK));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  staged_eval_kernel<<<grid, SE_BLOCK, 0, st>>>(x, lp_out, g_out, res, n);
  return static_cast<int>(cudaGetLastError());
}
