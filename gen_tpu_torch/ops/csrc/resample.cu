// K4: systematic-resampling parents, one thread per position.
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
// 1.7e10 comparisons at 131,072 particles. Here each thread runs a
// lower-bound binary search over the cdf instead, ceil(log2(N + 1)) loads
// through the read-only path, which gives the same integer whenever the
// cdf is nondecreasing (gen_tpu's jnp.searchsorted path assumes the same).
// The card's parallel cumsum can dip by one ulp where two partial sums
// meet, and did at 131,072 float32 particles; the wrapper's running max
// (ops/resample.py::normalized_cdf) removes such dips, and chip_smoke.py
// holds this kernel to the literal count, where any other would show.
//
// The work is bound by bytes (N cdf values read, N int32 written: 1 MiB at
// 131,072 float32 particles, 0.31 us at 3.35 TB/s); the searches hit L2
// (the cdf of 1M float32 particles is 4 MiB of the 50 MB), and at these N a
// launch costs more than the bound.
//
// No limit on N beyond int32 indices: the TPU's 65,536 cap and multiple of
// 1,024 were VMEM limits. u is read through a pointer, so the caller never
// synchronizes to pass it.

#include <cuda_runtime.h>
#include <stdint.h>

#define RESAMPLE_BLOCK 256

template <typename T>
__global__ void resample_systematic_kernel(const T* __restrict__ cdf,
                                           const T* __restrict__ u_ptr,
                                           int32_t* __restrict__ parents,
                                           int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T recip = (T)1 / (T)n;
  const T pos = ((T)i + __ldg(u_ptr)) * recip;
  int lo = 0, hi = n;            // the first j with cdf[j] >= pos
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(cdf + mid) < pos) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  parents[i] = lo < n - 1 ? lo : n - 1;
}

template <typename T>
static int launch(const void* cdf, const void* u, void* parents, int n,
                  void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + RESAMPLE_BLOCK - 1) / RESAMPLE_BLOCK;
  resample_systematic_kernel<T><<<blocks, RESAMPLE_BLOCK, 0,
                                  (cudaStream_t)stream>>>(
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
