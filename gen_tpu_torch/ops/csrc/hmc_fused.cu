// Fused many-chain HMC: n_steps whole HMC updates per chain in one launch.
//
// Replaces gen_tpu/ops/hmc_fused.py::_kernel (the Pallas TPU kernel behind
// hmc_chains_fused). Semantics are the same; the design is Hopper's:
//
// - One thread per chain. A chain's work is independent scalar code: no
//   cross-chain reduction and no matrix product, so there is nothing for
//   tensor cores or shared-memory tiling to do. The d coordinates, momenta
//   and gradient live in registers (D is a compile-time constant) for all
//   n_steps x L leapfrogs; device memory sees one read of the state, the
//   per-step history write and the final write.
// - A streamed likelihood (a loop over the data table sd, rows of padded
//   length) gets HMC_LANES / 32 warps per chain and HMC_BLOCK / HMC_LANES
//   chains per block instead: the lanes run the chain's HMC bookkeeping on
//   the same values and split the loop inside staged_vag. The loop is
//   bound by its per-point arithmetic (IEEE divisions, log1p); each lane
//   evaluates a block of points of every tile as independent
//   instructions and Kahan-adds the block's tree sum, and the block's
//   chains read every tile from one ring of shared memory (cp.async), so
//   the table crosses L2 once per block. Every chain of a block calls
//   staged_vag at the same points of its loops (its barriers need every
//   warp): the wrapper fills the last block with copies of the last chain
//   and drops their results. All lanes of a chain store the same values.
// - The model's value and gradient is the straight-line __device__ function
//   staged_vag, generated by gen_tpu_torch/ops/scalarize.py and spliced in
//   below; the data-only part of the model was evaluated once outside and
//   arrives as the residual constants r[0..R-1], held in shared memory.
// - Layout (d, n) with chains contiguous, so every per-step history write
//   and every state read coalesces across a warp.
// - Randomness is Philox4x32-10 (philox.cuh) keyed by the two words of the
//   caller's key, with counter (chain, step, tag, 0). The jittered step
//   size uses counter (0xFFFFFFFF, step, 0, 0), so it depends on (seed,
//   step) only and every chain shares it, as hmc_chains does. (The TPU
//   kernel drew it per grid program.) A one-warp prologue kernel,
//   hmc_eps_kernel, fills the launch's table of step sizes before the main
//   kernel runs, so no chain repeats that draw. Momenta are Box-Muller
//   pairs; an inverse mass of 0 freezes a coordinate (sqrt_mass_safe).
// - Injected mode reads the step sizes (the caller's table), normals and
//   accept uniforms from device memory instead, so the kernel can be
//   compared exactly with its plain PyTorch twin (hmc_chains_fused_plain).
//
// What bounds it: instruction issue. Per chain and leapfrog the staged
// program is a few dozen float operations with a few transcendentals and
// divisions; memory traffic is one float per chain per step for the
// history. The build uses -fmad=false so that the kernel performs the same
// roundings as its twin. The staged program divides by a residual constant
// through its reciprocal, staged beside it (a multiply where that
// reciprocal is exact, else _div_rcp: three instructions and a guard in
// place of an IEEE division's reciprocal-unit call, Newton steps and
// slow-path check), and by a value it divides by repeatedly through one
// reciprocal computed after it (scalarize.py). The residual constants stay
// in shared memory: the compiler keeps them in registers across the step
// loop (no shared-memory load in it, PERF.md). With the divisions and the
// step-size draw gone, ptxas keeps the headline regression's kernel at 64
// registers: 8 blocks of 128 an SM, and a launch of 524,288 chains fills
// 3.88 waves of the card (4.43 at the 70 registers it took before).

#include <cuda_runtime.h>
#include <stdint.h>

// @@DEFINES@@

// @@STAGED_VAG@@

namespace {

// @@INCLUDE philox.cuh@@

__device__ __forceinline__ float kinetic(const float* inv, const float* m) {
  float k = (inv[0] * m[0]) * m[0];
#pragma unroll
  for (int j = 1; j < HMC_D; ++j) k = k + (inv[j] * m[j]) * m[j];
  return 0.5f * k;
}

// the jittered step size of each step: one Philox call per step, shared by
// every chain of the launch
__global__ void hmc_eps_kernel(float* __restrict__ eps_tab, int n_steps,
                               float eps, float eps_jitter, uint32_t seed0,
                               uint32_t seed1) {
  const uint2 key = make_uint2(seed0, seed1);
  for (int s = (int)threadIdx.x; s < n_steps; s += (int)blockDim.x) {
    const uint4 jb = philox4x32_10(make_uint4(0xFFFFFFFFu, s, 0u, 0u), key);
    eps_tab[s] = eps * (1.0f - eps_jitter + 2.0f * eps_jitter * u01(jb.x));
  }
}

template <bool INJECTED, bool COLLECT_ALL>
__global__ void __launch_bounds__(HMC_BLOCK) hmc_fused_kernel(
    const float* __restrict__ v0,        // (D, n)
    float* __restrict__ vout,            // (D, n)
    float* __restrict__ hist,            // (n_steps, n) or (n_steps, D, n)
    float* __restrict__ acc_out,         // (n,)
    const float* __restrict__ res,       // (R,)
    const float* __restrict__ inv_mass,  // (D,)
    const float* __restrict__ sd,        // (rows, n_pts) stream table
    int n_pts,
    int n, int n_steps, int L, int collect_idx,
    uint32_t seed0, uint32_t seed1,
    const float* __restrict__ eps_tab,   // (n_steps,)
    const float* __restrict__ inj_z,     // (n_steps, D, n)
    const float* __restrict__ inj_u) {   // (n_steps, n)
  __shared__ float r[HMC_R];
  for (int k = threadIdx.x; k < HMC_R; k += blockDim.x) r[k] = res[k];
  __syncthreads();
  const int i = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x)
                      / HMC_LANES);
  if (i >= n) return;
  const size_t N = (size_t)n;
  const uint2 key = make_uint2(seed0, seed1);

  float inv[HMC_D], msc[HMC_D], v[HMC_D], g[HMC_D];
#pragma unroll
  for (int k = 0; k < HMC_D; ++k) {
    inv[k] = inv_mass[k];
    msc[k] = inv[k] > 0.0f ? 1.0f / sqrtf(fmaxf(inv[k], 1e-30f)) : 0.0f;
    v[k] = v0[k * N + i];
  }
  float lp;
  staged_vag(v, r, lp, g, sd, n_pts);
  float acc = 0.0f;

  for (int s = 0; s < n_steps; ++s) {
    const float eps_s = __ldg(eps_tab + s);
    float z[HMC_D];
    if (INJECTED) {
#pragma unroll
      for (int k = 0; k < HMC_D; ++k) z[k] = inj_z[((size_t)s * HMC_D + k) * N + i];
    } else {
#pragma unroll
      for (int c = 0; c < (HMC_D + 3) / 4; ++c) {
        const uint4 b = philox4x32_10(make_uint4(i, s, 1u + c, 0u), key);
        float q[4];
        box_muller(b.x, b.y, q[0], q[1]);
        box_muller(b.z, b.w, q[2], q[3]);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (4 * c + t < HMC_D) z[4 * c + t] = q[t];
      }
    }
    float m0[HMC_D], m[HMC_D], vn[HMC_D], gn[HMC_D];
#pragma unroll
    for (int k = 0; k < HMC_D; ++k) {
      m0[k] = msc[k] * z[k];
      m[k] = m0[k];
      vn[k] = v[k];
      gn[k] = g[k];
    }
    float lpn = lp;
    const float half = eps_s * 0.5f;
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int k = 0; k < HMC_D; ++k) {
        m[k] = m[k] + half * gn[k];
        vn[k] = vn[k] + eps_s * (inv[k] * m[k]);
      }
      staged_vag(vn, r, lpn, gn, sd, n_pts);
#pragma unroll
      for (int k = 0; k < HMC_D; ++k) m[k] = m[k] + half * gn[k];
    }
    float alpha = lpn - lp - kinetic(inv, m) + kinetic(inv, m0);
    if (isnan(alpha)) alpha = -__int_as_float(0x7f800000);
    float u;
    if (INJECTED) {
      u = inj_u[(size_t)s * N + i];
    } else {
      const uint4 b = philox4x32_10(make_uint4(i, s, 0u, 0u), key);
      u = fmaxf(u01(b.x), kTiny);
    }
    if (logf(u) < alpha) {
#pragma unroll
      for (int k = 0; k < HMC_D; ++k) {
        v[k] = vn[k];
        g[k] = gn[k];
      }
      lp = lpn;
      acc = acc + 1.0f;
    }
    if (COLLECT_ALL) {
#pragma unroll
      for (int k = 0; k < HMC_D; ++k) hist[((size_t)s * HMC_D + k) * N + i] = v[k];
    } else {
      // one predicated store a coordinate: a select over v[k] by the
      // runtime index would put v in local memory
#pragma unroll
      for (int k = 0; k < HMC_D; ++k)
        if (k == collect_idx) hist[(size_t)s * N + i] = v[k];
    }
  }
#pragma unroll
  for (int k = 0; k < HMC_D; ++k) vout[k * N + i] = v[k];
  acc_out[i] = acc;
}

}  // namespace

// Launches on the caller's stream and returns cudaGetLastError(): a launch
// that is refused never runs, and a later synchronize would not report it.
// Without injected randomness (inj_z null) hmc_eps_kernel first fills
// eps_tab, an (n_steps,) scratch table; with it, eps_tab holds the
// caller's step sizes.
extern "C" int hmc_fused_launch(
    const float* v0, float* vout, float* hist, float* acc_out,
    const float* res, const float* inv_mass, const float* sd, int n_pts,
    int n, int n_steps, int L,
    float eps, float eps_jitter, int collect_idx, unsigned int seed0,
    unsigned int seed1, float* eps_tab, const float* inj_z,
    const float* inj_u, void* stream) {
  const dim3 grid((unsigned)(((size_t)n * HMC_LANES + HMC_BLOCK - 1)
                             / HMC_BLOCK));
  const dim3 block(HMC_BLOCK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool injected = inj_z != nullptr;
  const bool all = collect_idx < 0;
  if (!injected) {
    hmc_eps_kernel<<<1, 32, 0, st>>>(eps_tab, n_steps, eps, eps_jitter,
                                     seed0, seed1);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
#define HMC_ARGS v0, vout, hist, acc_out, res, inv_mass, sd, n_pts, n, \
    n_steps, L, collect_idx, seed0, seed1, eps_tab, inj_z, inj_u
  if (injected && all)
    hmc_fused_kernel<true, true><<<grid, block, 0, st>>>(HMC_ARGS);
  else if (injected)
    hmc_fused_kernel<true, false><<<grid, block, 0, st>>>(HMC_ARGS);
  else if (all)
    hmc_fused_kernel<false, true><<<grid, block, 0, st>>>(HMC_ARGS);
  else
    hmc_fused_kernel<false, false><<<grid, block, 0, st>>>(HMC_ARGS);
#undef HMC_ARGS
  return static_cast<int>(cudaGetLastError());
}
