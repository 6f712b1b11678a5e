// Fused many-chain FSM-NUTS, one leapfrog per tick: num_ticks leapfrogs per
// chain in one launch (kernel K6).
//
// Replaces gen_tpu/ops/nuts_fused.py::_kernel (line 230; the Pallas TPU
// kernel behind nuts_chains_fused(paired=False), the public default).
// Semantics are those of its twin, gen_tpu_torch/inference/nuts_fsm.py::
// run_ticks, tick for tick: every chain does exactly one leapfrog per tick,
// which is never masked out; around it, the bf16x2 pack of (post-leapfrog
// momentum, pre-leapfrog subtree momentum sum) into every checkpoint level
// whose block starts at this position (the in-block boundary-momentum
// rule), the progressive multinomial candidate, the per-level block-end
// U-turn tests, the biased subtree merge, the divergence threshold, the
// trajectory end, and a fresh trajectory on the next tick. Same
// per-trajectory NUTS as K3 (nuts_pair.cu) on a different schedule.
//
// The design is Hopper's, not the TPU's, and K3's:
//
// - One thread per chain; layout (d, n) with chains contiguous, so every
//   history row and state read coalesces across a warp.
// - The chain's state is per-thread arrays: 16 d-vectors (current sample,
//   left/right ends, tree momentum sum, candidate, integration point,
//   subtree momentum sum, subtree candidate, plus the momentum scratch z)
//   and max_depth-1 packed checkpoint vectors. The leapfrog runs in place
//   on the integration point, which K3's two slots could not do. nvcc keeps
//   in registers what fits under the 255-register cap and puts the rest in
//   local memory.
// - Where the TPU evaluated every branch as a full-plane select (no
//   per-lane branch there), a thread branches: the momentum refresh runs
//   only on a fresh tick, the merge only when a subtree ends, the U-turn
//   test only at the levels whose block ends here.
// - The inverse mass, momentum scale and staged residual constants live in
//   shared memory; the staged program (gen_tpu_torch/ops/scalarize.py) is
//   inlined for d <= 32 and one non-inlined function above.
// - Randomness: Philox4x32-10 keyed by the two words of the caller's key,
//   counter (chain, tick, tag, 0); tag 0 gives the four uniforms (u_dir0,
//   u_take, u_bias, u_dir), tags 1.. the Box-Muller normals, drawn only on
//   a fresh tick (the only tick that reads them). Injected mode reads z
//   (T, d, n) and the uniforms (T, 4, n) instead, so the kernel can be held
//   exactly to its plain PyTorch version.
//
// What bounds it: operations. Per chain and tick one staged program (a few
// hundred float operations at d=10, a few thousand at d=102) plus the
// bookkeeping: O(d) for the leapfrog, energy and candidate, O(d) per
// checkpoint level that starts or ends here. Device memory sees the state
// once, one history value and one count per tick, and the final state. At
// large d the per-thread state spills to local memory. Built with
// -fmad=false so that it rounds exactly as its twin.

#include <cuda_runtime.h>
#include <stdint.h>

// @@DEFINES@@

// @@STAGED_VAG@@

#if NUTS_D <= 32
#define NUTS_UNROLL _Pragma("unroll")
#define NUTS_VAG_INLINE __forceinline__
#else
#define NUTS_UNROLL _Pragma("unroll 1")
#define NUTS_VAG_INLINE __noinline__
#endif

#define NUTS_LEVELS (NUTS_MD > 1 ? NUTS_MD - 1 : 1)

// @@NUTS_COMMON@@

namespace {

template <bool INJECTED, bool COLLECT_ALL>
__global__ void __launch_bounds__(NUTS_BLOCK) nuts_tick_kernel(
    const float* __restrict__ v0,        // (D, n)
    float* __restrict__ vout,            // (D, n)
    float* __restrict__ hist,            // (T, n) or (T, D, n)
    int* __restrict__ hist_cnt,          // (T, n)
    int* __restrict__ cnt_out,           // (n,)
    float* __restrict__ stats,           // (5, n)
    const float* __restrict__ res,       // (R,)
    const float* __restrict__ inv_mass,  // (D,)
    const float* __restrict__ mom_scale, // (D,) sqrt_mass_safe(inv_mass)
    int n, int num_ticks, float eps, float div_threshold, int collect_idx,
    uint32_t seed0, uint32_t seed1,
    const float* __restrict__ inj_z,     // (T, D, n)
    const float* __restrict__ inj_u) {   // (T, 4, n)
  __shared__ float r[NUTS_R];
  __shared__ float inv[NUTS_D];
  __shared__ float msc[NUTS_D];
  for (int k = threadIdx.x; k < NUTS_R; k += blockDim.x) r[k] = res[k];
  for (int k = threadIdx.x; k < NUTS_D; k += blockDim.x) {
    inv[k] = inv_mass[k];
    msc[k] = mom_scale[k];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t N = (size_t)n;
  const uint2 key = make_uint2(seed0, seed1);

  // ptv/pr/pg: the integration point; after the tick's leapfrog it holds
  // the new position, momentum and gradient
  float cur[NUTS_D], lt[NUTS_D], lr[NUTS_D], lg[NUTS_D], rt[NUTS_D],
      rr[NUTS_D], rg[NUTS_D], rho[NUTS_D], ct[NUTS_D], cg[NUTS_D],
      ptv[NUTS_D], pr[NUTS_D], pg[NUTS_D], rs[NUTS_D], cs[NUTS_D],
      csg[NUTS_D], z[NUTS_D];
  uint32_t ck[NUTS_LEVELS][NUTS_D];

  NUTS_UNROLL
  for (int k = 0; k < NUTS_D; ++k) cur[k] = v0[k * N + i];
  float lp;
  vag(cur, r, lp, cg);
  NUTS_UNROLL
  for (int k = 0; k < NUTS_D; ++k) {
    lt[k] = rt[k] = ct[k] = ptv[k] = cs[k] = cur[k];
    lg[k] = rg[k] = pg[k] = csg[k] = cg[k];
    lr[k] = rr[k] = rho[k] = pr[k] = rs[k] = 0.0f;
  }
  for (int l = 0; l < NUTS_LEVELS; ++l) {
    NUTS_UNROLL
    for (int k = 0; k < NUTS_D; ++k) ck[l][k] = 0u;
  }
  int count = 0, depth = 0, nlf = 0, sn = 0, nl = 1, div = 0;
  float energy0 = 0.0f, clp = lp, lwt = 0.0f, asum = 0.0f, de = eps;
  float cslp = lp, lws = neg_inf(), acc_sum = 0.0f, depth_sum = 0.0f;
  bool fresh = true;
  const float thr = -div_threshold;

  for (int t = 0; t < num_ticks; ++t) {
    float u[4];
    if (INJECTED) {
#pragma unroll
      for (int j = 0; j < 4; ++j) u[j] = inj_u[((size_t)t * 4 + j) * N + i];
    } else {
      const uint4 b = philox4x32_10(make_uint4(i, t, 0u, 0u), key);
      u[0] = u01(b.x); u[1] = u01(b.y); u[2] = u01(b.z); u[3] = u01(b.w);
    }
    const float u_take = fmaxf(u[1], kTiny), u_bias = fmaxf(u[2], kTiny);

    // -- trajectory init: momentum refresh at the current sample ----------
    if (fresh) {
      if (INJECTED) {
        NUTS_UNROLL
        for (int k = 0; k < NUTS_D; ++k)
          z[k] = inj_z[((size_t)t * NUTS_D + k) * N + i];
      } else {
        philox_normals(z, i, t, 1u, key);
      }
      NUTS_UNROLL
      for (int k = 0; k < NUTS_D; ++k) {
        const float r0 = msc[k] * z[k];
        lr[k] = rr[k] = rho[k] = pr[k] = r0;
        lt[k] = rt[k] = ptv[k] = ct[k];
        lg[k] = rg[k] = pg[k] = cg[k];
        rs[k] = 0.0f;
      }
      energy0 = clp - kinetic(inv, lr);
      lwt = 0.0f;
      depth = 0;
      asum = 0.0f;
      nlf = 0;
      de = u[0] < 0.5f ? eps : -eps;
      sn = 0;
      nl = 1;
      lws = neg_inf();
    }

    // -- ONE leapfrog, in place on the integration point -----------------
    const float half = 0.5f * de;
    NUTS_UNROLL
    for (int k = 0; k < NUTS_D; ++k) {
      pr[k] = pr[k] + half * pg[k];
      ptv[k] = ptv[k] + de * (inv[k] * pr[k]);
    }
    vag(ptv, r, lp, pg);
    NUTS_UNROLL
    for (int k = 0; k < NUTS_D; ++k) pr[k] = pr[k] + half * pg[k];
    // checkpoint writes at every level whose block starts here; rs is
    // still the pre-leapfrog subtree momentum sum
    NUTS_UNROLL
    for (int k = 0; k < NUTS_D; ++k) {
      const uint32_t pk = pack2(pr[k], rs[k]);
#pragma unroll
      for (int l = 1; l <= NUTS_LEVELS && l < NUTS_MD; ++l)
        if ((sn & ((1 << l) - 1)) == 0) ck[l - 1][k] = pk;
    }
    float delta = (lp - kinetic(inv, pr)) - energy0;
    if (isnan(delta)) delta = neg_inf();
    const bool dv = delta < thr;
    asum = asum + fminf(expf(delta), 1.0f);
    nlf += 1;
    // progressive multinomial candidate within the subtree
    lws = logaddexp(lws, delta);
    if (logf(u_take) < delta - lws) {
      copy(cs, ptv);
      cslp = lp;
      copy(csg, pg);
    }
    NUTS_UNROLL
    for (int k = 0; k < NUTS_D; ++k) rs[k] = rs[k] + pr[k];
    // block-end U-turn tests at every level whose block ends here
    bool turning_sub = false;
#pragma unroll
    for (int l = 1; l < NUTS_MD; ++l) {
      if (((sn + 1) & ((1 << l) - 1)) != 0) continue;
      turning_sub = turning_sub || uturn_block(inv, rs, ck[l - 1], pr);
    }
    const bool sub_done = sn + 1 >= nl || turning_sub || dv;

    // -- subtree merge into the tree -------------------------------------
    bool traj_done = false;
    if (sub_done) {
      const bool ok = !turning_sub && !dv;
      if (ok && logf(u_bias) < lws - lwt) {
        copy(ct, cs);
        clp = cslp;
        copy(cg, csg);
      }
      if (ok) {
        lwt = logaddexp(lwt, lws);
        if (de > 0.0f) {
          copy(rt, ptv); copy(rr, pr); copy(rg, pg);
        } else {
          copy(lt, ptv); copy(lr, pr); copy(lg, pg);
        }
        NUTS_UNROLL
        for (int k = 0; k < NUTS_D; ++k) rho[k] = rho[k] + rs[k];
      }
      traj_done = turning_sub || dv || (ok && uturn(inv, rho, lr, rr))
          || depth + 1 >= NUTS_MD;
    }
    // -- next subtree: continue from the end it extends ------------------
    if (sub_done && !traj_done) {
      depth += 1;
      de = u[3] < 0.5f ? eps : -eps;
      if (de > 0.0f) {
        copy(ptv, rt); copy(pr, rr); copy(pg, rg);
      } else {
        copy(ptv, lt); copy(pr, lr); copy(pg, lg);
      }
      nl = 1 << depth;
      NUTS_UNROLL
      for (int k = 0; k < NUTS_D; ++k) rs[k] = 0.0f;
      lws = neg_inf();
    }
    sn = sub_done ? 0 : sn + 1;
    // -- trajectory finish: emit the sample, refresh on the next tick ----
    if (traj_done) {
      copy(cur, ct);
      count += 1;
      acc_sum = acc_sum + asum / (float)max(nlf, 1);
      depth_sum = depth_sum + ((float)depth + 1.0f);
      if (dv) div += 1;
    }
    fresh = traj_done;

    if (COLLECT_ALL) {
      NUTS_UNROLL
      for (int k = 0; k < NUTS_D; ++k)
        hist[((size_t)t * NUTS_D + k) * N + i] = cur[k];
    } else {
      float c = cur[0];
      NUTS_UNROLL
      for (int k = 1; k < NUTS_D; ++k)
        if (k == collect_idx) c = cur[k];
      hist[(size_t)t * N + i] = c;
    }
    hist_cnt[(size_t)t * N + i] = count;
  }
  NUTS_UNROLL
  for (int k = 0; k < NUTS_D; ++k) vout[k * N + i] = cur[k];
  cnt_out[i] = count;
  stats[i] = acc_sum;
  stats[N + i] = depth_sum;
  stats[2 * N + i] = (float)div;
  stats[3 * N + i] = asum;
  stats[4 * N + i] = (float)nlf;
}

}  // namespace

// Launches on the caller's stream and returns cudaGetLastError(): a launch
// that is refused never runs, and a later synchronize would not report it.
extern "C" int nuts_tick_launch(
    const float* v0, float* vout, float* hist, int* hist_cnt, int* cnt_out,
    float* stats, const float* res, const float* inv_mass,
    const float* mom_scale, int n, int num_ticks, float eps,
    float div_threshold, int collect_idx, unsigned int seed0,
    unsigned int seed1, const float* inj_z, const float* inj_u,
    void* stream) {
  const dim3 grid((n + NUTS_BLOCK - 1) / NUTS_BLOCK);
  const dim3 block(NUTS_BLOCK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool injected = inj_z != nullptr;
  const bool all = collect_idx < 0;
#define NUTS_ARGS v0, vout, hist, hist_cnt, cnt_out, stats, res, inv_mass, \
    mom_scale, n, num_ticks, eps, div_threshold, collect_idx, seed0, seed1, \
    inj_z, inj_u
  if (injected && all)
    nuts_tick_kernel<true, true><<<grid, block, 0, st>>>(NUTS_ARGS);
  else if (injected)
    nuts_tick_kernel<true, false><<<grid, block, 0, st>>>(NUTS_ARGS);
  else if (all)
    nuts_tick_kernel<false, true><<<grid, block, 0, st>>>(NUTS_ARGS);
  else
    nuts_tick_kernel<false, false><<<grid, block, 0, st>>>(NUTS_ARGS);
#undef NUTS_ARGS
  return static_cast<int>(cudaGetLastError());
}
