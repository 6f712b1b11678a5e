// Fused many-chain pair-scheduled FSM-NUTS: num_pairs x 2 leapfrog slots
// per chain in one launch.
//
// Replaces gen_tpu/ops/nuts_fused.py::_kernel_pair (line 550; the Pallas
// TPU kernel behind nuts_chains_fused(paired=True)). Semantics are those of
// its twin, gen_tpu_torch/inference/nuts_fsm.py::run_pairs, pair for pair:
// iterative multinomial NUTS with power-of-two momentum checkpoints (the
// in-block boundary-momentum rule: a block's checkpoint is its first
// in-block momentum), checkpoints packed bf16x2 into one uint32 per
// coordinate and level, biased progressive merging of subtrees, divergence
// threshold, and a fresh trajectory on the pair after one completes. Subtree
// starts are aligned to pairs, so the checkpoint writes run only in slot 1
// and the per-level U-turn end tests only in slot 2.
//
// The design is Hopper's, not the TPU's:
//
// - One thread per chain; layout (d, n) with chains contiguous, so every
//   history row and state read coalesces across a warp. There is no
//   cross-chain work.
// - The chain's whole NUTS state is per-thread arrays: 16 d-vectors (current
//   sample, left/right ends, tree momentum sum, candidate, integration
//   point, subtree momentum sum, subtree candidate) plus max_depth-1 packed
//   checkpoint vectors, (16 + max_depth - 1) d words. nvcc keeps in
//   registers what fits under the 255-register cap and puts the rest in
//   local memory (L1/L2-cached); at d=102 that is about 9.4 KB per thread.
//   Moving it to shared memory or a warp-cooperative layout is later work.
// - The scalar carry (counts, energies, log weights, depth, sums) lives in
//   registers. The inverse mass, momentum scale and the staged residual
//   constants are in shared memory.
// - A streamed likelihood (a loop over the data table sd, (rows, n_pts))
//   gets a warp per chain (NUTS_LANES 32): the 32 lanes run the chain's
//   NUTS bookkeeping on the same values, and inside staged_vag each lane
//   sums every 32nd point, Kahan-compensated, before a shuffle tree gives
//   every lane the same sums. All lanes store the same values.
// - The model's value and gradient is staged_vag, generated by
//   gen_tpu_torch/ops/scalarize.py and spliced in below. For small d it is
//   inlined at its three call sites; for large d it is one non-inlined
//   function, so the straight-line program is compiled once.
// - The Philox, Box-Muller, logaddexp, bf16 and dot-product helpers are
//   shared with K6 (nuts_tick.cu) in nuts_common.cuh, spliced in below.
// - Randomness: Philox4x32-10 keyed by the two words of the caller's key,
//   counter (chain, pair, tag, 0); tags 0-1 give the seven uniforms, tags
//   2.. the Box-Muller normals. Injected mode reads z (pairs, d, n) and the
//   uniforms (pairs, 7, n) instead, so the kernel can be held exactly to its
//   plain PyTorch version.
// - Divergent and idle chains branch: a chain that ends a subtree in slot 1
//   skips slot 2 (its leapfrog and bookkeeping), which its twin computes and
//   masks out with the same result.
//
// What bounds it: operations. Per chain and pair it evaluates the staged
// program twice (a few hundred float operations at d=10, a few thousand at
// d=102, with IEEE divisions and expf) plus O(max_depth x d) bookkeeping;
// device memory sees the state once, one history value and one count per
// pair, and the final state. At large d the per-thread state spills to
// local memory and its traffic through L1/L2 adds to that. Built with
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
__global__ void __launch_bounds__(NUTS_BLOCK) nuts_pair_kernel(
    const float* __restrict__ v0,        // (D, n)
    float* __restrict__ vout,            // (D, n)
    float* __restrict__ hist,            // (P, n) or (P, D, n)
    int* __restrict__ hist_cnt,          // (P, n)
    int* __restrict__ cnt_out,           // (n,)
    float* __restrict__ stats,           // (5, n)
    const float* __restrict__ res,       // (R,)
    const float* __restrict__ inv_mass,  // (D,)
    const float* __restrict__ mom_scale, // (D,) sqrt_mass_safe(inv_mass)
    const float* __restrict__ sd,        // (rows, n_pts) stream table
    int n_pts, int n, int num_pairs, float eps, float div_threshold, int collect_idx,
    uint32_t seed0, uint32_t seed1,
    const float* __restrict__ inj_z,     // (P, D, n)
    const float* __restrict__ inj_u) {   // (P, 7, n)
  __shared__ float r[NUTS_R];
  __shared__ float inv[NUTS_D];
  __shared__ float msc[NUTS_D];
  for (int k = threadIdx.x; k < NUTS_R; k += blockDim.x) r[k] = res[k];
  for (int k = threadIdx.x; k < NUTS_D; k += blockDim.x) {
    inv[k] = inv_mass[k];
    msc[k] = mom_scale[k];
  }
  __syncthreads();
  const int i = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x)
                      / NUTS_LANES);
  if (i >= n) return;
  const size_t N = (size_t)n;
  const uint2 key = make_uint2(seed0, seed1);

  float cur[NUTS_D], lt[NUTS_D], lr[NUTS_D], lg[NUTS_D], rt[NUTS_D],
      rr[NUTS_D], rg[NUTS_D], rho[NUTS_D], ct[NUTS_D], cg[NUTS_D],
      ptv[NUTS_D], pr[NUTS_D], pg[NUTS_D], rs[NUTS_D], cs[NUTS_D],
      csg[NUTS_D];
  uint32_t ck[NUTS_LEVELS][NUTS_D];
  float th[NUTS_D], rn[NUTS_D], g[NUTS_D], z[NUTS_D];

  NUTS_UNROLL
  for (int k = 0; k < NUTS_D; ++k) cur[k] = v0[k * N + i];
  float lp;
  vag(cur, r, lp, g, sd, n_pts);
  NUTS_UNROLL
  for (int k = 0; k < NUTS_D; ++k) {
    lt[k] = rt[k] = ct[k] = ptv[k] = cs[k] = cur[k];
    lg[k] = rg[k] = cg[k] = pg[k] = csg[k] = g[k];
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

  for (int p = 0; p < num_pairs; ++p) {
    float u[7];
    if (INJECTED) {
      NUTS_UNROLL
      for (int k = 0; k < NUTS_D; ++k)
        z[k] = inj_z[((size_t)p * NUTS_D + k) * N + i];
#pragma unroll
      for (int j = 0; j < 7; ++j) u[j] = inj_u[((size_t)p * 7 + j) * N + i];
    } else {
      const uint4 b0 = philox4x32_10(make_uint4(i, p, 0u, 0u), key);
      const uint4 b1 = philox4x32_10(make_uint4(i, p, 1u, 0u), key);
      u[0] = u01(b0.x); u[1] = u01(b0.y); u[2] = u01(b0.z);
      u[3] = u01(b0.w); u[4] = u01(b1.x); u[5] = u01(b1.y);
      u[6] = u01(b1.z);
      philox_normals(z, i, p, 2u, key);
    }
    const float u_take1 = fmaxf(u[1], kTiny), u_bias1 = fmaxf(u[2], kTiny);
    const float u_take2 = fmaxf(u[4], kTiny), u_bias2 = fmaxf(u[5], kTiny);

    // -- trajectory init: momentum refresh at the current sample ----------
    if (fresh) {
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

    // ============ slot 1 (sn even for every chain) ======================
    float half = 0.5f * de;
    NUTS_UNROLL
    for (int k = 0; k < NUTS_D; ++k) {
      rn[k] = pr[k] + half * pg[k];
      th[k] = ptv[k] + de * (inv[k] * rn[k]);
    }
    vag(th, r, lp, g, sd, n_pts);
    NUTS_UNROLL
    for (int k = 0; k < NUTS_D; ++k) rn[k] = rn[k] + half * g[k];
    // checkpoint writes (block starts live only at even positions); rs is
    // still the pre-leapfrog subtree momentum sum here
    NUTS_UNROLL
    for (int k = 0; k < NUTS_D; ++k) {
      const uint32_t pk = pack2(rn[k], rs[k]);
#pragma unroll
      for (int l = 1; l <= NUTS_LEVELS && l < NUTS_MD; ++l)
        if ((sn & ((1 << l) - 1)) == 0) ck[l - 1][k] = pk;
    }
    float delta1 = (lp - kinetic(inv, rn)) - energy0;
    if (isnan(delta1)) delta1 = neg_inf();
    const bool div1 = delta1 < thr;
    asum = asum + fminf(expf(delta1), 1.0f);
    nlf += 1;
    const float lws1 = logaddexp(lws, delta1);
    if (logf(u_take1) < delta1 - lws1) {
      copy(cs, th);
      cslp = lp;
      copy(csg, g);
    }
    NUTS_UNROLL
    for (int k = 0; k < NUTS_D; ++k) rs[k] = rs[k] + rn[k];

    // mid-pair subtree end: the 1-leapfrog first subtree or a divergence
    const bool m1 = (nl == 1) || div1;
    bool traj_done1 = false;
    if (m1) {
      if (!div1 && logf(u_bias1) < lws1 - lwt) {
        copy(ct, cs);
        clp = cslp;
        copy(cg, csg);
      }
      if (!div1) {
        lwt = logaddexp(lwt, lws1);
        if (de > 0.0f) {
          copy(rt, th); copy(rr, rn); copy(rg, g);
        } else {
          copy(lt, th); copy(lr, rn); copy(lg, g);
        }
        NUTS_UNROLL
        for (int k = 0; k < NUTS_D; ++k) rho[k] = rho[k] + rs[k];
      }
      traj_done1 = div1 || uturn(inv, rho, lr, rr) || depth + 1 >= NUTS_MD;
    }
    const bool start1 = m1 && !traj_done1;
    if (start1) {
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
    } else {
      copy(ptv, th);
      copy(pr, rn);
      copy(pg, g);
      lws = lws1;
    }
    sn = m1 ? 0 : sn + 1;
    if (traj_done1) {
      copy(cur, ct);
      count += 1;
      acc_sum = acc_sum + asum / (float)max(nlf, 1);
      depth_sum = depth_sum + ((float)depth + 1.0f);
      if (div1) div += 1;
    }

    // ============ slot 2 (chains that ended a subtree in slot 1 idle) ===
    bool traj_done2 = false;
    if (!m1) {
      half = 0.5f * de;
      NUTS_UNROLL
      for (int k = 0; k < NUTS_D; ++k) {
        rn[k] = pr[k] + half * pg[k];
        th[k] = ptv[k] + de * (inv[k] * rn[k]);
      }
      vag(th, r, lp, g, sd, n_pts);
      NUTS_UNROLL
      for (int k = 0; k < NUTS_D; ++k) rn[k] = rn[k] + half * g[k];
      float delta2 = (lp - kinetic(inv, rn)) - energy0;
      if (isnan(delta2)) delta2 = neg_inf();
      const bool div2 = delta2 < thr;
      asum = asum + fminf(expf(delta2), 1.0f);
      nlf += 1;
      const float lws2 = logaddexp(lws, delta2);
      if (logf(u_take2) < delta2 - lws2) {
        copy(cs, th);
        cslp = lp;
        copy(csg, g);
      }
      NUTS_UNROLL
      for (int k = 0; k < NUTS_D; ++k) rs[k] = rs[k] + rn[k];
      // the pair-boundary U-turn section (sn odd here)
      bool turning_sub = false;
#pragma unroll
      for (int l = 1; l < NUTS_MD; ++l) {
        if (((sn + 1) & ((1 << l) - 1)) != 0) continue;
        turning_sub = turning_sub || uturn_block(inv, rs, ck[l - 1], rn);
      }
      const bool sub_done2 = sn + 1 >= nl || turning_sub || div2;
      if (sub_done2) {
        const bool ok2 = !turning_sub && !div2;
        if (ok2 && logf(u_bias2) < lws2 - lwt) {
          copy(ct, cs);
          clp = cslp;
          copy(cg, csg);
        }
        if (ok2) {
          lwt = logaddexp(lwt, lws2);
          if (de > 0.0f) {
            copy(rt, th); copy(rr, rn); copy(rg, g);
          } else {
            copy(lt, th); copy(lr, rn); copy(lg, g);
          }
          NUTS_UNROLL
          for (int k = 0; k < NUTS_D; ++k) rho[k] = rho[k] + rs[k];
        }
        traj_done2 = turning_sub || div2 || (ok2 && uturn(inv, rho, lr, rr))
            || depth + 1 >= NUTS_MD;
      }
      if (sub_done2 && !traj_done2) {
        depth += 1;
        de = u[6] < 0.5f ? eps : -eps;
        if (de > 0.0f) {
          copy(ptv, rt); copy(pr, rr); copy(pg, rg);
        } else {
          copy(ptv, lt); copy(pr, lr); copy(pg, lg);
        }
        nl = 1 << depth;
        NUTS_UNROLL
        for (int k = 0; k < NUTS_D; ++k) rs[k] = 0.0f;
        lws = neg_inf();
      } else {
        copy(ptv, th);
        copy(pr, rn);
        copy(pg, g);
        lws = lws2;
      }
      sn = sub_done2 ? 0 : sn + 1;
      if (traj_done2) {
        copy(cur, ct);
        count += 1;
        acc_sum = acc_sum + asum / (float)max(nlf, 1);
        depth_sum = depth_sum + ((float)depth + 1.0f);
        if (div2) div += 1;
      }
    }
    fresh = traj_done1 || traj_done2;

    if (COLLECT_ALL) {
      NUTS_UNROLL
      for (int k = 0; k < NUTS_D; ++k)
        hist[((size_t)p * NUTS_D + k) * N + i] = cur[k];
    } else {
      float c = cur[0];
      NUTS_UNROLL
      for (int k = 1; k < NUTS_D; ++k)
        if (k == collect_idx) c = cur[k];
      hist[(size_t)p * N + i] = c;
    }
    hist_cnt[(size_t)p * N + i] = count;
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
extern "C" int nuts_pair_launch(
    const float* v0, float* vout, float* hist, int* hist_cnt, int* cnt_out,
    float* stats, const float* res, const float* inv_mass,
    const float* mom_scale, const float* sd, int n_pts, int n, int num_pairs,
    float eps, float div_threshold, int collect_idx, unsigned int seed0,
    unsigned int seed1, const float* inj_z, const float* inj_u,
    void* stream) {
  const dim3 grid((unsigned)(((size_t)n * NUTS_LANES + NUTS_BLOCK - 1)
                             / NUTS_BLOCK));
  const dim3 block(NUTS_BLOCK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool injected = inj_z != nullptr;
  const bool all = collect_idx < 0;
#define NUTS_ARGS v0, vout, hist, hist_cnt, cnt_out, stats, res, inv_mass, \
    mom_scale, sd, n_pts, n, num_pairs, eps, div_threshold, collect_idx, \
    seed0, seed1, inj_z, inj_u
  if (injected && all)
    nuts_pair_kernel<true, true><<<grid, block, 0, st>>>(NUTS_ARGS);
  else if (injected)
    nuts_pair_kernel<true, false><<<grid, block, 0, st>>>(NUTS_ARGS);
  else if (all)
    nuts_pair_kernel<false, true><<<grid, block, 0, st>>>(NUTS_ARGS);
  else
    nuts_pair_kernel<false, false><<<grid, block, 0, st>>>(NUTS_ARGS);
#undef NUTS_ARGS
  return static_cast<int>(cudaGetLastError());
}
