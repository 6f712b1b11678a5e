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
// The design is Hopper's, not the TPU's. ops/nuts_fused.py keeps one of
// three layouts of the kernel (the lines after a "LAYOUT" marker that
// names it, up to the next marker; kernel_layout picks):
//
// - One thread per chain (d <= 32, a streamed likelihood, or d > 128):
//   layout (d, n) with chains contiguous, so every history row and state
//   read coalesces across a warp. The chain's whole NUTS state is
//   per-thread arrays: 16 d-vectors (current sample, left/right ends, tree
//   momentum sum, candidate, integration point, subtree momentum sum,
//   subtree candidate) plus max_depth-1 packed checkpoint vectors. Up to
//   d=32 the loops unroll and nvcc keeps in registers what fits under the
//   255-register cap; above, every array is indexed dynamically and lives
//   in local memory, which is why 32 < d <= 128 has the warp layout. d >
//   128 (more than 4 coordinates per lane) keeps this layout for now.
// - One warp per chain (32 < d <= 128, no stream): lane l owns coordinates
//   4l..4l+3 of every d-vector and checkpoint vector, 27 x 4 words in
//   registers (compile-time slots, fully unrolled; no local-memory state).
//   Every sum over coordinates (kinetic energy, U-turn tests) is each
//   lane's partial sum in coordinate order, then a fixed xor-shuffle
//   butterfly, so every lane holds the same bits and computes the same
//   scalar carry: every branch is warp-uniform. The staged program is the
//   split rendering of ops/scalarize.py (SplitProgram): each coordinate's
//   terms on its owner lane, the hub coordinates' on every lane, each
//   reduction as lane partials plus the butterfly, inlined. The momentum
//   normals of lane l are the Philox block (chain, pair, 2 + l, 0), the
//   one-thread layout's bits for those coordinates.
// - The scalar carry (counts, energies, log weights, depth, sums) lives in
//   registers. The staged residual constants are in shared memory; in the
//   one-thread layout also the inverse mass and momentum scale, which the
//   warp layout keeps in each lane's registers.
// - A streamed likelihood (a loop over the data table sd, rows of padded
//   length) runs the one-thread layout's code in the stream layout:
//   NUTS_LANES / 32 warps per chain (1-8 by the data length) run the
//   chain's NUTS bookkeeping on the same values and split the loop inside
//   staged_vag. The loop is bound by its per-point arithmetic (IEEE
//   divisions, log1p, -fmad=false): each lane evaluates a block of points
//   of every tile as independent instructions and Kahan-adds the block's
//   tree sum, from tiles copied into a shared-memory ring (cp.async).
//   One chain a block, as slot 2 is conditional per chain: every warp of
//   the block takes the same branch, so the loop's barriers hold.
//   NUTS_MIN_BLOCKS blocks an SM (at most 128 registers) was faster on the
//   H100 than one block an SM at 182 registers, and than two chains a
//   block sharing the tiles with slot 2 run for both when one needs it.
//   Where a chain is one warp, 4 points a lane (not 8) keep the chain's
//   state out of local memory. All lanes store the same values.
// - In the one-thread layout the model's value and gradient is staged_vag
//   (gen_tpu_torch/ops/scalarize.py), inlined at its three call sites for
//   small programs, one non-inlined function for large ones.
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
// pair, and the final state. In the warp layout the latency of the
// shuffle and division chains, with ~3 chains per SM scheduler (about 160
// registers per lane), sets the pace: at d=102 on an H100 about 3% of the
// operation bound, against 0.4% when the one-thread state spilled to local
// memory; lanes 26-31 idle at d=102.
// Built with -fmad=false so that it rounds exactly as its twin.

#include <cuda_runtime.h>
#include <stdint.h>

// @@DEFINES@@

// @@STAGED_VAG@@

// @@LAYOUT thread stream@@
#if NUTS_D <= 32
#define NUTS_UNROLL _Pragma("unroll")
#define NUTS_VAG_INLINE __forceinline__
#else
#define NUTS_UNROLL _Pragma("unroll 1")
#define NUTS_VAG_INLINE __noinline__
#endif
// @@LAYOUT end@@

#define NUTS_LEVELS (NUTS_MD > 1 ? NUTS_MD - 1 : 1)

// @@NUTS_COMMON@@

// @@LAYOUT thread stream@@
namespace {

template <bool INJECTED, bool COLLECT_ALL>
// @@LAYOUT thread@@
__global__ void __launch_bounds__(NUTS_BLOCK) nuts_pair_kernel(
// @@LAYOUT stream@@
__global__ void __launch_bounds__(NUTS_BLOCK, NUTS_MIN_BLOCKS)
nuts_pair_kernel(
// @@LAYOUT thread stream@@
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
// @@LAYOUT end@@
// @@LAYOUT warp@@
namespace {

// One warp per chain: lane l holds coordinates 4l .. 4l+3 of every
// d-vector (slots c = 0..3, those below NUTS_D) in registers. The scalar
// carry is computed by every lane from the same butterflied sums and the
// same Philox uniforms, so every branch is warp-uniform.
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
    const float* __restrict__ sd,        // unused (no stream table)
    int n_pts, int n, int num_pairs, float eps, float div_threshold, int collect_idx,
    uint32_t seed0, uint32_t seed1,
    const float* __restrict__ inj_z,     // (P, D, n)
    const float* __restrict__ inj_u) {   // (P, 7, n)
  __shared__ float r[NUTS_R];
  for (int k = threadIdx.x; k < NUTS_R; k += blockDim.x) r[k] = res[k];
  __syncthreads();
  const int i = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x)
                      / NUTS_LANES);
  if (i >= n) return;                    // the whole warp
  const int lane = (int)(threadIdx.x & 31u);
  const size_t N = (size_t)n;
  const uint2 key = make_uint2(seed0, seed1);

  float inv[NUTS_CPL], msc[NUTS_CPL];
  float cur[NUTS_CPL], lt[NUTS_CPL], lr[NUTS_CPL], lg[NUTS_CPL],
      rt[NUTS_CPL], rr[NUTS_CPL], rg[NUTS_CPL], rho[NUTS_CPL], ct[NUTS_CPL],
      cg[NUTS_CPL], ptv[NUTS_CPL], pr[NUTS_CPL], pg[NUTS_CPL], rs[NUTS_CPL],
      cs[NUTS_CPL], csg[NUTS_CPL];
  uint32_t ck[NUTS_LEVELS][NUTS_CPL];
  float th[NUTS_CPL], rn[NUTS_CPL], g[NUTS_CPL], z[NUTS_CPL];

#pragma unroll
  for (int c = 0; c < NUTS_CPL; ++c) {
    const int k = NUTS_CPL * lane + c;
    inv[c] = owns(lane, c) ? inv_mass[k] : 0.0f;
    msc[c] = owns(lane, c) ? mom_scale[k] : 0.0f;
    cur[c] = owns(lane, c) ? v0[k * N + i] : 0.0f;
  }
  float lp;
  vag(cur, r, lp, g, lane);
#pragma unroll
  for (int c = 0; c < NUTS_CPL; ++c) {
    lt[c] = rt[c] = ct[c] = ptv[c] = cs[c] = cur[c];
    lg[c] = rg[c] = cg[c] = pg[c] = csg[c] = g[c];
    lr[c] = rr[c] = rho[c] = pr[c] = rs[c] = 0.0f;
#pragma unroll
    for (int l = 0; l < NUTS_LEVELS; ++l) ck[l][c] = 0u;
  }
  int count = 0, depth = 0, nlf = 0, sn = 0, nl = 1, div = 0;
  float energy0 = 0.0f, clp = lp, lwt = 0.0f, asum = 0.0f, de = eps;
  float cslp = lp, lws = neg_inf(), acc_sum = 0.0f, depth_sum = 0.0f;
  bool fresh = true;
  const float thr = -div_threshold;

  for (int p = 0; p < num_pairs; ++p) {
    float u[7];
    if (INJECTED) {
#pragma unroll
      for (int c = 0; c < NUTS_CPL; ++c)
        z[c] = owns(lane, c)
            ? inj_z[((size_t)p * NUTS_D + NUTS_CPL * lane + c) * N + i]
            : 0.0f;
#pragma unroll
      for (int j = 0; j < 7; ++j) u[j] = inj_u[((size_t)p * 7 + j) * N + i];
    } else {
      const uint4 b0 = philox4x32_10(make_uint4(i, p, 0u, 0u), key);
      const uint4 b1 = philox4x32_10(make_uint4(i, p, 1u, 0u), key);
      u[0] = u01(b0.x); u[1] = u01(b0.y); u[2] = u01(b0.z);
      u[3] = u01(b0.w); u[4] = u01(b1.x); u[5] = u01(b1.y);
      u[6] = u01(b1.z);
      lane_normals(z, i, p, 2u, key, lane);
    }
    const float u_take1 = fmaxf(u[1], kTiny), u_bias1 = fmaxf(u[2], kTiny);
    const float u_take2 = fmaxf(u[4], kTiny), u_bias2 = fmaxf(u[5], kTiny);

    // -- trajectory init: momentum refresh at the current sample ----------
    if (fresh) {
#pragma unroll
      for (int c = 0; c < NUTS_CPL; ++c) {
        const float r0 = msc[c] * z[c];
        lr[c] = rr[c] = rho[c] = pr[c] = r0;
        lt[c] = rt[c] = ptv[c] = ct[c];
        lg[c] = rg[c] = pg[c] = cg[c];
        rs[c] = 0.0f;
      }
      energy0 = clp - kinetic(inv, lr, lane);
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
#pragma unroll
    for (int c = 0; c < NUTS_CPL; ++c) {
      rn[c] = pr[c] + half * pg[c];
      th[c] = ptv[c] + de * (inv[c] * rn[c]);
    }
    vag(th, r, lp, g, lane);
#pragma unroll
    for (int c = 0; c < NUTS_CPL; ++c) rn[c] = rn[c] + half * g[c];
    // checkpoint writes (block starts live only at even positions); rs is
    // still the pre-leapfrog subtree momentum sum here
#pragma unroll
    for (int c = 0; c < NUTS_CPL; ++c) {
      const uint32_t pk = pack2(rn[c], rs[c]);
#pragma unroll
      for (int l = 1; l <= NUTS_LEVELS && l < NUTS_MD; ++l)
        if ((sn & ((1 << l) - 1)) == 0) ck[l - 1][c] = pk;
    }
    float delta1 = (lp - kinetic(inv, rn, lane)) - energy0;
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
#pragma unroll
    for (int c = 0; c < NUTS_CPL; ++c) rs[c] = rs[c] + rn[c];

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
#pragma unroll
        for (int c = 0; c < NUTS_CPL; ++c) rho[c] = rho[c] + rs[c];
      }
      traj_done1 = div1 || uturn(inv, rho, lr, rr, lane)
          || depth + 1 >= NUTS_MD;
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
#pragma unroll
      for (int c = 0; c < NUTS_CPL; ++c) rs[c] = 0.0f;
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
#pragma unroll
      for (int c = 0; c < NUTS_CPL; ++c) {
        rn[c] = pr[c] + half * pg[c];
        th[c] = ptv[c] + de * (inv[c] * rn[c]);
      }
      vag(th, r, lp, g, lane);
#pragma unroll
      for (int c = 0; c < NUTS_CPL; ++c) rn[c] = rn[c] + half * g[c];
      float delta2 = (lp - kinetic(inv, rn, lane)) - energy0;
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
#pragma unroll
      for (int c = 0; c < NUTS_CPL; ++c) rs[c] = rs[c] + rn[c];
      // the pair-boundary U-turn section (sn odd here)
      bool turning_sub = false;
#pragma unroll
      for (int l = 1; l < NUTS_MD; ++l) {
        if (((sn + 1) & ((1 << l) - 1)) != 0) continue;
        turning_sub = turning_sub
            || uturn_block(inv, rs, ck[l - 1], rn, lane);
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
#pragma unroll
          for (int c = 0; c < NUTS_CPL; ++c) rho[c] = rho[c] + rs[c];
        }
        traj_done2 = turning_sub || div2
            || (ok2 && uturn(inv, rho, lr, rr, lane)) || depth + 1 >= NUTS_MD;
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
#pragma unroll
        for (int c = 0; c < NUTS_CPL; ++c) rs[c] = 0.0f;
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
#pragma unroll
      for (int c = 0; c < NUTS_CPL; ++c)
        if (owns(lane, c))
          hist[((size_t)p * NUTS_D + NUTS_CPL * lane + c) * N + i] = cur[c];
    } else {
      float cv = cur[0];
#pragma unroll
      for (int c = 1; c < NUTS_CPL; ++c)
        if (c == collect_idx % NUTS_CPL) cv = cur[c];
      if (lane == collect_idx / NUTS_CPL) hist[(size_t)p * N + i] = cv;
    }
    if (lane == 0) hist_cnt[(size_t)p * N + i] = count;
  }
#pragma unroll
  for (int c = 0; c < NUTS_CPL; ++c)
    if (owns(lane, c)) vout[(NUTS_CPL * lane + c) * N + i] = cur[c];
  if (lane == 0) {
    cnt_out[i] = count;
    stats[i] = acc_sum;
    stats[N + i] = depth_sum;
    stats[2 * N + i] = (float)div;
    stats[3 * N + i] = asum;
    stats[4 * N + i] = (float)nlf;
  }
}

}  // namespace
// @@LAYOUT end@@

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
