"""Finite-state-machine NUTS: the fused kernels' twins and the FSM pipeline.

Counterpart: ``gen_tpu/inference/nuts_fsm.py``, all of it: ``FSMResult``,
``nuts_fsm`` (one leapfrog per tick), ``nuts_fsm_paired`` (two leapfrogs per
tick, subtree starts aligned to pair boundaries, so checkpoint writes happen
only in slot 1 and the per-level U-turn end tests only in slot 2) and
``nuts_fsm_warmup_and_sample`` (chunked dual averaging and diagonal mass
over three stages, then sampling). The per-trajectory semantics are
gen_tpu's: iterative multinomial NUTS, progressive candidates, biased
merging, power-of-two checkpoints with the in-block boundary-momentum rule,
divergence threshold, and bf16-rounded checkpoints (``ckpt_bf16``).

Where PyTorch forced differences:

- The chains are a batch dimension written out: ``theta0`` is ``(n, d)``
  and ``key`` ``(n, 2)`` (one key per chain, as under gen_tpu's vmap). The
  step size may be one per chain ``(n,)`` and the inverse mass one per
  chain ``(n, d)``, which is what the vmapped warmup adapts.
  ``injected_rng`` takes gen_tpu's layouts with a chain axis: for
  ``nuts_fsm`` ``z (ticks, n, d)`` and ``u_dir0, u_take, u_bias, u_dir``
  each ``(ticks, n)``; for ``nuts_fsm_paired`` ``z (pairs, n, d)`` and
  ``u_dir0, u_take1, u_bias1, u_dir1, u_take2, u_bias2, u_dir2`` each
  ``(pairs, n)``. The streams come back step-major, ``(steps, n[, d])``,
  and ``FSMResult.slots`` is ``(n, num_sample_slots, d)``.
- The loops, :func:`run_ticks` and :func:`run_pairs`, keep the state in the
  fused kernels' layout ``(d, n)`` and do the kernels' arithmetic in the
  kernels' order: sums over coordinates run 0..d-1, ``logaddexp`` is
  written out, and the take/bias uniforms are clamped to FLT_MIN before
  their log. With ``torch.func`` of the logp they are ``nuts_fsm`` and
  ``nuts_fsm_paired``; with the staged program as ``vag`` they are the
  plain versions of K6 and K3 (:func:`gen_tpu_torch.ops.nuts_fused.
  nuts_chains_fused_plain`).
- The warmup's chunks are a Python loop where gen_tpu scans.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.func import vmap

from .. import random
from ..utils import bf16_round, sqrt_mass_safe
from .nuts import logaddexp

_TINY = 1.1754944e-38           # FLT_MIN: keeps log(u) finite


class FSMResult(NamedTuple):
    slots: torch.Tensor         # (n, B, dim) FIRST samples in order (writes
                                # stop once the buffer fills); B = 0 paired
    counts: torch.Tensor        # (n,) int32, completed trajectories
    theta: torch.Tensor         # (n, dim) final current sample
    mean_accept: torch.Tensor   # mean accept-stat over completed trajectories
    mean_depth: torch.Tensor
    num_divergent: torch.Tensor
    pos_mean: torch.Tensor      # (n, dim) mean of per-tick leapfrog
    pos_var: torch.Tensor       # positions, their variance; zeros paired


def _seqsum(p: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum over the coordinate axis ``dim`` in order 0..d-1, as the kernel
    accumulates."""
    acc = p.select(dim, 0)
    for j in range(1, p.shape[dim]):
        acc = acc + p.select(dim, j)
    return acc


def _warpsum(p: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum over the coordinate axis ``dim`` as the warp-per-chain kernels
    accumulate: lane l adds its coordinates ``WARP_CPL l ..`` in order (a
    lane with none gives 0.0), then the butterfly over the 32 lanes."""
    from ..ops.scalarize import LANES, WARP_CPL, butterfly
    q = p.movedim(dim, -1)
    d = q.shape[-1]
    base = torch.arange(0, d, WARP_CPL, device=p.device)
    acc = q[..., base]
    for c in range(1, WARP_CPL):
        idx = base + c
        acc = torch.where(idx < d, acc + q[..., idx.clamp(max=d - 1)], acc)
    pad = acc.new_zeros(acc.shape[:-1] + (LANES - base.shape[0],))
    return butterfly(torch.cat([acc, pad], dim=-1))[..., 0]


# layout -> the sum over coordinates of the kernels with that layout
_SUMS = {"thread": _seqsum, "warp": _warpsum}


def run_ticks(vag: Callable, theta: torch.Tensor, eps, num_ticks: int,
              max_depth: int, inv_mass: torch.Tensor,
              divergence_threshold: float, draw: Callable, collect_idx,
              ckpt_bf16: bool = True, num_sample_slots: int = 0,
              track_positions: bool = False, layout: str = "thread"):
    """The one-leapfrog-per-tick FSM-NUTS loop on the ``(d, n)`` state
    ``theta``: every chain does exactly one leapfrog per tick, and the
    subtree/trajectory bookkeeping runs masked around it.

    ``vag(x (d, n)) -> (logp (n,), grad (d, n))``; ``draw(t)`` returns tick
    ``t``'s randomness ``(z (d, n), [u_dir0, u_take, u_bias, u_dir])``.
    ``eps`` is a float or one step size per chain ``(n,)``; ``inv_mass``
    ``(d, 1)`` or ``(d, n)``. ``num_sample_slots`` keeps the first B
    trajectory ends per chain, ``track_positions`` the Welford mean and
    variance of every leapfrog position (both only in ``nuts_fsm``; the
    kernel K6 has neither). ``layout`` orders every sum over coordinates as
    K6 in that layout does: ``"thread"`` 0..d-1, ``"warp"`` by lanes then
    the butterfly (:func:`gen_tpu_torch.ops.nuts_fused.kernel_layout`).
    Returns ``(final state dict, hist, hist_cnt)``
    with ``hist`` ``(ticks, n)`` (coordinate ``collect_idx``) or ``(ticks,
    d, n)`` (``None`` or ``"all"``); ``collect_idx=False`` collects
    nothing and returns ``None`` for both."""
    d, n = theta.shape
    dt, dev = theta.dtype, theta.device
    inv = inv_mass
    msc = sqrt_mass_safe(inv_mass)
    feps = torch.as_tensor(eps, dtype=dt, device=dev)
    ninf = torch.full((n,), -math.inf, dtype=dt, device=dev)
    zd = torch.zeros_like(theta)
    ckround = bf16_round if ckpt_bf16 else (lambda x: x)
    levels = max(max_depth - 1, 0)     # checkpoint levels 1..md-1
    _sum = _SUMS[layout]

    def dot_im(a, b):
        return _sum((inv * a) * b)

    def kinetic(r):
        return 0.5 * dot_im(r, r)

    def uturn(rho, ra, rb):
        return (dot_im(rho, ra) <= 0.0) | (dot_im(rho, rb) <= 0.0)

    def wd(c, a, b):
        return torch.where(c, a, b)

    lp0, g0 = vag(theta)
    i0 = torch.zeros(n, dtype=torch.int32, device=dev)
    f0 = torch.zeros(n, dtype=dt, device=dev)
    # d-vector state (the candidate planes double as cur_logp/cur_grad)
    cur_t, lt, lr, lg = theta, theta, zd, g0
    rt, rr, rg, rho_t = theta, zd, g0, zd
    ct, cg, ptv, pr, pg = theta, g0, theta, zd, g0
    rs, cs, csg = zd, theta, g0
    # checkpoint momenta r and rho sums of levels 1..md-1, stacked so that
    # every level's write and U-turn test is one tensor op
    ck_r = torch.zeros((levels, d, n), dtype=dt, device=dev)
    ck_s = torch.zeros((levels, d, n), dtype=dt, device=dev)
    lvl_mask = (torch.bitwise_left_shift(
        torch.ones(levels, dtype=torch.int32, device=dev),
        torch.arange(1, levels + 1, dtype=torch.int32, device=dev))
        - 1)[:, None]                  # 2^k - 1, k = 1..md-1
    count, energy0, clp, lwt, depth = i0, f0, lp0, f0, i0
    asum, nlf, de, sn, nl = f0, i0, f0 + feps, i0, i0 + 1
    cslp, lws = lp0, ninf
    acc_sum, depth_sum, div = f0, f0, i0
    fresh = torch.ones(n, dtype=torch.bool, device=dev)
    thr = -float(divergence_threshold)
    B = int(num_sample_slots)
    slots = torch.zeros((B, d, n), dtype=dt, device=dev)
    chain = torch.arange(n, device=dev)
    pos_n = torch.zeros((), dtype=dt, device=dev)
    pos_mean, pos_m2 = zd, zd
    hist, hist_cnt = [], []

    for t in range(num_ticks):
        z, (u_dir0, u_take, u_bias, u_dir) = draw(t)
        u_take = torch.clamp(u_take, min=_TINY)
        u_bias = torch.clamp(u_bias, min=_TINY)

        # -- trajectory init (masked): momentum refresh at the current
        # sample
        r0 = msc * z
        dir0 = torch.where(u_dir0 < 0.5, feps, -feps)
        energy0 = wd(fresh, clp - kinetic(r0), energy0)
        lt, lr, lg = wd(fresh, ct, lt), wd(fresh, r0, lr), wd(fresh, cg, lg)
        rt, rr, rg = wd(fresh, ct, rt), wd(fresh, r0, rr), wd(fresh, cg, rg)
        rho_t = wd(fresh, r0, rho_t)
        lwt, depth = wd(fresh, f0, lwt), wd(fresh, i0, depth)
        asum, nlf = wd(fresh, f0, asum), wd(fresh, i0, nlf)
        de, sn, nl = wd(fresh, dir0, de), wd(fresh, i0, sn), \
            wd(fresh, i0 + 1, nl)
        ptv, pr, pg = wd(fresh, ct, ptv), wd(fresh, r0, pr), \
            wd(fresh, cg, pg)
        rs, lws = wd(fresh, zd, rs), wd(fresh, ninf, lws)

        # -- ONE leapfrog (the only gradient work; never masked out) ------
        rs_pre = rs
        half = 0.5 * de
        r = pr + half * pg
        th = ptv + de * (inv * r)
        lp, g = vag(th)
        r = r + half * g
        # checkpoints: the block's first IN-BLOCK momentum (post-leapfrog)
        # and the pre-leapfrog subtree momentum sum, at every level whose
        # block starts here
        starts = ((sn & lvl_mask) == 0)[:, None, :]
        ck_r = wd(starts, ckround(r), ck_r)
        ck_s = wd(starts, ckround(rs_pre), ck_s)
        if track_positions:
            # Welford over every leapfrog position (the warmup's scales)
            pos_n = pos_n + 1.0
            dlt = th - pos_mean
            pos_mean = pos_mean + dlt / pos_n
            pos_m2 = pos_m2 + dlt * (th - pos_mean)

        delta = (lp - kinetic(r)) - energy0
        delta = torch.where(torch.isnan(delta), -math.inf, delta)
        dv = delta < thr
        asum = asum + torch.clamp(torch.exp(delta), max=1.0)
        nlf = nlf + 1
        # progressive multinomial candidate within the subtree
        lws = logaddexp(lws, delta)
        take = torch.log(u_take) < delta - lws
        cs, cslp, csg = wd(take, th, cs), wd(take, lp, cslp), \
            wd(take, g, csg)
        rs = rs + r
        # block-end U-turn checks inside the subtree, every level at once
        ends = ((sn + 1) & lvl_mask) == 0
        ib = inv * (rs - ck_s)
        turning = (_sum(ib * ck_r, 1) <= 0.0) | (_sum(ib * r, 1) <= 0.0)
        turning_sub = torch.any(ends & turning, dim=0)
        sub_done = (sn + 1 >= nl) | turning_sub | dv

        # ---- subtree merge into the tree (masked by sub_done) -----------
        ok = ~turning_sub & ~dv
        tk = sub_done & (torch.log(u_bias) < lws - lwt) & ok
        ct, clp, cg = wd(tk, cs, ct), wd(tk, cslp, clp), wd(tk, csg, cg)
        upd = sub_done & ok
        lwt = wd(upd, logaddexp(lwt, lws), lwt)
        right, left = upd & (de > 0), upd & ~(de > 0)
        rt, rr, rg = wd(right, th, rt), wd(right, r, rr), wd(right, g, rg)
        lt, lr, lg = wd(left, th, lt), wd(left, r, lr), wd(left, g, lg)
        rho_t = wd(upd, rho_t + rs, rho_t)
        traj_done = sub_done & (turning_sub | dv | (ok & uturn(rho_t, lr, rr))
                                | (depth + 1 >= max_depth))

        # ---- next subtree (trajectory continues) ------------------------
        start = sub_done & ~traj_done
        depth = depth + start.to(torch.int32)
        de = wd(start, torch.where(u_dir < 0.5, feps, -feps), de)
        gr = de > 0
        ptv = wd(start, wd(gr, rt, lt), th)
        pr = wd(start, wd(gr, rr, lr), r)
        pg = wd(start, wd(gr, rg, lg), g)
        sn = wd(sub_done, i0, sn + 1)
        nl = wd(start, torch.bitwise_left_shift(i0 + 1, depth), nl)
        rs = wd(start, zd, rs)
        lws = wd(start, ninf, lws)

        # ---- trajectory finish: emit the sample, re-init next tick -------
        cur_t = wd(traj_done, ct, cur_t)
        if B:
            # prefix buffer, not a ring: writes stop at B samples
            w = traj_done & (count < B)
            slots[count[w].long(), :, chain[w]] = ct[:, w].T
        count = count + traj_done.to(torch.int32)
        acc_sum = acc_sum + torch.where(
            traj_done, asum / torch.clamp(nlf, min=1).to(dt), 0.0)
        depth_sum = depth_sum + torch.where(traj_done,
                                            depth.to(dt) + 1.0, 0.0)
        div = div + (traj_done & dv).to(torch.int32)
        fresh = traj_done

        if collect_idx is not False:
            hist.append(cur_t if collect_idx is None or collect_idx == "all"
                        else cur_t[collect_idx])
            hist_cnt.append(count)

    state = dict(theta=cur_t, count=count, acc_sum=acc_sum,
                 depth_sum=depth_sum, div=div, asum=asum, nlf=nlf,
                 slots=slots.permute(2, 0, 1), pos_mean=pos_mean.T,
                 pos_var=(pos_m2 / torch.clamp(pos_n - 1.0, min=1.0)).T)
    if collect_idx is False:
        return state, None, None
    return state, torch.stack(hist), torch.stack(hist_cnt)


def run_pairs(vag: Callable, theta: torch.Tensor, eps: float,
              num_pairs: int, max_depth: int, inv_mass: torch.Tensor,
              divergence_threshold: float, draw: Callable, collect_idx,
              ckpt_bf16: bool = True, layout: str = "thread"):
    """The pair-scheduled FSM-NUTS loop on the ``(d, n)`` state ``theta``.

    ``vag(x (d, n)) -> (logp (n,), grad (d, n))``; ``draw(p)`` returns pair
    ``p``'s randomness ``(z (d, n), [u_dir0, u_take1, u_bias1, u_dir1,
    u_take2, u_bias2, u_dir2])``; ``layout`` orders the sums over
    coordinates as K3 in that layout does (see :func:`run_ticks`).
    Returns ``(final state dict, hist,
    hist_cnt)``; ``hist`` is ``(pairs, n)`` (coordinate ``collect_idx``)
    or ``(pairs, d, n)`` (``collect_idx`` None or ``"all"``)."""
    d, n = theta.shape
    dt, dev = theta.dtype, theta.device
    inv = inv_mass.reshape(d, 1)
    msc = sqrt_mass_safe(inv_mass).reshape(d, 1)
    feps = torch.tensor(eps, dtype=dt, device=dev)
    ninf = torch.full((n,), -math.inf, dtype=dt, device=dev)
    zd = torch.zeros_like(theta)
    ckround = bf16_round if ckpt_bf16 else (lambda x: x)
    levels = max(max_depth - 1, 0)     # checkpoint levels 1..md-1
    _sum = _SUMS[layout]

    def dot_im(a, b):
        return _sum((inv * a) * b)

    def kinetic(r):
        return 0.5 * dot_im(r, r)

    def uturn(rho, ra, rb):
        return (dot_im(rho, ra) <= 0.0) | (dot_im(rho, rb) <= 0.0)

    def wd(c, a, b):
        return torch.where(c, a, b)

    lp0, g0 = vag(theta)
    i0 = torch.zeros(n, dtype=torch.int32, device=dev)
    f0 = torch.zeros(n, dtype=dt, device=dev)
    # d-vector state (the candidate planes double as cur_logp/cur_grad)
    cur_t, lt, lr, lg = theta, theta, zd, g0
    rt, rr, rg, rho_t = theta, zd, g0, zd
    ct, cg, ptv, pr, pg = theta, g0, theta, zd, g0
    rs, cs, csg = zd, theta, g0
    ck_r = [zd] * levels               # checkpoint momenta r, level k
    ck_s = [zd] * levels               # checkpoint rho sums, level k
    # per-chain scalars
    count, energy0, clp, lwt, depth = i0, f0, lp0, f0, i0
    asum, nlf, de, sn, nl = f0, i0, f0 + feps, i0, i0 + 1
    cslp, lws = lp0, ninf
    acc_sum, depth_sum, div = f0, f0, i0
    fresh = torch.ones(n, dtype=torch.bool, device=dev)
    thr = -float(divergence_threshold)
    hist, hist_cnt = [], []

    for p in range(num_pairs):
        z, (u_dir0, u_take1, u_bias1, u_dir1, u_take2, u_bias2,
            u_dir2) = draw(p)
        u_take1, u_bias1, u_take2, u_bias2 = (
            torch.clamp(u, min=_TINY)
            for u in (u_take1, u_bias1, u_take2, u_bias2))

        # -- trajectory init (masked): momentum refresh at the current
        # sample
        r0 = msc * z
        dir0 = torch.where(u_dir0 < 0.5, feps, -feps)
        energy0 = wd(fresh, clp - kinetic(r0), energy0)
        lt, lr, lg = wd(fresh, ct, lt), wd(fresh, r0, lr), wd(fresh, cg, lg)
        rt, rr, rg = wd(fresh, ct, rt), wd(fresh, r0, rr), wd(fresh, cg, rg)
        rho_t = wd(fresh, r0, rho_t)
        lwt, depth = wd(fresh, f0, lwt), wd(fresh, i0, depth)
        asum, nlf = wd(fresh, f0, asum), wd(fresh, i0, nlf)
        de, sn, nl = wd(fresh, dir0, de), wd(fresh, i0, sn), \
            wd(fresh, i0 + 1, nl)
        ptv, pr, pg = wd(fresh, ct, ptv), wd(fresh, r0, pr), \
            wd(fresh, cg, pg)
        rs, lws = wd(fresh, zd, rs), wd(fresh, ninf, lws)

        # ============ slot 1 (sn even for every chain) ==================
        rs_pre = rs
        half = 0.5 * de
        r1 = pr + half * pg
        th1 = ptv + de * (inv * r1)
        lp1, g1 = vag(th1)
        r1 = r1 + half * g1
        # checkpoint writes: block starts live only at even positions
        r1c, rsc = ckround(r1), ckround(rs_pre)
        for k in range(1, max_depth):
            starts = (sn & (2 ** k - 1)) == 0
            ck_r[k - 1] = wd(starts, r1c, ck_r[k - 1])
            ck_s[k - 1] = wd(starts, rsc, ck_s[k - 1])
        delta1 = (lp1 - kinetic(r1)) - energy0
        delta1 = torch.where(torch.isnan(delta1), -math.inf, delta1)
        div1 = delta1 < thr
        asum = asum + torch.clamp(torch.exp(delta1), max=1.0)
        nlf = nlf + 1
        lws_1 = logaddexp(lws, delta1)
        take1 = torch.log(u_take1) < delta1 - lws_1
        cs, cslp, csg = wd(take1, th1, cs), wd(take1, lp1, cslp), \
            wd(take1, g1, csg)
        rs = rs + r1

        # mid-pair subtree end: the 1-leapfrog first subtree or divergence
        m1 = (nl == 1) | div1
        ok1 = ~div1
        tk = m1 & (torch.log(u_bias1) < lws_1 - lwt) & ok1
        ct, clp, cg = wd(tk, cs, ct), wd(tk, cslp, clp), wd(tk, csg, cg)
        upd1 = m1 & ok1
        lwt = wd(upd1, logaddexp(lwt, lws_1), lwt)
        right, left = upd1 & (de > 0), upd1 & ~(de > 0)
        rt, rr, rg = wd(right, th1, rt), wd(right, r1, rr), wd(right, g1, rg)
        lt, lr, lg = wd(left, th1, lt), wd(left, r1, lr), wd(left, g1, lg)
        rho_t = wd(upd1, rho_t + rs, rho_t)
        traj_done1 = m1 & (div1 | uturn(rho_t, lr, rr)
                           | (depth + 1 >= max_depth))
        start1 = m1 & ~traj_done1
        depth = depth + start1.to(torch.int32)
        de = wd(start1, torch.where(u_dir1 < 0.5, feps, -feps), de)
        gr = de > 0
        ptv = wd(start1, wd(gr, rt, lt), th1)
        pr = wd(start1, wd(gr, rr, lr), r1)
        pg = wd(start1, wd(gr, rg, lg), g1)
        sn = wd(m1, i0, sn + 1)
        nl = wd(start1, torch.bitwise_left_shift(i0 + 1, depth), nl)
        rs = wd(start1, zd, rs)
        lws = wd(start1, ninf, lws_1)
        cur_t = wd(traj_done1, ct, cur_t)
        count = count + traj_done1.to(torch.int32)
        acc_sum = acc_sum + torch.where(
            traj_done1, asum / torch.clamp(nlf, min=1).to(dt), 0.0)
        depth_sum = depth_sum + torch.where(traj_done1,
                                            depth.to(dt) + 1.0, 0.0)
        div = div + (traj_done1 & div1).to(torch.int32)
        # every slot-1 subtree-ender idles slot 2 (alignment invariant)
        act = ~m1

        # ============ slot 2 (masked by act) ============================
        half = 0.5 * de
        r2 = pr + half * pg
        th2 = ptv + de * (inv * r2)
        lp2, g2 = vag(th2)
        r2 = r2 + half * g2
        delta2 = (lp2 - kinetic(r2)) - energy0
        delta2 = torch.where(torch.isnan(delta2), -math.inf, delta2)
        div2 = act & (delta2 < thr)
        asum = asum + torch.where(act, torch.clamp(torch.exp(delta2),
                                                   max=1.0), 0.0)
        nlf = nlf + act.to(torch.int32)
        lws_2 = wd(act, logaddexp(lws, delta2), lws)
        take2 = act & (torch.log(u_take2) < delta2 - lws_2)
        cs, cslp, csg = wd(take2, th2, cs), wd(take2, lp2, cslp), \
            wd(take2, g2, csg)
        rs = wd(act, rs + r2, rs)
        # the pair-boundary U-turn section (sn odd for active chains)
        turning_sub = torch.zeros(n, dtype=torch.bool, device=dev)
        for k in range(1, max_depth):
            ends = act & (((sn + 1) & (2 ** k - 1)) == 0)
            block_rho = rs - ck_s[k - 1]
            turning_sub = turning_sub | (ends & uturn(block_rho,
                                                      ck_r[k - 1], r2))
        sub_done2 = act & ((sn + 1 >= nl) | turning_sub | div2)
        ok2 = ~turning_sub & ~div2
        tk = sub_done2 & (torch.log(u_bias2) < lws_2 - lwt) & ok2
        ct, clp, cg = wd(tk, cs, ct), wd(tk, cslp, clp), wd(tk, csg, cg)
        upd2 = sub_done2 & ok2
        lwt = wd(upd2, logaddexp(lwt, lws_2), lwt)
        right, left = upd2 & (de > 0), upd2 & ~(de > 0)
        rt, rr, rg = wd(right, th2, rt), wd(right, r2, rr), wd(right, g2, rg)
        lt, lr, lg = wd(left, th2, lt), wd(left, r2, lr), wd(left, g2, lg)
        rho_t = wd(upd2, rho_t + rs, rho_t)
        traj_done2 = sub_done2 & (turning_sub | div2
                                  | (ok2 & uturn(rho_t, lr, rr))
                                  | (depth + 1 >= max_depth))
        start2 = sub_done2 & ~traj_done2
        depth = depth + start2.to(torch.int32)
        de = wd(start2, torch.where(u_dir2 < 0.5, feps, -feps), de)
        gr = de > 0
        ptv = wd(start2, wd(gr, rt, lt), wd(act, th2, ptv))
        pr = wd(start2, wd(gr, rr, lr), wd(act, r2, pr))
        pg = wd(start2, wd(gr, rg, lg), wd(act, g2, pg))
        sn = wd(act, wd(sub_done2, i0, sn + 1), sn)
        nl = wd(start2, torch.bitwise_left_shift(i0 + 1, depth), nl)
        rs = wd(start2, zd, rs)
        lws = wd(start2, ninf, lws_2)
        cur_t = wd(traj_done2, ct, cur_t)
        count = count + traj_done2.to(torch.int32)
        acc_sum = acc_sum + torch.where(
            traj_done2, asum / torch.clamp(nlf, min=1).to(dt), 0.0)
        depth_sum = depth_sum + torch.where(traj_done2,
                                            depth.to(dt) + 1.0, 0.0)
        div = div + (traj_done2 & div2).to(torch.int32)
        fresh = traj_done1 | traj_done2

        hist.append(cur_t if collect_idx is None or collect_idx == "all"
                    else cur_t[collect_idx])
        hist_cnt.append(count)

    state = dict(theta=cur_t, count=count, acc_sum=acc_sum,
                 depth_sum=depth_sum, div=div, asum=asum, nlf=nlf)
    return state, torch.stack(hist), torch.stack(hist_cnt)


def summary_stats(count, acc_sum, depth_sum, div, asum, nlf):
    """gen_tpu's per-chain stats from the five accumulators: a chain with
    no completed trajectory reports its in-flight accept statistic."""
    cnt = torch.clamp(count, min=1).to(acc_sum.dtype)
    inflight = asum / torch.clamp(nlf.to(asum.dtype), min=1.0)
    mean_accept = torch.where(count > 0, acc_sum / cnt, inflight)
    return dict(mean_accept=mean_accept, mean_depth=depth_sum / cnt,
                num_divergent=div.to(torch.int32))


def key_draws(keys, d, dtype, n_u: int = 7, steps: int = 32):
    """``draw`` for :func:`run_pairs` (``n_u=7``) or :func:`run_ticks`
    (``n_u=4``) from one key per chain ``(n, 2)``: per step, each chain
    splits its key ``n_u + 2`` ways and draws ``z`` and the ``n_u``
    uniforms, as gen_tpu's ``nuts_fsm_paired`` and ``nuts_fsm`` do. The
    key chain is split step by step, the normals and uniforms of a block of
    up to ``steps`` steps are drawn in one batched pass (the same bits,
    far fewer kernel launches); ``draw(p)`` takes p = 0, 1, ... in
    order."""
    n = keys.shape[0]
    block = max(1, min(steps, 32, (1 << 20) // max(n, 1)))
    state = {"keys": keys, "start": 0, "z": None, "u": None}
    split = vmap(lambda k: random.split(k, n_u + 2))
    normal = vmap(lambda k: random.normal(k, (d,), dtype))
    uniform = vmap(lambda k: random.uniform(k, (), dtype))

    def refill(p):
        subs = []
        for _ in range(block):
            ks = split(state["keys"])
            state["keys"] = ks[:, 0]
            subs.append(ks[:, 1:])
        subs = torch.stack(subs)                  # (block, n, n_u + 1, 2)
        state["z"] = normal(subs[:, :, 0].reshape(-1, 2)).reshape(
            block, n, d)
        state["u"] = uniform(subs[:, :, 1:].reshape(-1, 2)).reshape(
            block, n, n_u)
        state["start"] = p

    def draw(p):
        if state["z"] is None or p - state["start"] >= block:
            refill(p)
        i = p - state["start"]
        return state["z"][i].T, list(state["u"][i].T)

    return draw


def injected_draws(injected_rng, n, d, dtype, device, n_u: int = 7):
    """``draw`` for :func:`run_pairs` (``n_u=7``) or :func:`run_ticks`
    (``n_u=4``) from gen_tpu's injected streams with a chain axis:
    ``z (steps, n, d)`` and ``n_u`` uniforms ``(steps, n)``."""
    if len(injected_rng) != n_u + 1:
        raise ValueError(
            f"injected_rng needs {n_u + 1} streams (z and {n_u} uniforms) "
            f"for the {'paired (K3)' if n_u == 7 else 'one-leapfrog (K6)'} "
            "schedule, "
            f"got {len(injected_rng)}")
    z_all, *us = (torch.as_tensor(x, dtype=dtype, device=device)
                  for x in injected_rng)
    z_all = z_all.reshape(-1, n, d).permute(0, 2, 1)
    us = [u.reshape(-1, n) for u in us]
    return lambda p: (z_all[p], [u[p] for u in us])


def _chain_inputs(value_and_grad, theta0, step_size, inv_mass_diag):
    """``vag`` on ``(d, n)`` states through ``torch.func.vmap``, the step
    size as a float or an ``(n,)`` tensor, and the inverse mass laid out
    ``(d, 1)`` (one for all chains) or ``(d, n)`` (one per chain)."""
    n, d = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    inv = (torch.ones(d, dtype=dt, device=dev) if inv_mass_diag is None
           else torch.as_tensor(inv_mass_diag, dtype=dt, device=dev))
    inv = inv.reshape(d, 1) if inv.dim() == 1 else inv.T
    eps = (torch.as_tensor(step_size, dtype=dt, device=dev)
           if isinstance(step_size, torch.Tensor) else float(step_size))
    vg = vmap(value_and_grad)

    def vag(x):
        lp, g = vg(x.T)
        return lp.to(dt), g.T.to(dt)

    return vag, eps, inv


def nuts_fsm(key, value_and_grad, theta0, step_size, num_ticks: int,
             max_depth: int = 10, inv_mass_diag=None,
             num_sample_slots: int = 256,
             divergence_threshold: float = 1000.0,
             injected_rng=None, collect_idx=None,
             ckpt_bf16: bool = False):
    """Run ``num_ticks`` global leapfrog ticks of FSM-NUTS on the ``(n, d)``
    chains ``theta0``: every chain does exactly one leapfrog per tick.
    ``value_and_grad`` maps a ``(d,)`` vector to ``(logp, grad)`` (it runs
    under ``torch.func.vmap``); ``key`` is ``(n, 2)``, one per chain, and
    is unused when ``injected_rng=(z (ticks, n, d), u_dir0, u_take, u_bias,
    u_dir each (ticks, n))`` is given. ``step_size`` is a float or ``(n,)``;
    ``inv_mass_diag`` ``(d,)`` or ``(n, d)``.

    Returns the :class:`FSMResult` (``slots`` holds each chain's first
    ``min(counts, num_sample_slots)`` trajectory ends in order; later ones
    are dropped, never wrapped). With ``collect_idx`` an int (or ``"all"``)
    it returns ``(FSMResult, (hist (ticks, n[, d]), hist_cnt (ticks,
    n)))``: the collected coordinate of each chain's current sample after
    every tick and its completed-trajectory count. ``ckpt_bf16`` rounds the
    U-turn checkpoints to bf16, the fused kernel's semantics."""
    n, d = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    vag, eps, inv = _chain_inputs(value_and_grad, theta0, step_size,
                                  inv_mass_diag)
    draw = (key_draws(key.to(dev), d, dt, 4, num_ticks)
            if injected_rng is None
            else injected_draws(injected_rng, n, d, dt, dev, 4))
    s, hist, hist_cnt = run_ticks(
        vag, theta0.T, eps, num_ticks, max_depth, inv, divergence_threshold,
        draw, False if collect_idx is None else collect_idx, ckpt_bf16,
        num_sample_slots, track_positions=True)
    stats = summary_stats(s["count"], s["acc_sum"], s["depth_sum"],
                          s["div"], s["asum"], s["nlf"])
    res = FSMResult(slots=s["slots"], counts=s["count"], theta=s["theta"].T,
                    mean_accept=stats["mean_accept"],
                    mean_depth=stats["mean_depth"],
                    num_divergent=stats["num_divergent"],
                    pos_mean=s["pos_mean"], pos_var=s["pos_var"])
    if collect_idx is None:
        return res
    if hist.dim() == 3:
        hist = hist.permute(0, 2, 1)
    return res, (hist, hist_cnt)


def nuts_fsm_paired(key, value_and_grad, theta0, step_size,
                    num_pairs: int, max_depth: int = 10,
                    inv_mass_diag=None,
                    divergence_threshold: float = 1000.0,
                    injected_rng=None, collect_idx=0,
                    ckpt_bf16: bool = True):
    """Pair-scheduled FSM-NUTS on the ``(n, d)`` chains ``theta0``: two
    leapfrogs per tick with subtree starts aligned to pair boundaries.
    ``value_and_grad`` maps a ``(d,)`` vector to ``(logp, grad)`` (it runs
    under ``torch.func.vmap``); ``key`` is ``(n, 2)``, one per chain, and
    is unused when ``injected_rng`` is given. Returns ``(FSMResult,
    (hist, hist_cnt))`` with per-PAIR streams: ``hist`` ``(pairs, n)``
    holds coordinate ``collect_idx`` of each chain's current sample (the
    whole ``(pairs, n, d)`` state for ``None`` or ``"all"``), ``hist_cnt``
    ``(pairs, n)`` the completed-trajectory count."""
    n, d = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    vag, eps, inv = _chain_inputs(value_and_grad, theta0, float(step_size),
                                  inv_mass_diag)
    draw = (key_draws(key.to(dev), d, dt, 7, num_pairs)
            if injected_rng is None
            else injected_draws(injected_rng, n, d, dt, dev))
    s, hist, hist_cnt = run_pairs(
        vag, theta0.T, eps, num_pairs, max_depth, inv,
        divergence_threshold, draw, collect_idx, ckpt_bf16)
    if hist.dim() == 3:
        hist = hist.permute(0, 2, 1)
    stats = summary_stats(s["count"], s["acc_sum"], s["depth_sum"],
                          s["div"], s["asum"], s["nlf"])
    zeros = torch.zeros((n, d), dtype=dt, device=dev)
    res = FSMResult(slots=torch.zeros((n, 0, d), dtype=dt, device=dev),
                    counts=s["count"], theta=s["theta"].T,
                    mean_accept=stats["mean_accept"],
                    mean_depth=stats["mean_depth"],
                    num_divergent=stats["num_divergent"],
                    pos_mean=zeros, pos_var=zeros)
    return res, (hist, hist_cnt)


def nuts_fsm_warmup_and_sample(key, value_and_grad, theta0,
                               num_warmup_ticks: int = 1024,
                               num_ticks: int = 2048,
                               warmup_chunks: int = 16,
                               max_depth: int = 10,
                               target_accept: float = 0.8,
                               adapt_mass: bool = True,
                               num_sample_slots: int = 256,
                               free_mask=None):
    """The FSM pipeline for the ``(n, d)`` chains ``theta0``, each chain on
    its own (gen_tpu vmaps a one-chain version; ``key`` is ``(n, 2)``):
    three stages, each a ``find_reasonable_step_size``, dual averaging over
    ``warmup_chunks // 2`` fixed-tick chunks (one update per chunk from its
    mean accept statistic) and, after the first two, a diagonal mass from
    the stage's position variance; then a sampling run at the adapted step
    size and mass. Returns ``(FSMResult, info)`` with per-chain
    ``step_size (n,)``, ``inv_mass_diag (n, d)`` and ``mean_accept``.

    ``free_mask``: optional ``(d,)`` 0/1; coordinates with 0 stay frozen
    (inverse mass 0) through the warmup and the mass adaptation."""
    from .nuts import da_init, da_update, find_reasonable_step_size

    n, d = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    mask = (torch.ones(d, dtype=dt, device=dev) if free_mask is None
            else torch.as_tensor(free_mask, dtype=dt, device=dev))
    ks = vmap(lambda k: random.split(k, 3))(key.to(dev))
    k_find1, k_w1, k_samp = ks[:, 0], ks[:, 1], ks[:, 2]
    half = max(warmup_chunks // 2, 1)
    chunk_ticks = max(num_warmup_ticks // (3 * half), 1)
    B = num_sample_slots

    def da_stage(k_stage, theta_in, eps0, inv_mass):
        """Chunked dual averaging at fixed mass: final theta, adapted eps
        and the mean position variance of the later chunks."""
        theta, da, pos_vars = theta_in, da_init(eps0), []
        for k in vmap(lambda kk: random.split(kk, half))(k_stage).unbind(1):
            res = nuts_fsm(k, value_and_grad, theta, torch.exp(da.log_eps),
                           chunk_ticks, max_depth=max_depth,
                           inv_mass_diag=inv_mass, num_sample_slots=B)
            da = da_update(da, res.mean_accept, target_accept)
            theta = res.theta
            pos_vars.append(res.pos_var)
        var = torch.stack(pos_vars[half // 2:]).mean(dim=0)
        return theta, torch.exp(da.log_eps_bar), var

    theta = theta0
    inv_mass = mask.expand(n, d)
    eps_final = None
    for stage in range(3):
        k_find = vmap(lambda k: random.fold_in(k, stage))(k_find1)
        k_stage = vmap(lambda k: random.fold_in(k, stage))(k_w1)
        eps0 = find_reasonable_step_size(k_find, value_and_grad, theta,
                                         inv_mass)
        theta, eps_final, var = da_stage(k_stage, theta, eps0, inv_mass)
        if stage < 2 and adapt_mass:
            # frozen coordinates stay frozen (the 1e-8 floor would
            # unfreeze them)
            inv_mass = mask * torch.clamp(var, min=1e-8)

    res = nuts_fsm(k_samp, value_and_grad, theta, eps_final, num_ticks,
                   max_depth=max_depth, inv_mass_diag=inv_mass,
                   num_sample_slots=num_sample_slots)
    info = dict(step_size=eps_final, inv_mass_diag=inv_mass,
                mean_accept=res.mean_accept)
    return res, info
