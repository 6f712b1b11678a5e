"""Finite-state-machine NUTS, pair-scheduled: the fused kernel's twin.

Counterpart: ``gen_tpu/inference/nuts_fsm.py``. Ported: ``FSMResult`` and
``nuts_fsm_paired``, the pair-scheduled FSM-NUTS (two leapfrogs per tick,
subtree starts aligned to pair boundaries, so checkpoint writes happen only
in slot 1 and the per-level U-turn end tests only in slot 2). The
per-trajectory semantics are gen_tpu's: iterative multinomial NUTS,
progressive candidates, biased merging, power-of-two checkpoints with the
in-block boundary-momentum rule, divergence threshold, and bf16-rounded
checkpoints (``ckpt_bf16``). ``nuts_fsm`` (one leapfrog per tick) and
``nuts_fsm_warmup_and_sample`` wait for the one-leapfrog kernel (K6).

Where PyTorch forced differences:

- The chains are a batch dimension written out: ``theta0`` is ``(n, d)``
  and ``key`` ``(n, 2)`` (one key per chain, as under gen_tpu's vmap);
  ``injected_rng`` takes gen_tpu's 8-stream layout with a chain axis,
  ``z (pairs, n, d)`` and ``u_dir0, u_take1, u_bias1, u_dir1, u_take2,
  u_bias2, u_dir2`` each ``(pairs, n)``. The streams come back step-major,
  ``(pairs, n[, d])``.
- The loop itself, :func:`run_pairs`, keeps the state in the fused
  kernel's layout ``(d, n)`` and does the kernel's arithmetic in the
  kernel's order: sums over coordinates run 0..d-1, ``logaddexp`` is
  written out, and the take/bias uniforms are clamped to FLT_MIN before
  their log, so with the staged program as ``vag`` it is the kernel's
  plain version (:func:`gen_tpu_torch.ops.nuts_fused.
  nuts_chains_fused_plain`).
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
    slots: torch.Tensor         # (0, n, dim): the paired engine keeps none
    counts: torch.Tensor        # (n,) int32, completed trajectories
    theta: torch.Tensor         # (n, dim) final current sample
    mean_accept: torch.Tensor   # mean accept-stat over completed trajectories
    mean_depth: torch.Tensor
    num_divergent: torch.Tensor
    pos_mean: torch.Tensor      # (n, dim); zeros in the paired engine
    pos_var: torch.Tensor


def _seqsum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (coordinate) axis in order 0..d-1, as the
    kernel accumulates."""
    acc = p[0]
    for j in range(1, p.shape[0]):
        acc = acc + p[j]
    return acc


def run_pairs(vag: Callable, theta: torch.Tensor, eps: float,
              num_pairs: int, max_depth: int, inv_mass: torch.Tensor,
              divergence_threshold: float, draw: Callable, collect_idx,
              ckpt_bf16: bool = True):
    """The pair-scheduled FSM-NUTS loop on the ``(d, n)`` state ``theta``.

    ``vag(x (d, n)) -> (logp (n,), grad (d, n))``; ``draw(p)`` returns pair
    ``p``'s randomness ``(z (d, n), [u_dir0, u_take1, u_bias1, u_dir1,
    u_take2, u_bias2, u_dir2])``. Returns ``(final state dict, hist,
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

    def dot_im(a, b):
        return _seqsum((inv * a) * b)

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


def key_draws(keys, d, dtype):
    """``draw`` for :func:`run_pairs` from one key per chain ``(n, 2)``: per
    pair, each chain splits its key 9 ways and draws ``z`` and the seven
    uniforms as gen_tpu's ``nuts_fsm_paired`` does."""
    state = {"keys": keys}

    def one(k):
        ks = random.split(k, 9)
        z = random.normal(ks[1], (d,), dtype)
        us = torch.stack([random.uniform(ks[i], (), dtype)
                          for i in range(2, 9)])
        return ks[0], z, us

    def draw(p):
        state["keys"], z, us = vmap(one)(state["keys"])
        return z.T, list(us.T)

    return draw


def injected_draws(injected_rng, n, d, dtype, device):
    """``draw`` for :func:`run_pairs` from gen_tpu's 8 injected streams
    with a chain axis: ``z (pairs, n, d)`` and 7 ``(pairs, n)``."""
    if len(injected_rng) != 8:
        raise ValueError(f"injected_rng needs 8 streams (z and 7 uniforms)"
                         f" for the paired engine, got {len(injected_rng)}")
    z_all, *us = (torch.as_tensor(x, dtype=dtype, device=device)
                  for x in injected_rng)
    z_all = z_all.reshape(-1, n, d).permute(0, 2, 1)
    us = [u.reshape(-1, n) for u in us]
    return lambda p: (z_all[p], [u[p] for u in us])


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
    inv_mass = (torch.ones(d, dtype=dt, device=dev) if inv_mass_diag is None
                else torch.as_tensor(inv_mass_diag, dtype=dt, device=dev))
    vg = vmap(value_and_grad)

    def vag(x):
        lp, g = vg(x.T)
        return lp.to(dt), g.T.to(dt)

    draw = (key_draws(key.to(dev), d, dt) if injected_rng is None
            else injected_draws(injected_rng, n, d, dt, dev))
    s, hist, hist_cnt = run_pairs(
        vag, theta0.T, float(step_size), num_pairs, max_depth, inv_mass,
        divergence_threshold, draw, collect_idx, ckpt_bf16)
    if hist.dim() == 3:
        hist = hist.permute(0, 2, 1)
    stats = summary_stats(s["count"], s["acc_sum"], s["depth_sum"],
                          s["div"], s["asum"], s["nlf"])
    zeros = torch.zeros((n, d), dtype=dt, device=dev)
    res = FSMResult(slots=torch.zeros((0, n, d), dtype=dt, device=dev),
                    counts=s["count"], theta=s["theta"].T,
                    mean_accept=stats["mean_accept"],
                    mean_depth=stats["mean_depth"],
                    num_divergent=stats["num_divergent"],
                    pos_mean=zeros, pos_var=zeros)
    return res, (hist, hist_cnt)
