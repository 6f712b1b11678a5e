"""No-U-Turn Sampler with dual-averaging step-size adaptation.

Counterpart: ``gen_tpu/inference/nuts.py``: the iterative multinomial NUTS
(Hoffman & Gelman 2014; progressive multinomial sampling, Betancourt 2017;
power-of-two checkpoint U-turn checks, Phan et al. 2019), including the
in-block boundary-momentum rule for the checkpoints.

Where PyTorch forced differences:

- gen_tpu writes one chain with ``lax.while_loop`` and vmaps it. Here the
  chains are a batch dimension written out: ``theta0`` is ``(n, d)`` with
  one key per chain ``(n, 2)``, and the loops run in lockstep while any
  chain is active. Each chain's state is updated only while its own loop
  condition holds, which is what a vmapped ``while_loop`` does, so under
  the same keys the result equals gen_tpu's vmapped transition. A single
  ``(d,)`` chain with a ``(2,)`` key is a batch of one.
- ``value_and_grad`` maps a ``(d,)`` vector to ``(logp, grad)``, as in
  gen_tpu; it is evaluated on the batch with ``torch.func.vmap``.
- Per-chain key splits run under ``torch.func.vmap`` of
  :mod:`gen_tpu_torch.random`, which reproduces ``jax.random`` bit for bit
  on bits and uniforms.
- ``logaddexp`` is written out as ``jnp.logaddexp`` computes it
  (:func:`logaddexp`), so that the fused kernel, its twin and this module
  evaluate the same formula.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from .. import random
from ..selection import Selection
from ..utils import sqrt_mass_safe
from .target import FlatTarget


class NUTSStats(NamedTuple):
    accept_prob: torch.Tensor   # mean MH accept statistic (dual averaging)
    num_leapfrogs: torch.Tensor
    depth: torch.Tensor
    diverging: torch.Tensor


def logaddexp(a, b):
    """``log(exp(a) + exp(b))`` as ``jnp.logaddexp`` computes it:
    ``max(a, b) + log1p(exp(-|a - b|))``, and ``a + b`` where ``a - b`` is
    NaN (both infinite with one sign, or a NaN input)."""
    d = a - b
    return torch.where(torch.isnan(d), a + b,
                       torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(d))))


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _uturn(rho, r_a, r_b, inv_mass):
    va = inv_mass * r_a
    vb = inv_mass * r_b
    return (_dot(rho, va) <= 0) | (_dot(rho, vb) <= 0)


def _wh(c, a, b):
    """``where`` with a per-chain condition ``(n,)`` broadcast over any
    trailing dimensions of ``a`` and ``b``."""
    c = c.reshape(c.shape + (1,) * (max(a.dim(), b.dim()) - 1))
    return torch.where(c, a, b)


def _split(keys, num):
    return vmap(lambda k: random.split(k, num))(keys)


def _uniform(keys, dtype):
    return vmap(lambda k: random.uniform(k, (), dtype))(keys)


def nuts_flat(key, value_and_grad, theta0, step_size, max_depth=10,
              inv_mass_diag=None, divergence_threshold=1000.0):
    """One NUTS transition of each chain. ``theta0`` is ``(n, d)`` with
    ``key`` ``(n, 2)`` (one key per chain), or a single ``(d,)`` chain with
    a ``(2,)`` key. Returns ``(theta, NUTSStats)`` with the chain axis
    kept as given."""
    single = theta0.dim() == 1
    if single:
        theta0, key = theta0[None], key[None]
    n, dim = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    fdt = torch.get_default_dtype()        # JAX's default float
    key = key.to(dev)
    inv_mass = (torch.ones(dim, dtype=dt, device=dev) if inv_mass_diag is None
                else torch.as_tensor(inv_mass_diag, dtype=dt, device=dev))
    sqrt_mass = sqrt_mass_safe(inv_mass)
    vg = vmap(value_and_grad)

    def kinetic(r):
        return 0.5 * _dot(r, inv_mass * r)

    logp0, grad0 = vg(theta0)
    ks = _split(key, 2)
    k_mom, k_loop = ks[:, 0], ks[:, 1]
    r0 = sqrt_mass * vmap(lambda k: random.normal(k, (dim,), dt))(k_mom)
    energy0 = logp0 - kinetic(r0)

    def leapfrog(theta, r, grad, eps):
        eps = eps[:, None]
        r = r + 0.5 * eps * grad
        theta = theta + eps * (inv_mass * r)
        logp, grad = vg(theta)
        r = r + 0.5 * eps * grad
        return theta, r, grad, logp

    false = torch.zeros(n, dtype=torch.bool, device=dev)
    zero_i = torch.zeros(n, dtype=torch.int64, device=dev)

    def build_subtree(k_sub, theta, r, grad, eps_signed, num_leaves, live):
        """Integrate ``num_leaves`` leapfrogs from (theta, r, grad), checking
        the power-of-two block U-turns; ``live`` masks chains whose outer
        loop has stopped (their result is discarded)."""
        s = dict(n=zero_i, theta=theta, r=r, grad=grad,
                 rho=torch.zeros_like(theta), cand_theta=theta,
                 logw=torch.full((n,), -math.inf, dtype=dt, device=dev),
                 turning=false, diverging=false,
                 alpha=torch.zeros(n, dtype=dt, device=dev),
                 r_ckpt=torch.zeros((n, max_depth + 1, dim), dtype=dt,
                                    device=dev),
                 rsum_ckpt=torch.zeros((n, max_depth + 1, dim), dtype=dt,
                                       device=dev),
                 key=k_sub)
        while True:
            active = live & (s["n"] < num_leaves) & ~s["turning"] \
                & ~s["diverging"]
            if not bool(active.any()):
                return s
            nn = s["n"]
            r_ck, rs_ck = s["r_ckpt"].clone(), s["rsum_ckpt"].clone()
            for k in range(1, max_depth + 1):
                starts = (nn % (2 ** k)) == 0
                rs_ck[:, k] = _wh(starts, s["rho"], rs_ck[:, k])
            theta, r, grad, logp = leapfrog(s["theta"], s["r"], s["grad"],
                                            eps_signed)
            # momentum checkpoint: the block's first IN-BLOCK state (after
            # this leapfrog); the pre-block momentum makes the stopping rule
            # asymmetric under reversal and biases the sampler
            for k in range(1, max_depth + 1):
                starts = (nn % (2 ** k)) == 0
                r_ck[:, k] = _wh(starts, r, r_ck[:, k])
            energy = logp - kinetic(r)
            delta = energy - energy0
            delta = torch.where(torch.isnan(delta), -math.inf, delta)
            diverging = delta < -divergence_threshold
            alpha = s["alpha"] + torch.clamp(torch.exp(delta), max=1.0)
            logw_new = logaddexp(s["logw"], delta)
            ks = _split(s["key"], 2)
            key_next, k_take = ks[:, 0], ks[:, 1]
            take = torch.log(_uniform(k_take, fdt)) < delta - logw_new
            cand_theta = _wh(take, theta, s["cand_theta"])
            rho = s["rho"] + r
            turning = s["turning"]
            for k in range(1, max_depth + 1):
                ends = ((nn + 1) % (2 ** k)) == 0
                block_rho = rho - rs_ck[:, k]
                turning = turning | (ends & _uturn(block_rho, r_ck[:, k], r,
                                                   inv_mass))
            new = dict(n=nn + 1, theta=theta, r=r, grad=grad, rho=rho,
                       cand_theta=cand_theta, logw=logw_new,
                       turning=turning, diverging=diverging, alpha=alpha,
                       r_ckpt=r_ck, rsum_ckpt=rs_ck, key=key_next)
            s = {k: _wh(active, new[k], s[k]) for k in s}

    s = dict(theta_left=theta0, r_left=r0, grad_left=grad0,
             theta_right=theta0, r_right=r0, grad_right=grad0,
             rho=r0, cand_theta=theta0,
             logw=torch.zeros(n, dtype=dt, device=dev),
             depth=zero_i, turning=false, diverging=false,
             alpha_sum=torch.zeros(n, dtype=dt, device=dev),
             n_leapfrog=zero_i, key=k_loop)
    while True:
        active = (s["depth"] < max_depth) & ~s["turning"] & ~s["diverging"]
        if not bool(active.any()):
            break
        ks = _split(s["key"], 4)
        key_next, k_dir, k_sub, k_acc = ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]
        go_right = vmap(lambda k: random.bernoulli(k, 0.5, (), fdt))(k_dir)
        num_leaves = 2 ** s["depth"]
        start = [_wh(go_right, s[f"{v}_right"], s[f"{v}_left"])
                 for v in ("theta", "r", "grad")]
        eps_signed = torch.where(go_right, step_size, -step_size).to(dt)
        sub = build_subtree(k_sub, *start, eps_signed, num_leaves, active)
        ok = ~sub["turning"] & ~sub["diverging"]
        # biased progressive sampling between tree and subtree
        take = (torch.log(_uniform(k_acc, fdt)) < sub["logw"] - s["logw"]) \
            & ok
        new = dict(s)
        new["cand_theta"] = _wh(take, sub["cand_theta"], s["cand_theta"])
        new["logw"] = torch.where(ok, logaddexp(s["logw"], sub["logw"]),
                                  s["logw"])
        for v, sv in (("theta", "theta"), ("r", "r"), ("grad", "grad")):
            upd = _wh(ok, sub[sv], s[f"{v}_right"])
            new[f"{v}_right"] = _wh(go_right, upd, s[f"{v}_right"])
            upd = _wh(ok, sub[sv], s[f"{v}_left"])
            new[f"{v}_left"] = _wh(go_right, s[f"{v}_left"], upd)
        new["rho"] = _wh(ok, s["rho"] + sub["rho"], s["rho"])
        turning_total = _uturn(new["rho"], new["r_left"], new["r_right"],
                               inv_mass)
        new["turning"] = sub["turning"] | (ok & turning_total)
        new["depth"] = s["depth"] + 1
        new["diverging"] = s["diverging"] | sub["diverging"]
        new["alpha_sum"] = s["alpha_sum"] + sub["alpha"]
        new["n_leapfrog"] = s["n_leapfrog"] + sub["n"]
        new["key"] = key_next
        s = {k: _wh(active, new[k], s[k]) for k in s}

    nlf = torch.clamp(s["n_leapfrog"], min=1)
    stats = NUTSStats(accept_prob=s["alpha_sum"] / nlf,
                      num_leapfrogs=s["n_leapfrog"], depth=s["depth"],
                      diverging=s["diverging"])
    if single:
        return s["cand_theta"][0], NUTSStats(*(x[0] for x in stats))
    return s["cand_theta"], stats


def nuts(key, trace, selection: Selection, step_size, max_depth=10,
         inv_mass_diag=None):
    """One NUTS update on a trace's selected choices. Returns
    ``(new_trace, stats)``."""
    target = FlatTarget(trace, selection)
    theta, stats = nuts_flat(key, target.value_and_grad, target.flat0,
                             step_size, max_depth, inv_mass_diag)
    return target.rebuild(theta), stats


# -- dual averaging (Hoffman & Gelman 2014, §3.2) -------------------------


class DAState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def da_init(eps0):
    """Dual-averaging state at step size ``eps0``, in the default float
    dtype (JAX's ``result_type(float)``), on ``eps0``'s device."""
    eps0 = torch.as_tensor(eps0)
    eps0 = eps0.to(torch.get_default_dtype())
    z = torch.zeros((), dtype=eps0.dtype, device=eps0.device)
    return DAState(torch.log(eps0), z, z, z + 1.0, torch.log(10.0 * eps0))


def da_update(state: DAState, accept_prob, target_accept=0.8, gamma=0.05,
              t0=10.0, kappa=0.75):
    t = state.t
    h_bar = ((1.0 - 1.0 / (t + t0)) * state.h_bar
             + (target_accept - accept_prob) / (t + t0))
    log_eps = state.mu - torch.sqrt(t) / gamma * h_bar
    w = t ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * state.log_eps_bar
    return DAState(log_eps, log_eps_bar, h_bar, t + 1.0, state.mu)


def find_reasonable_step_size(key, value_and_grad, theta0, inv_mass=None):
    """Heuristic of Hoffman & Gelman algorithm 4 for a ``(d,)`` chain (or a
    batch ``(n, d)`` with keys ``(n, 2)``, each chain on its own)."""
    single = theta0.dim() == 1
    if single:
        theta0, key = theta0[None], key[None]
    n, dim = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    inv_mass = (torch.ones(dim, dtype=dt, device=dev) if inv_mass is None
                else torch.as_tensor(inv_mass, dtype=dt, device=dev))
    vg = vmap(value_and_grad)
    logp0, grad0 = vg(theta0)
    r0 = sqrt_mass_safe(inv_mass) * vmap(
        lambda k: random.normal(k, (dim,), dt))(key.to(dev))
    h0 = logp0 - 0.5 * _dot(r0, inv_mass * r0)
    log_half = math.log(0.5)

    def h_after(eps):
        e = eps[:, None]
        r = r0 + 0.5 * e * grad0
        theta = theta0 + e * inv_mass * r
        logp, grad = vg(theta)
        r = r + 0.5 * e * grad
        h = logp - 0.5 * _dot(r, inv_mass * r)
        return torch.where(torch.isnan(h), -math.inf, h)

    eps = torch.ones(n, dtype=dt, device=dev)
    delta0 = h_after(eps) - h0
    direction = torch.where(delta0 > log_half, 1.0, -1.0).to(dt)
    it = torch.zeros(n, dtype=torch.int64, device=dev)
    while True:
        delta = h_after(eps) - h0
        keep = torch.where(direction > 0, delta > log_half,
                           delta < log_half) & (it < 50)
        if not bool(keep.any()):
            break
        eps = torch.where(keep, eps * (2.0 ** direction), eps)
        it = it + keep.to(it.dtype)
    return eps[0] if single else eps


def nuts_warmup_and_sample(key, trace, selection: Selection, num_warmup=500,
                           num_samples=1000, max_depth=10, target_accept=0.8,
                           adapt_mass=True):
    """Single-chain pipeline: dual-averaging warmup (+ diagonal mass from
    the second half of warmup), then sampling. Returns ``(samples_flat
    (num_samples, d), final_trace, info)``. A Python loop over transitions
    where gen_tpu scans.

    A batch of chains, as gen_tpu's call vmapped over ``(key, trace)``:
    ``trace`` with a leading chain axis (a vmapped ``generate``) and ``key``
    ``(n, 2)``. Every chain runs its own pipeline (its own step size and
    mass); returns ``(samples (n, num_samples, d), final traces with a
    chain axis, info)`` with one info entry per chain."""
    batched = key.dim() == 2
    if batched:
        target = FlatTarget(pytree.tree_map(lambda x: x[0], trace),
                            selection)
        theta = vmap(lambda tr: tr.get_choices().filter(selection)
                     .to_array())(trace)
    else:
        target = FlatTarget(trace, selection)
        theta, key = target.flat0[None], key[None]
    n, dim = theta.shape
    dt, dev = theta.dtype, theta.device
    ks = _split(key.to(dev), 3)
    k_find, k_warm, k_samp = ks[:, 0], ks[:, 1], ks[:, 2]
    eps0 = find_reasonable_step_size(k_find, target.value_and_grad, theta)
    da = da_init(eps0)
    mean = torch.zeros((n, dim), dtype=dt, device=dev)
    m2 = torch.zeros((n, dim), dtype=dt, device=dev)
    count = torch.zeros((n,), dtype=dt, device=dev)
    warm_keys = _split(k_warm, num_warmup)
    for m in range(num_warmup):
        theta, stats = nuts_flat(warm_keys[:, m], target.value_and_grad,
                                 theta, torch.exp(da.log_eps), max_depth)
        da = da_update(da, stats.accept_prob, target_accept)
        # Welford on the second half of warmup
        active = (da.t > (num_warmup // 2)).expand(n)[:, None]
        count = count + torch.where(active[:, 0], 1.0, 0.0)
        delta = theta - mean
        mean2 = mean + torch.where(
            active, delta / torch.clamp(count, min=1.0)[:, None], 0.0)
        m2 = m2 + torch.where(active, delta * (theta - mean2), 0.0)
        mean = mean2
    eps_final = torch.exp(da.log_eps_bar)
    var = m2 / torch.clamp(count - 1.0, min=1.0)[:, None]
    inv_mass = torch.where(torch.as_tensor(adapt_mass) & (count > 2)[:, None],
                           torch.clamp(var, min=1e-6),
                           torch.ones((n, dim), dtype=dt, device=dev))
    samples, accepts, leapfrogs = [], [], []
    samp_keys = _split(k_samp, num_samples)
    for s in range(num_samples):
        theta, stats = nuts_flat(samp_keys[:, s], target.value_and_grad,
                                 theta, eps_final, max_depth, inv_mass)
        samples.append(theta)
        accepts.append(stats.accept_prob)
        leapfrogs.append(stats.num_leapfrogs)
    info = dict(step_size=eps_final, inv_mass_diag=inv_mass,
                mean_accept=torch.stack(accepts).mean(dim=0),
                total_leapfrogs=torch.stack(leapfrogs).sum(dim=0))
    samples = torch.stack(samples, dim=1)
    if batched:
        return samples, vmap(target.rebuild)(theta), info
    return (samples[0], target.rebuild(theta[0]),
            {k: v[0] for k, v in info.items()})
