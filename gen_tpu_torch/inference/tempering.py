"""Tempering methods: AIS, SMC samplers, parallel tempering.

Counterpart: ``gen_tpu/inference/tempering.py``. Every method works on

    log p_beta(v) = log prior(v) + beta * log lik(v)

over the selected latents of a trace whose other choices (the
observations) stay fixed: ``rebuild(v)`` (one key-free, fully constrained
``update``), then ``prior = project(trace, latent_selection)`` and ``lik =
score - prior``. The particles start at beta = 0 from ``generate`` with
the observations as constraints.

* :func:`ais`: annealed importance sampling with tempered-HMC moves.
* :func:`smc_sampler`: AIS with ESS-triggered resampling between rungs.
* :func:`smc_sampler_adaptive`: each stage bisects the next beta so that
  the incremental weights' ESS hits a target, then resamples and moves.
* :func:`parallel_tempering`: replica exchange with even/odd swap passes.

Where PyTorch forces a difference: the ``lax.scan`` over rungs and sweeps
and the leapfrog's ``lax.scan`` are Python loops; ``lax.cond`` (resample
or keep) is a host branch on one ``.item()`` a rung; the adaptive
sampler's ``lax.while_loop`` over stages reads beta once a stage on the
host and takes exactly gen_tpu's stages, while its 50 bisection steps stay
on the device. Gradients come from ``torch.func.grad_and_value``.
Resampling goes through the particle filter's ``_resample_parents``:
``"systematic"``, the default, launches kernel K4 for a CUDA tensor.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.func import grad_and_value, vmap

from .. import random
from ..gfi import Trace
from ..selection import Selection
from ..utils import logsumexp
from .particle_filter import _resample_parents
from .target import FlatTarget


class TemperedTarget:
    """``logprior(flat)`` / ``loglik(flat)`` over the selected latents of a
    trace whose remaining choices (the observations) are held fixed."""

    def __init__(self, trace: Trace, selection: Selection):
        self._flat = FlatTarget(trace, selection)
        self._selection = selection
        self.dim = self._flat.dim
        self.flat0 = self._flat.flat0

        def prior_lik(flat):
            tr = self._flat.rebuild(flat)
            prior = tr.project(selection)
            return prior, tr.get_score() - prior

        self.prior_lik = prior_lik

    def logp_at(self, beta):
        def logp(flat):
            prior, lik = self.prior_lik(flat)
            return prior + beta * lik
        return logp

    def rebuild(self, flat):
        return self._flat.rebuild(flat)

    def lik(self, flats):
        """log lik of each row of ``flats`` (vmapped)."""
        return vmap(lambda f: self.prior_lik(f)[1])(flats)


def _hmc_draws(key, shape, dtype):
    """A trajectory's randomness: the momentum and the log of the accept
    test's uniform."""
    k_mom, k_acc = random.split(key)
    return (random.normal(k_mom, shape, dtype),
            torch.log(random.uniform(k_acc, (), torch.get_default_dtype())))


def _hmc_trajectory(flat, p0, log_u, target: TemperedTarget, beta, L: int,
                    eps):
    """One MH-corrected leapfrog trajectory on log p_beta from momentum
    ``p0``, accepted where ``log_u`` < log alpha. Returns (new_flat,
    accepted)."""
    gv = grad_and_value(target.logp_at(beta))
    g, lp0 = gv(flat)
    q, p, lp = flat, p0, lp0
    for _ in range(L):
        p = p + 0.5 * eps * g
        q = q + eps * p
        g, lp = gv(q)
        p = p + 0.5 * eps * g
    log_alpha = ((lp - 0.5 * torch.sum(p * p))
                 - (lp0 - 0.5 * torch.sum(p0 * p0)))
    accept = log_u < log_alpha
    return torch.where(accept, q, flat), accept


def _tempered_hmc_step(key, flat, target: TemperedTarget, beta,
                       L: int, eps):
    """One MH-corrected leapfrog trajectory on log p_beta. Returns
    (new_flat, accepted)."""
    p0, log_u = _hmc_draws(key, tuple(flat.shape), flat.dtype)
    return _hmc_trajectory(flat, p0, log_u, target, beta, L, eps)


def _moves(keys, flats, target, beta, L, eps):
    """One tempered-HMC move of every particle, a key each (vmapped)."""
    return vmap(lambda f, k: _tempered_hmc_step(k, f, target, beta, L,
                                                eps)[0])(flats, keys)


def _init_particles(key, trace: Trace, selection: Selection, n: int):
    """Latents from the prior + their log-likelihoods, via ``generate``
    with the trace's non-selected choices (the observations) as
    constraints."""
    gen_fn = trace.get_gen_fn()
    args = trace.get_args()
    obs = trace.get_choices().filter(selection.complement())

    def one(k):
        tr, w = gen_fn.generate(k, args, obs)
        flat = tr.get_choices().filter(selection).to_array()
        return flat, w

    return vmap(one)(random.split(key, n))


def _fold_in_keys(key, i: int, n: int):
    """Per-particle keys of move i: ``fold_in(fold_in(key, i), j)``."""
    return random.fold_in(random.fold_in(key, i),
                          torch.arange(n, device=key.device))


def ais(key, trace: Trace, selection: Selection, betas,
        n_particles: int, L: int = 10, eps: float = 0.1,
        moves_per_rung: int = 1):
    """Annealed importance sampling from the prior to the posterior of the
    selected latents.

    ``betas``: increasing ladder, each entry a rung AFTER the prior stage
    (the last must be 1.0 for a posterior/evidence estimate).

    Returns ``(flats, log_weights, log_ml)``: particle latents (N, dim) at
    beta = betas[-1], their AIS weights, and the log-marginal-likelihood
    estimate ``logsumexp(log_weights) - log N``.
    """
    dev = key.device
    betas = torch.as_tensor(betas, device=dev)
    k_init, k_scan = random.split(key)
    flats, _ = _init_particles(k_init, trace, selection, n_particles)
    target = TemperedTarget(trace, selection)
    log_w = torch.zeros(n_particles, device=dev)
    beta_prev = torch.zeros((), dtype=betas.dtype, device=dev)
    keys = random.split(k_scan, betas.shape[0])
    for beta, k in zip(betas, keys):
        # incremental weight at the CURRENT positions
        log_w = log_w + (beta - beta_prev) * target.lik(flats)
        ks = random.split(k, moves_per_rung)
        for i in range(moves_per_rung):
            flats = _moves(random.split(ks[i], n_particles), flats, target,
                           beta, L, eps)
        beta_prev = beta
    log_ml = logsumexp(log_w) - math.log(n_particles)
    return flats, log_w, log_ml


def smc_sampler(key, trace: Trace, selection: Selection, betas,
                n_particles: int, L: int = 10, eps: float = 0.1,
                moves_per_rung: int = 1,
                ess_threshold: Optional[float] = None,
                resample_method: str = "systematic"):
    """Tempered SMC: AIS with ESS-triggered resampling between rungs.

    Returns ``(flats, log_weights, log_ml)``; ``log_weights`` are the
    residual (post-resampling) weights: the posterior sample is the
    weighted set, near-uniform when resampling triggered late.
    """
    dev = key.device
    betas = torch.as_tensor(betas, device=dev)
    n = n_particles
    if ess_threshold is None:
        ess_threshold = n / 2
    k_init, k_scan = random.split(key)
    flats, _ = _init_particles(k_init, trace, selection, n)
    target = TemperedTarget(trace, selection)
    log_w = torch.zeros(n, device=dev)
    log_ml = torch.zeros((), device=dev)
    keys = random.split(k_scan, betas.shape[0])
    beta_prevs = torch.cat([torch.zeros(1, dtype=betas.dtype, device=dev),
                            betas[:-1]])
    for beta, beta_prev, k in zip(betas, beta_prevs, keys):
        k_res, k_mov = random.split(k)
        log_w = log_w + (beta - beta_prev) * target.lik(flats)
        log_total = logsumexp(log_w)
        lnw = log_w - log_total
        ess = torch.exp(-logsumexp(2.0 * lnw))
        if bool(ess < ess_threshold):
            parents = _resample_parents(k_res, lnw, resample_method)
            flats = flats[parents]
            log_w = torch.zeros_like(log_w)
            log_ml = log_ml + log_total - math.log(n)
        for i in range(moves_per_rung):
            flats = _moves(_fold_in_keys(k_mov, i, n), flats, target, beta,
                           L, eps)
    log_ml = log_ml + logsumexp(log_w) - math.log(n)
    return flats, log_w, log_ml


def smc_sampler_adaptive(key, trace: Trace, selection: Selection,
                         n_particles: int, target_ess: float = 0.5,
                         max_stages: int = 64, L: int = 10,
                         eps: float = 0.1, moves_per_rung: int = 1,
                         resample_method: str = "systematic"):
    """Tempered SMC with an ESS-ADAPTIVE ladder (Del Moral et al. 2012,
    §3.3): each stage bisects the next beta so the incremental weights'
    ESS hits ``target_ess * N``, then resamples and moves. The number of
    stages is data-dependent (bounded by ``max_stages``).

    Returns ``(flats, log_ml, n_stages, betas)``: equally-weighted
    posterior particles, the evidence estimate, the number of stages used,
    and the (max_stages,) ladder actually taken (NaN-padded).
    """
    dev = key.device
    n = n_particles
    k_init, k = random.split(key)
    flats, _ = _init_particles(k_init, trace, selection, n)
    target = TemperedTarget(trace, selection)
    tgt = target_ess * n

    def ess_of(log_w):
        lnw = log_w - logsumexp(log_w)
        return torch.exp(-logsumexp(2.0 * lnw))

    log_ml = torch.zeros((), device=dev)
    beta = torch.zeros((), device=dev)
    betas_hist = torch.full((max_stages,), math.nan, device=dev)
    stage = 0
    while stage < max_stages and bool(beta < 1.0):
        k, k_res, k_mov = random.split(k, 3)
        lik = target.lik(flats)
        # bisect the largest next beta whose incremental ESS >= target
        # (log_w is uniform here: every stage resamples)
        lo, hi = beta, torch.ones((), dtype=beta.dtype, device=dev)
        for _ in range(50):
            mid = 0.5 * (lo + hi)
            ok = ess_of((mid - beta) * lik) >= tgt
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        full_ok = ess_of((1.0 - beta) * lik) >= tgt
        new_beta = torch.where(full_ok, 1.0, lo)

        log_w = (new_beta - beta) * lik
        log_total = logsumexp(log_w)
        log_ml = log_ml + log_total - math.log(n)
        parents = _resample_parents(k_res, log_w - log_total,
                                    resample_method)
        flats = flats[parents]
        for i in range(moves_per_rung):
            flats = _moves(_fold_in_keys(k_mov, i, n), flats, target,
                           new_beta, L, eps)
        betas_hist[stage] = new_beta
        beta = new_beta
        stage += 1
    return flats, log_ml, stage, betas_hist


_PT_DRAW_BLOCK = 512    # sweeps whose randomness is drawn at once


def parallel_tempering(key, trace: Trace, selection: Selection, betas,
                       n_sweeps: int, L: int = 10, eps: float = 0.1,
                       thin: int = 1):
    """Replica-exchange MCMC over a temperature ladder.

    ``betas``: increasing, ending at 1.0; one replica per temperature
    starts at the trace's current latents. Each sweep: one tempered-HMC
    move per replica (vmapped over the ladder), then even/odd adjacent
    swap proposals with exact acceptance log alpha = (beta_i -
    beta_j)(lik_j - lik_i).

    Returns ``(samples, swap_rate)``: (n_sweeps//thin, dim) latents from
    the beta=1 replica and the mean adjacent-swap acceptance rate.
    """
    dev = key.device
    betas = torch.as_tensor(betas, device=dev)
    K = betas.shape[0]
    target = TemperedTarget(trace, selection)
    flats = target.flat0.to(dev).expand(K, target.dim)
    idx = torch.arange(K, device=dev)
    eligible_by = [(idx[:-1] % 2) == parity for parity in (0, 1)]
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    shape, dtype = (target.dim,), flats.dtype

    def draws(k):
        """A sweep's randomness: per replica the momentum and the log
        uniform of its accept test, and the swaps' log uniforms."""
        k_move, k_swap = random.split(k)
        p0, log_u = vmap(lambda kk: _hmc_draws(kk, shape, dtype))(
            random.split(k_move, K))
        return p0, log_u, torch.log(random.uniform(
            k_swap, (K - 1,), torch.get_default_dtype()))

    def one(f, b, p0, log_u):
        return _hmc_trajectory(f, p0, log_u, target, b, L, eps)[0]

    keys = random.split(key, n_sweeps)
    samples, n_acc = [], torch.zeros((), dtype=torch.int64, device=dev)
    n_el = 0
    for t0 in range(0, n_sweeps, _PT_DRAW_BLOCK):
        # the randomness of a block of sweeps in a few batched draws (the
        # draws are a few hundred small ops each, the sweeps' host cost)
        p0s, log_us, log_u_swaps = vmap(draws)(
            keys[t0:t0 + _PT_DRAW_BLOCK])
        for i in range(p0s.shape[0]):
            t = t0 + i
            flats = vmap(one)(flats, betas, p0s[i], log_us[i])
            liks = target.lik(flats)
            # propose swaps for pairs (i, i+1) with i = parity, parity+2,
            # ...; the pairs are disjoint, so one permutation applies all
            eligible = eligible_by[t % 2]
            log_alpha = (betas[:-1] - betas[1:]) * (liks[1:] - liks[:-1])
            acc = eligible & (log_u_swaps[i] < log_alpha)
            swap_lo = torch.cat([acc, no])        # i swaps up
            swap_hi = torch.cat([no, acc])        # i+1 swaps down
            perm = torch.where(swap_lo, idx + 1,
                               torch.where(swap_hi, idx - 1, idx))
            flats = flats[perm]
            samples.append(flats[-1])
            n_acc = n_acc + torch.sum(acc)
            n_el += (K - 1 - t % 2 + 1) // 2
    swap_rate = n_acc / max(n_el, 1)
    return torch.stack(samples)[::thin], swap_rate
