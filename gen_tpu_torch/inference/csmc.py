"""Conditional SMC and Particle Gibbs with ancestor sampling.

Counterpart: ``gen_tpu/inference/csmc.py``. A conditional particle filter
pins lane 0 to a reference trajectory, which leaves the exact posterior
over trajectories invariant (Andrieu, Doucet & Holenstein 2010); ancestor
sampling (Lindsten, Jordan & Schön 2014) redraws the reference lane's
parent at each step.

Built on the genealogy formulation of :mod:`.smc`: the reference lane is
expressed with :class:`~gen_tpu_torch.masked.MaskedValue` constraints
(flag = lane == 0), so lane pinning is branchless and the extension step
stays one vmapped ``generate``. Resampling is conditional multinomial
(iid parents for lanes 1..N-1, lane 0's ancestor pinned or
ancestor-sampled); the final trajectory comes from the backward genealogy
gather.

Weights (GFI-exact): a non-reference lane's incremental weight is the
``generate`` weight with the step's observations constrained. The
reference lane's ``generate`` has ALL of the reference's step choices
constrained (weight = the full joint density); subtracting
``project(subtrace, latent_selection)``, the internal-proposal density of
the latent choices, recovers the weight the lane would have had, had the
internal proposal sampled the reference values.

Ancestor sampling's one-step weight ``w_{t-1}^i p(ref step-t choices |
state_i)`` (through ``assess``) is exact where the kernel's carried state
is determined by its traced choices at that step (``x ~ normal(f(prev),
q); return x``); :func:`check_state_is_choice_determined` checks a kernel,
and ``ancestor_sampling=False`` (plain CSMC) is always valid.

Where PyTorch forces a difference: the ``lax.scan`` over steps and sweeps
is a Python loop whose outputs are stacked time-major (sweep-major) at the
end. The resample-or-keep ``lax.cond`` is a host branch: on the step alone
under the default schedule (resample every step after the first), on one
``.item()`` (the ESS test) with ``ess_threshold``. The rank merge of the
conditional multinomial stays plain torch, as on the particle-filter path.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from .. import random
from ..choice_map import ChoiceMap
from ..combinators.unfold import as_state, step_index
from ..combinators.vector import VectorChoiceMap, tree_index, tree_stack
from ..gfi import GenerativeFunction
from ..masked import MaskedValue
from ..ops.resample import _rank_merge_parents
from ..selection import select
from ..utils import logsumexp
from .smc import reconstruct_trajectories


def _conditional_multinomial_parents(key, lnw):
    """(n-1,) IID multinomial parents for the non-reference lanes,
    O(n log n) at any n: exponential-spacings sorted uniforms and the rank
    merge (ops/resample.py), where ``random.categorical(shape=(n,))``
    would draw an (n, n) block of Gumbels.

    Exactly n-1 draws are made and ALL are kept (the caller prepends the
    pinned/ancestor-sampled lane-0 parent). Drawing n and overwriting
    index 0 would discard the MINIMUM of n sorted draws: the kept n-1
    would no longer be iid (with n=4 uniform weights, parent 0 appears
    with frequency 0.106 instead of 0.25), which suppresses the previous
    reference particle's offspring and breaks CSMC invariance. The sorted
    order itself is harmless: lanes 1..N-1 are exchangeable (all extended
    by iid proposals)."""
    return _parents_from_exponentials(
        random.exponential(key, (lnw.shape[0],)), lnw)


def _parents_from_exponentials(e, lnw):
    """:func:`_conditional_multinomial_parents` from its n exponentials."""
    n = lnw.shape[0]
    c = torch.cumsum(e, dim=0)
    us = c[:-1] / c[-1]                       # (n-1,) sorted iid uniforms
    w = torch.exp(lnw - torch.max(lnw))
    cdf = torch.cumsum(w, dim=0)
    return torch.clamp(_rank_merge_parents(cdf / cdf[-1], us),
                       0, n - 1).to(torch.int32)


def _step_draws(keys, n: int):
    """The randomness of a run of steps that does not depend on the
    particles, from the steps' keys, in a few batched draws (each draw is a
    few hundred small ops, the steps' host cost): per step the ancestor
    key, the n exponentials of the conditional multinomial and the n
    particle keys of the extension."""
    sub = vmap(lambda k: random.split(k, 3))(keys)
    return (sub[:, 0], vmap(lambda k: random.exponential(k, (n,)))(sub[:, 1]),
            vmap(lambda k: random.split(k, n))(sub[:, 2]))


_DRAW_ELEMS = 1 << 22   # particle-steps whose draws are made at once


def _latent_paths(ref_inner: ChoiceMap, obs_inner: ChoiceMap):
    obs_addrs = set(obs_inner.addresses())
    latent = [a for a in ref_inner.addresses() if a not in obs_addrs]
    if not latent:
        raise ValueError("reference choices contain no latent addresses "
                         "beyond the observations — nothing to condition on")
    return latent


def _pick(key, subs, ancestry, log_w, length: int) -> VectorChoiceMap:
    """The trajectory of one final particle drawn by its weight, as a
    time-major choice map."""
    j = random.categorical(key, log_w - logsumexp(log_w))
    trajs = reconstruct_trajectories(subs, ancestry)
    traj_j = pytree.tree_map(lambda x: x[:, j], trajs)
    return VectorChoiceMap(traj_j.get_choices(), length)


def csmc_genealogy(key, kernel: GenerativeFunction, init_state,
                   params: Tuple, observations: VectorChoiceMap,
                   ref_choices: VectorChoiceMap, num_particles: int,
                   ancestor_sampling: bool = False,
                   ess_threshold: Optional[float] = None):
    """Conditional SMC over an Unfold-style kernel
    ``(t, state, *params) -> state``, pinning lane 0 to ``ref_choices``.

    ``ref_choices`` must be the FULL per-step choices of a coherent
    trajectory (latents and observations), time-major: e.g. the output of
    :func:`particle_gibbs_step`. ``ess_threshold=None`` resamples every
    step (the standard CSMC schedule); pass a value for adaptive
    resampling.

    Returns ``(subtraces, ancestry, log_weights, log_ml_estimate)`` with
    the shapes and meaning of :func:`gen_tpu_torch.inference.smc.
    smc_genealogy`.
    """
    T = observations.length
    if ref_choices.length != T:
        raise ValueError(f"ref_choices length {ref_choices.length} != "
                         f"observations length {T}")
    n = num_particles
    dev = key.device
    latent_addrs = _latent_paths(ref_choices.inner, observations.inner)
    latent_sel = select(*latent_addrs)

    k_scan, = random.split(key, 1)
    is_ref = torch.arange(n, device=dev) == 0
    states = pytree.tree_map(lambda x: x.expand((n,) + tuple(x.shape)),
                             as_state(init_state, dev))
    log_w = torch.zeros(n, device=dev)
    log_ml = torch.zeros((), device=dev)
    identity = torch.arange(n, dtype=torch.int32, device=dev)
    subs_t, ancestry = [], []
    keys = random.split(k_scan, T)
    block = max(1, _DRAW_ELEMS // n)
    for t in range(T):
        if t % block == 0:
            k_ancs, expos, k_exts = _step_draws(keys[t:t + block], n)
        k_anc, expo, k_ext = (x[t % block] for x in (k_ancs, expos, k_exts))
        t_arg = step_index(t, dev)
        ref_t = tree_index(ref_choices.inner, t)
        obs_t = tree_index(observations.inner, t)

        log_total = logsumexp(log_w)
        lnw = log_w - log_total
        lm_dtype = torch.result_type(log_ml, log_total)
        do = t > 0 and (ess_threshold is None or bool(
            torch.exp(-logsumexp(2.0 * lnw)) < ess_threshold))
        if do:
            rest = _parents_from_exponentials(expo, lnw)
            if ancestor_sampling:
                # w_{t-1}^i * p(ref step-t choices | state_i): exact under
                # the choice-determined-state condition (module docstring)
                as_lp = vmap(lambda s: kernel.assess(
                    (t_arg, s) + tuple(params), ref_t)[0])(states)
                p0 = random.categorical(k_anc, lnw + as_lp).to(torch.int32)
            else:
                p0 = torch.zeros((), dtype=torch.int32, device=dev)
            parents = torch.cat([p0[None], rest])
            states = pytree.tree_map(lambda x: x[parents], states)
            log_w = torch.zeros_like(log_w)
            log_ml = (log_ml + log_total - math.log(n)).to(lm_dtype)
        else:
            parents = identity
            log_ml = log_ml.to(lm_dtype)

        def one(k_i, s, flag):
            cons = obs_t.copy()
            for addr in latent_addrs:
                cons.set_value(addr, MaskedValue(ref_t.get_value(addr), flag))
            sub, w = kernel.generate(k_i, (t_arg, s) + tuple(params), cons)
            # reference lane: full joint weight -> importance weight by
            # removing the internal-proposal density of the pinned latents
            w = w - torch.where(flag, sub.project(latent_sel), 0.0)
            return sub, w

        subs, ws = vmap(one)(k_ext, states, is_ref)
        states = subs.get_retval()
        log_w = log_w + ws
        subs_t.append(subs)
        ancestry.append(parents)
    final_lml = log_ml + logsumexp(log_w) - math.log(n)
    return tree_stack(subs_t), torch.stack(ancestry), log_w, final_lml


def particle_gibbs_step(key, kernel: GenerativeFunction, init_state,
                        params: Tuple, observations: VectorChoiceMap,
                        ref_choices: VectorChoiceMap, num_particles: int,
                        ancestor_sampling: bool = True,
                        ess_threshold: Optional[float] = None):
    """One Particle-Gibbs sweep: run conditional SMC against the current
    reference trajectory, then draw the new reference from the final
    particle weights (the returned choice map has the input's structure).

    Returns ``(new_ref_choices, log_ml_estimate)``. Iterating this function
    is a Markov chain on full latent trajectories whose invariant
    distribution is the exact posterior ``p(latents | observations)``
    (Andrieu et al. 2010 Thm 5); ``ancestor_sampling=True`` improves the
    mixing of the early states of long sequences (Lindsten et al. 2014) and
    needs the choice-determined-state condition (module docstring).
    """
    k_run, k_pick = random.split(key)
    subs, ancestry, log_w, lml = csmc_genealogy(
        k_run, kernel, init_state, params, observations, ref_choices,
        num_particles, ancestor_sampling=ancestor_sampling,
        ess_threshold=ess_threshold)
    return _pick(k_pick, subs, ancestry, log_w, observations.length), lml


def particle_gibbs(key, kernel: GenerativeFunction, init_state,
                   params: Tuple, observations: VectorChoiceMap,
                   num_particles: int, num_sweeps: int,
                   ancestor_sampling: bool = True,
                   init_ref: Optional[VectorChoiceMap] = None):
    """Run a Particle-Gibbs chain of ``num_sweeps`` sweeps of
    :func:`particle_gibbs_step`.

    The initial reference is drawn from an unconditional genealogy SMC run
    (a draw from the posterior approximation, a valid initialization)
    unless ``init_ref`` is given. Returns ``(refs, log_mls)`` where
    ``refs`` is a time-major choice map whose leaves have a leading
    ``(num_sweeps,)`` axis: sweep s's trajectory is
    ``VectorChoiceMap(tree_map(lambda x: x[s], refs.inner), T)``.
    """
    from .smc import smc_genealogy
    k_init, k_pick, k_scan = random.split(key, 3)
    if init_ref is None:
        subs, anc, log_w, _ = smc_genealogy(
            k_init, kernel, init_state, params, observations, num_particles)
        init_ref = _pick(k_pick, subs, anc, log_w, observations.length)
    ref, refs, lmls = init_ref, [], []
    for k in random.split(k_scan, num_sweeps):
        ref, lml = particle_gibbs_step(
            k, kernel, init_state, params, observations, ref, num_particles,
            ancestor_sampling=ancestor_sampling)
        refs.append(ref)
        lmls.append(lml)
    return tree_stack(refs), torch.stack(lmls)


def check_state_is_choice_determined(key, kernel: GenerativeFunction,
                                     states, t, params: Tuple,
                                     step_choices: ChoiceMap,
                                     atol: float = 0.0) -> bool:
    """Host-side validator for the ancestor-sampling condition: generate
    the kernel at step ``t`` from each of several ``states`` (a batched
    pytree) with ``step_choices`` fully constrained, and check that the
    returned carried state is the same for every ancestor. Run it on
    representative states before enabling ``ancestor_sampling=True``."""
    n = pytree.tree_leaves(states)[0].shape[0]
    if isinstance(t, int):
        t = step_index(t, key.device)

    def one(k, s):
        sub, _ = kernel.generate(k, (t, s) + tuple(params), step_choices)
        return sub.get_retval()

    retvals = vmap(one)(random.split(key, n), states)
    for leaf in pytree.tree_leaves(retvals):
        leaf = np.asarray(leaf.detach().cpu())
        if not np.all(np.abs(leaf - leaf[0]) <= atol):
            return False
    return True
