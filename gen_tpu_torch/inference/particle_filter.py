"""Particle filtering / sequential Monte Carlo.

Counterpart: ``gen_tpu/inference/particle_filter.py``. The particle axis is
a ``torch.func.vmap`` axis over ``generate`` and ``update``; resampling is
a gather of every trace leaf. With Unfold models the step rides Unfold's
O(1) extension path. The state is functional: every function returns a
new state.

Where PyTorch forces a difference: ``maybe_resample``'s ``lax.cond`` is a
Python branch on one ``.item()`` (the ESS test). Both branches give what
gen_tpu's give: parents (identity when nothing is resampled), zeroed
weights after a resample, the log-ML cast to ``result_type(log_ml,
log_total)``. Systematic resampling launches kernel K4 on a CUDA tensor
(:mod:`gen_tpu_torch.ops.resample`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.utils._pytree as pytree

from .. import random
from ..choice_map import ChoiceMap
from ..gfi import GenerativeFunction
from ..utils import logsumexp

_GUMBEL_MAX_N = 32768   # above it, no (n, n) Gumbels are drawn


class ParticleFilterState:
    """Vectorized traces + per-particle log weights + accumulated log-ML
    (+ the parents of the last ``maybe_resample``)."""

    __slots__ = ("traces", "log_weights", "log_ml_est", "parents")

    def __init__(self, traces, log_weights, log_ml_est, parents=None):
        self.traces = traces
        self.log_weights = log_weights
        self.log_ml_est = log_ml_est
        self.parents = parents

    @property
    def num_particles(self) -> int:
        return self.log_weights.shape[0]


pytree.register_pytree_node(
    ParticleFilterState,
    lambda s: ([s.traces, s.log_weights, s.log_ml_est, s.parents], None),
    lambda c, _: ParticleFilterState(*c),
    serialized_type_name="gen_tpu_torch.ParticleFilterState")


def effective_sample_size(log_normalized_weights) -> torch.Tensor:
    """ESS = exp(-logsumexp(2 * log w_norm))."""
    return torch.exp(-logsumexp(2.0 * log_normalized_weights))


def _propose_and_generate(model, model_args, observations, proposal,
                          proposal_args):
    def one(k):
        kp, km = random.split(k)
        prop_choices, prop_weight, _ = proposal.propose(kp, proposal_args)
        constraints = observations.merge(prop_choices)
        trace, model_weight = model.generate(km, model_args, constraints)
        return trace, model_weight - prop_weight
    return one


def initialize_particle_filter(key, model: GenerativeFunction,
                               model_args: Tuple, observations: ChoiceMap,
                               num_particles: int,
                               proposal: Optional[GenerativeFunction] = None,
                               proposal_args: Tuple = ()):
    keys = random.split(key, num_particles)
    if proposal is None:
        traces, log_weights = torch.func.vmap(
            lambda k: model.generate(k, model_args, observations))(keys)
    else:
        traces, log_weights = torch.func.vmap(_propose_and_generate(
            model, model_args, observations, proposal, proposal_args))(keys)
    # gen_tpu's weakly typed 0.0 takes the weights' dtype
    return ParticleFilterState(traces, log_weights,
                               torch.zeros((), dtype=log_weights.dtype,
                                           device=log_weights.device))


def particle_filter_step(key, state: ParticleFilterState, new_args: Tuple,
                         argdiffs: Tuple, observations: ChoiceMap,
                         proposal: Optional[GenerativeFunction] = None,
                         proposal_args: Tuple = ()):
    """Extend every particle to the new arguments/observations.

    Default: the weight increment of ``update``. Custom proposal: propose
    per particle (given its trace), then a constrained ``update``; weight =
    update weight - proposal weight. A proposal that overwrites existing
    choices (non-empty discard) is not a trace extension and raises."""
    keys = random.split(key, state.num_particles)

    def one(k, trace):
        fn = trace.get_gen_fn()
        if proposal is None:
            new_trace, weight, _, _ = fn.update(
                k, trace, new_args, argdiffs, observations)
            return new_trace, weight
        kp, ku = random.split(k)
        prop_choices, prop_weight, _ = proposal.propose(
            kp, (trace,) + tuple(proposal_args))
        constraints = observations.merge(prop_choices)
        new_trace, weight, _, discard = fn.update(
            ku, trace, new_args, argdiffs, constraints)
        if not discard.is_empty():
            raise ValueError(
                "particle_filter_step: proposal overwrote existing choices "
                "(discard non-empty); not a valid trace extension")
        return new_trace, weight - prop_weight

    new_traces, weights = torch.func.vmap(one)(keys, state.traces)
    return ParticleFilterState(new_traces, state.log_weights + weights,
                               state.log_ml_est, state.parents)


def _resample_parents(key, log_normalized_weights, method: str):
    n = log_normalized_weights.shape[0]
    if method == "multinomial":
        if n > _GUMBEL_MAX_N:
            # inverse-cdf with sorted uniforms (exponential spacings) and
            # the rank merge: O(n log n), exact in distribution (the
            # parents come out sorted; particles are exchangeable)
            from ..ops.resample import _rank_merge_parents, normalized_cdf
            c = torch.cumsum(random.exponential(key, (n + 1,)), dim=0)
            us = c[:-1] / c[-1]
            return torch.clamp(_rank_merge_parents(
                normalized_cdf(log_normalized_weights), us), 0, n - 1)
        return random.categorical(key, log_normalized_weights, shape=(n,))
    if method == "systematic":
        # one uniform, stratified positions; kernel K4 on the card
        from ..ops.resample import systematic_resample
        u = random.uniform(key, (), torch.get_default_dtype())
        return systematic_resample(log_normalized_weights, u)
    if method == "residual":
        w = torch.exp(log_normalized_weights)
        counts = torch.floor(w * n).to(torch.int64)
        resid = w * n - counts
        k1 = random.split(key, 1)[0]
        resid_logits = torch.log(torch.clamp(resid, min=1e-38))
        if n > _GUMBEL_MAX_N:
            # gen_tpu draws these from (n, n) Gumbels here too (68 GB of
            # float32 at 131,072 particles; ROADMAP queue 3): the port
            # draws them by inverse cdf of n iid uniforms instead, exact
            # in distribution
            from ..ops.resample import _rank_merge_parents, normalized_cdf
            us, perm = torch.sort(random.uniform(k1, (n,), w.dtype))
            extra = torch.empty(n, dtype=torch.int64, device=w.device)
            extra[perm] = torch.clamp(_rank_merge_parents(
                normalized_cdf(resid_logits), us), 0, n - 1).long()
        else:
            extra = random.categorical(k1, resid_logits, shape=(n,))
        idx = torch.arange(n, device=w.device)
        base = torch.repeat_interleave(idx, counts)[:n]
        base = torch.cat([base, base.new_zeros(n - base.shape[0])])
        return torch.where(idx < torch.sum(counts), base, extra)
    raise ValueError(f"unknown resampling method {method!r}")


def maybe_resample(key, state: ParticleFilterState,
                   ess_threshold: Optional[float] = None,
                   method: str = "systematic"):
    """Resample when ESS < threshold (default N/2), accumulating the log-ML
    increment. Returns (new_state, did_resample)."""
    n = state.num_particles
    if ess_threshold is None:
        ess_threshold = n / 2
    log_total = logsumexp(state.log_weights)
    lnw = state.log_weights - log_total
    do = bool(effective_sample_size(lnw) < ess_threshold)
    lm_dtype = torch.result_type(state.log_ml_est, log_total)
    if do:
        parents = _resample_parents(key, lnw, method).to(torch.int32)
        traces = pytree.tree_map(lambda x: x[parents], state.traces)
        return ParticleFilterState(
            traces, torch.zeros_like(state.log_weights),
            (state.log_ml_est + log_total - math.log(n)).to(lm_dtype),
            parents), do
    return ParticleFilterState(
        state.traces, state.log_weights, state.log_ml_est.to(lm_dtype),
        torch.arange(n, dtype=torch.int32,
                     device=state.log_weights.device)), do


def log_ml_estimate(state: ParticleFilterState):
    return (state.log_ml_est + logsumexp(state.log_weights)
            - math.log(state.num_particles))


def sample_unweighted_traces(key, state: ParticleFilterState,
                             num_samples: int):
    log_total = logsumexp(state.log_weights)
    idx = random.categorical(key, state.log_weights - log_total,
                             shape=(num_samples,))
    return pytree.tree_map(lambda x: x[idx], state.traces)


def get_traces(state):
    return state.traces


def get_log_weights(state):
    return state.log_weights
