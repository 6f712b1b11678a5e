"""Batch sequential Monte Carlo with ancestry tracking (genealogy PF).

Counterpart: ``gen_tpu/inference/smc.py``. Per-step kernel traces are
collected time-major; resampling permutes only the carried state plus an
ancestry row, and whole trajectories are reconstructed once at the end by
a backward gather pass, so the per-step cost does not grow with history
length.

Where PyTorch forces a difference: the ``lax.scan`` over steps is a Python
loop that stacks the per-step subtraces and ancestry rows time-major at
the end, and the ``lax.cond`` is a Python branch on one ``.item()`` (the
ESS test). A step that keeps its weights gets an identity ancestry row.
Each step's work is split into :func:`extend_particles` (the vmapped
``generate``) and :func:`resample_states` (the parents, through kernel K4
for ``systematic`` on the card, and the gather of the states).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.utils._pytree as pytree

from .. import random
from ..combinators.unfold import as_state, step_index
from ..combinators.vector import VectorChoiceMap, tree_index, tree_stack
from ..gfi import GenerativeFunction
from ..utils import logsumexp
from .particle_filter import _resample_parents


def extend_particles(kernel: GenerativeFunction, keys, t, states, params,
                     obs_t):
    """One step of every particle: ``kernel.generate`` vmapped over the
    keys and the states. Returns (subtraces, weights)."""
    return torch.func.vmap(
        lambda k, s: kernel.generate(k, (t, s) + tuple(params), obs_t))(
        keys, states)


def resample_states(key, lnw, states, method: str):
    """Parents drawn from the normalized log weights, and the states
    gathered by them. Returns (states, parents int32)."""
    parents = _resample_parents(key, lnw, method).to(torch.int32)
    return pytree.tree_map(lambda x: x[parents], states), parents


def smc_genealogy(key, kernel: GenerativeFunction, init_state, params: Tuple,
                  observations: VectorChoiceMap, num_particles: int,
                  ess_threshold: Optional[float] = None,
                  resample_method: str = "systematic"):
    """Run a full particle filter over an Unfold-style kernel
    ``(t, state, *params) -> state``.

    Returns (subtraces, ancestry, log_weights, log_ml_estimate):
      subtraces: time-major batched kernel traces, leaves (T, N, ...)
      ancestry:  (T, N) int32, the parents chosen at each step's
                 resampling (identity rows where none happened)
      log_weights: (N,) final unnormalized log weights
    Use :func:`reconstruct_trajectories` for coherent particle histories.
    """
    T = observations.length
    if ess_threshold is None:
        ess_threshold = num_particles / 2
    n = num_particles
    dev = key.device

    k_init, k_scan = random.split(key)
    states = pytree.tree_map(
        lambda x: x.expand((n,) + tuple(x.shape)), as_state(init_state, dev))
    log_w = torch.zeros(n, device=dev)
    log_ml = torch.zeros((), dtype=log_w.dtype, device=dev)
    identity = torch.arange(n, dtype=torch.int32, device=dev)
    keys = random.split(k_scan, T)
    subs_t, ancestry = [], []
    for t in range(T):
        k_res, k_ext = random.split(keys[t])
        log_total = logsumexp(log_w)
        lnw = log_w - log_total
        lm_dtype = torch.result_type(log_ml, log_total)
        if t > 0 and bool(torch.exp(-logsumexp(2.0 * lnw)) < ess_threshold):
            states, parents = resample_states(k_res, lnw, states,
                                              resample_method)
            log_w = torch.zeros_like(log_w)
            log_ml = (log_ml + log_total - math.log(n)).to(lm_dtype)
        else:
            parents = identity
            log_ml = log_ml.to(lm_dtype)
        subs, ws = extend_particles(kernel, random.split(k_ext, n),
                                    step_index(t, dev), states, params,
                                    tree_index(observations.inner, t))
        states = subs.get_retval()
        log_w = log_w + ws
        subs_t.append(subs)
        ancestry.append(parents)
    final_lml = log_ml + logsumexp(log_w) - math.log(n)
    return tree_stack(subs_t), torch.stack(ancestry), log_w, final_lml


def reconstruct_trajectories(subtraces, ancestry):
    """Resolve the genealogy: time-major subtraces re-indexed so that column
    j is the coherent history of final particle j. One backward pass of
    (N,) index gathers, then one gather per leaf."""
    T, n = ancestry.shape
    # ancestry[t] maps a step-t particle to its parent's index at step t-1
    idx = torch.arange(n, dtype=ancestry.dtype, device=ancestry.device)
    step_indices = [None] * T
    for t in range(T - 1, -1, -1):
        step_indices[t] = idx
        idx = ancestry[t][idx]
    step_indices = torch.stack(step_indices).long()
    rows = torch.arange(T, device=ancestry.device)[:, None]
    return pytree.tree_map(lambda x: x[rows, step_indices], subtraces)
