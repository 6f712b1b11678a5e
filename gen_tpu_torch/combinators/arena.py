"""UnfoldArena: fixed-capacity state-space traces with O(1) extension, and
``smc_run``, a whole particle filter over them.

Counterpart: ``gen_tpu/combinators/arena.py``. The arena preallocates
``max_length`` slots; the active length ``t_active`` is a tensor, and
``extend`` writes slot ``t_active`` with a where-mask over the slot axis.
Inactive slots are zero padding with zero scores, so the trace score is
exactly the active prefix's joint.

Where PyTorch forces a difference: ``smc_run``'s ``lax.scan`` over the
steps is a Python loop, and its ``lax.cond`` is a Python branch on one
``.item()`` (the ESS test); both branches give what gen_tpu's give. A
Python-number ``init_state`` becomes a tensor on the key's device in
``init``, so that slot 0 has the structure of every later slot.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.utils._pytree as pytree

from .. import random
from ..choice_map import ChoiceMap
from ..gfi import GenerativeFunction, Trace
from ..utils import join_static, logsumexp, split_static
from .unfold import UnfoldCombinator, UnfoldTrace, as_state
from .vector import VectorChoiceMap, tree_index


class ArenaTrace(Trace):
    """subtraces: one batched kernel-trace pytree over the slot axis;
    t_active: int32 tensor count of live slots."""

    __slots__ = ("arena", "subtraces", "t_active", "init_state", "params",
                 "static_mask")

    def __init__(self, arena, subtraces, t_active, init_state, params,
                 static_mask=None):
        self.arena = arena
        self.subtraces = subtraces
        self.t_active = t_active
        self.init_state = init_state
        self.params = params
        # which leaves of (init_state, params) are static, once flattened
        self.static_mask = static_mask

    def get_args(self):
        return (self.t_active, self.init_state) + tuple(self.params)

    def get_retval(self):
        return self.subtraces.get_retval()  # stacked states (max_length,...)

    def get_score(self):
        return torch.sum(self.subtraces.get_score())  # inactive slots are 0

    def get_gen_fn(self):
        return self.arena

    def last_state(self):
        """The state of slot ``t_active - 1``, by a one-hot masked sum."""
        idx = torch.clamp(self.t_active - 1, min=0)

        def pick(x):
            onehot = torch.arange(x.shape[0], device=x.device) == idx
            return torch.sum(torch.where(
                onehot.reshape((-1,) + (1,) * (x.dim() - 1)), x,
                torch.zeros((), dtype=x.dtype, device=x.device)), dim=0)

        return pytree.tree_map(pick, self.get_retval())

    def get_choices(self):
        out = ChoiceMap()
        inner = self.subtraces.get_choices()
        for i in range(int(self.t_active)):
            out.set_submap(i, tree_index(inner, i))
        return out

    def project(self, selection):
        if selection.is_empty_set():
            return torch.zeros(())
        raise NotImplementedError(
            "arena project: convert with to_unfold_trace() first")

    def to_unfold_trace(self):
        """Concrete-length view as a standard UnfoldTrace (full GFI)."""
        t = int(self.t_active)
        subs = pytree.tree_map(lambda x: x[:t], self.subtraces)
        unfold = UnfoldCombinator(self.arena.kernel)
        args = (t, self.init_state) + tuple(self.params)
        return UnfoldTrace(unfold, args, subs, torch.sum(subs.get_score()),
                           subs.get_retval(), t)


def _arena_flatten(tr: ArenaTrace):
    rest_dyn, rest_aux = split_static((tr.init_state, tuple(tr.params)),
                                      tr.static_mask)
    return [tr.subtraces, tr.t_active, rest_dyn], (tr.arena, rest_aux)


def _arena_unflatten(children, aux):
    subtraces, t_active, rest_dyn = children
    init_state, params = join_static(rest_dyn, aux[1])
    return ArenaTrace(aux[0], subtraces, t_active, init_state, params,
                      aux[1][1])


pytree.register_pytree_node(ArenaTrace, _arena_flatten, _arena_unflatten,
                            serialized_type_name="gen_tpu_torch.ArenaTrace")


class UnfoldArena(GenerativeFunction):
    """``UnfoldArena(kernel, max_length)``: SMC-oriented interface,
    ``init`` then repeated ``extend``."""

    def __init__(self, kernel: GenerativeFunction, max_length: int):
        self.kernel = kernel
        self.max_length = max_length

    def __repr__(self):
        return f"UnfoldArena({self.kernel!r}, max_length={self.max_length})"

    def _zero_pad(self, sub):
        """Arena of max_length slots: slot 0 = sub, the rest zero."""
        def pad(x):
            x = torch.as_tensor(x)
            return torch.cat([x[None], torch.zeros(
                (self.max_length - 1,) + tuple(x.shape), dtype=x.dtype,
                device=x.device)])
        return pytree.tree_map(pad, sub)

    def init(self, key, init_state, params: Tuple = (),
             constraints: Optional[ChoiceMap] = None):
        """Generate step 0. Returns (trace, weight)."""
        dev = key.device
        init_state = as_state(init_state, dev)
        sub, w = self.kernel.generate(
            key, (torch.zeros((), dtype=torch.int32, device=dev),
                  init_state) + tuple(params),
            constraints if constraints is not None else ChoiceMap())
        return ArenaTrace(self, self._zero_pad(sub),
                          torch.ones((), dtype=torch.int32, device=dev),
                          init_state, tuple(params)), w

    def extend(self, key, trace: ArenaTrace,
               constraints: Optional[ChoiceMap] = None):
        """Append one step at ``t_active``: O(1). Weight = the generate
        weight of the new step (Unfold's extension semantics)."""
        t = trace.t_active
        sub, w = self.kernel.generate(
            key, (t, trace.last_state()) + tuple(trace.params),
            constraints if constraints is not None else ChoiceMap())

        def write_slot(arena_leaf, new_leaf):
            mask = torch.arange(arena_leaf.shape[0],
                                device=arena_leaf.device) == t
            mask = mask.reshape((-1,) + (1,) * (arena_leaf.dim() - 1))
            newv = torch.as_tensor(new_leaf).to(arena_leaf.dtype)
            return torch.where(mask, newv[None, ...], arena_leaf)

        new_arena = pytree.tree_map(write_slot, trace.subtraces, sub)
        return ArenaTrace(self, new_arena, t + 1, trace.init_state,
                          trace.params), w

    def simulate(self, key, args: Tuple):
        t_total, init_state, *params = args
        keys = random.split(key, int(t_total))
        trace, _ = self.init(keys[0], init_state, tuple(params))
        for i in range(1, int(t_total)):
            trace, _ = self.extend(keys[i], trace)
        return trace


def smc_run(key, arena: UnfoldArena, init_state, params: Tuple,
            observations: VectorChoiceMap, num_particles: int,
            ess_threshold: Optional[float] = None,
            resample_method: str = "systematic"):
    """A whole particle filter: particles vmapped, resampling between
    steps when the ESS falls below ``ess_threshold`` (default N/2).
    ``observations``: dense per-step constraints (``vector_choicemap(T,
    y=obs)``). Returns (final_state_traces, log_weights,
    log_ml_estimate)."""
    from ..inference import particle_filter
    T = observations.length
    if ess_threshold is None:
        ess_threshold = num_particles / 2

    k_init, k_scan = random.split(key)
    obs0 = observations.get_submap(0)
    traces, log_weights = torch.func.vmap(
        lambda k: arena.init(k, init_state, params, obs0))(
        random.split(k_init, num_particles))
    log_ml = torch.zeros((), dtype=log_weights.dtype,
                         device=log_weights.device)
    keys = random.split(k_scan, T - 1)
    for t in range(1, T):
        k_res, k_ext = random.split(keys[t - 1])
        log_total = logsumexp(log_weights)
        lnw = log_weights - log_total
        ess = torch.exp(-logsumexp(2.0 * lnw))
        lm_dtype = torch.result_type(log_ml, log_total)
        if bool(ess < ess_threshold):
            parents = particle_filter._resample_parents(k_res, lnw,
                                                        resample_method)
            traces = pytree.tree_map(lambda x: x[parents], traces)
            log_weights = torch.zeros_like(log_weights)
            log_ml = (log_ml + log_total
                      - math.log(num_particles)).to(lm_dtype)
        else:
            log_ml = log_ml.to(lm_dtype)
        obs_t = tree_index(observations.inner, t)
        traces, ws = torch.func.vmap(
            lambda kk, tr: arena.extend(kk, tr, obs_t))(
            random.split(k_ext, num_particles), traces)
        log_weights = log_weights + ws
    final_lml = log_ml + logsumexp(log_weights) - math.log(num_particles)
    return traces, log_weights, final_lml
