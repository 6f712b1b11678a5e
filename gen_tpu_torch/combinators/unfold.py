"""Unfold combinator: a Markov chain of kernel applications.

Counterpart: ``gen_tpu/combinators/unfold.py``. Kernel signature
``(t, state, *params) -> state``, args ``(T, init_state, *params)``, the
choices of step t under integer key t, the trace stored time-major (leaves
``(T, ...)``). ``update`` keeps the O(1) extension path that the particle
filter rides (``IntDiff`` on T, constraints only at the new steps: the
kernel runs on the appended steps alone) and re-runs every step under
``update`` semantics otherwise.

Where PyTorch forces a difference:

- ``lax.scan`` becomes a Python loop over the steps with gen_tpu's
  per-step keys (``split(key, T)``); the subtraces are stacked time-major
  at the end.
- gen_tpu lowers sparse per-step constraints onto one masked dense scan
  (``densify_masked``); the port runs its per-step loop, with the same
  weights. The keys are the same too, unless a partially constrained
  address comes before a sampled one in the kernel: the masked scan draws
  a key at every masked address.
- Per-step selections that differ are lowered by gen_tpu onto a masked
  selection; the port raises ``NotImplementedError`` there (``masked.py``,
  ROADMAP queue 1 item 5). ALL, NONE and selections that are the same at
  every step run the per-step loop with gen_tpu's keys.
- The step index ``t`` and Python numbers in ``init_state`` become tensors
  on the key's device before the first step: torch's pytrees keep Python
  numbers static where JAX traces them, and every step's subtrace must
  have the same structure to be stacked.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.utils._pytree as pytree

from .. import random
from ..address import addr_path
from ..choice_map import ChoiceMap
from ..diff import IntDiff, NoChange, UnknownChange
from ..gfi import GenerativeFunction, Trace
from ..selection import (AllSelection, EmptySelection, Selection,
                         selection_signature, static_leaf_paths)
from ..utils import join_static, split_static
from .vector import VectorChoiceMap, tree_index, tree_stack, try_densify


def step_index(t: int, device) -> torch.Tensor:
    """The kernel's step argument: an int64 tensor, as ``jnp.arange``'s
    elements are in gen_tpu's 64-bit mode."""
    return torch.tensor(t, dtype=torch.int64, device=device)


def as_state(state, device):
    """``state`` with its Python numbers made tensors on ``device``."""
    return pytree.tree_map(
        lambda x: torch.as_tensor(x, device=device)
        if isinstance(x, (bool, int, float)) else x, state)


def _zero(device):
    return torch.zeros((), device=device)


class UnfoldTrace(Trace):
    __slots__ = ("gen_fn", "args", "subtraces", "score", "retval", "length",
                 "args_mask")

    def __init__(self, gen_fn, args, subtraces, score, retval, length,
                 args_mask=None):
        self.gen_fn = gen_fn
        self.args = args
        self.subtraces = subtraces  # batched over the time axis
        self.score = score
        self.retval = retval        # stacked states, leaves (T, ...)
        self.length = length
        self.args_mask = args_mask  # which args are static, once flattened

    def get_args(self):
        return self.args

    def get_retval(self):
        return self.retval

    def get_score(self):
        return self.score

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self) -> VectorChoiceMap:
        return VectorChoiceMap(self.subtraces.get_choices(), self.length)

    def get_subtrace(self, t):
        return tree_index(self.subtraces, t)

    def __getitem__(self, addr):
        """trace[(i, ...)] descends into step i; trace[i] alone gives step
        i's return value."""
        path = addr_path(addr)
        head, rest = path[0], path[1:]
        sub = self.get_subtrace(head)
        if not rest:
            return sub.get_retval()
        return sub[rest if len(rest) > 1 else rest[0]]

    def project(self, selection: Selection):
        if isinstance(selection, (EmptySelection, AllSelection)):
            return torch.sum(torch.func.vmap(
                lambda tr: tr.project(selection))(self.subtraces))
        total = 0.0
        for t in range(self.length):
            total = total + self.get_subtrace(t).project(
                selection.subselection(t))
        return total


def _unfoldtrace_flatten(tr: UnfoldTrace):
    args_dyn, args_aux = split_static(tr.args, tr.args_mask)
    return ([args_dyn, tr.subtraces, tr.score, tr.retval],
            (tr.gen_fn, tr.length, args_aux))


def _unfoldtrace_unflatten(children, aux):
    gen_fn, length, args_aux = aux
    args_dyn, subtraces, score, retval = children
    return UnfoldTrace(gen_fn, join_static(args_dyn, args_aux), subtraces,
                       score, retval, length, args_aux[1])


pytree.register_pytree_node(
    UnfoldTrace, _unfoldtrace_flatten, _unfoldtrace_unflatten,
    serialized_type_name="gen_tpu_torch.UnfoldTrace")


def _step_selections(selection: Selection, length: int):
    """Each step's selection; raises where gen_tpu lowers the per-step
    selections onto a masked selection (they differ between steps and
    every one is statically enumerable)."""
    if isinstance(selection, (AllSelection, EmptySelection)):
        return [selection] * length
    sels = [selection.subselection(t) for t in range(length)]
    try:
        sigs = [selection_signature(s) for s in sels]
        if all(s == sigs[0] for s in sigs[1:]):
            return sels
        for s in sels:
            static_leaf_paths(s)
    except NotImplementedError:
        return sels          # gen_tpu's per-step fallback
    raise NotImplementedError(
        "Unfold.regenerate with per-step selections that differ needs a "
        "masked selection, which comes with masked.py (ROADMAP queue 1 "
        "item 5)")


class UnfoldCombinator(GenerativeFunction):
    """``UnfoldCombinator(kernel)``; args = (T, init_state, *params)."""

    def __init__(self, kernel: GenerativeFunction):
        self.kernel = kernel

    # structural equality: combinators built inline must compare equal
    # across replays of a model body
    def __eq__(self, other):
        return type(other) is type(self) and other.kernel == self.kernel

    def __hash__(self):
        return hash((type(self), self.kernel))

    def __repr__(self):
        return f"Unfold({self.kernel!r})"

    @staticmethod
    def _split_args(args: Tuple):
        length = args[0]
        if not isinstance(length, int):
            raise TypeError(
                "Unfold length must be a static Python int (it fixes the "
                "trace shape)")
        return length, args[1], tuple(args[2:])

    def _make_trace(self, args, subtraces, length):
        score = torch.sum(subtraces.get_score())
        return UnfoldTrace(self, args, subtraces, score,
                           subtraces.get_retval(), length)

    @staticmethod
    def _constraint(kind, payload, t):
        if kind == "sparse":
            return payload.get(t, ChoiceMap())
        if kind == "dense":
            return payload.get_submap(t)
        return ChoiceMap()

    # -- GFI --------------------------------------------------------------

    def simulate(self, key, args: Tuple) -> UnfoldTrace:
        length, init_state, params = self._split_args(args)
        dev = key.device
        keys = random.split(key, length)
        state, subs = as_state(init_state, dev), []
        for t in range(length):
            sub = self.kernel.simulate(keys[t],
                                       (step_index(t, dev), state) + params)
            subs.append(sub)
            state = sub.get_retval()
        return self._make_trace(args, tree_stack(subs), length)

    def generate(self, key, args: Tuple, constraints: ChoiceMap = None):
        length, init_state, params = self._split_args(args)
        kind, payload = try_densify(constraints, length)
        dev = key.device
        if kind == "empty":
            return self.simulate(key, args), _zero(dev)
        keys = random.split(key, length)
        state, subs, weights = as_state(init_state, dev), [], []
        for t in range(length):
            sub, w = self.kernel.generate(
                keys[t], (step_index(t, dev), state) + params,
                self._constraint(kind, payload, t))
            subs.append(sub)
            weights.append(w)
            state = sub.get_retval()
        return (self._make_trace(args, tree_stack(subs), length),
                torch.sum(torch.stack(weights)))

    def assess(self, args: Tuple, choices: ChoiceMap):
        length, init_state, params = self._split_args(args)
        kind, payload = try_densify(choices, length)
        if kind != "dense":
            raise ValueError("Unfold.assess requires choices at every step")
        dev = pytree.tree_leaves(payload.inner)[0].device
        state, weights, retvals = as_state(init_state, dev), [], []
        for t in range(length):
            w, state = self.kernel.assess(
                (step_index(t, dev), state) + params, payload.get_submap(t))
            weights.append(w)
            retvals.append(state)
        return torch.sum(torch.stack(weights)), tree_stack(retvals)

    def project(self, trace: UnfoldTrace, selection: Selection):
        return trace.project(selection)

    def update(self, key, trace: UnfoldTrace, args: Tuple, argdiffs: Tuple,
               constraints: ChoiceMap):
        length, init_state, params = self._split_args(args)
        prev_length = trace.length
        kind, payload = try_densify(constraints, length)
        dev = trace.score.device
        init_state = as_state(init_state, dev)
        keys = (random.split(key, max(length, 1)) if key is not None
                else None)

        # O(1) extension path (particle filtering): same prefix args,
        # constraints only at the appended steps
        if (length > prev_length
                and isinstance(argdiffs[0], IntDiff)
                and all(d is NoChange for d in argdiffs[1:])):
            touched_old = (set(payload) if kind == "sparse" else
                           set(range(length)) if kind == "dense" else set())
            if not any(t < prev_length for t in touched_old):
                return self._extend(keys, trace, args, payload, kind)

        sub_argdiffs = (NoChange, UnknownChange) + tuple(
            UnknownChange for _ in params)
        if kind in ("empty", "dense") and length == prev_length:
            # gen_tpu's scanned update: discards stacked time-major
            state, subs, weights, discards = init_state, [], [], []
            for t in range(length):
                sub, w, _, d = self.kernel.update(
                    None if keys is None else keys[t], trace.get_subtrace(t),
                    (step_index(t, dev), state) + params, sub_argdiffs,
                    self._constraint(kind, payload, t))
                subs.append(sub)
                weights.append(w)
                discards.append(d)
                state = sub.get_retval()
            discard = (ChoiceMap() if all(d.is_empty() for d in discards)
                       else VectorChoiceMap(tree_stack(discards), length))
            return (self._make_trace(args, tree_stack(subs), length),
                    torch.sum(torch.stack(weights)), UnknownChange, discard)

        # sparse constraints and/or a length change
        state, subs, weight = init_state, [], _zero(dev)
        discard = ChoiceMap()
        for t in range(length):
            c_t = self._constraint(kind, payload, t)
            k_t = None if keys is None else keys[t]
            t_arg = (step_index(t, dev), state) + params
            if t < prev_length:
                sub, w, _, d = self.kernel.update(
                    k_t, trace.get_subtrace(t), t_arg, sub_argdiffs, c_t)
                if not d.is_empty():
                    discard.set_submap(t, d)
            else:
                sub, w = self.kernel.generate(k_t, t_arg, c_t)
            subs.append(sub)
            weight = weight + w
            state = sub.get_retval()
        for t in range(length, prev_length):
            old = trace.get_subtrace(t)
            weight = weight - old.get_score()
            ch = old.get_choices()
            if not ch.is_empty():
                discard.set_submap(t, ch)
        return (self._make_trace(args, tree_stack(subs), length), weight,
                UnknownChange, discard)

    def _extend(self, keys, trace: UnfoldTrace, args, payload, kind):
        """Append steps prev_length..length-1 without touching the
        prefix."""
        length, init_state, params = self._split_args(args)
        prev_length = trace.length
        dev = trace.score.device
        state = (tree_index(trace.retval, prev_length - 1)
                 if prev_length > 0 else as_state(init_state, dev))
        new_subs, weight = [], _zero(dev)
        for t in range(prev_length, length):
            sub, w = self.kernel.generate(
                keys[t - prev_length], (step_index(t, dev), state) + params,
                self._constraint(kind, payload, t))
            new_subs.append(sub)
            weight = weight + w
            state = sub.get_retval()
        subtraces = pytree.tree_map(lambda a, b: torch.cat([a, b]),
                                    trace.subtraces, tree_stack(new_subs))
        return (self._make_trace(args, subtraces, length), weight,
                UnknownChange, ChoiceMap())

    def regenerate(self, key, trace: UnfoldTrace, args: Tuple,
                   argdiffs: Tuple, selection: Selection):
        length, init_state, params = self._split_args(args)
        if length != trace.length:
            raise NotImplementedError(
                "Unfold.regenerate with length change: use update")
        sels = _step_selections(selection, length)
        dev = key.device
        keys = random.split(key, length)
        sub_argdiffs = (NoChange, UnknownChange) + tuple(
            UnknownChange for _ in params)
        state, subs, weights = as_state(init_state, dev), [], []
        for t in range(length):
            sub, w, _ = self.kernel.regenerate(
                keys[t], trace.get_subtrace(t),
                (step_index(t, dev), state) + params, sub_argdiffs, sels[t])
            subs.append(sub)
            weights.append(w)
            state = sub.get_retval()
        return (self._make_trace(args, tree_stack(subs), length),
                torch.sum(torch.stack(weights)), UnknownChange)


def Unfold(kernel: GenerativeFunction) -> UnfoldCombinator:
    return UnfoldCombinator(kernel)
