"""Map combinator: independent application of a kernel over vectors of
arguments.

Counterpart: ``gen_tpu/combinators/map_combinator.py``. Every GFI method is
one ``torch.func.vmap`` of the kernel's method over the element axis, and
the trace is one pytree whose leaves carry a leading element axis; element
i's choices live under integer key i. Dense constraints (a
:class:`VectorChoiceMap`, or an int-keyed map with one structure at every
element) take the vmapped path; sparse (per-index) constraints are lowered
onto one masked dense vmap (``densify_masked``) where they stack, and
element-varying selections onto a batched masked selection
(``batch_selections``); what does not lower runs gen_tpu's per-element
loop, as does ``update`` with a length change.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from .. import random
from ..address import addr_path
from ..choice_map import ChoiceMap
from ..diff import UnknownChange, all_unknown_change
from ..gfi import GenerativeFunction, Trace
from ..selection import Selection
from ..utils import join_static, split_static
from .vector import (VectorChoiceMap, densify_masked, lane_selections,
                     sparsify_masked, tree_index, tree_stack, try_densify)



class MapTrace(Trace):
    __slots__ = ("gen_fn", "args", "subtraces", "score", "retval", "length",
                 "args_mask")

    def __init__(self, gen_fn, args, subtraces, score, retval, length,
                 args_mask=None):
        self.gen_fn = gen_fn
        self.args = args
        self.subtraces = subtraces  # ONE batched subtrace pytree
        self.score = score
        self.retval = retval
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

    def get_subtrace(self, i):
        return tree_index(self.subtraces, i)

    def __getitem__(self, addr):
        """trace[(i, ...)] descends into element i; trace[i] alone gives
        element i's return value."""
        path = addr_path(addr)
        head, rest = path[0], path[1:]
        sub = self.get_subtrace(head)
        if not rest:
            return sub.get_retval()
        return sub[rest if len(rest) > 1 else rest[0]]

    def project(self, selection: Selection):
        shared, masked = lane_selections(selection, self.length,
                                          self.score.device)
        if shared is not None or masked is not None:
            return torch.sum(vmap(
                lambda t, s: t.project(s),
                in_dims=(0, None if masked is None else 0))(
                self.subtraces, shared if masked is None else masked))
        total = 0.0
        for i in range(self.length):
            total = total + self.get_subtrace(i).project(
                selection.subselection(i))
        return total


def _maptrace_flatten(tr: MapTrace):
    args_dyn, args_aux = split_static(tr.args, tr.args_mask)
    return ([args_dyn, tr.subtraces, tr.score, tr.retval],
            (tr.gen_fn, tr.length, args_aux))


def _maptrace_unflatten(children, aux):
    gen_fn, length, args_aux = aux
    args_dyn, subtraces, score, retval = children
    return MapTrace(gen_fn, join_static(args_dyn, args_aux), subtraces,
                    score, retval, length, args_aux[1])


pytree.register_pytree_node(
    MapTrace, _maptrace_flatten, _maptrace_unflatten,
    serialized_type_name="gen_tpu_torch.MapTrace")


def _length_of(args: Tuple) -> int:
    leaves = [x for x in pytree.tree_leaves(args)
              if isinstance(x, torch.Tensor)]
    if not leaves:
        raise ValueError("Map requires at least one vectorized argument")
    return int(leaves[0].shape[0])


class MapCombinator(GenerativeFunction):
    """``MapCombinator(kernel)``: args are pytrees whose leaves have a
    leading element axis; the kernel is applied independently per
    element."""

    def __init__(self, kernel: GenerativeFunction):
        self.kernel = kernel

    # structural equality: ``Map(f)`` built inline in a model body is a new
    # instance on every replay, and the instance rides in the trace's
    # pytree spec
    def __eq__(self, other):
        return type(other) is type(self) and other.kernel == self.kernel

    def __hash__(self):
        return hash((type(self), self.kernel))

    def __repr__(self):
        return f"Map({self.kernel!r})"

    def _make_trace(self, args, subtraces, length):
        score = torch.sum(subtraces.get_score())
        return MapTrace(self, args, subtraces, score,
                        subtraces.get_retval(), length)

    # -- GFI --------------------------------------------------------------

    def simulate(self, key, args: Tuple) -> MapTrace:
        n = _length_of(args)
        keys = random.split(key, n)
        subtraces = vmap(lambda k, a: self.kernel.simulate(k, a))(keys, args)
        return self._make_trace(args, subtraces, n)

    def generate(self, key, args: Tuple, constraints: ChoiceMap = None):
        n = _length_of(args)
        kind, payload = try_densify(constraints, n)
        if kind == "sparse":
            # lower onto ONE masked-dense vmapped generate when stackable
            dense = densify_masked(payload, n)
            if dense is not None:
                kind, payload = "dense", dense
        keys = random.split(key, n)
        if kind == "empty":
            subtraces = vmap(lambda k, a: self.kernel.simulate(k, a))(
                keys, args)
            return (self._make_trace(args, subtraces, n),
                    torch.zeros((), device=keys.device))
        if kind == "dense":
            subtraces, weights = vmap(
                lambda k, a, c: self.kernel.generate(k, a, c))(
                    keys, args, payload.inner)
            return self._make_trace(args, subtraces, n), torch.sum(weights)
        # sparse: per-element loop, stacked
        subs, weights = [], []
        for i in range(n):
            sub, w = self.kernel.generate(
                keys[i], tree_index(args, i), payload.get(i, ChoiceMap()))
            subs.append(sub)
            weights.append(w)
        return (self._make_trace(args, tree_stack(subs), n),
                torch.sum(torch.stack(weights)))

    def assess(self, args: Tuple, choices: ChoiceMap):
        n = _length_of(args)
        kind, payload = try_densify(choices, n)
        if kind != "dense":
            raise ValueError("Map.assess requires choices for every element")
        weights, retvals = vmap(lambda a, c: self.kernel.assess(a, c))(
            args, payload.inner)
        return torch.sum(weights), retvals

    def project(self, trace: MapTrace, selection: Selection):
        return trace.project(selection)

    def update(self, key, trace: MapTrace, args: Tuple, argdiffs: Tuple,
               constraints: ChoiceMap):
        n = _length_of(args)
        keys = random.split(key, n) if key is not None else None
        kind, payload = try_densify(constraints, n)
        lowered = False
        if kind == "sparse" and n == trace.length:
            dense = densify_masked(payload, n)
            if dense is not None:
                kind, payload, lowered = "dense", dense, True
        if n == trace.length and kind in ("empty", "dense"):
            dense = kind == "dense"

            def one(k, prev, a, c):
                new_sub, w, _, d = self.kernel.update(
                    k, prev, a, all_unknown_change(a), c)
                return new_sub, w, d

            new_subs, weights, discards = vmap(
                one, in_dims=(None if key is None else 0, 0, 0,
                              0 if dense else None))(
                keys, trace.subtraces, args,
                payload.inner if dense else ChoiceMap())
            discard = (VectorChoiceMap(discards, n)
                       if not discards.is_empty() else ChoiceMap())
            if lowered and not discards.is_empty():
                # unmask the discard back to sparse plain values (the
                # reference discard)
                sparse_d = sparsify_masked(discards, n)
                if sparse_d is not None:
                    discard = sparse_d
            return (self._make_trace(args, new_subs, n), torch.sum(weights),
                    UnknownChange, discard)
        # sparse or length-changing path: per-element loop
        new_subs = []
        discard = ChoiceMap()
        weight = torch.zeros((), device=trace.score.device)
        for i in range(n):
            a_i = tree_index(args, i)
            c_i = (payload.get(i, ChoiceMap()) if kind == "sparse"
                   else (payload.get_submap(i) if kind == "dense"
                         else ChoiceMap()))
            k_i = None if keys is None else keys[i]
            if i < trace.length:
                sub, w, _, d = self.kernel.update(
                    k_i, trace.get_subtrace(i), a_i,
                    all_unknown_change(a_i), c_i)
                if not d.is_empty():
                    discard.set_submap(i, d)
            else:
                sub, w = self.kernel.generate(k_i, a_i, c_i)
            new_subs.append(sub)
            weight = weight + w
        # deleted elements (n < prev length): subtract scores, discard
        # choices
        for i in range(n, trace.length):
            old = trace.get_subtrace(i)
            weight = weight - old.get_score()
            ch = old.get_choices()
            if not ch.is_empty():
                discard.set_submap(i, ch)
        return (self._make_trace(args, tree_stack(new_subs), n), weight,
                UnknownChange, discard)

    def regenerate(self, key, trace: MapTrace, args: Tuple, argdiffs: Tuple,
                   selection: Selection):
        n = _length_of(args)
        if n != trace.length:
            raise NotImplementedError(
                "Map.regenerate with length change: use update")
        keys = random.split(key, n)
        # per-element subselections on one vmappable form: a shared
        # closed-over subselection when uniform, a batched MaskedSelection
        # when element-varying
        shared, masked = lane_selections(selection, n, keys.device)
        if shared is not None or masked is not None:
            def one(k, prev, a, s):
                new_sub, w, _ = self.kernel.regenerate(
                    k, prev, a, all_unknown_change(a), s)
                return new_sub, w
            new_subs, weights = vmap(
                one, in_dims=(0, 0, 0, None if masked is None else 0))(
                keys, trace.subtraces, args,
                shared if masked is None else masked)
            return (self._make_trace(args, new_subs, n), torch.sum(weights),
                    UnknownChange)
        # selections that are not statically enumerable: per element
        new_subs, weight = [], torch.zeros((), device=keys.device)
        for i in range(n):
            a_i = tree_index(args, i)
            sub, w, _ = self.kernel.regenerate(
                keys[i], trace.get_subtrace(i), a_i, all_unknown_change(a_i),
                selection.subselection(i))
            new_subs.append(sub)
            weight = weight + w
        return (self._make_trace(args, tree_stack(new_subs), n), weight,
                UnknownChange)


def Map(kernel: GenerativeFunction) -> MapCombinator:
    return MapCombinator(kernel)
