"""Map combinator: independent application of a kernel over vectors of
arguments.

Counterpart: ``gen_tpu/combinators/map_combinator.py``. Every GFI method is
one ``torch.func.vmap`` of the kernel's method over the element axis, and
the trace is one pytree whose leaves carry a leading element axis; element
i's choices live under integer key i. Ported: the dense paths of
``simulate``, ``generate``, ``assess``, ``update`` and ``regenerate``
(ALL, NONE, or a selection that is the same for every element),
``project`` (a per-element loop where the selections differ), and
structural ``__eq__``/``__hash__``.

Not ported yet (ROADMAP queue 1 item 5), each raising
``NotImplementedError`` where gen_tpu would take it: sparse (per-index)
constraints, which gen_tpu lowers onto one masked dense vmap
(``densify_masked``), and element-varying selections in ``regenerate``,
which it batches into a masked selection (``batch_selections``), both
with ``masked.py``; and ``update`` with a length change, gen_tpu's
per-element loop.
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
from ..selection import (AllSelection, EmptySelection, Selection,
                         selection_signature)
from ..utils import join_static, split_static
from .vector import VectorChoiceMap, tree_index, try_densify

_NOT_PORTED = "is not ported yet (ROADMAP queue 1 item 5)"


def _shared_selection(selection: Selection, length: int):
    """The one selection every element sees, or None where the elements'
    selections differ."""
    if isinstance(selection, (AllSelection, EmptySelection)):
        return selection
    sels = [selection.subselection(i) for i in range(length)]
    sig = selection_signature(sels[0])
    if all(selection_signature(s) == sig for s in sels[1:]):
        return sels[0]
    return None


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
        shared = _shared_selection(selection, self.length)
        if shared is not None:
            return torch.sum(vmap(lambda t: t.project(shared))(
                self.subtraces))
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


def _refuse_sparse(kind: str, what: str):
    if kind == "sparse":
        raise NotImplementedError(
            f"Map.{what} with sparse (per-index) constraints, gen_tpu's "
            f"masked dense pass (masked.py), {_NOT_PORTED}")


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
        _refuse_sparse(kind, "generate")
        keys = random.split(key, n)
        if kind == "empty":
            subtraces = vmap(lambda k, a: self.kernel.simulate(k, a))(
                keys, args)
            return (self._make_trace(args, subtraces, n),
                    torch.zeros((), device=keys.device))
        subtraces, weights = vmap(
            lambda k, a, c: self.kernel.generate(k, a, c))(
                keys, args, payload.inner)
        return self._make_trace(args, subtraces, n), torch.sum(weights)

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
        if n != trace.length:
            raise NotImplementedError(
                f"Map.update with a length change (gen_tpu's per-element "
                f"loop) {_NOT_PORTED}")
        keys = random.split(key, n) if key is not None else None
        kind, payload = try_densify(constraints, n)
        _refuse_sparse(kind, "update")
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
        return (self._make_trace(args, new_subs, n), torch.sum(weights),
                UnknownChange, discard)

    def regenerate(self, key, trace: MapTrace, args: Tuple, argdiffs: Tuple,
                   selection: Selection):
        n = _length_of(args)
        if n != trace.length:
            raise NotImplementedError(
                "Map.regenerate with length change: use update")
        shared = _shared_selection(selection, n)
        if shared is None:
            raise NotImplementedError(
                f"Map.regenerate with element-varying selections, gen_tpu's "
                f"batched masked selection (masked.py), {_NOT_PORTED}")

        def one(k, prev, a):
            new_sub, w, _ = self.kernel.regenerate(
                k, prev, a, all_unknown_change(a), shared)
            return new_sub, w

        new_subs, weights = vmap(one)(random.split(key, n), trace.subtraces,
                                      args)
        return (self._make_trace(args, new_subs, n), torch.sum(weights),
                UnknownChange)


def Map(kernel: GenerativeFunction) -> MapCombinator:
    return MapCombinator(kernel)
