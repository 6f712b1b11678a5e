"""choice_at / call_at: wrap a distribution or generative function so that
its choices live under an extra address component.

Counterpart: ``gen_tpu/combinators/at.py``. The key is the trailing
argument and must be a concrete Python value (it fixes the trace's
structure, as in gen_tpu, where addresses are static under jit).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.utils._pytree as pytree

from ..choice_map import ChoiceMap
from ..diff import UnknownChange
from ..dists.distribution import Distribution
from ..gfi import GenerativeFunction, Trace
from ..selection import Selection
from ..utils import join_static, split_static


class ChoiceAtTrace(Trace):
    __slots__ = ("gen_fn", "args", "key_arg", "value", "score", "args_mask")

    def __init__(self, gen_fn, args, key_arg, value, score, args_mask=None):
        self.gen_fn = gen_fn
        self.args = args
        self.key_arg = key_arg
        self.value = value
        self.score = score
        self.args_mask = args_mask

    def get_args(self):
        return self.args + (self.key_arg,)

    def get_retval(self):
        return self.value

    def get_score(self):
        return self.score

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self):
        return ChoiceMap().set_value(self.key_arg, self.value)

    def project(self, selection: Selection):
        if (self.key_arg,) in selection:
            return self.score
        return torch.zeros_like(self.score)


def _cat_flatten(t: ChoiceAtTrace):
    args_dyn, args_aux = split_static(t.args, t.args_mask)
    return [args_dyn, t.value, t.score], (t.gen_fn, t.key_arg, args_aux)


def _cat_unflatten(c, aux):
    gen_fn, key_arg, args_aux = aux
    return ChoiceAtTrace(gen_fn, join_static(c[0], args_aux), key_arg, c[1],
                         c[2], args_aux[1])


pytree.register_pytree_node(
    ChoiceAtTrace, _cat_flatten, _cat_unflatten,
    serialized_type_name="gen_tpu_torch.ChoiceAtTrace")


class ChoiceAtCombinator(GenerativeFunction):
    """``choice_at(dist)``: args = (*dist_args, key)."""

    def __init__(self, dist: Distribution):
        self.dist = dist

    def __repr__(self):
        return f"choice_at({self.dist!r})"

    def _split(self, args: Tuple):
        return tuple(args[:-1]), args[-1]

    def simulate(self, key, args: Tuple):
        dargs, k_addr = self._split(args)
        v = self.dist.sample(key, *dargs)
        return ChoiceAtTrace(self, dargs, k_addr, v,
                             self.dist.logpdf(v, *dargs))

    def generate(self, key, args: Tuple, constraints: ChoiceMap = None):
        dargs, k_addr = self._split(args)
        constraints = constraints if constraints is not None else ChoiceMap()
        if constraints.has_value(k_addr):
            v = constraints.get_value(k_addr)
            s = self.dist.logpdf(v, *dargs)
            return ChoiceAtTrace(self, dargs, k_addr, v, s), s
        trace = self.simulate(key, args)
        return trace, torch.zeros_like(trace.score)

    def assess(self, args: Tuple, choices: ChoiceMap):
        dargs, k_addr = self._split(args)
        v = choices.get_value(k_addr)
        return self.dist.logpdf(v, *dargs), v

    def project(self, trace: ChoiceAtTrace, selection: Selection):
        return trace.project(selection)

    def update(self, key, trace: ChoiceAtTrace, args: Tuple, argdiffs: Tuple,
               constraints: ChoiceMap):
        dargs, k_addr = self._split(args)
        constrained = constraints is not None and constraints.has_value(k_addr)
        if k_addr != trace.key_arg:
            # key changed: the old choice is discarded, the new one is
            # constrained or fresh
            if constrained:
                v = constraints.get_value(k_addr)
                s = self.dist.logpdf(v, *dargs)
                weight = s - trace.score
            else:
                v = self.dist.sample(key, *dargs)
                s = self.dist.logpdf(v, *dargs)
                weight = -trace.score
            discard = ChoiceMap().set_value(trace.key_arg, trace.value)
            return (ChoiceAtTrace(self, dargs, k_addr, v, s), weight,
                    UnknownChange, discard)
        if constrained:
            v = constraints.get_value(k_addr)
            discard = ChoiceMap().set_value(k_addr, trace.value)
        else:
            v = trace.value
            discard = ChoiceMap()
        s = self.dist.logpdf(v, *dargs)
        return (ChoiceAtTrace(self, dargs, k_addr, v, s), s - trace.score,
                UnknownChange, discard)

    def regenerate(self, key, trace: ChoiceAtTrace, args: Tuple,
                   argdiffs: Tuple, selection: Selection):
        dargs, k_addr = self._split(args)
        if (k_addr,) in selection or k_addr != trace.key_arg:
            v = self.dist.sample(key, *dargs)
            s = self.dist.logpdf(v, *dargs)
            weight = torch.zeros_like(s)
        else:
            v = trace.value
            s = self.dist.logpdf(v, *dargs)
            weight = s - trace.score
        return ChoiceAtTrace(self, dargs, k_addr, v, s), weight, UnknownChange


class CallAtTrace(Trace):
    __slots__ = ("gen_fn", "key_arg", "inner_trace")

    def __init__(self, gen_fn, key_arg, inner_trace):
        self.gen_fn = gen_fn
        self.key_arg = key_arg
        self.inner_trace = inner_trace

    def get_args(self):
        return self.inner_trace.get_args() + (self.key_arg,)

    def get_retval(self):
        return self.inner_trace.get_retval()

    def get_score(self):
        return self.inner_trace.get_score()

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self):
        inner = self.inner_trace.get_choices()
        out = ChoiceMap()
        if not inner.is_empty():
            out.set_submap(self.key_arg, inner)
        return out

    def project(self, selection: Selection):
        return self.inner_trace.project(selection.subselection(self.key_arg))


pytree.register_pytree_node(
    CallAtTrace, lambda t: ([t.inner_trace], (t.gen_fn, t.key_arg)),
    lambda c, aux: CallAtTrace(aux[0], aux[1], c[0]),
    serialized_type_name="gen_tpu_torch.CallAtTrace")


class CallAtCombinator(GenerativeFunction):
    """``call_at(fn)``: args = (*fn_args, key)."""

    def __init__(self, fn: GenerativeFunction):
        self.fn = fn

    def __repr__(self):
        return f"call_at({self.fn!r})"

    def _split(self, args: Tuple):
        return tuple(args[:-1]), args[-1]

    def simulate(self, key, args: Tuple):
        fargs, k_addr = self._split(args)
        return CallAtTrace(self, k_addr, self.fn.simulate(key, fargs))

    def generate(self, key, args: Tuple, constraints: ChoiceMap = None):
        fargs, k_addr = self._split(args)
        sub_cons = (constraints.get_submap(k_addr)
                    if constraints is not None else ChoiceMap())
        inner, w = self.fn.generate(key, fargs, sub_cons)
        return CallAtTrace(self, k_addr, inner), w

    def assess(self, args: Tuple, choices: ChoiceMap):
        fargs, k_addr = self._split(args)
        return self.fn.assess(fargs, choices.get_submap(k_addr))

    def project(self, trace: CallAtTrace, selection: Selection):
        return trace.project(selection)

    def update(self, key, trace: CallAtTrace, args: Tuple, argdiffs: Tuple,
               constraints: ChoiceMap):
        fargs, k_addr = self._split(args)
        sub_cons = (constraints.get_submap(k_addr)
                    if constraints is not None else ChoiceMap())
        if k_addr != trace.key_arg:
            inner, w = self.fn.generate(key, fargs, sub_cons)
            return (CallAtTrace(self, k_addr, inner), w - trace.get_score(),
                    UnknownChange, trace.get_choices())
        inner, w, retdiff, sub_discard = self.fn.update(
            key, trace.inner_trace, fargs,
            tuple(UnknownChange for _ in fargs), sub_cons)
        discard = ChoiceMap()
        if not sub_discard.is_empty():
            discard.set_submap(k_addr, sub_discard)
        return CallAtTrace(self, k_addr, inner), w, retdiff, discard

    def regenerate(self, key, trace: CallAtTrace, args: Tuple,
                   argdiffs: Tuple, selection: Selection):
        fargs, k_addr = self._split(args)
        if k_addr != trace.key_arg:
            inner, w = self.fn.generate(key, fargs, ChoiceMap())
            return (CallAtTrace(self, k_addr, inner),
                    w - trace.project(selection.complement()), UnknownChange)
        inner, w, retdiff = self.fn.regenerate(
            key, trace.inner_trace, fargs,
            tuple(UnknownChange for _ in fargs),
            selection.subselection(k_addr))
        return CallAtTrace(self, k_addr, inner), w, retdiff


def choice_at(dist: Distribution) -> ChoiceAtCombinator:
    return ChoiceAtCombinator(dist)


def call_at(fn: GenerativeFunction) -> CallAtCombinator:
    return CallAtCombinator(fn)
