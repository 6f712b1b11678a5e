"""GenFn: the ``@gen`` generative function.

Counterpart: ``gen_tpu/dynamic/fn.py``. The body runs eagerly under a
handler; ``torch.func.vmap`` batches it over keys and ``torch.func.grad``
differentiates ``assess``, where gen_tpu relies on ``jax.vmap``/``jax.grad``.
Ported: ``simulate``, ``generate``, ``assess``, ``project``, ``update``
(with the deletion pass, the discard and the not-visited check),
``regenerate``, ``propose`` (the default, through ``simulate``), the
gradient metadata (``get_params``, ``accepts_output_grad``,
``has_argument_grads``) and the parameter store with its gradient
accumulators (``init_param``, ``get_param``, ``set_param``,
``get_param_grad``, ``zero_param_grad``, ``set_param_grad``).
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from ..choice_map import ChoiceMap
from ..diff import UnknownChange
from ..gfi import GenerativeFunction
from ..selection import Selection
from .handlers import (AssessHandler, GenerateHandler, RegenerateHandler,
                       SimulateHandler, UpdateHandler, active_handler)
from .params import current_params
from .trace import ChoiceRecord, DynamicTrace


def _trace(gen_fn, args, retval, h) -> DynamicTrace:
    """The trace a handler recorded. The score and noise accumulators are
    still the CPU scalars they started as when the body traced nothing;
    they move to the device of the body's arguments or return
    value, and the noise to the score's, so that a batch of such traces
    lives on one device: one index tensor gathers every leaf (resampling
    does), and a mask on the card selects between two of them (Recurse's
    aggregation traces, which hold no choice)."""
    score = h.score
    if not h.records:
        for x in pytree.tree_leaves((args, retval)):
            if isinstance(x, torch.Tensor) and x.device.type != "cpu":
                score = score.to(x.device)
                break
    return DynamicTrace(gen_fn, args, retval, score,
                        h.noise.to(score.device), h.records)


class GenFn(GenerativeFunction):
    """A generative function defined by a traced Python body."""

    def __init__(self, fn, name: Optional[str] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "gen_fn")
        self.params: Dict[str, Any] = {}
        self.params_grad: Dict[str, Any] = {}
        # trailing default arguments are filled in, so the trace stores
        # canonical full args
        try:
            ps = list(inspect.signature(fn).parameters.values())
            self._variadic = any(
                p.kind is inspect.Parameter.VAR_POSITIONAL for p in ps)
            positional = [p for p in ps if p.kind in (
                inspect.Parameter.POSITIONAL_ONLY,
                inspect.Parameter.POSITIONAL_OR_KEYWORD)]
            self._n_positional = len(positional)
            self._defaults = tuple(
                p.default for p in positional
                if p.default is not inspect.Parameter.empty)
        except (ValueError, TypeError):
            self._variadic, self._n_positional, self._defaults = True, 0, ()

    def fill_args(self, args: Tuple) -> Tuple:
        """Append declared defaults for omitted trailing arguments."""
        args = tuple(args)
        if self._variadic or not self._defaults \
                or len(args) >= self._n_positional:
            return args
        missing = self._n_positional - len(args)
        if missing > len(self._defaults):
            return args  # too few args: let Python raise naturally
        return args + self._defaults[len(self._defaults) - missing:]

    def run_body(self, args):
        return self.fn(*args)

    def get_params(self):
        return tuple(self.params.keys())

    def accepts_output_grad(self) -> bool:
        return True

    def has_argument_grads(self):
        # arguments of inexact dtype are differentiable
        return None

    def __repr__(self):
        return f"@gen {self.name}"

    def simulate(self, key, args: Tuple) -> DynamicTrace:
        args = self.fill_args(args)
        with SimulateHandler(key, current_params(self)) as h:
            retval = self.run_body(args)
        return _trace(self, args, retval, h)

    def generate(self, key, args: Tuple,
                 constraints: Optional[ChoiceMap] = None):
        constraints = constraints if constraints is not None else ChoiceMap()
        args = self.fill_args(args)
        with GenerateHandler(key, constraints, current_params(self)) as h:
            retval = self.run_body(args)
        return _trace(self, args, retval, h), h.weight

    def assess(self, args: Tuple, choices: ChoiceMap, params=None):
        args = self.fill_args(args)
        with AssessHandler(choices, current_params(self) if params is None
                           else params) as h:
            retval = self.run_body(args)
            unconsumed = [a for a in choices.addresses()
                          if not h.visitor.covers(a)]
        if unconsumed:
            raise ValueError(
                f"assess: choices at {unconsumed!r} were not visited")
        return h.weight, retval

    def project(self, trace: DynamicTrace, selection: Selection):
        return trace.project(selection)

    def update(self, key, trace: DynamicTrace, args: Tuple, argdiffs: Tuple,
               constraints: ChoiceMap):
        args = self.fill_args(args)
        with UpdateHandler(key, trace, constraints,
                           current_params(self)) as h:
            retval = self.run_body(args)
        weight = h.weight
        discard = h.discard
        # deletion pass: previous records not visited again leave the
        # trace; their scores leave the weight and their choices go to the
        # discard
        visited = h.visitor
        for path, rec in trace.records.items():
            if path not in visited.paths:
                weight = weight - rec.score
                if isinstance(rec, ChoiceRecord):
                    discard.set_value(path, rec.value)
                else:
                    sub_choices = rec.subtrace.get_choices()
                    if not sub_choices.is_empty():
                        discard.set_submap(path, sub_choices)
        unconsumed = [a for a in constraints.addresses()
                      if not visited.covers(a)]
        if unconsumed:
            raise ValueError(
                f"update: did not visit constraints at {unconsumed!r}")
        new_trace = _trace(self, args, retval, h)
        return new_trace, weight, UnknownChange, discard

    def regenerate(self, key, trace: DynamicTrace, args: Tuple,
                   argdiffs: Tuple, selection: Selection):
        args = self.fill_args(args)
        with RegenerateHandler(key, trace, selection,
                               current_params(self)) as h:
            retval = self.run_body(args)
        weight = h.weight
        # calls that were not visited again leave with their noise
        for path, rec in trace.records.items():
            if path not in h.visitor.paths and not isinstance(
                    rec, ChoiceRecord):
                weight = weight - rec.noise
        new_trace = _trace(self, args, retval, h)
        return new_trace, weight, UnknownChange


def gen(fn=None, **kwargs):
    """Decorator: ``@gen`` turns a Python function into a :class:`GenFn`.
    The body traces calls with ``dist(args) @ "addr"``,
    ``other_gen_fn(args) @ "addr"``, or ``trace_at(addr, fn, *args)``."""
    if fn is None:
        return lambda f: GenFn(f, **kwargs)
    return GenFn(fn, **kwargs)


def param(name: str):
    """Read a trainable parameter inside a model body."""
    return active_handler().get_param(name)


# -- the parameter store ------------------------------------------------

def init_param(fn: GenFn, name: str, value):
    fn.params[name] = (value if isinstance(value, torch.Tensor)
                       else torch.as_tensor(value,
                                            dtype=torch.get_default_dtype()))
    fn.params_grad[name] = None


def get_param(fn: GenFn, name: str):
    return fn.params[name]


def set_param(fn: GenFn, name: str, value):
    fn.params[name] = value


def get_param_grad(fn: GenFn, name: str):
    """The accumulated gradient of a parameter (zeros if none)."""
    g = fn.params_grad.get(name)
    if g is None:
        return pytree.tree_map(torch.zeros_like, fn.params[name])
    return g


def zero_param_grad(fn: GenFn, name: str):
    fn.params_grad[name] = None


def set_param_grad(fn: GenFn, name: str, grad):
    fn.params_grad[name] = grad

