"""Effect handlers: one per GFI operation.

Counterpart: ``gen_tpu/dynamic/handlers.py``. A model body is plain Python
and torch code; every ``dist(args) @ "addr"`` dispatches to the innermost
active handler, which threads an explicit key (split once per traced call,
in execution order, exactly as gen_tpu does, so both packages draw the same
bits). Ported: ``Simulate``, ``Generate``, ``Assess``, ``Update`` and
``Regenerate`` with their masked branches (a
:class:`~gen_tpu_torch.masked.MaskedValue` constraint, a
:class:`~gen_tpu_torch.masked.MaskedSelection`), and the distribution-call
recorder (:class:`record_dist_calls`) that ``inference/mixed.py``
discovers discrete supports with. The masked branches select with
``torch.where``, so that one vmapped pass serves lanes with any flags.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from .. import random
from ..address import Address, addr_path
from ..choice_map import ChoiceMap
from ..diff import all_unknown_change
from ..dists.distribution import Distribution
from ..masked import MaskedSelection, MaskedValue, flag_on
from ..selection import NONE, Selection
from .trace import CallRecord, ChoiceRecord

_STACK: List["Handler"] = []

# -- distribution-call recorder (support discovery for mixed-model
#    inference, inference/mixed.py). While active, every dist call anywhere
#    in the execution is recorded as (path, dist, args); a combinator's
#    inner calls build their own handlers while the recorder's prefix stack
#    still holds the outer call path. Combinator-inserted integer keys are
#    absent from the recorded paths; consumers match on int-stripped
#    paths. ------------------------------------------------------------


class _DistRecorder:
    __slots__ = ("prefix", "records")

    def __init__(self):
        self.prefix: List[Tuple] = []
        self.records: List[Tuple[Tuple, Distribution, Tuple]] = []

    def full(self, path: Tuple) -> Tuple:
        out: Tuple = ()
        for p in self.prefix:
            out = out + p
        return out + path


_RECORDER: List[_DistRecorder] = []   # at most one active


class record_dist_calls:
    """Context manager: record every distribution call executed inside.
    ``.records`` afterwards holds (path, dist, args) triples; paths omit
    combinator-inserted integer keys."""

    def __enter__(self):
        self._rec = _DistRecorder()
        _RECORDER.append(self._rec)
        return self._rec

    def __exit__(self, *exc):
        assert _RECORDER[-1] is self._rec
        _RECORDER.pop()
        return False


def active_handler() -> "Handler":
    if not _STACK:
        raise RuntimeError(
            "No active handler: traced calls like `dist(args) @ \"addr\"` "
            "are only legal inside a generative function body being "
            "executed by a GFI method (simulate/generate/assess).")
    return _STACK[-1]


def trace_at(addr: Address, fn, *args):
    """Trace a call to a distribution or generative function at an
    address: the explicit form of ``fn(args) @ addr``."""
    return active_handler().handle(addr_path(addr), fn, args)


class Call:
    """The object returned by ``fn(*args)`` inside a model body;
    ``@ addr`` performs the traced call."""

    __slots__ = ("fn", "args")

    def __init__(self, fn, args):
        self.fn = fn
        self.args = args

    def __matmul__(self, addr: Address):
        return trace_at(addr, self.fn, *self.args)

    def __repr__(self):
        return (f"Call({self.fn!r}, {self.args!r}) — did you forget "
                "`@ \"addr\"`?")


class AddressVisitor:
    """Duplicate/conflicting-address detection."""

    __slots__ = ("paths", "_prefixes")

    def __init__(self):
        self.paths = set()
        self._prefixes = set()

    def visit(self, path: Tuple):
        if path in self.paths:
            raise ValueError(f"address {path!r} visited twice")
        if path in self._prefixes:
            raise ValueError(f"address {path!r} conflicts with a longer "
                             "address already traced")
        for i in range(1, len(path)):
            if path[:i] in self.paths:
                raise ValueError(f"address {path!r} conflicts with shorter "
                                 f"address {path[:i]!r}")
        self.paths.add(path)
        for i in range(1, len(path)):
            self._prefixes.add(path[:i])

    def covers(self, path: Tuple) -> bool:
        """True if `path` was visited exactly or lies under a visited call."""
        if path in self.paths:
            return True
        return any(path[:i] in self.paths for i in range(1, len(path)))


def _sel_at_path(sel: Selection, path: Tuple) -> Selection:
    for k in path:
        sel = sel.subselection(k)
    return sel


def _zero():
    # a 0-dim CPU tensor acts as a scalar next to tensors on any device, so
    # the accumulators follow the model's device from the first add
    return torch.zeros((), device="cpu")


class Handler:
    """Base handler: key threading, param resolution, dispatch."""

    def __init__(self, key, params: Dict[str, Any]):
        self.key = key
        self.visitor = AddressVisitor()
        self.params_stack: List[Dict[str, Any]] = [params]

    def __enter__(self):
        _STACK.append(self)
        return self

    def __exit__(self, *exc):
        _STACK.pop()
        return False

    def _next_key(self):
        if self.key is None:
            raise RuntimeError(
                f"{type(self).__name__} has no PRNG key but the model tried "
                "to sample (an address was neither constrained nor "
                "retained)")
        self.key, sub = random.split(self.key)
        return sub

    def _maybe_key(self):
        """Key for a nested GFI call: None propagates (the callee raises
        only if it actually needs to sample)."""
        return None if self.key is None else self._next_key()

    def get_param(self, name: str):
        params = self.params_stack[-1]
        if name not in params:
            raise KeyError(
                f"trainable parameter {name!r} not initialized; call "
                f"init_param(fn, {name!r}, value) first")
        return params[name]

    def splice(self, fn, args):
        """Run another gen fn's body inline, splicing its choices into this
        handler's address space."""
        from .params import current_params
        self.params_stack.append(current_params(fn))
        try:
            return fn.run_body(args)
        finally:
            self.params_stack.pop()

    def handle(self, path: Tuple, fn, args):
        self.visitor.visit(path)
        if isinstance(fn, Distribution):
            if _RECORDER:
                rec = _RECORDER[-1]
                rec.records.append((rec.full(path), fn, args))
            return self.handle_dist(path, fn, args)
        if _RECORDER:
            rec = _RECORDER[-1]
            rec.prefix.append(path)
            try:
                return self.handle_call(path, fn, args)
            finally:
                rec.prefix.pop()
        return self.handle_call(path, fn, args)

    def handle_dist(self, path, dist, args):
        raise NotImplementedError

    def handle_call(self, path, fn, args):
        raise NotImplementedError


class SimulateHandler(Handler):

    def __init__(self, key, params):
        super().__init__(key, params)
        self.records: Dict[Tuple, Any] = {}
        self.score = _zero()
        self.noise = _zero()

    def handle_dist(self, path, dist, args):
        v = dist.sample(self._next_key(), *args)
        s = dist.logpdf(v, *args)
        self.records[path] = ChoiceRecord(v, s)
        self.score = self.score + s
        return v

    def handle_call(self, path, fn, args):
        sub = fn.simulate(self._next_key(), args)
        noise = sub.project(NONE)
        self.records[path] = CallRecord(sub, noise)
        self.score = self.score + sub.get_score()
        self.noise = self.noise + noise
        return sub.get_retval()


class GenerateHandler(Handler):
    """The weight accumulates the scores of constrained choices and the
    weights of sub-generates."""

    def __init__(self, key, constraints: ChoiceMap, params):
        super().__init__(key, params)
        self.constraints = constraints
        self.records: Dict[Tuple, Any] = {}
        self.score = _zero()
        self.noise = _zero()
        self.weight = _zero()

    def handle_dist(self, path, dist, args):
        constrained = self.constraints.has_value(path)
        if not constrained and self.constraints.has_submap(path):
            raise ValueError(
                f"constraints hold a submap at choice address {path!r}")
        if constrained:
            v = self.constraints.get_value(path)
            if isinstance(v, MaskedValue):
                # dynamically present constraint: sample where absent,
                # weight only where present
                sampled = dist.sample(self._next_key(), *args)
                flag = flag_on(v.flag, sampled)
                v = torch.where(flag, torch.as_tensor(v.value), sampled)
                s = dist.logpdf(v, *args)
                self.records[path] = ChoiceRecord(v, s)
                self.score = self.score + s
                self.weight = self.weight + torch.where(flag, s, 0.0)
                return v
        else:
            v = dist.sample(self._next_key(), *args)
        s = dist.logpdf(v, *args)
        self.records[path] = ChoiceRecord(v, s)
        self.score = self.score + s
        if constrained:
            self.weight = self.weight + s
        return v

    def handle_call(self, path, fn, args):
        if self.constraints.has_value(path):
            raise ValueError(
                f"constraints hold a value at call address {path!r}")
        sub_constraints = self.constraints.get_submap(path)
        sub, w = fn.generate(self._maybe_key(), args, sub_constraints)
        noise = sub.project(NONE)
        self.records[path] = CallRecord(sub, noise)
        self.score = self.score + sub.get_score()
        self.noise = self.noise + noise
        self.weight = self.weight + w
        return sub.get_retval()


class AssessHandler(Handler):
    """Every addressed choice must be given; the weight is the full joint
    logpdf. Key-free and differentiable: ``FlatTarget`` differentiates
    through it."""

    def __init__(self, choices: ChoiceMap, params):
        super().__init__(None, params)
        self.choices = choices
        self.weight = _zero()

    def handle_dist(self, path, dist, args):
        if not self.choices.has_value(path):
            raise ValueError(
                f"assess: no value provided for choice at {path!r}")
        v = self.choices.get_value(path)
        self.weight = self.weight + dist.logpdf(v, *args)
        return v

    def handle_call(self, path, fn, args):
        w, retval = fn.assess(args, self.choices.get_submap(path))
        self.weight = self.weight + w
        return retval


class UpdateHandler(Handler):
    """Per-choice weight bookkeeping of ``update``; the deletion term and
    the discard of unvisited records are completed in ``GenFn.update``."""

    def __init__(self, key, prev_trace, constraints: ChoiceMap, params):
        super().__init__(key, params)
        self.prev = prev_trace
        self.constraints = constraints
        self.records: Dict[Tuple, Any] = {}
        self.discard = ChoiceMap()
        self.score = _zero()
        self.noise = _zero()
        self.weight = _zero()

    def handle_dist(self, path, dist, args):
        has_prev = self.prev.has_choice(path)
        constrained = self.constraints.has_value(path)
        if not constrained and self.constraints.has_submap(path):
            raise ValueError(
                f"constraints hold a submap at choice address {path!r}")
        if has_prev:
            prev_rec = self.prev.get_choice(path)
        cons_v = self.constraints.get_value(path) if constrained else None
        if isinstance(cons_v, MaskedValue):
            if has_prev:
                flag = flag_on(cons_v.flag, prev_rec.value)
                v = torch.where(flag, torch.as_tensor(cons_v.value),
                                prev_rec.value)
                self.discard.set_value(path, MaskedValue(prev_rec.value,
                                                         flag))
                s = dist.logpdf(v, *args)
                self.weight = self.weight + s - prev_rec.score
            else:
                sampled = dist.sample(self._next_key(), *args)
                flag = flag_on(cons_v.flag, sampled)
                v = torch.where(flag, torch.as_tensor(cons_v.value),
                                sampled)
                s = dist.logpdf(v, *args)
                self.weight = self.weight + torch.where(flag, s, 0.0)
            self.records[path] = ChoiceRecord(v, s)
            self.score = self.score + s
            return v
        if constrained:
            v = cons_v
            if has_prev:
                self.discard.set_value(path, prev_rec.value)
        elif has_prev:
            v = prev_rec.value
        else:
            v = dist.sample(self._next_key(), *args)
        s = dist.logpdf(v, *args)
        if has_prev:
            self.weight = self.weight + s - prev_rec.score
        elif constrained:
            self.weight = self.weight + s
        self.records[path] = ChoiceRecord(v, s)
        self.score = self.score + s
        return v

    def handle_call(self, path, fn, args):
        if self.constraints.has_value(path):
            raise ValueError(
                f"constraints hold a value at call address {path!r}")
        sub_constraints = self.constraints.get_submap(path)
        if self.prev.has_call(path):
            prev_sub = self.prev.get_call(path).subtrace
            sub, w, _, sub_discard = fn.update(
                self._maybe_key(), prev_sub, args, all_unknown_change(args),
                sub_constraints)
            if not sub_discard.is_empty():
                self.discard.set_submap(path, sub_discard)
        else:
            sub, w = fn.generate(self._maybe_key(), args, sub_constraints)
        noise = sub.project(NONE)
        self.records[path] = CallRecord(sub, noise)
        self.score = self.score + sub.get_score()
        self.noise = self.noise + noise
        self.weight = self.weight + w
        return sub.get_retval()


class RegenerateHandler(Handler):
    """Selected choices are resampled from the prior (their weight
    contribution cancels); retained choices contribute score - prev_score."""

    def __init__(self, key, prev_trace, selection: Selection, params):
        super().__init__(key, params)
        self.prev = prev_trace
        self.selection = selection
        self.records: Dict[Tuple, Any] = {}
        self.score = _zero()
        self.noise = _zero()
        self.weight = _zero()

    def handle_dist(self, path, dist, args):
        if isinstance(self.selection, MaskedSelection):
            return self._handle_masked(path, dist, args)
        keep = self.prev.has_choice(path) and path not in self.selection
        if keep:
            prev_rec = self.prev.get_choice(path)
            v = prev_rec.value
        else:
            v = dist.sample(self._next_key(), *args)
        s = dist.logpdf(v, *args)
        if keep:
            self.weight = self.weight + s - prev_rec.score
        self.records[path] = ChoiceRecord(v, s)
        self.score = self.score + s
        return v

    def _handle_masked(self, path, dist, args):
        """Membership by a per-lane flag: resample where it is set, keep
        and re-score elsewhere, in one branchless pass."""
        if self.prev.has_choice(path):
            prev_rec = self.prev.get_choice(path)
            sampled = dist.sample(self._next_key(), *args)
            flag = flag_on(self.selection.flag_at(path), sampled)
            v = torch.where(flag, sampled, prev_rec.value)
            s = dist.logpdf(v, *args)
            self.weight = self.weight + torch.where(
                flag, 0.0, s - prev_rec.score)
        else:
            v = dist.sample(self._next_key(), *args)
            s = dist.logpdf(v, *args)
        self.records[path] = ChoiceRecord(v, s)
        self.score = self.score + s
        return v

    def handle_call(self, path, fn, args):
        subsel = _sel_at_path(self.selection, path)
        if self.prev.has_call(path):
            prev_sub = self.prev.get_call(path).subtrace
            sub, w, _ = fn.regenerate(
                self._maybe_key(), prev_sub, args, all_unknown_change(args),
                subsel)
        else:
            sub, w = fn.generate(self._maybe_key(), args, ChoiceMap())
        noise = sub.project(NONE)
        self.records[path] = CallRecord(sub, noise)
        self.score = self.score + sub.get_score()
        self.noise = self.noise + noise
        self.weight = self.weight + w
        return sub.get_retval()
