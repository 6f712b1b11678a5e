"""DynamicTrace: the trace of a ``@gen`` generative function.

Counterpart: ``gen_tpu/dynamic/trace.py``. The trace is a
``torch.utils._pytree`` node: the record structure (which addresses exist,
and whether each is a choice or a call), the generative function and the
non-tensor arguments and return values (e.g. a model body that returns
nothing) are the spec; values, scores and subtraces are the leaves. ``torch.func.vmap`` over ``generate`` therefore returns one trace
whose leaves carry the batch dimension, and ``update`` vmapped over traces
reads each particle's records. ``project`` under a
:class:`~gen_tpu_torch.masked.MaskedSelection` sums the scores weighted by
their per-lane flags.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.utils._pytree as pytree

from ..address import Address, addr_path, key_sort_key
from ..choice_map import ChoiceMap
from ..gfi import Trace
from ..masked import MaskedSelection, flag_on
from ..selection import NONE, Selection
from ..utils import join_static, split_static


class ChoiceRecord:
    """A primitive random choice: (value, score)."""

    __slots__ = ("value", "score")

    def __init__(self, value, score):
        self.value = value
        self.score = score


class CallRecord:
    """A generative-function call: the full subtrace plus cached noise
    (= project(subtrace, EmptySelection))."""

    __slots__ = ("subtrace", "noise")

    def __init__(self, subtrace: Trace, noise):
        self.subtrace = subtrace
        self.noise = noise

    @property
    def score(self):
        return self.subtrace.get_score()


pytree.register_pytree_node(
    ChoiceRecord, lambda r: ([r.value, r.score], None),
    lambda children, _: ChoiceRecord(*children),
    serialized_type_name="gen_tpu_torch.ChoiceRecord")
pytree.register_pytree_node(
    CallRecord, lambda r: ([r.subtrace, r.noise], None),
    lambda children, _: CallRecord(*children),
    serialized_type_name="gen_tpu_torch.CallRecord")


def _path_sort_key(path: Tuple) -> Tuple:
    return tuple(key_sort_key(k) for k in path)


class DynamicTrace(Trace):
    """See module docstring."""

    __slots__ = ("gen_fn", "args", "retval", "score", "noise", "records",
                 "args_mask", "retval_mask")

    def __init__(self, gen_fn, args, retval, score, noise,
                 records: Dict[Tuple, Any], args_mask=None,
                 retval_mask=None):
        self.gen_fn = gen_fn
        self.args = args
        self.retval = retval
        self.score = score
        self.noise = noise
        self.records = records  # path tuple -> ChoiceRecord | CallRecord
        self.args_mask = args_mask  # which args are static, once flattened
        self.retval_mask = retval_mask   # the same for the return value

    def get_args(self):
        return self.args

    def get_retval(self):
        return self.retval

    def get_score(self):
        return self.score

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self) -> ChoiceMap:
        out = ChoiceMap()
        for path, rec in self.records.items():
            if isinstance(rec, ChoiceRecord):
                out.set_value(path, rec.value)
            else:
                sub = rec.subtrace.get_choices()
                if not sub.is_empty():
                    out.set_submap(path, sub)
        return out

    def __getitem__(self, addr: Address):
        """Choice value, or a call's return value when the address names a
        call."""
        path = addr_path(addr)
        rec = self.records.get(path)
        if isinstance(rec, ChoiceRecord):
            return rec.value
        if isinstance(rec, CallRecord):
            return rec.subtrace.get_retval()
        for p, r in self.records.items():
            if (isinstance(r, CallRecord) and path[:len(p)] == p
                    and len(path) > len(p)):
                rest = path[len(p):]
                return r.subtrace[rest if len(rest) > 1 else rest[0]]
        raise KeyError(f"no record at address {addr!r}")

    # -- record lookup (used by the update and regenerate handlers) --------

    def has_choice(self, path: Tuple) -> bool:
        return isinstance(self.records.get(path), ChoiceRecord)

    def get_choice(self, path: Tuple) -> ChoiceRecord:
        rec = self.records.get(path)
        if not isinstance(rec, ChoiceRecord):
            raise KeyError(f"no choice at {path!r}")
        return rec

    def has_call(self, path: Tuple) -> bool:
        return isinstance(self.records.get(path), CallRecord)

    def get_call(self, path: Tuple) -> CallRecord:
        rec = self.records.get(path)
        if not isinstance(rec, CallRecord):
            raise KeyError(f"no call at {path!r}")
        return rec

    def project(self, selection: Selection):
        """Sum of selected choice scores plus recursive projects of calls;
        ``project(trace, EmptySelection()) == noise``."""
        if selection is NONE or selection.is_empty_set():
            return self.noise
        masked = isinstance(selection, MaskedSelection)
        total = torch.zeros_like(torch.as_tensor(self.score))
        for path, rec in self.records.items():
            if isinstance(rec, ChoiceRecord):
                if masked:
                    # membership by a per-lane flag: the flag-weighted
                    # score
                    total = total + torch.where(
                        flag_on(selection.flag_at(path), rec.score),
                        rec.score, 0.0)
                elif path in selection:
                    total = total + rec.score
            else:
                subsel = selection
                for k in path:
                    subsel = subsel.subselection(k)
                total = total + rec.subtrace.project(subsel)
        return total

    def __repr__(self):
        return (f"DynamicTrace({self.gen_fn!r}, score={self.score!r}, "
                f"addresses={list(self.records)})")


def _trace_flatten(tr: DynamicTrace):
    paths = sorted(tr.records.keys(), key=_path_sort_key)
    args_dyn, args_aux = split_static(tr.args, tr.args_mask)
    ret_dyn, ret_aux = split_static(tr.retval, tr.retval_mask)
    children = [args_dyn, ret_dyn, tr.score, tr.noise,
                [tr.records[p] for p in paths]]
    return children, (tr.gen_fn, tuple(paths), args_aux, ret_aux)


def _trace_unflatten(children, aux):
    gen_fn, paths, args_aux, ret_aux = aux
    args_dyn, ret_dyn, score, noise, recs = children
    return DynamicTrace(gen_fn, join_static(args_dyn, args_aux),
                        join_static(ret_dyn, ret_aux), score, noise,
                        dict(zip(paths, recs)), args_mask=args_aux[1],
                        retval_mask=ret_aux[1])


pytree.register_pytree_node(
    DynamicTrace, _trace_flatten, _trace_unflatten,
    serialized_type_name="gen_tpu_torch.DynamicTrace")
