"""Trainable-parameter plumbing.

Counterpart: ``gen_tpu/dynamic/params.py``, all of it. Parameters live on
each ``GenFn`` (a host-side store); gradients are functional:
``param_gradients`` re-executes ``assess`` under an override context that
substitutes the differentiated values for every reachable generative
function's parameters, and ``torch.func.grad`` differentiates the bundle.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

_OVERRIDES: List[Dict[int, dict]] = []


@contextlib.contextmanager
def override_params(mapping: Dict[int, dict]):
    """``mapping``: id(gen_fn) -> the parameters to use in this context."""
    _OVERRIDES.append(mapping)
    try:
        yield
    finally:
        _OVERRIDES.pop()


def current_params(fn) -> dict:
    """The parameters ``fn`` runs with: the innermost override naming it,
    else its own store."""
    for mapping in reversed(_OVERRIDES):
        if id(fn) in mapping:
            return mapping[id(fn)]
    return fn.params


def collect_param_fns(trace, acc=None) -> list:
    """Every generative function with trainable parameters reachable from
    a trace: the trace's own, its calls' subtraces, a combinator's batched
    kernel trace and a wrapper's inner trace (``call_at``)."""
    if acc is None:
        acc = []

    def add(fn):
        if fn is not None and getattr(fn, "params", None) and fn not in acc:
            acc.append(fn)

    add(trace.get_gen_fn())
    records = getattr(trace, "records", None)
    if records is not None:
        for rec in records.values():
            sub = getattr(rec, "subtrace", None)
            if sub is not None:
                collect_param_fns(sub, acc)
    subtraces = getattr(trace, "subtraces", None)
    if subtraces is not None:
        collect_param_fns(subtraces, acc)
    inner = getattr(trace, "inner_trace", None)
    if inner is not None:
        collect_param_fns(inner, acc)
    return acc
