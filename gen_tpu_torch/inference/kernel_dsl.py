"""Composite MCMC kernel DSL.

Counterpart: ``gen_tpu/inference/kernel_dsl.py``, all of it. A *kernel* is
any callable ``(key, trace, *args) -> (trace, aux)`` that leaves the target
invariant; ``seq``, ``repeat``, ``for_range``, ``mixture`` and
``cond_kernel`` return kernels, with gen_tpu's key splits, and
``reversal`` follows gen_tpu's reversal algebra (a registry for declared
primitives, a ``_reversal`` attribute on composites, self-reversal
otherwise).

``mixture`` has gen_tpu's two modes. Where its component index is batched
by a ``torch.func`` transform (a composite vmapped over chains; gen_tpu's
traced index under ``jit``/``vmap``), every component runs on
``fold_in(k_run, i)`` and the results are selected lane by lane; on a
concrete index only the chosen component runs, on ``k_run`` itself.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.utils._pytree as pytree
from torch._C._functorch import is_functorch_wrapped_tensor

from .. import random
from ..choice_map import ChoiceMap, _allclose

_REVERSALS = {}


def primitive_kernel(fn=None, reversal_fn=None):
    """Declare a stationary primitive kernel (the reference's @pkern).
    Optionally register its reversal (@rkern)."""
    def deco(f):
        if reversal_fn is not None:
            _REVERSALS[f] = reversal_fn
            _REVERSALS[reversal_fn] = f
        else:
            _REVERSALS.setdefault(f, f)  # self-reversal by default
        return f
    return deco(fn) if fn is not None else deco


def reversal(kernel):
    """The reversal of a kernel. Built-in kernels (mh, hmc, mala,
    elliptical_slice) are their own reversals."""
    if kernel in _REVERSALS:
        return _REVERSALS[kernel]
    rev = getattr(kernel, "_reversal", None)
    if rev is not None:
        return rev
    return kernel  # stationary kernels default to self-reversal


def _set_reversal(k, rev):
    k._reversal = rev
    rev._reversal = k
    return k


def seq(*kernels):
    """Sequential composition; reversal = reversed sequence of reversals."""
    def composite(key, trace, *args):
        accepted = []
        for k in kernels:
            key, sub = random.split(key)
            trace, aux = k(sub, trace, *args)
            accepted.append(aux)
        return trace, accepted

    def composite_rev(key, trace, *args):
        accepted = []
        for k in reversed(kernels):
            key, sub = random.split(key)
            trace, aux = reversal(k)(sub, trace, *args)
            accepted.append(aux)
        return trace, accepted

    return _set_reversal(composite, composite_rev)


def repeat(n: int, kernel):
    """Apply a kernel n times; reversal = repeat(n, reversal(kernel))."""
    def composite(key, trace, *args):
        aux = None
        for _ in range(n):
            key, sub = random.split(key)
            trace, aux = kernel(sub, trace, *args)
        return trace, aux

    def composite_rev(key, trace, *args):
        aux = None
        rk = reversal(kernel)
        for _ in range(n):
            key, sub = random.split(key)
            trace, aux = rk(sub, trace, *args)
        return trace, aux

    return _set_reversal(composite, composite_rev)


def for_range(n: int, make_kernel: Callable):
    """``@kern for i in 1:n``: apply ``make_kernel(i)`` for i = 0..n-1 in
    order. The reversal reverses both the loop range and each body kernel:
    ``reversal(f(i))`` for i = n-1..0."""
    kernels = [make_kernel(i) for i in range(n)]

    def composite(key, trace, *args):
        aux = []
        for k in kernels:
            key, sub = random.split(key)
            trace, a = k(sub, trace, *args)
            aux.append(a)
        return trace, aux

    def composite_rev(key, trace, *args):
        aux = []
        for k in reversed(kernels):
            key, sub = random.split(key)
            trace, a = reversal(k)(sub, trace, *args)
            aux.append(a)
        return trace, aux

    return _set_reversal(composite, composite_rev)


def _as_array(x):
    """``jnp.asarray`` of an aux value: nested lists stack."""
    if isinstance(x, (list, tuple)):
        return torch.stack([_as_array(v) for v in x])
    return torch.as_tensor(x)


def _select_by(idx, vals):
    """``jnp.select([idx == i ...], vals)``: the value of the first true
    condition, 0 where none holds."""
    out = torch.zeros_like(vals[0])
    for i in reversed(range(len(vals))):
        out = torch.where(idx == i, vals[i], out)
    return out


def mixture(probs: Sequence[float], kernels: Sequence[Callable]):
    """Choose a kernel at random each step (stationary if each component
    is); the reversal uses the components' reversals with the same probs.

    Under ``torch.func.vmap`` the component index is batched, so every
    component runs and the result is selected lane by lane (valid MH: the
    selection is independent of the outcomes); on a concrete index only
    the chosen component runs."""
    def _make(comps):
        def composite(key, trace, *args):
            k_sel, k_run = random.split(key)
            p = torch.as_tensor(probs, device=key.device)
            if not p.is_floating_point():
                p = p.to(torch.get_default_dtype())
            idx = random.categorical(k_sel, torch.log(p))
            if is_functorch_wrapped_tensor(idx):
                outs = [c(random.fold_in(k_run, i), trace, *args)
                        for i, c in enumerate(comps)]
                traces = [o[0] for o in outs]
                picked = pytree.tree_map(
                    lambda *xs: _select_by(
                        idx, [torch.as_tensor(x) for x in xs]), *traces)
                aux = _select_by(idx, [_as_array(o[1]) for o in outs])
                return picked, aux
            return comps[int(idx)](k_run, trace, *args)
        return composite

    fwd = _make(list(kernels))
    bwd = _make([reversal(k) for k in kernels])
    return _set_reversal(fwd, bwd)


def cond_kernel(pred_fn: Callable, if_kernel, else_kernel):
    """Apply if_kernel when pred_fn(trace) is true (a host-level predicate
    on concrete traces; the reference's @kern if-blocks)."""
    def composite(key, trace, *args):
        if bool(pred_fn(trace)):
            return if_kernel(key, trace, *args)
        return else_kernel(key, trace, *args)

    def composite_rev(key, trace, *args):
        if bool(pred_fn(trace)):
            return reversal(if_kernel)(key, trace, *args)
        return reversal(else_kernel)(key, trace, *args)

    return _set_reversal(composite, composite_rev)


def check_observations(choices: ChoiceMap, observations: ChoiceMap):
    """Verify a kernel preserved the observed addresses."""
    for path, value in observations.leaf_items():
        if not choices.has_value(path):
            raise RuntimeError(f"kernel deleted observation at {path!r}")
        got = choices.get_value(path)
        if not _allclose(got, value, 1e-5, 1e-8):
            raise RuntimeError(
                f"kernel changed observation at {path!r}: {got} != {value}")


def checked(kernel, observations: ChoiceMap):
    """Wrap a kernel with observation-preservation checking (the reference's
    ``check=true`` mode)."""
    def wrapped(key, trace, *args):
        new_trace, aux = kernel(key, trace, *args)
        check_observations(new_trace.get_choices(), observations)
        return new_trace, aux
    return wrapped
