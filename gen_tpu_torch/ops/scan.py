"""``scan``: a loop over time that the staging pass keeps rolled.

Counterpart: ``jax.lax.scan`` as ``gen_tpu/models/lgssm.py:83-104`` uses
it, together with ``gen_tpu/ops/scalarize.py::_eval_scan``, which unrolls
the scan statically into the TPU kernel's straight-line program.

``scan(step, init, xs, consts)`` runs ``carry, y_t = step(consts, carry,
xs[t])`` for t = 0 .. T-1 and returns ``(carry, ys)``, each leaf of ``ys``
stacked over the T steps. The per-chain values the step reads are explicit
``consts``, never closure captures: a traced tensor captured by the step
would be invisible to the staging pass and would lose its gradient.

- **Outside staging** it is a plain Python loop, so eager code, ``vmap``,
  ``torch.func`` transforms and the torch-op engines see exactly the
  arithmetic of a hand-written loop.
- **Inside** :func:`gen_tpu_torch.ops.scalarize.stage_scalarized` (the
  :func:`staging` context is active) it calls one custom op,
  ``gen_tpu_torch::scan_fwd``, whose gradient is a second one,
  ``gen_tpu_torch::scan_bwd``. ``make_fx`` of the logp's gradient then
  records each as one node instead of T unrolled steps, and the staging
  pass renders them as a forward loop that keeps a tape of the carry and
  a backward loop that recomputes each step from it (``scalarize.Loop``).

Why the port needs the ops where gen_tpu did not: ``jax.make_jaxpr`` keeps
``lax.scan`` as one equation, with the step as its sub-jaxpr, so gen_tpu's
staging saw the loop for free. ``make_fx`` records the aten ops that run,
so a Python loop arrives unrolled: 10,070 instructions for the T = 100
Kalman model, linear in T in staging time, build time and kernel size. A
custom op takes only tensors (and numbers), so the step reaches the ops
through the registry that the staging context holds: the ops' first
argument is the step's index there. The ops run only while ``make_fx``
traces: ``scan_fwd`` runs the loop (and keeps its inputs for the staging
pass to trace the step at), ``scan_bwd`` only stands for the pullback,
which the staging pass stages itself. The staged program, not the ops,
is what the kernels and their plain versions run.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten


class ScanStep:
    """A scan registered while staging: the step on flat lists, the
    carry's and the outputs' tree structures, and the real inputs it last
    ran on (the staging pass traces the step at those)."""

    def __init__(self, step: Callable, n_consts: int, carry_spec):
        self.step = step
        self.n_consts = n_consts
        self.carry_spec = carry_spec
        self.y_spec = None
        self.example = None

    def flat(self, consts: List[torch.Tensor], carry: List[torch.Tensor],
             x_t: torch.Tensor):
        """One step on flat lists: ``(carry leaves, y leaves)``."""
        new, y = self.step(tuple(consts),
                           tree_unflatten(list(carry), self.carry_spec), x_t)
        new_flat, _ = tree_flatten(new)
        y_flat, self.y_spec = tree_flatten(y)
        return list(new_flat), list(y_flat)


# the scans of the staging in progress (the ops' registry), or None
_REGISTRY: Optional[List[ScanStep]] = None


@contextlib.contextmanager
def staging():
    """Route :func:`scan` through the custom ops while the block runs;
    yields the registry the ops' first argument indexes."""
    global _REGISTRY
    prev, _REGISTRY = _REGISTRY, []
    try:
        yield _REGISTRY
    finally:
        _REGISTRY = prev


def registered(key: int) -> ScanStep:
    if _REGISTRY is None or not 0 <= key < len(_REGISTRY):
        raise RuntimeError(f"scan: step {key} is not registered (the scan "
                           "ops run only inside scan.staging())")
    return _REGISTRY[key]


@torch.library.custom_op("gen_tpu_torch::scan_fwd", mutates_args=())
def scan_fwd(key: int, consts: List[torch.Tensor], init: List[torch.Tensor],
             xs: torch.Tensor) -> List[torch.Tensor]:
    """The final carry's leaves, then each output leaf stacked over the
    steps."""
    entry = registered(key)
    entry.example = ([c.detach().clone() for c in consts],
                     [c.detach().clone() for c in init], xs.detach().clone())
    carry, ys = list(init), []
    for t in range(xs.shape[0]):
        carry, y = entry.flat(consts, carry, xs[t])
        ys.append(y)
    return [c.clone() for c in carry] + [
        torch.stack(list(col)) for col in zip(*ys)]


@scan_fwd.register_fake
def _scan_fwd_fake(key, consts, init, xs):
    entry = registered(key)
    new, y = entry.flat(consts, init, xs[0])
    return [torch.empty_like(c) for c in new] + [
        v.new_empty((xs.shape[0],) + tuple(v.shape)) for v in y]


@torch.library.custom_op("gen_tpu_torch::scan_bwd", mutates_args=())
def scan_bwd(key: int, consts: List[torch.Tensor], init: List[torch.Tensor],
             xs: torch.Tensor, cts: List[torch.Tensor]) -> List[torch.Tensor]:
    """The pullback of :func:`scan_fwd`: cotangents of ``consts`` and
    ``init`` from those of its outputs (``cts``). Only the node and its
    outputs' shapes matter: it exists only where an input of the scan
    depends on the staged point, so the staging pass never runs it and
    stages the pullback itself (``scalarize._GraphEval._scan_bwd``, a
    backward loop that recomputes each step from the tape). Its values
    while ``make_fx`` traces are zeros."""
    return [torch.zeros_like(c) for c in consts] + [
        torch.zeros_like(c) for c in init]


@scan_bwd.register_fake
def _scan_bwd_fake(key, consts, init, xs, cts):
    return [torch.empty_like(c) for c in consts] + [
        torch.empty_like(c) for c in init]


def _setup_context(ctx, inputs, output):
    key, consts, init, xs = inputs
    ctx.key, ctx.n_consts = key, len(consts)
    ctx.save_for_backward(*consts, *init, xs)


def _backward(ctx, cts):
    saved = ctx.saved_tensors
    n = ctx.n_consts
    consts, init, xs = list(saved[:n]), list(saved[n:-1]), saved[-1]
    out = scan_bwd(ctx.key, consts, init, xs, list(cts))
    return None, out[:n], out[n:], None


scan_fwd.register_autograd(_backward, setup_context=_setup_context)


def scan(step: Callable, init: Any, xs: torch.Tensor, consts=()):
    """``lax.scan(lambda c, x: step(consts, c, x), init, xs)``: ``(final
    carry, ys stacked over the T = xs.shape[0] steps)``. ``init`` and the
    carry are pytrees of tensors, ``consts`` a tuple of tensors, ``xs`` one
    tensor whose axis 0 is time. See the module note for what staging
    does with it."""
    consts = tuple(consts)
    if xs.shape[0] == 0:
        raise ValueError("scan: xs holds no steps")
    if _REGISTRY is None:
        carry, ys = init, []
        for t in range(xs.shape[0]):
            carry, y = step(consts, carry, xs[t])
            ys.append(y)
        return carry, tree_map(lambda *v: torch.stack(v), *ys)
    flat_init, carry_spec = tree_flatten(init)
    entry = ScanStep(step, len(consts), carry_spec)
    _REGISTRY.append(entry)
    out = scan_fwd(len(_REGISTRY) - 1, list(consts), list(flat_init), xs)
    n_c = len(flat_init)
    return (tree_unflatten(out[:n_c], carry_spec),
            tree_unflatten(out[n_c:], entry.y_spec))
