"""The Generative Function Interface (GFI).

Counterpart: ``gen_tpu/gfi.py``. Same design: every sampling method takes an
explicit key (a :mod:`gen_tpu_torch.random` key tensor, not a
``torch.Generator``, so that ``torch.func.vmap`` can batch it), methods are
pure, and traces are pytrees whose structure is static and whose leaves are
tensors. Ported: ``simulate``, ``generate``, ``assess``, ``project``,
``propose``, ``update`` and ``regenerate``, with the trace-first
forwarding of ``update``/``regenerate``; the gradient methods
``choice_gradients``, ``param_gradients`` and
``accumulate_param_gradients``, and the metadata ``has_argument_grads``,
``accepts_output_grad`` and ``get_params``.

The gradient methods are generic over every generative function, as in
gen_tpu: the gradient of the key-free, fully constrained ``assess``,
``torch.func.grad`` in place of ``jax.grad``. torch's transforms take
tensors, not choice maps: the selected choices go through
``to_array``/``from_array`` (as ``FlatTarget`` does) and the inexact
arguments and parameters through flat lists of tensors (a Python float
argument becomes a 0-dim tensor of the default dtype), so no new pytree
is registered. The results have gen_tpu's shapes: choice maps, argument
tuples with ``None`` at integer and boolean arguments, and ``{gen_fn:
{name: grad}}``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from .choice_map import ChoiceMap
from .diff import all_no_change
from .selection import NONE, Selection
from .utils import combine, partition_inexact, tree_vdot


class Trace:
    """A recorded execution of a generative function."""

    def get_args(self) -> Tuple:
        raise NotImplementedError

    def get_retval(self):
        raise NotImplementedError

    def get_choices(self) -> ChoiceMap:
        raise NotImplementedError

    def get_score(self):
        """log p(t, r; x) / q(r; x, t); equals log p(t; x) when there is no
        non-addressed randomness."""
        raise NotImplementedError

    def get_gen_fn(self) -> "GenerativeFunction":
        raise NotImplementedError

    def __getitem__(self, addr):
        return self.get_choices()[addr]

    def update(self, key, constraints: ChoiceMap, args=None, argdiffs=None):
        fn = self.get_gen_fn()
        if args is None:
            args = self.get_args()
            argdiffs = all_no_change(args)
        return fn.update(key, self, args, argdiffs, constraints)

    def regenerate(self, key, selection: Selection, args=None,
                   argdiffs=None):
        fn = self.get_gen_fn()
        if args is None:
            args = self.get_args()
            argdiffs = all_no_change(args)
        return fn.regenerate(key, self, args, argdiffs, selection)

    def project(self, selection: Selection):
        return self.get_gen_fn().project(self, selection)


class _Inexact:
    """The inexact leaves of a pytree as tensors to differentiate
    (``partition_inexact``), and the two ways back: the tree with new
    values in their places (``combine``), and a tree of gradients with
    ``None`` at the other leaves (the shape of gen_tpu's ``jax.grad``
    over the differentiable half)."""

    def __init__(self, tree):
        dyn, self.static = partition_inexact(tree)
        self.leaves, self.spec = pytree.tree_flatten(dyn)
        self.where = [i for i, x in enumerate(self.leaves) if x is not None]
        self.tensors = [
            x if isinstance(x, torch.Tensor)
            else torch.as_tensor(x, dtype=torch.get_default_dtype())
            for x in (self.leaves[i] for i in self.where)]

    def _fill(self, base, new):
        out = list(base)
        for i, t in zip(self.where, new):
            out[i] = t
        return pytree.tree_unflatten(out, self.spec)

    def substituted(self, new):
        return combine(self._fill(self.leaves, new), self.static)

    def grads(self, new):
        return self._fill([None] * len(self.leaves), new)


class GenerativeFunction:
    """Abstract generative function."""

    # -- metadata ---------------------------------------------------------

    def has_argument_grads(self) -> Tuple[bool, ...]:
        raise NotImplementedError

    def accepts_output_grad(self) -> bool:
        return False

    def get_params(self):
        """Iterable over trainable parameter names (may be empty)."""
        return ()

    def simulate(self, key, args: Tuple) -> Trace:
        """Sample t ~ p(.; x); return the trace."""
        raise NotImplementedError

    def generate(self, key, args: Tuple,
                 constraints: Optional[ChoiceMap] = None
                 ) -> Tuple[Trace, Any]:
        """Constrained generation; weight = log p(t; x) / q(t; u, x)."""
        raise NotImplementedError

    def project(self, trace: Trace, selection: Selection):
        """log-density of the selected choices under the internal proposal
        decomposition."""
        raise NotImplementedError

    def propose(self, key, args: Tuple) -> Tuple[ChoiceMap, Any, Any]:
        """(choices, weight, retval); the default goes through simulate."""
        trace = self.simulate(key, args)
        return trace.get_choices(), trace.get_score(), trace.get_retval()

    def assess(self, args: Tuple, choices: ChoiceMap) -> Tuple[Any, Any]:
        """(weight, retval) with ALL addressed choices given; key-free and
        differentiable."""
        raise NotImplementedError

    def update(self, key, trace: Trace, args: Tuple, argdiffs: Tuple,
               constraints: ChoiceMap):
        """(new_trace, weight, retdiff, discard); the incremental edit move.
        weight = log [p(t';x') q(r;x,t)] / [p(t;x) q(r';x',t') q(t';x',t+u)].
        ``key`` may be None when nothing needs to be sampled."""
        raise NotImplementedError

    def regenerate(self, key, trace: Trace, args: Tuple, argdiffs: Tuple,
                   selection: Selection):
        """(new_trace, weight, retdiff); resample the selected addresses from
        the internal proposal."""
        raise NotImplementedError

    # -- gradients --------------------------------------------------------

    def choice_gradients(self, trace: Trace, selection: Selection = NONE,
                         retgrad=None):
        """(arg_grads, choice_values, choice_grads): the gradient of
        log p(t; x) + <retgrad, retval> with respect to the arguments and
        the selected continuous choices, the last two as choice maps."""
        choices = trace.get_choices()
        sel_values = choices.filter(selection)
        rest = choices.filter(selection.complement())
        empty = sel_values.is_empty()
        flat0 = (torch.zeros(0, dtype=torch.get_default_dtype())
                 if empty else sel_values.to_array())
        args = _Inexact(trace.get_args())

        def f(flat, adyn):
            full = rest if empty else rest.merge(sel_values.from_array(flat))
            w, retval = self.assess(args.substituted(adyn), full)
            return w + tree_vdot(retgrad, retval)

        g_flat, g_args = torch.func.grad(f, argnums=(0, 1))(flat0,
                                                             args.tensors)
        choice_grads = sel_values if empty else sel_values.from_array(g_flat)
        return args.grads(g_args), sel_values, choice_grads

    def param_gradients(self, trace: Trace, retgrad=None,
                        scale_factor=1.0):
        """(arg_grads, param_grads): the functional form of Gen's
        ``accumulate_param_gradients!``. ``param_grads`` maps each
        reachable generative function with trainable parameters to its
        ``{name: grad}``; parameter gradients are scaled by
        ``scale_factor``, argument gradients are not."""
        from .dynamic.params import collect_param_fns, override_params
        fns = collect_param_fns(trace)
        bundle = {i: dict(fn.params) for i, fn in enumerate(fns)}
        params = _Inexact(bundle)
        choices = trace.get_choices()
        args = _Inexact(trace.get_args())

        def f(bdyn, adyn):
            b = params.substituted(bdyn)
            with override_params({id(fn): b[i] for i, fn in enumerate(fns)}):
                w, retval = self.assess(args.substituted(adyn), choices)
            return w + tree_vdot(retgrad, retval)

        g_bundle, g_args = torch.func.grad(f, argnums=(0, 1))(params.tensors,
                                                               args.tensors)
        if scale_factor != 1.0:
            g_bundle = [g * scale_factor for g in g_bundle]
        bundle_grads = params.grads(g_bundle)
        param_grads = {fn: bundle_grads[i] for i, fn in enumerate(fns)}
        return args.grads(g_args), param_grads

    def accumulate_param_gradients(self, trace: Trace, retgrad=None,
                                   scale_factor=1.0):
        """Adds the parameter gradients into the accumulators of every
        reachable generative function (host-side) and returns the argument
        gradients, as Gen's API does."""
        arg_grads, param_grads = self.param_gradients(trace, retgrad,
                                                      scale_factor)
        for fn, grads in param_grads.items():
            store = fn.params_grad
            for name, g in grads.items():
                acc = store.get(name)
                store[name] = g if acc is None else pytree.tree_map(
                    lambda a, b: a + b, acc, g)
        return arg_grads

    # -- modeling-language sugar ------------------------------------------

    def __call__(self, *args):
        """Inside a model body, ``fn(args) @ "addr"`` traces a call at an
        address."""
        from .dynamic.handlers import Call
        return Call(self, args)

    def inline(self, *args):
        """Call another generative function without an address scope: its
        choices splice into the caller's trace."""
        from .dynamic.handlers import active_handler
        return active_handler().splice(self, args)
