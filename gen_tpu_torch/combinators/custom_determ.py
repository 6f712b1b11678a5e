"""Deterministic generative functions with custom incremental computation.

Counterpart: ``gen_tpu/combinators/custom_determ.py``, all of it:
``CustomDetermGF`` (abstract: apply_with_state / update_with_state /
gradient_with_state), ``CustomUpdateGF`` and ``CustomGradientGF``. These
generative functions make no random choices (score 0, empty choices) but
take part in the GFI, so models can embed deterministic computations with
their own state threading and gradients.

The trace is a ``torch.utils._pytree`` node (gen_tpu registers it with
JAX): the non-tensor parts of the arguments, return value and state are
its spec, the tensors its leaves. Its score is a 0-dim zero on the device
of its arguments (of its return value where no argument is a tensor).
``CustomGradientGF`` differentiates with ``torch.func.grad`` where gen_tpu
uses ``jax.grad``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.utils._pytree as pytree

from ..choice_map import ChoiceMap
from ..diff import UnknownChange
from ..gfi import GenerativeFunction, Trace, _Inexact
from ..selection import Selection
from ..utils import join_static, split_static, tree_vdot


def _zero_on(*trees):
    """A 0-dim zero on the device of the first tensor in ``trees``."""
    for x in pytree.tree_leaves(trees):
        if isinstance(x, torch.Tensor):
            return torch.zeros((), device=x.device)
    return torch.zeros(())


class CustomDetermGFTrace(Trace):
    __slots__ = ("gen_fn", "args", "retval", "state", "mask")

    def __init__(self, gen_fn, args, retval, state, mask=None):
        self.gen_fn = gen_fn
        # which leaves are static, once flattened: the pytree utilities
        # re-flatten a trace whose tensors were replaced by other leaves
        self.mask = mask
        self.args = args
        self.retval = retval
        self.state = state

    def get_args(self):
        return self.args

    def get_retval(self):
        return self.retval

    def get_score(self):
        return _zero_on(self.args, self.retval)

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self):
        return ChoiceMap()

    def project(self, selection):
        return _zero_on(self.args, self.retval)


def _cdt_flatten(t):
    dyn, aux = split_static((t.args, t.retval, t.state), t.mask)
    return dyn, (t.gen_fn, aux)


def _cdt_unflatten(children, aux):
    args, retval, state = join_static(children, aux[1])
    return CustomDetermGFTrace(aux[0], args, retval, state, aux[1][1])


pytree.register_pytree_node(
    CustomDetermGFTrace, _cdt_flatten, _cdt_unflatten,
    serialized_type_name="gen_tpu_torch.CustomDetermGFTrace")


class CustomDetermGF(GenerativeFunction):
    """Subclass and implement apply_with_state / update_with_state /
    gradient_with_state."""

    def apply_with_state(self, args: Tuple):
        """-> (retval, state)."""
        raise NotImplementedError

    def update_with_state(self, state, args: Tuple, argdiffs: Tuple):
        """-> (new_state, retval, retdiff)."""
        retval, new_state = self.apply_with_state(args)
        return new_state, retval, UnknownChange

    def gradient_with_state(self, state, args: Tuple, retgrad):
        """-> arg_grads (None per non-differentiable arg)."""
        return tuple(None for _ in args)

    def accepts_output_grad(self) -> bool:
        return True

    # -- GFI --------------------------------------------------------------

    def simulate(self, key, args: Tuple):
        retval, state = self.apply_with_state(args)
        return CustomDetermGFTrace(self, args, retval, state)

    def generate(self, key, args: Tuple, constraints: ChoiceMap = None):
        if constraints is not None and not constraints.is_empty():
            raise ValueError(
                "deterministic generative function accepts no constraints")
        tr = self.simulate(key, args)
        return tr, tr.get_score()

    def assess(self, args: Tuple, choices: ChoiceMap):
        retval, _ = self.apply_with_state(args)
        return _zero_on(args, retval), retval

    def project(self, trace, selection: Selection):
        return trace.project(selection)

    def propose(self, key, args: Tuple):
        tr = self.simulate(key, args)
        return ChoiceMap(), tr.get_score(), tr.get_retval()

    def update(self, key, trace, args: Tuple, argdiffs: Tuple,
               constraints: ChoiceMap):
        if constraints is not None and not constraints.is_empty():
            raise ValueError(
                "deterministic generative function accepts no constraints")
        state, retval, retdiff = self.update_with_state(trace.state, args,
                                                        argdiffs)
        tr = CustomDetermGFTrace(self, args, retval, state)
        return tr, tr.get_score(), retdiff, ChoiceMap()

    def regenerate(self, key, trace, args: Tuple, argdiffs: Tuple,
                   selection: Selection):
        state, retval, retdiff = self.update_with_state(trace.state, args,
                                                        argdiffs)
        tr = CustomDetermGFTrace(self, args, retval, state)
        return tr, tr.get_score(), retdiff

    def choice_gradients(self, trace, selection=None, retgrad=None):
        arg_grads = self.gradient_with_state(trace.state, trace.get_args(),
                                             retgrad)
        return arg_grads, ChoiceMap(), ChoiceMap()

    def param_gradients(self, trace, retgrad=None, scale_factor=1.0):
        arg_grads = self.gradient_with_state(trace.state, trace.get_args(),
                                             retgrad)
        return arg_grads, {}


class CustomUpdateGF(CustomDetermGF):
    """Wrap ``apply_fn(*args)`` with a custom incremental
    ``update_fn(state, args, argdiffs) -> (state, retval, retdiff)``."""

    def __init__(self, apply_fn, update_fn=None):
        self.apply_fn = apply_fn
        self.update_fn = update_fn

    def apply_with_state(self, args):
        retval = self.apply_fn(*args)
        return retval, retval

    def update_with_state(self, state, args, argdiffs):
        if self.update_fn is None:
            return super().update_with_state(state, args, argdiffs)
        return self.update_fn(state, args, argdiffs)


class CustomGradientGF(CustomDetermGF):
    """Wrap a plain differentiable function: gradients by
    ``torch.func.grad`` (the reference requires a hand-written
    ``gradient`` method)."""

    def __init__(self, fn):
        self.fn = fn

    def apply_with_state(self, args):
        retval = self.fn(*args)
        return retval, None

    def gradient_with_state(self, state, args, retgrad):
        inexact = _Inexact(tuple(args))

        def f(tensors):
            out = self.fn(*inexact.substituted(tensors))
            return tree_vdot(retgrad, out) if retgrad is not None \
                else torch.sum(torch.as_tensor(out))

        return inexact.grads(torch.func.grad(f)(inexact.tensors))
