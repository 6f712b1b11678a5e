"""Shared inference utilities.

Counterpart: ``gen_tpu/inference/common.py``, all of it. ``select_trace``
picks leaf by leaf with ``torch.where`` when the two traces have the same
structure and leaf shapes (the case that runs under ``torch.func.vmap``),
and on the host otherwise (never under vmap).

Not in gen_tpu: :func:`any_lane`, the exit test of a loop that gen_tpu
writes as ``lax.while_loop``. Under ``torch.func.vmap`` a loop runs while
any lane's condition holds, each lane's state updated only while its own
condition holds, which is what a vmapped ``while_loop`` does.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree
from torch._C._functorch import get_unwrapped, is_functorch_wrapped_tensor

from .. import random
from ..selection import Selection


def select_trace(accept, new_trace, old_trace):
    """Pick between two traces by a (possibly batched) boolean."""
    new_leaves, new_def = pytree.tree_flatten(new_trace)
    old_leaves, old_def = pytree.tree_flatten(old_trace)
    if new_def == old_def and all(
            torch.as_tensor(a).shape == torch.as_tensor(b).shape
            for a, b in zip(new_leaves, old_leaves)):
        picked = [torch.where(accept, torch.as_tensor(a), torch.as_tensor(b))
                  for a, b in zip(new_leaves, old_leaves)]
        return pytree.tree_unflatten(picked, new_def)
    return new_trace if bool(accept) else old_trace


def mh_accept(key, log_alpha):
    """Standard MH accept decision: log u < log alpha, u in JAX's default
    float (``torch.get_default_dtype()``)."""
    u = random.uniform(key, (), torch.get_default_dtype())
    return torch.log(u) < log_alpha


def flat_selected(trace, selection: Selection):
    """(values_vector, rebuild) for the selected continuous choices: the
    ``to_array`` vector and its inverse to a choice map."""
    values_chm = trace.get_choices().filter(selection)
    vec = values_chm.to_array()

    def rebuild(v):
        return values_chm.from_array(v)

    return vec, rebuild


def any_lane(flag) -> bool:
    """Whether any lane of a (possibly ``torch.func``-batched) boolean
    holds: the values of every lane, read beneath the transforms."""
    t = flag
    while isinstance(t, torch.Tensor) and is_functorch_wrapped_tensor(t):
        t = get_unwrapped(t)
    return bool(torch.as_tensor(t).any())
