"""Shared inference utilities.

Counterpart: ``gen_tpu/inference/common.py``. ``select_trace`` picks leaf
by leaf with ``torch.where`` when the two traces have the same structure
and leaf shapes (the case that runs under ``torch.func.vmap``), and on the
host otherwise.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from .. import random


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
