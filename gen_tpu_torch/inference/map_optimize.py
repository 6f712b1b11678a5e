"""MAP optimization by backtracking gradient ascent on selected choices.

Counterpart: ``gen_tpu/inference/map_optimize.py``. gen_tpu's backtracking
line search is a ``lax.while_loop``; here it is a loop that runs while any
lane still backtracks (:func:`~gen_tpu_torch.inference.common.any_lane`),
each lane's step size, trace and score moving only while its own condition
holds. Outside ``torch.func.vmap`` that is the plain while loop; under it,
a vmapped ``while_loop``.
"""

from __future__ import annotations

import torch

from ..diff import all_no_change
from ..gfi import Trace
from ..selection import Selection
from .common import any_lane, select_trace


def map_optimize(trace: Trace, selection: Selection,
                 max_step_size: float = 0.1, tau: float = 0.5,
                 min_step_size: float = 1e-16):
    """One backtracking gradient-ascent move; returns the improved trace
    (or the original if no step size improved the score)."""
    gen_fn = trace.get_gen_fn()
    args = trace.get_args()
    argdiffs = all_no_change(args)

    _, values_chm, grad_chm = gen_fn.choice_gradients(trace, selection, None)
    values = values_chm.to_array()
    gradient = grad_chm.to_array()
    score = trace.get_score()

    def attempt(step_size):
        new_values = values + gradient * step_size
        new_trace, _, _, _ = gen_fn.update(
            None, trace, args, argdiffs, values_chm.from_array(new_values))
        return new_trace, new_trace.get_score()

    step_size = torch.as_tensor(max_step_size,
                                dtype=torch.get_default_dtype(),
                                device=values.device)
    new_trace, new_score = attempt(step_size)

    def backtracking(step_size, new_score):
        return (new_score - score < 0.0) & (step_size >= min_step_size)

    active = backtracking(step_size, new_score)
    while any_lane(active):
        step_size = torch.where(active, tau * step_size, step_size)
        cand_trace, cand_score = attempt(step_size)
        new_trace = select_trace(active, cand_trace, new_trace)
        new_score = torch.where(active, cand_score, new_score)
        active = backtracking(step_size, new_score)
    return select_trace(new_score >= score, new_trace, trace)
