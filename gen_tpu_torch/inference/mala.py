"""Metropolis-adjusted Langevin algorithm.

Counterpart: ``gen_tpu/inference/mala.py``: a forward Langevin proposal
``x + tau * grad``, an ``update``, the backward correction and an MH
accept, with gen_tpu's key splits, gradients from ``choice_gradients``.
"""

from __future__ import annotations

import math

import torch

from .. import random
from ..diff import all_no_change
from ..gfi import Trace
from ..selection import Selection
from .common import mh_accept, select_trace

_HALF_LOG_2PI = 0.9189385332046727


def _diag_normal_logpdf(x, mu, std):
    z = (x - mu) / std
    return torch.sum(-0.5 * z * z - math.log(std) - _HALF_LOG_2PI)


def mala(key, trace: Trace, selection: Selection, tau: float):
    """One MALA update on the selected addresses. Returns (trace,
    accepted)."""
    gen_fn = trace.get_gen_fn()
    args = trace.get_args()
    argdiffs = all_no_change(args)
    std = math.sqrt(2 * tau)

    _, values_chm, grad_chm = gen_fn.choice_gradients(trace, selection, None)
    values = values_chm.to_array()
    gradient = grad_chm.to_array()

    k_prop, k_acc = random.split(key)
    forward_mu = values + tau * gradient
    proposed = forward_mu + std * random.normal(k_prop, tuple(values.shape),
                                                values.dtype)
    forward_score = _diag_normal_logpdf(proposed, forward_mu, std)

    new_trace, weight, _, _ = gen_fn.update(
        None, trace, args, argdiffs, values_chm.from_array(proposed))

    _, _, back_grad_chm = gen_fn.choice_gradients(new_trace, selection, None)
    backward_mu = proposed + tau * back_grad_chm.to_array()
    backward_score = _diag_normal_logpdf(values, backward_mu, std)

    accept = mh_accept(k_acc, weight - forward_score + backward_score)
    return select_trace(accept, new_trace, trace), accept
