"""Laplace approximation: the posterior mode, the Gaussian curvature there
and a log-evidence estimate::

    log p(obs) ~= log p(mode, obs) + (d/2) log 2 pi - (1/2) log det(-H)

with H the Hessian of the log joint at the mode (a conditional evidence
given the unselected choices unless ``selection`` covers every unobserved
continuous address).

Counterpart: ``gen_tpu/inference/laplace.py``, all of it. The mode comes
from ``n_optimize`` :func:`~gen_tpu_torch.inference.map_optimize` moves (a
Python loop where gen_tpu scans); the Hessian is ``torch.func.hessian`` of
the key-free ``update`` score, factored by ``torch.linalg.cholesky`` and
inverted by ``torch.cholesky_solve``, where gen_tpu calls XLA's
``jax.hessian``, Cholesky and ``cho_solve``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import random
from ..diff import all_no_change
from ..gfi import Trace
from ..selection import Selection
from .common import flat_selected
from .map_optimize import map_optimize


class LaplaceResult(NamedTuple):
    trace: Trace           # trace moved to the posterior mode
    mean: torch.Tensor     # (d,) flat mode (to_array order of the selection)
    cov: torch.Tensor      # (d, d) inverse negative Hessian at the mode
    log_ml: torch.Tensor   # scalar Laplace evidence estimate
    rebuild: object        # flat vector -> ChoiceMap (from_array order)


def laplace_approx(trace: Trace, selection: Selection,
                   n_optimize: int = 200,
                   max_step_size: float = 0.1) -> LaplaceResult:
    """Laplace-approximate the posterior over the selected continuous
    choices of ``trace`` (its unselected choices and observations stay
    fixed): ``n_optimize`` backtracking gradient-ascent moves to the mode,
    then the Hessian of the log joint there."""
    gen_fn = trace.get_gen_fn()
    args = trace.get_args()
    argdiffs = all_no_change(args)

    mode_trace = trace
    for _ in range(n_optimize):
        mode_trace = map_optimize(mode_trace, selection,
                                  max_step_size=max_step_size)

    vec, rebuild = flat_selected(mode_trace, selection)

    def logjoint(v):
        new_tr, _, _, _ = gen_fn.update(None, mode_trace, args, argdiffs,
                                        rebuild(v))
        return new_tr.get_score()

    h = torch.func.hessian(logjoint)(vec)
    h = 0.5 * (h + h.T)
    chol = torch.linalg.cholesky(-h)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    d = vec.shape[0]
    log_ml = (mode_trace.get_score()
              + 0.5 * d * math.log(2.0 * math.pi) - 0.5 * logdet)
    cov = torch.cholesky_solve(
        torch.eye(d, dtype=chol.dtype, device=chol.device), chol)
    return LaplaceResult(mode_trace, vec, cov, log_ml, rebuild)


def laplace_sample(key, result: LaplaceResult, num_samples: int):
    """Flat draws ``(num_samples, d)`` from the Laplace Gaussian; map each
    row through ``result.rebuild`` for choice maps."""
    chol = torch.linalg.cholesky(result.cov)
    eps = random.normal(key, (num_samples, result.mean.shape[0]),
                        torch.get_default_dtype())
    return result.mean[None, :] + eps @ chol.T
