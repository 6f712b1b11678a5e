"""Stochastic-gradient MCMC: SGLD and SGHMC with a GFI-native minibatch
target.

Counterpart: ``gen_tpu/inference/sgmcmc.py``, all of it:
:class:`MinibatchTarget`, ``sgld_step``, ``sghmc_step`` and
``sgld_chain``. For each minibatch the target rebuilds the trace with the
batch args/observations through ``update`` (argdiffs unknown), splits the
prior from the likelihood with ``project``, and scales the likelihood by
``n_total / batch_size``; batches of equal size that partition the data
give an exactly unbiased gradient. The gradient is ``torch.func.grad``
through ``update`` and ``project`` (gen_tpu's ``jax.grad``), with the
latents rebuilt by the ``FlatTarget``'s ``values_chm.from_array``.

``sgld_chain`` is gen_tpu's ``lax.scan`` as a loop over the same
``split(key, total)`` keys, batch ``i % S`` at step ``i``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.utils._pytree as pytree

from .. import random
from ..diff import all_unknown_change
from ..gfi import Trace
from ..selection import Selection
from .target import FlatTarget


class MinibatchTarget:
    """Estimated log-posterior over the selected latents of a template
    trace, with the likelihood term computed on a minibatch and scaled to
    the full dataset. ``batch_args``/``batch_obs`` keep one batch size
    across calls."""

    def __init__(self, template_trace: Trace, selection: Selection,
                 n_total: int, batch_size: int):
        self._flat = FlatTarget(template_trace, selection)
        self._trace = template_trace
        self._gen_fn = template_trace.get_gen_fn()
        self._selection = selection
        self.dim = self._flat.dim
        self.flat0 = self._flat.flat0
        self.scale = float(n_total) / float(batch_size)
        self._values_chm = self._flat.values_chm

    def logpost_estimate(self, flat, batch_args: Tuple, batch_obs):
        """prior(flat) + (n/m) * loglik(flat; minibatch)."""
        latents = self._values_chm.from_array(flat)
        tr, _, _, _ = self._gen_fn.update(
            None, self._trace, batch_args, all_unknown_change(batch_args),
            batch_obs.merge(latents))
        prior = tr.project(self._selection)
        lik = tr.get_score() - prior
        return prior + self.scale * lik

    def grad_estimate(self, flat, batch_args: Tuple, batch_obs):
        return torch.func.grad(self.logpost_estimate)(flat, batch_args,
                                                      batch_obs)


def _sqrt(x, like):
    """``jnp.sqrt`` of a step size: a Python number in the default float
    (JAX's), a tensor in its own dtype."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=torch.get_default_dtype())
    return torch.sqrt(x.to(like.device))


def sgld_step(key, flat, grad, step_size):
    """One SGLD update: flat + (eps/2) g + N(0, eps)."""
    noise = random.normal(key, tuple(flat.shape), flat.dtype)
    return flat + 0.5 * step_size * grad + _sqrt(step_size, flat) * noise


def sghmc_step(key, flat, momentum, grad, step_size, friction=0.1):
    """One SGHMC update (Chen et al. 2014, eq. 15 with M = I):
    p <- (1-alpha) p + eps g + N(0, 2 alpha eps);  q <- q + p."""
    alpha = friction
    noise = random.normal(key, tuple(flat.shape), flat.dtype)
    momentum = ((1.0 - alpha) * momentum + step_size * grad
                + _sqrt(2.0 * alpha * step_size, flat) * noise)
    return flat + momentum, momentum


def sgld_chain(key, target: MinibatchTarget, batch_args_stream: Tuple,
               batch_obs_stream, step_size, n_passes: int = 1,
               flat0=None, thin: int = 1):
    """Run SGLD over prestacked minibatches.

    ``batch_args_stream``: tuple of tensors with leading axis S (batches);
    ``batch_obs_stream``: ChoiceMap whose leaves carry the same leading
    axis. ``step_size``: scalar or (S * n_passes,) schedule.

    Returns (S * n_passes // thin, dim) positions.
    """
    flat = target.flat0 if flat0 is None else torch.as_tensor(flat0)
    s = pytree.tree_leaves(batch_obs_stream)[0].shape[0]
    total = s * n_passes
    eps = torch.as_tensor(step_size, device=flat.device)
    if not eps.is_floating_point():
        eps = eps.to(torch.get_default_dtype())
    eps = torch.broadcast_to(eps, (total,))
    keys = random.split(key, total)
    hist = []
    for i in range(total):
        idx = i % s
        bargs = pytree.tree_map(lambda x: x[idx], batch_args_stream)
        bobs = pytree.tree_map(lambda x: x[idx], batch_obs_stream)
        g = target.grad_estimate(flat, bargs, bobs)
        flat = sgld_step(keys[i], flat, g, eps[i])
        hist.append(flat)
    return torch.stack(hist)[::thin]
