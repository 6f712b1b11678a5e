"""Prior and posterior predictive sampling.

Counterpart: ``gen_tpu/inference/predictive.py``, all of it. Given
posterior draws over some latents (from :func:`~gen_tpu_torch.inference.
sample.sample_posterior`, a PG chain, or any dict of per-address sample
tensors), the predictive re-runs the model with those latents constrained
and everything else (the observation addresses in particular) freshly
sampled: one ``torch.func.vmap`` over draws. Pass new ``args`` to predict
at new design points.

The draws are picked as gen_tpu picks them, ``jnp.linspace(0, n_total -
1, n).astype(int32)``, to the index: :func:`draw_indices` computes the
float64 values as XLA's compiled ``linspace`` does on the CPU (``i *
(stop * (1 / (n - 1)))``, the last one ``stop``), which is not
``torch.linspace``'s formula, and truncates them. The draws are gathered
before the vmap, so the vmapped function only sees its own draw.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.func import vmap

from .. import random
from ..choice_map import ChoiceMap
from ..gfi import GenerativeFunction


def _stack_draws(samples: Dict):
    """dict addr -> tensors with LEADING (draws, chains) axes (event dims
    after; exactly ``PosteriorSamples.samples``), or 1-D (draws,) for
    scalar addresses. A 2-D tensor is always read as (draws, chains): for
    draws of a vector-valued address from a single chain, add the chain
    axis explicitly (``arr[:, None, :]``)."""
    leaves = {}
    n = None
    for addr, arr in samples.items():
        arr = torch.as_tensor(arr)
        flat = arr.reshape((-1,) + tuple(arr.shape[2:])) \
            if arr.ndim >= 2 else arr
        leaves[addr] = flat
        if n is None:
            n = flat.shape[0]
        elif flat.shape[0] != n:
            raise ValueError("sample arrays disagree on draw count")
    return n, leaves


def draw_indices(n_total: int, n: int, device=None) -> torch.Tensor:
    """gen_tpu's ``jnp.linspace(0, n_total - 1, n).astype(jnp.int32)``,
    index for index (int32)."""
    stop = torch.tensor(float(n_total - 1), dtype=torch.float64)
    if n == 1:
        vals = torch.zeros(1, dtype=torch.float64)
    else:
        c = stop * (torch.tensor(1.0, dtype=torch.float64) / (n - 1))
        vals = torch.cat([torch.arange(n - 1, dtype=torch.float64) * c,
                          stop.reshape(1)])
    return vals.to(torch.int32).to(device)


def posterior_predictive(key, model: GenerativeFunction, args: Tuple,
                         samples: Dict, num_draws: Optional[int] = None):
    """Sample the predictive distribution of all UNCONSTRAINED addresses.

    ``samples``: address -> tensor with leading (draws, chains) axes (as
    returned in ``PosteriorSamples.samples``) or a single leading draws
    axis. Returns a ChoiceMap whose leaves have a leading draw axis:
    ``result.get_value("ys")`` is the (num_draws, ...) predictive for
    address "ys"."""
    n_total, leaves = _stack_draws(samples)
    n = num_draws or n_total
    if n > n_total:
        raise ValueError(f"requested {n} draws but only {n_total} samples")
    picked = {}
    for addr, flat in leaves.items():
        picked[addr] = flat[draw_indices(n_total, n, flat.device).long()]

    def one(k, vals):
        cons = ChoiceMap()
        for addr, v in vals.items():
            cons = cons.set_value(addr, v)
        trace, _ = model.generate(k, args, cons)
        return trace.get_choices()

    return vmap(one)(random.split(key, n), picked)


def prior_predictive(key, model: GenerativeFunction, args: Tuple,
                     num_draws: int):
    """Forward-simulate ``num_draws`` full traces; returns a ChoiceMap with
    a leading draw axis per address."""
    def one(k):
        return model.simulate(k, args).get_choices()

    return vmap(one)(random.split(key, num_draws))
