"""Exact enumerative inference over finite discrete latents.

Counterpart: ``gen_tpu/inference/enumerate.py``, all of it. The Cartesian
product of the latent supports ('ij' order) is one ``torch.func.vmap`` of
the key-free ``assess`` over the grid: exact posteriors and marginal
likelihoods for small discrete worlds, and the oracle that samplers are
tested against.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.func import vmap

from ..address import addr_path
from ..choice_map import ChoiceMap
from ..gfi import GenerativeFunction
from ..utils import logsumexp


def _grid(supports):
    """path -> (prod M_i,) flattened grid columns, and the sizes M_i."""
    paths = list(supports.keys())
    arrs = [torch.as_tensor(supports[p]) for p in paths]
    sizes = [a.shape[0] for a in arrs]
    mesh = torch.meshgrid(*[torch.arange(s, device=a.device)
                            for s, a in zip(sizes, arrs)], indexing="ij")
    return {p: a[m.reshape(-1)] for p, a, m in zip(paths, arrs, mesh)}, sizes


def enumerate_posterior(model: GenerativeFunction, args: Tuple,
                        observations: ChoiceMap, supports: Dict):
    """Exact posterior over the Cartesian product of the supports
    (address -> 1-D candidate values, the full support for exactness).

    Returns ``(grid, log_joint, log_ml, log_posterior)``: ``grid`` maps each
    path to its ``(G,)`` column, ``log_joint`` is ``(G,)``, ``log_ml`` the
    scalar log p(observations), ``log_posterior`` the normalized ``(G,)``.
    """
    supports = {addr_path(k): v for k, v in supports.items()}
    cols, _ = _grid(supports)
    paths = list(cols.keys())

    def joint(*vals):
        chm = ChoiceMap()
        for p, v in zip(paths, vals):
            chm.set_value(p, v)
        w, _ = model.assess(args, observations.merge(chm))
        return w

    log_joint = vmap(joint)(*[cols[p] for p in paths])
    log_ml = logsumexp(log_joint)
    return cols, log_joint, log_ml, log_joint - log_ml


def enumerate_marginals(model: GenerativeFunction, args: Tuple,
                        observations: ChoiceMap, supports: Dict):
    """Per-address exact posterior marginals: ``(marginals, log_ml)`` with
    ``marginals`` mapping each path to its ``(M_i,)`` probabilities in the
    given support order."""
    supports_p = {addr_path(k): torch.as_tensor(v)
                  for k, v in supports.items()}
    cols, sizes = _grid(supports_p)
    _, _, log_ml, log_post = enumerate_posterior(
        model, args, observations, supports_p)
    post = torch.exp(log_post).reshape(sizes)
    out = {}
    for i, p in enumerate(cols.keys()):
        axes = tuple(j for j in range(len(sizes)) if j != i)
        out[p] = torch.sum(post, dim=axes) if axes else post
    return out, log_ml
