"""Exact Gibbs moves over finite discrete addresses.

Counterpart: ``gen_tpu/inference/gibbs.py``, all of it. The candidate grid
(one address's support, or the Cartesian product of several, 'ij' order)
is scored by one ``torch.func.vmap`` of the key-free ``update`` (every
address of the block is constrained, so no key is needed), the new value
is one categorical draw over the weights, and the trace is gathered from
the candidate batch: the exact full conditional, a rejection-free move.
It runs under ``torch.func.vmap`` over keys or chains.
"""

from __future__ import annotations

from typing import Dict, Union

import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from .. import random
from ..address import addr_path
from ..choice_map import ChoiceMap
from ..gfi import Trace
from ..utils import logsumexp


def _candidate_grid(supports: Dict):
    """Cartesian product of per-address supports: path -> (G,) column."""
    paths = [addr_path(a) for a in supports]
    arrs = [torch.as_tensor(v) for v in supports.values()]
    mesh = torch.meshgrid(*[torch.arange(a.shape[0], device=a.device)
                            for a in arrs], indexing="ij")
    return {p: a[m.reshape(-1)] for p, a, m in zip(paths, arrs, mesh)}


def _supports(addr_or_supports, support):
    if support is not None:
        return {addr_or_supports: support}
    supports = dict(addr_or_supports)
    if not supports:
        raise ValueError("gibbs: empty support dict")
    return supports


def _scores(trace, grid):
    def score(cand):
        cons = ChoiceMap()
        for p, v in cand.items():
            cons = cons.set_value(p, v)
        new_tr, w, _, _ = trace.update(None, cons)
        return new_tr, w

    return vmap(score)(grid)


def gibbs(key, trace: Trace, addr_or_supports: Union[object, Dict],
          support=None) -> Trace:
    """Resample one address (``gibbs(key, trace, "z", support)``) or a
    block (``gibbs(key, trace, {"z1": s1, "z2": s2})``) from its exact
    conditional given all other choices. Each support must cover the
    address's full support (candidate values along the leading axis) with
    the stored value's dtype and trailing shape. Always accepted."""
    grid = _candidate_grid(_supports(addr_or_supports, support))
    traces, ws = _scores(trace, grid)
    idx = random.categorical(key, ws)
    return pytree.tree_map(
        lambda x: torch.index_select(x, 0, idx.reshape(1))[0], traces)


def gibbs_conditional(trace: Trace, addr_or_supports: Union[object, Dict],
                      support=None):
    """(grid, log-probabilities): the exact full conditional that
    :func:`gibbs` samples, normalized over the flattened candidate
    grid."""
    grid = _candidate_grid(_supports(addr_or_supports, support))
    _, ws = _scores(trace, grid)
    return grid, ws - logsumexp(ws)
