"""Carry gen_tpu state, given as numpy arrays, into the port.

No counterpart in gen_tpu. The caller converts JAX arrays with
``np.asarray``; this module never imports jax. Tensors go to the card
unless ``device`` names another (:func:`gen_tpu_torch.utils.
default_device`).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from .choice_map import ChoiceMap
from .dynamic.fn import init_param
from .utils import default_device


def _tensor(a, device=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(
        default_device() if device is None else device)


def choicemap_from_numpy(leaf_items: Iterable[Tuple[tuple, np.ndarray]],
                         device=None) -> ChoiceMap:
    """A choice map from ``[(path, ndarray), ...]``, e.g. gen_tpu's
    ``[(p, np.asarray(v)) for p, v in chm.leaf_items()]``."""
    out = ChoiceMap()
    for path, value in leaf_items:
        out.set_value(tuple(path), _tensor(value, device))
    return out


def params_from_numpy(gen_fn, params: Dict[str, np.ndarray], device=None):
    """``init_param`` each ``{name: ndarray}`` on ``gen_fn``."""
    for name, value in params.items():
        init_param(gen_fn, name, _tensor(value, device))


def flat_values_from_numpy(values: np.ndarray, device=None,
                           dtype=torch.float32) -> torch.Tensor:
    """Flat ``(chains, d)`` chain state, e.g. gen_tpu's ``to_array``
    output, as a tensor."""
    return _tensor(values, device).to(dtype)
