"""Checkpoint/resume for parameters and inference state.

Counterpart: ``gen_tpu/checkpoint.py``, all of it: ``save_pytree``,
``restore_pytree``, ``save_params``, ``restore_params``. Any tensor pytree
(a trainable-parameter store, batched chain traces, a particle-filter
state) goes into one ``.npz`` with path-keyed leaves; the structure on
restore comes from a template, so traces come back with their static
metadata.

The keys are JAX's ``keystr`` of each leaf's path, built here by a walk
that mirrors ``jax.tree_util.tree_flatten_with_path``: a dict's keys in
sorted order (``['w']``), a sequence's indices (``[0]``), a namedtuple's
fields (``.a``), ``None`` an empty node, and any other registered node
(the port's traces, choice maps) its children by position (``[<flat index
i>]``). torch's own pytree walk keeps a dict's insertion order and takes
``None`` for a leaf, so it is not used for the keys. A parameter store
therefore saves under the same keys, in the same order, as gen_tpu's, and
each package loads the other's file. A restored leaf goes to the device
and dtype of the template's leaf.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.utils._pytree as pytree


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(keyed children, rebuild) of one pytree node, or None for a leaf.
    ``rebuild(new_children)`` takes the children in the keyed order."""
    if tree is None:
        return [], lambda new: None
    if type(tree) is dict:
        keys = sorted(tree)

        def rebuild(new):
            got = dict(zip(keys, new))
            return {k: got[k] for k in tree}
        return [(f"[{k!r}]", tree[k]) for k in keys], rebuild
    if _is_namedtuple(tree):
        return ([(f".{f}", getattr(tree, f)) for f in tree._fields],
                lambda new: type(tree)(*new))
    if isinstance(tree, (list, tuple)):
        return ([(f"[{i}]", x) for i, x in enumerate(tree)],
                lambda new: type(tree)(new))
    node = pytree.SUPPORTED_NODES.get(type(tree))
    if node is not None:
        children, context = node.flatten_fn(tree)
        return ([(f"[<flat index {i}>]", c) for i, c in enumerate(children)],
                lambda new: node.unflatten_fn(list(new), context))
    return None


def _walk(tree, prefix=""):
    """[(keystr, leaf)] in JAX's flatten order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, child in kids[0]:
        out.extend(_walk(child, prefix + k))
    return out


def _rebuild(tree, leaves):
    """The template's structure with its leaves taken in order from the
    iterator ``leaves``."""
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    items, rebuild = kids
    return rebuild([_rebuild(child, leaves) for _, child in items])


def _leaf_keys(tree):
    keys, vals = [], []
    for path, leaf in _walk(tree):
        keys.append(path or "__root__")
        vals.append(leaf.detach().cpu().numpy()
                    if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
    return keys, vals


def save_pytree(path: str, tree: Any) -> str:
    """Save any tensor pytree (trace, PF state, params, optimizer state)."""
    keys, vals = _leaf_keys(tree)
    arrays = {f"leaf_{i}": v for i, v in enumerate(vals)}
    np.savez(path, __keys__=np.asarray(keys, dtype=object), **arrays)
    return path


def _like(saved: np.ndarray, proto):
    if isinstance(proto, torch.Tensor):
        return torch.as_tensor(saved).to(device=proto.device,
                                          dtype=proto.dtype)
    return torch.as_tensor(saved)


def restore_pytree(path: str, target: Any) -> Any:
    """Restore into the structure of ``target`` (an example pytree with the
    right structure, e.g. a freshly built trace or state). Each leaf takes
    the device and dtype of the target's leaf at its place."""
    with np.load(path, allow_pickle=True) as data:
        saved_keys = list(data["__keys__"])
        leaves = [data[f"leaf_{i}"] for i in range(len(saved_keys))]
    walked = _walk(target)
    tgt_keys = [p or "__root__" for p, _ in walked]
    if tgt_keys != saved_keys:
        raise ValueError(
            f"checkpoint structure mismatch:\n saved: {saved_keys[:5]}...\n"
            f" target: {tgt_keys[:5]}...")
    restored = [_like(v, proto) for v, (_, proto) in zip(leaves, walked)]
    return _rebuild(target, iter(restored))


def save_params(fn, path: str) -> str:
    """Save a gen fn's trainable-parameter store."""
    return save_pytree(path, dict(fn.params))


def restore_params(fn, path: str) -> None:
    """Restore a gen fn's trainable parameters in place."""
    restored = restore_pytree(path, dict(fn.params))
    for k, v in restored.items():
        fn.params[k] = v
