"""Vectorized choice maps: integer-keyed hierarchies stored as batched
tensors.

Counterpart: ``gen_tpu/combinators/vector.py``. A :class:`VectorChoiceMap`
holds ONE inner choice map whose leaves carry a leading length-N axis, the
form a vmapped or time-stacked trace produces. ``densify_masked`` lowers
sparse per-index constraints onto one dense map of
:class:`~gen_tpu_torch.masked.MaskedValue` stacks, and ``sparsify_masked``
turns such a discard back into plain values at the flagged indices.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from ..address import addr_head_rest
from ..choice_map import ChoiceMap


class VectorChoiceMap(ChoiceMap):
    """Top-level integer keys 0..length-1; element i's submap is the inner
    map with every leaf indexed at i."""

    __slots__ = ("inner", "length")

    def __init__(self, inner: ChoiceMap, length: int):
        super().__init__()
        self.inner = inner
        self.length = int(length)

    def is_empty(self) -> bool:
        return self.length == 0 or self.inner.is_empty()

    def _check_head(self, head) -> bool:
        return isinstance(head, int) and 0 <= head < self.length

    def has_value(self, addr) -> bool:
        head, rest = addr_head_rest(addr)
        if not self._check_head(head) or rest == ():
            return False
        return self.inner.has_value(rest)

    def get_value(self, addr):
        head, rest = addr_head_rest(addr)
        if not self._check_head(head) or rest == ():
            raise KeyError(f"no value at {addr!r}")
        return tree_index(self.inner.get_value(rest), head)

    def get_submap(self, addr) -> ChoiceMap:
        head, rest = addr_head_rest(addr)
        if not self._check_head(head):
            return ChoiceMap()
        sub = tree_index(self.inner, head)
        if rest == ():
            return sub
        return sub.get_submap(rest)

    def get_values_shallow(self):
        return {}

    def get_submaps_shallow(self):
        return {i: self.get_submap(i) for i in range(self.length)}

    def addresses(self):
        for i in range(self.length):
            for rest in self.inner.addresses():
                yield (i,) + rest

    def leaf_items(self):
        for path in self.addresses():
            yield path, self.get_value(path)

    def set_value(self, addr, value):
        raise TypeError("VectorChoiceMap is immutable; build it with "
                        "vector_choicemap()")

    def set_submap(self, addr, submap):
        raise TypeError("VectorChoiceMap is immutable; build it with "
                        "vector_choicemap()")

    def copy(self):
        return VectorChoiceMap(self.inner.copy(), self.length)

    def filter(self, selection):
        from ..selection import AllSelection, EmptySelection
        if isinstance(selection, AllSelection):
            return self
        if isinstance(selection, EmptySelection):
            return ChoiceMap()
        return self.to_choicemap().filter(selection)

    def merge(self, other: ChoiceMap, overwrite: bool = False) -> ChoiceMap:
        return self.to_choicemap().merge(other, overwrite=overwrite)

    def to_choicemap(self) -> ChoiceMap:
        """Materialize as an ordinary int-keyed ChoiceMap."""
        out = ChoiceMap()
        for i in range(self.length):
            sub = self.get_submap(i)
            if not sub.is_empty():
                out.set_submap(i, sub)
        return out

    def __repr__(self):
        return f"VectorChoiceMap(length={self.length}, inner={self.inner!r})"


pytree.register_pytree_node(
    VectorChoiceMap, lambda v: ([v.inner], v.length),
    lambda children, length: VectorChoiceMap(children[0], length),
    serialized_type_name="gen_tpu_torch.VectorChoiceMap")


def vector_choicemap(length: int, inner: ChoiceMap = None, **kwargs
                     ) -> VectorChoiceMap:
    """A dense vectorized constraint: ``vector_choicemap(T, y=obs)``
    constrains address (t, "y") to obs[t] for every t."""
    if inner is None:
        inner = ChoiceMap()
    for k, val in kwargs.items():
        inner.set_value(k, torch.as_tensor(val))
    return VectorChoiceMap(inner, length)


def try_densify(constraints: ChoiceMap, length: int):
    """Classify constraints for a vector combinator. Returns one of
    ``("empty", None)``, ``("dense", VectorChoiceMap)`` (the same
    structure at every index 0..N-1) or ``("sparse", {index: ChoiceMap})``.
    """
    if isinstance(constraints, VectorChoiceMap):
        if constraints.length != length:
            raise ValueError(f"constraint length {constraints.length} != "
                             f"combinator length {length}")
        return ("dense", constraints)
    if constraints is None or constraints.is_empty():
        return ("empty", None)
    if constraints.get_values_shallow():
        raise ValueError(
            "vector combinator constraints must use integer-keyed submaps")
    subs = constraints.get_submaps_shallow()
    for k in subs:
        if not isinstance(k, int) or not 0 <= k < length:
            raise ValueError(f"vector combinator constraint key {k!r} out "
                             f"of range [0, {length})")
    if len(subs) == length:
        specs = [pytree.tree_structure(subs[i]) for i in range(length)]
        if all(s == specs[0] for s in specs[1:]):
            return ("dense", VectorChoiceMap(
                tree_stack([subs[i] for i in range(length)]), length))
    return ("sparse", dict(subs))


def densify_masked(subs: dict, length: int):
    """Lower sparse per-index constraints ``{index: ChoiceMap}`` onto ONE
    dense VectorChoiceMap whose leaves are :class:`gen_tpu_torch.masked
    .MaskedValue` stacks over the union of constrained paths: presence
    becomes a per-lane flag vector, so a vector combinator runs one
    vmapped (or per-step) generate/update over every index. Returns None
    when the per-index maps are not stackable (heterogeneous shapes or
    dtypes, nested submaps, or already-masked values); callers fall back
    to their loop."""
    from ..masked import MaskedValue
    maps = [subs.get(i, ChoiceMap()) for i in range(length)]
    paths, seen = [], set()
    try:
        for m in maps:
            for p, v in m.leaf_items():
                if isinstance(v, MaskedValue):
                    return None
                if p not in seen:
                    seen.add(p)
                    paths.append(p)
        if not paths:
            return None
        inner = ChoiceMap()
        for p in paths:
            donors = [i for i in range(length) if maps[i].has_value(p)]
            proto = torch.as_tensor(maps[donors[0]].get_value(p))
            vals = torch.stack([
                torch.as_tensor(maps[i].get_value(p)) if maps[i].has_value(p)
                else torch.zeros_like(proto) for i in range(length)])
            flags = torch.tensor([maps[i].has_value(p)
                                  for i in range(length)],
                                 device=proto.device)
            inner.set_value(p, MaskedValue(vals, flags))
    except (ValueError, TypeError, RuntimeError):
        return None
    return VectorChoiceMap(inner, length)


def sparsify_masked(inner: ChoiceMap, length: int):
    """Inverse of :func:`densify_masked`: a stacked discard map whose
    leaves are MaskedValue((N,)+shape, (N,) flags) (or plain stacked
    values) becomes an int-keyed ChoiceMap holding plain values at exactly
    the flagged indices, the reference discard. Needs flags it can read
    on the host: returns None where a flag is batched by a ``torch.func``
    transform (the caller keeps the masked form), as gen_tpu does under
    tracing."""
    from torch._C._functorch import is_functorch_wrapped_tensor
    from ..masked import MaskedValue
    out = ChoiceMap()
    for p, v in inner.leaf_items():
        if isinstance(v, MaskedValue):
            if is_functorch_wrapped_tensor(torch.as_tensor(v.flag)):
                return None
            flags = torch.as_tensor(v.flag).tolist()
            vals = v.value
        else:
            flags = [True] * length
            vals = v
        for i in range(length):
            if flags[i]:
                out.set_value((i,) + p, vals[i])
    return out


def lane_selections(selection, length: int, device):
    """gen_tpu's lowering of a vector combinator's per-element (per-step)
    subselections: ``(shared, None)`` when every element sees one
    selection, ``(None, masked)`` (a MaskedSelection of ``(length,)``
    flags) when they differ but enumerate statically, and ``(None, None)``
    for the per-element fallback."""
    from ..selection import AllSelection, EmptySelection, batch_selections
    if isinstance(selection, (AllSelection, EmptySelection)):
        return selection, None
    try:
        return batch_selections(
            [selection.subselection(i) for i in range(length)], device)
    except NotImplementedError:
        return None, None


def tree_stack(items):
    """Stack a list of identically structured pytrees along a new axis 0."""
    return pytree.tree_map(
        lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]), *items)


def tree_index(tree, i):
    """Element i of a batched pytree."""
    return pytree.tree_map(lambda x: x[i], tree)
