"""Vectorized choice maps: integer-keyed hierarchies stored as batched
tensors.

Counterpart: ``gen_tpu/combinators/vector.py``. A :class:`VectorChoiceMap`
holds ONE inner choice map whose leaves carry a leading length-N axis, the
form a vmapped or time-stacked trace produces. ``densify_masked`` and
``sparsify_masked`` wait for ``masked.py`` (ROADMAP queue 1 item 12): the
port's combinators run sparse per-index constraints as a per-step loop,
which eager PyTorch runs as fast as a masked dense pass.
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


def tree_stack(items):
    """Stack a list of identically structured pytrees along a new axis 0."""
    return pytree.tree_map(
        lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]), *items)


def tree_index(tree, i):
    """Element i of a batched pytree."""
    return pytree.tree_map(lambda x: x[i], tree)
