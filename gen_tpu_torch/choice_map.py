"""ChoiceMap: hierarchical address -> value maps.

Counterpart: ``gen_tpu/choice_map.py``. The same class, with the values held
as torch tensors and the pytree registered with ``torch.utils._pytree``:
the address structure (sorted leaf keys and submap keys) is the spec and
the values are the leaves, so a choice map passes through
``torch.func.vmap`` and ``torch.func.grad``. ``to_array``/``from_array``
flatten leaves in the same deterministic sorted-key order as gen_tpu, which
fixes the flat layout that ``FlatTarget`` and the fused kernel index by.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch
import torch.utils._pytree as pytree

from .address import Address, Key, addr_head_rest, sorted_keys


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)


def _allclose(a, b, rtol, atol) -> bool:
    """``np.allclose`` on two leaves of any dtypes and devices."""
    a, b = _as_tensor(a), _as_tensor(b)
    dt = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                             torch.float64)
    return bool(torch.allclose(a.to(dt), b.to(device=a.device, dtype=dt),
                               rtol=rtol, atol=atol))


class ChoiceMap:
    """A mutable hierarchical map from addresses to values. Each node has
    *leaves* (values at single keys) and *submaps*; a key holds one or the
    other, never both."""

    __slots__ = ("_leaves", "_subs")

    def __init__(self):
        self._leaves: Dict[Key, Any] = {}
        self._subs: Dict[Key, "ChoiceMap"] = {}

    # -- construction -----------------------------------------------------

    @staticmethod
    def from_dict(d: Dict) -> "ChoiceMap":
        """Build from a (possibly nested) dict. Nested dicts become submaps."""
        out = ChoiceMap()
        for k, v in d.items():
            if isinstance(v, dict):
                out.set_submap(k, ChoiceMap.from_dict(v))
            else:
                out.set_value(k, v)
        return out

    def copy(self) -> "ChoiceMap":
        out = ChoiceMap()
        out._leaves = dict(self._leaves)
        out._subs = {k: v.copy() for k, v in self._subs.items()}
        return out

    # -- queries ----------------------------------------------------------

    def is_empty(self) -> bool:
        return not self._leaves and all(s.is_empty()
                                        for s in self._subs.values())

    def has_value(self, addr: Address) -> bool:
        head, rest = addr_head_rest(addr)
        if rest == ():
            return head in self._leaves
        sub = self._subs.get(head)
        return sub is not None and sub.has_value(rest)

    def get_value(self, addr: Address):
        head, rest = addr_head_rest(addr)
        if rest == ():
            if head not in self._leaves:
                raise KeyError(f"no value at address {addr!r}")
            return self._leaves[head]
        sub = self._subs.get(head)
        if sub is None:
            raise KeyError(f"no value at address {addr!r}")
        return sub.get_value(rest)

    def get_submap(self, addr: Address) -> "ChoiceMap":
        head, rest = addr_head_rest(addr)
        if rest == ():
            return self._subs.get(head, _EMPTY)
        sub = self._subs.get(head)
        if sub is None:
            return _EMPTY
        return sub.get_submap(rest)

    def has_submap(self, addr: Address) -> bool:
        return not self.get_submap(addr).is_empty()

    def get_values_shallow(self) -> Dict[Key, Any]:
        return dict(self._leaves)

    def get_submaps_shallow(self) -> Dict[Key, "ChoiceMap"]:
        return {k: v for k, v in self._subs.items() if not v.is_empty()}

    def __getitem__(self, addr: Address):
        return self.get_value(addr)

    def __contains__(self, addr: Address) -> bool:
        return self.has_value(addr)

    # -- mutation (construction only) -------------------------------------

    def set_value(self, addr: Address, value) -> "ChoiceMap":
        head, rest = addr_head_rest(addr)
        if rest == ():
            if head in self._subs:
                raise ValueError(f"address {addr!r} already holds a submap")
            self._leaves[head] = value
        else:
            if head in self._leaves:
                raise ValueError(f"address {head!r} already holds a value")
            sub = self._subs.get(head)
            if sub is None:
                sub = ChoiceMap()
                self._subs[head] = sub
            sub.set_value(rest, value)
        return self

    def set_submap(self, addr: Address, submap: "ChoiceMap") -> "ChoiceMap":
        head, rest = addr_head_rest(addr)
        if rest == ():
            if head in self._leaves:
                raise ValueError(f"address {addr!r} already holds a value")
            self._subs[head] = submap
        else:
            sub = self._subs.get(head)
            if sub is None:
                sub = ChoiceMap()
                self._subs[head] = sub
            sub.set_submap(rest, submap)
        return self

    # -- algebra ----------------------------------------------------------

    def merge(self, other: "ChoiceMap", overwrite: bool = False
              ) -> "ChoiceMap":
        """Functional merge. With ``overwrite=False`` duplicate leaf
        addresses raise; with ``overwrite=True`` ``other`` wins."""
        if type(self) is ChoiceMap and self.is_empty():
            return other.copy()
        if type(other) is not ChoiceMap and hasattr(other, "to_choicemap"):
            other = other.to_choicemap()
        out = self.copy()
        for k, v in other._leaves.items():
            if k in out._leaves and not overwrite:
                raise ValueError(f"duplicate value at key {k!r} in merge")
            if k in out._subs:
                raise ValueError(
                    f"key {k!r} holds a submap in one map, value in other")
            out._leaves[k] = v
        for k, sub in other._subs.items():
            if k in out._leaves:
                raise ValueError(
                    f"key {k!r} holds a value in one map, submap in other")
            if k in out._subs:
                out._subs[k] = out._subs[k].merge(sub, overwrite=overwrite)
            else:
                out._subs[k] = sub.copy()
        return out

    def __eq__(self, other) -> bool:
        if not isinstance(other, ChoiceMap):
            return NotImplemented
        if list(self.addresses()) != list(other.addresses()):
            return False
        return all(torch.equal(_as_tensor(a), _as_tensor(b))
                   for (_, a), (_, b) in zip(self.leaf_items(),
                                             other.leaf_items()))

    def __hash__(self):
        raise TypeError("ChoiceMap is unhashable")

    def allclose(self, other: "ChoiceMap", rtol=1e-5, atol=1e-8) -> bool:
        """Approximate equality on values, exact on structure (Gen's
        ``isapprox`` on choice maps)."""
        if sorted_keys(self._leaves) != sorted_keys(other._leaves):
            return False
        for k, v in self._leaves.items():
            if not _allclose(v, other._leaves[k], rtol, atol):
                return False
        mine = self.get_submaps_shallow()
        theirs = other.get_submaps_shallow()
        if sorted_keys(mine) != sorted_keys(theirs):
            return False
        return all(mine[k].allclose(theirs[k], rtol=rtol, atol=atol)
                   for k in mine)

    # -- iteration & flattening -------------------------------------------

    def addresses(self) -> Iterator[Tuple[Key, ...]]:
        """All full leaf addresses, in deterministic sorted order."""
        for k in sorted_keys(self._leaves):
            yield (k,)
        for k in sorted_keys(self._subs):
            for rest in self._subs[k].addresses():
                yield (k,) + rest

    def leaf_items(self) -> Iterator[Tuple[Tuple[Key, ...], Any]]:
        for path in self.addresses():
            yield path, self.get_value(path)

    def __len__(self) -> int:
        return sum(1 for _ in self.addresses())

    def to_array(self, dtype=None) -> torch.Tensor:
        """Flatten all leaves into one vector in sorted-address order."""
        parts = [_as_tensor(v).reshape(-1) for _, v in self.leaf_items()]
        if not parts:
            return torch.zeros((0,), dtype=dtype or torch.float32)
        flat = torch.cat(parts)
        return flat.to(dtype) if dtype is not None else flat

    def from_array(self, arr) -> "ChoiceMap":
        """A choice map with this map's structure, filled from a flat
        vector (the inverse of :meth:`to_array`)."""
        arr = _as_tensor(arr)
        items = [(p, _as_tensor(v)) for p, v in self.leaf_items()]
        needed = sum(v.numel() for _, v in items)
        if needed != arr.shape[0]:
            raise ValueError(
                f"from_array: array has {arr.shape[0]} elements, "
                f"structure needs {needed}")
        out = ChoiceMap()
        offset = 0
        for path, proto in items:
            n = proto.numel()
            piece = arr[offset:offset + n]
            out.set_value(path, piece.reshape(proto.shape).to(proto.dtype))
            offset += n
        return out

    def as_dict(self) -> Dict:
        """Nested plain-dict view (Gen's ``nested_view``)."""
        d: Dict = {k: self._leaves[k] for k in self._leaves}
        for k, sub in self.get_submaps_shallow().items():
            d[k] = sub.as_dict()
        return d

    def filter(self, selection) -> "ChoiceMap":
        """Restrict to the addresses in ``selection``."""
        out = ChoiceMap()
        for k, v in self._leaves.items():
            if (k,) in selection:
                out.set_value(k, v)
        for k, sub in self._subs.items():
            fsub = sub.filter(selection.subselection(k))
            if not fsub.is_empty():
                out.set_submap(k, fsub)
        return out

    def __repr__(self):
        items = ", ".join(f"{'.'.join(map(str, p))}={v!r}"
                          for p, v in self.leaf_items())
        return f"ChoiceMap({items})"


_EMPTY = ChoiceMap()


def choicemap(*args, **kwargs) -> ChoiceMap:
    """Construct a choice map from (address, value) pairs, keyword leaves,
    or a nested dict."""
    out = ChoiceMap()
    for a in args:
        if isinstance(a, dict):
            for k, v in ChoiceMap.from_dict(a).leaf_items():
                out.set_value(k, v)
        else:
            addr, value = a
            out.set_value(addr, value)
    for k, v in kwargs.items():
        out.set_value(k, v)
    return out


# -- pytree registration: the address structure is the spec ----------------

def _chm_flatten(chm: ChoiceMap):
    leaf_keys = tuple(sorted_keys(chm._leaves))
    sub_keys = tuple(sorted_keys(chm._subs))
    children = [chm._leaves[k] for k in leaf_keys] + [
        chm._subs[k] for k in sub_keys]
    return children, (leaf_keys, sub_keys)


def _chm_unflatten(children, aux) -> ChoiceMap:
    leaf_keys, sub_keys = aux
    out = ChoiceMap()
    n = len(leaf_keys)
    out._leaves = dict(zip(leaf_keys, children[:n]))
    out._subs = dict(zip(sub_keys, children[n:]))
    return out


pytree.register_pytree_node(
    ChoiceMap, _chm_flatten, _chm_unflatten,
    serialized_type_name="gen_tpu_torch.ChoiceMap")
