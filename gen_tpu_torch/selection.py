"""Selections: sets of hierarchical addresses.

Counterpart: ``gen_tpu/selection.py``. Selections are static metadata and
hold no tensors, so the classes carry over unchanged.
``selection_signature`` and ``static_leaf_paths`` tell Unfold's
``regenerate`` when gen_tpu would lower per-step selections onto a masked
selection; ``batch_selections`` itself waits for ``masked.py`` (ROADMAP
queue 1 item 5).
"""

from __future__ import annotations

from typing import Dict

from .address import Address, Key, addr_head_rest


class Selection:
    """Abstract set of hierarchical addresses."""

    def __contains__(self, addr: Address) -> bool:
        raise NotImplementedError

    def subselection(self, key: Key) -> "Selection":
        """The selection at a nested key (Gen's ``selection[key]``)."""
        raise NotImplementedError

    def __getitem__(self, key: Key) -> "Selection":
        return self.subselection(key)

    def is_empty_set(self) -> bool:
        return False

    def complement(self) -> "Selection":
        return ComplementSelection(self)


class AllSelection(Selection):
    """Selects every address."""

    def __contains__(self, addr: Address) -> bool:
        return True

    def subselection(self, key: Key) -> Selection:
        return self

    def complement(self) -> "Selection":
        return NONE

    def __repr__(self):
        return "AllSelection()"


class EmptySelection(Selection):
    """Selects nothing."""

    def __contains__(self, addr: Address) -> bool:
        return False

    def subselection(self, key: Key) -> Selection:
        return self

    def is_empty_set(self) -> bool:
        return True

    def complement(self) -> "Selection":
        return ALL

    def __repr__(self):
        return "EmptySelection()"


ALL = AllSelection()
NONE = EmptySelection()


class ComplementSelection(Selection):
    """Complement of another selection."""

    def __init__(self, inner: Selection):
        self.inner = inner

    def __contains__(self, addr: Address) -> bool:
        return addr not in self.inner

    def subselection(self, key: Key) -> Selection:
        return ComplementSelection(self.inner.subselection(key))

    def complement(self) -> Selection:
        return self.inner

    def __repr__(self):
        return f"complement({self.inner!r})"


class HierarchicalSelection(Selection):
    """A trie of subselections (Gen's ``DynamicSelection``)."""

    def __init__(self, subs: Dict[Key, Selection] | None = None):
        self.subs: Dict[Key, Selection] = dict(subs) if subs else {}

    def __contains__(self, addr: Address) -> bool:
        head, rest = addr_head_rest(addr)
        sub = self.subs.get(head)
        if sub is None:
            return False
        if rest == ():
            # a key is "in" the selection if its whole subtree is selected
            return isinstance(sub, AllSelection)
        return rest in sub

    def subselection(self, key: Key) -> Selection:
        return self.subs.get(key, NONE)

    def set_subselection(self, addr: Address,
                         sel: Selection) -> "HierarchicalSelection":
        head, rest = addr_head_rest(addr)
        if rest == ():
            self.subs[head] = sel
        else:
            sub = self.subs.get(head)
            if not isinstance(sub, HierarchicalSelection):
                sub = HierarchicalSelection()
                self.subs[head] = sub
            sub.set_subselection(rest, sel)
        return self

    def is_empty_set(self) -> bool:
        return all(s.is_empty_set() for s in self.subs.values())

    def __repr__(self):
        return f"select({sorted(map(str, self.subs))})"


def select(*addrs: Address) -> Selection:
    """Select the given addresses (and their whole subtrees)."""
    out = HierarchicalSelection()
    for a in addrs:
        out.set_subselection(a, ALL)
    return out


def complement(sel: Selection) -> Selection:
    return sel.complement()


def selection_signature(sel):
    """Structural signature of a static selection (content-based equality).
    Raises NotImplementedError for selection types whose membership is not
    statically enumerable."""
    if isinstance(sel, AllSelection):
        return ("all",)
    if isinstance(sel, EmptySelection):
        return ("empty",)
    if isinstance(sel, ComplementSelection):
        return ("compl", selection_signature(sel.inner))
    if isinstance(sel, HierarchicalSelection):
        return ("hier", tuple(sorted(
            ((k, selection_signature(v)) for k, v in sel.subs.items()),
            key=lambda kv: repr(kv[0]))))
    raise NotImplementedError(
        f"{type(sel).__name__} selections have no static signature")


def static_leaf_paths(sel, prefix=()):
    """Explicit address paths a static selection selects. A bare
    AllSelection at the root (whose address universe is unknown) and
    selections that are not statically enumerable raise
    NotImplementedError."""
    if isinstance(sel, EmptySelection):
        return []
    if isinstance(sel, AllSelection):
        if not prefix:
            raise NotImplementedError(
                "a bare AllSelection cannot be expanded into addresses")
        return [prefix]
    if isinstance(sel, HierarchicalSelection):
        out = []
        for k, v in sel.subs.items():
            out.extend(static_leaf_paths(v, prefix + (k,)))
        return out
    raise NotImplementedError(
        f"{type(sel).__name__} selections are not statically enumerable")
