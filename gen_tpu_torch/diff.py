"""Change hints ("diffs") for incremental GFI operations.

Counterpart: ``gen_tpu/diff.py``. Ported: ``NoChange``, ``UnknownChange``,
``IntDiff`` (the signal of Unfold's O(1) extension path),
``all_no_change`` and ``all_unknown_change``. ``Diffed``, ``VectorDiff``,
``SetDiff`` and ``DictDiff`` are not ported: no update path reads them.
"""

from __future__ import annotations


class Diff:
    """Abstract change hint for a value between two GFI calls."""


class _NoChange(Diff):
    def __repr__(self):
        return "NoChange()"


class _UnknownChange(Diff):
    def __repr__(self):
        return "UnknownChange()"


NoChange = _NoChange()
UnknownChange = _UnknownChange()


class IntDiff(Diff):
    """An integer changed by a known amount."""

    def __init__(self, difference: int):
        self.difference = difference

    def __repr__(self):
        return f"IntDiff({self.difference})"


def all_no_change(args) -> tuple:
    return tuple(NoChange for _ in args)


def all_unknown_change(args) -> tuple:
    return tuple(UnknownChange for _ in args)
