"""Masked values: dynamically-present constraints.

Counterpart: ``gen_tpu/masked.py``. A :class:`MaskedValue` wraps ``(value,
flag)``: the address is always constrained as far as the trace's structure
goes, but where ``flag`` is False the handler samples instead and the
weight contribution is zeroed, which is ``generate``/``update`` marginalized
over the flag. A :class:`MaskedSelection` holds a flag per address, so
``regenerate`` resamples an address exactly where its flag is set.

Both are registered with ``torch.utils._pytree`` (the flag and the value
are leaves), so ``torch.func.vmap`` carries a flag per lane; the handlers
select with ``torch.where``, never a Python branch on a flag, so that one
vmapped pass serves every lane.

Usage::

    c = ChoiceMap().set_value("y", MaskedValue(obs, present))
    trace, w = model.generate(key, args, c)   # w includes logpdf(obs) only
                                              # where present is True
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from .address import addr_path


class MaskedValue:
    """A constraint value with a per-lane presence flag."""

    __slots__ = ("value", "flag")

    def __init__(self, value, flag):
        self.value = value
        self.flag = flag

    def __repr__(self):
        return f"MaskedValue({self.value!r}, flag={self.flag!r})"


pytree.register_pytree_node(
    MaskedValue, lambda m: ([m.value, m.flag], None),
    lambda c, _: MaskedValue(c[0], c[1]),
    serialized_type_name="gen_tpu_torch.MaskedValue")


def flag_on(flag, like: torch.Tensor) -> torch.Tensor:
    """``flag`` (a Python bool, or a tensor) as a boolean tensor on the
    device of ``like``, for ``torch.where`` beside ``like``."""
    return torch.as_tensor(flag, device=like.device)


def mask(value, flag) -> MaskedValue:
    return MaskedValue(value, torch.as_tensor(flag))


def is_masked(x) -> bool:
    return isinstance(x, MaskedValue)


class MaskedSelection:
    """A selection whose membership flags are boolean tensors.

    ``regenerate`` with a MaskedSelection resamples address a where its
    flag is true: ONE pass whichever coordinate was chosen, in place of a
    K-way mixture of kernels that runs every component.

    Construct with a dict mapping addresses (single keys or tuple paths) to
    boolean scalars: ``MaskedSelection({"x": flags[0], "y": flags[1]})``.
    """

    def __init__(self, flags: dict):
        self._flags = {addr_path(a): f for a, f in flags.items()}

    def flag_at(self, path):
        """Membership flag for a full path (False if absent)."""
        if path in self._flags:
            return self._flags[path]
        return False

    def subselection(self, key):
        sub = {p[1:]: f for p, f in self._flags.items()
               if len(p) > 1 and p[0] == key}
        return MaskedSelection(sub)

    def is_empty_set(self) -> bool:
        return not self._flags

    def complement(self):
        raise NotImplementedError(
            "MaskedSelection complement is not defined (flags vary per "
            "lane)")

    def __contains__(self, addr) -> bool:
        raise TypeError(
            "MaskedSelection membership varies per lane; only `regenerate` "
            "and `project` support it (handlers read flag_at)")


def _msel_flatten(m: MaskedSelection):
    # paths sorted by repr: gen_tpu sorts the tuples themselves, which
    # raises where two paths hold an int and a str at one position
    # (ROADMAP queue 3)
    keys = sorted(m._flags, key=repr)
    return [m._flags[k] for k in keys], tuple(keys)


pytree.register_pytree_node(
    MaskedSelection, _msel_flatten,
    lambda flags, keys: MaskedSelection(dict(zip(keys, flags))),
    serialized_type_name="gen_tpu_torch.MaskedSelection")


def masked_select(**flags) -> MaskedSelection:
    """``masked_select(x=f0, y=f1)``: addresses with per-lane flags."""
    return MaskedSelection(flags)
