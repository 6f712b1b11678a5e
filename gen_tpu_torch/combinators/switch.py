"""Switch combinator: branch selection by the first argument.

Counterpart: ``gen_tpu/combinators/switch.py``. Args are ``(index,
*branch_args)``; the selected branch's choices live directly in the trace
(no extra address level), and an index *change* under ``update`` inherits
shared addresses from the previous branch with weight = generate weight -
previous score. Two modes, as in gen_tpu:

* **concrete index** (a Python int, or a 0-dim tensor that no
  ``torch.func`` transform batches): dispatch to one branch; the trace
  wraps that branch's trace, with the index-change ``update``/
  ``regenerate`` and their discards.
* **batched index** (under ``torch.func.vmap``, e.g. one mixture component
  a particle: gen_tpu's traced index): run ALL branches and select score,
  return value and weight by the index with ``torch.where``, the
  counterpart of ``jnp.select``. Under vmap this is the normal path on the
  card, not an edge case. Presence that varies with the index goes
  through :class:`~gen_tpu_torch.masked.MaskedValue` flags.

``regenerate`` with an index change carries gen_tpu's weight: generate
weight minus the previous scores of the retained choices that the new
branch consumed (the GFI contract), not the reference's formula, whose
``project`` terms count the selected choices twice.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch._C._functorch import is_functorch_wrapped_tensor

from .. import random
from ..choice_map import ChoiceMap
from ..diff import UnknownChange, all_unknown_change
from ..gfi import GenerativeFunction, Trace
from ..masked import MaskedSelection, MaskedValue, flag_on
from ..selection import Selection, select
from ..utils import join_static, split_static


def _is_concrete_index(index) -> bool:
    if isinstance(index, (int, np.integer)):
        return True
    if isinstance(index, torch.Tensor) and not is_functorch_wrapped_tensor(
            index):
        return index.ndim == 0
    return False


def _select(conds, vals, default):
    """``jnp.select``: the value of the first true condition, else
    ``default``."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(flag_on(c, v), v, out)
    return out


def _by_index(index, vals):
    """``vals[index]`` for a (batched) index: a select over the branches,
    0 where the index matches none, on the index's device (a branch's
    weight may still be the CPU scalar its handler started from)."""
    dev = (index.device if isinstance(index, torch.Tensor)
           else torch.as_tensor(vals[0]).device)
    vals = [torch.as_tensor(v).to(dev) for v in vals]
    return _select([index == i for i in range(len(vals))], vals,
                   torch.zeros_like(vals[0]))


def _tree_by_index(index, trees):
    return pytree.tree_map(lambda *xs: _by_index(index, xs), *trees)


class SwitchTrace(Trace):
    """Concrete-index mode: wraps the active branch's trace."""

    __slots__ = ("gen_fn", "index", "branch_trace", "args", "args_mask")

    def __init__(self, gen_fn, index, branch_trace, args, args_mask=None):
        self.gen_fn = gen_fn
        self.index = index
        self.branch_trace = branch_trace
        self.args = args
        self.args_mask = args_mask

    def get_args(self):
        return self.args

    def get_retval(self):
        return self.branch_trace.get_retval()

    def get_score(self):
        return self.branch_trace.get_score()

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self):
        return self.branch_trace.get_choices()

    def project(self, selection: Selection):
        return self.branch_trace.project(selection)

    def __getitem__(self, addr):
        return self.branch_trace[addr]


def _st_flatten(t: SwitchTrace):
    args_dyn, args_aux = split_static(t.args, t.args_mask)
    return [t.branch_trace, args_dyn], (t.gen_fn, t.index, args_aux)


def _st_unflatten(c, aux):
    gen_fn, index, args_aux = aux
    return SwitchTrace(gen_fn, index, c[0], join_static(c[1], args_aux),
                       args_aux[1])


pytree.register_pytree_node(
    SwitchTrace, _st_flatten, _st_unflatten,
    serialized_type_name="gen_tpu_torch.SwitchTrace")


class AllBranchesSwitchTrace(Trace):
    """Batched-index mode: holds every branch's trace plus the index."""

    __slots__ = ("gen_fn", "index", "branch_traces", "args", "args_mask")

    def __init__(self, gen_fn, index, branch_traces, args, args_mask=None):
        self.gen_fn = gen_fn
        self.index = index
        self.branch_traces = branch_traces
        self.args = args
        self.args_mask = args_mask

    def get_args(self):
        return self.args

    def get_retval(self):
        return _tree_by_index(self.index,
                              [t.get_retval() for t in self.branch_traces])

    def get_score(self):
        return _by_index(self.index,
                         [t.get_score() for t in self.branch_traces])

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self):
        if _is_concrete_index(self.index):
            return self.branch_traces[int(self.index)].get_choices()
        raise ValueError(
            "Switch with a batched index has no single choice-map view; "
            "use GFI operations, or a concrete index")

    def project(self, selection: Selection):
        return _by_index(self.index, [t.project(selection)
                                      for t in self.branch_traces])


def _abt_flatten(t: AllBranchesSwitchTrace):
    args_dyn, args_aux = split_static(t.args, t.args_mask)
    index_dyn, index_aux = split_static(t.index)
    return ([index_dyn, list(t.branch_traces), args_dyn],
            (t.gen_fn, index_aux, args_aux))


def _abt_unflatten(c, aux):
    gen_fn, index_aux, args_aux = aux
    return AllBranchesSwitchTrace(gen_fn, join_static(c[0], index_aux),
                                  list(c[1]), join_static(c[2], args_aux),
                                  args_aux[1])


pytree.register_pytree_node(
    AllBranchesSwitchTrace, _abt_flatten, _abt_unflatten,
    serialized_type_name="gen_tpu_torch.AllBranchesSwitchTrace")


class SwitchCombinator(GenerativeFunction):
    """``Switch(b0, b1, ...)``: args = (index, *shared_branch_args)."""

    def __init__(self, *branches: GenerativeFunction):
        if len(branches) == 1 and isinstance(branches[0], (list, tuple)):
            branches = tuple(branches[0])
        self.branches = tuple(branches)

    # structural equality: combinators built inline must compare equal
    # across replays of a model body (the instance rides in the trace's
    # pytree spec)
    def __eq__(self, other):
        return type(other) is type(self) and other.branches == self.branches

    def __hash__(self):
        return hash((type(self), self.branches))

    def __repr__(self):
        return f"Switch({self.branches!r})"

    def _promote(self, key, trace: SwitchTrace) -> AllBranchesSwitchTrace:
        """Lift a concrete-index trace into the all-branches universe
        (update/regenerate with a batched index). The fresh sibling
        universes never contribute to selected outputs: every quantity that
        depends on the previous trace selects by its concrete index."""
        bargs = tuple(trace.args[1:])
        keys = random.split(key, len(self.branches))
        subs = [trace.branch_trace if i == trace.index
                else b.simulate(keys[i], bargs)
                for i, b in enumerate(self.branches)]
        return AllBranchesSwitchTrace(self, trace.index, subs, trace.args)

    # -- GFI --------------------------------------------------------------

    def simulate(self, key, args: Tuple):
        index, bargs = args[0], tuple(args[1:])
        if _is_concrete_index(index):
            sub = self.branches[int(index)].simulate(key, bargs)
            return SwitchTrace(self, int(index), sub, args)
        keys = random.split(key, len(self.branches))
        subs = [b.simulate(k, bargs) for b, k in zip(self.branches, keys)]
        return AllBranchesSwitchTrace(self, index, subs, args)

    def generate(self, key, args: Tuple, constraints: ChoiceMap = None):
        index, bargs = args[0], tuple(args[1:])
        constraints = constraints if constraints is not None else ChoiceMap()
        if _is_concrete_index(index):
            sub, w = self.branches[int(index)].generate(key, bargs,
                                                        constraints)
            return SwitchTrace(self, int(index), sub, args), w
        keys = random.split(key, len(self.branches))
        pairs = [b.generate(k, bargs, constraints)
                 for b, k in zip(self.branches, keys)]
        subs = [p[0] for p in pairs]
        return (AllBranchesSwitchTrace(self, index, subs, args),
                _by_index(index, [p[1] for p in pairs]))

    def assess(self, args: Tuple, choices: ChoiceMap):
        index, bargs = args[0], tuple(args[1:])
        if _is_concrete_index(index):
            return self.branches[int(index)].assess(bargs, choices)
        outs = [b.assess(bargs, choices) for b in self.branches]
        return (_by_index(index, [o[0] for o in outs]),
                _tree_by_index(index, [o[1] for o in outs]))

    def project(self, trace, selection: Selection):
        return trace.project(selection)

    def update(self, key, trace, args: Tuple, argdiffs: Tuple,
               constraints: ChoiceMap):
        index, bargs = args[0], tuple(args[1:])
        bdiffs = tuple(argdiffs[1:]) if len(argdiffs) > 1 else \
            all_unknown_change(bargs)
        constraints = constraints if constraints is not None else ChoiceMap()

        if isinstance(trace, SwitchTrace) and _is_concrete_index(index):
            if int(index) == trace.index:
                sub, w, rd, disc = self.branches[int(index)].update(
                    key, trace.branch_trace, bargs, bdiffs, constraints)
                return SwitchTrace(self, int(index), sub, args), w, rd, disc
            # index change: inherit shared addresses from the old branch
            # (weight = generate weight - previous score)
            prev_choices = trace.get_choices()
            merged = prev_choices.merge(constraints, overwrite=True)
            sub, gen_w = self.branches[int(index)].generate(key, bargs,
                                                            merged)
            weight = gen_w - trace.get_score()
            discard = _switch_discard(prev_choices, constraints,
                                      sub.get_choices())
            return (SwitchTrace(self, int(index), sub, args), weight,
                    UnknownChange, discard)

        if isinstance(trace, SwitchTrace):  # batched index, concrete prev
            if key is None:
                raise ValueError(
                    "Switch.update with a batched index on a concrete-index "
                    "trace requires a key: promoting to the all-branches "
                    "universe samples the sibling branches. Build the "
                    "initial trace with a batched index, or pass a key.")
            key, k_promote = random.split(key)
            trace = self._promote(k_promote, trace)

        # batched-index mode (masked universe): run BOTH the same-index
        # update and the changed-index generate-with-inherited-choices for
        # every branch, then select per branch by (index == b) & ~same.
        # Each branch's semantics are the concrete-index path's, with
        # presence expressed as MaskedValue flags instead of host branches.
        if isinstance(trace, AllBranchesSwitchTrace):
            nb = len(self.branches)
            prev_index = trace.index
            prev_maps = [t.get_choices() for t in trace.branch_traces]
            same = torch.as_tensor(index == prev_index)
            keys = random.split(key, 2 * nb) if key is not None \
                else [None] * (2 * nb)
            # branches consume only the constraints they can address (a
            # masked discard holds other branches' addresses); a path no
            # branch can consume is still an error
            per_branch_cons = [_filter_for_branch(constraints, prev_maps[i])
                               for i in range(nb)]
            _check_some_branch_consumes(constraints, prev_maps)
            outs = [b.update(k, t, bargs, bdiffs, c)
                    for b, t, k, c in zip(self.branches, trace.branch_traces,
                                          keys[:nb], per_branch_cons)]
            ws = [o[1] for o in outs]
            discard = _masked_switch_discard(prev_maps, prev_index, index,
                                             same, constraints)

            if key is None:
                # key-free path (Gibbs-style updates): no sampling, so the
                # changed-index generate-with-inheritance cannot run. Each
                # universe keeps its OWN unconstrained values; the
                # index-change weight new_score - prev_score is exact when
                # the constraints cover every changed address (the
                # key=None contract).
                new_score = _by_index(index, [o[0].get_score()
                                              for o in outs])
                weight = torch.where(same, _by_index(index, ws),
                                     new_score - trace.get_score())
                return (AllBranchesSwitchTrace(self, index,
                                               [o[0] for o in outs], args),
                        weight, UnknownChange, discard)

            # changed index: generate branch b constrained by the previous
            # branch's compatible choices under the explicit constraints
            gens = []
            for b_idx, branch in enumerate(self.branches):
                merged = per_branch_cons[b_idx].copy()
                for path, tval in prev_maps[b_idx].leaf_items():
                    cv = merged.get_value(path) \
                        if merged.has_value(path) else None
                    if cv is not None and not isinstance(cv, MaskedValue):
                        continue  # a hard constraint wins outright
                    mv = _masked_prev_value(prev_maps, prev_index, path,
                                            template=tval)
                    if mv is None:
                        continue
                    if cv is None:
                        merged.set_value(path, MaskedValue(*mv))
                    else:
                        # masked constraint: constrain where its flag is
                        # on, inherit the previous branch's value where off
                        merged.set_value(path, MaskedValue(
                            torch.where(flag_on(cv.flag, mv[0]),
                                        torch.as_tensor(cv.value), mv[0]),
                            flag_on(cv.flag, mv[0]) | mv[1]))
                gens.append(branch.generate(keys[nb + b_idx], bargs, merged))

            subs = [_where_tree((index == b_idx) & ~same, gens[b_idx][0],
                                outs[b_idx][0]) for b_idx in range(nb)]
            weight = torch.where(
                same, _by_index(index, ws),
                _by_index(index, [g[1] for g in gens]) - trace.get_score())
            return (AllBranchesSwitchTrace(self, index, subs, args), weight,
                    UnknownChange, discard)
        raise TypeError(f"unexpected trace type {type(trace).__name__}")

    def regenerate(self, key, trace, args: Tuple, argdiffs: Tuple,
                   selection: Selection):
        index, bargs = args[0], tuple(args[1:])
        bdiffs = tuple(argdiffs[1:]) if len(argdiffs) > 1 else \
            all_unknown_change(bargs)

        if isinstance(trace, SwitchTrace) and _is_concrete_index(index):
            if int(index) == trace.index:
                sub, w, rd = self.branches[int(index)].regenerate(
                    key, trace.branch_trace, bargs, bdiffs, selection)
                return SwitchTrace(self, int(index), sub, args), w, rd
            # index change: constrain the new branch with the retained
            # (unselected) choices; weight = generate weight - the previous
            # scores of the retained choices the new branch consumed. This
            # is the GFI contract's weight: the selected and dropped terms
            # cancel against the internal forward/backward proposals. The
            # reference's +-project(selection) terms count the selected
            # choices twice (biased; gen_tpu's mixture-posterior MH test).
            retained = trace.get_choices().filter(selection.complement())
            sub, gen_w = self.branches[int(index)].generate(key, bargs,
                                                            retained)
            new_choices = sub.get_choices()
            consumed = [p for p, _ in retained.leaf_items()
                        if new_choices.has_value(p)]
            back = trace.project(select(*consumed)) if consumed \
                else torch.zeros_like(gen_w)
            return (SwitchTrace(self, int(index), sub, args), gen_w - back,
                    UnknownChange)

        if isinstance(trace, SwitchTrace):  # batched index, concrete prev
            key, k_promote = random.split(key)
            trace = self._promote(k_promote, trace)

        if isinstance(trace, AllBranchesSwitchTrace):
            nb = len(self.branches)
            prev_index = trace.index
            prev_maps = [t.get_choices() for t in trace.branch_traces]
            same = torch.as_tensor(index == prev_index)
            keys = random.split(key, 2 * nb)
            outs = [b.regenerate(k, t, bargs, bdiffs, selection)
                    for b, t, k in zip(self.branches, trace.branch_traces,
                                       keys[:nb])]

            # changed index: generate branch b constrained with the
            # previous branch's retained (unselected, shape-compatible)
            # choices; weight = generate weight - the previous scores of
            # the retained choices the new branch consumed (as the
            # concrete-index path above)
            gens, back_terms = [], []
            for b_idx, branch in enumerate(self.branches):
                retained = ChoiceMap()
                back = torch.zeros_like(torch.as_tensor(trace.get_score()))
                for path, tval in prev_maps[b_idx].leaf_items():
                    sflag = _sel_membership(selection, path)
                    if sflag is True:
                        continue  # statically selected: never retained
                    mv = _masked_prev_value(prev_maps, prev_index, path,
                                            template=tval)
                    if mv is None:
                        continue
                    val, dflag = mv
                    # MaskedSelection: membership is a per-lane flag;
                    # retain exactly where the address is NOT selected
                    flag = dflag if sflag is False else \
                        dflag & ~flag_on(sflag, dflag)
                    retained.set_value(path, MaskedValue(val, flag))
                    back = back + torch.where(
                        flag, trace.project(select(path)), 0.0)
                gens.append(branch.generate(keys[nb + b_idx], bargs,
                                            retained))
                back_terms.append(back)
            changed_w = (_by_index(index, [g[1] for g in gens])
                         - _by_index(index, back_terms))

            subs = [_where_tree((index == b_idx) & ~same, gens[b_idx][0],
                                outs[b_idx][0]) for b_idx in range(nb)]
            weight = torch.where(same, _by_index(index, [o[1] for o in outs]),
                                 changed_w)
            return (AllBranchesSwitchTrace(self, index, subs, args),
                    weight, UnknownChange)
        raise TypeError(f"unexpected trace type {type(trace).__name__}")


def _where_tree(flag, a, b):
    """Leafwise ``torch.where(flag, a, b)`` over two traces of one
    structure."""
    return pytree.tree_map(
        lambda g, u: torch.where(flag, g.to(flag.device), u.to(flag.device)),
        a, b)


class _MixedAvalError(NotImplementedError):
    """A shared address stores different shapes/dtypes across branches."""


def _aval(x):
    x = torch.as_tensor(x)
    return (tuple(x.shape), x.dtype)


def _filter_for_branch(constraints: ChoiceMap, template: ChoiceMap):
    """Constraints restricted to addresses the branch actually has."""
    out = ChoiceMap()
    for path, v in constraints.leaf_items():
        if template.has_value(path):
            out.set_value(path, v)
    return out


def _check_some_branch_consumes(constraints: ChoiceMap, prev_maps):
    orphans = [p for p, _ in constraints.leaf_items()
               if not any(m.has_value(p) for m in prev_maps)]
    if orphans:
        raise ValueError(f"Switch.update: no branch has addresses "
                         f"{orphans!r}")


def _sel_membership(selection, path):
    """Membership of ``path`` in a selection: a Python bool for static
    selections, a per-lane flag for a MaskedSelection."""
    if isinstance(selection, MaskedSelection):
        return selection.flag_at(path)  # a flag, or literal False
    return path in selection


def _masked_prev_value(prev_maps, prev_index, path, template=None):
    """(value, flag) for ``path`` under the (batched) previous branch
    index.

    Only branches storing a value shape/dtype-compatible with ``template``
    can donate; ``flag`` is False where the previous branch has no
    compatible value (so a MaskedValue constraint built from this samples
    fresh). Returns None when no branch can donate at all."""
    donors = [i for i, m in enumerate(prev_maps) if m.has_value(path)]
    if template is not None:
        t = _aval(template)
        donors = [i for i in donors
                  if _aval(prev_maps[i].get_value(path)) == t]
    else:
        avals = {_aval(prev_maps[i].get_value(path)) for i in donors}
        if len(avals) > 1:
            raise _MixedAvalError(
                f"Switch with a batched index: address {path!r} has "
                f"different shapes/dtypes across branches ({avals}); a "
                "single select-able value cannot represent it. Pad the "
                "branches to a common shape, or use a concrete index.")
    if not donors:
        return None
    vals = [torch.as_tensor(prev_maps[i].get_value(path)) for i in donors]
    conds = [flag_on(prev_index == i, vals[0]) for i in donors]
    value = vals[0] if len(vals) == 1 else _select(conds, vals, vals[0])
    flag = conds[0]
    for c in conds[1:]:
        flag = flag | c
    return value, flag


def _masked_switch_discard(prev_maps, prev_index, index, same,
                           constraints: ChoiceMap) -> ChoiceMap:
    """Batched-index discard: previous-branch choices overwritten by
    constraints, or (on an index change) absent from the new branch, with
    presence expressed as MaskedValue flags (the reference's discard
    marginalized over the batched indices)."""
    paths, seen = [], set()
    for m in prev_maps:
        for path, _ in m.leaf_items():
            if path not in seen:
                seen.add(path)
                paths.append(path)
    discard = ChoiceMap()
    for path in paths:
        try:
            value, has_prev = _masked_prev_value(prev_maps, prev_index, path)
        except _MixedAvalError:
            # unrepresentable: the branches disagree on this address's
            # shape/dtype. Omit it (the discard is best-effort in batched
            # mode) rather than failing updates that never read the discard
            warnings.warn(
                f"Switch batched-index discard omits address {path!r}: "
                "branches store different shapes/dtypes there. "
                "Custom-proposal MH over this address will mis-weight; pad "
                "the branches to a common shape to fix.", RuntimeWarning,
                stacklevel=2)
            continue
        if constraints.has_value(path):
            cv = constraints.get_value(path)
            const_flag = cv.flag if isinstance(cv, MaskedValue) else True
        else:
            const_flag = False
        # which NEW branches lack a compatible slot for this path (static)
        aval = _aval(value)
        lacking = [b for b, m in enumerate(prev_maps)
                   if not (m.has_value(path)
                           and _aval(m.get_value(path)) == aval)]
        lacks_new = flag_on(False, value)
        for b in lacking:
            lacks_new = lacks_new | (index == b)
        flag = has_prev & (flag_on(const_flag, value) | (~same & lacks_new))
        if not is_functorch_wrapped_tensor(flag) and flag.numel() == 1 \
                and not bool(flag):
            continue  # never discarded: keep the map empty
        discard.set_value(path, MaskedValue(value, flag))
    return discard


def _switch_discard(prev_choices: ChoiceMap, constraints: ChoiceMap,
                    new_choices: ChoiceMap) -> ChoiceMap:
    """Choices of the previous branch that were overwritten by constraints
    or do not appear in the new branch."""
    discard = ChoiceMap()
    for path, value in prev_choices.leaf_items():
        if constraints.has_value(path) or not new_choices.has_value(path):
            discard.set_value(path, value)
    return discard


def Switch(*branches) -> SwitchCombinator:
    return SwitchCombinator(*branches)
