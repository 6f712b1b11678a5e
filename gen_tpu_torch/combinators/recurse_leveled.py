"""Leveled Recurse: one batched call per tree level.

Counterpart: ``gen_tpu/combinators/recurse_leveled.py``, all of it. Same
contract as :mod:`.recurse` (the per-node arena), but each tree LEVEL is
one ``torch.func.vmap`` batch: level d is a single batched production
(resp. aggregation) call over its B^d slots. Score and weight bookkeeping
is identical, with per-lane active masks; constraints whose presence
varies from node to node become :class:`~gen_tpu_torch.masked.MaskedValue`
lanes, so one batched call serves every constraint pattern of the same
address structure. Keys are ``split(fold_in(k_prod, d), n)`` and
``split(fold_in(k_agg, d), n)`` for the level's n slots, ``(k_prod,
k_agg) = split(key)``, as in gen_tpu; the weights equal the per-node
arena's.

The trace holds per-level batched subtraces (leading axis B^d).
``regenerate`` takes uniform per-level selections (one shared
subselection) and node-varying ones, lowered onto one batched
:class:`~gen_tpu_torch.masked.MaskedSelection` a level. Node-varying
selections must name choice addresses explicitly. The choices view and
the discard of ``update`` need concrete masks, as in gen_tpu: under a
``torch.func`` transform (gen_tpu's traced mask) the choices view raises
and the discard is empty.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from .. import random
from ..choice_map import ChoiceMap
from ..diff import UnknownChange, all_unknown_change
from ..gfi import GenerativeFunction, Trace
from ..selection import (NONE, Selection, selection_signature,
                         static_leaf_paths)
from ..utils import join_static, split_static
from .recurse import (AGG, PROD, _device_of, _here, _is_batched, _on,
                      num_nodes)
from .vector import tree_index, tree_stack

__all__ = ["LeveledRecurseCombinator", "RecurseLeveled"]


def _level_offsets(max_branch: int, max_depth: int):
    offs, sizes = [], []
    off, size = 0, 1
    for _ in range(max_depth):
        offs.append(off)
        sizes.append(size)
        off += size
        size *= max_branch
    return offs, sizes


def _bcast(x, n, device):
    """The root input as a batch of ``n`` on the walk's device (a Python
    number would otherwise be a CPU tensor with a batch axis, which no
    CUDA op takes beside its own)."""
    x = torch.as_tensor(x, device=device)
    return torch.broadcast_to(x, (n,) + tuple(x.shape))


def _uniform_level_subsel(selection, offs, sizes, d):
    """The level's shared subselection if every node of level d is selected
    identically, else None."""
    rep = selection.subselection(offs[d])
    sig = selection_signature(rep)
    for j in range(1, sizes[d]):
        if selection_signature(selection.subselection(offs[d] + j)) != sig:
            return None
    return rep


def _lane_where(keep, a, b):
    """``where(keep, a, b)`` leaf by leaf, ``keep`` (n,) against leaves
    with a leading n axis."""
    return pytree.tree_map(
        lambda x, y: torch.where(
            keep.reshape((-1,) + (1,) * (x.ndim - 1)), x, y), a, b)


class LeveledRecurseTrace(Trace):
    __slots__ = ("gen_fn", "args", "prod_levels", "agg_levels", "active",
                 "retval", "score", "noise", "masks")

    def __init__(self, gen_fn, args, prod_levels, agg_levels, active, retval,
                 score, noise, masks=(None, None)):
        self.gen_fn = gen_fn
        self.masks = masks  # static leaves of args and retval (RecurseTrace)
        self.args = args
        self.prod_levels = tuple(prod_levels)  # per-level batched subtraces
        self.agg_levels = tuple(agg_levels)
        self.active = tuple(active)            # per-level (B^d,) bool
        self.retval = retval
        self.score = score
        self.noise = noise

    def get_args(self):
        return self.args

    def get_retval(self):
        return self.retval

    def get_score(self):
        return self.score

    def get_gen_fn(self):
        return self.gen_fn

    def _locate(self, i: int):
        offs, sizes = _level_offsets(self.gen_fn.max_branch,
                                     self.gen_fn.max_depth)
        for d in reversed(range(len(offs))):
            if i >= offs[d]:
                return d, i - offs[d]
        raise KeyError(i)

    def _node_sub(self, i: int, kind: str):
        d, local = self._locate(i)
        levels = self.prod_levels if kind == PROD else self.agg_levels
        return tree_index(levels[d], local)

    def get_choices(self) -> ChoiceMap:
        if any(_is_batched(a) for a in self.active):
            raise ValueError(
                "Recurse choices view requires a concrete active mask")
        offs, _ = _level_offsets(self.gen_fn.max_branch,
                                 self.gen_fn.max_depth)
        out = ChoiceMap()
        for d, act in enumerate(self.active):
            for local, is_act in enumerate(act.tolist()):
                if not is_act:
                    continue
                i = offs[d] + local
                p = tree_index(self.prod_levels[d], local).get_choices()
                if not p.is_empty():
                    out.set_submap((i, PROD), p)
                a = tree_index(self.agg_levels[d], local).get_choices()
                if not a.is_empty():
                    out.set_submap((i, AGG), a)
        return out

    def project(self, selection: Selection):
        if hasattr(selection, "is_empty_set") and selection.is_empty_set():
            return self.noise
        offs, sizes = _level_offsets(self.gen_fn.max_branch,
                                     self.gen_fn.max_depth)
        total = torch.zeros((), device=self.active[0].device)
        for d in range(len(offs)):
            sub = _uniform_level_subsel(selection, offs, sizes, d)
            if sub is not None:
                # one vmapped project per level
                psel = sub.subselection(PROD)
                asel = sub.subselection(AGG)
                p = vmap(lambda t: t.project(psel))(self.prod_levels[d])
                a = vmap(lambda t: t.project(asel))(self.agg_levels[d])
                total = total + torch.sum(
                    torch.where(self.active[d], p + a, 0.0))
                continue
            for local in range(sizes[d]):  # node-varying selection
                i = offs[d] + local
                psel = selection.subselection(i).subselection(PROD)
                asel = selection.subselection(i).subselection(AGG)
                p = tree_index(self.prod_levels[d], local).project(psel)
                a = tree_index(self.agg_levels[d], local).project(asel)
                total = total + torch.where(self.active[d][local], p + a,
                                            0.0)
        return total

    def __getitem__(self, addr):
        from ..address import addr_path
        path = addr_path(addr)
        i, kind = path[0], path[1]
        sub = self._node_sub(i, kind)
        rest = path[2:]
        if not rest:
            return sub.get_retval()
        return sub[rest if len(rest) > 1 else rest[0]]


def _lt_flatten(t: LeveledRecurseTrace):
    args_dyn, args_aux = split_static(t.args, t.masks[0])
    ret_dyn, ret_aux = split_static(t.retval, t.masks[1])
    return ([args_dyn, list(t.prod_levels), list(t.agg_levels),
             list(t.active), ret_dyn, t.score, t.noise],
            (t.gen_fn, args_aux, ret_aux))


def _lt_unflatten(c, aux):
    gen_fn, args_aux, ret_aux = aux
    return LeveledRecurseTrace(gen_fn, join_static(c[0], args_aux), c[1],
                               c[2], c[3], join_static(c[4], ret_aux), c[5],
                               c[6], (args_aux[1], ret_aux[1]))


pytree.register_pytree_node(
    LeveledRecurseTrace, _lt_flatten, _lt_unflatten,
    serialized_type_name="gen_tpu_torch.LeveledRecurseTrace")


class LeveledRecurseCombinator(GenerativeFunction):
    """``RecurseLeveled(production, aggregation, max_branch, max_depth,
    w_example)``: the contract of :class:`RecurseCombinator`, one batched
    call a level."""

    def __init__(self, production: GenerativeFunction,
                 aggregation: GenerativeFunction, max_branch: int,
                 max_depth: int, w_example):
        self.production = production
        self.aggregation = aggregation
        self.max_branch = max_branch
        self.max_depth = max_depth
        self.n_nodes = num_nodes(max_branch, max_depth)
        self.w_zero = pytree.tree_map(
            lambda x: torch.zeros_like(torch.as_tensor(x)), w_example)

    def __repr__(self):
        return (f"RecurseLeveled({self.production!r}, {self.aggregation!r}, "
                f"B={self.max_branch}, D={self.max_depth})")

    def accepts_output_grad(self) -> bool:
        return True

    def has_argument_grads(self):
        return None

    # -- shared leveled walk ------------------------------------------------

    def _walk(self, key, root_input, prod_op, agg_op, device):
        """prod_op(d, keys, active, batched_inputs) -> (batched_subs, extra);
        agg_op(d, keys, active, v, child_ws, nchild) -> (batched_subs,
        extra). Returns (prod_levels, agg_levels, active_levels, retval,
        prod_extras, agg_extras)."""
        B, D = self.max_branch, self.max_depth
        offs, sizes = _level_offsets(B, D)
        w_zero = _on(self.w_zero, device)
        if key is not None:
            k_prod, k_agg = random.split(key)
        else:
            k_prod, k_agg = None, None

        inputs = pytree.tree_map(lambda x: _bcast(x, 1, device), root_input)
        active = [torch.ones((1,), dtype=torch.bool, device=device)]
        prod_levels, prod_extras, vs, nchilds = [], [], [], []
        for d in range(D):
            n = sizes[d]
            keys = (random.split(random.fold_in(k_prod, d), n)
                    if k_prod is not None else None)
            subs, extra = prod_op(d, keys, active[d], inputs)
            prod_levels.append(subs)
            prod_extras.append(extra)
            v, nchild, child_inputs = subs.get_retval()
            nchild = torch.as_tensor(nchild)
            if d >= D - 1:
                nchild = torch.zeros_like(nchild)
            vs.append(v)
            nchilds.append(nchild)
            if d < D - 1:
                inputs = pytree.tree_map(
                    lambda x: x.reshape((n * B,) + tuple(x.shape[2:])),
                    child_inputs)
                act_next = (active[d][:, None]
                            & (torch.arange(B, device=nchild.device)[None, :]
                               < nchild[:, None]))
                active.append(act_next.reshape(-1))

        agg_levels = [None] * D
        agg_extras = [None] * D
        ws = None
        for d in reversed(range(D)):
            n = sizes[d]
            if ws is None:
                child_ws = pytree.tree_map(
                    lambda x: torch.zeros((n, B) + tuple(x.shape),
                                          dtype=x.dtype, device=x.device),
                    w_zero)
            else:
                child_ws = pytree.tree_map(
                    lambda x: x.reshape((n, B) + tuple(x.shape[1:])), ws)
            keys = (random.split(random.fold_in(k_agg, d), n)
                    if k_agg is not None else None)
            subs, extra = agg_op(d, keys, active[d], vs[d], child_ws,
                                 nchilds[d])
            agg_levels[d] = subs
            agg_extras[d] = extra
            ws = subs.get_retval()

        retval = tree_index(ws, 0)
        return (prod_levels, agg_levels, active, retval, prod_extras,
                agg_extras)

    def _scores(self, prod_levels, agg_levels, active):
        s_act = torch.zeros((), device=active[0].device)
        s_noise = torch.zeros((), device=active[0].device)
        for d in range(self.max_depth):
            node = prod_levels[d].get_score() + agg_levels[d].get_score()
            s_act = s_act + torch.sum(torch.where(active[d], node, 0.0))
            s_noise = s_noise + torch.sum(torch.where(active[d], 0.0, node))
        return s_act, s_noise

    def _make_trace(self, args, prod_levels, agg_levels, active, retval):
        score, noise = self._scores(prod_levels, agg_levels, active)
        return LeveledRecurseTrace(self, args, prod_levels, agg_levels,
                                   active, retval, score, noise)

    def _level_constraints(self, constraints: ChoiceMap, d: int, kind: str,
                           device):
        """Stack the per-node constraint maps of one level into a single
        batched (masked) constraint map: presence that varies by node is a
        MaskedValue with a per-lane flag vector."""
        from ..masked import MaskedValue
        offs, sizes = _level_offsets(self.max_branch, self.max_depth)
        n = sizes[d]
        maps = [constraints.get_submap((offs[d] + j, kind))
                for j in range(n)]
        if all(m.is_empty() for m in maps):
            return None
        paths = []
        seen = set()
        for m in maps:
            for p, _ in m.leaf_items():
                if p not in seen:
                    seen.add(p)
                    paths.append(p)
        out = ChoiceMap()
        for p in paths:
            donors = [j for j in range(n) if maps[j].has_value(p)]
            proto = torch.as_tensor(maps[donors[0]].get_value(p))
            vals = torch.stack([
                torch.as_tensor(maps[j].get_value(p)).to(proto.device)
                if maps[j].has_value(p)
                else torch.zeros_like(proto) for j in range(n)]).to(device)
            flags = torch.tensor([maps[j].has_value(p) for j in range(n)],
                                 device=device)
            out.set_value(p, MaskedValue(vals, flags))
        return out

    # -- GFI ------------------------------------------------------------

    def simulate(self, key, args: Tuple):
        (root_input,) = args

        def prod(d, keys, act, inputs):
            return vmap(
                lambda k, inp: self.production.simulate(k, (inp,)))(
                    keys, inputs), None

        def agg(d, keys, act, v, child_ws, nchild):
            return vmap(
                lambda k, a, cw, nc: self.aggregation.simulate(
                    k, (a, cw, nc)))(keys, v, child_ws, nchild), None

        p, a, act, retval, _, _ = self._walk(key, root_input, prod, agg,
                                             key.device)
        return self._make_trace(args, p, a, act, retval)

    def generate(self, key, args: Tuple, constraints: ChoiceMap = None):
        constraints = constraints if constraints is not None else ChoiceMap()
        (root_input,) = args
        weights = []
        dev = key.device

        def prod(d, keys, act, inputs):
            cons = self._level_constraints(constraints, d, PROD, dev)
            if cons is None:
                subs = vmap(
                    lambda k, inp: self.production.simulate(k, (inp,)))(
                        keys, inputs)
                return subs, None
            subs, w = vmap(
                lambda k, inp, c: self.production.generate(k, (inp,), c))(
                    keys, inputs, cons)
            weights.append(torch.sum(torch.where(act, _here(w, act), 0.0)))
            return subs, None

        def agg(d, keys, act, v, child_ws, nchild):
            cons = self._level_constraints(constraints, d, AGG, dev)
            if cons is None:
                subs = vmap(
                    lambda k, a, cw, nc: self.aggregation.simulate(
                        k, (a, cw, nc)))(keys, v, child_ws, nchild)
                return subs, None
            subs, w = vmap(
                lambda k, a, cw, nc, c: self.aggregation.generate(
                    k, (a, cw, nc), c))(keys, v, child_ws, nchild, cons)
            weights.append(torch.sum(torch.where(act, _here(w, act), 0.0)))
            return subs, None

        p, a, act, retval, _, _ = self._walk(key, root_input, prod, agg, dev)
        trace = self._make_trace(args, p, a, act, retval)
        return trace, (sum(weights) if weights
                       else torch.zeros((), device=dev))

    def assess(self, args: Tuple, choices: ChoiceMap):
        """Key-free full-choices density; the active structure is static
        (which node addresses appear). Levels run as packed vmaps over their
        active slots."""
        (root_input,) = args
        B, D = self.max_branch, self.max_depth
        offs, sizes = _level_offsets(B, D)
        level_act = [[choices.has_submap((offs[d] + j, PROD))
                      for j in range(sizes[d])] for d in range(D)]
        if not level_act[0][0]:
            raise ValueError("Recurse.assess: missing root production")

        weight = torch.zeros(())
        dev = _device_of(choices)
        inputs = pytree.tree_map(lambda x: _bcast(x, 1, dev), root_input)
        vs, nchilds, packed_idx = [], [], []
        for d in range(D):
            idx = [j for j in range(sizes[d]) if level_act[d][j]]
            if not idx:
                packed_idx.append(idx)
                vs.append(None)
                nchilds.append(None)
                continue
            packed_idx.append(idx)
            stacked = tree_stack(
                [choices.get_submap((offs[d] + j, PROD)) for j in idx])
            inp = pytree.tree_map(
                lambda x: x[torch.tensor(idx, device=x.device)], inputs)
            w, retval = vmap(
                lambda i, c: self.production.assess((i,), c))(inp, stacked)
            weight = weight + torch.sum(w)
            v, nchild, child_inputs = retval
            nchild = torch.as_tensor(nchild)
            if d >= D - 1:
                # depth cap: match _walk, so that the aggregation density
                # sees the nchild the trace was built with
                nchild = torch.zeros_like(nchild)
            vs.append(v)
            nchilds.append(nchild)
            if d < D - 1:
                # scatter packed child inputs back to the full level width
                full = pytree.tree_map(
                    lambda x: torch.zeros((sizes[d], B) + tuple(x.shape[2:]),
                                          dtype=x.dtype, device=x.device)
                    .index_copy(0, torch.tensor(idx, device=x.device), x),
                    child_inputs)
                inputs = pytree.tree_map(
                    lambda x: x.reshape((sizes[d] * B,) + tuple(x.shape[2:])),
                    full)

        ws_full = None
        root_w = None
        for d in reversed(range(D)):
            idx = packed_idx[d]
            if not idx:
                ws_full = None
                continue
            dev = nchilds[d].device
            if ws_full is None:
                child_ws = pytree.tree_map(
                    lambda x: torch.zeros((len(idx), B) + tuple(x.shape),
                                          dtype=x.dtype, device=dev),
                    _on(self.w_zero, dev))
            else:
                child_ws = pytree.tree_map(
                    lambda x: x.reshape((sizes[d], B) + tuple(x.shape[1:]))[
                        torch.tensor(idx, device=x.device)], ws_full)
            stacked = tree_stack(
                [choices.get_submap((offs[d] + j, AGG)) for j in idx])
            w, retw = vmap(
                lambda v, cw, nc, c: self.aggregation.assess((v, cw, nc), c)
            )(vs[d], child_ws, nchilds[d], stacked)
            weight = weight + torch.sum(w)
            # scatter outputs to full width for the parent's gather
            ws_full = pytree.tree_map(
                lambda x: torch.zeros((sizes[d],) + tuple(x.shape[1:]),
                                      dtype=x.dtype, device=x.device)
                .index_copy(0, torch.tensor(idx, device=x.device), x), retw)
            root_w = tree_index(retw, 0) if d == 0 else root_w
        return weight, root_w

    def project(self, trace, selection: Selection):
        return trace.project(selection)

    def update(self, key, trace: LeveledRecurseTrace, args: Tuple,
               argdiffs: Tuple, constraints: ChoiceMap):
        constraints = constraints if constraints is not None else ChoiceMap()
        (root_input,) = args
        weights = []
        prev_active = trace.active
        dev = prev_active[0].device

        def case_select(act, was, upd, gen, prev_score):
            new_u, w_u = upd
            new_g, w_g = gen
            w = torch.where(act & was, _here(w_u, act),
                            torch.where(act & ~was, _here(w_g, act),
                                        torch.where(~act & was, -prev_score,
                                                    0.0)))
            return _lane_where(act & was, new_u, new_g), w

        def prod(d, keys, act, inputs):
            cons = self._level_constraints(constraints, d, PROD, dev)
            cons = cons if cons is not None else ChoiceMap()
            prev = trace.prod_levels[d]
            upd = vmap(lambda k, t, inp, c: self.production.update(
                k, t, (inp,), (UnknownChange,), c)[:2])(
                    keys, prev, inputs, cons)
            gen = vmap(lambda k, inp, c: self.production.generate(
                k, (inp,), c))(keys, inputs, cons)
            new, w = case_select(act, prev_active[d], upd, gen,
                                 prev.get_score())
            weights.append(torch.sum(w))
            return new, None

        def agg(d, keys, act, v, child_ws, nchild):
            cons = self._level_constraints(constraints, d, AGG, dev)
            cons = cons if cons is not None else ChoiceMap()
            prev = trace.agg_levels[d]
            upd = vmap(lambda k, t, a, cw, nc, c: self.aggregation.update(
                k, t, (a, cw, nc), all_unknown_change((a, cw, nc)), c)[:2])(
                    keys, prev, v, child_ws, nchild, cons)
            gen = vmap(lambda k, a, cw, nc, c: self.aggregation.generate(
                k, (a, cw, nc), c))(keys, v, child_ws, nchild, cons)
            new, w = case_select(act, prev_active[d], upd, gen,
                                 prev.get_score())
            weights.append(torch.sum(w))
            return new, None

        p, a, act, retval, _, _ = self._walk(key, root_input, prod, agg, dev)
        new_trace = self._make_trace(args, p, a, act, retval)
        discard = self._concrete_discard(trace, act, constraints)
        return new_trace, sum(weights), UnknownChange, discard

    def _concrete_discard(self, trace, new_active, constraints):
        discard = ChoiceMap()
        if any(_is_batched(x) for x in tuple(trace.active)
               + tuple(new_active)):
            return discard
        offs, sizes = _level_offsets(self.max_branch, self.max_depth)
        for d in range(self.max_depth):
            pa = trace.active[d].tolist()
            na = new_active[d].tolist()
            for j in range(sizes[d]):
                i = offs[d] + j
                if pa[j] and not na[j]:
                    for kind in (PROD, AGG):
                        ch = trace._node_sub(i, kind).get_choices()
                        if not ch.is_empty():
                            discard.set_submap((i, kind), ch)
                elif pa[j] and na[j]:
                    for kind in (PROD, AGG):
                        cons = constraints.get_submap((i, kind))
                        if cons.is_empty():
                            continue
                        old = trace._node_sub(i, kind).get_choices()
                        kept = ChoiceMap()
                        for path, val in old.leaf_items():
                            if cons.has_value(path):
                                kept.set_value(path, val)
                        if not kept.is_empty():
                            discard.set_submap((i, kind), kept)
        return discard

    def _level_selection(self, selection: Selection, d: int, kind: str,
                         device):
        """Lower the per-node subselections of one level onto a vmappable
        form: ``(static_sel, None)`` when every node is selected identically
        (one closed-over subselection), else ``(None, batched_masked)``: a
        MaskedSelection whose flag leaves are (B^d,) tensors, mapped lane by
        lane by the level's vmap."""
        from ..masked import MaskedSelection
        offs, sizes = _level_offsets(self.max_branch, self.max_depth)
        rep = _uniform_level_subsel(selection, offs, sizes, d)
        if rep is not None:
            return rep.subselection(kind), None
        n = sizes[d]
        per_node = [set(static_leaf_paths(
            selection.subselection(offs[d] + j).subselection(kind)))
            for j in range(n)]
        union = sorted(set().union(*per_node), key=repr)
        flags = {p: torch.tensor([p in per_node[j] for j in range(n)],
                                 device=device)
                 for p in union}
        return None, MaskedSelection(flags)

    def regenerate(self, key, trace: LeveledRecurseTrace, args: Tuple,
                   argdiffs: Tuple, selection: Selection):
        (root_input,) = args
        weights = []
        prev_active = trace.active
        dev = key.device

        def prod(d, keys, act, inputs):
            prev = trace.prod_levels[d]
            sel_static, sel_masked = self._level_selection(selection, d,
                                                           PROD, dev)
            if sel_masked is None:
                reg = vmap(lambda k, t, inp: self.production.regenerate(
                    k, t, (inp,), (UnknownChange,), sel_static)[:2])(
                        keys, prev, inputs)
            else:
                # node-varying: one batched MaskedSelection, still one vmap
                reg = vmap(
                    lambda k, t, inp, s: self.production.regenerate(
                        k, t, (inp,), (UnknownChange,), s)[:2])(
                            keys, prev, inputs, sel_masked)
            gen = vmap(lambda k, inp: self.production.generate(
                k, (inp,), ChoiceMap()))(keys, inputs)
            keep = act & prev_active[d]
            new = _lane_where(keep, reg[0], gen[0])
            w = torch.where(keep, _here(reg[1], keep),
                            torch.where(~act & prev_active[d],
                                        -vmap(lambda t: t.project(NONE))(
                                            prev),
                                        0.0))
            weights.append(torch.sum(w))
            return new, None

        def agg(d, keys, act, v, child_ws, nchild):
            prev = trace.agg_levels[d]
            sel_static, sel_masked = self._level_selection(selection, d, AGG,
                                                           dev)
            if sel_masked is None:
                reg = vmap(
                    lambda k, t, a, cw, nc: self.aggregation.regenerate(
                        k, t, (a, cw, nc), all_unknown_change((a, cw, nc)),
                        sel_static)[:2])(keys, prev, v, child_ws, nchild)
            else:
                reg = vmap(
                    lambda k, t, a, cw, nc, s: self.aggregation.regenerate(
                        k, t, (a, cw, nc), all_unknown_change((a, cw, nc)),
                        s)[:2])(keys, prev, v, child_ws, nchild, sel_masked)
            gen = vmap(lambda k, a, cw, nc: self.aggregation.generate(
                k, (a, cw, nc), ChoiceMap()))(keys, v, child_ws, nchild)
            keep = act & prev_active[d]
            new = _lane_where(keep, reg[0], gen[0])
            weights.append(torch.sum(torch.where(keep, _here(reg[1], keep),
                                                 0.0)))
            return new, None

        p, a, act, retval, _, _ = self._walk(key, root_input, prod, agg, dev)
        new_trace = self._make_trace(args, p, a, act, retval)
        return new_trace, sum(weights), UnknownChange


def RecurseLeveled(production, aggregation, max_branch: int, max_depth: int,
                   w_example) -> LeveledRecurseCombinator:
    return LeveledRecurseCombinator(production, aggregation, max_branch,
                                    max_depth, w_example)

