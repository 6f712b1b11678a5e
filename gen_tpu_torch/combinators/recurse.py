"""Recurse combinator: stochastic recursion over a tree.

Counterpart: ``gen_tpu/combinators/recurse.py``, all of it. A *production*
kernel maps an input U to a value V plus child inputs, an *aggregation*
kernel combines V with the children's outputs W into this node's output;
addresses are ``(idx, "production")`` / ``(idx, "aggregation")`` with the
0-based heap indexing ``child(parent, j) = parent * B + j + 1``.

gen_tpu's design, a **bounded complete-tree arena**: every slot of a
depth-``max_depth``, branch-``max_branch`` tree always exists in the
trace; an *active* mask (driven by each production's ``num_children``)
selects the real tree. Inactive slots still sample, but their randomness
is non-addressed noise: ``get_score`` is exactly the active tree's joint
and ``project(EmptySelection)`` returns the inactive mass. Everything has
a fixed shape, so structure-changing moves run under ``torch.func.vmap``.
Keys are ``split(key, 2 * n_nodes)``: production i takes key i,
aggregation i key ``n_nodes + i``.

Kernel signatures (fixed width):
  production(u)                          -> (v, num_children, child_inputs)
        child_inputs: pytree with leading axis max_branch
  aggregation(v, child_outputs, num_children) -> w
        child_outputs: pytree with leading axis max_branch (garbage beyond
        num_children: the kernel must mask by num_children)

The two places where gen_tpu tells a concrete mask from a traced one read
here whether a ``torch.func`` transform batches the mask: the choices
view needs a concrete mask, and ``update`` under a transform returns an
empty discard (gen_tpu's under ``jit``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.utils._pytree as pytree
from torch._C._functorch import is_functorch_wrapped_tensor

from .. import random
from ..choice_map import ChoiceMap
from ..diff import UnknownChange, all_unknown_change
from ..gfi import GenerativeFunction, Trace
from ..selection import NONE, Selection
from ..utils import join_static, split_static
from .vector import tree_index, tree_stack

PROD = "production"
AGG = "aggregation"


def num_nodes(max_branch: int, max_depth: int) -> int:
    if max_branch == 1:
        return max_depth
    return (max_branch ** max_depth - 1) // (max_branch - 1)


def child_index(parent: int, j: int, max_branch: int) -> int:
    """0-based heap indexing."""
    return parent * max_branch + j + 1


def parent_index(idx: int, max_branch: int) -> int:
    return (idx - 1) // max_branch


def _is_batched(x) -> bool:
    return isinstance(x, torch.Tensor) and is_functorch_wrapped_tensor(x)


def _device_of(*trees):
    for x in pytree.tree_leaves(trees):
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _here(w, like):
    """A weight on the device of the mask ``like`` (a handler's weight
    stays the CPU scalar it starts as when nothing was constrained)."""
    return torch.as_tensor(w).to(like.device)


def _on(tree, device):
    """``w_example``'s zero prototype on the device of the walk."""
    return pytree.tree_map(lambda x: x.to(device), tree)


class RecurseTrace(Trace):
    __slots__ = ("gen_fn", "args", "prod_subs", "agg_subs", "active",
                 "retval", "score", "noise", "masks")

    def __init__(self, gen_fn, args, prod_subs, agg_subs, active, retval,
                 score, noise, masks=(None, None)):
        self.gen_fn = gen_fn
        # which leaves of args and retval are static, once flattened: the
        # pytree utilities re-flatten a trace whose tensors were replaced by
        # other leaves, and its structure must not change under them
        self.masks = masks
        self.args = args
        self.prod_subs = tuple(prod_subs)   # per-node production subtraces
        self.agg_subs = tuple(agg_subs)     # per-node aggregation subtraces
        self.active = active                # (N,) bool
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

    def get_choices(self) -> ChoiceMap:
        if _is_batched(self.active) or \
                torch.as_tensor(self.active).dtype != torch.bool:
            raise ValueError(
                "Recurse choices view requires a concrete active mask")
        active = self.active.tolist()
        out = ChoiceMap()
        for i, is_act in enumerate(active):
            if not is_act:
                continue
            p = self.prod_subs[i].get_choices()
            if not p.is_empty():
                out.set_submap((i, PROD), p)
            a = self.agg_subs[i].get_choices()
            if not a.is_empty():
                out.set_submap((i, AGG), a)
        return out

    def project(self, selection: Selection):
        if _sel_is_empty(selection):
            return self.noise
        total = torch.zeros((), device=self.active.device)
        for i in range(len(self.prod_subs)):
            act = self.active[i]
            psel = selection.subselection(i).subselection(PROD)
            asel = selection.subselection(i).subselection(AGG)
            p_sel = self.prod_subs[i].project(psel)
            a_sel = self.agg_subs[i].project(asel)
            total = total + torch.where(act, p_sel + a_sel, 0.0)
        return total

    def __getitem__(self, addr):
        from ..address import addr_path
        path = addr_path(addr)
        i, kind = path[0], path[1]
        sub = self.prod_subs[i] if kind == PROD else self.agg_subs[i]
        rest = path[2:]
        if not rest:
            return sub.get_retval()
        return sub[rest if len(rest) > 1 else rest[0]]


def _sel_is_empty(sel) -> bool:
    return hasattr(sel, "is_empty_set") and sel.is_empty_set()


def _rt_flatten(t: RecurseTrace):
    args_dyn, args_aux = split_static(t.args, t.masks[0])
    ret_dyn, ret_aux = split_static(t.retval, t.masks[1])
    return ([args_dyn, list(t.prod_subs), list(t.agg_subs), t.active,
             ret_dyn, t.score, t.noise], (t.gen_fn, args_aux, ret_aux))


def _rt_unflatten(c, aux):
    gen_fn, args_aux, ret_aux = aux
    return RecurseTrace(gen_fn, join_static(c[0], args_aux), c[1], c[2],
                        c[3], join_static(c[4], ret_aux), c[5], c[6],
                        (args_aux[1], ret_aux[1]))


pytree.register_pytree_node(
    RecurseTrace, _rt_flatten, _rt_unflatten,
    serialized_type_name="gen_tpu_torch.RecurseTrace")


class RecurseCombinator(GenerativeFunction):
    """``Recurse(production, aggregation, max_branch, max_depth)``;
    args = (root_input,)."""

    def __init__(self, production: GenerativeFunction,
                 aggregation: GenerativeFunction, max_branch: int,
                 max_depth: int, w_example):
        self.production = production
        self.aggregation = aggregation
        self.max_branch = max_branch
        self.max_depth = max_depth
        self.n_nodes = num_nodes(max_branch, max_depth)
        # zero-prototype of the aggregation output W, the dummy child-output
        # slot of the deepest level's nodes
        self.w_zero = pytree.tree_map(
            lambda x: torch.zeros_like(torch.as_tensor(x)), w_example)

    def __repr__(self):
        return (f"Recurse({self.production!r}, {self.aggregation!r}, "
                f"B={self.max_branch}, D={self.max_depth})")

    def accepts_output_grad(self) -> bool:
        return True

    def has_argument_grads(self):
        return None

    # -- core walk ---------------------------------------------------------

    def _node_depth(self, i):
        d, count, level_size = 0, 0, 1
        while True:
            if i < count + level_size:
                return d
            count += level_size
            level_size *= self.max_branch
            d += 1

    def _walk(self, root_input, per_node_prod, per_node_agg, device):
        """Generic two-pass walk. per_node_prod(i, active, input) ->
        (subtrace, extra); per_node_agg(i, active, v, child_ws, nchild) ->
        (subtrace, extra). Returns (prod_subs, agg_subs, active, retval,
        extras)."""
        N, B = self.n_nodes, self.max_branch
        w_zero = _on(self.w_zero, device)
        inputs = [None] * N
        inputs[0] = root_input
        active = [None] * N
        active[0] = torch.ones((), dtype=torch.bool, device=device)
        prod_subs = [None] * N
        prod_extras = [None] * N
        vs = [None] * N
        nchilds = [None] * N

        for i in range(N):
            if inputs[i] is None:
                raise RuntimeError("arena walk out of order")
            sub, extra = per_node_prod(i, active[i], inputs[i])
            prod_subs[i] = sub
            prod_extras[i] = extra
            v, nchild, child_inputs = sub.get_retval()
            nchild = torch.as_tensor(nchild)
            if self._node_depth(i) >= self.max_depth - 1:
                nchild = torch.zeros_like(nchild)
            vs[i] = v
            nchilds[i] = nchild
            for j in range(B):
                ci = child_index(i, j, B)
                if ci < N:
                    inputs[ci] = tree_index(child_inputs, j)
                    active[ci] = active[i] & (j < nchild)

        agg_subs = [None] * N
        agg_extras = [None] * N
        ws = [None] * N
        for i in reversed(range(N)):
            child_ws = []
            for j in range(B):
                ci = child_index(i, j, B)
                child_ws.append(ws[ci] if ci < N else w_zero)
            stacked = tree_stack(child_ws)
            sub, extra = per_node_agg(i, active[i], vs[i], stacked,
                                      nchilds[i])
            agg_subs[i] = sub
            agg_extras[i] = extra
            ws[i] = sub.get_retval()

        active_arr = torch.stack(active)
        return (prod_subs, agg_subs, active_arr, ws[0],
                (prod_extras, agg_extras))

    def _scores(self, prod_subs, agg_subs, active):
        s_act = torch.zeros((), device=active.device)
        s_noise = torch.zeros((), device=active.device)
        for i in range(self.n_nodes):
            node = prod_subs[i].get_score() + agg_subs[i].get_score()
            s_act = s_act + torch.where(active[i], node, 0.0)
            s_noise = s_noise + torch.where(active[i], 0.0, node)
        return s_act, s_noise

    def _make_trace(self, args, prod_subs, agg_subs, active, retval):
        score, noise = self._scores(prod_subs, agg_subs, active)
        return RecurseTrace(self, args, prod_subs, agg_subs, active, retval,
                            score, noise)

    # -- GFI ---------------------------------------------------------------

    def simulate(self, key, args: Tuple):
        (root_input,) = args
        keys = random.split(key, 2 * self.n_nodes)

        def prod(i, act, inp):
            return self.production.simulate(keys[i], (inp,)), None

        def agg(i, act, v, child_ws, nchild):
            return self.aggregation.simulate(
                keys[self.n_nodes + i], (v, child_ws, nchild)), None

        prod_subs, agg_subs, active, retval, _ = self._walk(
            root_input, prod, agg, key.device)
        return self._make_trace(args, prod_subs, agg_subs, active, retval)

    def generate(self, key, args: Tuple, constraints: ChoiceMap = None):
        constraints = constraints if constraints is not None else ChoiceMap()
        (root_input,) = args
        keys = random.split(key, 2 * self.n_nodes)
        weights = []

        def prod(i, act, inp):
            cons = constraints.get_submap((i, PROD))
            sub, w = self.production.generate(keys[i], (inp,), cons)
            weights.append(torch.where(act, _here(w, act), 0.0))
            return sub, None

        def agg(i, act, v, child_ws, nchild):
            cons = constraints.get_submap((i, AGG))
            sub, w = self.aggregation.generate(
                keys[self.n_nodes + i], (v, child_ws, nchild), cons)
            weights.append(torch.where(act, _here(w, act), 0.0))
            return sub, None

        prod_subs, agg_subs, active, retval, _ = self._walk(
            root_input, prod, agg, key.device)
        trace = self._make_trace(args, prod_subs, agg_subs, active, retval)
        return trace, sum(weights)

    def assess(self, args: Tuple, choices: ChoiceMap):
        """Full-choices density. The active tree is determined by WHICH
        node addresses appear in the choices (the structure is static even
        when values are batched), so assess is key-free and
        differentiable: the generic gradient methods go through it."""
        (root_input,) = args
        N, B = self.n_nodes, self.max_branch
        active = [choices.has_submap((i, PROD)) for i in range(N)]
        if not active[0]:
            raise ValueError("Recurse.assess: missing root production")
        inputs = [None] * N
        inputs[0] = root_input
        weight = torch.zeros(())
        vs, nchilds = [None] * N, [None] * N
        for i in range(N):
            if not active[i]:
                continue
            w, retval = self.production.assess(
                (inputs[i],), choices.get_submap((i, PROD)))
            weight = weight + w
            v, nchild, child_inputs = retval
            nchild = torch.as_tensor(nchild)
            if self._node_depth(i) >= self.max_depth - 1:
                # depth cap: match _walk, which zeroes nchild at the last
                # level
                nchild = torch.zeros_like(nchild)
            vs[i], nchilds[i] = v, nchild
            for j in range(B):
                ci = child_index(i, j, B)
                if ci < N:
                    inputs[ci] = tree_index(child_inputs, j)
        w_zero = _on(self.w_zero, _device_of(vs[0], nchilds[0]))
        ws = [None] * N
        for i in reversed(range(N)):
            if not active[i]:
                continue
            child_ws = []
            for j in range(B):
                ci = child_index(i, j, B)
                if ci < N and active[ci]:
                    child_ws.append(ws[ci])
                else:
                    child_ws.append(w_zero)
            w, retval = self.aggregation.assess(
                (vs[i], tree_stack(child_ws), nchilds[i]),
                choices.get_submap((i, AGG)))
            weight = weight + w
            ws[i] = retval
        return weight, ws[0]

    def project(self, trace, selection: Selection):
        return trace.project(selection)

    def update(self, key, trace: RecurseTrace, args: Tuple, argdiffs: Tuple,
               constraints: ChoiceMap):
        constraints = constraints if constraints is not None else ChoiceMap()
        (root_input,) = args
        keys = random.split(key, 2 * self.n_nodes) if key is not None \
            else None
        weights = []
        prev_active = trace.active

        def case_select(act_now, was_act, upd_out, gen_out, prev_sub):
            """The weight contribution of one node by its transition:
            stay-active the update weight, newly active the generate
            weight, newly inactive -prev_score, stay-inactive 0."""
            new_sub_u, w_u = upd_out
            new_sub_g, w_g = gen_out
            w = torch.where(
                act_now & was_act, _here(w_u, act_now),
                torch.where(act_now & ~was_act, _here(w_g, act_now),
                            torch.where(~act_now & was_act,
                                        -prev_sub.get_score(), 0.0)))
            new_sub = pytree.tree_map(
                lambda a, b: torch.where(act_now & was_act, a, b),
                new_sub_u, new_sub_g)
            return new_sub, w

        def prod(i, act, inp):
            k = keys[i] if keys is not None else None
            cons = constraints.get_submap((i, PROD))
            prev_sub = trace.prod_subs[i]
            upd = self.production.update(
                k, prev_sub, (inp,), (UnknownChange,), cons)[:2]
            gen = self.production.generate(k, (inp,), cons)
            new_sub, w = case_select(act, prev_active[i], upd, gen, prev_sub)
            weights.append(w)
            return new_sub, None

        def agg(i, act, v, child_ws, nchild):
            k = keys[self.n_nodes + i] if keys is not None else None
            cons = constraints.get_submap((i, AGG))
            prev_sub = trace.agg_subs[i]
            aargs = (v, child_ws, nchild)
            upd = self.aggregation.update(
                k, prev_sub, aargs, all_unknown_change(aargs), cons)[:2]
            gen = self.aggregation.generate(k, aargs, cons)
            new_sub, w = case_select(act, prev_active[i], upd, gen, prev_sub)
            weights.append(w)
            return new_sub, None

        prod_subs, agg_subs, active, retval, _ = self._walk(
            root_input, prod, agg, prev_active.device)
        new_trace = self._make_trace(args, prod_subs, agg_subs, active,
                                     retval)
        # discard: only with concrete masks (gen_tpu's is empty under jit)
        discard = ChoiceMap()
        if _is_batched(prev_active) or _is_batched(active):
            return new_trace, sum(weights), UnknownChange, discard
        pa = prev_active.tolist()
        na = active.tolist()
        for i in range(self.n_nodes):
            if pa[i] and not na[i]:
                pch = trace.prod_subs[i].get_choices()
                if not pch.is_empty():
                    discard.set_submap((i, PROD), pch)
                ach = trace.agg_subs[i].get_choices()
                if not ach.is_empty():
                    discard.set_submap((i, AGG), ach)
            elif pa[i] and na[i]:
                for kind, sub in ((PROD, trace.prod_subs[i]),
                                  (AGG, trace.agg_subs[i])):
                    cons = constraints.get_submap((i, kind))
                    if not cons.is_empty():
                        old = _overwritten(sub.get_choices(), cons)
                        if not old.is_empty():
                            discard.set_submap((i, kind), old)
        return new_trace, sum(weights), UnknownChange, discard

    def regenerate(self, key, trace: RecurseTrace, args: Tuple,
                   argdiffs: Tuple, selection: Selection):
        # regenerate = update with the selected nodes resampled: per-node
        # regenerate in the same walk
        (root_input,) = args
        keys = random.split(key, 2 * self.n_nodes)
        weights = []
        prev_active = trace.active

        def prod(i, act, inp):
            sel = selection.subselection(i).subselection(PROD)
            prev_sub = trace.prod_subs[i]
            reg = self.production.regenerate(
                keys[i], prev_sub, (inp,), (UnknownChange,), sel)
            gen = self.production.generate(keys[i], (inp,), ChoiceMap())
            new_sub = pytree.tree_map(
                lambda a, b: torch.where(act & prev_active[i], a, b),
                reg[0], gen[0])
            w = torch.where(act & prev_active[i], _here(reg[1], act),
                            torch.where((~act) & prev_active[i],
                                        -prev_sub.project(NONE), 0.0))
            weights.append(w)
            return new_sub, None

        def agg(i, act, v, child_ws, nchild):
            sel = selection.subselection(i).subselection(AGG)
            prev_sub = trace.agg_subs[i]
            aargs = (v, child_ws, nchild)
            reg = self.aggregation.regenerate(
                keys[self.n_nodes + i], prev_sub, aargs,
                all_unknown_change(aargs), sel)
            gen = self.aggregation.generate(keys[self.n_nodes + i], aargs,
                                            ChoiceMap())
            new_sub = pytree.tree_map(
                lambda a, b: torch.where(act & prev_active[i], a, b),
                reg[0], gen[0])
            weights.append(torch.where(act & prev_active[i],
                                       _here(reg[1], act), 0.0))
            return new_sub, None

        prod_subs, agg_subs, active, retval, _ = self._walk(
            root_input, prod, agg, key.device)
        new_trace = self._make_trace(args, prod_subs, agg_subs, active,
                                     retval)
        return new_trace, sum(weights), UnknownChange


def _overwritten(old: ChoiceMap, cons: ChoiceMap) -> ChoiceMap:
    out = ChoiceMap()
    for path, v in old.leaf_items():
        if cons.has_value(path):
            out.set_value(path, v)
    return out


def Recurse(production, aggregation, max_branch: int, max_depth: int,
            w_example) -> RecurseCombinator:
    return RecurseCombinator(production, aggregation, max_branch, max_depth,
                             w_example)

