"""gen_tpu_torch's update, regenerate, propose and the Unfold combinator
against gen_tpu's, under the same keys, in float64.

Weights, scores, discards and return values agree within 1e-12 relative
(float64 normals follow XLA's erf_inv within 3 ulp), on
a dynamic model whose structure changes with a static argument (added,
removed and constrained choices, a nested call) and on an Unfold
state-space model: generate (dense and sparse constraints), update on the
O(1) extension path and on the general path (same length, grow, shrink,
sparse), regenerate, assess and propose. FlatTarget.rebuild is the
key-free update of gen_tpu."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.combinators import Unfold as JUnfold  # noqa: E402
from gen_tpu.combinators import vector_choicemap as j_vcm  # noqa: E402
from gen_tpu_torch.combinators import Unfold as TUnfold  # noqa: E402
from gen_tpu_torch.combinators import VectorChoiceMap  # noqa: E402
from gen_tpu_torch.combinators import vector_choicemap as t_vcm  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

RTOL = 1e-12


def _models(g, xp):
    @g.gen
    def inner(mu):
        return g.normal(mu, 1.0) @ "z"

    @g.gen
    def model(n_extra, scale):
        a = g.normal(0.0, 1.0) @ "a"
        b = g.normal(a, scale) @ "b" if n_extra > 0 else a
        z = inner(b) @ "sub"
        for i in range(n_extra):
            g.normal(z, 1.0) @ ("e", i)
        g.normal(xp.stack([z + a, z - a]), 0.5) @ "y"
        return z

    @g.gen
    def ssm_kernel(t, prev):
        x = g.normal(0.8 * prev, 0.5) @ "x"
        g.normal(x, 0.3) @ "y"
        return x

    return model, ssm_kernel


J_MODEL, J_KERNEL = _models(gt, jnp)
T_MODEL, T_KERNEL = _models(tt, torch)
J_UNFOLD, T_UNFOLD = JUnfold(J_KERNEL), TUnfold(T_KERNEL)
Y = np.array([0.3, -0.7])


def jkey(s):
    return jax.random.PRNGKey(s)


def tkey(s):
    return tt.random.PRNGKey(s, "cpu")


def assert_chm_equal(tchm, jchm, rtol=RTOL):
    tp = list(tchm.addresses())
    assert tp == list(jchm.addresses())
    for p in tp:
        np.testing.assert_allclose(np.asarray(tchm[p]), np.asarray(jchm[p]),
                                   rtol=rtol, atol=1e-14)


def assert_close(t, j, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=1e-13)


def assert_traces_equal(ttr, jtr):
    assert_chm_equal(ttr.get_choices(), jtr.get_choices())
    assert_close(ttr.get_score(), jtr.get_score())
    assert_close(ttr.get_retval(), jtr.get_retval())


def _dynamic_traces(n_extra=2):
    jtr, _ = J_MODEL.generate(jkey(1), (n_extra, 0.7),
                              gt.choicemap(y=jnp.asarray(Y)))
    with float64_default():
        ttr, _ = T_MODEL.generate(tkey(1), (n_extra, 0.7),
                                  tt.choicemap(y=torch.tensor(Y)))
    assert_traces_equal(ttr, jtr)
    return jtr, ttr


@pytest.mark.parametrize("new_extra,constrain", [
    (2, True), (1, True), (0, False), (3, False), (4, True)])
def test_update_dynamic(new_extra, constrain):
    """Same structure, removed choices (the deletion pass and its
    discard), added choices (sampled with the handler's keys), constrained
    choices and a constrained choice inside the nested call."""
    jtr, ttr = _dynamic_traces()
    cons = {"a": 0.4, ("sub", "z"): -1.1} if constrain else {}
    jc = gt.choicemap(*[(k, jnp.float64(v)) for k, v in cons.items()])
    jn, jw, _, jd = J_MODEL.update(jkey(5), jtr, (new_extra, 0.9),
                                   (gt.UnknownChange,) * 2, jc)
    with float64_default():
        tc = tt.choicemap(*[(k, torch.tensor(v)) for k, v in cons.items()])
        tn, tw, td_, td = T_MODEL.update(tkey(5), ttr, (new_extra, 0.9),
                                         (tt.UnknownChange,) * 2, tc)
    assert td_ is tt.UnknownChange
    assert_traces_equal(tn, jn)
    assert_close(tw, jw)
    assert_chm_equal(td, jd)
    # update by trace forwarding, with the trace's own args, is the same
    with float64_default():
        tn2, tw2, _, _ = ttr.update(tkey(5), tc)
    jn2, jw2, _, _ = jtr.update(jkey(5), jc)
    assert_traces_equal(tn2, jn2)
    assert_close(tw2, jw2)


@pytest.mark.parametrize("sel", [("a",), (("sub", "z"),), ("b", ("e", 1)),
                                 ()])
def test_regenerate_dynamic(sel):
    jtr, ttr = _dynamic_traces()
    jn, jw, _ = J_MODEL.regenerate(jkey(9), jtr, (1, 0.7),
                                   (gt.UnknownChange,) * 2, gt.select(*sel))
    with float64_default():
        tn, tw, _ = T_MODEL.regenerate(tkey(9), ttr, (1, 0.7),
                                       (tt.UnknownChange,) * 2,
                                       tt.select(*sel))
        tn2, tw2, _ = ttr.regenerate(tkey(9), tt.select(*sel))
    jn2, jw2, _ = jtr.regenerate(jkey(9), gt.select(*sel))
    assert_traces_equal(tn, jn)
    assert_close(tw, jw)
    assert_traces_equal(tn2, jn2)
    assert_close(tw2, jw2)


def test_not_visited_errors():
    """update refuses constraints it never visits; assess refuses choices
    it never visits (the two not-visited ValueErrors)."""
    _, ttr = _dynamic_traces()
    with float64_default():
        with pytest.raises(ValueError, match="did not visit"):
            ttr.update(tkey(0), tt.choicemap((("e", 7), torch.tensor(0.))))
        choices = ttr.get_choices()
        choices.set_value("nowhere", torch.tensor(1.0))
        with pytest.raises(ValueError, match="not visited"):
            T_MODEL.assess((2, 0.7), choices)
        with pytest.raises(ValueError, match="submap at choice"):
            ttr.update(tkey(0), tt.choicemap((("a", "x"), torch.tensor(0.))))


def test_masked_constraints_raise():
    """A masked constraint updates as gen_tpu's does (kept where its flag
    is off, constrained where on, the discard masked); what still raises
    is what gen_tpu refuses: a masked value at a call address, and a
    MaskedSelection's complement and membership test."""
    jtr, ttr = _dynamic_traces()
    for flag in (True, False):
        jn, jw, _, jd = jtr.update(None, gt.ChoiceMap().set_value(
            "a", gt.mask(0.25, flag)))
        with float64_default():
            tn, tw, _, td = ttr.update(None, tt.ChoiceMap().set_value(
                "a", tt.mask(torch.tensor(0.25), flag)))
        assert_traces_equal(tn, jn)
        assert_close(tw, jw)
        assert_close(td["a"].value, jd["a"].value)
        assert bool(td["a"].flag) == bool(jd["a"].flag) == flag
    with float64_default():
        with pytest.raises(ValueError, match="call address"):
            ttr.update(tkey(0), tt.ChoiceMap().set_value(
                "sub", tt.mask(torch.tensor(0.0), True)))
    sel = tt.masked_select(a=torch.tensor(True))
    with pytest.raises(NotImplementedError, match="complement"):
        sel.complement()
    with pytest.raises(TypeError, match="regenerate"):
        ("a",) in sel


def test_propose():
    jc, jw, jr = J_MODEL.propose(jkey(4), (2, 0.7))
    with float64_default():
        tc, tw, tr = T_MODEL.propose(tkey(4), (2, 0.7))
    assert_chm_equal(tc, jc)
    assert_close(tw, jw)
    assert_close(tr, jr)


def test_rebuild_is_keyfree_update():
    jtr, ttr = _dynamic_traces()
    flat = np.array([0.25, -0.5, 1.5])
    jt = gt.inference.FlatTarget(jtr, gt.select("a", "b", ("sub", "z")))
    jn = jt.rebuild(jnp.asarray(flat))
    with float64_default():
        target = tt.inference.FlatTarget(ttr, tt.select("a", "b",
                                                        ("sub", "z")))
        tn = target.rebuild(torch.tensor(flat))
    assert_traces_equal(tn, jn)
    assert float(tn["a"]) == 0.25 and float(tn[("sub", "z")]) == 1.5


# -- Unfold ------------------------------------------------------------------

YS = np.array([0.5, 0.1, -0.4, 0.9, 0.2, -0.3])


def _unfold_traces(T=4, seed=2):
    jtr, jw = J_UNFOLD.generate(jkey(seed), (T, 0.0),
                                j_vcm(T, y=jnp.asarray(YS[:T])))
    with float64_default():
        ttr, tw = T_UNFOLD.generate(tkey(seed), (T, 0.0),
                                    t_vcm(T, y=torch.tensor(YS[:T])))
    assert_traces_equal(ttr, jtr)
    assert_close(tw, jw)
    return jtr, ttr


def _sparse(g, steps, addr="y"):
    return g.choicemap(*[((t, addr), YS[t] if g is gt else
                          torch.tensor(YS[t])) for t in steps])


def test_unfold_generate_simulate_assess():
    jtr, ttr = _unfold_traces()
    assert isinstance(ttr.get_choices(), VectorChoiceMap)
    assert_close(ttr[(2, "x")], jtr[(2, "x")])
    assert_close(ttr[2], jtr[2])
    # sparse constraints (lowered onto one masked dense pass)
    jt2, jw2 = J_UNFOLD.generate(jkey(3), (5, 0.0), _sparse(gt, (1, 3)))
    js = J_UNFOLD.simulate(jkey(3), (5, 0.0))
    jwa, jra = J_UNFOLD.assess((4, 0.0), jtr.get_choices())
    with float64_default():
        tt2, tw2 = T_UNFOLD.generate(tkey(3), (5, 0.0), _sparse(tt, (1, 3)))
        ts = T_UNFOLD.simulate(tkey(3), (5, 0.0))
        twa, tra = T_UNFOLD.assess((4, 0.0), ttr.get_choices())
        te, twe = T_UNFOLD.generate(tkey(3), (5, 0.0), tt.ChoiceMap())
    assert_traces_equal(tt2, jt2)
    assert_close(tw2, jw2)
    assert_traces_equal(ts, js)
    assert_traces_equal(te, js)
    assert float(twe) == 0.0
    assert_close(twa, jwa)
    assert_close(tra, jra)
    assert_close(twa, ttr.get_score())
    assert_close(ttr.project(tt.selection.ALL), jtr.project(gt.ALL))
    sel = (1, "y")
    assert_close(ttr.project(tt.select(sel)), jtr.project(gt.select(sel)))
    with pytest.raises(ValueError, match="every step"):
        T_UNFOLD.assess((4, 0.0), _sparse(tt, (1,)))


@pytest.mark.parametrize("case", ["extend", "extend_empty", "same_dense",
                                  "same_sparse", "grow", "shrink"])
def test_unfold_update(case):
    jtr, ttr = _unfold_traces(T=4)
    if case == "extend":      # IntDiff, constraints only at new steps
        T, diff, steps, addr = 6, 2, (4, 5), "y"
    elif case == "extend_empty":
        T, diff, steps, addr = 5, 1, (), "y"
    elif case == "same_dense":
        T, diff, steps, addr = 4, None, None, "x"
    elif case == "same_sparse":
        T, diff, steps, addr = 4, None, (0, 2), "x"
    elif case == "grow":      # UnknownChange: the general re-run
        T, diff, steps, addr = 6, None, (4, 5), "y"
    else:
        T, diff, steps, addr = 2, None, (1,), "x"
    if steps is None:
        xs = np.linspace(-0.5, 0.5, T)
        jc, tc = j_vcm(T, x=jnp.asarray(xs)), t_vcm(T, x=torch.tensor(xs))
    else:
        jc, tc = _sparse(gt, steps, addr), _sparse(tt, steps, addr)
    jd = ((gt.IntDiff(diff), gt.NoChange) if diff else
          (gt.UnknownChange, gt.NoChange))
    td = ((tt.IntDiff(diff), tt.NoChange) if diff else
          (tt.UnknownChange, tt.NoChange))
    jn, jw, _, jdisc = J_UNFOLD.update(jkey(8), jtr, (T, 0.0), jd, jc)
    with float64_default():
        tn, tw, _, tdisc = T_UNFOLD.update(tkey(8), ttr, (T, 0.0), td, tc)
    assert tn.length == T
    assert_traces_equal(tn, jn)
    assert_close(tw, jw)
    assert isinstance(tdisc, VectorChoiceMap) == isinstance(
        jdisc, gt.combinators.VectorChoiceMap)
    assert_chm_equal(tdisc, jdisc)
    if case.startswith("extend"):
        # the prefix is untouched
        np.testing.assert_array_equal(tn.get_retval()[:4].numpy(),
                                      ttr.get_retval().numpy())


@pytest.mark.parametrize("sel", ["all", "x_every_step", "none"])
def test_unfold_regenerate(sel):
    jtr, ttr = _unfold_traces(T=4)
    if sel == "all":
        js, ts = gt.ALL, tt.selection.ALL
    elif sel == "none":
        js, ts = gt.NONE, tt.selection.NONE
    else:
        js = gt.select(*[(t, "x") for t in range(4)])
        ts = tt.select(*[(t, "x") for t in range(4)])
    jn, jw, _ = J_UNFOLD.regenerate(jkey(6), jtr, (4, 0.0),
                                    (gt.NoChange,) * 2, js)
    with float64_default():
        tn, tw, _ = T_UNFOLD.regenerate(tkey(6), ttr, (4, 0.0),
                                        (tt.NoChange,) * 2, ts)
    assert_traces_equal(tn, jn)
    assert_close(tw, jw)


def test_unfold_regenerate_per_step_selection_raises():
    """Per-step selections that differ lower onto a batched masked
    selection, as in gen_tpu (same weights and trace); what still raises
    is gen_tpu's refusal of a length change."""
    jtr, ttr = _unfold_traces(T=4)
    jn, jw, _ = J_UNFOLD.regenerate(jkey(6), jtr, (4, 0.0),
                                    (gt.NoChange,) * 2, gt.select((1, "x")))
    with float64_default():
        tn, tw, _ = T_UNFOLD.regenerate(tkey(6), ttr, (4, 0.0),
                                        (tt.NoChange,) * 2,
                                        tt.select((1, "x")))
        with pytest.raises(NotImplementedError, match="length change"):
            T_UNFOLD.regenerate(tkey(6), ttr, (5, 0.0), (tt.NoChange,) * 2,
                                tt.select((1, "x")))
    assert_traces_equal(tn, jn)
    assert_close(tw, jw)


def test_unfold_structural_equality_and_errors():
    assert TUnfold(T_KERNEL) == TUnfold(T_KERNEL)
    assert hash(TUnfold(T_KERNEL)) == hash(TUnfold(T_KERNEL))
    with pytest.raises(TypeError, match="static Python int"):
        T_UNFOLD.simulate(tkey(0), (torch.tensor(3), 0.0))
