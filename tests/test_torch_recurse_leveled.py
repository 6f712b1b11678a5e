"""gen_tpu_torch's leveled Recurse (one batched call a tree level) against
gen_tpu's and against the port's per-node arena, in float64, under the
same keys.

simulate, generate (full and partial constraints), update (grow and
shrink, with discards), regenerate (a uniform selection and a
node-varying one, lowered onto a batched MaskedSelection), project and
assess equal gen_tpu's within 1e-12, with tests/test_recurse_leveled.py's
hand-computed weights and the GFI identities of
tests/test_gfi_invariants.py:172-228 (an update undone by its discard;
project(sel) + project(complement) = score). Leveled equals per-node
exactly on assess, at the depth cap too, and the gradient of assess in
the root input equals gen_tpu's ``jax.grad``. A batch of 8 trees under
``torch.func.vmap`` (gen_tpu: jit of vmap) simulates and updates equal
to gen_tpu's, with an empty discard in both."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from scipy import stats  # noqa: E402
from torch.func import vmap  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from torch_port_models import float64_default  # noqa: E402
from torch_recurse_models import (D, close, same_choices,  # noqa: E402
                                  same_trace, trees)

KEY = jax.random.PRNGKey(0)
J_LEVEL, T_LEVEL = trees("level")
J_NODE, T_NODE = trees("node")
# gen_tpu's calls jitted once for the file (eager, the leveled vmaps
# compile op by op)
J_SIM_LEVEL = jax.jit(lambda k: J_LEVEL.simulate(k, (0.0,)))
J_SIM_NODE = jax.jit(lambda k: J_NODE.simulate(k, (0.0,)))
J_GEN_LEVEL = jax.jit(lambda k, c: J_LEVEL.generate(k, (0.0,), c))
PV = (0, "production", "v")
PB = (0, "production", "branch")


def tkey(seed):
    return tt.random.PRNGKey(seed, "cpu")


def f64(x):
    return torch.tensor(x, dtype=torch.float64)


def jcons(items):
    c = gt.ChoiceMap()
    for a, v in items:
        c.set_value(a, jnp.asarray(v))
    return c


def tcons(items):
    c = tt.ChoiceMap()
    for a, v in items:
        c.set_value(a, torch.tensor(v) if isinstance(v, bool) else f64(v))
    return c


def test_simulate_and_partial_generate():
    tl = T_LEVEL
    for seed in (0, 5):
        jtr = J_SIM_LEVEL(jax.random.PRNGKey(seed))
        with float64_default():
            ttr = tl.simulate(tkey(seed), (0.0,))
        same_trace(ttr, jtr)
        expected = sum(float(torch.where(
            ttr.active[d], ttr.prod_levels[d].get_score()
            + ttr.agg_levels[d].get_score(), 0.0).sum()) for d in range(D))
        np.testing.assert_allclose(float(ttr.get_score()), expected,
                                   rtol=1e-10)
    jtr, jw = J_GEN_LEVEL(KEY, jcons([(PV, 0.7)]))
    with float64_default():
        ttr, tw = tl.generate(tkey(0), (0.0,), tcons([(PV, 0.7)]))
    same_trace(ttr, jtr)
    close(tw, jw)
    np.testing.assert_allclose(float(tw), stats.norm.logpdf(0.7, 0.0, 1.0),
                               rtol=1e-10)


def test_assess_and_full_generate_equal_per_node():
    tl, tn = T_LEVEL, T_NODE
    for seed in range(3):
        jref = J_SIM_NODE(jax.random.PRNGKey(seed))
        jw, jr = J_LEVEL.assess((0.0,), jref.get_choices())
        with float64_default():
            ref = tn.simulate(tkey(seed), (0.0,))
            ch = ref.get_choices()
            wn, rn = tn.assess((0.0,), ch)
            wl, rl = tl.assess((0.0,), ch)
            gtr, gw = tl.generate(tkey(9), (0.0,), ch)
        assert float(wl) == float(wn) and float(rl) == float(rn)
        close(wl, jw)
        close(rl, jr)
        close(gw, wl)
        close(gtr.get_score(), wl)
        close(gtr.get_retval(), ref.get_retval())


def test_update_shrink_grow_roundtrip():
    """tests/test_gfi_invariants.py:172 and tests/test_recurse_leveled.py:91:
    the root's branch flag flips off, then the update with that discard
    grows the tree back; weights equal gen_tpu's and the hand-computed
    one, and the round trip restores the choices with w1 + w2 = 0."""
    jl, tl = J_LEVEL, T_LEVEL
    start = [(PV, 0.3), (PB, True)]
    jtr, _ = J_GEN_LEVEL(KEY, jcons(start))
    j1, jw1, _, jd1 = jl.update(jax.random.PRNGKey(1), jtr, (0.0,),
                                (gt.NoChange,), jcons([(PB, False)]))
    j2, jw2, _, jd2 = jl.update(jax.random.PRNGKey(2), j1, (0.0,),
                                (gt.NoChange,), jd1)
    with float64_default():
        ttr, _ = tl.generate(tkey(0), (0.0,), tcons(start))
        t1, tw1, _, td1 = tl.update(tkey(1), ttr, (0.0,), (tt.NoChange,),
                                    tcons([(PB, False)]))
        t2, tw2, _, td2 = tl.update(tkey(2), t1, (0.0,), (tt.NoChange,),
                                    td1)
    for t, j in ((t1, j1), (t2, j2)):
        same_trace(t, j)
    for t, j in ((tw1, jw1), (tw2, jw2)):
        close(t, j)
    same_choices(td1, jd1)
    same_choices(td2, jd2)
    assert int(ttr.active[1].sum()) == 2 and not t1.active[1].any()
    removed = float(ttr.get_score()) - float(
        ttr.prod_levels[0].get_score()[0] + ttr.agg_levels[0].get_score()[0])
    np.testing.assert_allclose(
        float(tw1), np.log(0.6) - np.log(0.4) - removed, rtol=1e-10)
    assert td1.has_submap((1, "production"))
    np.testing.assert_allclose(float(tw1 + tw2), 0.0, atol=1e-10)
    assert t2.get_choices().allclose(ttr.get_choices(), atol=1e-12)


@pytest.mark.parametrize("varying", [False, True],
                         ids=["uniform", "node_varying"])
def test_regenerate_and_project(varying):
    jl, tl = J_LEVEL, T_LEVEL
    start = [(PB, True), ((1, "production", "branch"), False),
             ((2, "production", "branch"), False)]
    if varying:
        addrs = [PV, (1, "production", "v")]
    else:
        addrs = [(i, "production", "v") for i in range(tl.n_nodes)]
    jtr, _ = J_GEN_LEVEL(KEY, jcons(start))
    jnew, jw, _ = jl.regenerate(jax.random.PRNGKey(11), jtr, (0.0,),
                                (gt.NoChange,), gt.select(*addrs))
    jp = jnew.project(gt.select(*addrs))
    with float64_default():
        sel = tt.select(*addrs)
        ttr, _ = tl.generate(tkey(0), (0.0,), tcons(start))
        tnew, tw, _ = tl.regenerate(tkey(11), ttr, (0.0,), (tt.NoChange,),
                                    sel)
        tp = tnew.project(sel)
        tpc = tnew.project(sel.complement())
    same_trace(tnew, jnew)
    # the weight cancels to ~0 here: 1e-12 of the score's scale
    np.testing.assert_allclose(float(tw), float(jw), rtol=1e-12,
                               atol=1e-12 * abs(float(ttr.get_score())))
    close(tp, jp)
    np.testing.assert_allclose(float(tp + tpc), float(tnew.get_score()),
                               rtol=1e-10)
    lhs = float(tnew.get_score()) - float(ttr.get_score())
    rhs = float(tw) + float(tp) - float(ttr.project(sel))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-9, atol=1e-9)


def test_depth_cap_and_gradient():
    """A production that almost always asks for children at the last
    level: assess sees nchild = 0 there, per node and leveled, equal to
    the score (tests/test_recurse_leveled.py:189); the gradient of the
    leveled assess in the root input equals gen_tpu's jax.grad."""
    with float64_default():
        for which in ("node", "level"):
            tf = trees(which, depth=2, depth_cap=True)[1]
            tr = tf.simulate(tkey(4), (0.0,))
            w, _ = tf.assess((0.0,), tr.get_choices())
            close(w, tr.get_score())
    jl, tl = J_LEVEL, T_LEVEL
    jref = J_SIM_NODE(jax.random.PRNGKey(1))
    jg = jax.grad(lambda r: jl.assess((r,), jref.get_choices())[0])(0.0)
    with float64_default():
        ref = T_NODE.simulate(tkey(1), (0.0,))
        ch = ref.get_choices()
        tg = torch.func.grad(lambda r: tl.assess((r,), ch)[0])(f64(0.0))
    close(tg, jg)


def test_vmapped_simulate_and_update():
    jl, tl = J_LEVEL, T_LEVEL
    n = 8
    jtrs = jax.jit(jax.vmap(lambda k: jl.simulate(k, (0.0,))))(
        jax.random.split(KEY, n))
    jnew, jw, jd = jax.jit(jax.vmap(lambda k, t: (lambda o: (
        o[0], o[1], o[3]))(jl.update(k, t, (0.0,), (gt.NoChange,),
                                     jcons([(PB, True)])))))(
        jax.random.split(jax.random.PRNGKey(1), n), jtrs)
    with float64_default():
        ttrs = vmap(lambda k: tl.simulate(k, (0.0,)))(
            tt.random.split(tkey(0), n))
        tnew, tw, td = vmap(lambda k, t: (lambda o: (o[0], o[1], o[3]))(
            tl.update(k, t, (0.0,), (tt.NoChange,), tcons([(PB, True)]))))(
                tt.random.split(tkey(1), n), ttrs)
    for t, j in ((ttrs, jtrs), (tnew, jnew)):
        same_trace(t, j, choices=False)
        close(t.prod_levels[1]["v"], j.prod_levels[1]["v"])
    close(tw, jw)
    assert td.is_empty() and jd.is_empty()
    with pytest.raises(ValueError, match="concrete active mask"):
        vmap(lambda t: t.get_choices().to_array())(ttrs)
