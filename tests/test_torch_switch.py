"""gen_tpu_torch's Switch and choice_at/call_at against gen_tpu's, under the
same keys, in float64.

Switch at a concrete index (simulate, generate, assess, project, update
with and without an index change, with its discard, and regenerate with
an index change, which carries gen_tpu's fixed weight) and at a batched
index under vmap (gen_tpu's traced index: every branch runs and the index
selects; generate, an index-changing update with its masked discard, the
key-free update, regenerate, and a mixture model whose component index is
itself a choice). Weights, scores, discards and values agree within 1e-12
(float64 normals follow XLA's erf_inv within 3 ulp),
flags are equal. Also the combinators' structural ``__eq__``/``__hash__``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

RTOL = 1e-12


def _models(g, probs):
    @g.gen
    def b0(mu):
        x = g.normal(mu, 1.0) @ "x"
        return x

    @g.gen
    def b1(mu):
        x = g.normal(-mu, 2.0) @ "x"
        z = g.normal(x, 0.5) @ "z"
        return x + z

    sw = g.Switch(b0, b1)

    @g.gen
    def mixture(mu):
        k = g.categorical(probs) @ "k"
        v = sw(k, mu) @ "comp"
        g.normal(v, 0.5) @ "y"
        return v

    return sw, mixture


PROBS = np.asarray([0.4, 0.6])
J_SW, J_MIX = _models(gt, jnp.asarray(PROBS))
T_SW, T_MIX = _models(tt, torch.from_numpy(PROBS))
N = 8
IDX = np.array([0, 1, 1, 0, 1, 0, 0, 1])
NEW = np.array([1, 1, 0, 0, 0, 1, 0, 1])


def jkey(s):
    return jax.random.PRNGKey(s)


def tkey(s):
    return tt.random.PRNGKey(s, "cpu")


def close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=RTOL,
                               atol=1e-13, equal_nan=False)


def same_map(tm, jm):
    jl, tl = list(jm.leaf_items()), list(tm.leaf_items())
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (p, a), (_, b) in zip(jl, tl):
        assert isinstance(a, gt.MaskedValue) == isinstance(b, tt.MaskedValue)
        if isinstance(a, gt.MaskedValue):
            close(b.value, a.value)
            np.testing.assert_array_equal(np.asarray(b.flag),
                                          np.asarray(a.flag))
        else:
            close(b, a)


def test_switch_concrete_index():
    """One branch dispatched: generate, assess, project, update at the
    same index and with an index change (inherited "x", discard "z"), and
    regenerate with an index change (gen_tpu's fixed weight)."""
    jtr, jw = J_SW.generate(jkey(0), (1, 0.5), gt.choicemap(z=0.2))
    ja = J_SW.assess((1, 0.5), jtr.get_choices())
    jp = jtr.project(gt.select("x"))
    ju = J_SW.update(jkey(1), jtr, (1, 0.5), (gt.NoChange, gt.NoChange),
                     gt.choicemap(x=0.1))
    jc = J_SW.update(jkey(2), jtr, (0, 0.5), (gt.UnknownChange,
                                              gt.NoChange), gt.ChoiceMap())
    jr = J_SW.regenerate(jkey(3), jc[0], (1, 0.5), (gt.UnknownChange,
                                                    gt.NoChange),
                         gt.select("z"))
    with float64_default():
        ttr, tw = T_SW.generate(tkey(0), (1, 0.5), tt.choicemap(
            z=torch.tensor(0.2)))
        ta = T_SW.assess((1, 0.5), ttr.get_choices())
        tp = ttr.project(tt.select("x"))
        tu = T_SW.update(tkey(1), ttr, (1, 0.5), (tt.NoChange, tt.NoChange),
                         tt.choicemap(x=torch.tensor(0.1)))
        tc = T_SW.update(tkey(2), ttr, (0, 0.5), (tt.UnknownChange,
                                                  tt.NoChange),
                         tt.ChoiceMap())
        tr = T_SW.regenerate(tkey(3), tc[0], (1, 0.5), (tt.UnknownChange,
                                                        tt.NoChange),
                             tt.select("z"))
    close(tw, jw)
    same_map(ttr.get_choices(), jtr.get_choices())
    close(ta[0], ja[0])
    close(ta[1], ja[1])
    close(tp, jp)
    for t_out, j_out in ((tu, ju), (tc, jc)):
        close(t_out[1], j_out[1])
        same_map(t_out[0].get_choices(), j_out[0].get_choices())
        same_map(t_out[3], j_out[3])
    assert list(tc[3].addresses()) == [("z",)] and tc[0].index == 0
    close(tr[1], jr[1])
    same_map(tr[0].get_choices(), jr[0].get_choices())
    close(tr[0].get_score(), jr[0].get_score())


def _batched(g, sw, key_fn, split, vmap, xs):
    """generate at IDX, update to NEW (with "x" constrained on lanes 0-3
    by a masked constraint), the key-free update, and regenerate at NEW
    with "x" selected, all vmapped over lanes."""
    idx, new, flags, xv = xs

    def one(k, i, j, f, x):
        k1, k2, k3 = split(k, 3)
        tr, w = sw.generate(k1, (i, 0.5), g.ChoiceMap())
        cons = g.ChoiceMap().set_value("x", g.MaskedValue(x, f))
        new_tr, uw, _, disc = sw.update(k2, tr, (j, 0.5),
                                        (g.UnknownChange, g.NoChange), cons)
        _, kw, _, _ = sw.update(None, tr, (i, 0.5),
                                (g.NoChange, g.NoChange),
                                g.choicemap(x=x))
        r_tr, rw, _ = sw.regenerate(k3, tr, (j, 0.5),
                                    (g.UnknownChange, g.NoChange),
                                    g.select("x"))
        return (w, tr.get_score(), tr.get_retval(), uw, new_tr.get_score(),
                new_tr.get_retval(), disc, kw, rw, r_tr.get_score(),
                r_tr.get_retval())

    return vmap(one)(key_fn, *xs)


def test_switch_batched_index_under_vmap():
    """gen_tpu's traced-index universe: every branch runs and the index
    selects, lane by lane; the index-changing update's discard is masked
    per lane."""
    flags = np.arange(N) < 4
    xv = np.linspace(-1.0, 1.0, N)
    jout = _batched(gt, J_SW, jax.random.split(jkey(4), N), jax.random.split,
                    jax.vmap, (jnp.asarray(IDX), jnp.asarray(NEW),
                               jnp.asarray(flags), jnp.asarray(xv)))
    with float64_default():
        tout = _batched(tt, T_SW, tt.random.split(tkey(4), N),
                        tt.random.split, torch.func.vmap,
                        (torch.from_numpy(IDX), torch.from_numpy(NEW),
                         torch.from_numpy(flags), torch.from_numpy(xv)))
    for i, (a, b) in enumerate(zip(tout, jout)):
        if i == 6:
            same_map(a, b)
        else:
            close(a, b)
    assert set(tout[6].addresses()) == {("x",), ("z",)}


def test_switch_mixture_model_and_structure():
    """A mixture whose component index is a categorical choice (batched
    under vmap): generate with y observed, then an update that flips k,
    lane by lane; and the structural equality of Switch, Map and Unfold
    built twice."""
    ys = np.linspace(-2.0, 2.0, N)

    def run(g, mix, k, split, vmap, y, new):
        def one(kk, yy, kn):
            k1, k2 = split(kk)
            tr, w = mix.generate(k1, (0.5,), g.choicemap(y=yy))
            new_tr, uw, _, _ = tr.update(k2, g.choicemap(k=kn))
            return w, tr.get_score(), tr["k"], uw, new_tr.get_score()
        return vmap(one)(k, y, new)

    jout = run(gt, J_MIX, jax.random.split(jkey(5), N), jax.random.split,
               jax.vmap, jnp.asarray(ys), jnp.asarray(NEW))
    with float64_default():
        tout = run(tt, T_MIX, tt.random.split(tkey(5), N), tt.random.split,
                   torch.func.vmap, torch.from_numpy(ys),
                   torch.from_numpy(NEW))
    for a, b in zip(tout, jout):
        close(a, b)

    b0, b1 = T_SW.branches
    assert tt.Switch(b0, b1) == T_SW and hash(tt.Switch(b0, b1)) == hash(
        T_SW)
    assert tt.Switch(b1, b0) != T_SW
    assert tt.Map(b0) == tt.Map(b0) and tt.Unfold(b0) == tt.Unfold(b0)
    assert hash(tt.Map(b0)) == hash(tt.Map(b0)) and tt.Map(b0) != tt.Map(b1)


def _at_models(g):
    ca = g.choice_at(g.normal)

    @g.gen
    def inner(mu):
        return g.normal(mu, 1.0) @ "v"

    return ca, g.call_at(inner)


def test_choice_at_and_call_at():
    """simulate/generate/update/regenerate at the same key and with a key
    change (the old choice discarded), for both wrappers."""
    def run(g, ca, cl, key, split, cm, t):
        k = split(key, 6)
        out = []
        tr, w = ca.generate(k[0], (0.0, 1.0, "a"), cm(a=t(0.4)))
        out += [w, tr.get_score(), tr.project(g.select("a"))]
        u = ca.update(k[1], tr, (0.2, 1.0, "a"), (), cm(a=t(0.1)))
        c = ca.update(k[2], tr, (0.2, 1.0, "b"), (), g.ChoiceMap())
        r = ca.regenerate(k[3], tr, (0.2, 1.0, "a"), (), g.select("a"))
        out += [u[1], u[3]["a"], c[1], c[3]["a"], c[0].get_retval(), r[1],
                r[0].get_retval()]
        tr2, w2 = cl.generate(k[4], (0.5, "site"), g.ChoiceMap())
        u2 = cl.update(k[5], tr2, (0.5, "site"), (),
                       g.ChoiceMap().set_value(("site", "v"), t(1.5)))
        c2 = cl.update(k[5], tr2, (0.5, "other"), (), g.ChoiceMap())
        r2 = cl.regenerate(k[5], tr2, (0.5, "site"), (),
                           g.select(("site", "v")))
        out += [w2, tr2.get_choices()[("site", "v")], u2[1],
                u2[3][("site", "v")], c2[1], c2[3][("site", "v")], r2[1],
                r2[0].get_retval(), tr2.project(g.select("site"))]
        return out

    jca, jcl = _at_models(gt)
    jout = run(gt, jca, jcl, jkey(6), jax.random.split, gt.choicemap,
               jnp.asarray)
    with float64_default():
        tca, tcl = _at_models(tt)
        tout = run(tt, tca, tcl, tkey(6), tt.random.split, tt.choicemap,
                   torch.tensor)
    for a, b in zip(tout, jout):
        close(a, b)
