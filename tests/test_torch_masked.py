"""gen_tpu_torch's masked values and selections against gen_tpu's, under the
same keys, in float64: the masked branches of generate, update and
regenerate (one vmapped pass over lanes with different flags), masked
``project``, ``selectall``/``selectnone``/``batch_selections``,
``ChoiceMap.allclose``/``as_dict``, ``densify_masked``/``sparsify_masked``,
and the masked lowering of Map and Unfold (sparse constraints, discards,
element-varying selections, Map's length-changing update).

Deterministic outputs (weights, discards, scores, the maps) agree within
1e-12; sampled values agree within 1e-12 too (float64 normals differ from
XLA's by ~1e-14 relative: torch's erfinv), and flags are equal.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.combinators import vector as jvec  # noqa: E402
from gen_tpu_torch import convert  # noqa: E402
from gen_tpu_torch.combinators import vector as tvec  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

RTOL = 1e-12


def _models(g):
    @g.gen
    def point():
        x = g.normal(0.0, 1.0) @ "x"
        g.normal(x, 0.5) @ "y"
        return x

    @g.gen
    def pair():
        a = g.normal(0.0, 1.0) @ "a"
        b = g.normal(0.0, 1.0) @ "b"
        g.normal(a + b, 0.5) @ "y"
        return a

    @g.gen
    def grow(n):
        x = g.normal(0.0, 1.0) @ "x"
        if n > 1:
            g.normal(x, 0.5) @ "z"
        return x

    @g.gen
    def elem(mu):
        x = g.normal(mu, 1.0) @ "x"
        g.normal(x, 0.5) @ "y"
        return x

    @g.gen
    def step(t, prev):
        x = g.normal(0.8 * prev, 0.5) @ "x"
        g.normal(x, 0.3) @ "y"
        return x

    return dict(point=point, pair=pair, grow=grow, elem=elem, step=step)


J, T = _models(gt), _models(tt)


def jkey(s):
    return jax.random.PRNGKey(s)


def tkey(s):
    return tt.random.PRNGKey(s, "cpu")


def close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=RTOL,
                               atol=1e-13, equal_nan=False)


def same_map(tm, jm):
    """Two choice maps: the same addresses, masked leaves on both sides
    at the same places, values within RTOL and flags equal."""
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


FLAGS = np.array([True, False, True, False, False, True])


def test_masked_generate_under_vmap():
    """generate with a MaskedValue: one vmapped pass over lanes whose
    flags differ; the value is the constraint where the flag is set, the
    weight its logpdf there and 0 elsewhere."""
    def j_one(k, flag):
        c = gt.ChoiceMap().set_value("y", gt.mask(1.0, flag))
        tr, w = J["point"].generate(k, (), c)
        return w, tr["x"], tr["y"], tr.get_score()

    jw, jx, jy, js = jax.vmap(j_one)(jax.random.split(jkey(0), 6),
                                     jnp.asarray(FLAGS))
    with float64_default():
        def t_one(k, flag):
            c = tt.ChoiceMap().set_value("y", tt.mask(torch.tensor(1.0),
                                                      flag))
            tr, w = T["point"].generate(k, (), c)
            return w, tr["x"], tr["y"], tr.get_score()

        tw, tx, ty, ts = torch.func.vmap(t_one)(
            tt.random.split(tkey(0), 6), torch.from_numpy(FLAGS))
    for a, b in ((tw, jw), (tx, jx), (ty, jy), (ts, js)):
        close(a, b)
    assert np.all(np.asarray(tw)[~FLAGS] == 0.0)
    assert np.all(np.asarray(ty)[FLAGS] == 1.0)


def test_masked_update_and_discard():
    """update with a MaskedValue at a choice the trace has (kept and
    re-scored where the flag is off, the discard a MaskedValue of the old
    value) and at one it does not (sampled where the flag is off, weighted
    where on)."""
    flags = jnp.asarray(FLAGS)

    def j_one(k, flag):
        k1, k2 = jax.random.split(k)
        tr, _ = J["point"].generate(k1, (), gt.choicemap(y=1.0))
        new, w, _, d = tr.update(None, gt.ChoiceMap().set_value(
            "y", gt.mask(2.0, flag)))
        g, _ = J["grow"].generate(k1, (1,), gt.choicemap())
        g2, w2, _, _ = g.update(k2, gt.ChoiceMap().set_value(
            "z", gt.mask(0.3, flag)), (2,), (gt.UnknownChange,))
        return (w, new["y"], d.get_value("y").value, d.get_value("y").flag,
                w2, g2["z"], g2.get_score())

    jout = jax.vmap(j_one)(jax.random.split(jkey(1), 6), flags)
    with float64_default():
        def t_one(k, flag):
            k1, k2 = tt.random.split(k)
            tr, _ = T["point"].generate(k1, (), tt.choicemap(
                y=torch.tensor(1.0)))
            new, w, _, d = tr.update(None, tt.ChoiceMap().set_value(
                "y", tt.mask(torch.tensor(2.0), flag)))
            g, _ = T["grow"].generate(k1, (1,), tt.choicemap())
            g2, w2, _, _ = g.update(k2, tt.ChoiceMap().set_value(
                "z", tt.mask(torch.tensor(0.3), flag)), (2,),
                (tt.UnknownChange,))
            return (w, new["y"], d.get_value("y").value,
                    d.get_value("y").flag, w2, g2["z"], g2.get_score())

        tout = torch.func.vmap(t_one)(tt.random.split(tkey(1), 6),
                                      torch.from_numpy(FLAGS))
    for a, b in zip(tout, jout):
        close(a, b)
    assert np.all(np.asarray(tout[1])[~FLAGS] == 1.0)


def test_masked_regenerate_and_project():
    """Random-scan regenerate: per lane, a MaskedSelection resamples "a"
    or "b" in one vmapped pass; project under a MaskedSelection weights
    each score by its flag."""
    which = jnp.asarray(FLAGS)

    def j_one(k, w_):
        k1, k2 = jax.random.split(k)
        tr, _ = J["pair"].generate(k1, (), gt.choicemap(y=1.0))
        sel = gt.masked_select(a=w_, b=~w_)
        new, w, _ = tr.regenerate(k2, sel)
        return w, new["a"], new["b"], new.get_score(), tr.project(sel)

    jout = jax.vmap(j_one)(jax.random.split(jkey(2), 6), which)
    with float64_default():
        def t_one(k, w_):
            k1, k2 = tt.random.split(k)
            tr, _ = T["pair"].generate(k1, (), tt.choicemap(
                y=torch.tensor(1.0)))
            sel = tt.masked_select(a=w_, b=~w_)
            new, w, _ = tr.regenerate(k2, sel)
            return w, new["a"], new["b"], new.get_score(), tr.project(sel)

        tout = torch.func.vmap(t_one)(tt.random.split(tkey(2), 6),
                                      torch.from_numpy(FLAGS))
    for a, b in zip(tout, jout):
        close(a, b)


def test_selections_and_choicemap_views():
    """selectall/selectnone, batch_selections (shared, or one masked
    selection of per-lane flags), ChoiceMap.allclose and as_dict."""
    assert tt.selectall().complement().is_empty_set()
    assert tt.selectnone().is_empty_set() and ("x",) in tt.selectall()
    sels_j = [gt.select("x"), gt.select("y"), gt.select("x", ("s", "z"))]
    sels_t = [tt.select("x"), tt.select("y"), tt.select("x", ("s", "z"))]
    j_shared, j_masked = gt.selection.batch_selections(sels_j)
    t_shared, t_masked = tt.selection.batch_selections(sels_t)
    assert j_shared is None and t_shared is None
    assert sorted(j_masked._flags, key=repr) == sorted(t_masked._flags,
                                                       key=repr)
    for p, f in j_masked._flags.items():
        np.testing.assert_array_equal(np.asarray(t_masked.flag_at(p)),
                                      np.asarray(f))
    shared, masked = tt.selection.batch_selections([tt.select("x")] * 3)
    assert masked is None and ("x",) in shared
    # paths with an int and a str at one position: gen_tpu's flatten
    # sorts the paths and raises (ROADMAP queue 3); the port's sorts by
    # repr, and the selection goes through vmap
    flags = {("e", 1): [True, False], ("e", "k"): [False, True]}
    with pytest.raises(TypeError):
        jax.tree_util.tree_flatten(gt.MaskedSelection(
            {p: jnp.asarray(f) for p, f in flags.items()}))
    mixed = tt.MaskedSelection({p: torch.tensor(f) for p, f in flags.items()})
    got = torch.func.vmap(lambda s: s.flag_at(("e", "k")))(mixed)
    assert got.tolist() == [False, True]

    rng = np.random.default_rng(0)
    vals = {"a": rng.standard_normal(3), ("s", "b"): rng.standard_normal(2)}
    jm = gt.choicemap(*vals.items())
    tm = tt.choicemap(*((k, torch.from_numpy(v)) for k, v in vals.items()))
    near = tt.choicemap(*((k, torch.from_numpy(v + 1e-9))
                          for k, v in vals.items()))
    far = tt.choicemap(*((k, torch.from_numpy(v + 1e-3))
                         for k, v in vals.items()))
    jnear = gt.choicemap(*((k, v + 1e-9) for k, v in vals.items()))
    jfar = gt.choicemap(*((k, v + 1e-3) for k, v in vals.items()))
    assert tm.allclose(near) == jm.allclose(jnear) is True
    assert tm.allclose(far) == jm.allclose(jfar) is False
    assert not tm.allclose(tt.choicemap(a=torch.from_numpy(vals["a"])))
    jd, td = jm.as_dict(), tm.as_dict()
    assert set(jd) == set(td) == {"a", "s"} and set(td["s"]) == {"b"}
    close(td["a"], jd["a"])
    close(td["s"]["b"], jd["s"]["b"])


def test_densify_and_sparsify_masked():
    """Sparse per-index constraints onto one dense map of MaskedValue
    stacks, and a masked stack back onto plain values at the flagged
    indices; unstackable maps give None."""
    rng = np.random.default_rng(1)
    ys = rng.standard_normal(5)
    idx = (0, 2, 3)
    jd = jvec.densify_masked({i: gt.choicemap(y=ys[i]) for i in idx}, 5)
    with float64_default():
        td = tvec.densify_masked(
            {i: tt.choicemap(y=torch.tensor(ys[i])) for i in idx}, 5)
    same_map(td.inner, jd.inner)
    js, ts = (jvec.sparsify_masked(jd.inner, 5),
              tvec.sparsify_masked(td.inner, 5))
    same_map(ts, js)
    assert list(ts.addresses()) == [(0, "y"), (2, "y"), (3, "y")]
    assert tvec.densify_masked({0: tt.choicemap(y=torch.zeros(2)),
                                1: tt.choicemap(y=torch.zeros(3))},
                               2) is None
    assert tvec.densify_masked({}, 3) is None


def _sparse_obs(g, ys, idx, dev=None):
    out = g.ChoiceMap()
    for i in idx:
        v = ys[i] if dev is None else torch.tensor(ys[i])
        out.set_submap(i, g.choicemap(y=v))
    return out


def test_map_masked_lowering():
    """Map: sparse constraints lowered onto one masked vmap in generate
    and update (the discard unmasked back to the updated indices), a
    length-changing update (gen_tpu's per-element loop), and an
    element-varying regenerate and project (a batched MaskedSelection)."""
    rng = np.random.default_rng(2)
    mus, ys = rng.standard_normal(5), rng.standard_normal(5)
    jmap, mus_j = gt.Map(J["elem"]), (jnp.asarray(mus),)
    jtr, jw = jmap.generate(jkey(3), mus_j, _sparse_obs(gt, ys, (1, 4)))
    ju = jmap.update(jkey(4), jtr, mus_j, (gt.UnknownChange,),
                     _sparse_obs(gt, ys + 1.0, (0, 4)))
    jl = jmap.update(jkey(5), jtr, (jnp.asarray(mus[:3]),),
                     (gt.UnknownChange,), _sparse_obs(gt, ys, (2,)))
    jg = jmap.update(jkey(5), jtr, (jnp.asarray(np.r_[mus, 0.3]),),
                     (gt.UnknownChange,), gt.ChoiceMap())
    jsel = gt.select((0, "x"), (2, "y"), (3, "x"))
    jr = jmap.regenerate(jkey(6), jtr, mus_j, (gt.UnknownChange,), jsel)
    with float64_default():
        tmap, mus_t = tt.Map(T["elem"]), (torch.from_numpy(mus),)
        ttr, tw = tmap.generate(tkey(3), mus_t,
                                _sparse_obs(tt, ys, (1, 4), "cpu"))
        tu = tmap.update(tkey(4), ttr, mus_t, (tt.UnknownChange,),
                         _sparse_obs(tt, ys + 1.0, (0, 4), "cpu"))
        tl = tmap.update(tkey(5), ttr, (torch.from_numpy(mus[:3]),),
                         (tt.UnknownChange,),
                         _sparse_obs(tt, ys, (2,), "cpu"))
        tg = tmap.update(tkey(5), ttr, (torch.from_numpy(np.r_[mus, 0.3]),),
                         (tt.UnknownChange,), tt.ChoiceMap())
        tsel = tt.select((0, "x"), (2, "y"), (3, "x"))
        tr_ = tmap.regenerate(tkey(6), ttr, mus_t, (tt.UnknownChange,), tsel)
        tproj = ttr.project(tsel)
    close(tw, jw)
    same_map(ttr.get_choices(), jtr.get_choices())
    for t_out, j_out in ((tu, ju), (tl, jl), (tg, jg)):
        close(t_out[1], j_out[1])
        same_map(t_out[0].get_choices(), j_out[0].get_choices())
        same_map(t_out[3], j_out[3])
    assert list(tu[3].addresses()) == [(0, "y"), (4, "y")]
    close(tr_[1], jr[1])
    same_map(tr_[0].get_choices(), jr[0].get_choices())
    close(tproj, jtr.project(jsel))


def test_unfold_masked_lowering():
    """Unfold: sparse constraints lowered onto one masked pass (generate,
    same-length update with the discard unmasked), and per-step
    selections that differ lowered onto a batched MaskedSelection in
    regenerate and project."""
    rng = np.random.default_rng(3)
    ys = rng.standard_normal(6)
    ju_ = gt.Unfold(J["step"])
    jtr, jw = ju_.generate(jkey(7), (6, 0.0), _sparse_obs(gt, ys, (0, 3, 5)))
    ju = ju_.update(jkey(8), jtr, (6, 0.0), (gt.NoChange, gt.NoChange),
                    _sparse_obs(gt, ys - 0.5, (1, 3)))
    jsel = gt.select((0, "x"), (1, "y"), (4, "x"))
    jr = ju_.regenerate(jkey(9), jtr, (6, 0.0), (gt.NoChange, gt.NoChange),
                        jsel)
    with float64_default():
        tu_ = tt.Unfold(T["step"])
        ttr, tw = tu_.generate(tkey(7), (6, 0.0),
                               _sparse_obs(tt, ys, (0, 3, 5), "cpu"))
        tu = tu_.update(tkey(8), ttr, (6, 0.0), (tt.NoChange, tt.NoChange),
                        _sparse_obs(tt, ys - 0.5, (1, 3), "cpu"))
        tsel = tt.select((0, "x"), (1, "y"), (4, "x"))
        tr_ = tu_.regenerate(tkey(9), ttr, (6, 0.0),
                             (tt.NoChange, tt.NoChange), tsel)
        tproj = ttr.project(tsel)
    close(tw, jw)
    same_map(ttr.get_choices(), jtr.get_choices())
    close(tu[1], ju[1])
    same_map(tu[0].get_choices(), ju[0].get_choices())
    same_map(tu[3], ju[3])
    assert list(tu[3].addresses()) == [(1, "y"), (3, "y")]
    close(tr_[1], jr[1])
    same_map(tr_[0].get_choices(), jr[0].get_choices())
    close(tproj, jtr.project(jsel))


def test_convert_round_trip():
    """gen_tpu values carried into the port through numpy: a MaskedValue
    and a MaskedSelection, a time-major reference trajectory, and a
    Switch trace's choices with a masked discard; the port's own calls on
    them equal gen_tpu's."""
    rng = np.random.default_rng(4)
    ys, xs = rng.standard_normal(4), rng.standard_normal(4)
    jref = gt.VectorChoiceMap(gt.ChoiceMap().set_value("x", jnp.asarray(xs))
                              .set_value("y", jnp.asarray(ys)), 4)

    def numpy_leaves(chm):
        return [(p, (np.asarray(v.value), np.asarray(v.flag))
                 if isinstance(v, gt.MaskedValue) else np.asarray(v))
                for p, v in chm.leaf_items()]

    tref = convert.vector_choicemap_from_numpy(numpy_leaves(jref.inner), 4,
                                               "cpu")
    same_map(tref.inner, jref.inner)
    assert tref.length == 4 and tref.get_value((2, "x")) == xs[2]

    jm = gt.mask(jnp.asarray(1.5), jnp.asarray(True))
    tm = convert.masked_value_from_numpy(np.asarray(jm.value),
                                         np.asarray(jm.flag), "cpu")
    jsel = gt.masked_select(a=jnp.asarray(True), b=jnp.asarray(False))
    tsel = convert.masked_selection_from_numpy(
        {p: np.asarray(f) for p, f in jsel._flags.items()}, "cpu")
    jtr, _ = J["pair"].generate(jkey(10), (), gt.ChoiceMap().set_value(
        "y", jm))
    jnew, jw, _ = jtr.regenerate(jkey(11), jsel)
    with float64_default():
        ttr, _ = T["pair"].generate(tkey(10), (), tt.ChoiceMap().set_value(
            "y", tm))
        tnew, tw, _ = ttr.regenerate(tkey(11), tsel)
    close(tw, jw)
    same_map(tnew.get_choices(), jnew.get_choices())

    # a Switch trace's choices and a masked discard (an index change
    # under vmap), through the same converter
    jsw = gt.Switch(J["point"], J["elem"])
    jtr2, _ = jsw.generate(jkey(12), (1, 0.5), gt.choicemap(y=0.2))
    t_from_j = convert.choicemap_from_numpy(numpy_leaves(jtr2.get_choices()),
                                            "cpu")
    with float64_default():
        tsw = tt.Switch(T["point"], T["elem"])
        ttr2, _ = tsw.generate(tkey(12), (1, 0.5), tt.choicemap(
            y=torch.tensor(0.2)))
    same_map(t_from_j, jtr2.get_choices())
    same_map(ttr2.get_choices(), jtr2.get_choices())
    jdisc = gt.ChoiceMap().set_value("x", gt.MaskedValue(
        jnp.asarray(xs[:2]), jnp.asarray([True, False])))
    same_map(convert.choicemap_from_numpy(numpy_leaves(jdisc), "cpu"), jdisc)
