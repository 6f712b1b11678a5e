"""gen_tpu_torch's Recurse (the per-node arena), the static IR and the
custom deterministic generative functions against gen_tpu's, in float64,
under the same keys.

Recurse: simulate, generate, update (grow and shrink, with discards),
regenerate, assess and choice gradients equal gen_tpu's within 1e-12
(traces compared by score, noise, return value, active mask and choices),
with tests/test_recurse_static_ir.py's hand-computed weights; one
simulate and one structure-changing update vmapped over 16 trees (gen_tpu
under jit and vmap; both discards empty there, ROADMAP queue 3), and a
structure-moving MH chain step for step. The static IR: the full GFI of a
StaticGenFn equal to gen_tpu's, ``render_ir`` the same dot source, the
builder's validation errors. CustomDetermGF and its wrappers: score-0
traces on the arguments' device, custom updates and ``torch.func.grad``
gradients equal to gen_tpu's ``jax.grad``."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from scipy import stats  # noqa: E402
from torch.func import vmap  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu import inference as ji  # noqa: E402
from gen_tpu_torch import inference as ti  # noqa: E402
from torch_port_models import float64_default  # noqa: E402
from torch_recurse_models import (close, same_choices, same_trace,  # noqa
                                  trees)

KEY = jax.random.PRNGKey(0)


def tkey(seed):
    return tt.random.PRNGKey(seed, "cpu")


def f64(x):
    return torch.tensor(x, dtype=torch.float64)


def cons(g, conv, items):
    c = g.ChoiceMap()
    for addr, v in items:
        c.set_value(addr, conv(v))
    return c


def _bool(g):
    return (lambda v: jnp.asarray(v)) if g is gt else (
        lambda v: torch.tensor(v) if isinstance(v, bool) else f64(v))


def test_simulate_and_generate_weight():
    jf, tf = trees("node")
    items = [((0, "production", "v"), 1.5),
             ((0, "production", "branch"), False)]
    j_sim = jax.jit(lambda k: jf.simulate(k, (0.0,)))
    for seed in (0, 3):
        jtr = j_sim(jax.random.PRNGKey(seed))
        with float64_default():
            ttr = tf.simulate(tkey(seed), (0.0,))
        same_trace(ttr, jtr)
    jtr, jw = jax.jit(lambda k, c: jf.generate(k, (0.0,), c))(
        KEY, cons(gt, _bool(gt), items))
    with float64_default():
        ttr, tw = tf.generate(tkey(0), (0.0,), cons(tt, _bool(tt), items))
    same_trace(ttr, jtr)
    close(tw, jw)
    np.testing.assert_allclose(float(tw), stats.norm.logpdf(1.5, 0.0, 1.0)
                               + np.log(0.6), rtol=1e-10)


@pytest.mark.parametrize("direction", ["grow", "shrink"])
def test_update_weights_and_discards(direction):
    """tests/test_recurse_static_ir.py:88 and :108: the root's branch flag
    flips; weights equal gen_tpu's and the hand-computed ones."""
    jf, tf = trees("node")
    if direction == "grow":
        start = [((0, "production", "v"), 1.0),
                 ((0, "production", "branch"), False)]
    else:
        start = [((0, "production", "branch"), True),
                 ((1, "production", "branch"), False),
                 ((2, "production", "branch"), False)]
    flip = [((0, "production", "branch"), direction == "grow")]
    jtr, _ = jf.generate(KEY, (0.0,), cons(gt, _bool(gt), start))
    jnew, jw, _, jd = jf.update(jax.random.PRNGKey(1), jtr, (0.0,),
                                (gt.UnknownChange,),
                                cons(gt, _bool(gt), flip))
    with float64_default():
        ttr, _ = tf.generate(tkey(0), (0.0,), cons(tt, _bool(tt), start))
        tnew, tw, _, td = tf.update(tkey(1), ttr, (0.0,),
                                    (tt.UnknownChange,),
                                    cons(tt, _bool(tt), flip))
    same_trace(tnew, jnew)
    close(tw, jw)
    same_choices(td, jd)
    if direction == "grow":
        assert tnew.active[1] and tnew.active[2]
        np.testing.assert_allclose(float(tw), np.log(0.4) - np.log(0.6),
                                   rtol=1e-8)
    else:
        prev = sum(float(ttr.prod_subs[i].get_score())
                   + float(ttr.agg_subs[i].get_score()) for i in (1, 2))
        np.testing.assert_allclose(
            float(tw), np.log(0.6) - np.log(0.4) - prev, rtol=1e-8)
        assert td.has_value((1, "production", "v"))


def test_regenerate_assess_and_gradients():
    jf, tf = trees("node")
    jtr = jax.jit(lambda k: jf.simulate(k, (0.0,)))(jax.random.PRNGKey(3))
    sel_j = gt.select((0, "production", "v"), (0, "production", "branch"))
    jnew, jw = jax.jit(lambda k, t: jf.regenerate(
        k, t, (0.0,), (gt.NoChange,), sel_j)[:2])(jax.random.PRNGKey(4), jtr)
    jaw, jar = jax.jit(lambda c: jf.assess((0.0,), c))(jtr.get_choices())
    _, _, jg = jf.choice_gradients(jtr, gt.select((0, "production", "v")))
    with float64_default():
        ttr = tf.simulate(tkey(3), (0.0,))
        sel_t = tt.select((0, "production", "v"), (0, "production", "branch"))
        tnew, tw, _ = tf.regenerate(tkey(4), ttr, (0.0,), (tt.NoChange,),
                                    sel_t)
        taw, tar = tf.assess((0.0,), ttr.get_choices())
        _, _, tg = tf.choice_gradients(ttr, tt.select((0, "production",
                                                       "v")))
    same_trace(ttr, jtr)
    same_trace(tnew, jnew)
    close(tw, jw)
    close(taw, jaw)
    close(taw, ttr.get_score())
    close(tar, jar)
    same_choices(tg, jg)


def _no_diff(out):
    """update's outputs without the retdiff, which is no tensor."""
    return out[0], out[1], out[3]


def test_vmapped_simulate_update_and_mh_chain():
    """16 trees under torch.func.vmap (gen_tpu: jit of vmap), then the
    root's branch flipped to True in every lane (the discard is empty under
    the transform in both); then 12 steps of selection MH on the root's
    branch flag, eager, step for step."""
    jf, tf = trees("node")
    n = 16
    flip_j = cons(gt, _bool(gt), [((0, "production", "branch"), True)])
    jtrs = jax.jit(jax.vmap(lambda k: jf.simulate(k, (0.0,))))(
        jax.random.split(KEY, n))
    jnew, jw, jd = jax.jit(jax.vmap(lambda k, t: _no_diff(jf.update(
        k, t, (0.0,), (gt.UnknownChange,), flip_j))))(
            jax.random.split(jax.random.PRNGKey(1), n), jtrs)
    with float64_default():
        flip_t = cons(tt, _bool(tt), [((0, "production", "branch"), True)])
        ttrs = vmap(lambda k: tf.simulate(k, (0.0,)))(
            tt.random.split(tkey(0), n))
        tnew, tw, td = vmap(lambda k, t: _no_diff(tf.update(
            k, t, (0.0,), (tt.UnknownChange,), flip_t)))(
                tt.random.split(tkey(1), n), ttrs)
    for t, j in ((ttrs, jtrs), (tnew, jnew)):
        same_trace(t, j, choices=False)
        close(t[(0, "production", "v")], j[(0, "production", "v")])
    close(tw, jw)
    assert td.is_empty() and jd.is_empty()

    sel_j = gt.select((0, "production", "branch"))
    jtr = jax.jit(lambda k: jf.simulate(k, (0.0,)))(KEY)
    step_j = jax.jit(lambda k, t: ji.mh_selection(k, t, sel_j))
    sizes = []
    with float64_default():
        sel_t = tt.select((0, "production", "branch"))
        ttr = tf.simulate(tkey(0), (0.0,))
        for i in range(12):
            jtr, jacc = step_j(jax.random.fold_in(KEY, i), jtr)
            ttr, tacc = ti.mh_selection(tt.random.fold_in(tkey(0), i), ttr,
                                        sel_t)
            assert bool(tacc) == bool(jacc)
            same_trace(ttr, jtr)
            sizes.append(int(ttr.active.sum()))
    assert len(set(sizes)) > 1


# -- the static IR ----------------------------------------------------------

def _build(g, static_ir):
    b = static_ir.StaticIRBuilder("static_reg")
    xs = b.argument("xs")
    slope = b.choice(g.normal, [b.julia(lambda: 0.0, []),
                                b.julia(lambda: 2.0, [])], addr="slope")
    mu = b.julia(lambda s, x: s * x, [slope, xs], name="mu")
    ys = b.choice(g.normal, [mu, b.julia(lambda: 0.5, [])], addr="ys")
    b.set_return(ys)
    return static_ir.StaticGenFn(b.build())


def test_static_gen_fn_gfi_render_and_validation():
    from gen_tpu import static_ir as jir
    from gen_tpu_torch import static_ir as tir
    jfn, tfn = _build(gt, jir), _build(tt, tir)
    xs = np.array([1.0, 2.0])
    jtr = jfn.simulate(KEY, (jnp.asarray(xs),))
    jtr2, jw = jfn.generate(KEY, (jnp.asarray(xs),),
                            gt.choicemap(slope=0.3))
    jup, juw, _, jud = jfn.update(jax.random.PRNGKey(2), jtr2,
                                  (jnp.asarray(xs),), (gt.NoChange,),
                                  gt.choicemap(slope=-0.2))
    _, _, jg = jfn.choice_gradients(jtr2, gt.select("slope"))
    with float64_default():
        ttr = tfn.simulate(tkey(0), (f64(xs),))
        ttr2, tw = tfn.generate(tkey(0), (f64(xs),),
                                tt.choicemap(slope=f64(0.3)))
        tup, tuw, _, tud = tfn.update(tkey(2), ttr2, (f64(xs),),
                                      (tt.NoChange,),
                                      tt.choicemap(slope=f64(-0.2)))
        _, _, tg = tfn.choice_gradients(ttr2, tt.select("slope"))
    for t, j in ((ttr, jtr), (ttr2, jtr2), (tup, jup)):
        close(t.get_score(), j.get_score())
        same_choices(t.get_choices(), j.get_choices())
    close(tw, jw)
    close(tuw, juw)
    same_choices(tud, jud)
    same_choices(tg, jg)
    s, ys = float(ttr["slope"]), ttr["ys"].numpy()
    np.testing.assert_allclose(
        float(ttr.get_score()), stats.norm.logpdf(s, 0, 2)
        + stats.norm.logpdf(ys, s * xs, 0.5).sum(), rtol=1e-10)
    assert tir.render_ir(tfn.ir) == jir.render_ir(jfn.ir)
    assert "digraph" in tir.render_ir(tfn.ir)

    b = tir.StaticIRBuilder()
    x = b.argument("x")
    b.choice(tt.normal, [x, x], addr="a")
    with pytest.raises(ValueError, match="duplicate"):
        b.choice(tt.normal, [x, x], addr="a")
    with pytest.raises(ValueError, match="not defined"):
        b.julia(lambda v: v, [tir.StaticIRBuilder().argument("y")])


# -- custom deterministic generative functions ------------------------------

def test_custom_determ_gfs():
    """CustomUpdateGF with a custom update and CustomGradientGF inside a
    model: the model's weights and gradients equal gen_tpu's; the
    wrappers' traces score a 0-dim zero on the arguments' device."""
    def mods(g, np_):
        cumsum = g.CustomUpdateGF(
            lambda x: np_.cumsum(x, 0),
            lambda state, args, argdiffs: (np_.cumsum(args[0], 0),
                                           np_.cumsum(args[0], 0),
                                           g.UnknownChange))
        sq = g.CustomGradientGF(lambda a, b: np_.sum(a * a) * b)

        @g.gen
        def m(x):
            c = cumsum(x) @ "c"
            s = sq(c, 2.0) @ "s"
            g.normal(s, 1.0) @ "y"
        return m, sq
    x = np.array([0.3, -0.2, 0.5])
    jm, jsq = mods(gt, jnp)
    jtr, jw = jm.generate(KEY, (jnp.asarray(x),), gt.choicemap(y=1.0))
    jup, juw, _, _ = jm.update(None, jtr, (jnp.asarray(2 * x),),
                               (gt.UnknownChange,), gt.ChoiceMap())
    jag, _, _ = jm.choice_gradients(jtr, gt.selectnone())
    jsg = jsq.gradient_with_state(None, (jnp.asarray(x), 2.0), None)
    with float64_default():
        tm, tsq = mods(tt, torch)
        ttr, tw = tm.generate(tkey(0), (f64(x),), tt.choicemap(y=f64(1.0)))
        tup, tuw, _, _ = tm.update(None, ttr, (f64(2 * x),),
                                   (tt.UnknownChange,), tt.ChoiceMap())
        tag, _, _ = tm.choice_gradients(ttr, tt.selectnone())
        tsg = tsq.gradient_with_state(None, (f64(x), 2.0), None)
        sub = tsq.simulate(tkey(1), (f64(x), 2.0))
    close(tw, jw)
    close(ttr.get_score(), jtr.get_score())
    close(tuw, juw)
    close(tup["c"], jup["c"])
    close(tag[0], jag[0])
    close(tsg[0], jsg[0])
    close(tsg[1], jsg[1])
    assert sub.get_score().ndim == 0 and float(sub.get_score()) == 0.0
    assert sub.get_score().device == torch.device("cpu")
    assert sub.get_choices().is_empty()
    with pytest.raises(ValueError, match="accepts no constraints"):
        tsq.generate(tkey(1), (f64(x), 2.0), tt.choicemap(a=f64(1.0)))
