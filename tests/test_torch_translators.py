"""gen_tpu_torch's trace transforms, trace translators, involutive MCMC and
kernel DSL against gen_tpu's, in float64, under the same keys.

Deterministic outputs (transformed choices, log-|det J|, translator
weights) agree within 1e-12 relative; chains of ``mh_involutive`` and of
composite kernels agree step for step (values within 1e-12, accept
decisions equal), eagerly and vmapped over chains (the Jacobian under
``torch.func.vmap``, ``mixture`` in its batched-index mode against
gen_tpu's traced index). The statistical gates of
tests/test_translators_nuts.py run on the card in chip_smoke.py phase
13(c)."""

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

EXACT = 1e-12
CPU = "cpu"


def close(t, j, rtol=EXACT):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=rtol * 1e-2)


def tkey(seed):
    return tt.random.PRNGKey(seed, CPU)


def f64(x):
    return torch.tensor(x, dtype=torch.float64)


# -- transforms, written once for both packages ----------------------------

def _double(np_):
    def double_it(ctx):
        ctx.model_out["x"] = 2.0 * ctx.model_in["x"]
    return double_it


def _rot(np_):
    def rot(ctx):
        x = ctx.model_in["x"]
        y = ctx.model_in["y"]
        ctx.model_out["x"] = x + y
        ctx.model_out["y"] = x - y
    return rot


def _polar(np_):
    def polar(ctx):
        r = ctx.model_in["x"]
        th = ctx.aux_in["theta"]
        ctx.model_out["x"] = r * np_.cos(th)
        ctx.model_out["y"] = r * np_.sin(th)
    return polar


@pytest.mark.parametrize("make", [_double, _rot, _polar],
                         ids=["scale", "rotation", "polar"])
def test_transform_outputs_and_jacobian(make):
    jf = ji.transform(make(jnp))
    tf = ti.transform(make(torch))
    jm = gt.choicemap(x=1.7, y=-0.6)
    ja = gt.choicemap(theta=0.9)
    with float64_default():
        tm = tt.choicemap(x=f64(1.7), y=f64(-0.6))
        ta = tt.choicemap(theta=f64(0.9))
        tmo, _, tlog = tf.run(tm, ta)
    jmo, _, jlog = jax.jit(lambda m, a: jf.run(m, a))(jm, ja)
    close(tlog, jlog)
    assert list(tmo.addresses()) == list(jmo.addresses())
    for (_, a), (_, b) in zip(tmo.leaf_items(), jmo.leaf_items()):
        close(a, b)


def test_transform_errors_copy_and_discrete():
    def bad(np_):
        def f(ctx):
            x = ctx.model_in["x"]
            ctx.model_out["a"] = x
            ctx.model_out["b"] = 2 * x
        return f

    def both(np_):
        def f(ctx):
            b = ctx.model_in.discrete["b"]
            ctx.model_out.discrete["b"] = ~b
            ctx.copy("model_in", "keep", "model_out", "keep")
            ctx.model_out["x"] = -ctx.model_in["x"]
        return f

    for pkg, tr_mod, cm, val in ((gt, ji, gt.choicemap, jnp.asarray),
                                 (tt, ti, tt.choicemap, f64)):
        with pytest.raises(ValueError, match="not measure-preserving"):
            tr_mod.transform(bad(None)).run(cm(x=val(1.0)), pkg.ChoiceMap())
    with float64_default():
        mo, _, logJ = ti.transform(both(torch)).run(
            tt.choicemap(b=torch.tensor(True), keep=f64(5.0), x=f64(2.0)),
            tt.ChoiceMap())
    assert bool(mo["b"]) is False and float(mo["keep"]) == 5.0
    assert float(mo["x"]) == -2.0 and float(logJ) == 0.0

    def non_square(np_):
        def f(ctx):
            x = ctx.model_in["x"]
            ctx.model_out["x"] = np_.stack([x, x])
        return f

    for pkg, tr_mod, cm, val, np_ in (
            (gt, ji, gt.choicemap, jnp.asarray, jnp),
            (tt, ti, tt.choicemap, f64, torch)):
        with pytest.raises(ValueError, match="non-square"):
            tr_mod.transform(non_square(np_)).run(cm(x=val(1.0)),
                                                  pkg.ChoiceMap())


def test_deterministic_translator_weight():
    """tests/test_translators_nuts.py:258: x ~ Gamma(2, 1) -> y = log x
    under N(0, 10); weight against gen_tpu and the closed form."""
    def mods(g, np_):
        @g.gen
        def model_a():
            g.gamma(2.0, 1.0) @ "x"

        @g.gen
        def model_b():
            g.normal(0.0, 10.0) @ "y"

        def log_map(ctx):
            ctx.model_out["y"] = np_.log(ctx.model_in["x"])
        return model_a, model_b, log_map

    x0 = float(np.random.default_rng(0).gamma(2.0))
    ja, jb, jmap = mods(gt, jnp)
    jtr, _ = ja.generate(jax.random.PRNGKey(0), (), gt.choicemap(x=x0))
    jtrans = ji.DeterministicTraceTranslator(jb, (), gt.ChoiceMap(),
                                             ji.transform(jmap))
    jnew, jw = jax.jit(jtrans)(jax.random.PRNGKey(1), jtr)
    with float64_default():
        ta, tb, tmap = mods(tt, torch)
        ttr, _ = ta.generate(tkey(0), (), tt.choicemap(x=f64(x0)))
        ttrans = ti.DeterministicTraceTranslator(tb, (), tt.ChoiceMap(),
                                                 ti.transform(tmap))
        tnew, tw = ttrans(tkey(1), ttr)
    close(ttr["x"], jtr["x"])
    close(tnew["y"], jnew["y"])
    close(tw, jw)
    x = float(ttr["x"])
    expected = (stats.norm.logpdf(np.log(x), 0, 10)
                - stats.gamma.logpdf(x, 2.0) + np.log(1.0 / x))
    np.testing.assert_allclose(float(tw), expected, rtol=1e-10)


def test_general_translator_vmapped():
    """tests/test_translators_nuts.py:283's polar-to-Cartesian translator,
    vmapped over 64 keys: weights and new traces equal gen_tpu's."""
    def mods(g, np_, pi):
        @g.gen
        def radius_model():
            g.gamma(2.0, 1.0) @ "r"

        @g.gen
        def point_model():
            g.normal(0.0, 3.0) @ "px"
            g.normal(0.0, 3.0) @ "py"

        @g.gen
        def angle_fwd(tr):
            g.uniform(0.0, 2 * pi) @ "theta"

        @g.gen
        def null_bwd(tr):
            pass

        def polar_to_cart(ctx):
            r = ctx.model_in["r"]
            th = ctx.aux_in["theta"]
            ctx.model_out["px"] = r * np_.cos(th)
            ctx.model_out["py"] = r * np_.sin(th)
        return radius_model, point_model, angle_fwd, null_bwd, polar_to_cart

    def one(g, inf, rnd, ms):
        rm, pm, fwd, bwd, f = ms
        trans = inf.GeneralTraceTranslator(pm, (), g.ChoiceMap(), fwd, (),
                                           bwd, (), inf.transform(f))

        def run(k, r):
            k1, k2 = rnd.split(k)
            tra, _ = rm.generate(k1, (), g.choicemap(r=r))
            ntr, w = trans(k2, tra)
            return w, ntr["px"], ntr["py"]
        return run

    n = 64
    rs = np.random.default_rng(1).gamma(2.0, size=n)
    jw, jx, jy = jax.jit(jax.vmap(one(gt, ji, jax.random,
                                      mods(gt, jnp, np.pi))))(
        jax.random.split(jax.random.PRNGKey(2), n), jnp.asarray(rs))
    with float64_default():
        tw, tx, ty = vmap(one(tt, ti, tt.random, mods(tt, torch, np.pi)))(
            tt.random.split(tkey(2), n), f64(rs))
    close(tx, jx)
    close(ty, jy)
    close(tw, jw)


def _gamma_recip(g, np_):
    @g.gen
    def gmodel():
        g.gamma(2.0, 1.0) @ "x"

    @g.gen
    def null_proposal(tr):
        g.bernoulli(0.5) @ "dummy"

    @g.gen
    def drift(tr):
        g.normal(tr["x"], 0.3) @ "x"

    def inv(ctx):
        ctx.model_out["x"] = 1.0 / ctx.model_in["x"]
        ctx.copy("aux_in", "dummy", "aux_out", "dummy")
    return gmodel, null_proposal, inv, drift


def test_mh_involutive_recip_chain_and_vmapped():
    """x -> 1/x on Gamma(2, 1) (tests/test_translators_nuts.py:136) inside
    ``seq`` with a random-walk MH move (the port's gamma draws are not
    gen_tpu's, so the chain avoids prior draws of x): 25 steps step for
    step against gen_tpu (round-trip check on the first two), then one
    step vmapped over 32 chains, whose Jacobian runs under
    ``torch.func.vmap``."""
    jm, jq, jinv, jd = _gamma_recip(gt, jnp)
    jinv = ji.transform(jinv)

    def jstep(k, tr, check=False):
        return ji.seq(
            lambda kk, t: ji.mh_involutive(kk, t, jq, (), jinv, check=check),
            lambda kk, t: ji.mh(kk, t, proposal=jd))(k, tr)

    jtr, _ = jm.generate(jax.random.PRNGKey(0), (), gt.choicemap(x=2.0))
    with float64_default():
        tm, tq, tinv, td = _gamma_recip(tt, torch)
        tinv = ti.transform(tinv)

        def tstep(k, tr, check=False):
            return ti.seq(
                lambda kk, t: ti.mh_involutive(kk, t, tq, (), tinv,
                                               check=check),
                lambda kk, t: ti.mh(kk, t, proposal=td))(k, tr)

        ttr, _ = tm.generate(tkey(0), (), tt.choicemap(x=f64(2.0)))
        keys_j = jax.random.split(jax.random.PRNGKey(5), 25)
        keys_t = tt.random.split(tkey(5), 25)
        jit_step = jax.jit(jstep)
        accs = []
        for i in range(25):
            jtr, jacc = (jstep(keys_j[i], jtr, True) if i < 2
                         else jit_step(keys_j[i], jtr))
            ttr, tacc = tstep(keys_t[i], ttr, i < 2)
            close(ttr["x"], jtr["x"])
            assert [bool(a) for a in tacc] == [bool(a) for a in jacc]
            accs.append(bool(tacc[0]))
        assert 0 < sum(accs) < len(accs)

        n = 32
        xs = np.random.default_rng(7).gamma(2.0, size=n)
        j0, _ = jax.vmap(lambda k, x: jm.generate(k, (), gt.choicemap(x=x)))(
            jax.random.split(jax.random.PRNGKey(7), n), jnp.asarray(xs))
        jnew, jacc = jax.jit(jax.vmap(lambda t, k: ji.mh_involutive(
            k, t, jq, (), jinv)))(j0, jax.random.split(
                jax.random.PRNGKey(8), n))
        t0, _ = vmap(lambda k, x: tm.generate(k, (), tt.choicemap(x=x)))(
            tt.random.split(tkey(7), n), f64(xs))
        tnew, tacc = vmap(lambda t, k: ti.mh_involutive(
            k, t, tq, (), tinv))(t0, tt.random.split(tkey(8), n))
    close(t0["x"], j0["x"])
    close(tnew["x"], jnew["x"])
    close(tnew.get_score(), jnew.get_score())
    assert tacc.tolist() == np.asarray(jacc).tolist()


def test_mh_involutive_plain_function():
    """The bimodal flip with a plain involution function
    (tests/test_translators_nuts.py:117), 20 eager steps."""
    def mods(g):
        @g.gen
        def bimodal():
            z = g.bernoulli(0.5) @ "z"
            if z:
                g.normal(2.0, 0.5) @ "x"
            else:
                g.normal(-2.0, 0.5) @ "x"

        @g.gen
        def null_proposal(tr):
            g.bernoulli(0.5) @ "dummy"

        def invol(trace, fwd_choices, fwd_ret, args):
            z = bool(trace["z"])
            x = trace["x"]
            cons = g.choicemap(("z", not z), ("x", -x))
            new_trace, w, _, _ = trace.update(None, cons)
            return new_trace, fwd_choices, w
        return bimodal, null_proposal, invol

    jb, jq, jinv = mods(gt)
    jtr, _ = jb.generate(jax.random.PRNGKey(0), (),
                         gt.choicemap(z=True, x=2.0))
    with float64_default():
        tb, tq, tinv = mods(tt)
        ttr, _ = tb.generate(tkey(0), (),
                             tt.choicemap(z=torch.tensor(True), x=f64(2.0)))
        flips = 0
        for i in range(20):
            jtr, jacc = ji.mh_involutive(
                jax.random.fold_in(jax.random.PRNGKey(3), i), jtr, jq, (),
                jinv, check=i < 2)
            ttr, tacc = ti.mh_involutive(
                tt.random.fold_in(tkey(3), i), ttr, tq, (), tinv,
                check=i < 2)
            assert bool(tacc) == bool(jacc)
            assert bool(ttr["z"]) == bool(jtr["z"])
            close(ttr["x"], jtr["x"])
            flips += int(bool(tacc))
    assert flips > 3


def _conj(g):
    @g.gen
    def m():
        a = g.normal(0.0, 1.0) @ "a"
        g.normal(a, 0.5) @ "y"
    return m


def test_mixture_both_modes():
    """Eagerly only the chosen component runs, on k_run; vmapped (a
    batched index, gen_tpu's traced one under jit) every component runs on
    fold_in(k_run, i) and the lanes select. 30 eager steps and one
    vmapped step over 64 chains against gen_tpu."""
    def mix(g, inf):
        return inf.mixture(
            [0.3, 0.7],
            [lambda k, t: inf.mh_selection(k, t, g.select("a")),
             lambda k, t: inf.mala(k, t, g.select("a"), 0.05)])

    jmix = mix(gt, ji)
    jtr, _ = _conj(gt).generate(jax.random.PRNGKey(0), (),
                                gt.choicemap(y=1.0))
    with float64_default():
        tmix = mix(tt, ti)
        tm = _conj(tt)
        ttr, _ = tm.generate(tkey(0), (), tt.choicemap(y=f64(1.0)))
        for i in range(30):
            jtr, jacc = jmix(jax.random.fold_in(jax.random.PRNGKey(4), i),
                             jtr)
            ttr, tacc = tmix(tt.random.fold_in(tkey(4), i), ttr)
            close(ttr["a"], jtr["a"])
            assert bool(tacc) == bool(jacc)

        n = 64
        jtrs, _ = jax.vmap(lambda k: _conj(gt).generate(
            k, (), gt.choicemap(y=1.0)))(jax.random.split(
                jax.random.PRNGKey(1), n))
        jnew, jacc = jax.jit(jax.vmap(jmix))(
            jax.random.split(jax.random.PRNGKey(2), n), jtrs)
        ttrs, _ = vmap(lambda k: tm.generate(
            k, (), tt.choicemap(y=f64(1.0))))(tt.random.split(tkey(1), n))
        tnew, tacc = vmap(tmix)(tt.random.split(tkey(2), n), ttrs)
    close(tnew["a"], jnew["a"])
    close(tnew.get_score(), jnew.get_score())
    assert tacc.tolist() == np.asarray(jacc).tolist()


def test_composites_and_reversals():
    """seq(repeat(3, k), for_range(2, ...)) under checked(): step for step
    against gen_tpu with its reversal; the reversal registry of declared
    primitives survives for_range/seq/repeat nesting
    (tests/test_inference_kernels.py:218)."""
    log = []

    def make(i):
        def fwd(key, trace, *args):
            log.append(("f", i))
            return trace, None

        def bwd(key, trace, *args):
            log.append(("b", i))
            return trace, None
        return ti.primitive_kernel(fwd, reversal_fn=bwd)

    k = ti.seq(ti.repeat(2, ti.for_range(3, make)), make(9))
    k(tkey(0), None)
    assert log == [("f", 0), ("f", 1), ("f", 2)] * 2 + [("f", 9)]
    log.clear()
    ti.reversal(k)(tkey(0), None)
    assert log == [("b", 9)] + [("b", 2), ("b", 1), ("b", 0)] * 2
    log.clear()
    ti.reversal(ti.reversal(k))(tkey(0), None)
    assert log == [("f", 0), ("f", 1), ("f", 2)] * 2 + [("f", 9)]

    def comp(g, inf):
        def ka(key, trace):
            return inf.mh_selection(key, trace, g.select("a"))
        sweep = inf.for_range(2, lambda i: ka)
        return inf.checked(inf.seq(inf.repeat(3, ka), sweep),
                           g.choicemap(y=1.0))

    jc = comp(gt, ji)
    jtr, _ = _conj(gt).generate(jax.random.PRNGKey(0), (),
                                gt.choicemap(y=1.0))
    with float64_default():
        tc = tt.choicemap(y=f64(1.0))
        tk = ti.checked(ti.seq(
            ti.repeat(3, lambda k, t: ti.mh_selection(k, t, tt.select("a"))),
            ti.for_range(2, lambda i: (lambda k, t: ti.mh_selection(
                k, t, tt.select("a"))))), tc)
        ttr, _ = _conj(tt).generate(tkey(0), (), tc)
        for i in range(6):
            kj = jax.random.fold_in(jax.random.PRNGKey(6), i)
            kt = tt.random.fold_in(tkey(6), i)
            if i % 2:
                jtr, _ = ji.reversal(jc)(kj, jtr)
                ttr, _ = ti.reversal(tk)(kt, ttr)
            else:
                jtr, _ = jc(kj, jtr)
                ttr, _ = tk(kt, ttr)
            close(ttr["a"], jtr["a"])
        assert float(ttr["y"]) == 1.0


def test_cond_kernel_and_checked_raise():
    """cond_kernel dispatches on a host predicate, as gen_tpu's; checked()
    raises when a kernel changes an observation."""
    with float64_default():
        m = _conj(tt)
        tr, _ = m.generate(tkey(0), (), tt.choicemap(y=f64(1.0)))

        def pos(k, t):
            return t, "pos"

        def neg(k, t):
            return t, "neg"

        ck = ti.cond_kernel(lambda t: t["a"] > 0, pos, neg)
        assert ck(tkey(1), tr)[1] == ("pos" if float(tr["a"]) > 0
                                      else "neg")
        assert ti.reversal(ck)(tkey(1), tr)[1] == ck(tkey(1), tr)[1]

        def clobber(k, t):
            new, _, _, _ = t.update(None, tt.choicemap(y=f64(2.0)))
            return new, None

        with pytest.raises(RuntimeError, match="changed observation"):
            ti.checked(clobber, tt.choicemap(y=f64(1.0)))(tkey(2), tr)
