"""gen_tpu_torch's derived distributions (dists/dist_dsl.py) and mixtures
(dists/mixture.py) against gen_tpu's, in float64, on
tests/test_switch_distdsl.py's TestDistDSL and test_enum_dist cases and
tests/test_combinators.py's TestMixture cases.

Logpdfs and their gradients (``logpdf_grad``; ``choice_gradients`` through
a model) agree within 1e-12 relative. Draws under the same key are equal
where the port draws gen_tpu's construction: the affine, exp and relabeled
transforms of ``normal`` and ``categorical`` draws, the mixtures' index
and components. The operator sugar patched onto ``Distribution`` leaves
``dist(args) @ "addr"`` intact."""

import enum

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from scipy import stats  # noqa: E402
from torch.func import vmap  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.dists import dist_dsl as jdsl  # noqa: E402
from gen_tpu_torch.dists import dist_dsl as tdsl  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

EXACT = 1e-12


def close(t, j, rtol=EXACT):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=1e-300)


def f64(x):
    return torch.as_tensor(x, dtype=torch.float64)


def draws_both(jd, td, jargs, targs, n=500):
    """``n`` draws vmapped over the same keys in both frameworks."""
    jd_ = jax.jit(jax.vmap(lambda k: jd.sample(k, *jargs)))(
        jax.random.split(jax.random.PRNGKey(0), n))
    with float64_default():
        td_ = vmap(lambda k: td.sample(k, *targs))(
            tt.random.split(tt.random.PRNGKey(0, "cpu"), n))
    return td_, np.asarray(jd_)


def test_affine_transform():
    """y = 2x + 3 (and the other operators), x ~ N(0, 1)."""
    for op in (lambda d: d * 2.0 + 3.0, lambda d: 1.5 - d / 4.0,
               lambda d: -(d - 0.5), lambda d: 3.0 * d + 1.0):
        jd, td = op(gt.normal), op(tt.normal)
        assert isinstance(td, tdsl.TransformedDistribution)
        for v in (4.0, -0.7):
            with float64_default():
                tl = td.logpdf(v, 0.0, 1.0)
                tg = td.logpdf_grad(f64(v), f64(0.0), f64(1.0))
            close(tl, jd.logpdf(v, 0.0, 1.0))
            jg = jd.logpdf_grad(v, 0.0, 1.0)
            for a, b in zip(tg, jg):
                close(a, b)
        t_, j_ = draws_both(jd, td, (0.0, 1.0), (f64(0.0), f64(1.0)))
        close(t_, j_)
    with float64_default():
        close(td.logpdf(4.0, 0.0, 1.0), stats.norm.logpdf(1.0, 0.0, 1.0)
              - np.log(3.0), 1e-10)


def test_exp_transform_lognormal():
    for make in (jdsl.exp_of, jdsl.log_of):
        jd = make(gt.normal)
        td = (tdsl.exp_of if make is jdsl.exp_of else tdsl.log_of)(tt.normal)
        v = 2.0 if make is jdsl.exp_of else 0.4
        with float64_default():
            close(td.logpdf(v, 0.5, 1.0), jd.logpdf(v, 0.5, 1.0))
    with float64_default():
        close(tdsl.exp_of(tt.normal).logpdf(2.0, 0.5, 1.0),
              stats.lognorm.logpdf(2.0, 1.0, scale=np.exp(0.5)), 1e-10)
        t_, j_ = draws_both(jdsl.exp_of(gt.normal), tdsl.exp_of(tt.normal),
                            (0.5, 1.0), (f64(0.5), f64(1.0)))
    close(t_, j_)


def test_relabeled():
    labels = [10, 20, 10]
    probs = np.array([0.2, 0.3, 0.5])
    jd = jdsl.RelabeledDistribution(jnp.asarray(labels), gt.categorical)
    td = tt.RelabeledDistribution(torch.tensor(labels), tt.categorical)
    for v in (10, 20, 30):
        close(td.logpdf(v, f64(probs)), jd.logpdf(v, jnp.asarray(probs)))
    close(td.logpdf(10, f64(probs)), np.log(0.7), 1e-10)
    t_, j_ = draws_both(jd, td, (jnp.asarray(probs),), (f64(probs),))
    assert t_.tolist() == j_.tolist()


def test_in_model_with_grad():
    """``d(args) @ "y"`` of a transformed distribution: the generate
    weight and ``choice_gradients`` through it."""
    def model(g, d):
        @g.gen
        def m():
            return d(1.0, 1.0) @ "y"
        return m

    jm, tm = model(gt, gt.normal * 0.5), model(tt, tt.normal * 0.5)
    jtr, jw = jm.generate(jax.random.PRNGKey(0), (), gt.choicemap(y=0.8))
    _, _, jg = jm.choice_gradients(jtr, gt.select("y"))
    with float64_default():
        ttr, tw = tm.generate(tt.random.PRNGKey(0, "cpu"), (),
                              tt.choicemap(y=f64(0.8)))
        _, _, tg = tm.choice_gradients(ttr, tt.select("y"))
    close(tw, jw)
    close(tw, stats.norm.logpdf(0.8, 0.5, 0.5), 1e-10)
    close(tg["y"], jg["y"])


def test_enum_dist():
    class Color(enum.IntEnum):
        RED = 10
        GREEN = 20
        BLUE = 30

    probs = np.array([0.2, 0.3, 0.5])
    jd, td = jdsl.enum_dist(Color, gt.categorical), tt.enum_dist(
        Color, tt.categorical)
    t_, j_ = draws_both(jd, td, (jnp.asarray(probs),), (f64(probs),), 200)
    assert t_.tolist() == j_.tolist()
    assert Color(int(t_[0])) in Color
    for v in (10, 20, 30):
        close(td.logpdf(v, f64(probs)), jd.logpdf(v, jnp.asarray(probs)))
    d2 = tt.RelabeledDistribution(torch.tensor([1, 2, 1]), tt.categorical)
    close(d2.logpdf(1, f64(probs)), np.log(0.7), 1e-12)
    assert isinstance(tt.dist(lambda a: (a, 1.0), 1, base=tt.normal),
                      tdsl.ArgMappedDistribution)
    jam = jdsl.dist(lambda a: (a * 2.0, 1.0), 1, base=gt.normal)
    tam = tt.dist(lambda a: (a * 2.0, 1.0), 1, base=tt.normal)
    with float64_default():
        close(tam.logpdf(0.3, 0.4), jam.logpdf(0.3, 0.4))


WEIGHTS, MUS, STDS = np.array([0.4, 0.6]), np.array([-1.0, 2.0]), \
    np.array([0.5, 1.0])


def test_homogeneous_mixture():
    jmix = gt.HomogeneousMixture(gt.normal, [0, 0])
    tmix = tt.HomogeneousMixture(tt.normal, [0, 0])
    jargs = tuple(jnp.asarray(a) for a in (WEIGHTS, MUS, STDS))
    targs = tuple(f64(a) for a in (WEIGHTS, MUS, STDS))
    for v in (0.3, -1.4, 5.0):
        close(tmix.logpdf(f64(v), *targs), jmix.logpdf(v, *jargs))
        tg = tmix.logpdf_grad(f64(v), *targs)
        jg = jmix.logpdf_grad(v, *jargs)
        for a, b in zip(tg, jg):
            close(a, b)
    close(tmix.logpdf(f64(0.3), *targs),
          np.logaddexp(np.log(0.4) + stats.norm.logpdf(0.3, -1, 0.5),
                       np.log(0.6) + stats.norm.logpdf(0.3, 2, 1.0)), 1e-10)
    t_, j_ = draws_both(jmix, tmix, jargs, targs, 2000)
    close(t_, j_)
    assert abs(float(t_.mean()) - (0.4 * -1 + 0.6 * 2)) < 0.15


def test_heterogeneous_mixture():
    jmix = gt.HeterogeneousMixture([gt.normal, gt.uniform])
    tmix = tt.HeterogeneousMixture([tt.normal, tt.uniform])
    w = np.array([0.3, 0.7])
    with float64_default():
        for v in (0.5, 1.7, -0.2):
            close(tmix.logpdf(v, f64(w), 0.0, 1.0, 0.0, 2.0),
                  jmix.logpdf(v, jnp.asarray(w), 0.0, 1.0, 0.0, 2.0))
        close(tmix.logpdf(0.5, f64(w), 0.0, 1.0, 0.0, 2.0),
              np.logaddexp(np.log(0.3) + stats.norm.logpdf(0.5),
                           np.log(0.7) - np.log(2.0)), 1e-10)
    t_, j_ = draws_both(jmix, tmix, (jnp.asarray(w), 0.0, 1.0, 0.0, 2.0),
                        (f64(w), f64(0.0), f64(1.0), f64(0.0), f64(2.0)))
    close(t_, j_)
    with pytest.raises(ValueError):
        tmix.logpdf(0.5, f64(w), 0.0, 1.0, 0.0)


def test_mixture_in_model():
    def model(g, arr):
        mix = g.HomogeneousMixture(g.normal, [0, 0])

        @g.gen
        def m():
            return mix(arr([0.5, 0.5]), arr([0.0, 5.0]), arr([1.0, 1.0])) \
                @ "x"
        return m

    jm, tm = model(gt, jnp.asarray), model(tt, f64)
    jtr = jm.simulate(jax.random.PRNGKey(0), ())
    with float64_default():
        ttr = tm.simulate(tt.random.PRNGKey(0, "cpu"), ())
    close(ttr["x"], jtr["x"])
    close(ttr.get_score(), jtr.get_score())
    x = float(ttr["x"])
    close(ttr.get_score(), np.logaddexp(
        np.log(0.5) + stats.norm.logpdf(x, 0, 1),
        np.log(0.5) + stats.norm.logpdf(x, 5, 1)), 1e-10)
