"""gen_tpu_torch's Laplace approximation, exact enumeration and exact Gibbs
moves against gen_tpu's, in float64, on tests/test_laplace.py's,
tests/test_enumerate.py's and tests/test_gibbs.py's models.

Deterministic outputs agree within 1e-12 relative: the Laplace mode,
covariance and log-ML (the mode itself comes from map_optimize moves, see
tests/test_torch_local_moves.py), ``enumerate_posterior`` and
``enumerate_marginals``, ``gibbs_conditional`` (single and blocked).
Draws under the same key are equal: ``laplace_sample``, ``gibbs`` (one
chain, vmapped over keys, blocked), and the enumeration oracle's MH
chain. Each test also keeps its counterpart's check against the exact
answer."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import vmap  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu import inference as ji  # noqa: E402
from gen_tpu_torch import inference as ti  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

EXACT = 1e-12


def close(t, j, rtol=EXACT):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=1e-300)


def f64(x):
    return torch.as_tensor(x, dtype=torch.float64)


def jkey(s=0):
    return jax.random.PRNGKey(s)


def tkey(s=0):
    return tt.random.PRNGKey(s, "cpu")


def laplace_both(g_models, choices, sel, n_optimize=20):
    """gen_tpu's laplace_approx (jitted) and the port's from the same
    constrained trace. Their modes agree within 1e-8 and their log-MLs
    within 1e-10: near the mode the score is flat to its last bit, so the
    last moves' steps turn on one ulp of summation order (see
    tests/test_torch_local_moves.py). Then both evaluate the Laplace
    Gaussian at gen_tpu's mode (``n_optimize=0``): covariance and log-ML
    within 1e-12."""
    jm, tm = g_models
    jsel, tsel = gt.select(*sel), tt.select(*sel)

    def jtrace(extra={}):
        c = dict(choices, **extra)
        return jm.generate(jkey(), (), gt.choicemap(**{
            k: jnp.asarray(v) for k, v in c.items()}))[0]

    def ttrace(extra={}):
        c = dict(choices, **extra)
        return tm.generate(tkey(), (), tt.choicemap(**{
            k: f64(v) for k, v in c.items()}))[0]

    jmean, jcov, jlml = jax.jit(lambda tr: ji.laplace_approx(
        tr, jsel, n_optimize=n_optimize)[1:4])(jtrace())
    jres = ji.LaplaceResult(None, jmean, jcov, jlml, None)
    with float64_default():
        tres = ti.laplace_approx(ttrace(), tsel, n_optimize=n_optimize)
    np.testing.assert_allclose(tres.mean.numpy(), np.asarray(jmean),
                               atol=1e-8)
    np.testing.assert_allclose(float(tres.log_ml), float(jlml), atol=1e-10)
    at_mode = dict(zip(sorted(sel), np.asarray(jmean).tolist()))
    j0 = ji.LaplaceResult(None, *jax.jit(lambda tr: ji.laplace_approx(
        tr, jsel, n_optimize=0)[1:4])(jtrace(at_mode)), None)
    with float64_default():
        t0 = ti.laplace_approx(ttrace(at_mode), tsel, n_optimize=0)
    close(t0.mean, j0.mean)
    np.testing.assert_allclose(t0.cov.numpy(), np.asarray(j0.cov),
                               rtol=EXACT,
                               atol=EXACT * np.abs(np.asarray(j0.cov)).max())
    close(t0.log_ml, j0.log_ml)
    return jres, tres


def _conj(g, n, ones):
    @g.gen
    def model():
        mu = g.normal(0.0, 3.0) @ "mu"
        g.normal(mu * ones, 1.0) @ "ys"
    return model


def test_laplace_exact_on_conjugate_normal():
    n = 20
    jres, tres = laplace_both(
        (_conj(gt, n, jnp.ones(n)), _conj(tt, n, torch.ones(n, dtype=torch.float64))),
        dict(ys=np.full(n, 2.0), mu=0.0), ("mu",))
    post_prec = 1 / 9 + n
    close(tres.mean[0], 2.0 * n / post_prec, 1e-8)
    close(tres.cov[0, 0], 1 / post_prec, 1e-10)
    cov = np.eye(n) + 9 * np.ones((n, n))
    y = np.full(n, 2.0)
    exact = (-0.5 * y @ np.linalg.solve(cov, y)
             - 0.5 * np.linalg.slogdet(cov)[1] - 0.5 * n * np.log(2 * np.pi))
    assert abs(float(tres.log_ml) - exact) < 1e-10


XS = np.linspace(-2, 2, 30)


def _reg(g, xs):
    @g.gen
    def reg():
        s = g.normal(0.0, 2.0) @ "s"
        b = g.normal(0.0, 2.0) @ "b"
        g.normal(s * xs + b, 0.3) @ "ys"
    return reg


def test_laplace_multivariate_regression_and_sample():
    jres, tres = laplace_both(
        (_reg(gt, jnp.asarray(XS)), _reg(tt, f64(XS))),
        dict(ys=0.5 * XS - 1.0, s=0.0, b=0.0), ("s", "b"))
    assert abs(float(tres.mean[1]) - 0.5) < 1e-3
    assert abs(float(tres.mean[0]) + 1.0) < 1e-3
    js = ji.laplace_sample(jkey(1), jres, 400)
    with float64_default():
        ts = ti.laplace_sample(tkey(1), tres, 400)
        tj = ti.laplace_sample(tkey(1), ti.LaplaceResult(
            tres.trace, f64(np.asarray(jres.mean)),
            f64(np.asarray(jres.cov)), tres.log_ml, tres.rebuild), 400)
    assert ts.shape == (400, 2)
    close(tj, js, 1e-10)
    close(ts, js, 1e-6)


def _cubic(g):
    @g.gen
    def model():
        mu = g.normal(0.0, 1.0) @ "mu"
        g.normal(mu ** 3 / 3.0 + mu, 0.8) @ "y"
    return model


def test_laplace_evidence_vs_quadrature_non_gaussian():
    _, tres = laplace_both((_cubic(gt), _cubic(tt)), dict(y=1.2, mu=0.5),
                           ("mu",))
    grid = np.linspace(-6, 6, 20001)
    lp = (-0.5 * grid ** 2 - np.log(2 * np.pi) - np.log(0.8)
          - 0.5 * ((1.2 - (grid ** 3 / 3 + grid)) / 0.8) ** 2)
    assert abs(float(tres.log_ml) - np.log(np.trapezoid(np.exp(lp), grid))) < 0.1


def test_dirac_distribution():
    assert float(tt.dirac.logpdf(3, 3)) == float(gt.dirac.logpdf(3, 3)) == 0.0
    assert float(tt.dirac.logpdf(2, 3)) == -np.inf

    @tt.gen
    def clamped():
        x = tt.dirac(4.0) @ "x"
        tt.normal(x, 1.0) @ "y"
        return x

    with float64_default():
        tr = clamped.simulate(tkey(), ())
        assert float(tr["x"]) == 4.0
        w, _ = clamped.assess((), tr.get_choices())
        close(w, tr.get_score())
        _, w2 = clamped.generate(tkey(), (), tt.choicemap(x=f64(5.0),
                                                          y=f64(5.0)))
    assert float(w2) == -np.inf


def _coins(g, np_):
    @g.gen
    def two_coins():
        a = g.bernoulli(0.3) @ "a"
        b = g.bernoulli(0.6) @ "b"
        p = np_.where(a & b, 0.9, np_.where(a | b, 0.5, 0.1))
        g.bernoulli(p) @ "y"
    return two_coins


J_COINS, T_COINS = _coins(gt, jnp), _coins(tt, torch)


@pytest.mark.parametrize("y", [True, False])
def test_enumerate_matches_gen_tpu(y):
    """enumerate_posterior and enumerate_marginals: the grid in 'ij'
    order, every output within 1e-12."""
    jsup = {"a": jnp.asarray([False, True]), "b": jnp.asarray([False, True])}
    jg, jj, jl, jp = jax.jit(lambda: ji.enumerate_posterior(
        J_COINS, (), gt.choicemap(y=y), jsup))()
    jmarg, jl2 = ji.enumerate_marginals(J_COINS, (), gt.choicemap(y=y), jsup)
    with float64_default():
        tsup = {"a": torch.tensor([False, True]),
                "b": torch.tensor([False, True])}
        tobs = tt.choicemap(y=torch.tensor(y))
        tg, tj, tl, tp = ti.enumerate_posterior(T_COINS, (), tobs, tsup)
        tmarg, tl2 = ti.enumerate_marginals(T_COINS, (), tobs, tsup)
    for p in (("a",), ("b",)):
        assert tg[p].tolist() == np.asarray(jg[p]).tolist()
        close(tmarg[p], jmarg[p])
    for t_, j_ in ((tj, jj), (tl, jl), (tp, jp), (tl2, jl2)):
        close(t_, j_)
    total = sum(pa * pb * (pyv if y else 1 - pyv)
                for pa, pb, pyv in ((0.7 * 0.4, 1, 0.1), (0.7 * 0.6, 1, 0.5),
                                    (0.3 * 0.4, 1, 0.5), (0.3 * 0.6, 1, 0.9)))
    close(tl, np.log(total), 1e-10)


def _cat(g):
    @g.gen
    def cat_model():
        k = g.uniform_discrete(0, 4) @ "k"
        g.normal(1.0 * k, 0.7) @ "y"
    return cat_model


def test_enumeration_is_the_oracle_for_mh():
    """Selection MH over a discrete latent, step for step with gen_tpu for
    400 steps, its frequencies against the enumerated posterior (within
    0.1: gen_tpu's own test holds 18,000 draws to 0.02)."""
    jm, tm = _cat(gt), _cat(tt)
    jmarg, _ = ji.enumerate_marginals(jm, (), gt.choicemap(y=2.3),
                                      {"k": jnp.arange(5)})
    with float64_default():
        tmarg, _ = ti.enumerate_marginals(tm, (), tt.choicemap(y=f64(2.3)),
                                          {"k": torch.arange(5)})
    close(tmarg[("k",)], jmarg[("k",)])
    n = 400
    jtr, _ = jm.generate(jkey(), (), gt.choicemap(y=2.3))

    def step(tr, k):
        tr, _ = ji.mh(k, tr, gt.select("k"))
        return tr, tr["k"]

    _, jks = jax.jit(lambda tr, ks: jax.lax.scan(step, tr, ks))(
        jtr, jax.random.split(jkey(1), n))
    with float64_default():
        ttr, _ = tm.generate(tkey(), (), tt.choicemap(y=f64(2.3)))
        tks = []
        for k in tt.random.split(tkey(1), n):
            ttr, _ = ti.mh(k, ttr, tt.select("k"))
            tks.append(int(ttr["k"]))
    assert tks == np.asarray(jks).tolist()
    emp = np.bincount(np.asarray(tks)[100:], minlength=5) / (n - 100)
    np.testing.assert_allclose(emp, tmarg[("k",)].numpy(), atol=0.1)


def _mixture(g, np_, mus):
    @g.gen
    def mixture_model():
        z = g.bernoulli(0.3) @ "z"
        g.normal(np_.where(z, mus[1], mus[0]), 1.0) @ "x"
        return z
    return mixture_model


J_MIX = _mixture(gt, jnp, jnp.asarray([-1.0, 2.0]))
T_MIX = _mixture(tt, torch, torch.tensor([-1.0, 2.0], dtype=torch.float64))


def mix_traces(x_obs, z0):
    jtr, _ = J_MIX.generate(jkey(), (), gt.choicemap(x=x_obs, z=z0))
    with float64_default():
        ttr, _ = T_MIX.generate(tkey(), (), tt.choicemap(
            x=f64(x_obs), z=torch.tensor(z0)))
    return jtr, ttr


def test_conditional_matches_hand_computed():
    jtr, ttr = mix_traces(0.8, False)
    jg, jl = ji.gibbs_conditional(jtr, "z", jnp.asarray([False, True]))
    with float64_default():
        tg, tl = ti.gibbs_conditional(ttr, "z", torch.tensor([False, True]))
    close(tl, jl)
    assert tg[("z",)].tolist() == [False, True]
    lp = np.array([np.log(0.7) - 0.5 * 1.8 ** 2, np.log(0.3) - 0.5 * 1.2 ** 2])
    close(tl, lp - np.log(np.exp(lp).sum()), 1e-10)


def test_gibbs_sampling_frequencies():
    """One move vmapped over 4,000 keys draws what gen_tpu draws."""
    jtr, ttr = mix_traces(0.8, False)
    n = 4000
    jz = jax.jit(jax.vmap(lambda k: ji.gibbs(
        k, jtr, "z", jnp.asarray([False, True]))["z"]))(
            jax.random.split(jkey(1), n))
    with float64_default():
        tz = vmap(lambda k: ti.gibbs(k, ttr, "z", torch.tensor(
            [False, True]))["z"])(
                tt.random.split(tkey(1), n))
    assert tz.tolist() == np.asarray(jz).tolist()
    lp = np.array([np.log(0.7) - 0.5 * 1.8 ** 2, np.log(0.3) - 0.5 * 1.2 ** 2])
    p = np.exp(lp[1]) / np.exp(lp).sum()
    assert abs(tz.double().mean().item() - p) < 4 * np.sqrt(p * (1 - p) / n)


def _two_site(g, np_, means):
    @g.gen
    def two_site_model():
        z1 = g.categorical(np_.asarray([0.2, 0.5, 0.3])) @ "z1"
        z2 = g.bernoulli(0.4) @ "z2"
        mean = means[z1.reshape(1)][0] if g is tt else means[z1]
        g.normal(mean + np_.where(z2, 1.0, 0.0), 0.7) @ "x"
        return z1
    return two_site_model


def test_blocked_gibbs_exact_joint_conditional():
    jm = _two_site(gt, jnp, jnp.asarray([-2.0, 0.0, 2.0]))
    tm = _two_site(tt, torch, torch.tensor([-2.0, 0.0, 2.0],
                                           dtype=torch.float64))
    jtr, _ = jm.generate(jkey(), (), gt.choicemap(x=0.4, z1=0, z2=False))
    jsup = {"z1": jnp.arange(3), "z2": jnp.asarray([False, True])}
    jg, jl = ji.gibbs_conditional(jtr, jsup)
    jnew = jax.jit(jax.vmap(lambda k: ji.gibbs(k, jtr, jsup)))(
        jax.random.split(jkey(2), 300))
    with float64_default():
        ttr, _ = tm.generate(tkey(), (), tt.choicemap(
            x=f64(0.4), z1=torch.tensor(0), z2=torch.tensor(False)))
        tsup = {"z1": torch.arange(3), "z2": torch.tensor([False, True])}
        tg, tl = ti.gibbs_conditional(ttr, tsup)
        tnew = vmap(lambda k: ti.gibbs(k, ttr, tsup))(
            tt.random.split(tkey(2), 300))
    close(tl, jl)
    assert tg[("z1",)].tolist() == [0, 0, 1, 1, 2, 2]
    assert tnew["z1"].tolist() == np.asarray(jnew["z1"]).tolist()
    assert tnew["z2"].tolist() == np.asarray(jnew["z2"]).tolist()
    close(tnew.get_score(), jnew.get_score())


def test_gibbs_is_stationary_for_exact_posterior():
    jtr, ttr = mix_traces(-0.5, True)
    jn = ji.gibbs(jkey(5), jtr, "z", jnp.asarray([False, True]))
    with float64_default():
        tn = ti.gibbs(tkey(5), ttr, "z", torch.tensor([False, True]))
        w, _ = T_MIX.assess((), tn.get_choices())
    assert bool(tn["z"]) == bool(jn["z"])
    close(tn.get_score(), w)
    close(tn.get_score(), jn.get_score())
