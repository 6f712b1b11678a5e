"""The rest of gen_tpu_torch's dists/ against gen_tpu's, in float64:
``beta_uniform``, ``piecewise_uniform``, ``dirichlet``,
``piecewise_poisson_process`` (tests/test_distributions.py's cases),
``logsumexp2``, and random.py's float64 ``erf_inv`` and
``multivariate_normal``.

Logpdfs and ``logpdf_grad`` agree within 1e-12 relative. ``piecewise_
uniform`` draws gen_tpu's values under the same keys; so does
``beta_uniform`` where its coin picks the uniform. Where gen_tpu runs
JAX's gamma or Poisson rejection samplers (``dirichlet``, the beta of
``beta_uniform``, the event count of ``piecewise_poisson_process``), the
port's draws are tested by Kolmogorov-Smirnov or chi-square against the
exact law; the process's event positions equal gen_tpu's. The float64
``erf_inv`` is held to ``jax.lax.erf_inv`` over 10^6 inputs, both tails
included: at most 3 ulp apart, and equal in over 99% of them."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from scipy import stats  # noqa: E402
from torch.func import vmap  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.dists.distribution import logsumexp2 as jlse2  # noqa: E402
from gen_tpu_torch.dists.distribution import logsumexp2 as tlse2  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

EXACT = 1e-12


def close(t, j, rtol=EXACT):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=1e-300)


def f64(x):
    return torch.as_tensor(x, dtype=torch.float64)


def grads_close(td, jd, v, args):
    with float64_default():
        tg = td.logpdf_grad(f64(v), *(f64(a) for a in args))
    jg = jax.jit(jd.logpdf_grad)(jnp.asarray(v),
                                 *(jnp.asarray(a) for a in args))
    for a, b in zip(tg, jg):
        assert (a is None) == (b is None)
        if a is not None:
            close(a, b)


def draws(td, jd, targs, jargs, n, seed=0):
    jd_ = np.asarray(jax.jit(jax.vmap(lambda k: jd.sample(k, *jargs)))(
        jax.random.split(jax.random.PRNGKey(seed), n)))
    with float64_default():
        td_ = vmap(lambda k: td.sample(k, *targs))(
            tt.random.split(tt.random.PRNGKey(seed, "cpu"), n)).numpy()
    return td_, jd_


def test_beta_uniform():
    """Logpdf inside and outside [0, 1] and its gradients; 10,000 draws:
    those whose coin chose the uniform equal gen_tpu's, the whole by KS
    against the mixture's cdf."""
    theta, a, b = 0.4, 2.0, 3.0
    for x in (0.3, 0.9, 1.2):
        with float64_default():
            tl = tt.beta_uniform.logpdf(x, theta, a, b)
        close(tl, jax.jit(gt.beta_uniform.logpdf)(x, theta, a, b))
    close(tl, -np.inf)
    close(tt.beta_uniform.logpdf(f64(0.3), f64(theta), f64(a), f64(b)),
          np.logaddexp(np.log(theta) + stats.beta.logpdf(0.3, a, b),
                       np.log(1 - theta)), 1e-10)
    grads_close(tt.beta_uniform, gt.beta_uniform, 0.3, (theta, a, b))
    n = 10000
    td_, jd_ = draws(tt.beta_uniform, gt.beta_uniform,
                     (f64(theta), f64(a), f64(b)), (theta, a, b), n)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    coin = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.bernoulli(
        jax.random.split(k, 3)[1], theta)))(keys))
    np.testing.assert_array_equal(td_[~coin], jd_[~coin])
    cdf = lambda x: theta * stats.beta.cdf(x, a, b) + (1 - theta) * x
    assert stats.kstest(td_, cdf).pvalue > 1e-3


def test_piecewise_uniform():
    bounds, probs = np.array([0.0, 1.0, 3.0]), np.array([0.6, 0.4])
    for v in (0.5, 2.0, 1.0, 4.0, -0.1):
        with float64_default():
            tl = tt.piecewise_uniform.logpdf(v, f64(bounds), f64(probs))
        close(tl, jax.jit(gt.piecewise_uniform.logpdf)(
            v, jnp.asarray(bounds), jnp.asarray(probs)))
    with float64_default():
        close(tt.piecewise_uniform.logpdf(2.0, f64(bounds), f64(probs)),
              np.log(0.2), 1e-10)
    grads_close(tt.piecewise_uniform, gt.piecewise_uniform, 2.0,
                (bounds, probs))
    td_, jd_ = draws(tt.piecewise_uniform, gt.piecewise_uniform,
                     (f64(bounds), f64(probs)),
                     (jnp.asarray(bounds), jnp.asarray(probs)), 2000)
    close(td_, jd_)
    assert 0.0 <= td_.min() and td_.max() <= 3.0


ALPHA = np.array([2.0, 3.0, 1.5])


def test_dirichlet():
    """Logpdf and gradient; 20,000 draws: on the simplex, each
    coordinate's marginal Beta(a_i, sum - a_i) by KS, the mean within
    0.01."""
    v = np.array([0.3, 0.5, 0.2])
    close(tt.dirichlet.logpdf(f64(v), f64(ALPHA)),
          jax.jit(gt.dirichlet.logpdf)(jnp.asarray(v), jnp.asarray(ALPHA)))
    close(tt.dirichlet.logpdf(f64(v), f64(ALPHA)),
          stats.dirichlet.logpdf(v, ALPHA), 1e-10)
    grads_close(tt.dirichlet, gt.dirichlet, v, (ALPHA,))
    n = 20000
    with float64_default():
        ss = vmap(lambda k: tt.dirichlet.sample(k, f64(ALPHA)))(
            tt.random.split(tt.random.PRNGKey(0, "cpu"), n)).numpy()
    np.testing.assert_allclose(ss.sum(1), 1.0, atol=1e-12)
    np.testing.assert_allclose(ss.mean(0), ALPHA / ALPHA.sum(), atol=0.01)
    for i, a in enumerate(ALPHA):
        assert stats.kstest(ss[:, i], stats.beta(
            a, ALPHA.sum() - a).cdf).pvalue > 1e-3


def test_dirichlet_in_model():
    def model(g, arr):
        @g.gen
        def mix():
            w = g.dirichlet(arr([1.0, 1.0, 1.0])) @ "w"
            g.categorical(w) @ "z"
            return w
        return mix

    tm, jm = model(tt, f64), model(gt, jnp.asarray)
    with float64_default():
        tr = tm.simulate(tt.random.PRNGKey(0, "cpu"), ())
        w, _ = tm.assess((), tr.get_choices())
    close(w, tr.get_score())
    jw, _ = jm.assess((), gt.choicemap(w=jnp.asarray(tr["w"].numpy()),
                                       z=int(tr["z"])))
    close(w, jw)


def test_piecewise_poisson_process():
    """The reference formula, padding ignored, -inf outside the bounds or
    for descending bounds; rates' gradient. Padded draws: each event at
    gen_tpu's position, the counts by chi-square against Poisson(12), and
    ``sample`` without ``max_events`` raises."""
    bounds, rates = np.array([0.0, 2.0, 5.0, 10.0]), np.array([0.5, 2.0, 1.0])
    x = np.array([1.0, 2.0, 3.0, 9.0])
    cases = (x, np.concatenate([x, np.full(3, np.inf)]), np.array([11.0]))
    for xs in cases:
        close(tt.piecewise_poisson_process.logpdf(f64(xs), f64(bounds),
                                                  f64(rates)),
              jax.jit(gt.piecewise_poisson_process.logpdf)(
                  jnp.asarray(xs), jnp.asarray(bounds), jnp.asarray(rates)))
    close(tt.piecewise_poisson_process.logpdf(f64(x), f64(bounds), f64(rates)),
          np.log(0.5 * 0.5 * 2.0 * 1.0) - 12.0, 1e-10)
    assert float(tt.piecewise_poisson_process.logpdf(
        f64(x), f64(bounds[::-1].copy()), f64(rates))) == -np.inf
    grads_close(tt.piecewise_poisson_process, gt.piecewise_poisson_process,
                x, (bounds, rates))
    with pytest.raises(NotImplementedError):
        tt.piecewise_poisson_process.sample(tt.random.PRNGKey(0, "cpu"),
                                            f64(bounds), f64(rates))
    n = 2000
    td_, jd_ = draws(tt.PiecewisePoissonProcess(max_events=64),
                     gt.PiecewisePoissonProcess(max_events=64),
                     (f64(bounds), f64(rates)),
                     (jnp.asarray(bounds), jnp.asarray(rates)), n)
    both = np.isfinite(td_) & np.isfinite(jd_)
    close(td_[both], jd_[both])
    counts = np.isfinite(td_).sum(1)
    assert counts.max() < 64
    edges = np.arange(3, 21)
    obs = np.histogram(counts, bins=np.concatenate([[0], edges, [65]]))[0]
    cdf = stats.poisson(12.0).cdf(np.concatenate([[-1], edges - 1, [64]]))
    assert stats.chisquare(obs, n * np.diff(cdf) / np.diff(cdf).sum()
                           ).pvalue > 1e-3


def test_logsumexp2():
    a = np.array([0.5, -np.inf, np.inf, -3.0, -np.inf, 700.0])
    b = np.array([1.5, 2.0, 1.0, -np.inf, -np.inf, 700.0])
    close(tlse2(f64(a), f64(b)), jlse2(jnp.asarray(a), jnp.asarray(b)))


def _ulps(a, b):
    ia, ib = a.view(np.int64), b.view(np.int64)
    ia = np.where(ia < 0, np.int64(-2 ** 63) - ia, ia)
    ib = np.where(ib < 0, np.int64(-2 ** 63) - ib, ib)
    return np.abs(ia - ib)


def test_erfinv_f64_matches_xla():
    """10^6 inputs: uniform on (-1, 1), both tails down to 1 - 1e-16, the
    last 2,000 doubles below 1, and tiny ones. Float64 normals from the
    same keys then agree within 4e-16 relative."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-1, 1, 580000), 1 - 10 ** -rng.uniform(0, 16, 200000),
        -(1 - 10 ** -rng.uniform(0, 16, 200000)),
        np.nextafter(1.0, 0) - np.arange(2000) * 2.0 ** -53,
        10 ** -rng.uniform(0, 300, 18000)])
    x = x[np.abs(x) < 1]
    assert x.size >= 10 ** 6 - 100
    j = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    t = tt.random.erfinv_f64(torch.from_numpy(x)).numpy()
    u = _ulps(t, j)
    assert u.max() <= 3 and (u == 0).mean() > 0.99
    assert tt.random.erfinv_f64(f64([1.0, -1.0])).tolist() == [np.inf,
                                                               -np.inf]
    jn = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (100000,),
                                      jnp.float64))
    tn = tt.random.normal(tt.random.PRNGKey(3, "cpu"), (100000,),
                          torch.float64).numpy()
    close(tn, jn, 4e-16)


@pytest.mark.parametrize("cov,mean_batch", [
    (np.diag([3.0, 2.0, 1.0]), ()),
    (np.diag([3.0, 2.0, 1.0]), (4,)),
    (np.array([[2.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 0.5]]), (2,)),
])
def test_multivariate_normal_matches_jax(cov, mean_batch):
    """The SVD construction, unbatched and with a batched mean: equal to
    ``jax.random.multivariate_normal(..., method="svd")`` where the two
    SVD factors agree (checked first; the dense covariance's do here)."""
    mean = np.array(np.broadcast_to([0.5, -1.0, 2.0], (*mean_batch, 3)))
    uj, sj, _ = jnp.linalg.svd(jnp.asarray(cov))
    ut, st, _ = torch.linalg.svd(f64(cov))
    close(ut * torch.sqrt(st), uj * jnp.sqrt(sj), 1e-12)
    j = jax.random.multivariate_normal(
        jax.random.PRNGKey(1), jnp.asarray(mean), jnp.asarray(cov),
        method="svd")
    with float64_default():
        t = tt.random.multivariate_normal(
            tt.random.PRNGKey(1, "cpu"), f64(mean), f64(cov))
    assert tuple(t.shape) == j.shape
    close(t, j, 1e-12)
