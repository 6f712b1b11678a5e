"""gen_tpu_torch's linear-Gaussian state-space family and batched MVN
helpers against gen_tpu's (``gen_tpu/models/lgssm.py``,
``gen_tpu/ops/mvn.py``), in float64, and the quadrature references of the
two phase-10 models (``gen_tpu_torch/_verify.py``) against the benchmark
scripts they are ported from.

- ``kalman_filter`` and ``kalman_smoother`` equal gen_tpu's at 1e-10:
  the port's Python loop over time against gen_tpu's ``lax.scan``.
- ``lgssm(T).logpdf``, ``lgssm_kernel``'s weights and ``lgssm(T).sample``
  (same keys) equal gen_tpu's; the MVN helpers too, and their draws have
  the right moments.
- ``ar1_quadrature`` and ``robust_t_quadrature`` give gen_tpu's
  ``quadrature_exact`` and ``quadrature_reference`` moments."""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu import models as jm  # noqa: E402
from gen_tpu.ops import mvn as jmvn  # noqa: E402
from gen_tpu_torch import _verify, random  # noqa: E402
from gen_tpu_torch import models as tm  # noqa: E402
from gen_tpu_torch.ops import mvn as tmvn  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")


def _params(seed=0, d=2, p=3):
    """A stable random LGSSM (tests/test_lgssm.py's construction), as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    a = 0.6 * rng.standard_normal((d, d))
    a = a / max(1.0, 1.1 * np.max(np.abs(np.linalg.eigvals(a))))
    qh, rh, ph = (rng.standard_normal(s) for s in ((d, d), (p, p), (d, d)))
    c = rng.standard_normal((p, d))
    return (a, qh @ qh.T / d + 0.3 * np.eye(d), c,
            rh @ rh.T / p + 0.2 * np.eye(p), rng.standard_normal(d),
            ph @ ph.T / d + 0.5 * np.eye(d))


def _both(seed=0, T=12, d=2, p=3):
    ps = _params(seed, d, p)
    ys = np.random.default_rng(seed + 100).standard_normal((T, p))
    return (jm.LGSSMParams(*map(jnp.asarray, ps)), jnp.asarray(ys),
            tm.LGSSMParams(*map(torch.as_tensor, ps)), torch.as_tensor(ys))


@pytest.mark.parametrize("seed,d,p", [(0, 2, 3), (1, 3, 1)])
def test_kalman_filter_matches_gen_tpu(seed, d, p):
    jp, jy, tp, ty = _both(seed, 12, d, p)
    want = jm.kalman_filter(jp, jy)
    got = tm.kalman_filter(tp, ty)
    for w, g in zip(want, got):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)


def test_kalman_smoother_matches_gen_tpu():
    jp, jy, tp, ty = _both(2, 10)
    for w, g in zip(jm.kalman_smoother(jp, jy), tm.kalman_smoother(tp, ty)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)


def test_lgssm_distribution_and_kernel_match_gen_tpu():
    jp, jy, tp, ty = _both(3, 8)
    np.testing.assert_allclose(float(tm.lgssm(8).logpdf(ty, *tp)),
                               float(jm.lgssm(8).logpdf(jy, *jp)),
                               rtol=1e-12)
    # the same keys draw the same sequences
    np.testing.assert_allclose(
        tm.lgssm(8).sample(random.PRNGKey(4, "cpu"), *tp).numpy(),
        np.asarray(jm.lgssm(8).sample(jax.random.PRNGKey(4), *jp)),
        rtol=1e-10, atol=1e-12)
    x_prev = np.array([0.3, -0.2])
    x, y = np.array([0.1, 0.4]), np.array([0.5, -0.3, 1.0])
    with float64_default():
        for t in (0, 3):
            jw, _ = jm.lgssm_kernel.assess(
                (t, jnp.asarray(x_prev), *jp),
                gt.choicemap(x=jnp.asarray(x), y=jnp.asarray(y)))
            tw, _ = tm.lgssm_kernel.assess(
                (t, torch.as_tensor(x_prev), *tp),
                tt.choicemap(x=torch.as_tensor(x), y=torch.as_tensor(y)))
            np.testing.assert_allclose(float(tw), float(jw), rtol=1e-12)


def test_mvn_rows_match_gen_tpu():
    ps = _params(5, 3, 3)
    cov = ps[3]
    xs = np.random.default_rng(6).standard_normal((40, 3))
    mu = np.array([0.1, -0.2, 0.3])
    jpre = jmvn.mvn_precompute(jnp.asarray(cov))
    tpre = tmvn.mvn_precompute(torch.as_tensor(cov))
    for w, g in zip(jpre, tpre):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-14)
    want = np.asarray(jmvn.mvn_logpdf_rows(jnp.asarray(xs), jnp.asarray(mu),
                                           jpre))
    got = tmvn.mvn_logpdf_rows(torch.as_tensor(xs), torch.as_tensor(mu),
                               tpre)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    # the bfloat16 mode rounds the operands: close to the exact rows
    approx = tmvn.mvn_logpdf_rows(torch.as_tensor(xs), torch.as_tensor(mu),
                                  tpre, dtype=torch.bfloat16)
    np.testing.assert_allclose(approx.numpy(), want, rtol=0.05, atol=0.05)


def test_mvn_sample_rows_moments():
    cov = torch.tensor([[1.5, 0.4], [0.4, 0.8]], dtype=torch.float64)
    mu = torch.tensor([0.5, -1.0], dtype=torch.float64)
    for arg in (cov, tmvn.mvn_precompute(cov)):
        xs = tmvn.mvn_sample_rows(random.PRNGKey(7, "cpu"), mu, arg, 40000)
        assert xs.shape == (40000, 2)
        np.testing.assert_allclose(xs.mean(0).numpy(), mu.numpy(),
                                   atol=0.03)
        np.testing.assert_allclose(torch.cov(xs.T).numpy(), cov.numpy(),
                                   atol=0.04)


def test_ar1_quadrature_matches_bench_statespace():
    """The closed-form AR(1)+noise quadrature against
    ``bench_statespace_fused.quadrature_exact``, which assesses the gen_tpu
    model at every grid node (31 points per axis here)."""
    sys.path.insert(0, BENCH)
    import bench_statespace_fused as B
    T = 100
    ys = np.asarray(B.make_dataset(T))
    want = B.quadrature_exact(B.make_model(T), (jnp.float32(2.0),),
                              jnp.asarray(ys), n_grid=31)
    got = _verify.ar1_quadrature(ys, n_grid=31)
    for name, (m, s) in got.items():
        m_ex, s_ex = want[(name,)]
        assert abs(m - m_ex) < 2e-4 * s_ex and abs(s / s_ex - 1) < 2e-4, (
            name, m, m_ex, s, s_ex)


def test_robust_t_quadrature_matches_bench_stream():
    """The float64 robust-t quadrature (Newton-centred) against
    ``bench_stream.quadrature_reference`` (Laplace-centred, float32
    partials) at n = 2,000 and 24 grid points per axis."""
    sys.path.insert(0, BENCH)
    import bench_stream as B
    xs, ys = B.make_data(0, 2000)
    want = B.quadrature_reference(xs, ys, n_grid=24)
    got = _verify.robust_t_quadrature(np.array(xs), np.array(ys),
                                      n_grid=24)
    for name, (m, s) in got.items():
        m_ex, s_ex = want[(name,)]
        assert abs(m - m_ex) < 0.01 * s_ex and abs(s / s_ex - 1) < 0.01, (
            name, m, m_ex, s, s_ex)
