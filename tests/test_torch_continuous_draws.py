"""Samplers, gradients and return types of gen_tpu_torch's continuous
distributions against gen_tpu's, in float64.

``uniform``, ``exponential``, ``cauchy`` and ``laplace`` are
``jax.random``'s constructions on ``random.py``'s bits, so under the same
key they draw what gen_tpu draws. ``student_t``, ``beta`` and
``inv_gamma`` draw their gamma variates by cdf inversion where gen_tpu
runs ``jax.random.gamma``'s rejection loop; ``mvnormal``'s SVD factor may
differ from XLA's by column signs. Those four are held to their
distributions by a Kolmogorov-Smirnov test (p > 1e-3 at fixed keys) or by
their moments."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from scipy import stats  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu_torch import random  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

N_DRAWS = 20000
LOW = np.array([-1.0, 0.5, 2.0])
HIGH = np.array([1.0, 3.0, 2.5])

# name -> args of one draw, for the samplers that equal gen_tpu's
EXACT = {"uniform": (LOW, HIGH), "exponential": (np.array([0.5, 2.0]),),
         "cauchy": (np.array([0.5, -1.0]), 2.0),
         "laplace": (np.array([0.5, -1.0]), np.array([1.0, 0.2])),
         "normal": (np.array([0.5, -1.0]), 2.0)}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_exact_samplers_match_gen_tpu_under_the_same_key(name):
    with float64_default():
        for seed in (0, 3):
            jx = getattr(gt, name).sample(
                jax.random.PRNGKey(seed),
                *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                  for a in EXACT[name]])
            tx = getattr(tt, name).sample(
                random.PRNGKey(seed, "cpu"),
                *[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                  for a in EXACT[name]])
            assert tx.dtype == torch.float64
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                       rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("name,args,dist", [
    ("student_t", (5.0, 0.5, 2.0), stats.t(5.0, loc=0.5, scale=2.0)),
    ("beta", (2.0, 3.5), stats.beta(2.0, 3.5)),
    ("inv_gamma", (3.0, 2.0), stats.invgamma(3.0, scale=2.0)),
])
def test_gamma_based_samplers_by_ks(name, args, dist):
    with float64_default():
        shape_arg = torch.full((N_DRAWS,), float(args[0]))
        draws = getattr(tt, name).sample(random.PRNGKey(11, "cpu"),
                                         shape_arg, *args[1:])
    assert draws.shape == (N_DRAWS,) and draws.dtype == torch.float64
    assert stats.kstest(draws.numpy(), dist.cdf).pvalue > 1e-3


def test_mvnormal_sampler_moments():
    mu = torch.tensor([0.1, -0.2, 0.3], dtype=torch.float64)
    cov = torch.tensor([[2.0, 0.3, -0.4], [0.3, 1.0, 0.2],
                        [-0.4, 0.2, 0.7]], dtype=torch.float64)
    keys = random.split(random.PRNGKey(5, "cpu"), N_DRAWS)
    draws = torch.func.vmap(lambda k: tt.mvnormal.sample(k, mu, cov))(keys)
    assert draws.shape == (N_DRAWS, 3)
    se = torch.sqrt(torch.diagonal(cov) / N_DRAWS)
    assert float(((draws.mean(0) - mu) / se).abs().max()) < 4.5
    np.testing.assert_allclose(torch.cov(draws.T).numpy(), cov.numpy(),
                               atol=0.05)


def test_logpdf_grad_and_return_type_match_gen_tpu():
    with float64_default():
        for name, v, args in (
                ("normal", 0.7, (0.2, 1.5)),
                ("student_t", np.array([0.3, -2.0]), (4.0, 0.1, 1.2)),
                ("uniform", np.array([0.3, 0.6]), (0.0, 2.0)),
                ("bernoulli", True, (0.3,))):
            jd, td = getattr(gt, name), getattr(tt, name)
            jg = jd.logpdf_grad(
                jnp.asarray(v), *[jnp.asarray(a) for a in args])
            tg = td.logpdf_grad(
                torch.as_tensor(v), *[torch.as_tensor(a) for a in args])
            assert len(jg) == len(tg)
            for a, b in zip(jg, tg):
                assert (a is None) == (b is None), name
                if a is not None:
                    np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                               rtol=1e-12)
            assert (td.get_return_type() == torch.int32) == (
                jd.get_return_type() == jnp.int32)
