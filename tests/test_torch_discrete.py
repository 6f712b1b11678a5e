"""gen_tpu_torch's discrete distributions against gen_tpu's
(``gen_tpu/dists/discrete.py``), in float64 (JAX's x64 mode, the port's
default float64).

Every ``logpdf`` and every finite ``enumerate_support`` equals gen_tpu's
(1e-12 relative; -inf where gen_tpu gives -inf). The six samplers built on
``random.py``'s bits (bernoulli, categorical, labeled_categorical,
uniform_discrete, geometric, dirac) equal gen_tpu's under the same keys.
poisson, binom, neg_binom and multinomial (and gamma, which the poisson
model of tests/test_mixed.py draws from) use other exact constructions
than JAX's rejection samplers, so they are held to their distributions
by a chi-square test at fixed keys (threshold: the 99.9% point of the
chi-square distribution with the bins' degrees of freedom)."""

import math

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
P5 = np.array([0.1, 0.3, 0.5, 0.7, 0.95])
PROBS4 = np.array([0.1, 0.2, 0.3, 0.4])
PROBS34 = np.array([[0.1, 0.2, 0.3, 0.4], [0.25, 0.25, 0.25, 0.25],
                    [0.7, 0.1, 0.1, 0.1]])

# name -> [(args, value), ...]; numpy arrays become tensors on each side
LOGPDF_CASES = {
    "bernoulli": [((P5,), np.array([True, False, True, True, False])),
                  ((0.3,), True), ((0.3,), False), ((0.0,), False)],
    "categorical": [((PROBS4,), 2), ((PROBS4,), np.array([0, 3, 3])),
                    ((PROBS34,), np.array([1, 0, 3]))],
    "labeled_categorical": [((PROBS4,), 1), ((PROBS4,), np.array([3, 2]))],
    "uniform_discrete": [((2, 5), 3), ((2, 5), 1), ((2, 5), 5),
                         ((2, 5), np.array([2, 6]))],
    "poisson": [((3.5,), 0), ((3.5,), 4), ((3.5,), -1),
                ((np.array([0.5, 2.0, 9.0]),), np.array([1, 2, 12]))],
    "binom": [((10, 0.3), 0), ((10, 0.3), 3), ((10, 0.3), 10),
              ((10, 0.3), 11), ((10, 1.0), 10)],
    "geometric": [((0.25,), 0), ((0.25,), 5), ((0.25,), -1),
                  ((P5,), np.array([0, 1, 2, 3, 4]))],
    "neg_binom": [((3.0, 0.4), 0), ((3.0, 0.4), 7), ((2.5, 0.9), 1),
                  ((3.0, 0.4), -2)],
    "multinomial": [((5, np.array([0.2, 0.3, 0.5])), np.array([1, 1, 3])),
                    ((5, np.array([0.2, 0.3, 0.5])), np.array([1, 1, 2])),
                    ((4, np.array([0.0, 0.5, 0.5])), np.array([0, 2, 2]))],
    "dirac": [((1.5,), 1.5), ((1.5,), 1.6), ((3,), 3), ((3,), 4),
              ((np.array([1.0, 2.0]),), np.array([1.0, 2.0 + 1e-9]))],
}
SUPPORT_CASES = {
    "bernoulli": (0.3,), "categorical": (PROBS4,),
    "labeled_categorical": (PROBS34,), "uniform_discrete": (2, 5),
    "binom": (7, 0.4),
}


def _j(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _t(x):
    return torch.as_tensor(x) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("name", sorted(LOGPDF_CASES))
def test_logpdf_matches_gen_tpu(name):
    jd, td = getattr(gt, name), getattr(tt, name)
    with float64_default():
        for args, v in LOGPDF_CASES[name]:
            want = float(jd.logpdf(_j(v), *map(_j, args)))
            got = float(td.logpdf(_t(v), *map(_t, args)))
            if math.isinf(want):
                assert got == want, (name, args, v, got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-12,
                                           err_msg=f"{name} {args} {v}")


@pytest.mark.parametrize("name", sorted(LOGPDF_CASES))
def test_enumerate_support_matches_gen_tpu(name):
    jd, td = getattr(gt, name), getattr(tt, name)
    if name not in SUPPORT_CASES:
        for d in (jd, td):
            with pytest.raises(NotImplementedError,
                               match="discrete_supports"):
                d.enumerate_support(*map(_j, LOGPDF_CASES[name][0][0]))
        return
    args = SUPPORT_CASES[name]
    np.testing.assert_array_equal(
        td.enumerate_support(*map(_t, args)).numpy(),
        np.asarray(jd.enumerate_support(*map(_j, args))))


def test_traced_support_bounds_raise():
    def f(hi):
        return tt.uniform_discrete.enumerate_support(0, hi)
    with pytest.raises(NotImplementedError, match="traced"):
        torch.func.vmap(f)(torch.tensor([3, 4]))


# name -> args of one draw, for the samplers that equal gen_tpu's
EXACT_SAMPLERS = {
    "bernoulli": (P5,), "categorical": (PROBS34,),
    "labeled_categorical": (PROBS4,), "uniform_discrete": (2, 7),
    "geometric": (P5,), "dirac": (np.array([1.5, -2.0]),),
}


@pytest.mark.parametrize("name", sorted(EXACT_SAMPLERS))
def test_exact_samplers_match_gen_tpu_under_the_same_key(name):
    jd, td = getattr(gt, name), getattr(tt, name)
    args = EXACT_SAMPLERS[name]
    with float64_default():
        for seed in range(8):
            want = np.asarray(jd.sample(jax.random.PRNGKey(seed),
                                        *map(_j, args)))
            got = td.sample(random.PRNGKey(seed, "cpu"), *map(_t, args))
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{name} seed {seed}")
            assert str(got.dtype).split(".")[-1] == str(want.dtype)


def _chi2_ok(counts, expected):
    """Chi-square of counts against expectations, with bins of fewer than
    5 expected draws merged into their neighbour."""
    counts, expected = list(counts), list(expected)
    i = 0
    while i < len(expected):
        if expected[i] < 5 and len(expected) > 2:
            e, c = expected.pop(i), counts.pop(i)
            j = min(i, len(expected) - 1)     # the next bin, or the last
            expected[j] += e
            counts[j] += c
            i = 0
            continue
        i += 1
    e, c = np.asarray(expected), np.asarray(counts)
    chi2 = float(((c - e) ** 2 / e).sum())
    crit = float(stats.chi2.ppf(0.999, len(e) - 1))
    return chi2 < crit, (chi2, crit)


def _pmf_check(draws, pmf, hi):
    draws = np.asarray(draws).astype(np.int64)
    counts = [int((draws == k).sum()) for k in range(hi)]
    counts.append(int((draws >= hi).sum()))
    probs = [pmf(k) for k in range(hi)]
    probs.append(1.0 - sum(probs))
    ok, info = _chi2_ok(counts, [p * len(draws) for p in probs])
    assert ok, info


def test_poisson_sampler_chi_square():
    lam = torch.full((N_DRAWS,), 3.5)
    _pmf_check(tt.poisson.sample(random.PRNGKey(1, "cpu"), lam),
               lambda k: stats.poisson.pmf(k, 3.5), 12)
    big = tt.poisson.sample(random.PRNGKey(2, "cpu"),
                            torch.full((N_DRAWS,), 250.0))
    assert abs(float(big.double().mean()) - 250.0) < 4 * math.sqrt(
        250.0 / N_DRAWS)


def test_binom_sampler_chi_square():
    p = torch.full((N_DRAWS,), 0.3)
    draws = tt.binom.sample(random.PRNGKey(3, "cpu"), 10, p)
    assert draws.dtype == torch.int32 and int(draws.max()) <= 10
    _pmf_check(draws, lambda k: stats.binom.pmf(k, 10, 0.3), 10)


def test_neg_binom_sampler_chi_square():
    p = torch.full((N_DRAWS,), 0.4)
    draws = tt.neg_binom.sample(random.PRNGKey(4, "cpu"), 3.0, p)
    _pmf_check(draws, lambda k: stats.nbinom.pmf(k, 3.0, 0.4), 18)


def test_multinomial_sampler_chi_square():
    probs = torch.tensor([0.2, 0.3, 0.5]).expand(N_DRAWS, 3)
    draws = tt.multinomial.sample(random.PRNGKey(5, "cpu"), 3, probs)
    assert bool((draws.sum(dim=-1) == 3).all())
    outcomes = [(a, b, 3 - a - b) for a in range(4) for b in range(4 - a)]
    d = draws.numpy().astype(np.int64)
    counts = [int(np.all(d == np.array(o), axis=1).sum()) for o in outcomes]
    expected = [N_DRAWS * stats.multinomial.pmf(o, 3, [0.2, 0.3, 0.5])
                for o in outcomes]
    ok, info = _chi2_ok(counts, expected)
    assert ok, info


def test_gamma_sampler_chi_square():
    """Probability integral transform: cdf(draws) is uniform; ten
    equiprobable bins."""
    shape = torch.full((N_DRAWS,), 2.0, dtype=torch.float64)
    draws = tt.gamma.sample(random.PRNGKey(6, "cpu"), shape, 1.5)
    u = stats.gamma.cdf(draws.numpy(), 2.0, scale=1.5)
    counts = np.bincount(np.minimum((u * 10).astype(int), 9), minlength=10)
    ok, info = _chi2_ok(list(counts), [N_DRAWS / 10] * 10)
    assert ok, info
