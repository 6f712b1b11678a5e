"""The main path's models written twice, for gen_tpu and for gen_tpu_torch,
with their data made by numpy: the headline regression model (bench.py)
and eight_schools (benchmarks/bench_hard_targets.py, the general-model
engine's workload). Shared by the tests/test_torch_*.py files that hold
the port to gen_tpu."""

import contextlib

import jax.numpy as jnp
import numpy as np
import torch

import gen_tpu as gt
import gen_tpu_torch as tt

# One intra-op thread per test process. The suite runs as six pytest-xdist
# workers on the CPU, and each worker's torch would start one OpenMP thread
# per core: the port's tests are thousands of small ops, and the threads'
# spinning between them oversubscribed the cores (the port's files summed
# 2,031 s of junit time with the default threads and 1,095 s with one).
# xdist imports every test module in every worker, and most port test
# files import this module, so the setting holds in every worker.
torch.set_num_threads(1)

N_POINTS = 50
XS = np.linspace(-3.0, 3.0, N_POINTS).astype(np.float32)
YS = (np.float32(0.7) * XS - np.float32(0.4) + np.float32(0.5)
      * np.random.default_rng(0).standard_normal(N_POINTS)
      .astype(np.float32))
X = np.stack([XS, np.ones_like(XS)], axis=1)
ADDRS = ("slope", "intercept", "log_noise")


@gt.gen
def jax_regression(X):
    slope = gt.normal(0.0, 2.0) @ "slope"
    intercept = gt.normal(0.0, 2.0) @ "intercept"
    log_noise = gt.normal(0.0, 1.0) @ "log_noise"
    gt.normal_linear(X, jnp.stack([slope, intercept]),
                     jnp.exp(log_noise)) @ "ys"
    return slope


@tt.gen
def torch_regression(X):
    slope = tt.normal(0.0, 2.0) @ "slope"
    intercept = tt.normal(0.0, 2.0) @ "intercept"
    log_noise = tt.normal(0.0, 1.0) @ "log_noise"
    tt.normal_linear(X, torch.stack([slope, intercept]),
                     torch.exp(log_noise)) @ "ys"
    return slope


YS_8 = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
SIGMAS_8 = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])
SCHOOL_ADDRS = ("mu", "log_tau", "theta_std")


def make_schools(K=100, seed=0, mu_true=4.0, tau_true=6.0):
    """K synthetic schools from the model's prior-predictive structure."""
    rng = np.random.default_rng(seed)
    sigmas = rng.uniform(9.0, 18.0, K)
    theta = mu_true + tau_true * rng.standard_normal(K)
    ys = theta + sigmas * rng.standard_normal(K)
    return ys, sigmas


@gt.gen
def jax_eight_schools(sigmas):
    mu = gt.normal(0.0, 10.0) @ "mu"
    log_tau = gt.normal(0.0, 1.5) @ "log_tau"
    theta_std = gt.normal(jnp.zeros(sigmas.shape[0]), 1.0) @ "theta_std"
    gt.normal(mu + jnp.exp(log_tau) * theta_std, sigmas) @ "ys"
    return mu


@tt.gen
def torch_eight_schools(sigmas):
    mu = tt.normal(0.0, 10.0) @ "mu"
    log_tau = tt.normal(0.0, 1.5) @ "log_tau"
    theta_std = tt.normal(torch.zeros(sigmas.shape[0], dtype=sigmas.dtype,
                                      device=sigmas.device), 1.0) \
        @ "theta_std"
    tt.normal(mu + torch.exp(log_tau) * theta_std, sigmas) @ "ys"
    return mu


def jax_args(dtype=jnp.float32):
    return (jnp.asarray(X, dtype),), gt.choicemap(ys=jnp.asarray(YS, dtype))


def torch_args(dtype=torch.float32):
    return ((torch.tensor(X, dtype=dtype),),
            tt.choicemap(ys=torch.tensor(YS, dtype=dtype)))


@contextlib.contextmanager
def float64_default():
    """torch's default dtype float64 for the block: the port's counterpart
    of JAX's x64 mode, where the models' Python-float prior parameters
    become float64."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


# -- mixed discrete + continuous models (tests/test_mixed.py's GMM and
#    scalar categorical model; examples/regression.py's flagship) ----------

GMM_SIGMA, GMM_TAU = 1.0, 1.5
GMM_LOCS = (-2.0, 2.0)
GMM_YS = np.array([-2.3, -1.8, -0.4, 0.6, 2.2, 1.9])
SCALAR_LOCS = np.array([-3.0, 0.0, 3.0])
SCALAR_PRIOR = np.array([0.5, 0.3, 0.2])


@gt.gen
def _jax_gmm_datum(mu0, mu1):
    z = gt.bernoulli(0.5) @ "z"
    return gt.normal(jnp.where(z, mu1, mu0), GMM_SIGMA) @ "y"


_jax_gmm_data = gt.Map(_jax_gmm_datum)


@gt.gen
def jax_gmm(n):
    mu0 = gt.normal(GMM_LOCS[0], GMM_TAU) @ "mu0"
    mu1 = gt.normal(GMM_LOCS[1], GMM_TAU) @ "mu1"
    return _jax_gmm_data(jnp.full(n, mu0), jnp.full(n, mu1)) @ "data"


@tt.gen
def _torch_gmm_datum(mu0, mu1):
    z = tt.bernoulli(0.5) @ "z"
    return tt.normal(torch.where(z, mu1, mu0), GMM_SIGMA) @ "y"


_torch_gmm_data = tt.Map(_torch_gmm_datum)


@tt.gen
def torch_gmm(n):
    mu0 = tt.normal(GMM_LOCS[0], GMM_TAU) @ "mu0"
    mu1 = tt.normal(GMM_LOCS[1], GMM_TAU) @ "mu1"
    return _torch_gmm_data(mu0.expand(n), mu1.expand(n)) @ "data"


@gt.gen
def _jax_reg_datum(x, slope, intercept, inlier_std, outlier_std):
    is_outlier = gt.bernoulli(0.5) @ "is_outlier"
    std = jnp.where(is_outlier, outlier_std, inlier_std)
    return gt.normal(slope * x + intercept, std) @ "y"


_jax_reg_data = gt.Map(_jax_reg_datum)


@gt.gen
def jax_outlier_regression(xs):
    slope = gt.normal(0.0, 2.0) @ "slope"
    intercept = gt.normal(0.0, 2.0) @ "intercept"
    inlier_log_std = gt.normal(0.0, 1.0) @ "inlier_log_std"
    outlier_log_std = gt.normal(2.0, 1.0) @ "outlier_log_std"
    n = xs.shape[0]
    return _jax_reg_data(
        xs, jnp.full(n, slope), jnp.full(n, intercept),
        jnp.full(n, jnp.exp(inlier_log_std)),
        jnp.full(n, jnp.exp(outlier_log_std))) @ "data"


@tt.gen
def _torch_reg_datum(x, slope, intercept, inlier_std, outlier_std):
    is_outlier = tt.bernoulli(0.5) @ "is_outlier"
    std = torch.where(is_outlier, outlier_std, inlier_std)
    return tt.normal(slope * x + intercept, std) @ "y"


_torch_reg_data = tt.Map(_torch_reg_datum)


@tt.gen
def torch_outlier_regression(xs):
    slope = tt.normal(0.0, 2.0) @ "slope"
    intercept = tt.normal(0.0, 2.0) @ "intercept"
    inlier_log_std = tt.normal(0.0, 1.0) @ "inlier_log_std"
    outlier_log_std = tt.normal(2.0, 1.0) @ "outlier_log_std"
    n = xs.shape[0]
    return _torch_reg_data(
        xs, slope.expand(n), intercept.expand(n),
        torch.exp(inlier_log_std).expand(n),
        torch.exp(outlier_log_std).expand(n)) @ "data"


def outlier_dataset(n=50, seed=0):
    """examples/regression.py::make_dataset as numpy arrays."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-5, 5, n)
    ys = -1.2 * xs + 2.0 + rng.normal(0, 0.5, n)
    outliers = rng.random(n) < 0.15
    ys[outliers] = rng.normal(0, 8.0, outliers.sum())
    return xs, ys


@gt.gen
def jax_scalar_mix():
    k = gt.categorical(jnp.asarray(SCALAR_PRIOR)) @ "k"
    mu = gt.normal(jnp.asarray(SCALAR_LOCS)[k], 1.0) @ "mu"
    return gt.normal(mu, 0.5) @ "y"


@tt.gen
def torch_scalar_mix():
    k = tt.categorical(torch.tensor(SCALAR_PRIOR,
                                    dtype=torch.get_default_dtype())) @ "k"
    locs = torch.tensor(SCALAR_LOCS, dtype=torch.get_default_dtype())
    # a 1-element index: torch takes a 0-dim index tensor as an integer,
    # which a chain-batched k under torch.func.grad cannot be
    mu = tt.normal(locs[k.long().reshape(1)][0], 1.0) @ "mu"
    return tt.normal(mu, 0.5) @ "y"


def gmm_obs(g, ys):
    """Observations of ``data``'s y at every element, for package ``g``."""
    obs = g.ChoiceMap()
    obs.set_submap("data", g.vector_choicemap(len(ys), y=ys))
    return obs


def mixed_problems(dtype):
    """name -> (jax model, torch model, jax args, torch args, jax obs,
    torch obs) for the three models of sample_posterior's mixed path, in
    ``dtype`` (torch) and its JAX counterpart."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    xs, ys = outlier_dataset()
    return {
        "gmm": (jax_gmm, torch_gmm, (6,), (6,),
                gmm_obs(gt, jnp.asarray(GMM_YS, jdt)),
                gmm_obs(tt, torch.tensor(GMM_YS, dtype=dtype))),
        "regression": (jax_outlier_regression, torch_outlier_regression,
                       (jnp.asarray(xs, jdt),),
                       (torch.tensor(xs, dtype=dtype),),
                       gmm_obs(gt, jnp.asarray(ys, jdt)),
                       gmm_obs(tt, torch.tensor(ys, dtype=dtype))),
        "scalar": (jax_scalar_mix, torch_scalar_mix, (), (),
                   gt.choicemap(y=jnp.asarray(2.4, jdt)),
                   tt.choicemap(y=torch.tensor(2.4, dtype=dtype))),
    }


def same_choices(jtr, ttr, rtol=1e-8):
    """Two traces hold the same addresses with values within ``rtol``."""
    jl = list(jtr.get_choices().leaf_items())
    tl = list(ttr.get_choices().leaf_items())
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(b.numpy(), np.float64),
                                   np.asarray(a, np.float64), rtol=rtol,
                                   err_msg=str(p))


# -- the phase-10 models: the streamed robust regression
# (benchmarks/bench_stream.py) and the collapsed Kalman logp
# (tests/test_hmc_fused.py::_kalman_logp) -----------------------------------

ROBUST_ADDRS = ("slope", "intercept", "log_noise")


def robust_data(n, seed=0):
    """benchmarks/bench_stream.py::make_data, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-2.0, 2.0, n)
    ys = 0.7 * xs + -0.4 + 0.5 * rng.standard_t(4.0, n)
    return xs.astype(np.float32), ys.astype(np.float32)


def robust_models(n, seed=0):
    """(gen_tpu model, port model, ys) of bench_stream's robust-t
    regression over ``robust_data(n, seed)``."""
    xs, ys = robust_data(n, seed)
    jxs, txs = jnp.asarray(xs), torch.from_numpy(xs)

    @gt.gen
    def jax_robust():
        slope = gt.normal(0.0, 2.0) @ "slope"
        intercept = gt.normal(0.0, 2.0) @ "intercept"
        log_noise = gt.normal(0.0, 1.0) @ "log_noise"
        gt.student_t(4.0, slope * jxs + intercept,
                     jnp.exp(log_noise)) @ "ys"

    @tt.gen
    def torch_robust():
        slope = tt.normal(0.0, 2.0) @ "slope"
        intercept = tt.normal(0.0, 2.0) @ "intercept"
        log_noise = tt.normal(0.0, 1.0) @ "log_noise"
        tt.student_t(4.0, slope * txs + intercept,
                     torch.exp(log_noise)) @ "ys"

    return jax_robust, torch_robust, ys


def torch_kalman_logp(T=6, seed=0):
    """The port's counterpart of tests/test_hmc_fused.py::_kalman_logp:
    priors on (phi, log_q, log_r) and the exact Kalman marginal of a
    2-state model, float32."""
    from gen_tpu_torch.models import LGSSMParams, kalman_filter
    ys = torch.tensor(np.random.default_rng(seed).standard_normal((T, 1)),
                      dtype=torch.float32)
    I2 = torch.eye(2)

    def logp(x):
        phi, log_q, log_r = x[0], x[1], x[2]
        A = torch.tensor([[0.0, 1.0], [0.0, 0.0]]) + phi * I2
        Q = torch.exp(log_q) * I2
        C = torch.tensor([[1.0, 0.0]])
        R = torch.exp(log_r) * torch.eye(1)
        params = LGSSMParams(A, Q, C, R, torch.zeros(2), I2)
        return (kalman_filter(params, ys).log_ml
                - 0.5 * (phi ** 2 + log_q ** 2 + log_r ** 2))

    return logp
