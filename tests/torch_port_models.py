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
