"""Exact references for the main-path models, in numpy float64.

Counterparts: ``exact_posterior_moments`` in ``benchmarks/bench_verify.py``
(the headline regression model, by quadrature), ``schools_exact`` in
``benchmarks/bench_hard_targets.py`` (eight_schools, at any number of
schools) and ``_kalman_lml`` in ``tests/test_arena.py`` (the SMC slice's
linear-Gaussian state-space model, by the Kalman filter).

Regression: ``p(slope, intercept, log_noise | ys)`` factorizes as
``p(beta | ln, ys) p(ln | ys)``: the first factor is Gaussian in closed
form, the second is ``prior(ln) * N(ys; 0, s^2 I + X D X^T)`` with beta
marginalized, so the marginal means and sds are 1-D integrals over a
log_noise grid.
"""

from __future__ import annotations

import numpy as np


def exact_posterior_moments(X, ys, prior_beta_sd=2.0, prior_ln_sd=1.0,
                            grid=np.linspace(-3.0, 3.0, 4001)):
    """(mean_beta, sd_beta, mean_ln, sd_ln) of the regression posterior."""
    X = np.asarray(X, np.float64)
    ys = np.asarray(ys, np.float64)
    n, p = X.shape
    D = (prior_beta_sd ** 2) * np.eye(p)
    logw = np.empty(grid.shape)
    mus = np.empty((grid.size, p))
    sigs = np.empty((grid.size, p, p))
    for i, ln in enumerate(grid):
        s2 = np.exp(2.0 * ln)
        C = s2 * np.eye(n) + X @ D @ X.T
        _, logdet = np.linalg.slogdet(C)
        logw[i] = (-0.5 * logdet - 0.5 * ys @ np.linalg.solve(C, ys)
                   - 0.5 * (ln / prior_ln_sd) ** 2)
        S = np.linalg.inv(X.T @ X / s2 + np.linalg.inv(D))
        mus[i] = S @ (X.T @ ys) / s2
        sigs[i] = S
    w = np.exp(logw - logw.max())
    w /= w.sum()
    mean_beta = w @ mus
    e2 = w @ (np.stack([np.diag(s) for s in sigs]) + mus ** 2)
    sd_beta = np.sqrt(e2 - mean_beta ** 2)
    mean_ln = w @ grid
    sd_ln = np.sqrt(w @ grid ** 2 - mean_ln ** 2)
    return mean_beta, sd_beta, mean_ln, sd_ln


MU_SD, LTAU_SD = 10.0, 1.5     # eight_schools' priors on mu and log_tau


def schools_exact(ys, sigmas, mu_lo=-25.0, mu_hi=35.0, lt_lo=-7.0,
                  lt_hi=5.0):
    """Posterior moments of the non-centered eight_schools model
    (``mu ~ N(0, 10)``, ``log_tau ~ N(0, 1.5)``, ``theta_std ~ N(0, 1)``,
    ``ys ~ N(mu + exp(log_tau) theta_std, sigmas)``) for any number of
    schools: ``(mu, log_tau)`` by 2-D quadrature with ``theta_std``
    integrated out analytically, ``theta_std`` by its conditional-Gaussian
    mixture. Returns ``{("mu",): (mean, sd), ("log_tau",): (mean, sd),
    ("theta_std",): (means (K,), sds (K,))}``."""
    ys = np.asarray(ys, np.float64)
    sigmas = np.asarray(sigmas, np.float64)
    K = ys.shape[0]
    mu_g = np.linspace(mu_lo, mu_hi, 601)
    lt_g = np.linspace(lt_lo, lt_hi, 601)
    MU, LT = np.meshgrid(mu_g, lt_g, indexing="ij")
    tau2 = np.exp(2.0 * LT)
    logw = -0.5 * (MU / MU_SD) ** 2 - 0.5 * (LT / LTAU_SD) ** 2
    for y_i, s_i in zip(ys, sigmas):
        v = s_i ** 2 + tau2
        logw = logw - 0.5 * np.log(v) - 0.5 * (y_i - MU) ** 2 / v
    w = np.exp(logw - logw.max())
    w /= w.sum()
    out = {}
    for name, grid in ((("mu",), MU), (("log_tau",), LT)):
        m = (w * grid).sum()
        out[name] = (float(m), float(np.sqrt((w * grid ** 2).sum() - m ** 2)))
    tau = np.exp(LT)
    t_mean = np.empty(K)
    t_sd = np.empty(K)
    for i, (y_i, s_i) in enumerate(zip(ys, sigmas)):
        prec = 1.0 + tau2 / s_i ** 2
        cmean = (tau * (y_i - MU) / s_i ** 2) / prec
        m = (w * cmean).sum()
        e2 = (w * (1.0 / prec + cmean ** 2)).sum()
        t_mean[i], t_sd[i] = m, np.sqrt(e2 - m ** 2)
    out[("theta_std",)] = (t_mean, t_sd)
    return out


def kalman_filter(ys, A=0.8, Q=0.25, R=0.09):
    """Exact log marginal likelihood and filtered moments of the 1-D
    linear-Gaussian state-space model ``x_t ~ N(A x_{t-1}, Q)`` (from
    ``x_{-1} = 0``), ``y_t ~ N(x_t, R)``, with Q and R variances. Returns
    ``(log_ml, means (T,), variances (T,))`` of ``x_t | y_0..y_t``."""
    m, v, lml = 0.0, 0.0, 0.0
    means, variances = [], []
    for t, y in enumerate(np.asarray(ys, np.float64)):
        pm, pv = (A * m, A * A * v + Q) if t else (0.0, Q)
        S = pv + R
        lml += -0.5 * np.log(2 * np.pi * S) - 0.5 * (y - pm) ** 2 / S
        K = pv / S
        m, v = pm + K * (y - pm), (1 - K) * pv
        means.append(m)
        variances.append(v)
    return float(lml), np.asarray(means), np.asarray(variances)
