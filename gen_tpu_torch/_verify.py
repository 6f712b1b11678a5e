"""Exact references for the main-path models, in float64.

Counterparts: ``exact_posterior_moments`` in ``benchmarks/bench_verify.py``
(the headline regression model, by quadrature), ``schools_exact`` in
``benchmarks/bench_hard_targets.py`` (eight_schools, at any number of
schools), ``_kalman_lml`` in ``tests/test_arena.py`` (the SMC slice's
linear-Gaussian state-space model, by the Kalman filter),
``quadrature_reference`` in ``benchmarks/bench_stream.py`` (the robust-t
regression, by 3-D quadrature; :func:`robust_t_quadrature`) and
``quadrature_exact`` in ``benchmarks/bench_statespace_fused.py`` (the
collapsed AR(1)+noise model; :func:`ar1_quadrature`). The last two run in
torch float64 on any device: at a million data points the quadrature is
~1e11 density evaluations.

Regression: ``p(slope, intercept, log_noise | ys)`` factorizes as
``p(beta | ln, ys) p(ln | ys)``: the first factor is Gaussian in closed
form, the second is ``prior(ln) * N(ys; 0, s^2 I + X D X^T)`` with beta
marginalized, so the marginal means and sds are 1-D integrals over a
log_noise grid.
"""

from __future__ import annotations

import math

import numpy as np
import torch


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


def robust_t_logpost(th, xs, ys, nu=4.0):
    """Log posterior (up to a constant) of ``benchmarks/bench_stream.py``'s
    robust regression, ``slope, intercept ~ N(0, 2)``, ``log_noise ~ N(0,
    1)``, ``ys ~ student_t(nu, slope xs + intercept, exp(log_noise))``, at
    ``th (..., 3) = (slope, intercept, log_noise)``."""
    sl, it, ln = th[..., 0:1], th[..., 1:2], th[..., 2:3]
    r = (ys - (sl * xs + it)) / torch.exp(ln)
    like = torch.sum(-0.5 * (nu + 1.0) * torch.log1p(r * r / nu), dim=-1)
    return (like - ys.shape[-1] * ln[..., 0] - sl[..., 0] ** 2 / 8.0
            - it[..., 0] ** 2 / 8.0 - ln[..., 0] ** 2 / 2.0)


def robust_t_quadrature(xs, ys, n_grid=48, span=7.0, device=None,
                        chunk_bytes=1 << 29):
    """Posterior means and sds of the robust-t regression by 3-D grid
    quadrature in float64, ``bench_stream.py::quadrature_reference``'s
    scheme: an ``n_grid``-point grid per axis over ``+- span`` Laplace sds
    around the mode (found here by Newton's method), the data sum in
    chunks of grid nodes. Returns ``{name: (mean, sd)}`` for ``slope``,
    ``intercept`` and ``log_noise``."""
    x = torch.as_tensor(np.asarray(xs), dtype=torch.float64, device=device)
    y = torch.as_tensor(np.asarray(ys), dtype=torch.float64, device=device)
    A = torch.stack([x, torch.ones_like(x)], dim=1)
    beta = torch.linalg.lstsq(A, y[:, None]).solution[:, 0]
    th = torch.cat([beta, torch.log(torch.std(y - A @ beta))[None]])

    def f(t):
        return robust_t_logpost(t, x, y)

    for _ in range(100):
        g = torch.func.grad(f)(th)
        H = torch.func.hessian(f)(th)
        step = torch.linalg.solve(H, g)
        th = th - step
        if float(step.abs().max()) < 1e-12:
            break
    sd = torch.sqrt(torch.diagonal(torch.linalg.inv(-H)))
    axes = [torch.linspace(float(th[i] - span * sd[i]),
                           float(th[i] + span * sd[i]), n_grid,
                           dtype=torch.float64, device=device)
            for i in range(3)]
    G = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    per = max(1, chunk_bytes // (8 * x.numel()))
    lp = torch.cat([f(G[i:i + per]) for i in range(0, G.shape[0], per)])
    w = torch.exp(lp - lp.max())
    w = w / w.sum()
    edge = w[torch.any((G < th - (span - 0.5) * sd)
                       | (G > th + (span - 0.5) * sd), dim=1)].sum()
    if float(edge) >= 1e-6:
        raise AssertionError(f"quadrature grid too small (edge mass "
                             f"{float(edge):g})")
    mean = w @ G
    var = w @ (G * G) - mean * mean
    return {name: (float(mean[i]), float(torch.sqrt(var[i])))
            for i, name in enumerate(("slope", "intercept", "log_noise"))}


def ar1_log_ml(phi, log_q, log_r, ys, p0=2.0):
    """Exact Kalman log marginal likelihood of the collapsed AR(1)+noise
    model (``lgssm`` with ``A = phi``, ``Q = exp(log_q)``, ``C = 1``, ``R =
    exp(log_r)``, ``mu0 = 0``, ``P0 = p0``), elementwise over the
    parameter tensors."""
    q, r = torch.exp(log_q), torch.exp(log_r)
    m = torch.zeros_like(phi)
    P = torch.full_like(phi, p0)
    lml = torch.zeros_like(phi)
    for t, yt in enumerate(np.asarray(ys, np.float64).reshape(-1)):
        if t:
            m, P = phi * m, phi * phi * P + q
        S = P + r
        v = yt - m
        lml = lml - 0.5 * (torch.log(2.0 * math.pi * S) + v * v / S)
        K = P / S
        m, P = m + K * v, (1.0 - K) * P
    return lml


def ar1_quadrature(ys, n_grid=121, p0=2.0, device=None):
    """Posterior means and sds of ``benchmarks/bench_statespace_fused.py``'s
    collapsed AR(1)+noise model (``phi ~ N(0, 1)``, ``log_q, log_r ~
    N(-1, 1)``) by dense 3-D quadrature on its grid (``phi`` in [-2, 2],
    ``log_q`` and ``log_r`` in [-7, 2.5]), in float64. Returns ``{name:
    (mean, sd)}``."""
    grids = [torch.linspace(lo, hi, n_grid, dtype=torch.float64,
                            device=device)
             for lo, hi in ((-2.0, 2.0), (-7.0, 2.5), (-7.0, 2.5))]
    P, LQ, LR = torch.meshgrid(*grids, indexing="ij")
    lp = (ar1_log_ml(P, LQ, LR, ys, p0) - 0.5 * P ** 2
          - 0.5 * (LQ + 1.0) ** 2 - 0.5 * (LR + 1.0) ** 2)
    w = torch.exp(lp - lp.max())
    edge = max(float(w[0].max()), float(w[-1].max()),
               float(w[:, 0].max()), float(w[:, -1].max()),
               float(w[:, :, 0].max()), float(w[:, :, -1].max()))
    if edge >= 1e-6:
        raise AssertionError(f"quadrature grid clips the posterior: {edge}")
    w = w / w.sum()
    out = {}
    for name, grid in (("phi", P), ("log_q", LQ), ("log_r", LR)):
        m = float((w * grid).sum())
        out[name] = (m, float(torch.sqrt((w * grid * grid).sum() - m * m)))
    return out
