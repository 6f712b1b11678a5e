"""Pareto-smoothed importance sampling (PSIS) and the k-hat diagnostic.

Counterpart: ``gen_tpu/inference/psis.py``. PSIS (Vehtari, Simpson,
Gelman, Yao & Gabry 2024) fits a generalized Pareto distribution (GPD) to
the largest importance ratios, replaces the tail weights by the expected
order statistics of the fit, and reports its shape k-hat: k < 0.5 means
finite-variance ratios, 0.5 <= k < 0.7 usable, k >= 0.7 not to be trusted.

Fixed shapes given the sample count, as in gen_tpu: one stable sort, a
tail of fixed length and the Zhang & Stephens (2009) profile-posterior GPD
fit as one batched reduction, with no host round trip. The tensors stay
on the weights' device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils import logsumexp


def gpd_fit(x):
    """Fit GPD(sigma, k) to exceedances ``x`` (1-D, sorted ascending,
    positive) by the Zhang & Stephens (2009) profile posterior with the
    weak prior regularization used by PSIS. Returns (k, sigma) in ``x``'s
    dtype.

    The fit runs in float64 whatever that dtype: its profile likelihood
    multiplies each mean's rounding by the tail length n, so float32
    reductions in two summation orders (the card's and the CPU's) gave
    k-hats 2e-5 apart (relative) on 131,072 AIS weights; in float64 they
    agree to float32's rounding. float64 input runs as in gen_tpu."""
    x = torch.as_tensor(x)
    dtype = x.dtype
    x = x.double()
    n = x.shape[0]
    prior_bs, prior_k = 3.0, 10.0
    m_est = 30 + int(float(n) ** 0.5)

    jj = torch.arange(1, m_est + 1, dtype=x.dtype, device=x.device)
    quart = x[int(n / 4 + 0.5) - 1]
    b = 1.0 - torch.sqrt(m_est / (jj - 0.5))
    b = b / (prior_bs * quart) + 1.0 / x[-1]

    k_b = torch.log1p(-b[:, None] * x[None, :]).mean(dim=1)     # (m,)
    log_lik = n * (torch.log(-b / k_b) - k_b - 1.0)
    w = torch.exp(log_lik - logsumexp(log_lik))
    b_post = torch.sum(b * w)
    k_post = torch.log1p(-b_post * x).mean()
    k_post = (n * k_post + prior_k * 0.5) / (n + prior_k)
    sigma = -k_post / b_post
    return k_post.to(dtype), sigma.to(dtype)


def _gpd_quantile(p, k, sigma):
    """Inverse CDF of GPD with location 0: sigma/k * (1 - (1-p)^k)
    (limit -sigma*log(1-p) as k -> 0)."""
    small = torch.abs(k) < 1e-12
    safe_k = torch.where(small, 1.0, k)
    q = sigma * torch.expm1(-safe_k * torch.log1p(-p)) / safe_k
    q0 = -sigma * torch.log1p(-p)
    return torch.where(small, q0, q)


class PSISResult(NamedTuple):
    log_weights: torch.Tensor  # smoothed, same normalization as the input
    khat: torch.Tensor         # GPD shape diagnostic
    tail_len: int              # number of smoothed tail weights


def psis(log_weights):
    """Pareto-smooth a vector of (unnormalized) log importance weights.

    Returns :class:`PSISResult`. The tail length follows the paper:
    M = min(S/5, 3*sqrt(S)). If the tail is degenerate (all equal, e.g.
    an exact proposal) the weights are returned unsmoothed with
    khat = -inf.
    """
    lw = torch.as_tensor(log_weights)
    s = lw.shape[0]
    m = int(min(0.2 * s, 3.0 * float(s) ** 0.5))
    if m < 5 or s < 16:
        return PSISResult(lw, torch.tensor(-math.inf, dtype=lw.dtype,
                                           device=lw.device), 0)

    lw_sorted, order = torch.sort(lw, stable=True)
    # stabilize: work relative to the max weight
    shift = lw_sorted[-1]
    tail = torch.exp(lw_sorted[-m:] - shift)         # ascending, in (0, 1]
    cutoff = torch.exp(lw_sorted[-m - 1] - shift)
    exceed = tail - cutoff                           # > 0 (up to ties)

    ok = exceed[-1] > 0                              # non-degenerate tail
    exceed_safe = torch.where(ok, torch.clamp(exceed, min=1e-30),
                              torch.ones_like(exceed))
    k, sigma = gpd_fit(exceed_safe)

    # expected order statistics of the fitted GPD, capped at the max ratio
    p = (torch.arange(1, m + 1, dtype=lw.dtype, device=lw.device) - 0.5) / m
    smoothed = torch.minimum(_gpd_quantile(p, k, sigma) + cutoff, tail[-1])
    new_tail = torch.log(torch.clamp(smoothed, min=1e-38)) + shift
    new_sorted = torch.where(ok, torch.cat([lw_sorted[:-m], new_tail]),
                             lw_sorted)

    # inverse permutation by a gather
    out = new_sorted[torch.argsort(order)]
    khat = torch.where(ok, k, -math.inf)
    return PSISResult(out, khat, m)


def psis_effective_sample_size(log_weights):
    """ESS of (possibly smoothed) log weights: 1 / sum(w_norm^2)."""
    lw = torch.as_tensor(log_weights)
    lnw = lw - logsumexp(lw)
    return torch.exp(-logsumexp(2.0 * lnw))
