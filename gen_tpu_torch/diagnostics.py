"""MCMC convergence diagnostics: rank-normalized split-R-hat, bulk/tail
effective sample size and Monte-Carlo standard error.

Counterpart: ``gen_tpu/diagnostics.py``, the same definitions (Vehtari,
Gelman, Simpson, Carpenter & Bürkner 2021) on ``(draws, chains)`` tensors,
including the tail-safe normal scores that keep R-hat finite past 2**23
pooled draws. Where PyTorch forced a difference: ``torch.median`` returns
the lower middle value, so the median is taken as the mean of the two
middle order statistics, as ``jnp.median`` does; the running minimum of the
Geyer pair sums is ``torch.cummin``.

Also here: :func:`autocorr_ess`, the per-chain autocorrelation ESS that
``bench.py`` reports (a benchmark helper in gen_tpu), computed with
``torch.fft`` so that a long history is reduced where it lies, on the card.
"""

from __future__ import annotations

import math

import torch


def _split_chains(x):
    """(N, M) -> (N//2, 2M): split each chain in half (drop odd draw)."""
    n = (x.shape[0] // 2) * 2
    x = x[:n]
    half = n // 2
    return torch.cat([x[:half], x[half:]], dim=1)


def _median(x):
    srt = torch.sort(x.reshape(-1)).values
    s = srt.shape[0]
    return 0.5 * (srt[(s - 1) // 2] + srt[s // 2])


def _rank_normalize(x):
    """Pooled average-rank normal scores (Blom), shape-preserving; ties get
    average ranks. The upper half uses the symmetric form with an exact
    integer numerator, so the top ranks never round to p == 1."""
    shape = x.shape
    flat = x.reshape(-1).contiguous()
    s = flat.shape[0]
    srt = torch.sort(flat).values
    lo = torch.searchsorted(srt, flat, right=False)
    hi = torch.searchsorted(srt, flat, right=True)
    m2 = lo + hi + 1                     # 2 * rank (exact int)
    num_lo = m2.to(torch.float32) / 2.0 - 0.375
    num_hi = (2 * s - m2).to(torch.float32) / 2.0 + 0.625
    den = torch.tensor(s + 0.25, dtype=torch.float32, device=x.device)
    z = torch.where(m2 <= s + 1, torch.special.ndtri(num_lo / den),
                    -torch.special.ndtri(num_hi / den))
    return z.reshape(shape).to(torch.promote_types(x.dtype, torch.float32))


def _autocov(x):
    """Per-chain FFT autocovariance; x: (N, M) -> (N, M)."""
    n = x.shape[0]
    xc = x - x.mean(dim=0, keepdim=True)
    f = torch.fft.rfft(xc, n=2 * n, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=2 * n, dim=0)[:n]
    return acov / n


def _split_rhat(x):
    z = _split_chains(x)
    n, m = z.shape
    chain_means = z.mean(dim=0)
    b = n * torch.var(chain_means, correction=1)
    w = torch.mean(torch.var(z, dim=0, correction=1))
    var_plus = (n - 1) / n * w + b / n
    return torch.sqrt(var_plus / w)


def rhat(x):
    """Rank-normalized split-R-hat (max of bulk and folded variants) of
    ``(draws, chains)`` draws. Values below 1.01 indicate convergence."""
    x = torch.as_tensor(x)
    bulk = _split_rhat(_rank_normalize(x))
    folded = _split_rhat(_rank_normalize(torch.abs(x - _median(x))))
    return torch.maximum(bulk, folded)


def _ess_from_draws(z):
    """Multi-chain ESS of (already transformed) draws z: (N, M)."""
    z = _split_chains(z)
    n, m = z.shape
    acov = _autocov(z)
    chain_var = acov[0] * n / (n - 1.0)
    w = torch.mean(chain_var)
    b_over_n = torch.var(z.mean(dim=0), correction=1)
    var_plus = (n - 1) / n * w + b_over_n
    rho = 1.0 - (w - acov.mean(dim=1)) / var_plus
    # Geyer pair sums, initial-positive truncation, initial-monotone clamp
    n_pairs = n // 2
    g = rho[:2 * n_pairs].reshape(n_pairs, 2).sum(dim=1)
    g = torch.where(torch.cumsum((g < 0).to(torch.int64), 0) > 0,
                    torch.zeros_like(g), g)
    g = torch.cummin(g, dim=0).values
    g = torch.clamp(g, min=0.0)
    tau = torch.clamp(-1.0 + 2.0 * torch.sum(g), min=1e-3)
    ess = n * m / tau
    return torch.clamp(ess, max=n * m * math.log10(n * m))


def ess_bulk(x):
    """Rank-normalized bulk effective sample size; x: (draws, chains)."""
    return _ess_from_draws(_rank_normalize(torch.as_tensor(x)))


def _quantiles(x, qs):
    """Linear-interpolation quantiles of all elements, as ``jnp.quantile``
    and ``torch.quantile`` compute them, by one sort (``torch.quantile``
    refuses inputs above 2**24 elements, fewer than one gate's draws)."""
    srt = torch.sort(x.reshape(-1)).values
    out = []
    for q in qs:
        pos = q * (srt.shape[0] - 1)
        lo = math.floor(pos)
        hi = min(lo + 1, srt.shape[0] - 1)
        out.append(srt[lo] + (srt[hi] - srt[lo]) * (pos - lo))
    return out


def ess_tail(x):
    """Tail ESS: min ESS of the 5% and 95% exceedance indicators."""
    x = torch.as_tensor(x)
    q = _quantiles(x, (0.05, 0.95))
    e05 = _ess_from_draws(_rank_normalize((x <= q[0]).to(torch.float32)))
    e95 = _ess_from_draws(_rank_normalize((x <= q[1]).to(torch.float32)))
    return torch.minimum(e05, e95)


def ess_mean(x):
    """Plain (non-rank-normalized) ESS for the mean estimator."""
    return _ess_from_draws(torch.as_tensor(x))


def mcse_mean(x):
    """Monte-Carlo standard error of the posterior-mean estimate."""
    x = torch.as_tensor(x)
    return x.std(correction=1) / torch.sqrt(ess_mean(x))


def summarize(samples: dict):
    """Per-entry diagnostics for a dict of ``(draws, chains[, ...])``
    tensors; trailing event dimensions are reported per coordinate.
    Returns ``{name: {"mean", "sd", "rhat", "ess_bulk", "ess_tail",
    "mcse_mean"}}``."""
    out = {}
    for name, leaf in samples.items():
        leaf = torch.as_tensor(leaf)
        if leaf.ndim < 2:
            raise ValueError(f"{name} must be (draws, chains[, ...])")
        ev_shape = leaf.shape[2:]
        cols = leaf.reshape(leaf.shape[0], leaf.shape[1], -1)
        per = [cols[:, :, j] for j in range(cols.shape[2])]
        stats = {
            "mean": cols.mean(dim=(0, 1)),
            "sd": cols.reshape(-1, cols.shape[2]).std(dim=0, correction=1),
            "rhat": torch.stack([rhat(c) for c in per]),
            "ess_bulk": torch.stack([ess_bulk(c) for c in per]),
            "ess_tail": torch.stack([ess_tail(c) for c in per]),
            "mcse_mean": torch.stack([mcse_mean(c) for c in per]),
        }
        out[name] = {k: v.reshape(ev_shape) if ev_shape else v[0]
                     for k, v in stats.items()}
    return out


def autocorr_ess(x, block: int = 65536) -> float:
    """ESS summed over chains of a ``(steps, chains)`` history: per-chain
    FFT autocovariance, Geyer's initial positive sequence of pair sums,
    ``n / (1 + 2 sum)``, and 1 for a chain with no variance. ``bench.py``'s
    ``autocorr_ess``, in float64, blocked over chains."""
    x = torch.as_tensor(x)
    if x.shape[1] > block:
        return float(sum(autocorr_ess(x[:, i:i + block])
                         for i in range(0, x.shape[1], block)))
    x = x.to(torch.float64)
    n, m = x.shape
    x = x - x.mean(dim=0, keepdim=True)
    f = torch.fft.rfft(x, n=2 * n, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=2 * n, dim=0)[:n] / n
    var0 = acov[0]
    ok = torch.isfinite(var0) & (var0 > 0)
    rho = acov / torch.where(ok, var0, 1.0)[None, :]
    n_pairs = (n - 1) // 2
    pairs = rho[1:1 + 2 * n_pairs].reshape(n_pairs, 2, m).sum(dim=1)
    stopped = torch.cumsum((pairs < 0).to(torch.int64), dim=0) > 0
    s = torch.where(stopped, 0.0, pairs).sum(dim=0)
    ess = torch.where(ok, n / (1.0 + 2.0 * s), 1.0)
    return float(ess.sum())
