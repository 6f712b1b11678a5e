"""Discrete distributions.

Counterpart: ``gen_tpu/dists/discrete.py``: the same ten distributions,
with the same parameterizations (``categorical`` and ``uniform_discrete``
are 0-based) and the same logpdf expressions, which sum over elements.

Samplers:

- ``bernoulli``, ``categorical``, ``labeled_categorical``,
  ``uniform_discrete``, ``geometric`` and ``dirac`` are gen_tpu's
  constructions on :mod:`gen_tpu_torch.random`'s bits, so under the same
  key they draw what gen_tpu draws.
- ``poisson``, ``binom``, ``neg_binom`` and ``multinomial`` use
  ``jax.random``'s rejection samplers in gen_tpu, whose data-dependent
  loops ``torch.func.vmap`` cannot run. The port draws them by other
  constructions that are exact in distribution (not equal to gen_tpu's
  draws) and tests them by chi-square: ``poisson`` inverts its cdf
  (``torch.special.gammaincc``) by bisection in float64; ``neg_binom`` is
  gen_tpu's gamma-Poisson mixture, its gamma drawn by inverting
  ``torch.special.gammainc`` (:func:`gamma_icdf`); ``binom`` counts ``n``
  Bernoulli draws and ``multinomial`` counts ``n`` categorical draws, so
  their trial counts must be concrete (a Python int or a plain tensor),
  as ``binom``'s support already needs.

Integer draws take JAX's default integer (:func:`gen_tpu_torch.utils.
default_int`: int64 when torch's default float is float64, JAX's x64
mode, else int32); ``geometric`` and ``binom`` return int32 and
``multinomial`` float counts, as gen_tpu's.
"""

from __future__ import annotations

import math

import torch

from .. import random
from ..utils import default_int
from .distribution import Distribution, _f, concrete_int

_BISECT = 64          # bisection steps over integers < 2**63


def _neg_inf_where(inside, lp):
    return torch.sum(torch.where(inside, lp, -math.inf))


def _u64(key, shape):
    return random.uniform(key, shape, torch.float64)


def gamma_icdf(alpha: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The standard gamma quantile at ``u`` (float64): bisection of
    ``torch.special.gammainc`` on log g over [-800, log(alpha + 50
    sqrt(alpha) + 50)], 72 halvings (past float64 resolution). ``alpha``
    goes to ``u``'s device: a Python-float shape is a CPU tensor, and
    ``gammainc`` takes no CPU scalar beside a CUDA tensor."""
    alpha = alpha.to(device=u.device, dtype=torch.float64)
    lo = torch.full_like(alpha * u, -800.0)
    hi = torch.log(alpha + 50.0 * torch.sqrt(alpha) + 50.0) + 0.0 * lo
    for _ in range(72):
        mid = 0.5 * (lo + hi)
        up = torch.special.gammainc(alpha, torch.exp(mid)) >= u
        hi = torch.where(up, mid, hi)
        lo = torch.where(up, lo, mid)
    return torch.exp(hi)


def _poisson_icdf(lam: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The smallest k with P(X <= k) = gammaincc(k + 1, lam) >= u, by
    bisection over [-1, lam + 50 sqrt(lam) + 50] (float64), on ``u``'s
    device as :func:`gamma_icdf`."""
    lam = lam.to(device=u.device, dtype=torch.float64)
    hi = torch.floor(lam + 50.0 * torch.sqrt(lam) + 50.0) + 0.0 * u
    lo = torch.full_like(hi, -1.0)
    for _ in range(_BISECT):
        mid = torch.floor(0.5 * (lo + hi))
        cdf = torch.where(mid < 0, 0.0, torch.special.gammaincc(
            torch.clamp(mid, min=0.0) + 1.0, lam))
        up = cdf >= u
        hi = torch.where(up, mid, hi)
        lo = torch.where(up, lo, mid)
    return hi


def _take(probs, v):
    """``probs[v]`` for 1-D ``probs``, with the index flattened to 1-D: a
    0-dim index tensor takes torch's integer-index path, which a batched
    tensor under ``torch.func.grad`` cannot."""
    return probs[v.reshape(-1)].reshape(v.shape)


def _trials(n, what):
    """A concrete trial count (tensor) and its maximum."""
    if isinstance(n, torch.Tensor):
        n_max = concrete_int(torch.max(n), what)
    else:
        n_max = int(n)
    return torch.as_tensor(n), n_max


class Bernoulli(Distribution):
    """bernoulli(p) -> bool."""

    is_discrete = True
    has_output_grad = False
    arg_grads = (True,)

    def sample(self, key, p):
        p = _f(p)
        return random.bernoulli(key, p, tuple(p.shape), p.dtype)

    def logpdf(self, v, p):
        p = _f(p)
        vf = torch.as_tensor(v).to(p.dtype)
        return torch.sum(torch.special.xlogy(vf, p)
                         + torch.special.xlog1py(1.0 - vf, -p))

    def enumerate_support(self, p):
        return torch.tensor([False, True])


class Categorical(Distribution):
    """categorical(probs) -> int index in [0, n) (0-based)."""

    is_discrete = True
    has_output_grad = False
    arg_grads = (True,)

    def sample(self, key, probs):
        return random.categorical(key, torch.log(_f(probs))).to(
            default_int())

    def logpdf(self, v, probs):
        probs = _f(probs)
        v = torch.as_tensor(v).long()
        if probs.dim() == 1:
            return torch.sum(torch.log(_take(probs, v)))
        # batched: v (...,), probs (..., n)
        lp = torch.log(torch.take_along_dim(probs, v[..., None],
                                            dim=-1))[..., 0]
        return torch.sum(lp)

    def enumerate_support(self, probs):
        # only the (static) trailing length is read
        return torch.arange(probs.shape[-1], dtype=torch.int32)


class LabeledCategorical(Distribution):
    """categorical over explicit labels (the @dist DSL's relabeling)."""

    is_discrete = True
    has_output_grad = False
    arg_grads = (True,)

    def sample(self, key, probs):
        return random.categorical(key, torch.log(_f(probs))).to(
            default_int())

    def logpdf(self, v, probs):
        probs = _f(probs)
        return torch.sum(torch.log(_take(probs, torch.as_tensor(v).long())))

    def enumerate_support(self, probs):
        return torch.arange(probs.shape[-1], dtype=torch.int32)


class UniformDiscrete(Distribution):
    """uniform_discrete(low, high) -> int in [low, high] inclusive."""

    is_discrete = True
    has_output_grad = False
    arg_grads = (False, False)

    def sample(self, key, low, high):
        return random.randint(key, (), int(low), int(high) + 1,
                              dtype=default_int())

    def logpdf(self, v, low, high):
        v = torch.as_tensor(v)
        n = torch.as_tensor(high - low + 1,
                            dtype=torch.get_default_dtype())
        inside = (v >= low) & (v <= high)
        return torch.sum(torch.where(inside, -torch.log(n), -math.inf))

    def enumerate_support(self, low, high):
        lo = concrete_int(low, "uniform_discrete support bound")
        hi = concrete_int(high, "uniform_discrete support bound")
        return torch.arange(lo, hi + 1, dtype=torch.int32)


class Poisson(Distribution):
    """poisson(lam). Sampled by cdf inversion (exact in distribution)."""

    is_discrete = True
    has_output_grad = False
    arg_grads = (True,)

    def sample(self, key, lam):
        lam = _f(lam)
        return _poisson_icdf(lam, _u64(key, tuple(lam.shape))).to(
            default_int())

    def logpdf(self, v, lam):
        lam = _f(lam)
        vf = torch.as_tensor(v).to(lam.dtype)
        lp = torch.special.xlogy(vf, lam) - lam - torch.lgamma(vf + 1.0)
        return _neg_inf_where(vf >= 0, lp)


class Binomial(Distribution):
    """binom(n, p). Sampled as the count of ``n`` Bernoulli draws (exact;
    ``n`` concrete)."""

    is_discrete = True
    has_output_grad = False
    arg_grads = (False, True)

    def sample(self, key, n, p):
        p = _f(p)
        n, n_max = _trials(n, "binom trial count")
        shape = torch.broadcast_shapes(n.shape, p.shape)
        u = _u64(key, shape + (n_max,))
        live = torch.arange(n_max, device=u.device) < n.to(u.device)[..., None]
        hit = (u < p.to(torch.float64)[..., None]) & live
        return torch.sum(hit, dim=-1).to(torch.int32)

    def logpdf(self, v, n, p):
        p = _f(p)
        vf = torch.as_tensor(v).to(p.dtype)
        nf = torch.as_tensor(n).to(p.dtype)
        inside = (vf >= 0) & (vf <= nf)
        logcomb = (torch.lgamma(nf + 1) - torch.lgamma(vf + 1)
                   - torch.lgamma(nf - vf + 1))
        lp = (logcomb + torch.special.xlogy(vf, p)
              + torch.special.xlog1py(nf - vf, -p))
        return _neg_inf_where(inside, lp)

    def enumerate_support(self, n, p):
        return torch.arange(concrete_int(n, "binom trial count") + 1,
                            dtype=torch.int32)


class Geometric(Distribution):
    """geometric(p): failures before the first success, support {0, 1,
    ...}."""

    is_discrete = True
    has_output_grad = False
    arg_grads = (True,)

    def sample(self, key, p):
        p = _f(p)
        u = random.uniform(key, tuple(p.shape), torch.get_default_dtype())
        return torch.floor(torch.log1p(-u) / torch.log1p(-p)).to(
            torch.int32)

    def logpdf(self, v, p):
        p = _f(p)
        vf = torch.as_tensor(v).to(p.dtype)
        lp = torch.log(p) + torch.special.xlog1py(vf, -p)
        return _neg_inf_where(vf >= 0, lp)


class NegativeBinomial(Distribution):
    """neg_binom(r, p): failures before the r-th success. Sampled as
    gen_tpu's gamma-Poisson mixture, lam ~ Gamma(r, (1 - p) / p), x ~
    Poisson(lam), each by cdf inversion (exact in distribution)."""

    is_discrete = True
    has_output_grad = False
    arg_grads = (True, True)

    def sample(self, key, r, p):
        r, p = _f(r), _f(p)
        shape = tuple(torch.broadcast_shapes(r.shape, p.shape))
        kg, kp = random.split(key)
        lam = (gamma_icdf(r.to(torch.float64), _u64(kg, shape))
               * (1.0 - p.to(torch.float64)) / p.to(torch.float64))
        return _poisson_icdf(lam, _u64(kp, shape)).to(default_int())

    def logpdf(self, v, r, p):
        r, p = _f(r), _f(p)
        vf = torch.as_tensor(v).to(p.dtype)
        lp = (torch.lgamma(vf + r) - torch.lgamma(r) - torch.lgamma(vf + 1)
              + r * torch.log(p) + torch.special.xlog1py(vf, -p))
        return _neg_inf_where(vf >= 0, lp)


class Multinomial(Distribution):
    """multinomial(n, probs) -> (k,) counts summing to n. Sampled as the
    counts of ``n`` categorical draws (exact; ``n`` concrete)."""

    is_discrete = True
    has_output_grad = False
    arg_grads = (False, True)

    def sample(self, key, n, probs):
        probs = _f(probs)
        n_max = concrete_int(n, "multinomial trial count")
        k = probs.shape[-1]
        draws = random.categorical(key, torch.log(probs),
                                   (n_max,) + tuple(probs.shape[:-1]))
        cats = torch.arange(k, device=draws.device)
        # float counts, as jax.random.multinomial returns
        return torch.sum(draws[..., None] == cats, dim=0).to(
            torch.get_default_dtype())

    def logpdf(self, v, n, probs):
        probs = _f(probs)
        vf = torch.as_tensor(v).to(probs.dtype)
        nf = torch.as_tensor(n).to(probs.dtype)
        lp = (torch.lgamma(nf + 1.0)
              - torch.sum(torch.lgamma(vf + 1.0), dim=-1)
              + torch.sum(torch.special.xlogy(vf, probs), dim=-1))
        ok = torch.sum(vf, dim=-1) == nf
        return _neg_inf_where(ok, lp)


class Dirac(Distribution):
    """dirac(v) -> v: a point mass. logpdf is 0 where the value matches
    (within 1e-6 relative for floats, so that a float32 round trip is
    safe) and -inf elsewhere."""

    is_discrete = True
    has_output_grad = False
    arg_grads = (False,)

    def sample(self, key, v):
        return torch.as_tensor(v)

    def logpdf(self, v, expected):
        v = torch.as_tensor(v)
        expected = torch.as_tensor(expected).to(v.dtype)
        if torch.is_floating_point(v):
            match = torch.abs(v - expected) <= 1e-6 * (1.0
                                                       + torch.abs(expected))
        else:
            match = v == expected
        return torch.sum(torch.where(match, 0.0, -math.inf))


bernoulli = Bernoulli()
dirac = Dirac()
multinomial = Multinomial()
categorical = Categorical()
labeled_categorical = LabeledCategorical()
uniform_discrete = UniformDiscrete()
poisson = Poisson()
binom = Binomial()
geometric = Geometric()
neg_binom = NegativeBinomial()
