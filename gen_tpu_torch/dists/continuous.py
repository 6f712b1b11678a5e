"""Continuous distributions: ``normal``, ``normal_linear`` and ``gamma``.

Counterpart: ``gen_tpu/dists/continuous.py`` (``Normal``, ``NormalLinear``
and ``Gamma``; the other distributions wait for later slices). The
logpdfs are the same expressions in the same order. ``gamma`` draws by
inverting its cdf (``torch.special.gammainc``) in float64, exact in
distribution where gen_tpu runs ``jax.random.gamma``'s rejection loop,
which ``torch.func.vmap`` cannot run. ``normal_linear`` keeps
the Gram-matrix form: ``G = [X|v]^T [X|v]`` depends only on the data, which
is what lets the staging pass hoist it out of the fused kernel.
"""

from __future__ import annotations

import math

import torch

from .. import random
from .distribution import Distribution, _f

_HALF_LOG_2PI = 0.9189385332046727  # 0.5*log(2*pi)


class Normal(Distribution):
    """normal(mu, std); logpdf sums elementwise over array-valued draws."""

    def sample(self, key, mu, std):
        mu, std = _f(mu), _f(std)
        shape = torch.broadcast_shapes(mu.shape, std.shape)
        z = random.normal(key, shape, torch.result_type(mu, std))
        return mu + std * z

    def logpdf(self, v, mu, std):
        v, mu, std = _f(v), _f(mu), _f(std)
        z = (v - mu) / std
        return torch.sum(-0.5 * z * z - torch.log(std) - _HALF_LOG_2PI)


class NormalLinear(Distribution):
    """normal_linear(X, beta, sigma): n iid normal observations with mean
    ``X @ beta`` and shared scale ``sigma``. The residual sum of squares is
    ``u^T G u`` with ``u = [beta; -1]`` and the data-only Gram matrix
    ``G = [X|v]^T [X|v]``. In float32 keep the data at O(1) scale: the Gram
    form subtracts large squares."""

    def sample(self, key, X, beta_, sigma):
        X, beta_, sigma = _f(X), _f(beta_), _f(sigma)
        mean = X @ beta_
        return mean + sigma * random.normal(key, mean.shape, mean.dtype)

    def logpdf(self, v, X, beta_, sigma):
        v, X, beta_, sigma = _f(v), _f(X), _f(beta_), _f(sigma)
        A = torch.cat([X, v[:, None]], dim=1)
        G = A.T @ A                      # data-only: hoisted by staging
        u = torch.cat([beta_, -torch.ones((1,), dtype=beta_.dtype,
                                          device=beta_.device)])
        rss = u @ (G @ u)
        n = X.shape[0]
        return -0.5 * rss / (sigma * sigma) - n * (torch.log(sigma)
                                                   + _HALF_LOG_2PI)


class Gamma(Distribution):
    """gamma(shape, scale), the shape/scale parameterization."""

    def sample(self, key, shape, scale):
        from .discrete import gamma_icdf
        shape, scale = _f(shape), _f(scale)
        size = tuple(torch.broadcast_shapes(shape.shape, scale.shape))
        g = gamma_icdf(shape, random.uniform(key, size, torch.float64))
        return g.to(torch.result_type(shape, scale)) * scale

    def logpdf(self, v, shape, scale):
        v, shape, scale = _f(v), _f(shape), _f(scale)
        inside = v > 0
        v_safe = torch.where(inside, v, 1.0)
        lp = ((shape - 1) * torch.log(v_safe) - v_safe / scale
              - shape * torch.log(scale) - torch.lgamma(shape))
        return torch.sum(torch.where(inside, lp, -math.inf))


normal = Normal()
normal_linear = NormalLinear()
gamma = Gamma()
