"""Continuous distributions.

Counterpart: ``gen_tpu/dists/continuous.py``, all of it: ``normal``,
``broadcasted_normal``, ``normal_linear``, ``mvnormal``, ``uniform``
(``uniform_continuous``), ``beta``, ``beta_uniform``, ``gamma``,
``inv_gamma``, ``exponential``, ``cauchy``, ``laplace``,
``piecewise_uniform``, ``student_t``, ``dirichlet`` and
``piecewise_poisson_process``. The logpdfs are the same expressions in the
same order.

Samplers: ``normal``, ``uniform``, ``exponential``, ``cauchy`` and
``laplace`` are ``jax.random``'s constructions on
:mod:`gen_tpu_torch.random`'s bits. Where gen_tpu runs
``jax.random.gamma``'s rejection loop (``gamma``, ``inv_gamma``, ``beta``,
``student_t``), which ``torch.func.vmap`` cannot run, the port draws the
gamma variates by inverting their cdf (``torch.special.gammainc``) in
float64: exact in distribution, not equal to gen_tpu's draws. ``beta`` is
``G1 / (G1 + G2)``, ``student_t`` is ``Z / sqrt(2 G / nu)`` with
``G ~ gamma(nu / 2)`` and ``dirichlet`` normalizes one gamma a component
(gen_tpu normalizes log-gammas by a softmax). ``beta_uniform`` takes
gen_tpu's three keys: its coin and its uniform are gen_tpu's draws, its
beta the port's. ``piecewise_uniform`` draws what gen_tpu draws;
``piecewise_poisson_process`` places its events where gen_tpu does, but
counts them by the port's Poisson (cdf inversion). ``mvnormal`` draws
:func:`gen_tpu_torch.random.multivariate_normal`'s ``svd`` construction,
``mu + (U sqrt(s)) z``, whose factor's signs may differ from XLA's SVD.

``normal_linear`` keeps the Gram-matrix form: ``G = [X|v]^T [X|v]``
depends only on the data, which is what lets the staging pass hoist it
out of the fused kernel.
"""

from __future__ import annotations

import math

import torch

from .. import random
from .distribution import Distribution, _f, logsumexp2

_HALF_LOG_2PI = 0.9189385332046727  # 0.5*log(2*pi)


class Normal(Distribution):
    """normal(mu, std); logpdf sums elementwise over array-valued draws."""

    arg_grads = (True, True)

    def sample(self, key, mu, std):
        mu, std = _f(mu), _f(std)
        shape = torch.broadcast_shapes(mu.shape, std.shape)
        z = random.normal(key, shape, torch.result_type(mu, std))
        return mu + std * z

    def logpdf(self, v, mu, std):
        v, mu, std = _f(v), _f(mu), _f(std)
        z = (v - mu) / std
        return torch.sum(-0.5 * z * z - torch.log(std) - _HALF_LOG_2PI)


class BroadcastedNormal(Normal):
    """Alias of :class:`Normal` (gen_tpu's ``broadcasted_normal``)."""


class MvNormal(Distribution):
    """mvnormal(mu, cov): the logpdf by Cholesky and ``cho_solve``."""

    arg_grads = (True, True)

    def sample(self, key, mu, cov):
        return random.multivariate_normal(key, _f(mu), _f(cov))

    def logpdf(self, v, mu, cov):
        v, mu, cov = _f(v), _f(mu), _f(cov)
        d = v - mu
        chol = torch.linalg.cholesky(cov)
        alpha = torch.cholesky_solve(d[..., None], chol)[..., 0]
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
        k = mu.shape[-1]
        return -0.5 * (torch.dot(d, alpha) + logdet + k * 2.0 * _HALF_LOG_2PI)


class UniformContinuous(Distribution):
    """uniform(low, high)."""

    arg_grads = (True, True)

    def sample(self, key, low, high):
        low, high = _f(low), _f(high)
        shape = torch.broadcast_shapes(low.shape, high.shape)
        u = random.uniform(key, shape, torch.result_type(low, high))
        return low + u * (high - low)

    def logpdf(self, v, low, high):
        v, low, high = _f(v), _f(low), _f(high)
        inside = (v >= low) & (v <= high)
        lp = -torch.log(high - low)
        return torch.sum(torch.where(inside, lp, -math.inf))

    def logpdf_grad(self, v, low, high):
        # analytic, as gen_tpu: d/dv = 0 in the support
        v, low, high = _f(v), _f(low), _f(high)
        inv = 1.0 / (high - low)
        return (torch.zeros_like(v), torch.sum(inv.expand(v.shape)),
                -torch.sum(inv.expand(v.shape)))


def _std_gamma(key, alpha, shape, dtype):
    from .discrete import gamma_icdf
    alpha = torch.as_tensor(alpha, dtype=torch.float64, device=key.device)
    u = random.uniform(key, shape, torch.float64)
    return gamma_icdf(alpha.expand(shape), u).to(dtype)


class Beta(Distribution):
    """beta(alpha, beta); draws ``G1 / (G1 + G2)`` from two gammas."""

    arg_grads = (True, True)

    def sample(self, key, alpha, beta):
        alpha, beta = _f(alpha), _f(beta)
        shape = tuple(torch.broadcast_shapes(alpha.shape, beta.shape))
        dt = torch.result_type(alpha, beta)
        ka, kb = random.split(key)
        ga = _std_gamma(ka, alpha, shape, torch.float64)
        gb = _std_gamma(kb, beta, shape, torch.float64)
        return (ga / (ga + gb)).to(dt)

    def logpdf(self, v, alpha, beta):
        v, alpha, beta = _f(v), _f(alpha), _f(beta)
        inside = (v > 0) & (v < 1)
        v_safe = torch.where(inside, v, 0.5)
        lp = ((alpha - 1) * torch.log(v_safe)
              + (beta - 1) * torch.log1p(-v_safe) - _betaln(alpha, beta))
        return torch.sum(torch.where(inside, lp, -math.inf))


class BetaUniformMixture(Distribution):
    """beta_uniform(theta, alpha, beta): with probability theta a Beta(alpha,
    beta) draw, else a Uniform(0, 1) one."""

    arg_grads = (True, True, True)

    def sample(self, key, theta, alpha, beta):
        kb, kc, ku = random.split(key, 3)
        theta = _f(theta)
        use_beta = random.bernoulli(kc, theta, (), theta.dtype)
        b = Beta().sample(kb, alpha, beta)
        u = random.uniform(ku, tuple(b.shape), torch.get_default_dtype())
        return torch.where(use_beta, b, u)

    def logpdf(self, v, theta, alpha, beta):
        v, theta = _f(v), _f(theta)
        lbeta = torch.log(theta) + Beta().logpdf(v, alpha, beta)
        inside = (v >= 0) & (v <= 1)
        lunif = torch.where(torch.all(inside), torch.log1p(-theta),
                            -math.inf)
        return logsumexp2(lbeta, lunif)


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class InverseGamma(Distribution):
    """inv_gamma(shape, scale)."""

    arg_grads = (True, True)

    def sample(self, key, shape, scale):
        shape, scale = _f(shape), _f(scale)
        size = tuple(torch.broadcast_shapes(shape.shape, scale.shape))
        g = _std_gamma(key, shape, size, torch.result_type(shape, scale))
        return scale / g

    def logpdf(self, v, shape, scale):
        v, shape, scale = _f(v), _f(shape), _f(scale)
        inside = v > 0
        v_safe = torch.where(inside, v, 1.0)
        lp = (shape * torch.log(scale) - (shape + 1) * torch.log(v_safe)
              - scale / v_safe - torch.lgamma(shape))
        return torch.sum(torch.where(inside, lp, -math.inf))


class Exponential(Distribution):
    """exponential(rate)."""

    arg_grads = (True,)

    def sample(self, key, rate):
        rate = _f(rate)
        return random.exponential(key, rate.shape, rate.dtype) / rate

    def logpdf(self, v, rate):
        v, rate = _f(v), _f(rate)
        inside = v >= 0
        lp = torch.log(rate) - rate * torch.where(inside, v, 0.0)
        return torch.sum(torch.where(inside, lp, -math.inf))


class Cauchy(Distribution):
    """cauchy(x0, gamma)."""

    arg_grads = (True, True)

    def sample(self, key, x0, gamma):
        x0, gamma = _f(x0), _f(gamma)
        shape = torch.broadcast_shapes(x0.shape, gamma.shape)
        dt = torch.result_type(x0, gamma)
        u = random.uniform(key, shape, dt, torch.finfo(dt).eps, 1.0)
        return x0 + gamma * torch.tan(math.pi * (u - 0.5))

    def logpdf(self, v, x0, gamma):
        v, x0, gamma = _f(v), _f(x0), _f(gamma)
        z = (v - x0) / gamma
        return torch.sum(-math.log(math.pi) - torch.log(gamma)
                         - torch.log1p(z * z))


class Laplace(Distribution):
    """laplace(loc, scale)."""

    arg_grads = (True, True)

    def sample(self, key, loc, scale):
        loc, scale = _f(loc), _f(scale)
        shape = torch.broadcast_shapes(loc.shape, scale.shape)
        dt = torch.result_type(loc, scale)
        # JAX's lower bound is -1 + epsneg, half of eps for binary floats
        u = random.uniform(key, shape, dt, -1.0 + torch.finfo(dt).eps / 2,
                           1.0)
        return loc + scale * (torch.sign(u) * torch.log1p(-torch.abs(u)))

    def logpdf(self, v, loc, scale):
        v, loc, scale = _f(v), _f(loc), _f(scale)
        return torch.sum(-torch.abs(v - loc) / scale - torch.log(2 * scale))


class StudentT(Distribution):
    """student_t(nu, loc, scale); draws ``Z / sqrt(2 G / nu)`` with ``G ~
    gamma(nu / 2)``."""

    arg_grads = (True, True, True)

    def sample(self, key, nu, loc, scale):
        nu, loc, scale = _f(nu), _f(loc), _f(scale)
        shape = tuple(torch.broadcast_shapes(nu.shape, loc.shape,
                                             scale.shape))
        dt = torch.promote_types(torch.result_type(nu, loc), scale.dtype)
        kz, kg = random.split(key)
        z = random.normal(kz, shape, torch.float64)
        g = _std_gamma(kg, nu.double() / 2.0, shape, torch.float64)
        t = z / torch.sqrt(2.0 * g / nu.double())
        return loc + scale * t.to(dt)

    def logpdf(self, v, nu, loc, scale):
        v, nu, loc, scale = _f(v), _f(nu), _f(loc), _f(scale)
        z = (v - loc) / scale
        lp = (torch.lgamma((nu + 1) / 2) - torch.lgamma(nu / 2)
              - 0.5 * torch.log(nu * math.pi) - torch.log(scale)
              - (nu + 1) / 2 * torch.log1p(z ** 2 / nu))
        return torch.sum(lp)


class NormalLinear(Distribution):
    """normal_linear(X, beta, sigma): n iid normal observations with mean
    ``X @ beta`` and shared scale ``sigma``. The residual sum of squares is
    ``u^T G u`` with ``u = [beta; -1]`` and the data-only Gram matrix
    ``G = [X|v]^T [X|v]``. In float32 keep the data at O(1) scale: the Gram
    form subtracts large squares."""

    arg_grads = (True, True, True)

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

    arg_grads = (True, True)

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


class Dirichlet(Distribution):
    """dirichlet(alpha) -> a simplex vector; one gamma a component,
    normalized."""

    arg_grads = (True,)

    def sample(self, key, alpha):
        alpha = _f(alpha)
        g = _std_gamma(key, alpha, tuple(alpha.shape), torch.float64)
        return (g / torch.sum(g, dim=-1, keepdim=True)).to(alpha.dtype)

    def logpdf(self, v, alpha):
        v, alpha = _f(v), _f(alpha)
        lp = (torch.sum((alpha - 1.0) * torch.log(v), dim=-1)
              + torch.lgamma(torch.sum(alpha, dim=-1))
              - torch.sum(torch.lgamma(alpha), dim=-1))
        return torch.sum(lp)


def _take(x, idx):
    """``x[idx]`` for 1-D ``x`` with the index flattened to 1-D (a 0-dim
    index tensor takes torch's integer-index path, which a batched tensor
    cannot)."""
    return x[idx.reshape(-1)].reshape(idx.shape)


class PiecewiseUniform(Distribution):
    """piecewise_uniform(bounds, probs): ``bounds`` holds the n + 1 sorted
    cell edges, ``probs`` the n cell probabilities."""

    arg_grads = (True, True)

    def sample(self, key, bounds, probs):
        bounds, probs = _f(bounds), _f(probs)
        kc, ku = random.split(key)
        idx = random.categorical(kc, torch.log(probs))
        lo = _take(bounds, idx)
        hi = _take(bounds, idx + 1)
        return lo + random.uniform(ku, (), torch.get_default_dtype()) * (
            hi - lo)

    def logpdf(self, v, bounds, probs):
        v, bounds, probs = _f(v), _f(bounds), _f(probs)
        idx = torch.clamp(torch.searchsorted(bounds, v.to(bounds.dtype),
                                             right=True) - 1,
                          0, probs.shape[0] - 1)
        width = _take(bounds, idx + 1) - _take(bounds, idx)
        inside = (v >= bounds[0]) & (v <= bounds[-1])
        lp = torch.log(_take(probs, idx)) - torch.log(width)
        return torch.sum(torch.where(inside, lp, -math.inf))


class PiecewisePoissonProcess(Distribution):
    """piecewise_poisson_process(bounds, rates): a piecewise-homogeneous
    Poisson process observed as a vector of event times. ``bounds`` holds
    the n + 1 ascending segment edges, ``rates`` the n intensities::

        logpdf(x) = sum_i log(rates[segment(x_i)]) - sum_j rates_j * len_j

    (-inf if the bounds are not ascending or an event falls outside
    [bounds[0], bounds[-1]]; non-finite entries are padding and ignored).

    ``sample`` needs an instance built with ``max_events``: it returns a
    vector of that length whose unused tail is +inf, and it TRUNCATES the
    event count at ``max_events`` (choose ``max_events >= total + 6 *
    sqrt(total)``); a truncated draw has no +inf entry."""

    arg_grads = (False, True)

    def __init__(self, max_events=None):
        self.max_events = max_events

    def sample(self, key, bounds, rates):
        if self.max_events is None:
            raise NotImplementedError(
                "piecewise_poisson_process is observation-oriented under "
                "static shapes; construct "
                "PiecewisePoissonProcess(max_events=N) for padded "
                "simulation")
        from .discrete import _poisson_icdf
        bounds, rates = _f(bounds), _f(rates)
        m = self.max_events
        lens = torch.diff(bounds)
        cell = rates * lens
        total = torch.sum(cell)
        kn, ku = random.split(key)
        n = torch.clamp(_poisson_icdf(total, random.uniform(
            kn, (), torch.float64)), max=m)
        cum = torch.cat([torch.zeros(1, dtype=bounds.dtype,
                                     device=bounds.device),
                         torch.cumsum(cell, 0)])
        u = random.uniform(ku, (m,), torch.get_default_dtype()) * total
        seg = torch.clamp(torch.searchsorted(cum, u, right=True) - 1,
                          0, rates.shape[0] - 1)
        pos = bounds[seg] + (u - cum[seg]) / torch.clamp(rates[seg],
                                                         min=1e-30)
        slots = torch.arange(m, device=u.device)
        return torch.where(slots < n, pos, math.inf)

    def logpdf(self, x, bounds, rates):
        x, bounds, rates = _f(x), _f(bounds), _f(rates)
        lens = torch.diff(bounds)
        ascending = torch.all(lens >= 0)
        total = torch.sum(rates * lens)
        finite = torch.isfinite(x)
        xs = torch.where(finite, x, bounds[0])
        # the segment of x_i counts the interior bounds strictly below it
        # (half-open (b_j, b_j+1] segments)
        seg = torch.sum(xs[..., None] > bounds[None, 1:-1], dim=-1)
        lp_pts = torch.sum(torch.where(finite, torch.log(rates[seg]), 0.0))
        inside = torch.all(torch.where(
            finite, (xs >= bounds[0]) & (xs <= bounds[-1]), True))
        return torch.where(ascending & inside, lp_pts - total, -math.inf)


normal = Normal()
broadcasted_normal = BroadcastedNormal()
normal_linear = NormalLinear()
mvnormal = MvNormal()
uniform = UniformContinuous()
uniform_continuous = uniform
beta = Beta()
beta_uniform = BetaUniformMixture()
gamma = Gamma()
inv_gamma = InverseGamma()
exponential = Exponential()
cauchy = Cauchy()
laplace = Laplace()
piecewise_uniform = PiecewiseUniform()
piecewise_poisson_process = PiecewisePoissonProcess()
student_t = StudentT()
dirichlet = Dirichlet()
