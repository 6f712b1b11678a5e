"""Derived distributions: the counterpart of Gen's ``@dist`` DSL.

Counterpart: ``gen_tpu/dists/dist_dsl.py``, all of it. Derived
distributions come from argument transformations
(:class:`ArgMappedDistribution`, :func:`dist`), elementwise bijections of
the output (:class:`TransformedDistribution`: affine, ``exp_of``,
``log_of``, with the change-of-variables correction) and relabelings of a
discrete index (:class:`RelabeledDistribution`, :func:`enum_dist`; equal
labels sum their mass). Importing this module patches arithmetic onto
:class:`~gen_tpu_torch.dists.distribution.Distribution`, as gen_tpu does:
``normal * 2 + 3`` is the affine transform of ``normal``'s output. The
patch touches the distribution objects only, not ``dist(args) @ "addr"``,
whose ``@`` belongs to the call record.

Where PyTorch forced a difference: an affine map's ``log|a|`` takes the
dtype of the value it is applied to (gen_tpu's ``jnp.asarray(a)`` takes
JAX's default float when the map is built), and relabeled draws move the
labels to the index's device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import vmap

from .distribution import Distribution, _f


class Bijection:
    """A scalar (elementwise) bijection y = f(x) with log|dy/dx|."""

    def __init__(self, forward: Callable, inverse: Callable,
                 log_abs_deriv: Callable, name: str = "bijection"):
        self.forward = forward
        self.inverse = inverse
        self.log_abs_deriv = log_abs_deriv  # log|f'(x)| as a function of x
        self.name = name


def affine_bijection(a, b):
    """y = a*x + b."""
    def log_abs_deriv(x):
        la = torch.log(torch.abs(torch.as_tensor(a, dtype=x.dtype,
                                                 device=x.device)))
        return torch.broadcast_to(la, x.shape)

    return Bijection(forward=lambda x: a * x + b,
                     inverse=lambda y: (y - b) / a,
                     log_abs_deriv=log_abs_deriv,
                     name=f"affine({a}, {b})")


exp_bijection = Bijection(torch.exp, torch.log, lambda x: x, "exp")
log_bijection = Bijection(torch.log, torch.exp, lambda x: -torch.log(x),
                          "log")


class TransformedDistribution(Distribution):
    """y = f(x), x ~ base. A continuous base gives logpdf(y) =
    base.logpdf(f^-1(y)) - log|f'(f^-1(y))|; for a discrete base the
    transform is a relabeling with no correction."""

    def __init__(self, base: Distribution, bij: Bijection):
        self.base = base
        self.bij = bij
        self.is_discrete = base.is_discrete
        self.has_output_grad = base.has_output_grad
        self.arg_grads = base.arg_grads

    def __repr__(self):
        return f"{self.bij.name}({self.base!r})"

    def sample(self, key, *args):
        return self.bij.forward(self.base.sample(key, *args))

    def logpdf(self, v, *args):
        v = _f(v) if not self.is_discrete else torch.as_tensor(v)
        x = self.bij.inverse(v)
        lp = self.base.logpdf(x, *args)
        if self.is_discrete:
            return lp
        return lp - torch.sum(self.bij.log_abs_deriv(x))


class RelabeledDistribution(Distribution):
    """v = labels[i], i ~ base index distribution; the logpdf sums the
    index probability over every index whose label equals v."""

    def __init__(self, labels, base: Distribution):
        self.labels = torch.as_tensor(labels)
        self.base = base
        self.is_discrete = True
        self.has_output_grad = False
        self.arg_grads = base.arg_grads

    def __repr__(self):
        return f"relabeled({self.base!r})"

    def sample(self, key, *args):
        idx = torch.as_tensor(self.base.sample(key, *args))
        labels = self.labels.to(idx.device)
        return labels[idx.reshape(-1).long()].reshape(idx.shape)

    def logpdf(self, v, *args):
        v = torch.as_tensor(v)
        labels = self.labels.to(v.device)
        idxs = torch.arange(labels.shape[0], device=v.device)
        match = labels == v
        lps = vmap(lambda i: torch.as_tensor(self.base.logpdf(i, *args)))(
            idxs)
        return torch.logsumexp(torch.where(match, lps, -torch.inf), dim=0)


class ArgMappedDistribution(Distribution):
    """Distribution with transformed arguments: ``d(args*) =
    base(g(args*))``."""

    def __init__(self, base: Distribution, arg_fn: Callable,
                 num_args: Optional[int] = None, is_discrete=None):
        self.base = base
        self.arg_fn = arg_fn
        self.is_discrete = (base.is_discrete if is_discrete is None
                            else is_discrete)
        self.has_output_grad = base.has_output_grad
        self.arg_grads = (True,) * (num_args or 0)

    def __repr__(self):
        return f"arg_mapped({self.base!r})"

    def sample(self, key, *args):
        return self.base.sample(key, *self.arg_fn(*args))

    def logpdf(self, v, *args):
        return self.base.logpdf(v, *self.arg_fn(*args))


def dist(fn: Callable, num_args: int = None, base: Distribution = None,
         **kwargs):
    """The closest counterpart of ``@dist``: an argument-transforming
    callable around a base distribution, ``fn(*user_args) ->
    base_args_tuple``."""
    if base is None:
        raise ValueError("dist(...) requires base=<Distribution>")
    return ArgMappedDistribution(base, fn, num_args=num_args, **kwargs)


# -- operator sugar on Distribution ---------------------------------------

def _add(self, c):
    return TransformedDistribution(self, affine_bijection(1.0, c))


def _mul(self, c):
    return TransformedDistribution(self, affine_bijection(c, 0.0))


def _sub(self, c):
    return TransformedDistribution(self, affine_bijection(1.0, -c))


def _rsub(self, c):
    return TransformedDistribution(self, affine_bijection(-1.0, c))


def _div(self, c):
    return TransformedDistribution(self, affine_bijection(1.0 / c, 0.0))


def _neg(self):
    return TransformedDistribution(self, affine_bijection(-1.0, 0.0))


Distribution.__add__ = _add
Distribution.__radd__ = _add
Distribution.__mul__ = _mul
Distribution.__rmul__ = _mul
Distribution.__sub__ = _sub
Distribution.__rsub__ = _rsub
Distribution.__truediv__ = _div
Distribution.__neg__ = _neg


def exp_of(base: Distribution) -> TransformedDistribution:
    return TransformedDistribution(base, exp_bijection)


def log_of(base: Distribution) -> TransformedDistribution:
    return TransformedDistribution(base, log_bijection)


def enum_dist(enum_cls, base: Distribution) -> RelabeledDistribution:
    """``@dist``'s Enum construction: ``base`` is an index distribution
    over positions 0..len(enum_cls)-1 in definition order, and draws are
    the members' ``.value`` as integer tensors (recover the member with
    ``enum_cls(int(v))``). Equal values sum their index mass."""
    return RelabeledDistribution(
        torch.as_tensor([m.value for m in enum_cls]), base)
