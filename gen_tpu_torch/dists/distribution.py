"""Distribution interface.

Counterpart: ``gen_tpu/dists/distribution.py``. ``logpdf`` is plain torch
code, traced by ``torch.func`` transforms and by the staging pass in
:mod:`gen_tpu_torch.ops.scalarize`. The gradient metadata
(``is_discrete``, ``has_output_grad``, ``arg_grads``) and
``enumerate_support`` are gen_tpu's, and so are ``logpdf_grad`` (here
``torch.func.grad`` of the summed logpdf), ``get_return_type`` and
``logsumexp2``.

Where PyTorch forced a difference: gen_tpu's supports refuse JAX tracers.
Here a support bound must be a concrete value: a Python number or a plain
tensor, not one batched by ``torch.func.vmap`` (:func:`concrete_int`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..gfi import GenerativeFunction


class Distribution(GenerativeFunction):
    """Base class for primitive probability distributions."""

    is_discrete: bool = False
    has_output_grad: bool = True
    arg_grads: Tuple[bool, ...] = ()

    def sample(self, key, *args):
        raise NotImplementedError

    def logpdf(self, v, *args):
        raise NotImplementedError

    def has_argument_grads(self) -> Tuple[bool, ...]:
        return self.arg_grads

    def enumerate_support(self, *args):
        """Finite support of the distribution (a 1-D tensor of candidate
        values), for exact enumerative moves (the Gibbs sweeps of
        :mod:`gen_tpu_torch.inference.mixed`). Only finite discrete
        distributions implement it; it reads shapes and concrete bounds,
        never traced values."""
        raise NotImplementedError(
            f"{type(self).__name__} has no finite enumerable support; "
            "addresses drawn from it cannot be moved by exact Gibbs — "
            "pass explicit discrete_supports= (if a finite truncation is "
            "acceptable) or marginalize the address out of the model")

    def logpdf_grad(self, v, *args):
        """``(output_grad_or_None, *arg_grads_or_None)``: the gradient of
        the summed logpdf with respect to the value (when
        ``has_output_grad``) and each argument whose ``arg_grads`` entry is
        true; None elsewhere."""
        diff_wrt = ([0] if self.has_output_grad else []) + [
            i + 1 for i, g in enumerate(self.arg_grads) if g]
        if not diff_wrt:
            return (None,) * (len(args) + 1)
        fargs = (_f(v) if self.has_output_grad else v,) + tuple(
            _f(a) if i + 1 in diff_wrt else a for i, a in enumerate(args))

        def f(*all_args):
            return torch.sum(self.logpdf(*all_args))

        grads = torch.func.grad(f, argnums=tuple(diff_wrt))(*fargs)
        out = [None] * (len(args) + 1)
        for idx, g in zip(diff_wrt, grads):
            out[idx] = g
        return tuple(out)

    def get_return_type(self):
        """float32 for continuous, int32 for discrete distributions."""
        return torch.int32 if self.is_discrete else torch.float32

    def __repr__(self):
        return f"{type(self).__name__.lower()}"


def _f(x) -> torch.Tensor:
    """Promote to a floating tensor (Python numbers become float32, JAX's
    32-bit default)."""
    x = torch.as_tensor(x)
    if not torch.is_floating_point(x):
        x = x.to(torch.get_default_dtype())
    return x


def concrete_int(x, what: str) -> int:
    """``x`` as a Python int, refusing a tensor batched by a
    ``torch.func`` transform (gen_tpu refuses JAX tracers the same
    way)."""
    if isinstance(x, torch.Tensor):
        from torch._C._functorch import is_functorch_wrapped_tensor
        if is_functorch_wrapped_tensor(x):
            raise NotImplementedError(
                f"{what} is a traced value — the support cannot be "
                "enumerated statically; pass explicit discrete_supports= "
                "covering the widest possible range")
    return int(x)


def logsumexp2(a, b):
    """Pairwise logsumexp, ``-inf`` (or ``+inf``) where the larger of the
    two is not finite."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    m = torch.maximum(a, b)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, 0.0)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))
    return torch.where(finite, out, m)
