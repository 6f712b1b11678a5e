"""Batched multivariate-normal helpers: many rows against one covariance.

Counterpart: ``gen_tpu/ops/mvn.py`` (``MvnChol``, ``mvn_precompute``,
``mvn_logpdf_rows``, ``mvn_sample_rows``). The formulation is gen_tpu's:
factor the shared covariance once (``L = chol(cov)``, ``Linv = L^-1``),
then each batch is one matmul, ``Z = (X - mu) Linv^T``. On the TPU that
matmul rode the MXU; here it is a plain ``torch`` matmul (cuBLAS on the
card). gen_tpu's ``dtype=jnp.bfloat16`` mode casts the operands and
accumulates in float32; the port keeps the argument and casts the same way,
accumulating in float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import random

_LOG_2PI = 1.8378770664093453


class MvnChol(NamedTuple):
    """Precomputed factorization of one shared covariance."""

    linv: torch.Tensor    # (D, D) lower-triangular inverse Cholesky factor
    logdet: torch.Tensor  # scalar: log det(cov)


def mvn_precompute(cov) -> MvnChol:
    """Factor a shared covariance once; reuse across the whole batch."""
    cov = torch.as_tensor(cov)
    chol = torch.linalg.cholesky(cov)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2,
                                                      dim2=-1)), dim=-1)
    return MvnChol(linv, logdet)


def _matmul_t(a, b, dtype, out_dtype):
    """``a @ b.T``, with both operands cast to ``dtype`` when given and the
    product accumulated in ``out_dtype``."""
    if dtype is not None:
        a, b = a.to(dtype).to(out_dtype), b.to(dtype).to(out_dtype)
    return a.to(out_dtype) @ b.to(out_dtype).T


def mvn_logpdf_rows(x, mu, prec: MvnChol,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Row-wise MVN logpdf: ``x`` (N, D) against N(mu, cov) with ``prec``
    from :func:`mvn_precompute`. ``dtype=torch.bfloat16`` rounds the
    residuals and ``Linv`` to bfloat16 before the float32 matmul. Returns
    (N,) in float32, or the input float dtype if wider."""
    x, mu = torch.as_tensor(x), torch.as_tensor(mu)
    d = x - mu
    out_dtype = torch.promote_types(d.dtype, torch.float32)
    z = _matmul_t(d, prec.linv, dtype, out_dtype)
    k = x.shape[-1]
    quad = torch.sum(z * z, dim=-1)
    return (-0.5 * (quad + prec.logdet + k * _LOG_2PI)).to(out_dtype)


def mvn_sample_rows(key, mu, prec_or_cov, n: int,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Draw n samples from N(mu, cov) as an (n, D) matrix with one matmul:
    ``X = mu + E L^T``, ``E ~ N(0, I)``."""
    if isinstance(prec_or_cov, MvnChol):
        linv = prec_or_cov.linv
        eye = torch.eye(linv.shape[-1], dtype=linv.dtype, device=linv.device)
        chol = torch.linalg.solve_triangular(linv, eye, upper=False)
    else:
        chol = torch.linalg.cholesky(torch.as_tensor(prec_or_cov))
    mu = torch.as_tensor(mu)
    d = chol.shape[-1]
    eps = random.normal(key, (n, d), chol.dtype)
    out_dtype = torch.promote_types(mu.dtype, torch.float32)
    return mu + _matmul_t(eps, chol, dtype, out_dtype)
