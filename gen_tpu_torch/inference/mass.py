"""Structured mass matrices by whitening the coordinates.

Counterpart: ``gen_tpu/inference/mass.py``, all of it. Instead of teaching
the fused kernels a dense M^-1, the coordinates are whitened once:

  Sigma ~ cross-chain covariance of the warmed population, Sigma = L L^T
  y = L^-1 x  =>  pi_y(y) = pi_x(L y) (+ const log|L|),

and the kernels run on ``pi_y`` with identity mass, which is HMC/NUTS on x
with dense mass Sigma^-1. The wrapped logp's ``L @ y`` (and the low-rank
transform's products with U) stages through :mod:`gen_tpu_torch.ops.
scalarize` as plain multiply-adds over residual constants, so the kernels
do not change. The diag + rank-k metric covers large d, where a dense L's
d^2 staged scalars would pass the residual cap; the ``partial_*`` forms are
the identity on frozen coordinates, so each chain's conditioning values
are never mixed.

Where PyTorch forced differences: the Cholesky factor, the SVD and the
triangular solve are ``torch.linalg`` calls outside the kernels, on the
population's device. SVD signs differ between LAPACK builds; the low-rank
transform ``U diag U^T`` does not depend on them. The products are written
with ``@`` so that a ``(d,)`` argument stages as a matrix-vector product.
"""

from __future__ import annotations

import numpy as np
import torch


def dense_mass_chol(flat, jitter_rel: float = 1e-5):
    """Cholesky factor L of the cross-chain covariance (+ relative jitter):
    ``Sigma = L L^T``. ``flat``: (chains, d) warmed population."""
    flat = torch.as_tensor(flat).to(torch.float32)
    n, d = flat.shape
    x = flat - torch.mean(flat, dim=0)
    sigma = (x.T @ x) / max(n - 1, 1)
    jitter = jitter_rel * (torch.trace(sigma) / d)
    eye = torch.eye(d, dtype=sigma.dtype, device=sigma.device)
    return torch.linalg.cholesky(sigma + jitter * eye)


def whiten_logp(logp, L):
    """``pi_y(y) = pi_x(L y)``. The additive log|L| constant is dropped: it
    cancels in every MH/NUTS energy difference."""
    L = torch.as_tensor(L)

    def logp_w(y):
        return logp(L @ y)

    return logp_w


def whiten(L, x):
    """x -> y = L^-1 x, batched over a leading chain axis."""
    x = torch.as_tensor(x)
    return torch.linalg.solve_triangular(L, x.T, upper=False).T


def unwhiten(L, y):
    """y -> x = L y; works on (chains, d) and (steps, chains, d)."""
    return torch.as_tensor(y) @ L.T


# -- diagonal + low-rank metric ----------------------------------------------

def lowrank_mass_factors(flat, k: int, inv_mass_diag=None):
    """Estimate a diag + rank-k metric from the warmed population.

    Returns ``(sqrt_d, U, sk, s0)``: ``sqrt_d = sqrt(inv_mass_diag)``
    standardizes per-coordinate scale first (pass the ChEES diagonal);
    ``U (d, k)`` top-k eigenvectors of the standardized covariance, ``sk
    (k,)`` their singular values (sqrt eigenvalues), ``s0`` the sqrt of the
    average residual eigenvalue."""
    flat = torch.as_tensor(flat).to(torch.float32)
    n, d = flat.shape
    if not 0 < k < d:
        raise ValueError(f"lowrank rank k={k} must be in (0, {d})")
    sqrt_d = (torch.ones(d, dtype=torch.float32, device=flat.device)
              if inv_mass_diag is None else torch.sqrt(
                  torch.as_tensor(inv_mass_diag, dtype=torch.float32,
                                  device=flat.device)))
    x = (flat - torch.mean(flat, dim=0)) / torch.clamp(sqrt_d, min=1e-12)
    # right singular vectors of X/sqrt(n-1) are eigenvectors of Sigma_std
    _, s, vt = torch.linalg.svd(x / np.sqrt(max(n - 1, 1)),
                                full_matrices=False)
    lam = s ** 2
    lam_k = lam[:k]
    lam_bar = (torch.sum(lam) - torch.sum(lam_k)) / max(d - k, 1)
    lam_bar = torch.clamp(lam_bar, min=1e-10)
    return sqrt_d, vt[:k].T, torch.sqrt(lam_k), torch.sqrt(lam_bar)


def lowrank_transform(sqrt_d, U, sk, s0, y):
    """x = A y with A = diag(sqrt_d) (s0 I + U diag(sk - s0) U^T):
    A A^T = diag(sqrt_d) (s0^2 I + U diag(sk^2 - s0^2) U^T) diag(sqrt_d)
    = the estimated metric. Works on (..., d)."""
    inner = y @ U
    z = s0 * y + ((sk - s0) * inner) @ U.T
    return sqrt_d * z


def lowrank_inverse_transform(sqrt_d, U, sk, s0, x):
    """y = A^-1 x (A is simultaneously diagonalized by (I, U))."""
    z = torch.as_tensor(x) / torch.clamp(sqrt_d, min=1e-12)
    inner = z @ U
    return z / s0 + ((1.0 / sk - 1.0 / s0) * inner) @ U.T


def lowrank_whiten_logp(logp, sqrt_d, U, sk, s0):
    """pi_y(y) = pi_x(A y); log|A| constant dropped (cancels in MH)."""

    def logp_w(y):
        return logp(lowrank_transform(sqrt_d, U, sk, s0, y))

    return logp_w


# -- partial selections ---------------------------------------------------------
# The flat engines freeze unselected coordinates (inverse mass 0). A
# structured metric then whitens only the free subspace and is exactly the
# identity on the frozen one; it is estimated on the free columns alone
# (the frozen columns vary across chains, each chain's own conditioning
# values, and a full estimate would couple them in).

def partial_dense_chol(flat, free_idx, d, jitter_rel: float = 1e-5):
    """Identity-embedded Cholesky factor for a partial selection: the
    (sorted) ``free_idx`` block is chol of the free-subset cross-chain
    covariance; every other row/column is identity."""
    free_idx = np.asarray(free_idx)
    if not np.all(np.diff(free_idx) > 0):
        raise ValueError("free_idx must be sorted")
    flat = torch.as_tensor(flat)
    idx = torch.as_tensor(free_idx, device=flat.device)
    L_sub = dense_mass_chol(flat[:, idx], jitter_rel)
    L = torch.eye(d, dtype=L_sub.dtype, device=L_sub.device)
    L[idx[:, None], idx[None, :]] = L_sub
    return L


def partial_lowrank_factors(flat, free_idx, d, k: int, inv_mass_diag=None):
    """Diag + rank-k factors estimated on the free subset and embedded at
    the full dimension: U rows and sqrt_d entries off ``free_idx`` are
    zeroed/one'd, so :func:`partial_lowrank_transform` is the identity on
    frozen coordinates. ``inv_mass_diag``: FULL-d diagonal (frozen entries
    0, as the ChEES warmup returns for partial selections)."""
    flat = torch.as_tensor(flat)
    idx = torch.as_tensor(np.asarray(free_idx), device=flat.device)
    sub_inv = (None if inv_mass_diag is None
               else torch.as_tensor(inv_mass_diag).to(flat.device)[idx])
    sqrt_d_f, U_f, sk, s0 = lowrank_mass_factors(flat[:, idx], k,
                                                 inv_mass_diag=sub_inv)
    sqrt_d = torch.ones((d,), dtype=torch.float32, device=flat.device)
    sqrt_d[idx] = sqrt_d_f
    U = torch.zeros((d, U_f.shape[1]), dtype=torch.float32,
                    device=flat.device)
    U[idx] = U_f
    mask = torch.zeros((d,), dtype=torch.float32, device=flat.device)
    mask[idx] = 1.0
    return sqrt_d, U, sk, s0, mask


def partial_lowrank_transform(sqrt_d, U, sk, s0, mask, y):
    x = lowrank_transform(sqrt_d, U, sk, s0, y)
    return mask * x + (1.0 - mask) * y


def partial_lowrank_inverse_transform(sqrt_d, U, sk, s0, mask, x):
    y = lowrank_inverse_transform(sqrt_d, U, sk, s0, x)
    return mask * y + (1.0 - mask) * x


def partial_lowrank_whiten_logp(logp, sqrt_d, U, sk, s0, mask):

    def logp_w(y):
        return logp(partial_lowrank_transform(sqrt_d, U, sk, s0, mask, y))

    return logp_w
