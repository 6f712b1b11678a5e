"""Staging part b against gen_tpu: the structured ops (Cholesky,
triangular solves, ``cholesky_solve``, ``tril``, ``diagonal`` and their
gradients) unrolled into straight-line arithmetic.

- The staged collapsed-Kalman logp (``tests/test_hmc_fused.py``'s
  ``_kalman_logp``, T = 6, D = 2) gives gen_tpu's logp and ``jax.grad`` at
  the tolerances of ``test_scalarize_scan_kalman_exact`` (rtol 1e-4 and
  3e-3).
- Each structured op, in each of its forms, stages and equals eager torch
  (value and ``torch.func`` gradient, float32, 1e-5).
- A branch (``torch.where``, gen_tpu's ``cond``) stages; a long
  straight-line program is one non-inlined CUDA function."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu_torch as tt  # noqa: E402
from gen_tpu_torch import random  # noqa: E402
from gen_tpu_torch.ops import hmc_fused, nuts_fused, staged_eval  # noqa: E402
from gen_tpu_torch.ops.scalarize import stage_scalarized  # noqa: E402
from test_hmc_fused import _kalman_logp as j_kalman_logp  # noqa: E402
from torch_port_models import torch_kalman_logp as t_kalman_logp  # noqa: E402


def _points(d, n, seed=1, scale=0.3):
    return (np.random.default_rng(seed).standard_normal((d, n)) * scale
            ).astype(np.float32)


def _eager(logp, x):
    """Eager torch value and gradient at the columns of ``x``."""
    lp, g = torch.func.vmap(torch.func.grad_and_value(logp))(
        torch.from_numpy(x.T.copy()))[::-1]
    return lp.numpy(), g.T.numpy()


def test_staged_kalman_logp_matches_gen_tpu():
    staged = stage_scalarized(t_kalman_logp(), 3, "cpu")
    assert staged.res_consts.shape[0] < 64 and not staged.streams
    assert staged.structured
    V = _points(3, 16)
    lp, g = staged.vag(torch.from_numpy(V))
    ref, gref = jax.jit(jax.vmap(jax.value_and_grad(j_kalman_logp())))(
        jnp.asarray(V.T))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(g.numpy(), np.asarray(gref).T, rtol=3e-3,
                               atol=3e-3)


def _spd(x):
    """A 3x3 symmetric positive-definite matrix built from x."""
    a = torch.stack([torch.stack([2.0 + x[0] ** 2, x[1], 0.3 * x[2]]),
                     torch.stack([x[1], 2.5 + x[2] ** 2, x[0]]),
                     torch.stack([0.3 * x[2], x[0], 3.0 + x[1] ** 2])])
    return a


def _op_logp(form):
    b = torch.tensor([[0.5, -1.0], [0.2, 0.3], [1.5, 0.7]])

    def logp(x):
        a = _spd(x)
        if form == "cholesky":
            L = torch.linalg.cholesky(a)
            U = torch.linalg.cholesky(a, upper=True)
            return (L * torch.arange(9.0).reshape(3, 3)).sum() \
                + torch.log(torch.diagonal(U)).sum()
        L = torch.linalg.cholesky(a)
        if form == "solve_triangular":
            X1 = torch.linalg.solve_triangular(L, b, upper=False)
            X2 = torch.linalg.solve_triangular(L.T, b, upper=True)
            X3 = torch.linalg.solve_triangular(L, b.T, upper=False,
                                               left=False)
            X4 = torch.linalg.solve_triangular(
                torch.tril(L, -1) + torch.eye(3), b, upper=False,
                unitriangular=True)
            return (X1.sum() + (X2 * X2).sum() + X3.sum() - X4.sum())
        if form == "cholesky_solve":
            y = torch.cholesky_solve(b, L)
            z = torch.cholesky_solve(b, L.T, upper=True)
            return (y * b).sum() + z.sum()
        if form == "cholesky_inverse":
            return (torch.cholesky_inverse(L) * b[:, :1]).sum()
        if form == "batched":
            stack = torch.stack([a, a * 1.5 + torch.eye(3)])
            Ls = torch.linalg.cholesky(stack)
            return torch.log(torch.diagonal(Ls, dim1=-2, dim2=-1)).sum() \
                + torch.triu(Ls.transpose(-1, -2), 1).sum()
        raise ValueError(form)

    return logp


@pytest.mark.parametrize("form", ["cholesky", "solve_triangular",
                                  "cholesky_solve", "cholesky_inverse",
                                  "batched"])
def test_structured_ops_stage_and_match_eager(form):
    logp = _op_logp(form)
    staged = stage_scalarized(logp, 3, "cpu")
    assert staged.structured
    V = _points(3, 12)
    lp, g = staged.vag(torch.from_numpy(V))
    lp_ref, g_ref = _eager(logp, V)
    np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-5, atol=1e-5)


def test_model_with_a_branch_stages():
    """gen_tpu unrolls ``cond`` into a select over both branches; a torch
    model writes the branch as ``torch.where``, which stages as a select
    of both branches' values and gradients."""
    @tt.gen
    def branchy():
        a = tt.normal(0.0, 1.0) @ "a"
        b = tt.normal(0.0, 1.0) @ "b"
        loc = torch.where(a > 0.0, torch.tanh(b) * a, torch.exp(0.5 * b))
        tt.normal(loc, 0.7) @ "y"

    tr, _ = branchy.generate(random.PRNGKey(0, "cpu"), (),
                             tt.choicemap(y=torch.tensor(0.4)))
    target = tt.inference.FlatTarget(tr, tt.select("a", "b"))
    staged = stage_scalarized(target.logp, 2, "cpu")
    V = _points(2, 16, scale=1.0)
    assert (V[0] > 0).any() and (V[0] < 0).any()
    lp, g = staged.vag(torch.from_numpy(V))
    lp_ref, g_ref = _eager(target.logp, V)
    np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-5, atol=1e-6)


def test_long_program_is_one_function_in_every_kernel():
    """A straight-line program past the inlining limit (the Cholesky
    factor of a 12 x 12 matrix and its gradient; a Kalman recursion is a
    rolled loop now): staged_vag is one __noinline__ function, spliced
    into K1, K3, K6 and the staged-code kernel, each launched by one
    thread per chain."""
    def logp(x):
        a = 0.01 * torch.outer(x, x) + 2.0 * torch.eye(12)
        return torch.log(torch.diagonal(torch.linalg.cholesky(a))).sum()

    staged = hmc_fused.stage(logp, 12, "cpu")
    assert staged.n_instructions > 2000 and not staged.loops
    src = staged.cuda_source()
    assert "__device__ __noinline__ void staged_vag(" in src
    assert src.count("  const float t") + src.count("  const bool t") == \
        staged.n_instructions
    fused = (hmc_fused.kernel_source(staged),
             nuts_fused.kernel_source(staged, 8, True),
             nuts_fused.kernel_source(staged, 8, False))
    for k_src in fused + (staged_eval.build_job(staged)[1],):
        assert src in k_src and "@@" not in k_src
        assert "__shfl_xor_sync" not in k_src
    assert all("_LANES 1\n" in k_src for k_src in fused)
