"""The staging pass and the fused HMC kernel's twin against gen_tpu.

- The staged value and gradient (torch rendering) equal
  ``torch.func.grad_and_value`` of the logp and gen_tpu's
  ``stage_scalarized(...).plane_vag``.
- The twin under injected randomness equals gen_tpu's Pallas kernel run
  under the TPU interpreter (``interpret=True``) on the regression model and
  on a Gaussian with a frozen coordinate: equal accept counts, values and
  histories within 2e-4 (tests/test_hmc_fused.py's tolerance for the same
  comparison against its XLA reference).
- The CUDA source renders; it can only be compiled where nvcc and a card
  are (``chip_smoke.py``, and the ``cuda``-marked test below).
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.inference.target import FlatTarget as JFlatTarget  # noqa: E402
from gen_tpu.ops.hmc_fused import hmc_chains_fused as j_fused  # noqa: E402
from gen_tpu.ops.scalarize import stage_scalarized as j_stage  # noqa: E402
from gen_tpu_torch.inference import FlatTarget  # noqa: E402
from gen_tpu_torch.ops import hmc_fused  # noqa: E402
from gen_tpu_torch.ops.hmc_fused import (hmc_chains_fused,  # noqa: E402
                                         hmc_chains_fused_plain)
from gen_tpu_torch.ops.scalarize import stage_scalarized  # noqa: E402
from torch_port_models import (ADDRS, jax_args, jax_regression,  # noqa: E402
                               torch_args, torch_regression)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
SDS = np.array([1.0, 4.0, 0.5], np.float32)
INV_MASS_FROZEN = np.array([1.0, 16.0, 0.0], np.float32)


def _regression_targets():
    """(gen_tpu FlatTarget, port FlatTarget); call under x64 off."""
    args_j, obs_j = jax_args()
    jtr, _ = jax_regression.generate(jax.random.PRNGKey(0), args_j, obs_j)
    args_t, obs_t = torch_args()
    ttr, _ = torch_regression.generate(tt.random.PRNGKey(0, "cpu"), args_t, obs_t)
    return (JFlatTarget(jtr, gt.select(*ADDRS)),
            FlatTarget(ttr, tt.select(*ADDRS)))


def _gauss_logps():
    sds_j, sds_t = jnp.asarray(SDS), torch.from_numpy(SDS)
    return (lambda x: -0.5 * jnp.sum((x / sds_j) ** 2),
            lambda x: -0.5 * torch.sum((x / sds_t) ** 2))


def _injected(seed, n_steps, n, d, eps):
    rng = np.random.default_rng(seed)
    return ((eps * rng.uniform(0.8, 1.2, n_steps)).astype(np.float32),
            rng.standard_normal((n_steps, n, d)).astype(np.float32),
            np.maximum(rng.uniform(size=(n_steps, n)), 1e-30)
            .astype(np.float32))


def test_staged_value_and_grad_regression():
    with jax.enable_x64(False):
        jt, t = _regression_targets()
        staged_j = j_stage(jt.logp, 3)
        x = (0.5 * np.random.default_rng(0).standard_normal((3, 256))
             ).astype(np.float32)
        lp_j, g_j = staged_j.plane_vag(jnp.asarray(x), staged_j.res_consts)
        lp_j, g_j = np.asarray(lp_j), np.asarray(g_j)
    staged = stage_scalarized(t.logp, 3)
    # the normal_linear data (50 points) is hoisted: the kernel sees only
    # the Gram matrix and the priors' parameters
    assert staged.n_res < 50
    lp, g = staged.vag(torch.from_numpy(x))
    lp_ref, g_ref = torch.func.vmap(t.value_and_grad)(torch.from_numpy(x).T)
    np.testing.assert_allclose(lp.numpy(), lp_ref.numpy(), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_ref.T.numpy(), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(lp.numpy(), lp_j, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-4, atol=1e-3)


def test_staged_value_and_grad_elementwise_ops():
    """A logp touching most of the op table, against torch.func."""
    w = torch.tensor([0.3, -1.2, 2.0])

    def logp(x):
        a = torch.tanh(x[0]) * torch.sigmoid(x[1]) + torch.sqrt(1.0 + x[2] ** 2)
        b = torch.log1p(torch.exp(x - 3.0)).sum() - torch.abs(x).sum()
        c = torch.where(x[0] > x[1], torch.sin(x[2]), torch.cos(x[2]))
        d = torch.clamp(x, min=-1.0, max=1.5) @ w
        e = torch.maximum(x[0], x[2]) / (2.0 + x[1] * x[1]) - 1.0 / (3 + x[0] ** 2)
        return a + b + c + d + e + torch.rsqrt(2.0 + x[2] ** 2)

    staged = stage_scalarized(logp, 3)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 64))
                         .astype(np.float32))
    lp, g = staged.vag(x)
    lp_ref, g_ref = torch.func.vmap(torch.func.grad_and_value(logp))(x.T)[::-1]
    np.testing.assert_allclose(lp.numpy(), lp_ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_ref.T.numpy(), rtol=1e-5,
                               atol=1e-5)


def _eigh_logp(x):
    a = torch.stack([torch.stack([2.0 + x[0] ** 2, x[1]]),
                     torch.stack([x[1], 2.0 + x[2] ** 2])])
    return torch.linalg.eigvalsh(a).sum()


_DATA = torch.linspace(-1.0, 1.0, 4096)
_DATA2 = torch.linspace(-1.0, 1.0, 3000)


@pytest.mark.parametrize("logp,name", [
    (lambda x: torch.cumsum(x, 0).sum(), "cumsum"),
    # cholesky and per-point likelihoods stage now (parts b and c,
    # tests/test_torch_staging_*.py); an eigendecomposition does not
    (_eigh_logp, "eigh"),
    # two data axes of different lengths in one streamed likelihood
    (lambda x: -torch.sum(torch.log1p((_DATA - x[0]) ** 2))
     - torch.sum(torch.log1p((_DATA2 - x[1]) ** 2)), "lengths"),
])
def test_unsupported_op_raises_with_its_name(logp, name):
    with pytest.raises(ValueError, match=name):
        stage_scalarized(logp, 3)


def test_twin_matches_interpret_kernel_regression():
    n, d, n_steps, L = 1024, 3, 12, 3
    inj = _injected(5, n_steps, n, d, 0.035)
    vals0 = (0.1 * np.random.default_rng(6).standard_normal((n, d))
             ).astype(np.float32)
    with jax.enable_x64(False):
        jt, t = _regression_targets()
        vj, cj, aj = j_fused(jax.random.PRNGKey(1), jt.logp,
                             jnp.asarray(vals0), n_steps=n_steps, L=L,
                             eps=0.035, collect_idx=None,
                             injected_rng=tuple(map(jnp.asarray, inj)),
                             interpret=True)
        vj, cj, aj = map(np.asarray, (vj, cj, aj))
    before = hmc_chains_fused.launches
    vt, ct, at = hmc_chains_fused(tt.random.PRNGKey(1, "cpu"), t.logp,
                                  torch.from_numpy(vals0), n_steps, L=L,
                                  eps=0.035, collect_idx=None,
                                  injected_rng=inj)
    assert hmc_chains_fused.launches == before   # CPU: the twin ran
    assert ct.shape == (n_steps, n, d)
    np.testing.assert_array_equal(at.numpy(), aj)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=TOL, atol=TOL)
    assert aj.mean() / n_steps > 0.5


def test_twin_matches_interpret_kernel_frozen_coordinate():
    n, d, n_steps, L = 1024, 3, 10, 4
    inj = _injected(7, n_steps, n, d, 0.4)
    vals0 = (np.random.default_rng(8).standard_normal((n, d)) * SDS
             ).astype(np.float32)
    logp_j, logp_t = _gauss_logps()
    with jax.enable_x64(False):
        vj, cj, aj = j_fused(jax.random.PRNGKey(1), logp_j,
                             jnp.asarray(vals0), n_steps=n_steps, L=L,
                             eps=0.4, collect_idx=1,
                             inv_mass_diag=jnp.asarray(INV_MASS_FROZEN),
                             injected_rng=tuple(map(jnp.asarray, inj)),
                             interpret=True)
        vj, cj, aj = map(np.asarray, (vj, cj, aj))
    vt, ct, at = hmc_chains_fused_plain(
        tt.random.PRNGKey(1, "cpu"), logp_t, torch.from_numpy(vals0), n_steps, L=L,
        eps=0.4, collect_idx=1, inv_mass_diag=INV_MASS_FROZEN,
        injected_rng=inj)
    np.testing.assert_array_equal(at.numpy(), aj)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(vt[:, 2].numpy(), vals0[:, 2])


def test_twin_own_randomness_samples_the_gaussian():
    """Without injection the twin draws with gen_tpu_torch.random; on a
    Gaussian it recovers the target's scales, frozen coordinate fixed."""
    _, logp_t = _gauss_logps()
    vals0 = torch.from_numpy(
        (np.random.default_rng(9).standard_normal((512, 3)) * SDS)
        .astype(np.float32))
    vt, ct, at = hmc_chains_fused(tt.random.PRNGKey(2, "cpu"), logp_t, vals0, 150,
                                  L=5, eps=0.4, collect_idx=None,
                                  inv_mass_diag=INV_MASS_FROZEN)
    draws = ct[50:].reshape(-1, 3)
    np.testing.assert_allclose(draws[:, :2].std(0).numpy(), SDS[:2],
                               rtol=0.05)
    assert torch.equal(vt[:, 2], vals0[:, 2])
    assert 0.8 < float(at.mean()) / 150 <= 1.0


def test_chunked_runner_stitches_chunks():
    """``hmc_chains_fused_chunked`` (the ``hmc_fused`` engine's chunked runner):
    chunk c runs with the second half of the c-th split of the key, so the
    result equals those calls made by hand; the history is their
    concatenation and the accept counts their sum."""
    _, logp_t = _gauss_logps()
    vals0 = torch.from_numpy(
        (np.random.default_rng(10).standard_normal((64, 3)) * SDS)
        .astype(np.float32))
    kw = dict(L=4, eps=0.4, collect_idx=None, inv_mass_diag=INV_MASS_FROZEN)
    key = tt.random.PRNGKey(4, "cpu")
    v, c, a = hmc_fused.hmc_chains_fused_chunked(key, logp_t, vals0, 10,
                                                 chunk_steps=4, **kw)
    hist, acc, vm = [], torch.zeros(64), vals0
    for t in (4, 4, 2):
        key, k_use = tt.random.split(key)
        vm, cm, am = hmc_chains_fused(k_use, logp_t, vm, t, **kw)
        hist.append(cm)
        acc = acc + am
    torch.testing.assert_close(v, vm, rtol=0, atol=0)
    torch.testing.assert_close(c, torch.cat(hist), rtol=0, atol=0)
    torch.testing.assert_close(a, acc, rtol=0, atol=0)
    assert c.shape == (10, 64, 3)
    # the budget: one chunk unless the history would pass it
    assert hmc_fused.HIST_BUDGET_BYTES // (3 * 4 * 64) > 10


def test_cuda_source_renders():
    _, t = _regression_targets()
    staged = hmc_fused.stage(t.logp, 3, "cpu")
    assert hmc_fused.stage(t.logp, 3, "cpu") is staged     # cached
    src = hmc_fused.kernel_source(staged)
    assert "@@" not in src
    assert "#define HMC_D 3" in src and f"#define HMC_R {staged.n_res}" in src
    assert src.count("  const float t") + src.count("  const bool t") == \
        staged.n_instructions
    assert all(f"  g[{i}] = " in src for i in range(3))
    assert 'extern "C" int hmc_fused_launch(' in src


def test_chip_smoke_refuses_without_cuda():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.cuda
def test_kernel_matches_twin_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    sds = torch.from_numpy(SDS).to(dev)

    def logp_t(x):
        return -0.5 * torch.sum((x / sds) ** 2)

    n, d, n_steps = 4096, 3, 10
    inj = _injected(3, n_steps, n, d, 0.4)
    vals0 = torch.randn(n, d, device=dev) * sds
    kw = dict(n_steps=n_steps, L=4, eps=0.4, collect_idx=None,
              inv_mass_diag=INV_MASS_FROZEN, injected_rng=inj)
    before = hmc_chains_fused.launches
    vk, ck, ak = hmc_chains_fused(tt.random.PRNGKey(1, dev), logp_t, vals0,
                                  **kw)
    assert hmc_chains_fused.launches == before + 1
    vp, cp, ap = hmc_chains_fused_plain(tt.random.PRNGKey(1, dev), logp_t,
                                        vals0, **kw)
    assert torch.equal(ak, ap)
    torch.testing.assert_close(vk, vp, rtol=TOL, atol=TOL)
    torch.testing.assert_close(ck, cp, rtol=TOL, atol=TOL)
