"""gen_tpu_torch's FlatTarget, hmc_chains and diagnostics against gen_tpu's.

hmc_chains runs step for step under the same key: the port's threefry
draws are gen_tpu's bits, so every jitter, momentum, accept and teleport
draw is the same. float32 throughout (gen_tpu with x64 off, its production
setting). Accept decisions must agree exactly; positions within 1e-3,
because XLA contracts multiply-adds into fmas and sums the Gram form of
normal_linear in another order, and that form cancels in float32.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.diagnostics import (ess_bulk as j_ess_bulk,  # noqa: E402
                                 ess_tail as j_ess_tail,
                                 mcse_mean as j_mcse, rhat as j_rhat)
from gen_tpu.inference import hmc_chains as j_hmc_chains  # noqa: E402
from gen_tpu.inference.target import FlatTarget as JFlatTarget  # noqa: E402
from gen_tpu_torch import diagnostics as tdiag  # noqa: E402
from gen_tpu_torch.convert import flat_values_from_numpy  # noqa: E402
from gen_tpu_torch.inference import FlatTarget, hmc_chains  # noqa: E402
from torch_port_models import (ADDRS, float64_default,  # noqa: E402
                               jax_args, jax_regression, torch_args,
                               torch_regression)


def _targets(dtype_j=jnp.float32, dtype_t=torch.float32):
    args_j, obs_j = jax_args(dtype_j)
    jtr, _ = jax_regression.generate(jax.random.PRNGKey(0), args_j, obs_j)
    args_t, obs_t = torch_args(dtype_t)
    ttr, _ = torch_regression.generate(tt.random.PRNGKey(0, "cpu"), args_t, obs_t)
    return (JFlatTarget(jtr, gt.select(*ADDRS)),
            FlatTarget(ttr, tt.select(*ADDRS)))


def test_flat_target_logp_and_grad_float64():
    rng = np.random.default_rng(1)
    with float64_default():
        jt, t = _targets(jnp.float64, torch.float64)
        assert t.dim == jt.dim == 3
        for x in rng.standard_normal((5, 3)) * 0.5:
            lj, gj = jt.value_and_grad(jnp.asarray(x))
            lt, gt_ = t.value_and_grad(torch.tensor(x))
            assert lt.dtype == torch.float64
            np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-12)
            np.testing.assert_allclose(gt_.numpy(), np.asarray(gj),
                                       rtol=1e-10)
            np.testing.assert_allclose(t.logp(torch.tensor(x)).item(),
                                       float(lj), rtol=1e-12)


def test_flat_target_logp_and_grad_float32():
    with jax.enable_x64(False):
        jt, t = _targets()
        rng = np.random.default_rng(1)
        xs = (rng.standard_normal((5, 3)) * 0.5).astype(np.float32)
        ref = [jt.value_and_grad(jnp.asarray(x)) for x in xs]
        ref = [(float(lj), np.asarray(gj)) for lj, gj in ref]
    for x, (lj, gj) in zip(xs, ref):
        lt, gt_ = t.value_and_grad(torch.from_numpy(x))
        assert lt.dtype == torch.float32
        # the float32 Gram form cancels: 1e-4 relative
        np.testing.assert_allclose(lt.item(), lj, rtol=1e-4)
        np.testing.assert_allclose(gt_.numpy(), gj, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("inv_mass", [None, (1.0, 0.5, 0.0)])
def test_hmc_chains_step_for_step(inv_mass):
    """Including a diagonal mass with a frozen (inverse mass 0) coordinate."""
    n, n_steps = 256, 20
    with jax.enable_x64(False):
        jt, t = _targets()
        args_j, obs_j = jax_args()
        sel = gt.select(*ADDRS)
        v0 = jax.vmap(lambda k: jax_regression.generate(k, args_j, obs_j)[0]
                      .get_choices().filter(sel).to_array())(
            jax.random.split(jax.random.PRNGKey(2), n))
        vj, cj, aj = jax.jit(lambda v: j_hmc_chains(
            jax.random.PRNGKey(3), jt, v, n_steps=n_steps, L=10, eps=0.035,
            teleport_after=5, inv_mass_diag=None if inv_mass is None
            else jnp.asarray(inv_mass, jnp.float32)))(v0)
        v0, vj, cj, aj = map(np.asarray, (v0, vj, cj, aj))
    vt, ct, at = hmc_chains(tt.random.PRNGKey(3, "cpu"), t,
                            flat_values_from_numpy(v0, "cpu"), n_steps=n_steps,
                            L=10, eps=0.035, teleport_after=5,
                            inv_mass_diag=inv_mass)
    assert ct.shape == (n_steps, n, 3) and at.shape == (n_steps, n)
    np.testing.assert_array_equal(at.numpy(), aj)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-3, atol=1e-3)
    assert 0.5 < aj.mean() < 1.0


def _ar1_draws(seed, n=400, m=16, rho=0.6):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, m))
    e = rng.standard_normal((n, m))
    for i in range(1, n):
        x[i] = rho * x[i - 1] + e[i]
    x[:, 0] += 0.3            # one chain off-centre: R-hat above 1
    return x.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_diagnostics_match_on_shared_draws(seed):
    x = _ar1_draws(seed)
    with jax.enable_x64(False):
        ref = {name: float(jax.jit(f)(jnp.asarray(x))) for name, f in [
            ("rhat", j_rhat), ("ess_bulk", j_ess_bulk),
            ("ess_tail", j_ess_tail), ("mcse_mean", j_mcse)]}
    xt = torch.from_numpy(x)
    got = {"rhat": tdiag.rhat(xt), "ess_bulk": tdiag.ess_bulk(xt),
           "ess_tail": tdiag.ess_tail(xt), "mcse_mean": tdiag.mcse_mean(xt)}
    for name, v in got.items():
        np.testing.assert_allclose(float(v), ref[name], rtol=1e-4,
                                   err_msg=name)
    summ = tdiag.summarize({"a": xt, "b": torch.stack([xt, -xt], dim=-1)})
    np.testing.assert_allclose(float(summ["a"]["rhat"]), ref["rhat"],
                               rtol=1e-4)
    assert summ["b"]["ess_bulk"].shape == (2,)


@pytest.mark.parametrize("nan", [False, True])
def test_rank_normalize_ties_and_nan_match_gen_tpu(nan):
    """Average ranks of tied values, infinities and NaNs: the tie bounds
    from runs of equal values give gen_tpu's normal scores (its two
    searches), NaN lanes included."""
    from gen_tpu.diagnostics import _rank_normalize as j_rank

    rng = np.random.default_rng(3)
    x = rng.integers(0, 7, size=(40, 4)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.inf
    x[rng.random(x.shape) < 0.1] = -np.inf
    if nan:
        x[rng.random(x.shape) < 0.15] = np.nan
    with jax.enable_x64(False):
        ref = np.asarray(jax.jit(j_rank)(jnp.asarray(x)))
    got = tdiag._rank_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_rhat_large_pooled_size_no_overflow():
    """Tail-safe normal scores: past 2**23 pooled float32 draws the naive
    form rounds the top ranks to p == 1 and R-hat becomes NaN."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6000, 2048)).astype(np.float32))
    r = float(tdiag.rhat(x))
    assert np.isfinite(r) and abs(r - 1.0) < 0.01
