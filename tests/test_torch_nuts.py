"""NUTS, dual averaging and ChEES warmup of the port against gen_tpu.

- ``bf16_round``/``bf16_pack2``/``bf16_unpack2`` equal gen_tpu's bit for
  bit on random, tie and NaN inputs (the fused NUTS kernel's checkpoint
  packing rounds with the same integer arithmetic).
- ``da_update``, ``find_reasonable_step_size``, ``nuts_flat``,
  ``chees_warmup_flat``, ``chees_hmc_warmup_and_sample`` and
  ``nuts_warmup_and_sample`` under the same keys. The port's ``random``
  equals ``jax.random`` bit for bit on bits and uniforms, and float64
  normals within 3 ulp (XLA's erf_inv), so these run in float64 on both
  sides (JAX x64, torch's default dtype float64), where a 1-ulp
  difference cannot flip a decision; tolerance 1e-12 relative. gen_tpu's
  side runs jitted.
- ``autocorr_ess`` on ``torch.fft`` equals ``bench.py``'s numpy version.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu.utils as j_utils  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu_torch import utils as t_utils  # noqa: E402
from gen_tpu_torch.diagnostics import autocorr_ess  # noqa: E402
from torch_port_models import (SCHOOL_ADDRS, SIGMAS_8, YS_8,  # noqa: E402
                               float64_default, jax_eight_schools,
                               torch_eight_schools)

# by module path: the packages export functions named like the modules
j_nuts = importlib.import_module("gen_tpu.inference.nuts")
j_chees = importlib.import_module("gen_tpu.inference.chees")
t_nuts = importlib.import_module("gen_tpu_torch.inference.nuts")
t_chees = importlib.import_module("gen_tpu_torch.inference.chees")

RTOL = 1e-12
SDS = np.array([1.0, 3.0, 0.5])


def _logps():
    sj, st = jnp.asarray(SDS), torch.tensor(SDS)
    return (lambda x: -0.5 * jnp.sum((x / sj) ** 2) - 0.3 * x[0] * x[2],
            lambda x: -0.5 * torch.sum((x / st) ** 2) - 0.3 * x[0] * x[2])


def _vag_t(logp):
    gv = torch.func.grad_and_value(logp)

    def vag(x):
        g, v = gv(x)
        return v, g
    return vag


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _bf16_inputs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)
         ).astype(np.float32)
    # ties (low half exactly 0x8000, both parities of bit 16), NaNs with
    # an all-ones mantissa (the sign-carry artifact), infinities, zeros
    ties = (np.arange(256, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    special = np.array([0xFFFFFFFF, 0x7FFFFFFF, 0x7FC00000, 0x7F800000,
                        0xFF800000, 0x80000000, 0, 0x7F7FFFFF],
                       np.uint32).view(np.float32)
    return np.concatenate([x, ties, special])


def test_bf16_helpers_bit_exact():
    x = _bf16_inputs()
    y = np.roll(x, 7)
    with jax.enable_x64(False):
        r_j = _bits(j_utils.bf16_round(jnp.asarray(x)))
        p_j = np.asarray(j_utils.bf16_pack2(jnp.asarray(x), jnp.asarray(y)))
        a_j, b_j = map(_bits, j_utils.bf16_unpack2(jnp.asarray(p_j)))
    r_t = _bits(t_utils.bf16_round(torch.from_numpy(x)).numpy())
    p_t = t_utils.bf16_pack2(torch.from_numpy(x), torch.from_numpy(y))
    a_t, b_t = (_bits(v.numpy()) for v in t_utils.bf16_unpack2(p_t))
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_array_equal(p_t.numpy(), p_j)
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(b_t, b_j)
    # the round trip is bf16_round exactly, NaN carries included
    np.testing.assert_array_equal(a_t, r_t)
    np.testing.assert_array_equal(
        b_t, _bits(t_utils.bf16_round(torch.from_numpy(y)).numpy()))
    finite = np.isfinite(x)
    np.testing.assert_array_equal(
        r_t[finite], _bits(torch.from_numpy(x[finite]).bfloat16().float()
                           .numpy()))


def test_da_update_sequence_matches():
    accepts = np.random.default_rng(1).uniform(size=40)
    sj = j_nuts.da_init(0.3)
    with float64_default():
        st = t_nuts.da_init(0.3)
        for a in accepts:
            sj = j_nuts.da_update(sj, a, 0.8)
            st = t_nuts.da_update(st, torch.tensor(a), 0.8)
            for x, y in zip(st, sj):
                np.testing.assert_allclose(float(x), float(y), rtol=1e-13)


@pytest.mark.parametrize("seed", [0, 3])
def test_find_reasonable_step_size_matches(seed):
    lj, lt = _logps()
    x0 = np.random.default_rng(seed).standard_normal(3) * SDS * 3.0
    e_j = j_nuts.find_reasonable_step_size(
        jax.random.PRNGKey(seed), jax.value_and_grad(lj), jnp.asarray(x0))
    with float64_default():
        e_t = t_nuts.find_reasonable_step_size(
            tt.random.PRNGKey(seed, "cpu"), _vag_t(lt), torch.tensor(x0))
    assert float(e_t) == float(e_j)


def test_nuts_flat_matches():
    lj, lt = _logps()
    n = 16
    x0 = np.random.default_rng(2).standard_normal((n, 3)) * SDS
    keys_j = jax.random.split(jax.random.PRNGKey(3), n)
    th_j, s_j = jax.jit(jax.vmap(lambda k, x: j_nuts.nuts_flat(
        k, jax.value_and_grad(lj), x, 0.4, max_depth=6,
        inv_mass_diag=jnp.asarray(SDS ** 2))))(keys_j, jnp.asarray(x0))
    with float64_default():
        th_t, s_t = t_nuts.nuts_flat(
            tt.random.split(tt.random.PRNGKey(3, "cpu"), n), _vag_t(lt),
            torch.tensor(x0), 0.4, max_depth=6,
            inv_mass_diag=torch.tensor(SDS ** 2))
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_array_equal(s_t.depth.numpy(), np.asarray(s_j.depth))
    np.testing.assert_array_equal(s_t.num_leapfrogs.numpy(),
                                  np.asarray(s_j.num_leapfrogs))
    np.testing.assert_array_equal(s_t.diverging.numpy(),
                                  np.asarray(s_j.diverging))
    np.testing.assert_allclose(s_t.accept_prob.numpy(),
                               np.asarray(s_j.accept_prob), rtol=RTOL)
    assert len(set(s_t.depth.tolist())) > 1      # chains took their own paths


def test_chees_warmup_flat_matches():
    lj, lt = _logps()
    x0 = np.random.default_rng(1).standard_normal((64, 3)) * SDS * 2.0
    kw = dict(num_warmup=30, num_samples=2, target_accept=0.8)
    sm_j, xs_j, info_j = jax.jit(lambda k, x: j_chees.chees_warmup_flat(
        k, jax.value_and_grad(lj), x, **kw))(jax.random.PRNGKey(5),
                                             jnp.asarray(x0))
    with float64_default():
        sm_t, xs_t, info_t = t_chees.chees_warmup_flat(
            tt.random.PRNGKey(5, "cpu"), _vag_t(lt), torch.tensor(x0), **kw)
    for k in ("step_size", "trajectory_length", "mean_accept", "inv_mass"):
        np.testing.assert_allclose(np.asarray(info_t[k]),
                                   np.asarray(info_j[k]), rtol=RTOL)
    assert info_t["num_leapfrogs"] == int(info_j["num_leapfrogs"])
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(sm_t.numpy(), np.asarray(sm_j), rtol=RTOL,
                               atol=1e-12)


def test_chees_hmc_warmup_and_sample_on_eight_schools():
    """The entry point on a batch of traces from a vmapped ``generate``;
    the frozen mask path (no teleport) as well."""
    n = 32
    kw = dict(num_warmup=6, num_samples=1, target_accept=0.8)
    traces_j, _ = jax.vmap(lambda k: jax_eight_schools.generate(
        k, (jnp.asarray(SIGMAS_8),), gt.choicemap(ys=jnp.asarray(YS_8))))(
        jax.random.split(jax.random.PRNGKey(0), n))
    mask = np.ones(10)
    mask[3] = 0.0
    run_j = jax.jit(lambda k, tr, m: j_chees.chees_hmc_warmup_and_sample(
        k, tr, gt.select(*SCHOOL_ADDRS), free_mask=m, **kw))
    out_j = run_j(jax.random.PRNGKey(1), traces_j, None)
    outm_j = run_j(jax.random.PRNGKey(1), traces_j, jnp.asarray(mask))
    with float64_default():
        traces_t, _ = torch.func.vmap(
            lambda k: torch_eight_schools.generate(
                k, (torch.tensor(SIGMAS_8),),
                tt.choicemap(ys=torch.tensor(YS_8))))(
            tt.random.split(tt.random.PRNGKey(0, "cpu"), n))
        out_t = t_chees.chees_hmc_warmup_and_sample(
            tt.random.PRNGKey(1, "cpu"), traces_t, tt.select(*SCHOOL_ADDRS),
            **kw)
        outm_t = t_chees.chees_hmc_warmup_and_sample(
            tt.random.PRNGKey(1, "cpu"), traces_t, tt.select(*SCHOOL_ADDRS),
            free_mask=torch.tensor(mask), **kw)
    for (sj, xj, ij), (st, xt, it) in ((out_j, out_t), (outm_j, outm_t)):
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12,
                                   atol=1e-10)
        for k in ("step_size", "trajectory_length", "inv_mass"):
            np.testing.assert_allclose(np.asarray(it[k]), np.asarray(ij[k]),
                                       rtol=1e-12)
    assert float(outm_t[2]["inv_mass"][3]) == 0.0


def test_nuts_warmup_and_sample_matches():
    kw = dict(num_warmup=8, num_samples=4, max_depth=5)
    tr_j, _ = jax_eight_schools.generate(
        jax.random.PRNGKey(4), (jnp.asarray(SIGMAS_8),),
        gt.choicemap(ys=jnp.asarray(YS_8)))
    s_j, ftr_j, info_j = jax.jit(lambda k, tr: j_nuts.nuts_warmup_and_sample(
        k, tr, gt.select(*SCHOOL_ADDRS), **kw))(jax.random.PRNGKey(6), tr_j)
    with float64_default():
        tr_t, _ = torch_eight_schools.generate(
            tt.random.PRNGKey(4, "cpu"), (torch.tensor(SIGMAS_8),),
            tt.choicemap(ys=torch.tensor(YS_8)))
        s_t, ftr_t, info_t = t_nuts.nuts_warmup_and_sample(
            tt.random.PRNGKey(6, "cpu"), tr_t, tt.select(*SCHOOL_ADDRS),
            **kw)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-12,
                               atol=1e-10)
    np.testing.assert_allclose(float(info_t["step_size"]),
                               float(info_j["step_size"]), rtol=1e-12)
    assert int(info_t["total_leapfrogs"]) == int(info_j["total_leapfrogs"])
    np.testing.assert_allclose(float(ftr_t.get_score()),
                               float(ftr_j.get_score()), rtol=1e-12)


def test_autocorr_ess_matches_numpy():
    import bench
    rng = np.random.default_rng(2)
    n, m = 300, 70
    x = np.zeros((n, m))
    for t in range(1, n):               # AR(1) chains of varying memory
        x[t] = np.linspace(0.0, 0.9, m) * x[t - 1] + rng.standard_normal(m)
    x[:, 5] = 1.0                       # a stuck chain counts 1
    ref = bench.autocorr_ess(x, block=32)
    np.testing.assert_allclose(autocorr_ess(torch.tensor(x), block=32), ref,
                               rtol=1e-10)
    np.testing.assert_allclose(
        autocorr_ess(torch.tensor(x, dtype=torch.float32)),
        bench.autocorr_ess(x.astype(np.float32)), rtol=1e-10)
