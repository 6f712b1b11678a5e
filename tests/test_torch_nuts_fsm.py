"""The one-leapfrog-per-tick FSM-NUTS of the port against gen_tpu.

- ``nuts_fsm`` equals gen_tpu's vmapped ``nuts_fsm`` under the same
  injected streams on gen_tpu's three kernel configurations (a correlated
  4-d Gaussian, the divergence paths at eps 0.9 / threshold 4, a frozen
  coordinate), with and without bf16 checkpoints, in float64: every count
  equal, values within 1e-12 (the two differ only in the order of the
  coordinate sums).
- Under the same keys (float64 on both sides; the port's float64 normals
  follow XLA's erf_inv within 3 ulp, so no decision flips): slots,
  position mean and variance, the collected streams for ``collect_idx``
  int, ``"all"`` and None, and the frozen coordinate, within 1e-12
  relative.
- ``nuts_fsm_warmup_and_sample`` under the same key with per-chain step
  sizes and inverse masses, a frozen coordinate included.
- The one-leapfrog schedule samples the right distribution: completed
  draws of a 3-d anisotropic Gaussian within 6% of the exact variances, the
  multi-dimensional check that catches a wrong checkpoint momentum.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu_torch as tt  # noqa: E402
from gen_tpu_torch.ops.nuts_fused import extract_completed_draws  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

j_fsm = importlib.import_module("gen_tpu.inference.nuts_fsm")
t_fsm = importlib.import_module("gen_tpu_torch.inference.nuts_fsm")

SDS = np.array([1.0, 3.0, 0.5, 2.0])
# name -> (eps, max_depth, divergence threshold, inverse mass, coupling
# terms (a, i, j) of -a x_i x_j, ticks, stream seed)
CONFIGS = {
    "gaussian": (0.45, 5, 1000.0, SDS ** 2, ((0.3, 0, 2), (0.1, 1, 3)), 80,
                 11),
    "divergence": (0.9, 5, 4.0, None, ((0.3, 0, 2),), 80, 7),
    "frozen": (0.5, 5, 1000.0, SDS ** 2 * np.array([1, 1, 0, 1]),
               ((0.3, 0, 2), (0.1, 1, 2)), 48, 3),
}


def _logps(coupling, sds=SDS):
    def make(sum_, s):
        def logp(x):
            out = -0.5 * sum_((x / s) ** 2)
            for a, i, j in coupling:
                out = out - a * x[i] * x[j]
            return out
        return logp

    return make(jnp.sum, jnp.asarray(sds)), make(torch.sum,
                                                 torch.tensor(sds))


def _vag_t(logp):
    gv = torch.func.grad_and_value(logp)

    def vag(x):
        g, v = gv(x)
        return v, g
    return vag


def _streams(seed, ticks, n, d):
    """gen_tpu's 5 injected streams, made by numpy: z (ticks, n, d) and 4
    uniforms (ticks, n) kept inside [1e-6, 1 - 1e-6]."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((ticks, n, d))
    us = [np.clip(rng.uniform(size=(ticks, n)), 1e-6, 1 - 1e-6)
          for _ in range(4)]
    return (z, *us)


def _jax_fsm(keys, vals0, eps, ticks, inv=None, inj=None, **kw):
    """gen_tpu's nuts_fsm vmapped over chains (float64, x64 mode)."""
    lj = kw.pop("logp")
    vag = jax.value_and_grad(lj)
    im = None if inv is None else jnp.asarray(inv)
    if inj is None:
        return jax.jit(jax.vmap(lambda k, t: j_fsm.nuts_fsm(
            k, vag, t, eps, ticks, inv_mass_diag=im, **kw)))(
            keys, jnp.asarray(vals0))
    injc = tuple(jnp.moveaxis(jnp.asarray(x), 0, 1) for x in inj)
    return jax.jit(jax.vmap(lambda k, t, *xs: j_fsm.nuts_fsm(
        k, vag, t, eps, ticks, inv_mass_diag=im, injected_rng=xs, **kw)))(
        keys, jnp.asarray(vals0), *injc)


@pytest.mark.parametrize("ckpt_bf16", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_nuts_fsm_injected_matches_gen_tpu(name, ckpt_bf16):
    eps, md, thr, inv, coupling, ticks, seed = CONFIGS[name]
    n, d = 64, 4
    vals0 = np.random.default_rng(0).standard_normal((n, d)) * SDS
    inj = _streams(seed, ticks, n, d)
    lj, lt = _logps(coupling)
    kw = dict(max_depth=md, divergence_threshold=thr, collect_idx=2,
              num_sample_slots=8, ckpt_bf16=ckpt_bf16)
    rj, (hj, hcj) = _jax_fsm(jax.random.split(jax.random.PRNGKey(2), n),
                             vals0, eps, ticks, inv, inj, logp=lj, **kw)
    with float64_default():
        rt, (ht, hct) = t_fsm.nuts_fsm(
            None, _vag_t(lt), torch.tensor(vals0), eps, ticks,
            inv_mass_diag=None if inv is None else torch.tensor(inv),
            injected_rng=inj, **kw)
    np.testing.assert_array_equal(rt.counts.numpy(), np.asarray(rj.counts))
    np.testing.assert_array_equal(hct.numpy(), np.asarray(hcj).T)
    np.testing.assert_array_equal(rt.num_divergent.numpy(),
                                  np.asarray(rj.num_divergent))
    for a, b in ((rt.theta, rj.theta), (ht, np.asarray(hj).T),
                 (rt.slots, rj.slots), (rt.mean_accept, rj.mean_accept),
                 (rt.mean_depth, rj.mean_depth), (rt.pos_mean, rj.pos_mean),
                 (rt.pos_var, rj.pos_var)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    assert rt.counts.min() > 0
    if name == "divergence":
        assert int(rt.num_divergent.sum()) > 50
    if name == "frozen":
        np.testing.assert_array_equal(rt.theta[:, 2].numpy(), vals0[:, 2])
        assert float(rt.pos_var[:, 2].abs().max()) == 0.0


@pytest.mark.parametrize("collect_idx", [1, "all", None])
def test_nuts_fsm_same_keys_matches_gen_tpu(collect_idx):
    """Own randomness: the port's threefry keys equal jax.random's, so the
    chains take the same paths; slots, positions and streams agree."""
    eps, md, thr, inv, coupling, _, _ = CONFIGS["frozen"]
    n, d, ticks = 32, 4, 60
    vals0 = np.random.default_rng(1).standard_normal((n, d)) * SDS
    lj, lt = _logps(coupling)
    kw = dict(max_depth=md, collect_idx=collect_idx, num_sample_slots=6)
    out_j = _jax_fsm(jax.random.split(jax.random.PRNGKey(3), n), vals0, eps,
                     ticks, inv, logp=lj, **kw)
    with float64_default():
        out_t = t_fsm.nuts_fsm(
            tt.random.split(tt.random.PRNGKey(3, "cpu"), n), _vag_t(lt),
            torch.tensor(vals0), eps, ticks, inv_mass_diag=torch.tensor(inv),
            **kw)
    rj, rt = (out_j, out_t) if collect_idx is None else (out_j[0], out_t[0])
    np.testing.assert_array_equal(rt.counts.numpy(), np.asarray(rj.counts))
    for a, b in ((rt.theta, rj.theta), (rt.slots, rj.slots),
                 (rt.pos_mean, rj.pos_mean), (rt.pos_var, rj.pos_var),
                 (rt.mean_accept, rj.mean_accept)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-10)
    if collect_idx is not None:
        (ht, hct), (hj, hcj) = out_t[1], out_j[1]
        np.testing.assert_array_equal(hct.numpy(), np.asarray(hcj).T)
        np.testing.assert_allclose(ht.numpy(), np.swapaxes(np.asarray(hj),
                                                           0, 1),
                                   rtol=1e-12, atol=1e-10)
        assert ht.shape == ((ticks, n) if collect_idx == 1
                            else (ticks, n, d))
    # the frozen coordinate never moves, in the state and in every slot
    np.testing.assert_array_equal(rt.theta[:, 2].numpy(), vals0[:, 2])
    filled = np.arange(6)[None, :] < np.minimum(rt.counts.numpy(), 6)[:, None]
    np.testing.assert_array_equal(
        rt.slots[:, :, 2].numpy()[filled],
        np.broadcast_to(vals0[:, 2:3], filled.shape)[filled])


def test_warmup_and_sample_matches_gen_tpu():
    """Per-chain step sizes and inverse masses adapted in three stages, a
    frozen coordinate through all of them; float64 on both sides."""
    sds = np.array([0.2, 1.0, 4.0])
    lj, lt = _logps((), sds)
    n, d = 16, 3
    vals0 = np.random.default_rng(5).standard_normal((n, d)) * sds
    mask = np.array([1.0, 0.0, 1.0])
    kw = dict(num_warmup_ticks=96, num_ticks=40, warmup_chunks=4,
              max_depth=5, num_sample_slots=8)
    rj, ij = jax.jit(jax.vmap(lambda k, t: j_fsm.nuts_fsm_warmup_and_sample(
        k, jax.value_and_grad(lj), t, free_mask=jnp.asarray(mask), **kw)))(
        jax.random.split(jax.random.PRNGKey(7), n), jnp.asarray(vals0))
    with float64_default():
        rt, it = t_fsm.nuts_fsm_warmup_and_sample(
            tt.random.split(tt.random.PRNGKey(7, "cpu"), n), _vag_t(lt),
            torch.tensor(vals0), free_mask=torch.tensor(mask), **kw)
    for k in ("step_size", "inv_mass_diag", "mean_accept"):
        np.testing.assert_allclose(it[k].numpy(), np.asarray(ij[k]),
                                   rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(rt.counts.numpy(), np.asarray(rj.counts))
    for a, b in ((rt.theta, rj.theta), (rt.slots, rj.slots),
                 (rt.pos_var, rj.pos_var), (rt.mean_depth, rj.mean_depth)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=1e-10)
    assert it["step_size"].shape == (n,) and it["inv_mass_diag"].shape == (
        n, d)
    assert len(set(it["step_size"].tolist())) > 1   # each chain adapts
    assert float(it["inv_mass_diag"][:, 1].abs().max()) == 0.0
    np.testing.assert_array_equal(rt.theta[:, 1].numpy(), vals0[:, 1])


def test_tick_schedule_moments_match_exact():
    """Completed draws of ``nuts_fsm``, own randomness, bf16 checkpoints as
    the kernel K6 has them, on an anisotropic 3-d Gaussian: variances within
    6% and means within 0.05 sd (gen_tpu's gate; a checkpoint that stored
    the pre-block momentum gives ~10% low variances here)."""
    sds = torch.tensor([1.0, 3.0, 0.5])
    n, ticks = 1024, 500
    vals0 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n, 3)).astype(np.float32)) * sds
    keys = tt.random.split(tt.random.PRNGKey(1, "cpu"), n)
    res, (hist, hcnt) = t_fsm.nuts_fsm(
        keys, _vag_t(lambda x: -0.5 * torch.sum((x / sds) ** 2)), vals0,
        0.5, ticks, max_depth=6, inv_mass_diag=sds ** 2, collect_idx="all",
        num_sample_slots=0, ckpt_bf16=True)
    m = int(res.counts.min())
    assert m > 40
    draws = extract_completed_draws(hist, hcnt, m)[m // 4:].double()
    np.testing.assert_allclose(draws.var(dim=(0, 1)).numpy(),
                               (sds ** 2).numpy(), rtol=0.06)
    assert float((draws.mean(dim=(0, 1)) / sds).abs().max()) < 0.05
