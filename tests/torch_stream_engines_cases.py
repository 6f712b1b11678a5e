"""The fused engines on the two phase-10 models against gen_tpu, on the
CPU, under injected randomness (rtol 2e-4).

- K1's plain version (``hmc_chains_fused`` on a CPU tensor) on the streamed
  robust-t regression (``benchmarks/bench_stream.py``'s model, n = 2,560)
  and on the collapsed Kalman logp (``tests/test_hmc_fused.py``'s
  ``_kalman_logp``, T = 3) against gen_tpu's plain reference
  ``_reference_hmc_injected``: the same accept decisions, values within
  2e-4.
- K3's and K6's plain versions (``nuts_chains_fused``) on both models
  against gen_tpu's ``nuts_fsm_paired`` and ``nuts_fsm`` under the same
  injected streams: equal completed counts, values within 2e-4.
- ``engine="auto"`` picks gen_tpu's engine for both, and says that the
  robust-t likelihood streams.
- ChEES warmup evaluates the population through ``batched_vag`` when one
  is given (the fused engines pass the staged kernel on the card).

gen_tpu's side runs in float32 (x64 off), as its kernel-vs-reference
tests do. The cases are split over ``test_torch_stream_engines_1.py`` and
``_2.py``."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.inference import sample as j_sample  # noqa: E402
from gen_tpu.inference.nuts_fsm import nuts_fsm as j_fsm  # noqa: E402
from gen_tpu.inference.nuts_fsm import nuts_fsm_paired as j_pair  # noqa: E402
from gen_tpu.inference.target import FlatTarget as JFlatTarget  # noqa: E402
from gen_tpu_torch.inference import FlatTarget  # noqa: E402
from gen_tpu_torch.inference import sample as t_sample  # noqa: E402
from gen_tpu_torch.inference.chees import chees_warmup_flat  # noqa: E402
from gen_tpu_torch.ops.hmc_fused import hmc_chains_fused  # noqa: E402
from gen_tpu_torch.ops.nuts_fused import nuts_chains_fused  # noqa: E402
from test_hmc_fused import (_kalman_logp, _reference_hmc_injected,  # noqa
                            _injected_rng)
from torch_port_models import (ROBUST_ADDRS, robust_data,  # noqa: E402
                               robust_models, torch_kalman_logp)

TOL = 2e-4
N_PTS = 2560


@functools.lru_cache(maxsize=None)
def _robust(n=N_PTS):
    """(gen_tpu trace, port trace, gen_tpu logp, port logp, start values
    near the posterior (n_chains, 3) in the flat order intercept,
    log_noise, slope)."""
    jm, tm, ys = robust_models(n)
    with jax.enable_x64(False):
        jtr, _ = jm.generate(jax.random.PRNGKey(0), (),
                             gt.choicemap(ys=jnp.asarray(ys)))
        jl = JFlatTarget(jtr, gt.select(*ROBUST_ADDRS)).logp
    ttr, _ = tm.generate(tt.random.PRNGKey(0, "cpu"), (),
                         tt.choicemap(ys=torch.from_numpy(ys)))
    tl = FlatTarget(ttr, tt.select(*ROBUST_ADDRS)).logp
    return jtr, ttr, jl, tl


def _start(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "robust":
        center = np.array([-0.4, np.log(0.5), 0.7], np.float32)
        return (center + 0.02 * rng.standard_normal((n, 3))
                ).astype(np.float32)
    return (0.2 * rng.standard_normal((n, 3))).astype(np.float32)


def _logps(kind):
    if kind == "robust":
        _, _, jl, tl = _robust()
        return jl, tl, 0.01
    return _kalman_logp(T=3), torch_kalman_logp(T=3), 0.4


@pytest.mark.parametrize("kind", ["robust", "kalman"])
def test_hmc_plain_version_matches_gen_tpu_reference(kind):
    jl, tl, eps = _logps(kind)
    n, n_steps, L = 64, 4, 3
    vals0 = _start(kind, n, 1)
    with jax.enable_x64(False):
        inj = _injected_rng(jax.random.PRNGKey(5), n_steps, n, 3, eps, 0.2)
        vr, cr, ar = _reference_hmc_injected(
            jax.jit(jl), jnp.asarray(vals0), *inj, L, jnp.ones(3), None)
        inj = tuple(np.asarray(x) for x in inj)
    before = hmc_chains_fused.launches
    v, c, a = hmc_chains_fused(
        tt.random.PRNGKey(1, "cpu"), tl, torch.from_numpy(vals0),
        n_steps=n_steps, L=L, eps=eps, collect_idx=None, injected_rng=inj)
    assert hmc_chains_fused.launches == before      # CPU: no kernel launch
    np.testing.assert_array_equal(a.numpy(), np.asarray(ar))
    assert 0 < a.sum() < n * n_steps
    np.testing.assert_allclose(v.numpy(), np.asarray(vr), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(cr), rtol=TOL, atol=TOL)


def _streams(seed, steps, n, d, n_u):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((steps, n, d)).astype(np.float32)
    us = [np.clip(rng.uniform(size=(steps, n)), 1e-6, 1 - 1e-6)
          .astype(np.float32) for _ in range(n_u)]
    return (z, *us)


@pytest.mark.parametrize("kind,paired", [("robust", True), ("robust", False),
                                         ("kalman", True)])
def test_nuts_plain_versions_match_gen_tpu(kind, paired):
    jl, tl, eps = _logps(kind)
    n, md = 48, 5
    steps = 12 if paired else 24
    vals0 = _start(kind, n, 2)
    inj = _streams(3, steps, n, 3, 7 if paired else 4)
    with jax.enable_x64(False):
        injc = tuple(jnp.moveaxis(jnp.asarray(x), 0, 1) for x in inj)
        if paired:
            def run(kk, t, *xs):
                return j_pair(kk, jax.value_and_grad(jl), t, eps, steps,
                              max_depth=md, injected_rng=xs, collect_idx=0,
                              ckpt_bf16=True)
        else:
            def run(kk, t, *xs):
                return j_fsm(kk, jax.value_and_grad(jl), t, eps, steps,
                             max_depth=md, num_sample_slots=8,
                             injected_rng=xs, collect_idx=0, ckpt_bf16=True)
        res, (hj, hcj) = jax.jit(jax.vmap(run))(
            jax.random.split(jax.random.PRNGKey(2), n), jnp.asarray(vals0),
            *injc)
    v, hist, hcnt, cnt, _ = nuts_chains_fused(
        tt.random.PRNGKey(1, "cpu"), tl, torch.from_numpy(vals0),
        num_ticks=2 * steps if paired else steps, eps=eps, max_depth=md,
        collect_idx=0, injected_rng=inj, paired=paired)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(res.counts))
    np.testing.assert_array_equal(hcnt.numpy(), np.asarray(hcj).T)
    assert cnt.min() > 0
    np.testing.assert_allclose(v.numpy(), np.asarray(res.theta), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(hist.numpy(), np.asarray(hj).T, rtol=TOL,
                               atol=TOL)


def test_auto_engine_matches_gen_tpu_on_both_models():
    jtr, ttr, _, _ = _robust()
    ys = robust_data(N_PTS)[1]
    sel_j, sel_t = gt.select(*ROBUST_ADDRS), tt.select(*ROBUST_ADDRS)
    with jax.enable_x64(False):
        j_eng, _ = j_sample._auto_engine(
            jtr, gt.choicemap(ys=jnp.asarray(ys)), sel_j, 8)
    t_eng, reason = t_sample._auto_engine(
        ttr, tt.choicemap(ys=torch.from_numpy(ys)), sel_t, 8)
    assert t_eng == j_eng == "nuts_fused"
    assert f"streams {N_PTS} data points (2 rows)" in reason

    from gen_tpu.models import lgssm as j_lgssm
    from gen_tpu_torch.models import lgssm as t_lgssm
    y6 = np.random.default_rng(0).standard_normal((6, 1)).astype(np.float32)

    def ar1(g, lib, lg):
        eye1 = lib.eye(1, dtype=lib.float32)

        @g.gen
        def model():
            phi = g.normal(0.0, 1.0) @ "phi"
            log_q = g.normal(-1.0, 1.0) @ "log_q"
            log_r = g.normal(-1.0, 1.0) @ "log_r"
            lg(6)(phi * eye1, lib.exp(log_q) * eye1, eye1,
                  lib.exp(log_r) * eye1, lib.zeros(1, dtype=lib.float32),
                  2.0 * eye1) @ "ys"
        return model

    with jax.enable_x64(False):
        jm = ar1(gt, jnp, j_lgssm)
        obs_j = gt.choicemap(ys=jnp.asarray(y6))
        jtr, _ = jm.generate(jax.random.PRNGKey(0), (), obs_j)
        j_eng, _ = j_sample._auto_engine(jtr, obs_j, gt.select(
            "phi", "log_q", "log_r"), 8)
    tm = ar1(tt, torch, t_lgssm)
    obs_t = tt.choicemap(ys=torch.from_numpy(y6))
    ttr, _ = tm.generate(tt.random.PRNGKey(0, "cpu"), (), obs_t)
    assert t_sample._auto_engine(ttr, obs_t, tt.select(
        "phi", "log_q", "log_r"), 8) == (j_eng, "scalarization probe passed")


def test_chees_warmup_takes_a_batched_evaluator():
    @tt.gen
    def gauss():
        tt.normal(torch.zeros(3), torch.tensor([1.0, 2.0, 0.5])) @ "x"

    target = FlatTarget(gauss.generate(tt.random.PRNGKey(0, "cpu"), (),
                                       tt.choicemap())[0], tt.select("x"))
    xs0 = torch.from_numpy(_start("kalman", 16, 4))
    calls = []
    vg = torch.func.vmap(target.value_and_grad)

    def batched(x):
        calls.append(x.shape)
        return vg(x)

    key = tt.random.PRNGKey(3, "cpu")
    a = chees_warmup_flat(key, target.value_and_grad, xs0, num_warmup=6,
                          num_samples=2)
    b = chees_warmup_flat(key, target.value_and_grad, xs0, num_warmup=6,
                          num_samples=2, batched_vag=batched)
    assert calls and all(s == (16, 3) for s in calls)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)
    # on the CPU the fused engines' warmup vmaps the torch logp
    for dtype in (torch.float32, torch.float64):
        assert t_sample._staged_population_vag(target, dtype) is None
