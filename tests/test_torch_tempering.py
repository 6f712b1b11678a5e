"""gen_tpu_torch's tempering samplers and PSIS against gen_tpu's, under the
same keys, in float64, on tests/test_tempering.py's conjugate Gaussian
model (20 observations, prior sd 3, noise sd 1) and its bimodal model.

PSIS (smoothed weights, k-hat, tail length), ``gpd_fit`` and the tempered
target's prior and likelihood are deterministic and agree within 1e-12.
The samplers run short ladders (3-5 rungs, 64-256 particles): particle
positions, log weights and log-ML estimates agree within 1e-9 relative,
the adaptive ladder's stages and betas too, and resampling parents are
equal. (float64 normals differ from XLA's by ~1e-14 relative: torch's
erfinv; a leapfrog trajectory carries that through its accept test.)
The statistical gates of tests/test_tempering.py run on the card in
chip_smoke.py's phase 11 (a)-(d), at 131,072 particles.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.inference import tempering as jtemp  # noqa: E402
from gen_tpu_torch.inference import tempering as ttemp  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

# the packages export a function psis beside the module of that name
jpsis = importlib.import_module("gen_tpu.inference.psis")
tpsis = importlib.import_module("gen_tpu_torch.inference.psis")

EXACT = 1e-12
SAMPLER = 1e-9
N_OBS = 20
YS = np.random.default_rng(1).normal(2.0, 1.0, N_OBS)
BETAS = np.asarray([0.05, 0.2, 0.5, 1.0])


def _models(g, ones):
    @g.gen
    def gauss_model():
        mu = g.normal(0.0, 3.0) @ "mu"
        g.normal(mu * ones, 1.0) @ "ys"

    @g.gen
    def bimodal_model():
        x = g.normal(0.0, 3.0) @ "x"
        g.normal(x * x, 0.5) @ "y"

    return gauss_model, bimodal_model


J_GAUSS, J_BI = _models(gt, jnp.ones(N_OBS))
T_GAUSS, T_BI = _models(tt, torch.ones(N_OBS, dtype=torch.float64))


def jkey(s):
    return jax.random.PRNGKey(s)


def tkey(s):
    return tt.random.PRNGKey(s, "cpu")


def close(t, j, rtol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=rtol * 1e-2, equal_nan=False)


def traces(bimodal=False):
    """gen_tpu's and the port's template traces (observations constrained),
    and the latent selections."""
    if bimodal:
        jtr, _ = J_BI.generate(jkey(0), (), gt.choicemap(y=4.0))
        with float64_default():
            ttr, _ = T_BI.generate(tkey(0), (), tt.choicemap(
                y=torch.tensor(4.0)))
        return jtr, ttr, gt.select("x"), tt.select("x")
    jtr, _ = J_GAUSS.generate(jkey(0), (), gt.choicemap(ys=jnp.asarray(YS)))
    with float64_default():
        ttr, _ = T_GAUSS.generate(tkey(0), (), tt.choicemap(
            ys=torch.from_numpy(YS)))
    return jtr, ttr, gt.select("mu"), tt.select("mu")


def gaussian_log_ratios(s, n, seed):
    """tests/test_psis.py's log importance ratios (k = 1 - s^2)."""
    x = np.random.default_rng(seed).normal(0, s, n)
    return -0.5 * x ** 2 + 0.5 * (x / s) ** 2 + np.log(s)


@pytest.mark.parametrize("case", ["heavy", "light", "degenerate", "short"])
def test_psis_matches_gen_tpu(case):
    """Smoothed log weights, k-hat, tail length and ESS; gpd_fit on the
    sorted exceedances of the heavy case."""
    lw = {"heavy": gaussian_log_ratios(0.6, 5000, 0),
          "light": gaussian_log_ratios(1.5, 3000, 1),
          "degenerate": np.zeros(400),
          "short": gaussian_log_ratios(0.7, 12, 2)}[case]
    j = jax.jit(jpsis.psis)(jnp.asarray(lw))
    t = tpsis.psis(torch.from_numpy(lw))
    close(t.log_weights, j.log_weights, EXACT)
    assert t.tail_len == j.tail_len
    if np.isfinite(float(j.khat)):
        close(t.khat, j.khat, EXACT)
    else:
        assert float(t.khat) == float(j.khat) == -np.inf
    close(tpsis.psis_effective_sample_size(t.log_weights),
          jax.jit(jpsis.psis_effective_sample_size)(j.log_weights), EXACT)
    if case == "heavy":
        x = np.sort(np.exp(lw - lw.max()))[-200:]
        x = x - x[0] + 1e-6
        jk, js = jax.jit(jpsis.gpd_fit)(jnp.asarray(x))
        tk, ts = tpsis.gpd_fit(torch.from_numpy(x))
        close(tk, jk, EXACT)
        close(ts, js, EXACT)


def test_tempered_target_and_hmc_step():
    """prior and likelihood of the tempered target at a few latents, and
    one tempered-HMC trajectory (L=5) from each."""
    jtr, ttr, jsel, tsel = traces()
    jtarget = jtemp.TemperedTarget(jtr, jsel)
    j_prior_lik = jax.jit(jtarget.prior_lik)
    j_step = jax.jit(lambda k, f: jtemp._tempered_hmc_step(
        k, f, jtarget, 0.4, 5, 0.1))
    with float64_default():
        ttarget = ttemp.TemperedTarget(ttr, tsel)
        for i, mu in enumerate((-1.0, 0.3, 2.2)):
            jp, jl = j_prior_lik(jnp.asarray([mu]))
            tp, tl = ttarget.prior_lik(torch.tensor([mu]))
            close(tp, jp, EXACT)
            close(tl, jl, EXACT)
            jn, ja = j_step(jkey(i), jnp.asarray([mu]))
            tn, ta = ttemp._tempered_hmc_step(tkey(i), torch.tensor([mu]),
                                              ttarget, 0.4, 5, 0.1)
            close(tn, jn, SAMPLER)
            assert bool(ta) == bool(ja)


def test_ais_matches_gen_tpu():
    jtr, ttr, jsel, tsel = traces()
    jf, jw, jl = jtemp.ais(jkey(3), jtr, jsel, jnp.asarray(BETAS), 64, L=3,
                           eps=0.1, moves_per_rung=2)
    with float64_default():
        tf, tw, tl = ttemp.ais(tkey(3), ttr, tsel, torch.from_numpy(BETAS),
                               64, L=3, eps=0.1, moves_per_rung=2)
    close(tf, jf, SAMPLER)
    close(tw, jw, SAMPLER)
    close(tl, jl, SAMPLER)


@pytest.mark.parametrize("method", ["systematic", "multinomial"])
def test_smc_sampler_matches_gen_tpu(method):
    """Resampling triggers at every rung here (the likelihood of 20
    observations is sharp), through K4's plain version for systematic."""
    jtr, ttr, jsel, tsel = traces()
    jf, jw, jl = jtemp.smc_sampler(jkey(4), jtr, jsel, jnp.asarray(BETAS),
                                   128, L=3, eps=0.1, moves_per_rung=2,
                                   resample_method=method)
    with float64_default():
        tf, tw, tl = ttemp.smc_sampler(tkey(4), ttr, tsel,
                                       torch.from_numpy(BETAS), 128, L=3,
                                       eps=0.1, moves_per_rung=2,
                                       resample_method=method)
    close(tf, jf, SAMPLER)
    close(tw, jw, SAMPLER)
    close(tl, jl, SAMPLER)


def test_smc_sampler_adaptive_matches_gen_tpu():
    jtr, ttr, jsel, tsel = traces()
    jf, jl, jn, jb = jtemp.smc_sampler_adaptive(
        jkey(5), jtr, jsel, 256, target_ess=0.6, max_stages=16, L=3,
        eps=0.1)
    with float64_default():
        tf, tl, tn, tb = ttemp.smc_sampler_adaptive(
            tkey(5), ttr, tsel, 256, target_ess=0.6, max_stages=16, L=3,
            eps=0.1)
    assert tn == int(jn) and 1 < tn < 16
    close(tb[:tn], jb[:tn], SAMPLER)
    assert float(tb[tn - 1]) == 1.0 and np.all(np.isnan(tb[tn:].numpy()))
    close(tf, jf, SAMPLER)
    close(tl, jl, SAMPLER)


def test_parallel_tempering_matches_gen_tpu():
    jtr, ttr, jsel, tsel = traces(bimodal=True)
    betas = np.asarray([0.02, 0.06, 0.15, 0.35, 0.65, 1.0])
    js, jr = jtemp.parallel_tempering(jkey(6), jtr, jsel, jnp.asarray(betas),
                                      n_sweeps=40, L=8, eps=0.15, thin=2)
    with float64_default():
        ts, tr = ttemp.parallel_tempering(tkey(6), ttr, tsel,
                                          torch.from_numpy(betas),
                                          n_sweeps=40, L=8, eps=0.15, thin=2)
    assert ts.shape == (20, 1)
    close(ts, js, SAMPLER)
    close(tr, jr, EXACT)
    assert 0.0 < float(tr) <= 1.0
