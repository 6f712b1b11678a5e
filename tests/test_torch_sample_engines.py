"""Every engine of the port's ``sample_posterior`` against exact posteriors
on small conjugate models, at gen_tpu's own tolerances
(``tests/test_sample_api.py``), on the CPU (the fused engines run their
kernels' plain versions there).

- Each engine recovers the conjugate-normal posterior: mean and sd within
  0.04 (gen_tpu's engine tests), split-R-hat below 1.05.
- Partial selections condition each chain on its own frozen value: the
  standardized residual of the conditional posterior is N(0, 1) within
  0.08 across chains and draws (gen_tpu's test), and the frozen value
  never moves.
- ``mass="dense"`` and ``mass="lowrank"`` on a correlated Gaussian: means
  within a quarter of the largest posterior sd (x4) and sds within 25%,
  gen_tpu's tolerances for the same test.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import gen_tpu_torch as tt  # noqa: E402
from gen_tpu_torch.inference import sample_posterior  # noqa: E402

N_OBS, SIGMA, PRIOR_SD = 20, 1.0, 3.0
YS = torch.full((N_OBS,), 2.0)
POST_PREC = 1 / PRIOR_SD ** 2 + N_OBS / SIGMA ** 2
POST_MEAN = float(YS.sum()) / SIGMA ** 2 / POST_PREC
POST_SD = 1 / np.sqrt(POST_PREC)


@tt.gen
def conjugate(n):
    mu = tt.normal(0.0, PRIOR_SD) @ "mu"
    tt.normal(mu * torch.ones(n), SIGMA) @ "ys"


# engine -> budget; each enough for gen_tpu's 0.04 tolerance on this model
ENGINES = {
    "nuts": dict(num_chains=8, num_warmup=80, num_samples=50),
    "chees": dict(num_chains=16, num_warmup=200, num_samples=200),
    "hmc_fused": dict(num_chains=16, num_warmup=200, num_samples=200),
    "nuts_fused": dict(num_chains=16, num_warmup=200, num_samples=128,
                       num_ticks=768),
    "nuts_fsm": dict(num_chains=8, num_samples=128, num_ticks=384),
    "auto": dict(num_chains=8, num_warmup=100, num_samples=100),
}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_recovers_conjugate_posterior(engine):
    kw = ENGINES[engine]
    out = sample_posterior(tt.random.PRNGKey(3, "cpu"), conjugate, (N_OBS,),
                           tt.choicemap(ys=YS), engine=engine, **kw)
    mu = out.samples["mu"]
    assert mu.shape[1] == kw["num_chains"]
    assert 2 <= mu.shape[0] <= kw["num_samples"]
    s = out.summary["mu"]
    assert abs(float(s["mean"]) - POST_MEAN) < 0.04
    assert abs(float(s["sd"]) - POST_SD) < 0.04
    assert float(s["rhat"]) < 1.05
    expected = "nuts_fused" if engine == "auto" else engine
    assert out.info["engine"] == expected
    if engine == "auto":
        assert out.info["engine_reason"] == "scalarization probe passed"


S_AB = 0.5
Y_AB = 0.8


@tt.gen
def two_normals():
    a = tt.normal(0.0, 1.0) @ "a"
    b = tt.normal(0.0, 1.0) @ "b"
    tt.normal(a + b, S_AB) @ "y"


@pytest.mark.parametrize("engine", ["chees", "hmc_fused", "nuts_fused",
                                    "nuts_fsm"])
def test_partial_selection_conditions_per_chain(engine):
    """a ~ N(0,1), b ~ N(0,1), y ~ N(a+b, s); sampling only "a" leaves
    each chain's b at its initial draw, so (a - m(b_i)) / sd is N(0, 1)."""
    n_chains = 96
    key = tt.random.PRNGKey(11, "cpu")
    obs = tt.choicemap(y=torch.tensor(Y_AB))
    kw = dict(num_chains=n_chains, num_warmup=150, num_samples=48,
              max_depth=6, engine=engine)
    if engine == "nuts_fsm":
        kw["num_ticks"] = 256
    out = sample_posterior(key, two_normals, (), obs,
                           selection=tt.select("a"), **kw)
    assert set(out.samples) == {"a"}
    a = out.samples["a"].double().numpy()
    # each chain's frozen b, from the engine's own init stream
    k_init = tt.random.split(key)[0]
    traces, _ = torch.func.vmap(lambda k: two_normals.generate(k, (), obs))(
        tt.random.split(k_init, n_chains))
    b = traces.get_choices()["b"].double().numpy()
    v = 1.0 / (1.0 + 1.0 / S_AB ** 2)
    z = (a - (v * (Y_AB - b) / S_AB ** 2)[None, :]) / np.sqrt(v)
    assert abs(z.mean()) < 0.08, z.mean()
    assert abs(z.std() - 1.0) < 0.08, z.std()


D_CORR = 6
_rng = np.random.default_rng(0)
_Q, _ = np.linalg.qr(_rng.standard_normal((D_CORR, D_CORR)))
A_CORR = (np.sqrt(np.geomspace(1.0, 300.0, D_CORR) - 1.0)[:, None]
          * _Q.T).astype(np.float32)
YS_CORR = (A_CORR @ _rng.standard_normal(D_CORR)
           + _rng.standard_normal(D_CORR)).astype(np.float32)
_S = np.linalg.inv(np.eye(D_CORR) + A_CORR.astype(np.float64).T @ A_CORR)
MEAN_CORR = _S @ (A_CORR.astype(np.float64).T @ YS_CORR)
SD_CORR = np.sqrt(np.diag(_S))


@tt.gen
def correlated():
    x = tt.normal(torch.zeros(D_CORR), 1.0) @ "x"
    tt.normal_linear(torch.from_numpy(A_CORR), x, 1.0) @ "ys"


@pytest.mark.parametrize("engine,mass", [("hmc_fused", "dense"),
                                         ("nuts_fused", "dense"),
                                         ("hmc_fused", "lowrank")])
def test_structured_mass_on_correlated_gaussian(engine, mass):
    out = sample_posterior(
        tt.random.PRNGKey(3, "cpu"), correlated, (),
        tt.choicemap(ys=torch.from_numpy(YS_CORR)), num_chains=192,
        num_warmup=200, num_samples=48, num_ticks=256, engine=engine,
        mass=mass, mass_rank=2)
    xs = out.samples["x"].double().numpy().reshape(-1, D_CORR)
    np.testing.assert_allclose(xs.mean(axis=0), MEAN_CORR,
                               atol=4.0 * SD_CORR.max() * 0.25)
    np.testing.assert_allclose(xs.std(axis=0) / SD_CORR, np.ones(D_CORR),
                               rtol=0, atol=0.25)
