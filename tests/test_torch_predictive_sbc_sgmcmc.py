"""gen_tpu_torch's predictive sampling, SBC and SGMCMC against gen_tpu's,
in float64, under the same keys.

- Predictive: the draw indices equal gen_tpu's ``jnp.linspace(0, n_total
  - 1, n).astype(int32)`` for every (n_total, n) up to 30 (torch's
  ``linspace`` differs); the posterior and prior predictives equal
  gen_tpu's within 1e-12 at a draw count that does not divide the
  samples.
- SBC: ``sbc_ranks`` of the exact conjugate sampler (32 trials) and of an
  HMC pipeline under ``torch.func.vmap`` (24 trials) equal gen_tpu's rank
  for rank; ``sbc_uniformity`` equals it too.
- SGMCMC: tests/test_sgmcmc.py's identity (the mean of the minibatch
  gradients over a partition equals the full-data gradient, rtol 1e-9),
  each minibatch gradient within 1e-12 of gen_tpu's, and ``sgld_chain``
  and ``sghmc_step`` step for step.

The statistical gates (predictive moments, SBC uniformity at 400 trials,
SGLD against the exact posterior) run on the card in chip_smoke.py phase
13."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import vmap  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu import inference as ji  # noqa: E402
from gen_tpu_torch import inference as ti  # noqa: E402
from gen_tpu_torch.inference.predictive import draw_indices  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

EXACT = 1e-12


def close(t, j, rtol=EXACT):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=rtol * 1e-2)


def tkey(seed):
    return tt.random.PRNGKey(seed, "cpu")


def f64(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


N_OBS, SIGMA, PRIOR_STD = 20, 1.0, 3.0


def _pred_model(g, np_):
    @g.gen
    def model(n):
        mu = g.normal(0.0, PRIOR_STD) @ "mu"
        g.normal(mu * np_.ones(n, dtype=np_.float64), SIGMA) @ "ys"
    return model


def test_draw_indices_equal_jax_linspace():
    """Every (n_total, n) with n <= n_total <= 30. Both truncate
    6.999999999999999 to 6 at (15, 7): the draws are not the evenly
    spaced floor(i (n_total - 1) / (n - 1)) (ROADMAP queue 3)."""
    for total in range(1, 31):
        for n in range(1, total + 1):
            assert draw_indices(total, n).tolist() == np.asarray(
                jnp.linspace(0, total - 1, n).astype(jnp.int32)).tolist(), \
                (total, n)
    assert draw_indices(15, 7).tolist() == [0, 2, 4, 6, 9, 11, 14]
    assert [(i * 14) // 6 for i in range(7)] == [0, 2, 4, 7, 9, 11, 14]


def test_posterior_and_prior_predictive():
    mus = np.random.default_rng(0).normal(1.9, 0.2, (40, 3))
    jm = _pred_model(gt, jnp)
    jpred = ji.posterior_predictive(jax.random.PRNGKey(1), jm, (4,),
                                    {"mu": jnp.asarray(mus)}, num_draws=37)
    jprior = ji.prior_predictive(jax.random.PRNGKey(3), jm, (N_OBS,), 50)
    with float64_default():
        tm = _pred_model(tt, torch)
        tpred = ti.posterior_predictive(tkey(1), tm, (4,), {"mu": f64(mus)},
                                        num_draws=37)
        tprior = ti.prior_predictive(tkey(3), tm, (N_OBS,), 50)
    assert tuple(tpred.get_value("ys").shape) == (37, 4)
    close(tpred.get_value("mu"), jpred.get_value("mu"))
    close(tpred.get_value("ys"), jpred.get_value("ys"))
    close(tprior.get_value("ys"), jprior.get_value("ys"))
    close(tprior.get_value("mu"), jprior.get_value("mu"))


SBC_OBS, SBC_PRIOR = 8, 2.0
L = 31


def _sbc_model(g, np_):
    @g.gen
    def model():
        mu = g.normal(0.0, SBC_PRIOR) @ "mu"
        g.normal(mu * np_.ones(SBC_OBS, dtype=np_.float64), SIGMA) @ "ys"
    return model


def _exact_sampler(np_, normal):
    def run(key, obs):
        ys = obs.get_value("ys")
        prec = 1 / SBC_PRIOR ** 2 + SBC_OBS / SIGMA ** 2
        mean = (np_.sum(ys) / SIGMA ** 2) / prec
        return (mean + normal(key, (L,)) / np.sqrt(prec))[:, None]
    return run


def test_sbc_ranks_exact_sampler():
    jm = _sbc_model(gt, jnp)
    jr, jl = ji.sbc_ranks(jax.random.PRNGKey(0), jm, (), gt.select("ys"),
                          _exact_sampler(jnp, lambda k, s: jax.random.normal(
                              k, s, jnp.float64)), num_trials=32)
    with float64_default():
        tr, tl = ti.sbc_ranks(
            tkey(0), _sbc_model(tt, torch), (), tt.select("ys"),
            _exact_sampler(torch, lambda k, s: tt.random.normal(
                k, s, torch.float64)), num_trials=32)
    assert tl == jl == L and tuple(tr.shape) == (32, 1)
    assert tr.tolist() == np.asarray(jr).tolist()
    for a, b in zip(ti.sbc_uniformity(tr, tl, num_bins=8),
                    ji.sbc_uniformity(jr, jl, num_bins=8)):
        np.testing.assert_allclose(a, b, rtol=EXACT)


def test_sbc_ranks_hmc_pipeline():
    """tests/test_sbc.py:57's pipeline at 24 trials, 8 + 16 HMC steps
    thinned by 4: gen_tpu's scan, the port's loop under vmap."""
    def run_j(key, obs):
        k0, k1 = jax.random.split(key)
        tr, _ = jm.generate(k0, (), obs)

        def step(t, k):
            t, _ = ji.hmc(k, t, gt.select("mu"), L=8, eps=0.25)
            return t, t["mu"]

        _, mus = jax.lax.scan(step, tr, jax.random.split(k1, 24))
        return mus[8:][:, None]

    def run_t(key, obs):
        k0, k1 = tt.random.split(key)
        tr, _ = tm.generate(k0, (), obs)
        mus = []
        for k in tt.random.split(k1, 24):
            tr, _ = ti.hmc(k, tr, tt.select("mu"), L=8, eps=0.25)
            mus.append(tr["mu"])
        return torch.stack(mus)[8:][:, None]

    jm = _sbc_model(gt, jnp)
    jr, jl = ji.sbc_ranks(jax.random.PRNGKey(3), jm, (), gt.select("ys"),
                          run_j, num_trials=24, thin=4)
    with float64_default():
        tm = _sbc_model(tt, torch)
        tr, tl = ti.sbc_ranks(tkey(3), tm, (), tt.select("ys"), run_t,
                              num_trials=24, thin=4)
    assert tl == jl
    assert tr.tolist() == np.asarray(jr).tolist()


# -- SGMCMC (tests/test_sgmcmc.py's conjugate regression) ---------------------

N, M = 256, 32
RNG = np.random.default_rng(2)
XS = RNG.uniform(-1, 1, N)
YS = 0.8 * XS + 0.5 * RNG.standard_normal(N)


def _reg_model(g):
    @g.gen
    def reg_model(xs):
        w = g.normal(0.0, 1.0) @ "w"
        g.normal(w * xs, 0.5) @ "ys"
    return reg_model


def _targets():
    jm = _reg_model(gt)
    jtr, _ = jm.generate(jax.random.PRNGKey(0), (jnp.asarray(XS[:M]),),
                         gt.choicemap(ys=jnp.asarray(YS[:M])))
    jt = ji.MinibatchTarget(jtr, gt.select("w"), n_total=N, batch_size=M)
    tm = _reg_model(tt)
    ttr, _ = tm.generate(tkey(0), (f64(XS[:M]),),
                         tt.choicemap(ys=f64(YS[:M])))
    return jt, ti.MinibatchTarget(ttr, tt.select("w"), n_total=N,
                                  batch_size=M), tm


def test_minibatch_gradient_unbiased_and_equal():
    with float64_default():
        jt, t, tm = _targets()
        s = N // M
        flat = f64([0.3])
        grads = []
        for i in range(s):
            sl = slice(i * M, (i + 1) * M)
            g = t.grad_estimate(flat, (f64(XS[sl]),),
                                tt.choicemap(ys=f64(YS[sl])))
            jg = jt.grad_estimate(jnp.asarray([0.3]), (jnp.asarray(XS[sl]),),
                                  gt.choicemap(ys=jnp.asarray(YS[sl])))
            close(g, jg)
            grads.append(g)
        avg = torch.stack(grads).mean(0)
        full_tr, _ = tm.generate(tkey(0), (f64(XS),),
                                 tt.choicemap(ys=f64(YS)))
        _, g_full = ti.FlatTarget(full_tr, tt.select("w")).value_and_grad(
            flat)
    np.testing.assert_allclose(avg.numpy(), g_full.numpy(), rtol=1e-9)


def test_sgld_chain_and_sghmc_step_for_step():
    s = N // M
    with float64_default():
        jt, t, _ = _targets()
        jh = jax.jit(lambda k: ji.sgld_chain(
            k, jt, (jnp.asarray(XS.reshape(s, M)),),
            gt.choicemap(ys=jnp.asarray(YS.reshape(s, M))), step_size=1e-3,
            n_passes=2, thin=2))(jax.random.PRNGKey(1))
        th = ti.sgld_chain(tkey(1), t, (f64(XS.reshape(s, M)),),
                           tt.choicemap(ys=f64(YS.reshape(s, M))),
                           step_size=1e-3, n_passes=2, thin=2)
        assert tuple(th.shape) == (s, 1)
        close(th, jh)

        jf, jp = jnp.asarray([-2.0]), jnp.zeros(1)
        tf, tp = f64([-2.0]), torch.zeros(1, dtype=torch.float64)
        for i in range(12):
            sl = slice((i % s) * M, (i % s + 1) * M)
            jg = jt.grad_estimate(jf, (jnp.asarray(XS[sl]),),
                                  gt.choicemap(ys=jnp.asarray(YS[sl])))
            tg = t.grad_estimate(tf, (f64(XS[sl]),),
                                 tt.choicemap(ys=f64(YS[sl])))
            jf, jp = ji.sghmc_step(jax.random.fold_in(
                jax.random.PRNGKey(0), i), jf, jp, jg, step_size=1e-4,
                friction=0.3)
            tf, tp = ti.sghmc_step(tt.random.fold_in(tkey(0), i), tf, tp,
                                   tg, step_size=1e-4, friction=0.3)
            close(tf, jf)
            close(tp, jp)
