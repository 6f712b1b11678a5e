"""gen_tpu_torch's local MCMC moves against gen_tpu's under the same keys,
in float64, on tests/test_inference_kernels.py's models (a conjugate
Gaussian: mu ~ N(0, 3), 20 observations at 2.0 with noise 1; and a 3-d
mvnormal prior with Gaussian noise for elliptical slice).

Each chain runs step for step beside gen_tpu's jitted scan of the same
move under the same keys: ``mh_selection``, ``mh_proposal``, ``hmc``
(unit and diagonal mass; one step vmapped over 16 traces), ``hmc_chain``,
``mala``, ``map_optimize`` (40 moves; one move vmapped over lanes that
backtrack different numbers of times) and ``elliptical_slice`` (the
identity covariance, whose SVD factor is the identity in both; a vmapped
step whose lanes shrink their brackets different numbers of times). States
agree within 1e-12 relative and accept decisions are equal. The posterior
gates of tests/test_inference_kernels.py run on the card in chip_smoke.py
phase 12a at 131,072 chains."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402
from torch.func import vmap  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu import inference as ji  # noqa: E402
from gen_tpu_torch import inference as ti  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

EXACT = 1e-12
N_OBS = 20


def close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=EXACT,
                               atol=EXACT * 1e-2)


def _conj(g, ones):
    @g.gen
    def conj_model(n):
        mu = g.normal(0.0, 3.0) @ "mu"
        g.normal(mu * ones, 1.0) @ "ys"
        return mu
    return conj_model


J_CONJ = _conj(gt, jnp.ones(N_OBS))
T_CONJ = _conj(tt, torch.ones(N_OBS, dtype=torch.float64))


def conj_traces(mu0=None):
    jc = gt.choicemap(ys=jnp.full(N_OBS, 2.0))
    tc = tt.choicemap(ys=torch.full((N_OBS,), 2.0, dtype=torch.float64))
    if mu0 is not None:
        jc.set_value("mu", mu0)
        tc.set_value("mu", torch.tensor(mu0, dtype=torch.float64))
    jtr, _ = J_CONJ.generate(jax.random.PRNGKey(0), (N_OBS,), jc)
    with float64_default():
        ttr, _ = T_CONJ.generate(tt.random.PRNGKey(0, "cpu"), (N_OBS,), tc)
    return jtr, ttr


def run_both(jstep, tstep, n, seed=1, mu0=None):
    """gen_tpu's jitted scan of ``jstep`` and the port's loop of ``tstep``
    from the same trace under the same keys; each step returns (trace,
    accepted) and the chains' mu and accepts are compared."""
    jtr, ttr = conj_traces(mu0)

    def body(tr, k):
        tr, acc = jstep(k, tr)
        return tr, (tr["mu"], acc)

    _, (jmu, jacc) = jax.jit(lambda tr, ks: jax.lax.scan(body, tr, ks))(
        jtr, jax.random.split(jax.random.PRNGKey(seed), n))
    tmu, tacc = [], []
    with float64_default():
        for k in tt.random.split(tt.random.PRNGKey(seed, "cpu"), n):
            ttr, acc = tstep(k, ttr)
            tmu.append(ttr["mu"])
            tacc.append(bool(acc))
    close(torch.stack(tmu), jmu)
    assert tacc == [bool(a) for a in np.asarray(jacc)]
    return np.asarray(jacc)


def test_mh_selection_matches_gen_tpu():
    acc = run_both(lambda k, tr: ji.mh_selection(k, tr, gt.select("mu")),
                   lambda k, tr: ti.mh_selection(k, tr, tt.select("mu")),
                   40)
    assert 0 < acc.sum() < len(acc)


def test_mh_custom_proposal_matches_gen_tpu():
    def prop(g):
        @g.gen
        def drift_prop(tr):
            g.normal(tr["mu"], 0.25) @ "mu"
        return drift_prop

    jp, tp = prop(gt), prop(tt)
    acc = run_both(lambda k, tr: ji.mh_proposal(k, tr, jp),
                   lambda k, tr: ti.mh(k, tr, proposal=tp), 30)
    assert 0 < acc.sum() < len(acc)


@pytest.mark.parametrize("mass", [False, True])
def test_hmc_matches_gen_tpu(mass):
    if mass:
        kw = dict(L=5, eps=0.3, inv_mass_diag=jnp.array([0.05]))
        tkw = dict(L=5, eps=0.3, inv_mass_diag=torch.tensor([0.05],
                                                            dtype=torch.float64))
    else:
        kw = tkw = dict(L=5, eps=0.05)
    run_both(lambda k, tr: ji.hmc(k, tr, gt.select("mu"), **kw),
             lambda k, tr: ti.hmc(k, tr, tt.select("mu"), **tkw), 15,
             seed=2, mu0=-1.0)


def test_hmc_vmapped_chains():
    n = 16
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    obs = gt.choicemap(ys=jnp.full(N_OBS, 2.0))
    jtrs, _ = jax.vmap(lambda k: J_CONJ.generate(k, (N_OBS,), obs))(keys)
    jnew, jacc = jax.jit(jax.vmap(lambda tr, k: ji.hmc(
        k, tr, gt.select("mu"), L=5, eps=0.05)))(
            jtrs, jax.random.split(jax.random.PRNGKey(3), n))
    with float64_default():
        tobs = tt.choicemap(ys=torch.full((N_OBS,), 2.0, dtype=torch.float64))
        tkeys = tt.random.split(tt.random.PRNGKey(0, "cpu"), n)
        ttrs, _ = vmap(lambda k: T_CONJ.generate(k, (N_OBS,), tobs))(tkeys)
        tnew, tacc = vmap(lambda tr, k: ti.hmc(
            k, tr, tt.select("mu"), L=5, eps=0.05))(
                ttrs, tt.random.split(tt.random.PRNGKey(3, "cpu"), n))
    assert tacc.shape == (n,) and tnew.get_score().shape == (n,)
    close(tnew["mu"], jnew["mu"])
    close(tnew.get_score(), jnew.get_score())
    assert tacc.tolist() == np.asarray(jacc).tolist()


def test_hmc_chain_matches_gen_tpu():
    jtr, ttr = conj_traces(0.5)
    jf, js, ja = jax.jit(lambda k, tr: ji.hmc_chain(
        k, tr, gt.select("mu"), 25, L=4, eps=0.08))(
            jax.random.PRNGKey(4), jtr)
    with float64_default():
        tf, ts, ta = ti.hmc_chain(tt.random.PRNGKey(4, "cpu"), ttr,
                                  tt.select("mu"), 25, L=4, eps=0.08)
    assert ts.shape == (25, 1) and ta.shape == (25,)
    close(ts, js)
    assert ta.tolist() == np.asarray(ja).tolist()
    close(tf["mu"], jf["mu"])
    close(tf.get_score(), jf.get_score())


def test_mala_matches_gen_tpu():
    acc = run_both(lambda k, tr: ji.mala(k, tr, gt.select("mu"), 0.005),
                   lambda k, tr: ti.mala(k, tr, tt.select("mu"), 0.005), 30,
                   mu0=0.3)
    assert 0 < acc.sum()


def test_map_optimize_matches_gen_tpu():
    """40 moves from mu = -3 one by one: mu equal within 1e-12 while a move
    raises the score by more than 1e-12 relative (the first four), the
    scores equal within 1e-12 at every move; past that the score is flat
    to its last bit around the mode, so which step the line search takes
    turns on one ulp of the 20 terms' summation order, and mu stays within
    1e-8 of gen_tpu's. Then one move vmapped over starting points whose
    line searches backtrack 0 to ~8 times."""
    jtr, ttr = conj_traces(-3.0)
    jmove = jax.jit(lambda tr: ji.map_optimize(tr, gt.select("mu")))
    resolved = True
    with float64_default():
        for _ in range(40):
            j_prev = float(jtr.get_score())
            jtr = jmove(jtr)
            ttr = ti.map_optimize(ttr, tt.select("mu"))
            close(ttr.get_score(), jtr.get_score())
            resolved &= float(jtr.get_score()) - j_prev > EXACT * abs(j_prev)
            if resolved:
                close(ttr["mu"], jtr["mu"])
            else:
                assert abs(float(ttr["mu"]) - float(jtr["mu"])) < 1e-8
    starts = np.array([-30.0, -3.0, 1.98, 2.1, 5.0, 40.0, 300.0, 1e4])
    jcs = [gt.choicemap(ys=jnp.full(N_OBS, 2.0), mu=m) for m in starts]
    jtrs = [J_CONJ.generate(jax.random.PRNGKey(0), (N_OBS,), c)[0]
            for c in jcs]
    jb = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jtrs)
    jout = jax.jit(jax.vmap(lambda tr: ji.map_optimize(
        tr, gt.select("mu"), max_step_size=2.0)))(jb)
    with float64_default():
        ttrs = [conj_traces(float(m))[1] for m in starts]
        tb = pytree.tree_map(lambda *x: torch.stack(x), *ttrs)
        tout = vmap(lambda tr: ti.map_optimize(tr, tt.select("mu"),
                                               max_step_size=2.0))(tb)
    close(tout["mu"], jout["mu"])


def _ess_model(g, zeros, eye):
    @g.gen
    def ess_model():
        f = g.mvnormal(zeros, eye) @ "f"
        g.normal(f, 0.5) @ "y"
        return f
    return ess_model


def test_elliptical_slice_matches_gen_tpu():
    """The SVD factor of the identity is the identity in both; 15 steps of
    one chain, then one step vmapped over 8 chains."""
    eye = np.eye(3)
    jm = _ess_model(gt, jnp.zeros(3), jnp.eye(3))
    tm = _ess_model(tt, torch.zeros(3, dtype=torch.float64),
                    torch.eye(3, dtype=torch.float64))
    u, s, _ = torch.linalg.svd(torch.from_numpy(eye))
    ju, js, _ = jnp.linalg.svd(jnp.asarray(eye))
    close(u * torch.sqrt(s), ju * jnp.sqrt(js))
    y = np.array([1.0, 1.0, 1.0])
    jtr, _ = jm.generate(jax.random.PRNGKey(0), (), gt.choicemap(
        y=jnp.asarray(y)))
    jstep = jax.jit(lambda k, tr: ji.elliptical_slice(
        k, tr, "f", jnp.zeros(3), jnp.eye(3)))
    with float64_default():
        ttr, _ = tm.generate(tt.random.PRNGKey(0, "cpu"), (), tt.choicemap(
            y=torch.from_numpy(y)))
        close(ttr["f"], jtr["f"])
        for s_ in range(15):
            jtr = jstep(jax.random.PRNGKey(10 + s_), jtr)
            ttr = ti.elliptical_slice(tt.random.PRNGKey(10 + s_, "cpu"), ttr,
                                      "f", torch.zeros(3, dtype=torch.float64),
                                      torch.from_numpy(eye))
            close(ttr["f"], jtr["f"])
        jk = jax.random.split(jax.random.PRNGKey(7), 8)
        jf = jax.jit(jax.vmap(lambda k: ji.elliptical_slice(
            k, jtr, "f", jnp.zeros(3), jnp.eye(3))["f"]))(jk)
        tk = tt.random.split(tt.random.PRNGKey(7, "cpu"), 8)
        tf = vmap(lambda k: ti.elliptical_slice(
            k, ttr, "f", torch.zeros(3, dtype=torch.float64),
            torch.from_numpy(eye))["f"])(tk)
    close(tf, jf)
