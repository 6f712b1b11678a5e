"""gen_tpu_torch's conditional SMC and Particle Gibbs against gen_tpu's,
under the same keys, in float64, on tests/test_csmc.py's linear-Gaussian
kernel and on examples/particle_gibbs.py's ``ssm_kernel``.

Ancestry and parents are equal; log weights and log-ML estimates agree
within 1e-12, and so do the sampled states (float64 normals differ from
XLA's by ~1e-14 relative: torch's erfinv). gen_tpu's systematic
resampling (the initial SMC run of ``particle_gibbs``) runs its plain
paths on the CPU, as in tests/torch_smc_cases.py. The statistical gate of
tests/test_csmc.py (400 sweeps against the Kalman smoother) runs on the
card in chip_smoke.py's phase 11(e), at benchmarks/workloads.py's width.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.combinators.vector import VectorChoiceMap as JVCM  # noqa: E402
from gen_tpu.inference import csmc as jcsmc  # noqa: E402
from gen_tpu.inference import smc as jsmc  # noqa: E402
from gen_tpu_torch.combinators.vector import (  # noqa: E402
    VectorChoiceMap as TVCM)
from gen_tpu_torch.inference import csmc as tcsmc  # noqa: E402
from gen_tpu_torch.inference import smc as tsmc  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

RTOL = 1e-12
A, Q, C, R = 0.9, 0.3, 1.0, 0.4
MU0, P0 = 0.0, 1.0


@gt.gen
def j_kernel(t, prev_x):
    first = t == 0
    mean = jnp.where(first, MU0, A * prev_x)
    var = jnp.where(first, P0, Q)
    x = gt.normal(mean, jnp.sqrt(var)) @ "x"
    gt.normal(C * x, jnp.sqrt(R)) @ "y"
    return x


@tt.gen
def t_kernel(t, prev_x):
    first = t == 0
    mean = torch.where(first, MU0, A * prev_x)
    var = torch.where(first, P0, Q)
    x = tt.normal(mean, torch.sqrt(var)) @ "x"
    tt.normal(C * x, R ** 0.5) @ "y"
    return x


def _pg_kernel(g):
    """examples/particle_gibbs.py's ssm_kernel (phi a parameter)."""
    @g.gen
    def ssm_kernel(t, prev, phi):
        x = g.normal(phi * prev, 0.5) @ "x"
        g.normal(x, 0.4) @ "y"
        return x
    return ssm_kernel


J_PG, T_PG = _pg_kernel(gt), _pg_kernel(tt)


def make_data(T, seed=3):
    """tests/test_csmc.py's data."""
    rng = np.random.default_rng(seed)
    xs = np.zeros(T)
    xs[0] = rng.normal(MU0, np.sqrt(P0))
    for t in range(1, T):
        xs[t] = rng.normal(A * xs[t - 1], np.sqrt(Q))
    return rng.normal(C * xs, np.sqrt(R))


def maps(ys, xs=None):
    """(observations, reference) on both sides."""
    jo = JVCM(gt.ChoiceMap().set_value("y", jnp.asarray(ys)), len(ys))
    to = TVCM(tt.ChoiceMap().set_value("y", torch.from_numpy(ys)), len(ys))
    if xs is None:
        return jo, to
    jr = JVCM(gt.ChoiceMap().set_value("x", jnp.asarray(xs))
              .set_value("y", jnp.asarray(ys)), len(ys))
    tr = TVCM(tt.ChoiceMap().set_value("x", torch.from_numpy(xs))
              .set_value("y", torch.from_numpy(ys)), len(ys))
    return jo, to, jr, tr


def jkey(s):
    return jax.random.PRNGKey(s)


def tkey(s):
    return tt.random.PRNGKey(s, "cpu")


def close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=RTOL,
                               atol=1e-13, equal_nan=False)


def equal(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def run_both(seed, T, n, ref_seed, **kw):
    ys = make_data(T)
    xs = np.random.default_rng(ref_seed).standard_normal(T)
    jo, to, jr, tr = maps(ys, xs)
    jout = jcsmc.csmc_genealogy(jkey(seed), j_kernel, 0.0, (), jo, jr, n,
                                **kw)
    with float64_default():
        tout = tcsmc.csmc_genealogy(tkey(seed), t_kernel, 0.0, (), to, tr,
                                    n, **kw)
    return xs, jout, tout


@pytest.mark.parametrize("kw", [
    dict(), dict(ancestor_sampling=True), dict(ess_threshold=16.0)],
    ids=["pinned", "ancestor_sampling", "adaptive"])
def test_csmc_genealogy_matches_gen_tpu(kw):
    """The conditional filter step for step: ancestry equal, the pinned
    lane's trajectory the reference bit for bit (without ancestor
    sampling), weights and log-ML within 1e-12."""
    xs, (js, ja, jw, jl), (ts, ta, tw, tl) = run_both(0, 12, 32, 1, **kw)
    equal(ta, ja)
    close(tw, jw)
    close(tl, jl)
    close(ts.get_choices().get_value("x"), js.get_choices().get_value("x"))
    close(ts.get_score(), js.get_score())
    traj = tsmc.reconstruct_trajectories(ts, ta).get_choices()["x"]
    if not kw.get("ancestor_sampling"):
        equal(traj[:, 0], xs)
        equal(ta[:, 0], np.zeros(12))
    else:
        assert int((ta[:, 0] != 0).sum()) > 0


def test_lane_weights_are_observation_densities():
    """One step: every lane's weight, the pinned one included, is
    logpdf(y | C x, R) for its own x."""
    ys = make_data(1)
    _, to, _, tr = maps(ys, np.asarray([0.37]))
    with float64_default():
        subs, _, log_w, lml = tcsmc.csmc_genealogy(
            tkey(2), t_kernel, 0.0, (), to, tr, 16)
    xs = subs.get_choices().get_value("x")[0].numpy()
    expected = (-0.5 * (ys[0] - C * xs) ** 2 / R
                - 0.5 * np.log(2 * np.pi * R))
    np.testing.assert_allclose(log_w.numpy(), expected, rtol=0, atol=1e-12)
    assert xs[0] == 0.37
    np.testing.assert_allclose(
        float(lml), float(np.log(np.mean(np.exp(expected)))), atol=1e-12)


def test_single_particle_step_is_identity_and_validator():
    ys = make_data(8)
    xs = np.random.default_rng(5).standard_normal(8)
    _, to, _, tr = maps(ys, xs)
    with float64_default():
        new_ref, _ = tcsmc.particle_gibbs_step(
            tkey(1), t_kernel, 0.0, (), to, tr, num_particles=1,
            ancestor_sampling=False)
        equal(new_ref.inner.get_value("x"), xs)
        states = torch.linspace(-2.0, 2.0, 8)
        assert tcsmc.check_state_is_choice_determined(
            tkey(0), t_kernel, states, 1, (),
            tt.choicemap(x=torch.tensor(0.5), y=torch.tensor(0.1)))

        @tt.gen
        def noise_kernel(t, prev):
            eps = tt.normal(0.0, 1.0) @ "eps"
            tt.normal(prev + eps, 0.5) @ "y"
            return prev + eps

        assert not tcsmc.check_state_is_choice_determined(
            tkey(0), noise_kernel, states, 1, (),
            tt.choicemap(eps=torch.tensor(0.5), y=torch.tensor(0.1)))


def test_conditional_multinomial_parents():
    """Equal to gen_tpu's under the same key, and iid Categorical(w) (the
    regression of tests/test_csmc.py: n-1 draws, all kept)."""
    rng = np.random.default_rng(6)
    lnw = rng.standard_normal(50)
    lnw = lnw - np.log(np.exp(lnw).sum())
    for s in range(3):
        j = jcsmc._conditional_multinomial_parents(jkey(s), jnp.asarray(lnw))
        with float64_default():
            t = tcsmc._conditional_multinomial_parents(
                tkey(s), torch.from_numpy(lnw))
        equal(t, j)
        assert t.dtype == torch.int32 and t.shape == (49,)
    n, trials = 4, 4000
    uniform = torch.full((n,), -np.log(n), dtype=torch.float64)
    with float64_default():
        draws = torch.func.vmap(
            lambda k: tcsmc._conditional_multinomial_parents(k, uniform))(
            tt.random.split(tkey(0), trials))
    freq = np.bincount(draws.numpy().ravel(), minlength=n) / draws.numel()
    se = np.sqrt(0.25 * 0.75 / draws.numel())
    np.testing.assert_allclose(freq, 0.25, atol=5 * se + 1e-3)


def test_particle_gibbs_matches_gen_tpu():
    """The whole slice: particle_gibbs (3 sweeps, 16 particles, T=6,
    ancestor sampling) on examples/particle_gibbs.py's kernel, its initial
    reference from an unconditional genealogy SMC run: every sweep's
    trajectory and log-ML estimate equal gen_tpu's."""
    T = 6
    ys = make_data(T, seed=7)
    jo, to = maps(ys)
    jrefs, jlmls = jcsmc.particle_gibbs(jkey(8), J_PG, 0.0, (0.8,), jo,
                                        num_particles=16, num_sweeps=3)
    with float64_default():
        trefs, tlmls = tcsmc.particle_gibbs(tkey(8), T_PG, 0.0, (0.8,), to,
                                            num_particles=16, num_sweeps=3)
    assert trefs.inner.get_value("x").shape == (3, T)
    close(trefs.inner.get_value("x"), jrefs.inner.get_value("x"))
    close(trefs.inner.get_value("y"), jrefs.inner.get_value("y"))
    close(tlmls, jlmls)
    # the initial run alone, as a check of the genealogy it starts from
    k_init = jax.random.split(jkey(8), 3)[0]
    jsub, janc, _, _ = jsmc.smc_genealogy(k_init, J_PG, 0.0, (0.8,), jo, 16)
    with float64_default():
        tsub, tanc, _, _ = tsmc.smc_genealogy(
            tt.random.split(tkey(8), 3)[0], T_PG, 0.0, (0.8,), to, 16)
    equal(tanc, janc)
