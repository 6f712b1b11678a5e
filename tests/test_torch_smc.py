"""gen_tpu_torch's importance sampling, particle filter, genealogy SMC and
smc_run against gen_tpu's, under the same keys, in float64.

Parents and ancestry are equal; log weights and log-ML estimates agree
within 1e-10 (float64 normals differ from XLA's by ~1e-14 relative:
torch's erfinv). gen_tpu's Pallas K4 has no interpret mode, so its plain
paths (``_jnp_systematic``, ``_sorted_systematic``) stand in, as they do
on gen_tpu's CPU. The state-space model is ``tests/test_arena.py``'s, and
so is the Kalman check of smc_run at 3,000 particles."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.combinators import Unfold as JUnfold  # noqa: E402
from gen_tpu.combinators import UnfoldArena as JArena  # noqa: E402
from gen_tpu.combinators import smc_run as j_smc_run  # noqa: E402
from gen_tpu.combinators import vector_choicemap as j_vcm  # noqa: E402
from gen_tpu.inference import particle_filter as jpf  # noqa: E402
from gen_tpu.inference import smc as jsmc  # noqa: E402
from gen_tpu_torch.combinators import Unfold as TUnfold  # noqa: E402
from gen_tpu_torch.combinators import UnfoldArena as TArena  # noqa: E402
from gen_tpu_torch.combinators import vector_choicemap as t_vcm  # noqa: E402
from gen_tpu_torch.inference import particle_filter as tpf  # noqa: E402
from gen_tpu_torch.inference import smc as tsmc  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

RTOL = 1e-10
METHODS = ("systematic", "multinomial", "residual")


def _models(g):
    @g.gen
    def ssm_kernel(t, prev):
        x = g.normal(0.8 * prev, 0.5) @ "x"
        g.normal(x, 0.3) @ "y"
        return x

    @g.gen
    def point():
        x = g.normal(0.0, 1.0) @ "x"
        g.normal(x, 0.5) @ "y"
        return x

    @g.gen
    def point_proposal(shift):
        return g.normal(shift, 0.8) @ "x"

    @g.gen
    def step_proposal(trace, t, y):
        return g.normal(0.5 * y, 0.6) @ (t, "x")

    return ssm_kernel, point, point_proposal, step_proposal


J_KERNEL, J_POINT, J_PROP, J_STEP = _models(gt)
T_KERNEL, T_POINT, T_PROP, T_STEP = _models(tt)


def ssm_data(T=10, seed=3):
    """tests/test_arena.py's data."""
    rng = np.random.default_rng(seed)
    x, ys = 0.0, []
    for _ in range(T):
        x = 0.8 * x + 0.5 * rng.standard_normal()
        ys.append(x + 0.3 * rng.standard_normal())
    return np.asarray(ys)


YS = ssm_data(10)


def jkey(s):
    return jax.random.PRNGKey(s)


def tkey(s):
    return tt.random.PRNGKey(s, "cpu")


def close(t, j, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=1e-11)


def equal(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


@pytest.mark.parametrize("proposal", [False, True])
def test_importance_sampling_and_resampling(proposal):
    kw_j = dict(proposal=J_PROP, proposal_args=(0.3,)) if proposal else {}
    jtr, jlw, jlml = gt.inference.importance_sampling(
        jkey(2), J_POINT, (), gt.choicemap(y=jnp.float64(0.9)), 200, **kw_j)
    jone, jlml2 = gt.inference.importance_resampling(
        jkey(3), J_POINT, (), gt.choicemap(y=jnp.float64(0.9)), 200, **kw_j)
    with float64_default():
        kw_t = dict(proposal=T_PROP, proposal_args=(0.3,)) if proposal \
            else {}
        obs = tt.choicemap(y=torch.tensor(0.9))
        ttr, tlw, tlml = tt.inference.importance_sampling(
            tkey(2), T_POINT, (), obs, 200, **kw_t)
        tone, tlml2 = tt.inference.importance_resampling(
            tkey(3), T_POINT, (), obs, 200, **kw_t)
    close(ttr["x"], jtr["x"])
    close(tlw, jlw)
    close(tlml, jlml)
    close(tone["x"], jone["x"])
    close(tlml2, jlml2)


@pytest.mark.parametrize("method,n", [
    ("systematic", 100), ("systematic", 40000), ("multinomial", 100),
    ("multinomial", 40000), ("residual", 100)])
def test_resample_parents(method, n):
    """All three methods under the same key, on both sides of gen_tpu's
    32,768 dispatch (Gumbels below, exponential spacings and the rank
    merge above for multinomial; searchsorted below, the rank merge above
    for systematic)."""
    lw = np.random.default_rng(n).standard_normal(n) * 2.0
    lnw = lw - np.logaddexp.reduce(lw)
    pj = jpf._resample_parents(jkey(4), jnp.asarray(lnw), method)
    with float64_default():
        pt = tpf._resample_parents(tkey(4), torch.tensor(lnw), method)
    equal(pt, pj)


def _pf_run(g, pf, unfold, key, split, obs_at, n, T, method, proposal):
    state = pf.initialize_particle_filter(key(0), unfold, (1, 0.0),
                                          obs_at(0), n)
    out = []
    for t in range(1, T):
        k_res, k_ext = split(key(t))
        state, _ = pf.maybe_resample(k_res, state, method=method)
        parents = state.parents
        kw = dict(proposal=proposal[0], proposal_args=proposal[1](t)) \
            if proposal else {}
        state = pf.particle_filter_step(
            k_ext, state, (t + 1, 0.0), (g.IntDiff(1), g.NoChange),
            obs_at(t), **kw)
        out.append((parents, state.log_weights, pf.log_ml_estimate(state)))
    return state, out


@pytest.mark.parametrize("method", METHODS)
def test_particle_filter_api(method):
    n, T = 64, 5
    jstate, jout = _pf_run(
        gt, jpf, JUnfold(J_KERNEL), jkey, jax.random.split,
        lambda t: gt.choicemap(((t, "y"), jnp.float64(YS[t]))), n, T,
        method, None)
    with float64_default():
        tstate, tout = _pf_run(
            tt, tpf, TUnfold(T_KERNEL), tkey, tt.random.split,
            lambda t: tt.choicemap(((t, "y"), torch.tensor(YS[t]))), n, T,
            method, None)
        tsamp = tpf.sample_unweighted_traces(tkey(20), tstate, 16)
    jsamp = jpf.sample_unweighted_traces(jkey(20), jstate, 16)
    resampled = 0
    for (tp, tw, tl), (jp, jw, jl) in zip(tout, jout):
        equal(tp, jp)
        close(tw, jw)
        close(tl, jl)
        resampled += int(not np.array_equal(np.asarray(jp), np.arange(n)))
    assert resampled >= 1
    assert tstate.traces.length == T
    close(tstate.traces.get_choices().inner["x"],
          jstate.traces.get_choices().inner["x"])
    close(tsamp.get_retval(), jsamp.get_retval())
    close(tpf.effective_sample_size(tstate.log_weights - torch.logsumexp(
        tstate.log_weights, 0)), jpf.effective_sample_size(
        jstate.log_weights - jax.scipy.special.logsumexp(
            jstate.log_weights)))


def test_particle_filter_step_with_proposal():
    n, T = 32, 3
    jstate, jout = _pf_run(
        gt, jpf, JUnfold(J_KERNEL), jkey, jax.random.split,
        lambda t: gt.choicemap(((t, "y"), jnp.float64(YS[t]))), n, T,
        "systematic", (J_STEP, lambda t: (t, YS[t])))
    with float64_default():
        tstate, tout = _pf_run(
            tt, tpf, TUnfold(T_KERNEL), tkey, tt.random.split,
            lambda t: tt.choicemap(((t, "y"), torch.tensor(YS[t]))), n, T,
            "systematic", (T_STEP, lambda t: (t, YS[t])))
    for (tp, tw, tl), (jp, jw, jl) in zip(tout, jout):
        equal(tp, jp)
        close(tw, jw)
        close(tl, jl)


def test_particle_filter_step_discard_error():
    """A proposal that overwrites an existing choice is not an
    extension."""
    with float64_default():
        state = tpf.initialize_particle_filter(
            tkey(0), TUnfold(T_KERNEL), (1, 0.0),
            tt.choicemap(((0, "y"), torch.tensor(YS[0]))), 8)
        with pytest.raises(ValueError, match="discard non-empty"):
            tpf.particle_filter_step(
                tkey(1), state, (2, 0.0), (tt.IntDiff(1), tt.NoChange),
                tt.choicemap(((1, "y"), torch.tensor(YS[1]))),
                proposal=T_STEP, proposal_args=(0, 0.1))


@pytest.mark.parametrize("method", ["systematic", "multinomial"])
def test_smc_genealogy_and_trajectories(method):
    n, T = 128, 8
    jsub, janc, jlw, jlml = jsmc.smc_genealogy(
        jkey(7), J_KERNEL, 0.0, (), j_vcm(T, y=jnp.asarray(YS[:T])), n,
        resample_method=method)
    jtraj = jsmc.reconstruct_trajectories(jsub, janc)
    with float64_default():
        tsub, tanc, tlw, tlml = tsmc.smc_genealogy(
            tkey(7), T_KERNEL, 0.0, (), t_vcm(T, y=torch.tensor(YS[:T])), n,
            resample_method=method)
        ttraj = tsmc.reconstruct_trajectories(tsub, tanc)
    assert tanc.shape == (T, n) and tanc.dtype == torch.int32
    equal(tanc, janc)
    equal(tanc[0], np.arange(n))
    assert sum(not np.array_equal(np.asarray(r), np.arange(n))
               for r in tanc) >= 1
    close(tlw, jlw)
    close(tlml, jlml)
    for tl, jl in ((tsub, jsub), (ttraj, jtraj)):
        close(tl.get_choices()["x"], jl.get_choices()["x"])
        close(tl.get_score(), jl.get_score())
    # coherence: each reconstructed step continues its column's last state
    x = ttraj.get_choices()["x"]
    prev = ttraj.get_args()[1]
    np.testing.assert_array_equal(prev[1:].numpy(), x[:-1].numpy())


def test_smc_run_matches_gen_tpu():
    n, T = 128, 8
    j_arena, t_arena = JArena(J_KERNEL, 12), TArena(T_KERNEL, 12)
    jtr, jlw, jlml = j_smc_run(jkey(5), j_arena, 0.0, (),
                               j_vcm(T, y=jnp.asarray(YS[:T])), n)
    with float64_default():
        ttr, tlw, tlml = tt.inference.smc_run(
            tkey(5), t_arena, 0.0, (), t_vcm(T, y=torch.tensor(YS[:T])), n)
    close(tlw, jlw)
    close(tlml, jlml)
    equal(ttr.t_active, jtr.t_active)
    close(ttr.subtraces.get_choices()["x"], jtr.subtraces.get_choices()["x"])
    close(ttr.subtraces.get_score(), jtr.subtraces.get_score())


def test_arena_trace_views():
    with float64_default():
        arena = TArena(T_KERNEL, 16)
        trace = arena.simulate(tkey(0), (5, 0.0))
        utr = trace.to_unfold_trace()
        ch = trace.get_choices()
    assert utr.length == 5
    close(utr.get_score(), trace.get_score())
    close(utr.project(tt.selection.ALL), utr.get_score())
    assert list(ch.get_submaps_shallow()) == [0, 1, 2, 3, 4]
    close(trace.last_state(), utr.get_retval()[4])


def test_smc_run_matches_kalman():
    """tests/test_arena.py's check: the mean log-ML of five 3,000-particle
    filters within 0.08 of the exact Kalman filter; the port's Kalman
    reference equals that test's."""
    from test_arena import _kalman_lml
    from gen_tpu_torch._verify import kalman_filter
    lml, means, variances = kalman_filter(YS)
    np.testing.assert_allclose(lml, _kalman_lml(YS), rtol=1e-12)
    assert means.shape == variances.shape == (10,)
    arena = TArena(T_KERNEL, 16)
    with float64_default():
        obs = t_vcm(10, y=torch.tensor(YS))
        lmls = [float(tt.smc_run(tkey(s), arena, 0.0, (), obs, 3000)[2])
                for s in range(5)]
    np.testing.assert_allclose(np.mean(lmls), lml, atol=0.08)


def test_residual_above_gumbel_limit_is_unbiased():
    """Above 32,768 particles the port draws residual offspring by inverse
    cdf (gen_tpu would materialize (n, n) Gumbels): the offspring counts
    are floor(n w) plus draws that match the residual weights."""
    n = 40000
    rng = np.random.default_rng(3)
    lw = rng.standard_normal(n)
    lnw = torch.tensor(lw - np.logaddexp.reduce(lw))
    w = np.exp(lnw.numpy())
    with float64_default():
        counts = np.zeros(n)
        for s in range(2):
            p = tpf._resample_parents(tkey(s), lnw, "residual")
            assert p.shape == (n,) and int(p.min()) >= 0 \
                and int(p.max()) < n
            c = np.bincount(p.numpy(), minlength=n)
            assert (c >= np.floor(n * w)).all()
            counts += c
    # the heaviest decile's share of the offspring tracks its weight
    top = np.argsort(w)[-n // 10:]
    np.testing.assert_allclose(counts[top].sum() / (2 * n), w[top].sum(),
                               atol=0.01)
