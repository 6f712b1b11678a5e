"""gen_tpu_torch's resumable runs (``inference/resumable.py``) on the CPU,
held to gen_tpu's and to themselves.

tests/test_resumable.py's contracts, its cases merged where they repeat:
a run killed after two of four segments and resumed by a fresh call
equals the uninterrupted run bit for bit, and both equal gen_tpu's
``resumable_run`` of ``hmc_chains`` under the same key within 1e-12 (a
float64 regression, 16 chains); a NaN in the state or in the draws rolls
the segment back onto the retry key ``fold_in(key, seg + RETRY_STRIDE)``;
a deterministic failure raises naming its segment; a run with another
segment count, base key or state structure is refused; a finished run
reloads its draws; one-argument health checks still work. The key's
fingerprint equals gen_tpu's for the same key. On the card chip_smoke.py
phase 13(a) runs the fused HMC kernel the same way at 524,288 chains."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import vmap  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.inference import hmc_chains as j_hmc_chains  # noqa: E402
from gen_tpu.inference import resumable as jres  # noqa: E402
from gen_tpu.inference.target import FlatTarget as JFlat  # noqa: E402
from gen_tpu_torch.inference import hmc_chains, resumable  # noqa: E402
from gen_tpu_torch.inference.target import FlatTarget  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

N_CHAINS, STEPS = 16, 6
XS = np.linspace(-2.0, 2.0, 20)
YS = 0.5 * XS + 0.3 * np.random.default_rng(0).standard_normal(20)
FLAT0 = np.random.default_rng(1).normal(0.0, 1.0, (N_CHAINS, 2))


def _torch_segment():
    @tt.gen
    def model(xs):
        slope = tt.normal(0.0, 2.0) @ "slope"
        intercept = tt.normal(0.0, 2.0) @ "intercept"
        tt.normal(slope * xs + intercept, 0.5) @ "ys"

    xs = torch.tensor(XS)
    obs = tt.choicemap(ys=torch.tensor(YS))
    trace, _ = model.generate(tt.random.PRNGKey(9, "cpu"), (xs,), obs)
    target = FlatTarget(trace, tt.select("slope", "intercept"))

    def segment(key, values):
        values, hist, _ = hmc_chains(key, target, values, n_steps=STEPS,
                                     L=3, eps=0.05)
        return values, hist
    return segment


def _jax_segment():
    @gt.gen
    def model(xs):
        slope = gt.normal(0.0, 2.0) @ "slope"
        intercept = gt.normal(0.0, 2.0) @ "intercept"
        gt.normal(slope * xs + intercept, 0.5) @ "ys"

    xs = jnp.asarray(XS)
    obs = gt.choicemap(ys=jnp.asarray(YS))
    trace, _ = model.generate(jax.random.PRNGKey(9), (xs,), obs)
    target = JFlat(trace, gt.select("slope", "intercept"))

    @jax.jit
    def segment(key, values):
        values, hist, _ = j_hmc_chains(key, target, values, n_steps=STEPS,
                                       L=3, eps=0.05)
        return values, hist
    return segment


def key(seed):
    return tt.random.PRNGKey(seed, "cpu")


def test_kill_and_resume_bitwise_and_equal_gen_tpu(tmp_path):
    with float64_default():
        segment = _torch_segment()
        flat0 = torch.tensor(FLAT0)
        sa, da, ia = resumable.resumable_run(str(tmp_path / "a"), key(42),
                                             segment, flat0, 4)
        assert not ia["resumed"]
        calls = {"n": 0}

        def dying(k, values):
            if calls["n"] == 2:
                raise KeyboardInterrupt("simulated preemption")
            calls["n"] += 1
            return segment(k, values)

        with pytest.raises(KeyboardInterrupt):
            resumable.resumable_run(str(tmp_path / "b"), key(42), dying,
                                    flat0, 4)
        # a fresh call with new objects and the same key and state0
        sb, db, ib = resumable.resumable_run(
            str(tmp_path / "b"), key(42), _torch_segment(),
            torch.tensor(FLAT0), 4)
    assert ib["resumed"] and ib["start_segment"] == 2
    assert torch.equal(da, db) and torch.equal(sa, sb)
    assert tuple(da.shape) == (4 * STEPS, N_CHAINS, 2)
    sj, dj, _ = jres.resumable_run(str(tmp_path / "j"), jax.random.PRNGKey(42),
                                   _jax_segment(), jnp.asarray(FLAT0), 4)
    np.testing.assert_allclose(da.numpy(), np.asarray(dj), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(sa.numpy(), np.asarray(sj), rtol=1e-12,
                               atol=1e-14)
    assert resumable._key_fingerprint(key(42)) == jres._key_fingerprint(
        jax.random.PRNGKey(42))


@pytest.mark.parametrize("where", ["state", "draws"])
def test_nan_rolls_back_onto_the_retry_key(tmp_path, where):
    with float64_default():
        segment = _torch_segment()
        flat0 = torch.tensor(FLAT0)
        seen = []
        armed = {"on": True}

        def flaky(k, values):
            seen.append(k.tolist())
            values, hist = segment(k, values)
            if armed["on"]:
                armed["on"] = False
                if where == "state":
                    values = values.clone()
                    values[0, 0] = float("nan")
                else:
                    hist = hist.clone()
                    hist[0, 0, 0] = float("nan")
            return values, hist

        state, draws, info = resumable.resumable_run(
            str(tmp_path / where), key(7), flaky, flat0, 3)
    assert info["retries"] == [(0, 0)]
    assert torch.isfinite(state).all() and torch.isfinite(draws).all()
    assert seen[1] == tt.random.fold_in(
        key(7), resumable.RETRY_STRIDE).tolist()
    assert tuple(draws.shape) == (3 * STEPS, N_CHAINS, 2)


def test_refusals_failures_and_reload(tmp_path):
    with float64_default():
        segment = _torch_segment()
        flat0 = torch.tensor(FLAT0)

        def broken(k, values):
            values, hist = segment(k, values)
            return values + float("inf"), hist

        with pytest.raises(RuntimeError, match="segment 0"):
            resumable.resumable_run(str(tmp_path / "broken"), key(0), broken,
                                    flat0, 2, max_retries=1)
        d = str(tmp_path / "done")
        _, da, _ = resumable.resumable_run(d, key(3), segment, flat0, 2)
        _, db, info = resumable.resumable_run(d, key(3), segment, flat0, 2)
        assert info["start_segment"] == 2 and torch.equal(da, db)
        with pytest.raises(ValueError, match="fresh workdir"):
            resumable.resumable_run(d, key(3), segment, flat0, 3)
        with pytest.raises(ValueError, match="different base key"):
            resumable.resumable_run(d, key(4), segment, flat0, 2)
        with pytest.raises(ValueError, match="state0 structure"):
            resumable.resumable_run(d, key(3), segment, flat0[:, :1], 2)
        calls = {"n": 0}

        def state_only(state):
            calls["n"] += 1
            return bool(torch.isfinite(state).all())

        resumable.resumable_run(str(tmp_path / "one"), key(0), segment,
                                flat0, 2, health_check=state_only)
    assert calls["n"] == 2


def test_structured_state_of_traces(tmp_path):
    """A state that is a batch of traces (a pytree with a spec) resumes bit
    for bit, each leaf back on its dtype."""
    @tt.gen
    def m():
        tt.normal(0.0, 1.0) @ "x"

    def seg(k, trs):
        new = vmap(lambda kk: m.simulate(kk, ()))(tt.random.split(k, 8))
        return new, new["x"][None]

    with float64_default():
        trs0 = vmap(lambda kk: m.simulate(kk, ()))(tt.random.split(key(0), 8))
        sa, da, _ = resumable.resumable_run(str(tmp_path / "a"), key(1), seg,
                                            trs0, 3)
        calls = {"n": 0}

        def dying(k, trs):
            if calls["n"] == 1:
                raise KeyboardInterrupt
            calls["n"] += 1
            return seg(k, trs)

        with pytest.raises(KeyboardInterrupt):
            resumable.resumable_run(str(tmp_path / "b"), key(1), dying,
                                    trs0, 3)
        sb, db, info = resumable.resumable_run(str(tmp_path / "b"), key(1),
                                               seg, trs0, 3)
    assert info["start_segment"] == 1
    assert torch.equal(da, db) and torch.equal(sa["x"], sb["x"])
    assert sb.get_score().dtype == torch.float64
