"""The one-call sampler of the port (``inference/sample.py``) against
gen_tpu: its pieces, its output layout, its refusals, and one whole run.

- ``_split_paths``, ``_default_selection`` and ``_free_mask_layout`` equal
  gen_tpu's on a model with a vector address, for full and partial
  selections; ``_auto_engine`` returns gen_tpu's engine and reason.
- Every engine returns gen_tpu's sample keys and shapes (draw counts of the
  completed-trajectory engines depend on the run, the other axes do not),
  gen_tpu's ``info`` keys and ``engine``.
- ``engine="auto"`` on a model that does not stage falls back to ``nuts``
  with a warning and the reason in ``info``.
- The refusals: ``mesh=`` raises ``NotImplementedError`` naming its
  slice; the mixed discrete path refuses gen_tpu's way a model with no
  continuous latent (``ValueError``) and a discrete address without a
  finite support (``NotImplementedError`` pointing at
  ``discrete_supports``); a discrete address with another engine, a
  selection outside the universe, ``mass`` with a non-fused engine and a
  dense metric past the residual cap raise gen_tpu's ``ValueError``.
- The slice as a whole: ``sample_posterior(engine="nuts_fused")`` on
  eight_schools under the same key in both frameworks, float32 on both
  sides. The initial traces agree to float32 normals (4 ulp, checked to
  1e-6 relative); 100 ChEES iterations over 128 chains amplify those ulps
  (accept decisions and teleports flip), so the adapted step sizes agree to
  1e-2 relative, not bit for bit; the fused runs then part as well
  (gen_tpu's twin differentiates the logp, the port stages it), so the
  draws of both are held to the exact posterior at one tolerance.
"""

import importlib
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu_torch._verify import schools_exact  # noqa: E402
from gen_tpu_torch.dists.distribution import Distribution  # noqa: E402
from torch_port_models import (SCHOOL_ADDRS, SIGMAS_8, YS_8,  # noqa: E402
                               jax_eight_schools, torch_eight_schools)

j_sample = importlib.import_module("gen_tpu.inference.sample")
t_sample = importlib.import_module("gen_tpu_torch.inference.sample")

A = np.random.default_rng(0).standard_normal((6, 3)).astype(np.float32)
YS = (A @ np.array([1.0, -0.5, 0.25]) + 0.3).astype(np.float32)


@gt.gen
def j_vec():
    w = gt.normal(jnp.zeros(3), 2.0) @ "w"
    b = gt.normal(0.0, 2.0) @ "b"
    gt.normal(jnp.asarray(A) @ w + b, 0.5) @ "ys"


@tt.gen
def t_vec():
    w = tt.normal(torch.zeros(3), 2.0) @ "w"
    b = tt.normal(0.0, 2.0) @ "b"
    tt.normal(torch.from_numpy(A) @ w + b, 0.5) @ "ys"


@tt.gen
def t_sort():
    a = tt.normal(0.0, 1.0) @ "a"
    b = tt.normal(0.0, 1.0) @ "b"
    lo = torch.sort(torch.stack([a, b])).values[0]
    tt.normal(lo, 0.5) @ "y"


class _Coin(Distribution):
    """A discrete choice without a finite support, for the refusal
    probes."""

    def sample(self, key, p):
        return (tt.random.uniform(key, ()) < p).to(torch.int32)

    def logpdf(self, v, p):
        p = torch.as_tensor(p)
        return torch.where(v == 1, torch.log(p), torch.log1p(-p))


@tt.gen
def t_mixed():
    z = _Coin()(0.5) @ "z"
    tt.normal(torch.where(z == 1, 1.0, -1.0), 1.0) @ "y"


@tt.gen
def t_mixed_latent():
    x = tt.normal(0.0, 1.0) @ "x"
    z = _Coin()(0.5) @ "z"
    tt.normal(x + torch.where(z == 1, 1.0, -1.0), 1.0) @ "y"


def _traces():
    with jax.enable_x64(False):
        jtr, _ = j_vec.generate(jax.random.PRNGKey(0), (),
                                gt.choicemap(ys=jnp.asarray(YS)))
    ttr, _ = t_vec.generate(tt.random.PRNGKey(0, "cpu"), (),
                            tt.choicemap(ys=torch.from_numpy(YS)))
    return (jtr, gt.choicemap(ys=jnp.asarray(YS))), (
        ttr, tt.choicemap(ys=torch.from_numpy(YS)))


@pytest.mark.parametrize("partial", [False, True])
def test_layout_helpers_match_gen_tpu(partial):
    (jtr, jobs), (ttr, tobs) = _traces()
    assert t_sample._split_paths(ttr, tobs) == j_sample._split_paths(jtr,
                                                                     jobs)
    _, paths_t = t_sample._default_selection(ttr, tobs)
    _, paths_j = j_sample._default_selection(jtr, jobs)
    assert paths_t == paths_j == [("b",), ("w",)]
    sel_j = gt.select("w") if partial else j_sample._default_selection(
        jtr, jobs)[0]
    sel_t = tt.select("w") if partial else t_sample._default_selection(
        ttr, tobs)[0]
    _, mj, ij, pj = j_sample._free_mask_layout(jtr, jobs, sel_j)
    _, mt, it, pt = t_sample._free_mask_layout(ttr, tobs, sel_t)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert pt == pj == partial


def test_auto_engine_matches_gen_tpu():
    (jtr, jobs), (ttr, tobs) = _traces()
    sel_t, _ = t_sample._default_selection(ttr, tobs)
    sel_j, _ = j_sample._default_selection(jtr, jobs)
    for chains in (8, 1):
        assert t_sample._auto_engine(ttr, tobs, sel_t, chains) == \
            j_sample._auto_engine(jtr, jobs, sel_j, chains)
    assert t_sample._auto_engine(ttr, tobs, sel_t, 8) == (
        "nuts_fused", "scalarization probe passed")
    tr, _ = t_sort.generate(tt.random.PRNGKey(0, "cpu"), (),
                            tt.choicemap(y=torch.tensor(0.3)))
    engine, reason = t_sample._auto_engine(
        tr, tt.choicemap(y=torch.tensor(0.3)), tt.select("a", "b"), 8)
    assert engine == "nuts" and "scalarize" in reason and "sort" in reason


# engine -> keyword budget, tiny: only the layout is compared here
BUDGETS = {
    "nuts": dict(num_chains=2, num_warmup=4, num_samples=3),
    "chees": dict(num_chains=4, num_warmup=4, num_samples=3),
    "hmc_fused": dict(num_chains=4, num_warmup=4, num_samples=3),
    "nuts_fused": dict(num_chains=4, num_warmup=4, num_samples=3,
                       num_ticks=48),
    "nuts_fsm": dict(num_chains=4, num_samples=3, num_ticks=60),
}


@pytest.mark.parametrize("engine", list(BUDGETS))
def test_output_layout_matches_gen_tpu(engine):
    kw = dict(BUDGETS[engine], max_depth=4, summarize=False)
    with jax.enable_x64(False):
        out_j = j_sample.sample_posterior(
            jax.random.PRNGKey(1), j_vec, (), gt.choicemap(ys=jnp.asarray(YS)),
            engine=engine, **kw)
        shapes_j = {k: v.shape for k, v in out_j.samples.items()}
    out_t = t_sample.sample_posterior(
        tt.random.PRNGKey(1, "cpu"), t_vec, (),
        tt.choicemap(ys=torch.from_numpy(YS)), engine=engine, **kw)
    shapes_t = {k: tuple(v.shape) for k, v in out_t.samples.items()}
    assert set(shapes_t) == set(shapes_j) == {"w", "b"}
    fixed = engine in ("nuts", "chees", "hmc_fused")
    for k in shapes_j:
        assert shapes_t[k][1:] == shapes_j[k][1:]
        assert shapes_t[k][0] == shapes_j[k][0] if fixed else \
            2 <= shapes_t[k][0] <= kw["num_samples"]
    assert set(out_t.info) == set(out_j.info)
    assert out_t.info["engine"] == out_j.info["engine"] == engine
    assert out_t.summary is None


def test_auto_fallback_warns_and_records_reason():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = t_sample.sample_posterior(
            tt.random.PRNGKey(0, "cpu"), t_sort, (),
            tt.choicemap(y=torch.tensor(0.3)), num_chains=2, num_warmup=6,
            num_samples=5, engine="auto", max_depth=4)
    assert out.info["engine"] == "nuts"
    assert out.info["engine_requested"] == "auto"
    assert "scalarize" in out.info["engine_reason"]
    assert any("fell back" in str(x.message) for x in w)
    assert out.samples["a"].shape == (5, 2)


def _run(model, obs, **kw):
    return t_sample.sample_posterior(tt.random.PRNGKey(0, "cpu"), model, (),
                                     obs, **dict(dict(
                                         num_chains=2, num_warmup=2,
                                         num_samples=2), **kw))


REFUSALS = {
    "mesh": (NotImplementedError, "item 12",
             lambda: _run(t_vec, tt.choicemap(ys=torch.from_numpy(YS)),
                          mesh=object())),
    "mixed_nuts": (ValueError, "no unobserved continuous",
                   lambda: _run(t_mixed, tt.choicemap(y=torch.tensor(0.5)))),
    "mixed_auto": (NotImplementedError, "discrete_supports",
                   lambda: _run(t_mixed_latent,
                                tt.choicemap(y=torch.tensor(0.5)),
                                engine="auto")),
    "discrete_other_engine": (
        ValueError, "discrete",
        lambda: _run(t_mixed, tt.choicemap(y=torch.tensor(0.5)),
                     engine="chees")),
    "outside_universe": (
        ValueError, "outside the unobserved",
        lambda: _run(t_vec, tt.choicemap(ys=torch.from_numpy(YS)),
                     selection=tt.select("w", "ys"), engine="hmc_fused")),
    "mass_needs_fused": (
        ValueError, "only supported by the fused",
        lambda: _run(t_vec, tt.choicemap(ys=torch.from_numpy(YS)),
                     engine="nuts_fsm", mass="dense")),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals(name):
    exc, match, call = REFUSALS[name]
    with pytest.raises(exc, match=match):
        call()


def test_dense_mass_refused_past_the_residual_cap():
    """d^2 > 900 residual scalars: gen_tpu's refusal, pointing at
    mass='lowrank' (raised after the diagonal warmup, as in gen_tpu)."""
    d = 31

    @tt.gen
    def wide():
        x = tt.normal(torch.zeros(d), 1.0) @ "x"
        tt.normal(x, 1.0) @ "ys"

    with pytest.raises(ValueError, match="lowrank"):
        _run(wide, tt.choicemap(ys=torch.zeros(d)), num_chains=4,
             engine="hmc_fused", mass="dense")


def test_slice_nuts_fused_matches_gen_tpu():
    kw = dict(num_chains=128, num_warmup=100, num_samples=48, num_ticks=256,
              engine="nuts_fused")
    sig, ys = SIGMAS_8.astype(np.float32), YS_8.astype(np.float32)
    with jax.enable_x64(False):
        # where the two runs start: the same traces up to float32 normals
        k_init = jax.random.split(jax.random.PRNGKey(3))[0]
        trs_j, _ = jax.vmap(lambda k: jax_eight_schools.generate(
            k, (jnp.asarray(sig),), gt.choicemap(ys=jnp.asarray(ys))))(
            jax.random.split(k_init, kw["num_chains"]))
        init_j = np.asarray(trs_j.get_choices()["theta_std"])
        # the reference's summary is not compared: summarize=False spares
        # its op-by-op diagnostics (~20 s)
        out_j = j_sample.sample_posterior(
            jax.random.PRNGKey(3), jax_eight_schools, (jnp.asarray(sig),),
            gt.choicemap(ys=jnp.asarray(ys)), summarize=False, **kw)
        samples_j = {k: np.asarray(v) for k, v in out_j.samples.items()}
        eps_j = float(out_j.info["step_size"])
    k_init = tt.random.split(tt.random.PRNGKey(3, "cpu"))[0]
    trs_t, _ = torch.func.vmap(lambda k: torch_eight_schools.generate(
        k, (torch.from_numpy(sig),), tt.choicemap(ys=torch.from_numpy(ys))))(
        tt.random.split(k_init, kw["num_chains"]))
    np.testing.assert_allclose(trs_t.get_choices()["theta_std"].numpy(),
                               init_j, rtol=1e-6, atol=1e-6)
    out_t = t_sample.sample_posterior(
        tt.random.PRNGKey(3, "cpu"), torch_eight_schools,
        (torch.from_numpy(sig),), tt.choicemap(ys=torch.from_numpy(ys)),
        **kw)
    assert set(out_t.samples) == set(samples_j) == set(SCHOOL_ADDRS)
    assert set(out_t.info) == set(out_j.info)
    assert out_t.info["engine"] == "nuts_fused"
    np.testing.assert_allclose(float(out_t.info["step_size"]), eps_j,
                               rtol=1e-2)
    exact = schools_exact(YS_8, SIGMAS_8)
    for k in SCHOOL_ADDRS:
        assert out_t.samples[k].shape[1:] == samples_j[k].shape[1:]
        m_ex, s_ex = (np.atleast_1d(v) for v in exact[(k,)])
        for draws in (samples_j[k], out_t.samples[k].numpy()):
            d = draws[draws.shape[0] // 4:].reshape(-1, m_ex.size)
            assert np.all(np.abs(d.mean(0) - m_ex) < 0.15 * s_ex), k
            assert np.all(np.abs(d.std(0) / s_ex - 1) < 0.15), k
        assert out_t.summary[k]["mean"].shape == out_t.samples[k].shape[2:]
