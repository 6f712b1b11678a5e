"""gen_tpu_torch's mixed discrete + continuous slice (Map, the discrete-site
discovery, the Gibbs sweep, the alternating and fused drivers behind
``sample_posterior``) against gen_tpu's, on tests/test_mixed.py's models
and examples/regression.py's flagship.

Under the same keys in float64: Map's generate and update weights and the
discovered discrete sites (the Gibbs sweep and the alternating driver are
in tests/test_torch_mixed_driver.py). The engine each model dispatches
to equals gen_tpu's; the GMM's
staged extended logp equals its FlatTarget logp; a tiny fused run returns
what gen_tpu's returns. The statistical gates at width run on the card in
chip_smoke.py. Last, the three faults of gen_tpu that the port does not
copy (ROADMAP queue 3)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.inference import mixed as jmixed  # noqa: E402
from gen_tpu.inference import sample as jsample  # noqa: E402
from gen_tpu_torch import random  # noqa: E402
from gen_tpu_torch.inference import mixed as tmixed  # noqa: E402
from gen_tpu_torch.inference import sample as tsample  # noqa: E402
from gen_tpu_torch.inference.target import FlatTarget  # noqa: E402
from gen_tpu_torch.ops.scalarize import stage_scalarized  # noqa: E402
from torch_port_models import GMM_YS, float64_default  # noqa: E402
from torch_port_models import mixed_problems as _problems  # noqa: E402
from torch_port_models import same_choices as _same_choices  # noqa: E402

@gt.gen
def _j_pois():
    lam = gt.gamma(2.0, 1.0) @ "lam"
    k = gt.poisson(lam) @ "k"
    return gt.normal(jnp.asarray(k, jnp.float32), 1.0) @ "y"


@tt.gen
def _t_pois():
    lam = tt.gamma(2.0, 1.0) @ "lam"
    k = tt.poisson(lam) @ "k"
    return tt.normal(k.to(torch.float32), 1.0) @ "y"


def _sites_summary(sites):
    return [(s.kind, s.path, s.length,
             np.asarray(s.support).astype(np.int64).tolist())
            for s in sites]


def test_map_generate_and_update_weights_match():
    with float64_default():
        jm, tm, ja, ta, jo, to = _problems(torch.float64)["gmm"]
        jtr, jw = jm.generate(jax.random.PRNGKey(3), ja, jo)
        ttr, tw = tm.generate(random.PRNGKey(3, "cpu"), ta, to)
        np.testing.assert_allclose(float(tw), float(jw), rtol=1e-12)
        _same_choices(jtr, ttr, 1e-12)
        z = np.array([True, False, True, True, False, False])
        jc, tc = gt.ChoiceMap(), tt.ChoiceMap()
        jc.set_submap("data", gt.vector_choicemap(6, z=jnp.asarray(z)))
        tc.set_submap("data", tt.vector_choicemap(6, z=torch.tensor(z)))
        jc.set_value("mu0", jnp.asarray(-1.7))
        tc.set_value("mu0", torch.tensor(-1.7))
        jnew, jw2, _, jd = jtr.update(None, jc)
        tnew, tw2, _, td = ttr.update(None, tc)
        np.testing.assert_allclose(float(tw2), float(jw2), rtol=1e-12)
        np.testing.assert_allclose(float(tnew.get_score()),
                                   float(jnew.get_score()), rtol=1e-12)
        _same_choices(jnew, tnew, 1e-12)
        assert [p for p, _ in td.leaf_items()] == \
            [p for p, _ in jd.leaf_items()]
        # simulate, and regenerate with the Map seeing NONE and ALL
        np.testing.assert_allclose(
            float(tm.simulate(random.PRNGKey(5, "cpu"), ta).get_score()),
            float(jm.simulate(jax.random.PRNGKey(5), ja).get_score()),
            rtol=1e-12)
        for jsel, tsel in ((gt.select("mu0"), tt.select("mu0")),
                           (gt.complement(gt.select("mu0", "mu1")),
                            tt.complement(tt.select("mu0", "mu1")))):
            jr, jw3, _ = jtr.regenerate(jax.random.PRNGKey(6), jsel)
            tr_, tw3, _ = ttr.regenerate(random.PRNGKey(6, "cpu"), tsel)
            np.testing.assert_allclose(float(tw3), float(jw3), rtol=1e-10,
                                       atol=1e-12)
            _same_choices(jr, tr_, 1e-12)


@pytest.mark.parametrize("name", ["gmm", "regression", "poisson"])
def test_discover_discrete_sites_matches(name):
    if name == "poisson":
        jm, tm, ja, ta = _j_pois, _t_pois, (), ()
        jo = gt.choicemap(y=jnp.asarray(3.0, jnp.float32))
        to = tt.choicemap(y=torch.tensor(3.0))
    else:
        jm, tm, ja, ta, jo, to = _problems(torch.float32)[name]
    jtr, _ = jm.generate(jax.random.PRNGKey(0), ja, jo)
    ttr, _ = tm.generate(random.PRNGKey(0, "cpu"), ta, to)
    if name == "poisson":
        for fn, tr, model, args, obs in (
                (jmixed.discover_discrete_sites, jtr, jm, ja, jo),
                (tmixed.discover_discrete_sites, ttr, tm, ta, to)):
            with pytest.raises(NotImplementedError,
                               match="discrete_supports"):
                fn(tr, obs, model, args)
        js = jmixed.discover_discrete_sites(jtr, jo, jm, ja,
                                            {"k": jnp.arange(12)})
        ts = tmixed.discover_discrete_sites(ttr, to, tm, ta,
                                            {"k": torch.arange(12)})
    else:
        js = jmixed.discover_discrete_sites(jtr, jo, jm, ja)
        ts = tmixed.discover_discrete_sites(ttr, to, tm, ta)
    assert _sites_summary(ts) == _sites_summary(js)
    assert (tmixed.model_evals_per_sweep(ts)
            == jmixed.model_evals_per_sweep(js))


@pytest.mark.parametrize("name", ["gmm", "regression", "scalar"])
def test_engine_dispatch_matches_gen_tpu(name):
    jm, tm, ja, ta, jo, to = _problems(torch.float32)[name]
    jtr, _ = jm.generate(jax.random.PRNGKey(0), ja, jo)
    ttr, _ = tm.generate(random.PRNGKey(0, "cpu"), ta, to)
    j_fused = jsample._probe_fused_mixed(jtr, jo) is None
    t_fused = tsample._probe_fused_mixed(ttr, to) is None
    assert t_fused == j_fused == (name != "scalar")


def test_gmm_staged_extended_logp_matches_flat_target():
    _, tm, _, ta, _, to = _problems(torch.float32)["gmm"]
    ttr, _ = tm.generate(random.PRNGKey(4, "cpu"), ta, to)
    sel, free_mask = tmixed.extended_layout(ttr, to)
    assert free_mask.tolist() == [1.0, 1.0] + [0.0] * 6
    target = FlatTarget(ttr, sel)
    staged = stage_scalarized(target.logp, target.dim, "cpu")
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal((2, 5)) * 2.0,
                        rng.integers(0, 2, (6, 5))]).astype(np.float32)
    lp, g = staged.vag(torch.tensor(x))
    for j in range(x.shape[1]):
        gj, vj = torch.func.grad_and_value(target.logp)(torch.tensor(x[:, j]))
        np.testing.assert_allclose(float(lp[j]), float(vj), rtol=1e-5)
        np.testing.assert_allclose(g[:, j].numpy(), gj.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert bool((g[2:, j] == 0).all())     # frozen coordinates


def test_gmm_fused_engine_runs_tiny():
    _, tm, _, ta, _, to = _problems(torch.float32)["gmm"]
    res = tsample.sample_posterior(random.PRNGKey(0, "cpu"), tm, ta, to,
                                   num_chains=4, num_warmup=30,
                                   num_samples=4, engine="auto")
    assert res.info["engine"] == "gibbs_nuts_fused"
    assert res.info["discrete_sites"] == [("data", "z")]
    assert res.info["discrete_evals_per_sweep"] == 12
    z = res.samples[("data", "z")]
    assert z.dtype == torch.bool and z.shape[1:] == (4, 6)
    assert res.samples["mu0"].shape == z.shape[:2]
    assert res.samples["mu0"].dtype == torch.float32
    assert res.summary[("data", "z")]["mean"].shape == (6,)


def test_scalar_categorical_runs_gibbs_nuts():
    _, tm, _, ta, _, to = _problems(torch.float32)["scalar"]
    res = tsample.sample_posterior(random.PRNGKey(1, "cpu"), tm, ta, to,
                                   num_chains=3, num_warmup=3,
                                   num_samples=3, max_depth=3,
                                   engine="auto")
    assert res.info["engine"] == "gibbs_nuts"
    assert "scalarize" in res.info["engine_reason"]
    assert res.samples["k"].shape == (3, 3)
    assert res.info["discrete_evals_per_sweep"] == 3


# -- gen_tpu's faults, not copied (ROADMAP queue 3) --------------------------

def test_partly_observed_vector_leaf_raises():
    _, tm, _, ta, _, to = _problems(torch.float32)["gmm"]
    ttr, _ = tm.generate(random.PRNGKey(0, "cpu"), ta, to)
    obs = tt.ChoiceMap()             # every y, and z at element 0 only
    for i, y in enumerate(GMM_YS):
        obs.set_value(("data", i, "y"), torch.tensor(y, dtype=torch.float32))
    obs.set_value(("data", 0, "z"), torch.tensor(True))
    with pytest.raises(ValueError, match="observed at elements"):
        tmixed.discover_discrete_sites(ttr, obs, tm, ta)


@pytest.mark.parametrize("kw", [dict(mass="dense"), dict(num_ticks=16),
                                dict(mesh=object())])
def test_mixed_path_refuses_arguments_it_would_ignore(kw):
    _, tm, _, ta, _, to = _problems(torch.float32)["gmm"]
    with pytest.raises(ValueError, match=next(iter(kw))):
        tsample.sample_posterior(random.PRNGKey(0, "cpu"), tm, ta, to,
                                 num_chains=2, num_warmup=2, num_samples=2,
                                 **kw)


def test_mixed_fused_sample_requires_observations():
    _, tm, _, ta, _, to = _problems(torch.float32)["gmm"]
    ttrs = torch.func.vmap(lambda k: tm.generate(k, ta, to)[0])(
        random.split(random.PRNGKey(0, "cpu"), 2))
    one = torch.utils._pytree.tree_map(lambda x: x[0], ttrs)
    sites = tmixed.discover_discrete_sites(one, to, tm, ta)
    with pytest.raises(ValueError, match="observations"):
        tmixed.mixed_fused_sample(random.PRNGKey(0, "cpu"), ttrs, one,
                                  sites, observations=None)


def test_stitched_chunks_are_each_chains_first_completed_draws():
    """The fused mixed driver's chunk stitching (``stitch_chunks``): each
    chain's first m completed draws of the concatenated K3 chunks, m the
    smallest total, with chains that complete no draw in some chunk (where
    gen_tpu's per-chunk ``min(cnt)`` would drop the whole chunk)."""
    rng = np.random.default_rng(0)
    n, d, steps = 5, 2, 6
    chunks, expected = [], [[] for _ in range(n)]
    for c in range(3):
        inc = rng.integers(0, 2, size=(steps, n))
        inc[:, c] = 0            # chain c completes nothing in chunk c
        hcnt = np.cumsum(inc, axis=0).astype(np.int32)
        hist = (100 * c + 10 * np.arange(steps)[:, None, None]
                + np.arange(n)[None, :, None] + 0.5 * np.arange(d))
        for j in range(n):
            expected[j] += [hist[s, j] for s in range(steps) if inc[s, j]]
        chunks.append((torch.tensor(hist, dtype=torch.float32),
                       torch.from_numpy(hcnt),
                       torch.from_numpy(hcnt[-1].copy())))
    draws, totals = tmixed.stitch_chunks(chunks)
    assert totals.tolist() == [len(e) for e in expected]
    m = min(len(e) for e in expected)
    assert draws.shape == (m, n, d) and m >= 2
    for j in range(n):
        np.testing.assert_array_equal(draws[:, j].numpy(),
                                      np.asarray(expected[j][:m]))
