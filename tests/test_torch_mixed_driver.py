"""gen_tpu_torch's Gibbs sweep and alternating Gibbs-within-NUTS driver
against gen_tpu's (``gen_tpu/inference/mixed.py``), under the same keys in
float64: ``gibbs_sweep`` on a model with a scalar categorical site and a
vector bernoulli site (two chains under vmap), and
``mixed_warmup_and_sample`` on tests/test_mixed.py's GMM at 2 chains and
4 + 4 iterations. Continuous draws agree within 1e-12 relative (float64
normals follow XLA's erf_inv within 3 ulp); discrete draws and leapfrog
counts exactly."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.inference import mixed as jmixed  # noqa: E402
from gen_tpu_torch import random  # noqa: E402
from gen_tpu_torch.inference import mixed as tmixed  # noqa: E402
from torch_port_models import float64_default, gmm_obs  # noqa: E402
from torch_port_models import mixed_problems as _problems  # noqa: E402
from torch_port_models import same_choices as _same_choices  # noqa: E402

RTOL = 1e-12


@gt.gen
def _j_sweep_datum(mu0, mu1, sd):
    z = gt.bernoulli(0.4) @ "z"
    return gt.normal(jnp.where(z, mu1, mu0), sd) @ "y"


@gt.gen
def _j_sweep_model(n):
    k = gt.categorical(jnp.asarray([0.3, 0.7])) @ "k"
    mu0 = gt.normal(-1.0, 1.0) @ "mu0"
    mu1 = gt.normal(1.0, 1.0) @ "mu1"
    sd = jnp.asarray([0.7, 1.3])[k]
    return gt.Map(_j_sweep_datum)(jnp.full(n, mu0), jnp.full(n, mu1),
                                  jnp.full(n, sd)) @ "data"


@tt.gen
def _t_sweep_datum(mu0, mu1, sd):
    z = tt.bernoulli(0.4) @ "z"
    return tt.normal(torch.where(z, mu1, mu0), sd) @ "y"


@tt.gen
def _t_sweep_model(n):
    k = tt.categorical(torch.tensor([0.3, 0.7])) @ "k"
    mu0 = tt.normal(-1.0, 1.0) @ "mu0"
    mu1 = tt.normal(1.0, 1.0) @ "mu1"
    sd = torch.tensor([0.7, 1.3])[k.long().reshape(1)][0]
    return tt.Map(_t_sweep_datum)(mu0.expand(n), mu1.expand(n),
                                  sd.expand(n)) @ "data"


def test_gibbs_sweep_matches_gen_tpu():
    """One scalar site (k, categorical) and one vector site (data.z,
    bernoulli), two chains under vmap."""
    ys = np.array([-1.4, 0.3, 2.1, -0.2])
    with float64_default():
        jo, to = gmm_obs(gt, jnp.asarray(ys)), gmm_obs(tt,
                                                         torch.tensor(ys))
        jkeys = jax.random.split(jax.random.PRNGKey(11), 2)
        tkeys = random.split(random.PRNGKey(11, "cpu"), 2)
        jtrs = jax.vmap(lambda k: _j_sweep_model.generate(k, (4,), jo)[0])(
            jkeys)
        ttrs = torch.func.vmap(lambda k: _t_sweep_model.generate(
            k, (4,), to)[0])(tkeys)
        jone = jax.tree_util.tree_map(lambda x: x[0], jtrs)
        tone = torch.utils._pytree.tree_map(lambda x: x[0], ttrs)
        _same_choices(jone, tone)
        js = jmixed.discover_discrete_sites(jone, jo, _j_sweep_model, (4,))
        ts = tmixed.discover_discrete_sites(tone, to, _t_sweep_model, (4,))
        assert [s.kind for s in ts] == ["scalar", "vector"]
        jouts = jax.jit(jax.vmap(lambda k, tr: jmixed.gibbs_sweep(
            k, tr, js)))(jkeys, jtrs)
        touts = torch.func.vmap(lambda k, tr: tmixed.gibbs_sweep(
            k, tr, ts))(tkeys, ttrs)
        for c in range(2):
            _same_choices(jax.tree_util.tree_map(lambda x: x[c], jouts),
                          torch.utils._pytree.tree_map(lambda x: x[c],
                                                       touts))
        np.testing.assert_allclose(touts.get_score().numpy(),
                                   np.asarray(jouts.get_score()), rtol=RTOL)

        # the sweep moved something: both sites are exercised
        def zs(trs):
            return trs.get_choices().get_submap("data").inner["z"]
        assert not torch.equal(zs(touts), zs(ttrs))


def test_mixed_warmup_and_sample_matches_gen_tpu():
    with float64_default():
        jm, tm, ja, ta, jo, to = _problems(torch.float64)["gmm"]
        jkeys = jax.random.split(jax.random.PRNGKey(2), 2)
        tkeys = random.split(random.PRNGKey(2, "cpu"), 2)
        jtrs = jax.vmap(lambda k: jm.generate(k, ja, jo)[0])(jkeys)
        ttrs = torch.func.vmap(lambda k: tm.generate(k, ta, to)[0])(tkeys)
        jone = jax.tree_util.tree_map(lambda x: x[0], jtrs)
        tone = torch.utils._pytree.tree_map(lambda x: x[0], ttrs)
        js = jmixed.discover_discrete_sites(jone, jo, jm, ja)
        ts = tmixed.discover_discrete_sites(tone, to, tm, ta)
        jrun = jax.jit(lambda trs, ks: jax.vmap(
            lambda tr, k: jmixed.mixed_warmup_and_sample(
                k, tr, gt.select("mu0", "mu1"), js, num_warmup=4,
                num_samples=4, max_depth=3))(trs, ks))
        jc, jd, _, jinfo = jrun(jtrs, jkeys)
        tc, td, _, tinfo = tmixed.mixed_warmup_and_sample(
            tkeys, ttrs, tt.select("mu0", "mu1"), ts, num_warmup=4,
            num_samples=4, max_depth=3)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL)
        np.testing.assert_array_equal(td[0].numpy(), np.asarray(jd[0]))
        for k in ("step_size", "inv_mass_diag", "mean_accept"):
            np.testing.assert_allclose(tinfo[k].numpy(),
                                       np.asarray(jinfo[k]), rtol=RTOL)
        np.testing.assert_array_equal(tinfo["total_leapfrogs"].numpy(),
                                      np.asarray(jinfo["total_leapfrogs"]))
