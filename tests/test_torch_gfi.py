"""gen_tpu_torch's distributions and GFI against gen_tpu's: logpdfs in
float64 within 1e-12, generate/simulate and vmapped generate under the same
keys, assess, and the package importing with jax blocked.

The GFI comparisons run in float64 (gen_tpu with x64, the port with float64
as torch's default dtype, so that the models' Python-float prior
parameters are float64 too): in float32 the Gram form of normal_linear
cancels, and two correct float32 programs differ by ~1e-3 relative in the
weight. Float64 normals agree to ~1e-14 relative (torch's erfinv against
XLA's), hence 1e-10."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import vmap  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from torch_port_models import (ADDRS, float64_default,  # noqa: E402
                               jax_args, jax_regression, torch_args,
                               torch_regression)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _choices(chm, addrs=ADDRS):
    return np.array([np.asarray(chm[a], np.float64) for a in addrs])


@pytest.mark.parametrize("seed", [0, 1])
def test_logpdfs_float64(seed):
    rng = np.random.default_rng(seed)
    v, mu = rng.standard_normal(7), rng.standard_normal(7)
    std = rng.uniform(0.5, 2.0, 7)
    lj = gt.normal.logpdf(jnp.asarray(v), jnp.asarray(mu), jnp.asarray(std))
    lt = tt.normal.logpdf(torch.tensor(v), torch.tensor(mu),
                          torch.tensor(std))
    assert lt.dtype == torch.float64
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-12)
    X = rng.standard_normal((50, 2))
    beta, sigma = rng.standard_normal(2), rng.uniform(0.3, 2.0)
    ys = X @ beta + sigma * rng.standard_normal(50)
    lj = gt.normal_linear.logpdf(jnp.asarray(ys), jnp.asarray(X),
                                 jnp.asarray(beta), jnp.asarray(sigma))
    lt = tt.normal_linear.logpdf(torch.tensor(ys), torch.tensor(X),
                                 torch.tensor(beta),
                                 torch.tensor(sigma, dtype=torch.float64))
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_generate_and_simulate_same_key(seed):
    args_j, obs_j = jax_args(jnp.float64)
    jtr, jw = jax_regression.generate(jax.random.PRNGKey(seed), args_j,
                                      obs_j)
    jsim = jax_regression.simulate(jax.random.PRNGKey(seed), args_j)
    with float64_default():
        args_t, obs_t = torch_args(torch.float64)
        ttr, tw = torch_regression.generate(tt.random.PRNGKey(seed, "cpu"), args_t,
                                            obs_t)
        tsim = torch_regression.simulate(tt.random.PRNGKey(seed, "cpu"), args_t)
    assert tw.dtype == torch.float64
    np.testing.assert_allclose(_choices(ttr.get_choices()),
                               _choices(jtr.get_choices()), rtol=1e-10)
    np.testing.assert_allclose(tw.item(), float(jw), rtol=1e-10)
    np.testing.assert_allclose(ttr.get_score().item(), float(jtr.get_score()),
                               rtol=1e-10)
    np.testing.assert_allclose(tsim.get_choices()["ys"].numpy(),
                               np.asarray(jsim.get_choices()["ys"]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tsim.get_score().item(),
                               float(jsim.get_score()), rtol=1e-10)
    assert ttr.get_retval() is ttr["slope"]


def test_vmapped_generate_over_64_keys():
    sel_j = gt.select(*ADDRS)
    sel_t = tt.select(*ADDRS)
    args_j, obs_j = jax_args(jnp.float64)

    def one(k):
        tr, w = jax_regression.generate(k, args_j, obs_j)
        return tr.get_choices().filter(sel_j).to_array(), w

    jv, jw = jax.vmap(one)(jax.random.split(jax.random.PRNGKey(4), 64))
    with float64_default():
        args_t, obs_t = torch_args(torch.float64)
        traces, tw = vmap(lambda k: torch_regression.generate(
            k, args_t, obs_t))(tt.random.split(tt.random.PRNGKey(4, "cpu"), 64))
        tv = vmap(lambda tr: tr.get_choices().filter(sel_t).to_array())(
            traces)
    assert tv.shape == (64, 3) and tw.shape == (64,)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-10)


def test_assess_float64():
    rng = np.random.default_rng(2)
    vals = {"slope": rng.standard_normal(), "intercept": rng.standard_normal(),
            "log_noise": 0.3 * rng.standard_normal()}
    args_j, obs_j = jax_args(jnp.float64)
    wj, rj = jax_regression.assess(
        args_j, obs_j.merge(gt.choicemap(**{k: jnp.float64(v)
                                            for k, v in vals.items()})))
    with float64_default():
        args_t, obs_t = torch_args(torch.float64)
        wt, rt = torch_regression.assess(
            args_t, obs_t.merge(tt.choicemap(**{k: torch.tensor(v)
                                                for k, v in vals.items()})))
    assert wt.dtype == torch.float64
    np.testing.assert_allclose(wt.item(), float(wj), rtol=1e-12)
    assert rt.item() == float(rj)
    with pytest.raises(ValueError):
        torch_regression.assess(args_t, tt.choicemap(slope=torch.tensor(0.)))


def test_imports_without_jax():
    """The port and chip_smoke.py never import jax: import every module
    with jax blocked."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import gen_tpu_torch, gen_tpu_torch.convert, gen_tpu_torch._verify\n"
        "import gen_tpu_torch.diagnostics, gen_tpu_torch.inference\n"
        "import gen_tpu_torch.ops.scalarize, gen_tpu_torch.ops.hmc_fused\n"
        "import gen_tpu_torch.ops.resample, gen_tpu_torch.combinators\n"
        "import gen_tpu_torch.inference.smc\n"
        "import chip_smoke\n"
        "assert not any(m == 'gen_tpu' or m.startswith(('gen_tpu.', 'jax.'))"
        " for m in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _nested_models(gt_or_tt, xp):
    """An outer model calling an inner one at an address, splicing another
    inline, and reading a trainable parameter."""
    @gt_or_tt.gen
    def inner(mu):
        return gt_or_tt.normal(mu, 1.0) @ "z"

    @gt_or_tt.gen
    def spliced():
        return gt_or_tt.normal(0.0, 3.0) @ "w"

    @gt_or_tt.gen
    def outer(y_scale):
        shift = gt_or_tt.param("shift")
        a = gt_or_tt.normal(shift, 1.0) @ "a"
        z = inner(a) @ "sub"
        w = spliced.inline()
        gt_or_tt.normal(xp.stack([z, w]), y_scale) @ "y"
        return z + w

    return outer


def test_nested_call_inline_and_param_float64():
    from gen_tpu_torch.convert import params_from_numpy
    j_outer = _nested_models(gt, jnp)
    gt.init_param(j_outer, "shift", jnp.float64(0.25))
    y = np.array([0.3, -0.7])
    jtr, jw = j_outer.generate(jax.random.PRNGKey(6), (0.5,),
                               gt.choicemap(y=jnp.asarray(y)))
    with float64_default():
        t_outer = _nested_models(tt, torch)
        params_from_numpy(t_outer, {"shift": np.float64(0.25)},
                          device="cpu")
        ttr, tw = t_outer.generate(tt.random.PRNGKey(6, "cpu"), (0.5,),
                                   tt.choicemap(y=torch.tensor(y)))
        wt, _ = t_outer.assess((0.5,), ttr.get_choices())
    assert list(ttr.get_choices().addresses()) == list(
        jtr.get_choices().addresses())
    for (pj, vj), (pt, vt) in zip(jtr.get_choices().leaf_items(),
                                  ttr.get_choices().leaf_items()):
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-10)
    np.testing.assert_allclose(tw.item(), float(jw), rtol=1e-10)
    np.testing.assert_allclose(ttr.get_score().item(),
                               float(jtr.get_score()), rtol=1e-10)
    np.testing.assert_allclose(wt.item(), ttr.get_score().item(), rtol=1e-12)
    assert ttr["sub"].item() == ttr[("sub", "z")].item()
    np.testing.assert_allclose(ttr.get_retval().item(),
                               float(jtr.get_retval()), rtol=1e-10)


def test_logsumexp_matches():
    from gen_tpu.utils import logsumexp as j_lse
    from gen_tpu_torch.utils import logsumexp as t_lse
    x = np.random.default_rng(3).standard_normal((4, 5)) * 30
    np.testing.assert_allclose(t_lse(torch.tensor(x)).item(),
                               float(j_lse(jnp.asarray(x))), rtol=1e-12)
    np.testing.assert_allclose(t_lse(torch.tensor(x), dim=1).numpy(),
                               np.asarray(j_lse(jnp.asarray(x), axis=1)),
                               rtol=1e-12)
