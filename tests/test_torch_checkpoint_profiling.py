"""gen_tpu_torch.checkpoint and gen_tpu_torch.profiling on the CPU.

A checkpoint's keys are JAX's ``keystr`` of each leaf's path, in JAX's
flatten order, so a parameter store saved by either package loads into
the other (both directions are run here, values equal bit for bit). A
restored leaf takes the device and dtype of the template's leaf. The
timers return positive times on the CPU and ``profile_trace`` writes a
Chrome trace naming the ops it saw; on the card chip_smoke.py phase 13(g)
checks that a trace of a fused HMC launch names the kernel."""

import collections
import glob
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import vmap  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu import checkpoint as jck  # noqa: E402
from gen_tpu_torch import checkpoint as tck  # noqa: E402
from gen_tpu_torch import profiling  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

RNG = np.random.default_rng(0)
W = RNG.standard_normal((3, 4)).astype(np.float32)
B = RNG.standard_normal(4).astype(np.float32)
S = np.float32(-0.25)


def _param_model(g):
    @g.gen
    def net(x):
        h = g.param("W")
        g.normal(x @ h + g.param("b"), 1.0) @ "y"
    return net


def test_params_cross_load_both_ways(tmp_path):
    jnet, tnet = _param_model(gt), _param_model(tt)
    for g, net, conv in ((gt, jnet, jnp.asarray), (tt, tnet, torch.tensor)):
        g.init_param(net, "W", conv(W))
        g.init_param(net, "b", conv(B))
        g.init_param(net, "log_s", conv(S))
    jpath = jck.save_params(jnet, str(tmp_path / "jax.npz"))
    tpath = tck.save_params(tnet, str(tmp_path / "torch.npz"))
    with np.load(jpath, allow_pickle=True) as a, \
            np.load(tpath, allow_pickle=True) as b:
        assert list(a["__keys__"]) == list(b["__keys__"]) == [
            "['W']", "['b']", "['log_s']"]
    # each loads the other's file, into zeroed stores
    for g, net, conv in ((gt, jnet, jnp.zeros_like),
                         (tt, tnet, torch.zeros_like)):
        for k in ("W", "b", "log_s"):
            g.set_param(net, k, conv(net.params[k]))
    jck.restore_params(jnet, tpath)
    tck.restore_params(tnet, jpath)
    for k, v in (("W", W), ("b", B), ("log_s", S)):
        assert np.array_equal(np.asarray(jnet.params[k]), v)
        assert tnet.params[k].dtype == torch.float32
        assert np.array_equal(tnet.params[k].numpy(), v)


def test_keys_follow_jax_paths(tmp_path):
    """Dict keys sorted, sequence indices, namedtuple fields, None empty:
    the same key list as gen_tpu's for the same tree."""
    NT = collections.namedtuple("NT", "a b")

    def tree(conv):
        return {"w": conv([1.0, 2.0]), "b": [conv([3.0]), (conv([4.0]), None)],
                "a": NT(conv([5.0]), {"z": conv([6.0]), "c": conv([7.0])})}

    jck.save_pytree(str(tmp_path / "j.npz"), tree(jnp.asarray))
    tck.save_pytree(str(tmp_path / "t.npz"), tree(torch.tensor))
    with np.load(tmp_path / "j.npz", allow_pickle=True) as a, \
            np.load(tmp_path / "t.npz", allow_pickle=True) as b:
        assert list(a["__keys__"]) == list(b["__keys__"])
        for i in range(len(a["__keys__"])):
            assert np.array_equal(a[f"leaf_{i}"], b[f"leaf_{i}"])
    back = tck.restore_pytree(str(tmp_path / "j.npz"), tree(torch.tensor))
    assert back["b"][1][1] is None and isinstance(back["a"], NT)
    assert float(back["a"].b["c"][0]) == 7.0


def test_trace_round_trip_and_mismatch(tmp_path):
    """A batch of traces restores into a template batch bit for bit, with
    the template's dtypes; a template of another structure is refused."""
    @tt.gen
    def m(n):
        mu = tt.normal(0.0, 1.0) @ "mu"
        tt.normal(mu * torch.ones(n, dtype=torch.float64), 1.0) @ "ys"

    with float64_default():
        keys = tt.random.split(tt.random.PRNGKey(0, "cpu"), 16)
        trs = vmap(lambda k: m.simulate(k, (5,)))(keys)
        tmpl = vmap(lambda k: m.simulate(k, (5,)))(
            tt.random.split(tt.random.PRNGKey(1, "cpu"), 16))
    path = tck.save_pytree(str(tmp_path / "trs.npz"), trs)
    back = tck.restore_pytree(path, tmpl)
    assert torch.equal(back["ys"], trs["ys"])
    assert torch.equal(back.get_score(), trs.get_score())
    assert back["mu"].dtype == torch.float64
    with pytest.raises(ValueError, match="structure mismatch"):
        tck.restore_pytree(path, {"mu": trs["mu"]})


def test_timers_and_profile_trace(tmp_path):
    x = torch.ones(64, 64)
    secs, out = profiling.time_fn(torch.mm, x, x, warmup=1, iters=3)
    assert secs > 0 and out.shape == (64, 64)
    results = {}
    with profiling.timed("mm", results) as t:
        t["value"] = torch.mm(x, x)
    assert results["mm"] == t["seconds"] > 0
    with profiling.profile_trace(str(tmp_path)) as d:
        torch.mm(x, x)
    files = glob.glob(os.path.join(d, "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
