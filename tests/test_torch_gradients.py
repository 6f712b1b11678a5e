"""gen_tpu_torch's gradient methods against gen_tpu's, in float64, on
tests/test_gradients.py's models: ``choice_gradients`` (argument and
choice gradients, with and without a return-value gradient, through a
call), ``param_gradients`` (scalar and vector parameters, a scale factor,
a Map's kernel, a ``call_at`` wrapper) and ``accumulate_param_gradients``
(accumulated across calls, on top of accumulators carried over from
gen_tpu by ``convert.params_from_numpy``), and the store's accessors. Every
gradient equals gen_tpu's within 1e-12 relative (gen_tpu's own tests hold
it to finite differences)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu_torch import convert, utils  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

EXACT = 1e-12


def close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=EXACT,
                               atol=1e-300)


def jkey(s=0):
    return jax.random.PRNGKey(s)


def tkey(s=0):
    return tt.random.PRNGKey(s, "cpu")


def f64(x):
    return torch.tensor(x, dtype=torch.float64)


def _reg(g):
    @g.gen
    def reg_model(x):
        slope = g.normal(0.0, 2.0) @ "slope"
        intercept = g.normal(0.0, 2.0) @ "intercept"
        return g.normal(slope * x + intercept, 0.5) @ "y"
    return reg_model


J_REG, T_REG = _reg(gt), _reg(tt)
REG_CHOICES = dict(slope=0.4, intercept=-0.2, y=1.0)


def reg_traces():
    jtr, _ = J_REG.generate(jkey(), (1.3,), gt.choicemap(**REG_CHOICES))
    with float64_default():
        ttr, _ = T_REG.generate(tkey(), (1.3,), tt.choicemap(
            **{k: f64(v) for k, v in REG_CHOICES.items()}))
    return jtr, ttr


@pytest.mark.parametrize("sel", [("slope", "intercept"), ("y",), ()])
def test_choice_gradients_finite_diff(sel):
    """Choice and argument gradients (x = 1.3 is differentiable); the empty
    selection gives argument gradients alone."""
    jtr, ttr = reg_traces()
    ja, jv, jg = J_REG.choice_gradients(jtr, gt.select(*sel))
    with float64_default():
        ta, tv, tg = T_REG.choice_gradients(ttr, tt.select(*sel))
    assert len(ta) == len(ja) == 1
    close(ta[0], ja[0])
    assert sorted(tg.addresses()) == sorted(jg.addresses())
    for a in sel:
        close(tv[a], jv[a])
        close(tg[a], jg[a])
    assert not tg.has_value("y") or "y" in sel


def test_choice_gradients_with_retgrad():
    """A return-value gradient shifts the gradient of the choice that is
    the return value, and nothing else."""
    jtr, ttr = reg_traces()
    for sel, rg in ((("slope",), None), (("slope",), 2.0), (("y",), 2.0),
                    (("y",), None)):
        _, _, jg = J_REG.choice_gradients(jtr, gt.select(*sel), retgrad=rg)
        with float64_default():
            _, _, tg = T_REG.choice_gradients(ttr, tt.select(*sel),
                                              retgrad=rg)
        close(tg[sel[0]], jg[sel[0]])


def test_choice_gradients_hierarchical():
    def models(g):
        @g.gen
        def inner(mu):
            return g.normal(mu, 1.0) @ "a"

        @g.gen
        def outer():
            m = g.normal(0.0, 1.0) @ "m"
            return inner(m) @ "sub"
        return outer

    jouter, touter = models(gt), models(tt)
    jc = gt.choicemap(m=0.3)
    jc.set_value(("sub", "a"), 0.9)
    jtr, _ = jouter.generate(jkey(), (), jc)
    _, _, jg = jouter.choice_gradients(jtr, gt.select(("sub", "a"), "m"))
    with float64_default():
        tc = tt.choicemap(m=f64(0.3))
        tc.set_value(("sub", "a"), f64(0.9))
        ttr, _ = touter.generate(tkey(), (), tc)
        _, _, tg = touter.choice_gradients(ttr, tt.select(("sub", "a"), "m"))
    close(tg[("sub", "a")], jg[("sub", "a")])
    close(tg["m"], jg["m"])


def _pmodel(g, init, name):
    @g.gen
    def pmodel():
        theta = g.param("theta")
        return g.normal(theta, 1.0) @ "x"
    pmodel.name = name
    if g is gt:
        gt.init_param(pmodel, "theta", init)
    else:
        with float64_default():
            tt.init_param(pmodel, "theta", init)
    return pmodel


def test_param_gradients_finite_diff():
    """Scalar parameter gradients, with and without a scale factor (which
    leaves argument gradients alone)."""
    jm, tm = _pmodel(gt, 0.5, "p"), _pmodel(tt, 0.5, "p")
    jtr, _ = jm.generate(jkey(), (), gt.choicemap(x=1.2))
    with float64_default():
        ttr, _ = tm.generate(tkey(), (), tt.choicemap(x=f64(1.2)))
    for scale in (1.0, 3.0):
        ja, jp = jm.param_gradients(jtr, scale_factor=scale)
        with float64_default():
            ta, tp = tm.param_gradients(ttr, scale_factor=scale)
        assert ta == ja == ()
        assert list(tp) == [tm] and list(jp) == [jm]
        close(tp[tm]["theta"], jp[jm]["theta"])


def test_accumulate_param_gradients():
    """Accumulators add across calls, start from what gen_tpu had
    accumulated (carried by ``params_from_numpy``), read back through the
    store's accessors and zero."""
    jm, tm = _pmodel(gt, 0.0, "p2"), _pmodel(tt, 0.0, "p2")
    jtr, _ = jm.generate(jkey(), (), gt.choicemap(x=2.0))
    with float64_default():
        ttr, _ = tm.generate(tkey(), (), tt.choicemap(x=f64(2.0)))
    jm.accumulate_param_gradients(jtr, scale_factor=0.5)
    convert.params_from_numpy(
        tm, {"theta": np.asarray(gt.get_param(jm, "theta"))}, device="cpu",
        grads={"theta": np.asarray(gt.get_param_grad(jm, "theta"))})
    for _ in range(2):
        jm.accumulate_param_gradients(jtr)
        with float64_default():
            tm.accumulate_param_gradients(ttr)
    close(tt.get_param_grad(tm, "theta"), gt.get_param_grad(jm, "theta"))
    close(tt.get_param(tm, "theta"), gt.get_param(jm, "theta"))
    tt.zero_param_grad(tm, "theta")
    gt.zero_param_grad(jm, "theta")
    close(tt.get_param_grad(tm, "theta"), gt.get_param_grad(jm, "theta"))
    tt.set_param_grad(tm, "theta", f64(1.5))
    tt.set_param(tm, "theta", f64(0.25))
    assert float(tt.get_param_grad(tm, "theta")) == 1.5
    assert tm.get_params() == ("theta",) and tm.accepts_output_grad()
    assert tm.has_argument_grads() is None


def test_vector_param_gradients():
    def vmodel(g, ones):
        @g.gen
        def vm():
            w = g.param("w")
            return g.normal(w.sum(), 1.0) @ "x"
        return vm

    jm, tm = vmodel(gt, None), vmodel(tt, None)
    gt.init_param(jm, "w", jnp.array([0.1, 0.2, 0.3]))
    tt.init_param(tm, "w", f64([0.1, 0.2, 0.3]))
    jtr, _ = jm.generate(jkey(), (), gt.choicemap(x=1.0))
    with float64_default():
        ttr, _ = tm.generate(tkey(), (), tt.choicemap(x=f64(1.0)))
        _, tp = tm.param_gradients(ttr, retgrad=f64(0.5))
    _, jp = jm.param_gradients(jtr, retgrad=0.5)
    close(tp[tm]["w"], jp[jm]["w"])


def _kernel(g):
    @g.gen
    def pk(x):
        theta = g.param("theta")
        g.normal(theta * x, 1.0) @ "y"
    return pk


def test_param_gradients_through_map_kernel():
    """A Map's kernel parameters are reached through the batched subtrace;
    the argument gradient of xs too."""
    jk, tk = _kernel(gt), _kernel(tt)
    gt.init_param(jk, "theta", 0.5)
    tt.init_param(tk, "theta", f64(0.5))
    xs, ys = np.array([1.0, 2.0]), np.array([1.0, 2.0])
    jtr, _ = gt.Map(jk).generate(jkey(), (jnp.asarray(xs),),
                                 gt.vector_choicemap(2, y=jnp.asarray(ys)))
    ja, jp = gt.Map(jk).param_gradients(jtr)
    with float64_default():
        tmap = tt.Map(tk)
        ttr, _ = tmap.generate(tkey(), (torch.from_numpy(xs),),
                               tt.vector_choicemap(2, y=torch.from_numpy(ys)))
        ta, tp = tmap.param_gradients(ttr)
    close(tp[tk]["theta"], jp[jk]["theta"])
    close(ta[0], ja[0])


def test_param_gradients_through_call_at():
    """``collect_param_fns`` walks a ``call_at`` wrapper's inner trace."""
    jk, tk = _kernel(gt), _kernel(tt)
    gt.init_param(jk, "theta", 0.7)
    tt.init_param(tk, "theta", f64(0.7))
    jca, tca = gt.call_at(jk), tt.call_at(tk)
    jc = gt.choicemap()
    jc.set_value(("k", "y"), 0.4)
    jtr, _ = jca.generate(jkey(), (1.5, "k"), jc)
    _, jp = jca.param_gradients(jtr)
    with float64_default():
        tc = tt.choicemap()
        tc.set_value(("k", "y"), f64(0.4))
        ttr, _ = tca.generate(tkey(), (1.5, "k"), tc)
        _, tp = tca.param_gradients(ttr)
    assert list(tp) == [tk]
    close(tp[tk]["theta"], jp[jk]["theta"])


def test_pytree_utils_match_gen_tpu():
    """is_inexact / partition_inexact / combine / tree_vdot."""
    tree = (1.5, 2, True, torch.tensor([1.0, 2.0]), torch.tensor([3, 4]),
            {"a": torch.tensor(0.5)})
    assert [utils.is_inexact(x) for x in tree[:5]] == [
        gt.utils.is_inexact(x) for x in (1.5, 2, True, jnp.ones(2),
                                         jnp.ones(2, jnp.int32))]
    dyn, static = utils.partition_inexact(tree)
    assert dyn[1] is None and static[0] is None and static[1] == 2
    back = utils.combine(dyn, static)
    assert back[0] == 1.5 and back[2] is True and back[4] is tree[4]
    assert float(utils.tree_vdot(None, tree)) == 0.0
    a = (torch.tensor([1.0, 2.0]), torch.tensor(3.0))
    assert float(utils.tree_vdot(a, a)) == float(gt.utils.tree_vdot(
        (jnp.array([1.0, 2.0]), jnp.array(3.0)),
        (jnp.array([1.0, 2.0]), jnp.array(3.0))))
