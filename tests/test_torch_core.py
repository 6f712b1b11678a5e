"""gen_tpu_torch's addresses, selections and choice maps against gen_tpu's:
the same sorted-key order, the same flat layout, the same algebra."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.address import sorted_keys as j_sorted  # noqa: E402
from gen_tpu_torch.address import sorted_keys as t_sorted  # noqa: E402
from gen_tpu_torch.convert import choicemap_from_numpy  # noqa: E402

NESTED = {
    "b": np.float32(1.5),
    "a": {"z": np.arange(3, dtype=np.float32), 2: np.float32(-1.0),
          0: {"q": np.ones((2, 2), np.float32)}},
    10: np.float32(4.0),
    3: np.float32(7.0),
}


def _map(f, d):
    return {k: _map(f, v) if isinstance(v, dict) else f(v)
            for k, v in d.items()}


def _pair(d):
    return gt.choicemap(_map(jnp.asarray, d)), tt.choicemap(
        _map(torch.as_tensor, d))


def test_sorted_keys_mixed():
    keys = ["b", 3, "a", 10, True, 0, "aa", -2]
    assert t_sorted(keys) == j_sorted(keys)


def test_selection_membership_matches():
    jsel = gt.select("slope", ("a", "z"), ("a", 0, "q"))
    tsel = tt.select("slope", ("a", "z"), ("a", 0, "q"))
    probes = ["slope", "other", ("a", "z"), ("a", 2), ("a", 0, "q"),
              ("a", 0, "r"), ("b",)]
    for sel_j, sel_t in [(jsel, tsel), (jsel.complement(), tsel.complement()),
                         (gt.complement(jsel), tt.complement(tsel))]:
        assert [p in sel_t for p in probes] == [p in sel_j for p in probes]
    assert ("z" in tsel.subselection("a")) == ("z" in jsel.subselection("a"))
    assert tsel["a"][0].is_empty_set() == jsel["a"][0].is_empty_set()
    assert tt.selection.ALL.complement().is_empty_set()


def test_nested_map_order_and_flat_layout():
    jm, tm = _pair(NESTED)
    assert list(tm.addresses()) == list(jm.addresses())
    np.testing.assert_array_equal(tm.to_array().numpy(),
                                  np.asarray(jm.to_array()))
    flat = np.arange(tm.to_array().shape[0], dtype=np.float32) * 0.5
    jback = jm.from_array(jnp.asarray(flat))
    tback = tm.from_array(torch.from_numpy(flat))
    assert list(tback.addresses()) == list(jback.addresses())
    for (pj, vj), (pt, vt) in zip(jback.leaf_items(), tback.leaf_items()):
        assert pj == pt
        np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    with pytest.raises(ValueError):
        tm.from_array(torch.zeros(3))


def test_queries_filter_merge():
    jm, tm = _pair(NESTED)
    for addr in [("a", "z"), "b", ("a", 0, "q"), ("a", 5), "zz"]:
        assert tm.has_value(addr) == jm.has_value(addr)
    np.testing.assert_array_equal(tm.get_value(("a", 0, "q")).numpy(),
                                  np.asarray(jm.get_value(("a", 0, "q"))))
    assert list(tm.get_submap("a").addresses()) == list(
        jm.get_submap("a").addresses())
    assert tm.get_submap("nope").is_empty()
    sel_j = gt.select("b", ("a", 0))
    sel_t = tt.select("b", ("a", 0))
    assert list(tm.filter(sel_t).addresses()) == list(
        jm.filter(sel_j).addresses())
    assert list(tm.filter(sel_t.complement()).addresses()) == list(
        jm.filter(sel_j.complement()).addresses())
    merged = tm.filter(sel_t).merge(tm.filter(sel_t.complement()))
    assert merged == tm
    with pytest.raises(ValueError):
        tm.merge(tm)
    assert list(tm.merge(tm, overwrite=True).addresses()) == list(
        tm.addresses())


def test_pytree_roundtrip_and_vmap():
    _, tm = _pair(NESTED)
    leaves, spec = pytree.tree_flatten(tm)
    assert pytree.tree_unflatten(leaves, spec) == tm
    batched = pytree.tree_map(lambda v: torch.stack([v, 2 * v]), tm)
    flat = torch.func.vmap(lambda c: c.to_array())(batched)
    np.testing.assert_array_equal(flat[1].numpy(), 2 * tm.to_array().numpy())


def test_regression_trace_layout_matches_gen_tpu():
    """The flat layout of the headline model's selected choices (what the
    fused kernel indexes by) is gen_tpu's."""
    xs = jnp.linspace(-3.0, 3.0, 50)
    X = jnp.stack([xs, jnp.ones_like(xs)], axis=1)

    @gt.gen
    def model(X):
        slope = gt.normal(0.0, 2.0) @ "slope"
        intercept = gt.normal(0.0, 2.0) @ "intercept"
        log_noise = gt.normal(0.0, 1.0) @ "log_noise"
        gt.normal_linear(X, jnp.stack([slope, intercept]),
                         jnp.exp(log_noise)) @ "ys"

    tr, _ = model.generate(jax.random.PRNGKey(0), (X,),
                           gt.choicemap(ys=0.1 * xs))
    sel_j = gt.select("slope", "intercept", "log_noise")
    jchm = tr.get_choices()
    tchm = choicemap_from_numpy(
        [(p, np.asarray(v)) for p, v in jchm.leaf_items()], device="cpu")
    sel_t = tt.select("slope", "intercept", "log_noise")
    assert [p for p, _ in tchm.filter(sel_t).leaf_items()] == [
        p for p, _ in jchm.filter(sel_j).leaf_items()]
    np.testing.assert_array_equal(
        tchm.filter(sel_t).to_array().numpy(),
        np.asarray(jchm.filter(sel_j).to_array()))
