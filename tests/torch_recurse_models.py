"""The stochastic binary tree of tests/test_recurse_static_ir.py and
tests/test_recurse_leveled.py written for both packages (at depth 2 here,
3 there: gen_tpu's per-node arena compiles every node), and the helpers
that compare two packages' Recurse traces. Shared by
tests/test_torch_recurse_static_ir.py and
tests/test_torch_recurse_leveled.py."""

import jax.numpy as jnp
import numpy as np
import torch

import gen_tpu as gt
import gen_tpu_torch as tt

B, D = 2, 2
EXACT = 1e-12


def tree_kernels(g, np_, depth_cap=False):
    """(production, aggregation): each node holds a Gaussian value and
    branches into two children with probability 0.4; the aggregation sums
    the node value with its active children. ``depth_cap``: the
    production asks for children with probability 0.95 and the
    aggregation's density depends on nchild
    (tests/test_recurse_leveled.py:189)."""
    p_branch = 0.95 if depth_cap else 0.4

    @g.gen
    def production(u):
        v = g.normal(u, 1.0) @ "v"
        branch = g.bernoulli(p_branch) @ "branch"
        nchild = np_.where(branch, 2, 0)
        return (v, nchild, np_.stack([v * 0.5, v * -0.5]))

    @g.gen
    def aggregation(v, child_ws, nchild):
        mask = np_.arange(B) < nchild
        if depth_cap:
            w = g.normal(v + nchild, 1.0) @ "w"
            return w + np_.sum(np_.where(mask, child_ws, 0.0))
        return v + np_.sum(np_.where(mask, child_ws, 0.0))

    return production, aggregation


def trees(which, depth=D, depth_cap=False):
    """The per-node (``"node"``) or leveled (``"level"``) combinator of
    both packages: (gen_tpu's, the port's)."""
    jp, ja = tree_kernels(gt, jnp, depth_cap)
    tp, ta = tree_kernels(tt, torch, depth_cap)
    jc = gt.Recurse if which == "node" else gt.RecurseLeveled
    tc = tt.Recurse if which == "node" else tt.RecurseLeveled
    return (jc(jp, ja, B, depth, w_example=jnp.asarray(0.0)),
            tc(tp, ta, B, depth, w_example=torch.tensor(0.0,
                                                        dtype=torch.float64)))


def close(t, j, rtol=EXACT):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=rtol * 1e-2)


def same_choices(tc, jc):
    """Two packages' choice maps: the same addresses, values within
    1e-12."""
    ti = list(tc.leaf_items())
    ji = list(jc.leaf_items())
    assert [p for p, _ in ti] == [p for p, _ in ji]
    for (_, a), (_, b) in zip(ti, ji):
        close(a, b)


def same_trace(ttr, jtr, choices=True):
    """Score, noise, return value and active mask equal; the choices too
    where the mask is concrete."""
    close(ttr.get_score(), jtr.get_score())
    close(ttr.project(tt.selectnone()), jtr.project(gt.selectnone()))
    close(ttr.get_retval(), jtr.get_retval())
    ta = ttr.active if isinstance(ttr.active, torch.Tensor) else \
        torch.cat([a.reshape(-1) for a in ttr.active])
    ja = jtr.active if not isinstance(jtr.active, tuple) else \
        jnp.concatenate([a.reshape(-1) for a in jtr.active])
    assert ta.tolist() == np.asarray(ja).tolist()
    if choices:
        same_choices(ttr.get_choices(), jtr.get_choices())
