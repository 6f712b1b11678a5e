"""The warp-per-chain layout of K3 and K6 (32 < d <= 128, no stream) on the
CPU: the staged program split over a warp's lanes, and the plain versions
that follow the kernels' lane order.

- The split rendering of the 100-school eight_schools logp (d=102) equals
  the serial torch rendering within float32 reordering (rtol 1e-5: only the
  four 100-term sums change order, each a few ulps of its terms), the
  value of gen_tpu's ``stage_scalarized`` program and ``jax.grad`` of
  gen_tpu's target at the tolerances of the port's d=10 check (value 1e-6
  relative, gradient 1e-5).
- Every instruction the outputs need is placed (on one coordinate's lane
  or on every lane) and scheduled; the hubs are ``log_tau`` and ``mu``;
  one lane runs at most an eighth of the serial program.
- A d=40 model whose coupling crosses lanes and a d=128 model (every lane
  busy) split and equal the serial rendering; d=200 keeps one thread per
  chain.
- ``run_pairs``/``run_ticks`` in the warp layout on a d=40 Gaussian with a
  coupling across lanes and a frozen coordinate, 64 chains, injected
  randomness: the serial layout's completed counts, its values within
  1e-5, and gen_tpu's ``nuts_fsm_paired``/``nuts_fsm`` the same way.
- The kernel sources: the warp layout at d=102 (its defines, shuffles, the
  split program); at d=10 the code of the one-thread layout, and for a
  streamed likelihood the code of the tiled stream layout, byte for byte
  once comments are removed (pinned hashes).
- The ``cuda``-marked test holds both kernels to their plain versions at
  d=40 on a card.
"""

import hashlib
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.inference.nuts_fsm import nuts_fsm as j_ticks  # noqa: E402
from gen_tpu.inference.nuts_fsm import nuts_fsm_paired as j_pairs  # noqa: E402
from gen_tpu.inference.target import FlatTarget as JFlatTarget  # noqa: E402
from gen_tpu.ops.scalarize import stage_scalarized as j_stage  # noqa: E402
from gen_tpu_torch.inference import FlatTarget  # noqa: E402
from gen_tpu_torch.inference.nuts_fsm import (  # noqa: E402
    injected_draws, run_pairs, run_ticks)
from gen_tpu_torch.ops import hmc_fused, nuts_fused, staged_eval  # noqa: E402
from gen_tpu_torch.ops.scalarize import (  # noqa: E402
    LANES, WARP_CPL, stage_scalarized)
from torch_port_models import (SCHOOL_ADDRS, SIGMAS_8, YS_8,  # noqa: E402
                               jax_eight_schools, make_schools,
                               robust_models, torch_eight_schools)

TOL = 1e-5
D_W = 40          # the d=40 Gaussian: coupling 0-39 across lanes 0 and 9
FROZEN = 7


def _schools(k):
    ys, sig = (make_schools(k, seed=0) if k > 8 else (YS_8, SIGMAS_8))
    ys, sig = ys.astype(np.float32), sig.astype(np.float32)
    tr, _ = torch_eight_schools.generate(
        tt.random.PRNGKey(0, "cpu"), (torch.from_numpy(sig),),
        tt.choicemap(ys=torch.from_numpy(ys)))
    return FlatTarget(tr, tt.select(*SCHOOL_ADDRS)), ys, sig


def _gauss(d, sds, coupling, lib=torch):
    """-0.5 sum (x/sd)^2 minus a x_i x_j for each coupling (a, i, j)."""
    def logp(x):
        out = -0.5 * lib.sum((x / sds) ** 2)
        for a, i, j in coupling:
            out = out - a * x[i] * x[j]
        return out
    return logp


def _sds(d):
    return np.random.default_rng(d).uniform(0.5, 2.0, d).astype(np.float32)


@pytest.fixture(scope="module")
def schools102():
    t, ys, sig = _schools(100)
    return t, stage_scalarized(t.logp, 102, "cpu"), ys, sig


def test_split_schools_matches_serial_and_gen_tpu(schools102):
    t, staged, ys, sig = schools102
    split = staged.warp_split()
    x = (np.random.default_rng(1).standard_normal((102, 64)) * 0.7
         ).astype(np.float32)
    lp_w, g_w = split.vag(torch.from_numpy(x))
    lp_s, g_s = staged.vag(torch.from_numpy(x))
    np.testing.assert_allclose(lp_w.numpy(), lp_s.numpy(), rtol=TOL)
    np.testing.assert_allclose(g_w.numpy(), g_s.numpy(), rtol=TOL,
                               atol=TOL)
    assert not np.array_equal(lp_w.numpy(), lp_s.numpy())   # order differs
    with jax.enable_x64(False):
        jtr, _ = jax_eight_schools.generate(
            jax.random.PRNGKey(0), (jnp.asarray(sig),),
            gt.choicemap(ys=jnp.asarray(ys)))
        jt = JFlatTarget(jtr, gt.select(*SCHOOL_ADDRS))
        js = j_stage(jt.logp, 102)
        with jax.disable_jit():         # an XLA build of it takes ~12 s
            lp_j = np.asarray(js.plane_fn(jnp.asarray(x), js.res_consts))
        g_j = np.asarray(jax.jit(jax.vmap(jax.grad(jt.logp)))(
            jnp.asarray(x.T))).T
    np.testing.assert_allclose(lp_w.numpy(), lp_j, rtol=1e-6)
    np.testing.assert_allclose(g_w.numpy(), g_j, rtol=1e-5, atol=1e-5)


def test_split_places_every_instruction(schools102):
    _, staged, _, _ = schools102
    split = staged.warp_split()
    assert split.hubs == 0b11                 # log_tau, mu (sorted paths)
    assert set(split._place) == set(split._reach)
    units = {split._unit(j) for j in split._reach}
    assert len(split._order) == len(units) == len(set(split._order))
    assert split.classes == [list(range(2, 102))]
    assert sorted(len(v) for v in staged.prog.reductions.values()) == \
        [100] * 4
    assert split.max_lane_instructions <= staged.n_instructions / 8
    # lanes 26-31 own no coordinate and run the shared part only
    counts = split.n_lane_instructions
    assert len(counts) == LANES and counts[31] < counts[1]


@pytest.mark.parametrize("d", [D_W, 128])
def test_split_wide_models_match_serial(d):
    sds = torch.from_numpy(_sds(d))
    coupling = ((0.3, 0, d - 1), (0.1, 5, 6), (0.05, 1, 2 * WARP_CPL + 1))
    staged = stage_scalarized(_gauss(d, sds, coupling), d, "cpu")
    assert nuts_fused.kernel_layout(staged) == "warp"
    split = staged.warp_split()
    assert split.hubs == 0
    x = torch.from_numpy((np.random.default_rng(d).standard_normal(
        (d, 32)) * 2.0).astype(np.float32))
    lp_w, g_w = split.vag(x)
    lp_s, g_s = staged.vag(x)
    np.testing.assert_allclose(lp_w.numpy(), lp_s.numpy(), rtol=TOL)
    np.testing.assert_allclose(g_w.numpy(), g_s.numpy(), rtol=TOL, atol=TOL)
    src = split.cuda_source()
    # the couplings read their other lane's operand by a shuffle
    assert src.count("__shfl_sync(") >= len(coupling)
    wide = stage_scalarized(_gauss(200, torch.ones(200), ()), 200, "cpu")
    assert nuts_fused.kernel_layout(wide) == "thread"


def _streams(seed, steps, n, d, n_u):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((steps, n, d)).astype(np.float32)
    us = [np.clip(rng.uniform(size=(steps, n)), 1e-6, 1 - 1e-6)
          .astype(np.float32) for _ in range(n_u)]
    return (z, *us)


@pytest.mark.parametrize("paired", [True, False])
def test_warp_loops_match_thread_loops_and_gen_tpu(paired):
    d, n, eps, md = D_W, 64, 0.5, 6
    steps = 24 if paired else 48
    n_u = 7 if paired else 4
    sds = _sds(d)
    coupling = ((0.3, 0, d - 1), (0.1, 5, 6))
    inv = (sds ** 2) * (np.arange(d) != FROZEN)
    vals0 = (np.random.default_rng(3).standard_normal((n, d)) * sds
             ).astype(np.float32)
    inj = _streams(11, steps, n, d, n_u)
    staged = stage_scalarized(_gauss(d, torch.from_numpy(sds), coupling), d,
                              "cpu")
    loop = run_pairs if paired else run_ticks
    out = {}
    for layout, vag in (("thread", staged.vag),
                        ("warp", staged.warp_split().vag)):
        draw = injected_draws(inj, n, d, torch.float32, "cpu", n_u)
        out[layout] = loop(vag, torch.from_numpy(vals0.T.copy()), eps,
                           steps, md, torch.from_numpy(inv).reshape(d, 1),
                           1000.0, draw, None, ckpt_bf16=True, layout=layout)
    (s_t, h_t, c_t), (s_w, h_w, c_w) = out["thread"], out["warp"]
    assert torch.equal(s_t["count"], s_w["count"]) and torch.equal(c_t, c_w)
    assert int(s_w["count"].sum()) > n
    torch.testing.assert_close(h_w, h_t, rtol=TOL, atol=TOL)
    assert torch.equal(s_w["theta"][FROZEN],
                       torch.from_numpy(vals0[:, FROZEN]))
    # the kernel's plain version picks the warp layout for this model
    vk, hk, hck, ck, _ = nuts_fused.nuts_chains_fused(
        tt.random.PRNGKey(0, "cpu"), _gauss(d, torch.from_numpy(sds),
                                            coupling),
        torch.from_numpy(vals0), 2 * steps if paired else steps, eps, md,
        torch.from_numpy(inv), None, 1000.0, inj, paired)
    assert torch.equal(vk.T, s_w["theta"]) and torch.equal(ck, s_w["count"])
    with jax.enable_x64(False):
        vg = jax.value_and_grad(_gauss(d, jnp.asarray(sds), coupling, jnp))
        injc = tuple(jnp.moveaxis(jnp.asarray(x), 0, 1) for x in inj)
        keys = jax.random.split(jax.random.PRNGKey(2), n)
        if paired:
            res, (hist, hcnt) = jax.vmap(lambda kk, t, *xs: j_pairs(
                kk, vg, t, eps, steps, max_depth=md,
                inv_mass_diag=jnp.asarray(inv), injected_rng=xs,
                collect_idx=0, ckpt_bf16=True))(keys, jnp.asarray(vals0),
                                                *injc)
        else:
            res, (hist, hcnt) = jax.vmap(lambda kk, t, *xs: j_ticks(
                kk, vg, t, eps, steps, max_depth=md,
                inv_mass_diag=jnp.asarray(inv), num_sample_slots=4,
                injected_rng=xs, collect_idx=0, ckpt_bf16=True))(
                keys, jnp.asarray(vals0), *injc)
        counts, theta = np.asarray(res.counts), np.asarray(res.theta)
        hcnt = np.asarray(hcnt)
    np.testing.assert_array_equal(s_w["count"].numpy(), counts)
    np.testing.assert_array_equal(c_w.numpy(), hcnt.T)
    np.testing.assert_allclose(s_w["theta"].T.numpy(), theta, rtol=TOL,
                               atol=TOL)


def _code(src):
    """The source without comments and blank lines."""
    return "\n".join(ln.rstrip() for ln in re.sub(r"//[^\n]*", "",
                                                  src).splitlines()
                     if ln.strip())


def _hash(text):
    return hashlib.sha256(text.encode()).hexdigest()[:16]


# sha256 prefixes of the kernels' code (comments removed; the notes
# changed): eight_schools d=10 at max_depth 8 in the one-thread layout, and
# the robust-t stream at n=4,096 and max_depth 6 in the tiled stream
# layout, as rendered with the staged code's division rule
# (scalarize._div_rcp) and K1's step-size table; an edit of that
# code must update them
BEFORE = {
    ("d10", "K3"): "8e99df6426b840de", ("d10", "K6"): "a55f21a4b4735c71",
    ("d10", "K1"): "eb79a35b79c667d7", ("d10", "SE"): "9c5df9775f2ca3e3",
    ("robust", "K3"): "8766bcd838cef841",
    ("robust", "K6"): "e0ae2532d4fc69d3",
    ("robust", "K1"): "3b5fc9788ba8764d",
    ("robust", "SE"): "4ead9d3d804cb36f",
}


def test_kernel_sources_by_layout(schools102):
    _, staged, _, _ = schools102
    for paired in (True, False):
        src = nuts_fused.kernel_source(staged, 8, paired)
        assert "@@" not in src and "__shfl_xor_sync" in src
        assert f"#define NUTS_LANES {LANES}\n" in src
        assert f"#define NUTS_CPL {WARP_CPL}" in src
        assert staged.warp_split().cuda_source() in src
        assert f"#define NUTS_R {staged.warp_split().n_res}\n" in src
        assert "staged_vag(" not in src and "_Pragma(\"unroll 1\")" not in src
    t10 = _schools(8)[0]
    st10 = stage_scalarized(t10.logp, 10, "cpu")
    _, rob, ys = robust_models(4096)
    rtr = rob.generate(tt.random.PRNGKey(1, "cpu"), (),
                       tt.choicemap(ys=torch.from_numpy(ys)))[0]
    strob = stage_scalarized(
        FlatTarget(rtr, tt.select("slope", "intercept", "log_noise")).logp,
        3, "cpu")
    for name, st, md in (("d10", st10, 8), ("robust", strob, 6)):
        assert nuts_fused.kernel_layout(st) == ("thread" if name == "d10"
                                                else "stream")
        for paired, k in ((True, "K3"), (False, "K6")):
            src = nuts_fused.kernel_source(st, md, paired)
            assert f"#define NUTS_LANES {st.lanes}" in src
            assert "#define NUTS_CPL" not in src and "@@" not in src
            assert _hash(_code(src)) == BEFORE[(name, k)]
        assert _hash(_code(hmc_fused.kernel_source(st))) == \
            BEFORE[(name, "K1")]
        assert _hash(_code(staged_eval.build_job(st)[1])) == \
            BEFORE[(name, "SE")]
    assert "#define NUTS_LANES 1\n" in nuts_fused.kernel_source(st10, 8, True)


@pytest.mark.cuda
def test_warp_kernels_match_plain_versions_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    d, n = D_W, 4000
    sds = torch.from_numpy(_sds(d)).to(dev)
    logp = _gauss(d, sds, ((0.3, 0, d - 1), (0.1, 5, 6)))
    inv = (sds ** 2) * (torch.arange(d, device=dev) != FROZEN)
    vals0 = torch.randn(n, d, device=dev) * sds
    for paired, steps in ((True, 20), (False, 40)):
        inj = tuple(torch.from_numpy(a).to(dev) for a in _streams(
            5, steps, n, d, 7 if paired else 4))
        kw = dict(num_ticks=2 * steps if paired else steps, eps=0.5,
                  max_depth=6, inv_mass_diag=inv, collect_idx=None,
                  injected_rng=inj, paired=paired)
        key = tt.random.PRNGKey(0, dev)
        before = nuts_fused.nuts_chains_fused.layout_launches["warp"]
        vk, hk, hck, ck, sk = nuts_fused.nuts_chains_fused(key, logp, vals0,
                                                           **kw)
        assert nuts_fused.nuts_chains_fused.layout_launches["warp"] == \
            before + 1
        vp, hp, hcp, cp, sp = nuts_fused.nuts_chains_fused_plain(
            key, logp, vals0, **kw)
        assert torch.equal(ck, cp) and torch.equal(hck, hcp)
        torch.testing.assert_close(vk, vp, rtol=TOL, atol=TOL)
        torch.testing.assert_close(hk, hp, rtol=TOL, atol=TOL)
        assert torch.equal(vk[:, FROZEN], vals0[:, FROZEN])
