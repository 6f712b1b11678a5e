"""The pair-scheduled FSM-NUTS engine of the port against gen_tpu.

- The port's ``nuts_fsm_paired`` equals gen_tpu's under the same injected
  8 streams on gen_tpu's three pair-kernel configurations
  (``tests/test_nuts_fused.py``): a correlated 4-d Gaussian at eps 0.45,
  the divergence paths (eps 0.9, threshold 4.0) and a frozen coordinate.
  Completed-trajectory counts, history counts and divergences exactly;
  samples, histories and accept statistics within 1e-5 (the tolerance of
  gen_tpu's own kernel-vs-twin test).
- The kernel's plain version (``nuts_chains_fused`` on a CPU tensor: the
  same loop through the staged program) equals the port's
  ``nuts_fsm_paired`` the same way.
- The pair schedule samples the right distribution: completed draws of a
  3-d anisotropic Gaussian within 6% of the exact variances, the
  multi-dimensional check that catches a wrong checkpoint momentum.
- The staged eight_schools value and gradient, the draw extraction and the
  chunked drivers, against gen_tpu or the unchunked run.
- The CUDA source renders; the ``cuda``-marked test holds the kernel to its
  plain version on a card.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.inference.nuts_fsm import nuts_fsm_paired as j_pair  # noqa: E402
from gen_tpu.inference.target import FlatTarget as JFlatTarget  # noqa: E402
from gen_tpu.ops.nuts_fused import (  # noqa: E402
    extract_completed_draws as j_extract,
    nuts_chains_fused_chunked as j_chunked)
from gen_tpu.ops.scalarize import stage_scalarized as j_stage  # noqa: E402
from gen_tpu_torch.inference import FlatTarget  # noqa: E402
from gen_tpu_torch.inference.nuts_fsm import nuts_fsm_paired  # noqa: E402
from gen_tpu_torch.ops import nuts_fused  # noqa: E402
from gen_tpu_torch.ops.hmc_fused import stage  # noqa: E402
from gen_tpu_torch.ops.nuts_fused import (  # noqa: E402
    extract_completed_draws, nuts_chains_fused, nuts_chains_fused_chunked,
    nuts_chains_fused_plain, nuts_collect_draws)
from gen_tpu_torch.ops.scalarize import stage_scalarized  # noqa: E402
from torch_port_models import (SCHOOL_ADDRS, SIGMAS_8, YS_8,  # noqa: E402
                               jax_eight_schools, torch_eight_schools)

TOL = 1e-5
SDS = np.array([1.0, 3.0, 0.5, 2.0], np.float32)

# gen_tpu's pair-kernel configurations (tests/test_nuts_fused.py):
# name -> (eps, max_depth, divergence threshold, inverse mass, coupling
# terms (a, i, j) of -a x_i x_j, pairs, stream seed)
CONFIGS = {
    "gaussian": (0.45, 5, 1000.0, SDS ** 2, ((0.3, 0, 2), (0.1, 1, 3)), 40,
                 11),
    "divergence": (0.9, 5, 4.0, None, ((0.3, 0, 2),), 40, 7),
    "frozen": (0.5, 5, 1000.0, (SDS ** 2) * np.array([1, 1, 0, 1],
                                                     np.float32),
               ((0.3, 0, 2), (0.1, 1, 2)), 24, 3),
}


def _logps(coupling):
    """(gen_tpu logp, port logp) of the correlated 4-d Gaussian."""
    def make(sum_, sds):
        def logp(x):
            out = -0.5 * sum_((x / sds) ** 2)
            for a, i, j in coupling:
                out = out - a * x[i] * x[j]
            return out
        return logp

    return make(jnp.sum, jnp.asarray(SDS)), make(torch.sum,
                                                 torch.from_numpy(SDS))


def _streams(seed, pairs, n, d):
    """gen_tpu's 8 injected streams, made by numpy: z (pairs, n, d) and 7
    uniforms (pairs, n) kept inside [1e-6, 1 - 1e-6]."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((pairs, n, d)).astype(np.float32)
    us = [np.clip(rng.uniform(size=(pairs, n)), 1e-6, 1 - 1e-6)
          .astype(np.float32) for _ in range(7)]
    return (z, *us)


def _vag_t(logp):
    gv = torch.func.grad_and_value(logp)

    def vag(x):
        g, v = gv(x)
        return v, g
    return vag


def _run_gen_tpu(name, n=128):
    eps, md, thr, inv, coupling, pairs, seed = CONFIGS[name]
    d = 4
    vals0 = (np.random.default_rng(0).standard_normal((n, d)) * SDS
             ).astype(np.float32)
    inj = _streams(seed, pairs, n, d)
    lj, lt = _logps(coupling)
    with jax.enable_x64(False):
        injc = tuple(jnp.moveaxis(jnp.asarray(x), 0, 1) for x in inj)
        res, (hist, hcnt) = jax.vmap(
            lambda kk, t, *xs: j_pair(
                kk, jax.value_and_grad(lj), t, eps, pairs, max_depth=md,
                inv_mass_diag=None if inv is None else jnp.asarray(inv),
                divergence_threshold=thr, injected_rng=xs, collect_idx=2,
                ckpt_bf16=True))(
            jax.random.split(jax.random.PRNGKey(2), n), jnp.asarray(vals0),
            *injc)
        ref = dict(counts=np.asarray(res.counts), theta=np.asarray(res.theta),
                   hist=np.asarray(hist).T, hcnt=np.asarray(hcnt).T,
                   div=np.asarray(res.num_divergent),
                   accept=np.asarray(res.mean_accept),
                   depth=np.asarray(res.mean_depth))
    return ref, vals0, inj, lt


def _check(ref, counts, theta, hist, hcnt, div, accept, depth):
    np.testing.assert_array_equal(counts, ref["counts"])
    np.testing.assert_array_equal(hcnt, ref["hcnt"])
    np.testing.assert_array_equal(div, ref["div"])
    np.testing.assert_allclose(theta, ref["theta"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hist, ref["hist"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(accept, ref["accept"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(depth, ref["depth"], rtol=TOL)
    assert counts.min() > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pair_twin_matches_gen_tpu(name):
    ref, vals0, inj, lt = _run_gen_tpu(name)
    eps, md, thr, inv, _, pairs, _ = CONFIGS[name]
    res, (hist, hcnt) = nuts_fsm_paired(
        None, _vag_t(lt), torch.from_numpy(vals0), eps, pairs,
        max_depth=md, inv_mass_diag=inv, divergence_threshold=thr,
        injected_rng=inj, collect_idx=2)
    _check(ref, res.counts.numpy(), res.theta.numpy(), hist.numpy(),
           hcnt.numpy(), res.num_divergent.numpy(), res.mean_accept.numpy(),
           res.mean_depth.numpy())
    if name == "divergence":
        assert ref["div"].sum() > 50, ref["div"].sum()
    if name == "frozen":
        np.testing.assert_array_equal(res.theta[:, 2].numpy(), vals0[:, 2])
        np.testing.assert_array_equal(
            hist.numpy(), np.broadcast_to(vals0[:, 2], hist.shape))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernel_plain_version_matches_gen_tpu(name):
    """nuts_chains_fused on a CPU tensor runs the plain version through the
    staged program; it is held to gen_tpu's twin as the Pallas kernel is."""
    ref, vals0, inj, lt = _run_gen_tpu(name)
    eps, md, thr, inv, _, pairs, _ = CONFIGS[name]
    before = nuts_chains_fused.launches
    v, hist, hcnt, cnt, stats = nuts_chains_fused(
        tt.random.PRNGKey(1, "cpu"), lt, torch.from_numpy(vals0),
        num_ticks=2 * pairs, eps=eps, max_depth=md, inv_mass_diag=inv,
        collect_idx=2, divergence_threshold=thr, injected_rng=inj,
        paired=True)
    assert nuts_chains_fused.launches == before     # CPU: no kernel launch
    assert hist.shape == (pairs, 128) and hcnt.dtype == torch.int32
    _check(ref, cnt.numpy(), v.numpy(), hist.numpy(), hcnt.numpy(),
           stats["num_divergent"].numpy(), stats["mean_accept"].numpy(),
           stats["mean_depth"].numpy())


def test_pair_schedule_moments_match_exact():
    """Completed draws of the pair twin, own randomness, on an anisotropic
    3-d Gaussian: variances within 6% and means within 0.05 sd (gen_tpu's
    gate; a checkpoint that stored the pre-block momentum gives ~10% low
    variances here)."""
    sds = torch.tensor([1.0, 3.0, 0.5])
    n, pairs = 1024, 300
    vals0 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n, 3)).astype(np.float32)) * sds
    keys = tt.random.split(tt.random.PRNGKey(1, "cpu"), n)
    res, (hist, hcnt) = nuts_fsm_paired(
        keys, _vag_t(lambda x: -0.5 * torch.sum((x / sds) ** 2)), vals0,
        0.5, pairs, max_depth=6, inv_mass_diag=sds ** 2, collect_idx="all")
    m = int(res.counts.min())
    assert m > 40
    draws = extract_completed_draws(hist, hcnt, m)[m // 4:].double()
    np.testing.assert_allclose(draws.var(dim=(0, 1)).numpy(),
                               (sds ** 2).numpy(), rtol=0.06)
    assert float((draws.mean(dim=(0, 1)) / sds).abs().max()) < 0.05


def test_staged_eight_schools_value_and_grad():
    """eight_schools at d=10: the x-dependent graph unrolls into one
    straight-line program (the data become residual constants); equal to
    torch.func and to gen_tpu's plane_vag within float32 rounding."""
    sig, ys = SIGMAS_8.astype(np.float32), YS_8.astype(np.float32)
    tr, _ = torch_eight_schools.generate(
        tt.random.PRNGKey(0, "cpu"), (torch.from_numpy(sig),),
        tt.choicemap(ys=torch.from_numpy(ys)))
    t = FlatTarget(tr, tt.select(*SCHOOL_ADDRS))
    staged = stage_scalarized(t.logp, 10)
    x = np.random.default_rng(1).standard_normal((10, 64)).astype(
        np.float32)
    lp, g = staged.vag(torch.from_numpy(x))
    lp_ref, g_ref = torch.func.vmap(t.value_and_grad)(torch.from_numpy(x).T)
    np.testing.assert_allclose(lp.numpy(), lp_ref.numpy(), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_ref.T.numpy(), rtol=1e-5,
                               atol=1e-5)
    with jax.enable_x64(False):
        jtr, _ = jax_eight_schools.generate(
            jax.random.PRNGKey(0), (jnp.asarray(sig),),
            gt.choicemap(ys=jnp.asarray(ys)))
        js = j_stage(JFlatTarget(jtr, gt.select(*SCHOOL_ADDRS)).logp, 10)
        lp_j, g_j = map(np.asarray, js.plane_vag(jnp.asarray(x),
                                                 js.res_consts))
    np.testing.assert_allclose(lp.numpy(), lp_j, rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-5, atol=1e-5)
    assert staged.n_res < 64          # ys and sigmas are hoisted


@pytest.mark.parametrize("with_d", [False, True])
def test_extract_completed_draws_matches_gen_tpu(with_d):
    rng = np.random.default_rng(5)
    t, n, d, m = 50, 32, 3, 9
    steps = rng.uniform(size=(t, n)) < 0.3
    hcnt = np.cumsum(steps, axis=0).astype(np.int32)
    hist = rng.standard_normal((t, n, d) if with_d else (t, n)).astype(
        np.float32)
    ref = np.asarray(j_extract(jnp.asarray(hist), jnp.asarray(hcnt), m))
    got = extract_completed_draws(torch.from_numpy(hist),
                                  torch.from_numpy(hcnt), m)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_chunked_driver_matches_gen_tpu():
    """The chunked driver on the plain version against gen_tpu's on its
    XLA twin from the same key: the per-chain keys agree bit for bit, so
    nearly every chain takes the same path (float32 normals agree to 4 ulp,
    not bit for bit); stitching is exact in both."""
    sds = np.array([1.0, 2.0], np.float32)
    n, ticks = 64, 240
    vals0 = (np.random.default_rng(6).standard_normal((n, 2)) * sds
             ).astype(np.float32)
    kw = dict(eps=0.7, max_depth=4, collect_idx=1, paired=True)
    with jax.enable_x64(False):
        sj = jnp.asarray(sds)
        _, hj, hcj, cj, _ = j_chunked(
            jax.random.PRNGKey(5), lambda x: -0.5 * jnp.sum((x / sj) ** 2),
            jnp.asarray(vals0), num_ticks=ticks, chunk_ticks=80,
            use_pallas=False, **kw)
        hj, hcj, cj = map(np.asarray, (hj, hcj, cj))
    st = torch.from_numpy(sds)
    _, hist, hcnt, cnt, stats = nuts_chains_fused_chunked(
        tt.random.PRNGKey(5, "cpu"),
        lambda x: -0.5 * torch.sum((x / st) ** 2), torch.from_numpy(vals0),
        num_ticks=ticks, chunk_ticks=80, **kw)
    assert hist.shape == hj.shape == (ticks // 2, n)
    assert (np.diff(hcnt.numpy(), axis=0) >= 0).all()
    np.testing.assert_array_equal(hcnt[-1].numpy(), cnt.numpy())
    same = (hcnt.numpy() == hcj).all(axis=0)
    assert same.mean() > 0.9, same.mean()
    np.testing.assert_allclose(hist.numpy()[:, same], hj[:, same],
                               rtol=1e-4, atol=1e-4)
    m = int(cnt.min())
    assert m > 10
    draws = extract_completed_draws(hist, hcnt, m)
    assert torch.isfinite(draws).all()
    assert abs(float(draws[m // 4:].mean())) < 0.35


def test_collect_draws_matches_stitched_extraction():
    sds = torch.tensor([1.0, 2.0])
    n, ticks = 64, 240
    vals0 = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (n, 2)).astype(np.float32)) * sds
    kw = dict(eps=0.7, max_depth=4, collect_idx=1, paired=True)

    def logp(x):
        return -0.5 * torch.sum((x / sds) ** 2)

    key = tt.random.PRNGKey(5, "cpu")
    _, hist, hcnt, cnt, _ = nuts_chains_fused_chunked(
        key, logp, vals0, num_ticks=ticks, chunk_ticks=80, **kw)
    m = int(cnt.min())
    ref = extract_completed_draws(hist, hcnt, m)
    draws, _, counts, used = nuts_collect_draws(
        key, logp, vals0, num_draws=m, chunk_ticks=80, max_ticks=ticks, **kw)
    assert used <= ticks and bool((counts >= m).all())
    torch.testing.assert_close(draws, ref, rtol=0, atol=0)


def test_unpaired_engine_raises_naming_its_kernel():
    with pytest.raises(NotImplementedError, match="K6"):
        nuts_chains_fused(tt.random.PRNGKey(0, "cpu"),
                          lambda x: -0.5 * torch.sum(x * x),
                          torch.zeros(8, 2), num_ticks=4, eps=0.1)


def test_cuda_source_renders():
    sds = torch.from_numpy(SDS)
    staged = stage(lambda x: -0.5 * torch.sum((x / sds) ** 2), 4, "cpu")
    src = nuts_fused.kernel_source(staged, 5)
    assert "@@" not in src
    assert "#define NUTS_D 4" in src and "#define NUTS_MD 5" in src
    assert f"#define NUTS_R {staged.n_res}" in src
    assert 'extern "C" int nuts_pair_launch(' in src
    assert src.count("  g[") >= 4


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    eps, md, thr, inv, coupling, pairs, seed = CONFIGS["divergence"]
    sds = torch.from_numpy(SDS).to(dev)

    def logp(x):
        return -0.5 * torch.sum((x / sds) ** 2) - 0.3 * x[0] * x[2]

    n = 4096
    inj = _streams(seed, pairs, n, 4)
    vals0 = torch.randn(n, 4, device=dev) * sds
    kw = dict(num_ticks=2 * pairs, eps=eps, max_depth=md, collect_idx=None,
              divergence_threshold=thr, injected_rng=inj, paired=True)
    before = nuts_chains_fused.launches
    out_k = nuts_chains_fused(tt.random.PRNGKey(1, dev), logp, vals0, **kw)
    assert nuts_chains_fused.launches == before + 1
    out_p = nuts_chains_fused_plain(tt.random.PRNGKey(1, dev), logp, vals0,
                                    **kw)
    assert torch.equal(out_k[3], out_p[3]) and torch.equal(out_k[2],
                                                           out_p[2])
    for a, b in zip(out_k[:2], out_p[:2]):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
    for k in out_k[4]:
        torch.testing.assert_close(out_k[4][k], out_p[4][k], rtol=TOL,
                                   atol=TOL)
