"""The one-leapfrog-per-tick fused NUTS kernel K6 of the port, through its
plain version, against gen_tpu.

- ``nuts_chains_fused(paired=False)`` on a CPU tensor runs K6's plain
  version (``run_ticks`` through the staged program); it equals gen_tpu's
  twin of the Pallas kernel, ``nuts_fsm(num_sample_slots=8,
  ckpt_bf16=True)``, under the same injected 5 streams, in float32: every
  completed and history count equal, values, histories and accept
  statistics within 1e-5 (the tolerance of gen_tpu's own kernel-vs-twin
  test; the two differ in the coordinate-sum order and in the staged vs
  autodiff gradient, a few ulp). Configurations: eight_schools d=10, a
  correlated 4-d Gaussian with divergences, and a frozen coordinate.
- The history and count streams have one row per tick; the chunked runner
  stitches them as gen_tpu's does, and ``nuts_collect_draws(paired=False)``
  equals the extraction from the stitched streams.
- The CUDA source renders; the ``cuda``-marked test holds the kernel to
  its plain version on a card.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.inference.nuts_fsm import nuts_fsm as j_fsm  # noqa: E402
from gen_tpu.inference.target import FlatTarget as JFlatTarget  # noqa: E402
from gen_tpu.ops.nuts_fused import (  # noqa: E402
    nuts_chains_fused_chunked as j_chunked)
from gen_tpu_torch.inference import FlatTarget  # noqa: E402
from gen_tpu_torch.ops import nuts_fused  # noqa: E402
from gen_tpu_torch.ops.hmc_fused import stage  # noqa: E402
from gen_tpu_torch.ops.nuts_fused import (  # noqa: E402
    extract_completed_draws, nuts_chains_fused, nuts_chains_fused_chunked,
    nuts_chains_fused_plain, nuts_collect_draws)
from torch_port_models import (SCHOOL_ADDRS, SIGMAS_8, YS_8,  # noqa: E402
                               jax_eight_schools, torch_eight_schools)

TOL = 1e-5
SDS = np.array([1.0, 3.0, 0.5, 2.0], np.float32)


def _gauss(coupling):
    def make(sum_, sds):
        def logp(x):
            out = -0.5 * sum_((x / sds) ** 2)
            for a, i, j in coupling:
                out = out - a * x[i] * x[j]
            return out
        return logp

    return make(jnp.sum, jnp.asarray(SDS)), make(torch.sum,
                                                 torch.from_numpy(SDS))


def _schools():
    sig, ys = SIGMAS_8.astype(np.float32), YS_8.astype(np.float32)
    with jax.enable_x64(False):
        jtr, _ = jax_eight_schools.generate(
            jax.random.PRNGKey(0), (jnp.asarray(sig),),
            gt.choicemap(ys=jnp.asarray(ys)))
        lj = JFlatTarget(jtr, gt.select(*SCHOOL_ADDRS)).logp
    ttr, _ = torch_eight_schools.generate(
        tt.random.PRNGKey(0, "cpu"), (torch.from_numpy(sig),),
        tt.choicemap(ys=torch.from_numpy(ys)))
    return lj, FlatTarget(ttr, tt.select(*SCHOOL_ADDRS)).logp


# name -> (logps, d, eps, max_depth, threshold, inverse mass, ticks, seed)
CONFIGS = {
    "eight_schools": (_schools, 10, 0.3, 6, 1000.0, None, 60, 1),
    "divergence": (lambda: _gauss(((0.3, 0, 2),)), 4, 0.9, 5, 4.0, None, 80,
                   7),
    "frozen": (lambda: _gauss(((0.3, 0, 2), (0.1, 1, 2))), 4, 0.5, 5, 1000.0,
               SDS ** 2 * np.array([1, 1, 0, 1], np.float32), 60, 3),
}


def _streams(seed, ticks, n, d):
    """gen_tpu's 5 injected streams, made by numpy: z (ticks, n, d) and 4
    uniforms (ticks, n) kept inside [1e-6, 1 - 1e-6]."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((ticks, n, d)).astype(np.float32)
    us = [np.clip(rng.uniform(size=(ticks, n)), 1e-6, 1 - 1e-6)
          .astype(np.float32) for _ in range(4)]
    return (z, *us)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernel_plain_version_matches_gen_tpu(name):
    make, d, eps, md, thr, inv, ticks, seed = CONFIGS[name]
    lj, lt = make()
    n = 96
    scale = SDS if d == 4 else np.ones(d, np.float32)
    vals0 = (np.random.default_rng(seed).standard_normal((n, d)) * scale
             ).astype(np.float32)
    inj = _streams(seed, ticks, n, d)
    with jax.enable_x64(False):
        injc = tuple(jnp.moveaxis(jnp.asarray(x), 0, 1) for x in inj)
        res, (hj, hcj) = jax.vmap(lambda kk, t, *xs: j_fsm(
            kk, jax.value_and_grad(lj), t, eps, ticks, max_depth=md,
            inv_mass_diag=None if inv is None else jnp.asarray(inv),
            num_sample_slots=8, divergence_threshold=thr, injected_rng=xs,
            collect_idx=2, ckpt_bf16=True))(
            jax.random.split(jax.random.PRNGKey(2), n), jnp.asarray(vals0),
            *injc)
        ref = {k: np.asarray(v) for k, v in dict(
            counts=res.counts, theta=res.theta, div=res.num_divergent,
            accept=res.mean_accept, depth=res.mean_depth,
            hist=hj.T, hcnt=hcj.T).items()}
    before = nuts_chains_fused.launches
    v, hist, hcnt, cnt, stats = nuts_chains_fused(
        tt.random.PRNGKey(1, "cpu"), lt, torch.from_numpy(vals0),
        num_ticks=ticks, eps=eps, max_depth=md, inv_mass_diag=inv,
        collect_idx=2, divergence_threshold=thr, injected_rng=inj)
    assert nuts_chains_fused.launches == before     # CPU: no kernel launch
    # one history row and one count row per tick
    assert hist.shape == (ticks, n) and hcnt.shape == (ticks, n)
    assert hcnt.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), ref["counts"])
    np.testing.assert_array_equal(hcnt.numpy(), ref["hcnt"])
    np.testing.assert_array_equal(stats["num_divergent"].numpy(), ref["div"])
    np.testing.assert_allclose(v.numpy(), ref["theta"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hist.numpy(), ref["hist"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(stats["mean_accept"].numpy(), ref["accept"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(stats["mean_depth"].numpy(), ref["depth"],
                               rtol=TOL)
    assert cnt.min() > 0
    # counts rise by at most one per tick
    assert set(np.unique(np.diff(hcnt.numpy(), axis=0))) <= {0, 1}
    if name == "divergence":
        assert ref["div"].sum() > 50, ref["div"].sum()
    if name == "frozen":
        np.testing.assert_array_equal(v[:, 2].numpy(), vals0[:, 2])
        np.testing.assert_array_equal(
            hist.numpy(), np.broadcast_to(vals0[:, 2], hist.shape))


def test_collect_all_layout():
    """collect_idx=None: the whole (ticks, n, d) state, equal to the
    per-coordinate collections of the same run."""
    lj, lt = _gauss(((0.3, 0, 2),))
    n, ticks = 40, 30
    vals0 = torch.from_numpy((np.random.default_rng(2).standard_normal(
        (n, 4)) * SDS).astype(np.float32))
    inj = _streams(4, ticks, n, 4)
    kw = dict(num_ticks=ticks, eps=0.5, max_depth=5, injected_rng=inj)
    key = tt.random.PRNGKey(0, "cpu")
    _, h_all, hc_all, _, _ = nuts_chains_fused_plain(key, lt, vals0,
                                                     collect_idx=None, **kw)
    assert h_all.shape == (ticks, n, 4)
    for c in (0, 3):
        _, h_c, hc_c, _, _ = nuts_chains_fused_plain(key, lt, vals0,
                                                     collect_idx=c, **kw)
        torch.testing.assert_close(h_all[:, :, c], h_c, rtol=0, atol=0)
        torch.testing.assert_close(hc_all, hc_c, rtol=0, atol=0)


def test_chunked_runner_matches_gen_tpu():
    """The chunked runner (paired=False) on the plain version against
    gen_tpu's on its XLA twin from the same key: the per-chain keys agree
    bit for bit, so nearly every chain takes the same path (float32
    normals agree to 4 ulp, not bit for bit); stitching is exact in both
    and the history has one row per tick."""
    sds = np.array([1.0, 2.0], np.float32)
    n, ticks = 64, 240
    vals0 = (np.random.default_rng(6).standard_normal((n, 2)) * sds
             ).astype(np.float32)
    kw = dict(eps=0.7, max_depth=4, collect_idx=1)
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
    assert hist.shape == hj.shape == (ticks, n)
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
    kw = dict(eps=0.7, max_depth=4, collect_idx=None, paired=False)

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
    assert draws.shape == (m, n, 2)
    torch.testing.assert_close(draws, ref, rtol=0, atol=0)


def test_chunk_budget_counts_rows_per_tick():
    """The history budget sees one row per tick for K6 and per pair for
    K3, and all coordinates against one: at 131,072 chains and d=10 a
    collect-all chunk holds 11x fewer ticks than a one-coordinate one."""
    n, d = 131072, 10
    one = nuts_fused._chunk_ticks(n, d, 0, 10 ** 6, paired=False)
    every = nuts_fused._chunk_ticks(n, d, None, 10 ** 6, paired=False)
    pair = nuts_fused._chunk_ticks(n, d, 0, 10 ** 6, paired=True)
    row = 4 * n
    assert one * 2 * row <= nuts_fused.HIST_BUDGET_BYTES
    assert every * 11 * row <= nuts_fused.HIST_BUDGET_BYTES
    assert one // every in (5, 6) and pair == 2 * one


def test_k6_cuda_source_renders():
    sds = torch.from_numpy(SDS)
    staged = stage(lambda x: -0.5 * torch.sum((x / sds) ** 2), 4, "cpu")
    src = nuts_fused.kernel_source(staged, 6, paired=False)
    assert "@@" not in src
    assert "#define NUTS_D 4" in src and "#define NUTS_MD 6" in src
    assert 'extern "C" int nuts_tick_launch(' in src
    assert "philox4x32_10" in src and "uturn_block" in src
    # the shared helpers are spliced into both kernels' sources, so an edit
    # of the header changes both build hashes
    common = (nuts_fused._CSRC_DIR / "nuts_common.cuh").read_text()
    assert common in src
    assert common in nuts_fused.kernel_source(staged, 6, paired=True)


@pytest.mark.cuda
def test_k6_matches_plain_version_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    sds = torch.from_numpy(SDS).to(dev)

    def logp(x):
        return -0.5 * torch.sum((x / sds) ** 2) - 0.3 * x[0] * x[2]

    n, ticks = 4096, 80
    inj = _streams(7, ticks, n, 4)
    vals0 = torch.randn(n, 4, device=dev) * sds
    kw = dict(num_ticks=ticks, eps=0.9, max_depth=5, collect_idx=None,
              divergence_threshold=4.0, injected_rng=inj)
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
