"""Staging part c against gen_tpu: streamed per-point likelihoods.

- ``tests/test_hmc_fused.py::test_scalarize_streams_data_dependent_residual``'s
  n = 5,000 student-t logp stages with the data as a one-row stream table
  and a handful of residual constants, and gives gen_tpu's logp and
  gradient at rtol 2e-5 and 1e-3; the non-additive variant is refused
  with the data-sum named; with ``allow_stream=False`` the residual cap
  refuses it, as gen_tpu's does.
- The plain stream loop sums in the kernels' order: 32 lanes, each
  Kahan-compensated over every 32nd point, then the butterfly; bit for bit
  against a numpy transcription, and the same bits whatever the block size
  of the plain evaluation.
- Data arrays read twice share a row, a bool mask becomes a row, an array
  of one value folds, and a per-point value combined with an unrolled
  array is refused. The CUDA rendering holds the loop and the kernels run a
  warp per chain."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gen_tpu.ops.scalarize import stage_scalarized as j_stage  # noqa: E402
from gen_tpu_torch.ops import hmc_fused, nuts_fused, scalarize  # noqa: E402
from gen_tpu_torch.ops import staged_eval  # noqa: E402
from gen_tpu_torch.ops.scalarize import stage_scalarized  # noqa: E402

DATA = np.random.default_rng(0).standard_normal(5000).astype(np.float32)


def _logps(nonadd=False):
    """(gen_tpu logp, port logp) of gen_tpu's streamed test likelihood."""
    def make(lib, data):
        def logp(x):
            z = (data - x[0]) / lib.exp(x[1])
            s = lib.sum(-lib.log1p(z * z))
            return lib.exp(s * 1e-4) if nonadd else s - x[1] * 5000
        return logp
    return make(jnp, jnp.asarray(DATA)), make(torch, torch.from_numpy(DATA))


def test_staged_stream_logp_matches_gen_tpu():
    jl, tl = _logps()
    staged = stage_scalarized(tl, 2, "cpu")
    assert staged.streams and staged.stream_data.shape == (1, 5000)
    np.testing.assert_array_equal(staged.stream_data[0].numpy(), DATA)
    assert staged.res_consts.shape[0] < 32
    assert j_stage(jl, 2).stream_data is not None     # gen_tpu streams too
    V = (np.random.default_rng(1).standard_normal((2, 24)) * 0.5
         ).astype(np.float32)
    lp, g = staged.vag(torch.from_numpy(V))
    ref, gref = jax.jit(jax.vmap(jax.value_and_grad(jl)))(jnp.asarray(V.T))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(gref).T, rtol=1e-3,
                               atol=1e-3)


def test_stream_refusals():
    _, tl = _logps()
    with pytest.raises(ValueError, match="staged scalars"):
        stage_scalarized(tl, 2, "cpu", allow_stream=False)
    _, nonadd = _logps(nonadd=True)
    with pytest.raises(ValueError, match="data-sum 'sum.*' re-enters"):
        stage_scalarized(nonadd, 2, "cpu")
    w = torch.linspace(0.5, 1.5, 3000)

    def unrolled(x):      # an x-dependent array over the data, not a sum
        return (torch.sort(x[0] * w).values * w).sum()

    with pytest.raises(ValueError, match="sort"):
        stage_scalarized(unrolled, 1, "cpu")


def _lanes_reference(vals, lanes):
    """numpy float32 transcription of the kernels' stream loop for one
    chain: lane l sums points l, l + lanes, ... with Kahan compensation,
    its total is acc - comp; within each warp v += v[l ^ off] for off = 16,
    8, 4, 2, 1; then the warps' totals in warp order."""
    f = np.float32
    acc, comp = np.zeros(lanes, f), np.zeros(lanes, f)
    for i, v in enumerate(vals):
        lane = i % lanes
        y = f(f(v) - comp[lane])
        t = f(acc[lane] + y)
        comp[lane] = f(f(t - acc[lane]) - y)
        acc[lane] = t
    tot = (acc - comp).astype(f).reshape(-1, 32)
    for off in (16, 8, 4, 2, 1):
        tot = (tot + tot[:, np.arange(32) ^ off]).astype(f)
    assert all(len(set(w.tolist())) == 1 for w in tot)
    out = tot[0, 0]
    for w in range(1, tot.shape[0]):
        out = f(out + tot[w, 0])
    return out


@pytest.mark.parametrize("per_warp,lanes", [(1 << 16, 32), (600, 128)])
def test_plain_loop_sums_in_the_kernels_order(monkeypatch, per_warp, lanes):
    """A warp per chain, and (with fewer points per warp allowed) four
    warps per chain."""
    monkeypatch.setattr(scalarize, "POINTS_PER_WARP", per_warp)
    data = (np.random.default_rng(2).standard_normal(2103) * 30.0 + 7.0
            ).astype(np.float32)
    t = torch.from_numpy(data)

    def logp(x):
        return torch.sum(torch.log1p((t - x[0]) ** 2)) + x[0]

    staged = stage_scalarized(logp, 1, "cpu")
    assert staged.lanes == lanes
    assert f"__shared__ float _red[2][{lanes // 32}];" in \
        staged.cuda_source() or lanes == 32
    X = torch.tensor([[0.25, -3.0, 11.5]])
    lp_default, g_default = staged.vag(X)
    monkeypatch.setattr(scalarize, "PLAIN_STREAM_BYTES", 1)  # one step/block
    lp, g = staged.vag(X)
    assert torch.equal(lp, lp_default) and torch.equal(g, g_default)
    for j, x0 in enumerate(X[0].tolist()):
        vals = np.log1p(np.square(data - np.float32(x0)).astype(np.float32))
        want = np.float32(_lanes_reference(vals, lanes) + np.float32(x0))
        assert lp[j].item() == float(want)


def test_rows_masks_and_constants():
    xs = torch.from_numpy(DATA[:3000])
    mask = xs > 0.5
    ones = torch.ones(3000)

    def logp(x):
        r = xs - x[0]
        inside = torch.where(mask, -r * r, -0.5 * r * r)
        return (inside * ones).sum() + (xs * x[1]).sum() - 0.1 * x[1] ** 2

    staged = stage_scalarized(logp, 2, "cpu")
    # xs read three times, and the mask: two rows; the ones fold away
    assert staged.stream_data.shape == (2, 3000)
    V = torch.tensor([[0.1, -0.4], [0.7, 2.0]])
    lp, g = staged.vag(V)
    ref_g, ref = torch.func.vmap(torch.func.grad_and_value(logp))(V.T)
    np.testing.assert_allclose(lp.numpy(), ref.numpy(), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), ref_g.T.numpy(), rtol=1e-4,
                               atol=1e-3)


def test_stream_sources_render_with_a_warp_per_chain():
    _, tl = _logps()
    staged = hmc_fused.stage(tl, 2, "cpu")
    src = staged.cuda_source()
    assert "for (int i = (int)(threadIdx.x & 31u); i < n_pts; i += 32)" in src
    assert src.count("_kahan(sa") == len(staged.sums) == 3
    assert src.count("__shfl_xor_sync(0xffffffffu") == 5 * 3
    assert "__device__ __forceinline__ void staged_vag(" in src
    for k_src in (hmc_fused.kernel_source(staged),
                  nuts_fused.kernel_source(staged, 6, True),
                  nuts_fused.kernel_source(staged, 6, False),
                  staged_eval.build_job(staged)[1]):
        assert src in k_src and "_LANES 32\n" in k_src and "@@" not in k_src


@pytest.mark.cuda
def test_stream_kernels_match_plain_versions_on_cuda():
    """On a card: the staged-code kernel and K1 with the stream loop (one
    warp per chain at n = 5,000; eight at n = 300,000) against their plain
    versions, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for n_pts in (5000, 300_000):
        data = torch.from_numpy(np.random.default_rng(3).standard_normal(
            n_pts).astype(np.float32)).to(dev)

        def logp(x):
            z = (data - x[0]) / torch.exp(x[1])
            return torch.sum(-torch.log1p(z * z)) - 0.5 * x[1] ** 2

        staged = hmc_fused.stage(logp, 2, dev)
        assert staged.lanes == (32 if n_pts < 65536 else 256)
        x = 0.3 * torch.randn(2, 777, device=dev)
        lk, gk = staged_eval.staged_vag(staged, x)
        lp, gp = staged.vag(x)
        assert torch.equal(lk, lp) and torch.equal(gk, gp)
        g = torch.Generator(dev).manual_seed(5)
        n, steps = 300, 3
        inj = (torch.full((steps,), 0.02, device=dev),
               torch.randn(steps, n, 2, device=dev, generator=g),
               torch.rand(steps, n, device=dev, generator=g) + 1e-6)
        v0 = 0.1 * torch.randn(n, 2, device=dev, generator=g)
        kw = dict(n_steps=steps, L=2, eps=0.02, collect_idx=None,
                  injected_rng=inj)
        key = torch.zeros(2, dtype=torch.int64, device=dev)
        out_k = hmc_fused.hmc_chains_fused(key, logp, v0, **kw)
        out_p = hmc_fused.hmc_chains_fused_plain(key, logp, v0, **kw)
        for a, b in zip(out_k, out_p):
            assert torch.equal(a, b)
