"""Staging part c against gen_tpu: streamed per-point likelihoods.

- ``tests/test_hmc_fused.py::test_scalarize_streams_data_dependent_residual``'s
  n = 5,000 student-t logp stages with the data as a one-row stream table
  and a handful of residual constants, and gives gen_tpu's logp and
  gradient at rtol 2e-5 and 1e-3; the non-additive variant is refused
  with the data-sum named; with ``allow_stream=False`` the residual cap
  refuses it, as gen_tpu's does.
- The plain stream loop sums in the kernels' order (``StreamLayout``): per
  lane blocks of P points, masked past the data, added by a pairwise tree,
  one Kahan add per tile, the butterfly, warps in order and split blocks
  in order; bit for bit against a numpy transcription in four layouts,
  and the same bits whatever the block size of the plain evaluation. At
  200,000 points its sums are as close to float64 as the old per-point
  Kahan order's.
- Data arrays read twice share a row, a bool mask becomes a row, an array
  of one value folds, and a per-point value combined with an unrolled
  array is refused. The CUDA rendering holds the tiled loop, and the
  kernels run its layout's warps per chain and chains per block; the
  staged-code kernel has a stream source of its own."""

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


def _layout_reference(vals, lay):
    """numpy float32 transcription of the kernels' stream loop for one
    chain in the ``StreamLayout`` ``lay``: the points in tiles of
    ``lay.tile``, lane l of warp w holding points ``(w P + p) 32 + l`` of
    each, 0.0 past the data; per lane the pairwise tree over its P values,
    then a Kahan add of the tile's total into block ``tile % splits``'s
    sum; each lane's ``acc - comp``, the butterfly ``v + v[l ^ off]``, the
    warps' totals in warp order, the blocks' in block order."""
    f = np.float32
    T, G, W, P = lay.tile, lay.splits, lay.warps, lay.points
    n_tiles = -(-len(vals) // T)
    padded = np.zeros(n_tiles * T, f)
    padded[:len(vals)] = vals
    acc, comp = np.zeros((G, W, 32), f), np.zeros((G, W, 32), f)
    for k, tile in enumerate(padded.reshape(n_tiles, W, P, 32)):
        while tile.shape[1] > 1:
            tile = (tile[:, 0::2] + tile[:, 1::2]).astype(f)
        g = k % G
        y = (tile[:, 0] - comp[g]).astype(f)
        t = (acc[g] + y).astype(f)
        comp[g] = ((t - acc[g]).astype(f) - y).astype(f)
        acc[g] = t
    tot = (acc - comp).astype(f)
    for off in (16, 8, 4, 2, 1):
        tot = (tot + tot[..., np.arange(32) ^ off]).astype(f)
    assert all(len(set(w.tolist())) == 1 for w in tot.reshape(-1, 32))
    per_block = tot[:, 0, 0]
    for w in range(1, W):
        per_block = (per_block + tot[:, w, 0]).astype(f)
    out = per_block[0]
    for g in range(1, G):
        out = f(out + per_block[g])
    return out


def _old_order(vals, lanes):
    """The order the kernels summed in before the tiles: lane l adds the
    points l, l + lanes, ... one Kahan add each, then the butterfly and
    the warps in order."""
    f = np.float32
    steps = -(-len(vals) // lanes)
    v = np.zeros(steps * lanes, f)
    v[:len(vals)] = vals
    acc, comp = np.zeros(lanes, f), np.zeros(lanes, f)
    for row in v.reshape(steps, lanes):
        y = (row - comp).astype(f)
        t = (acc + y).astype(f)
        comp = ((t - acc).astype(f) - y).astype(f)
        acc = t
    tot = (acc - comp).astype(f).reshape(-1, 32)
    for off in (16, 8, 4, 2, 1):
        tot = (tot + tot[:, np.arange(32) ^ off]).astype(f)
    out = tot[0, 0]
    for w in range(1, tot.shape[0]):
        out = f(out + tot[w, 0])
    return out


# (patched module constants, expected (warps, points, splits), whose
# layout): 2,103 points are neither a multiple of P nor of a tile
LAYOUTS = {
    "ragged": ({}, (1, 8, 1), "fused"),
    "chains_with_tail": ({"POINTS_PER_WARP": 600}, (4, 8, 1), "fused"),
    "split_blocks": ({"EVAL_MIN_TILES": 2}, (1, 8, 4), "eval"),
    "eight_warps_p4": ({"POINTS_PER_WARP": 100,
                        "STREAM_SMEM_BYTES": 8 << 10}, (8, 4, 1), "fused"),
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_plain_loop_sums_in_the_kernels_order(monkeypatch, case):
    """Four layouts: a warp per chain, 16 chains a block, over a ragged
    end; four warps per chain, four chains a block (three chains leave a
    tail); the staged-code kernel's chain split over four blocks; eight
    warps per chain with 4 points a lane."""
    patch, (w, p, g), which = LAYOUTS[case]
    for name, value in patch.items():
        monkeypatch.setattr(scalarize, name, value)
    data = (np.random.default_rng(2).standard_normal(2103) * 30.0 + 7.0
            ).astype(np.float32)
    t = torch.from_numpy(data)

    def logp(x):
        return torch.sum(torch.log1p((t - x[0]) ** 2)) + x[0]

    staged = stage_scalarized(logp, 1, "cpu")
    X = torch.tensor([[0.25, -3.0, 11.5]])
    lay = (staged.layout if which == "fused"
           else staged_eval.layout(staged, X.shape[1]))
    assert (lay.warps, lay.points, lay.splits) == (w, p, g)
    assert lay.tile % 16 == 0 and 2103 % lay.tile and 2103 % p
    if which == "fused":
        assert staged.lanes == lay.lanes
        assert lay.chains == scalarize.STREAM_BLOCK_WARPS // w
        assert (f"__shared__ float _red[{lay.chains}][2][{w}];" in
                staged.cuda_source()) == (w > 1)
        lp_default, g_default = staged.vag(X)
    else:
        lp_default, g_default = staged_eval.staged_vag(staged, X)
    if case == "chains_with_tail":
        assert X.shape[1] % lay.chains
    monkeypatch.setattr(scalarize, "PLAIN_STREAM_BYTES", 1)  # a tile a run
    lp, g = staged.vag(X, lay)
    assert torch.equal(lp, lp_default) and torch.equal(g, g_default)
    for j, x0 in enumerate(X[0].tolist()):
        vals = np.log1p(np.square(data - np.float32(x0)).astype(np.float32))
        want = np.float32(_layout_reference(vals, lay) + np.float32(x0))
        assert lp[j].item() == float(want)


def test_blocked_sums_stay_as_close_to_float64():
    """200,000 float32 values of mixed sign and magnitude, summed by the
    plain loop in K3's layout and in the staged-code kernel's (split over
    blocks): each within the old per-point order's distance to the float64
    sum, plus one unit in the last place."""
    rng = np.random.default_rng(7)
    n = 200_000
    vals = (rng.standard_normal(n) * np.exp(rng.uniform(-6, 6, n))
            ).astype(np.float32)
    exact = float(np.sum(vals.astype(np.float64)))
    ulp = float(np.spacing(np.float32(abs(exact))))
    sd = torch.from_numpy(vals).reshape(1, n)
    old_err = abs(float(_old_order(vals, 32 * scalarize.stream_warps(n)))
                  - exact)
    for lay in (scalarize.fused_layout(n, 1),
                scalarize.eval_layout(n, 1, 4)):
        s, = scalarize._stream_sums(lambda rows: [rows[0]], sd, n, 1, (),
                                    0, lay)
        assert float(s) == float(_layout_reference(vals, lay))
        assert abs(float(s) - exact) <= old_err + ulp
    assert scalarize.eval_layout(n, 1, 4).splits > 1


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
    lay = staged.layout
    assert (lay.warps, lay.points, lay.chains) == (1, 8, 16)
    assert "__shared__ __align__(16) float _tile[2][256];" in src
    assert "_stream_tile(_tile[(_j + 1) % 2], sd, _ld" in src
    assert src.count("const int _o = (_w * 8 + _p) * 32 + _lane;") == 2
    assert src.count("_kahan(sa") == len(staged.sums) == 3
    assert src.count("__shfl_xor_sync(0xffffffffu") == 5 * 3
    assert src.count("_live ? ") == 3 and "_red" not in src
    assert "if (_base + 256 <= n_pts) {" in src
    for fn in ("staged_partial(", "staged_finish(", "staged_vag("):
        assert f"__device__ __forceinline__ void {fn}" in src
    for k_src in (hmc_fused.kernel_source(staged),
                  nuts_fused.kernel_source(staged, 6, True),
                  nuts_fused.kernel_source(staged, 6, False)):
        assert "_LANES 32\n" in k_src and "@@" not in k_src
    assert src in hmc_fused.kernel_source(staged)
    assert "#define HMC_BLOCK 512\n" in hmc_fused.kernel_source(staged)
    assert src in nuts_fused.kernel_source(staged, 6, False)
    k3 = nuts_fused.kernel_source(staged, 6, True)
    # K3: one chain a block, so slot 2's branch is block-uniform, and at
    # one warp a chain 4 points a lane
    assert "__syncthreads_or" not in k3 and "if (!m1) {" in k3
    assert "#define NUTS_BLOCK 32\n" in k3
    k3_lay = nuts_fused.stream_layout(staged, True)
    assert (k3_lay.warps, k3_lay.points, k3_lay.chains) == (1, 4, 1)
    assert staged.cuda_source(k3_lay) in k3 and src not in k3
    se = staged_eval.build_job(staged)
    assert se[0] == "staged_stream" and "@@" not in se[1]
    assert staged.cuda_source(staged_eval.layout(staged, 1)) in se[1]
    assert staged_eval.layout(staged, 1 << 16).splits == 1
    assert staged_eval.layout(staged, 1).splits > 1


@pytest.mark.cuda
def test_stream_kernels_match_plain_versions_on_cuda():
    """On a card: the staged-code kernel (777 chains, 128 and 256, and 3
    split over blocks) and K1 with the stream loop (one warp per chain at n = 5,000;
    eight at n = 300,000; 300 chains leave a tail block) against their
    plain versions, bit for bit."""
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
        # 777 leaves a tail block; 128, 256 and 3 split chains
        for n in (777, 128, 256, 3):
            x = 0.3 * torch.randn(2, n, device=dev)
            lk, gk = staged_eval.staged_vag(staged, x)
            lp, gp = staged_eval.staged_vag_plain(staged, x)
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
