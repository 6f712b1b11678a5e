"""gen_tpu_torch's systematic resampling (kernel K4's module) against
gen_tpu's, in float64.

gen_tpu's Pallas K4 has no interpret mode; its plain paths stand in. The
port's CPU route, its searchsorted and rank-merge paths and the literal
count ``systematic_parents_count`` (K4's plain version) all equal gen_tpu's
``_jnp_systematic`` (searchsorted-left, the kernel's own definition)
exactly, across N (one particle, ragged, on both sides of the 32,768
dispatch), u (0, 0.5, 1 - 2^-24), zero-weight runs and a particle holding
all the mass; ``_counting_systematic`` equals gen_tpu's. gen_tpu's rank
merge and counting variants count a cdf entry equal to a position, so on
an exact tie they depart from the definition (ROADMAP queue 3); the test
pins that case down. In float32 the cdfs differ: torch accumulates its
CPU cumsum in float64, XLA in float32. The ``cuda``-marked test holds K4
to its plain version on the card."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu_torch as tt  # noqa: E402
from gen_tpu.ops import resample as J  # noqa: E402
from gen_tpu_torch.ops import resample as P  # noqa: E402

US = (0.0, 0.5, 1.0 - 2.0 ** -24)


def _log_weights(n, case, rng):
    lw = rng.standard_normal(n) * 2.0
    if case == "zero_runs" and n > 1:
        # runs of zero weight inside and at the end; particle 0 keeps mass
        lw[1 + n // 7: 1 + n // 3] = -np.inf
        lw[-max(1, n // 10):] = -np.inf
        lw[n // 2] = -np.inf
    elif case == "dominant":
        lw[:] = -np.inf
        lw[(3 * n) // 4] = 0.0
    return lw


@pytest.mark.parametrize("n", [1, 1000, 4096, 32768, 65536])
@pytest.mark.parametrize("case", ["random", "zero_runs", "dominant"])
def test_parents_equal_gen_tpu(n, case):
    lw = _log_weights(n, case, np.random.default_rng(n))
    lw_j, lw_t = jnp.asarray(lw), torch.tensor(lw)
    zero = np.flatnonzero(np.isneginf(lw))
    for u in US:
        uj, ut = jnp.float64(u), torch.tensor(u, dtype=torch.float64)
        ref = np.asarray(J._jnp_systematic(lw_j, uj))
        route = P.systematic_resample(lw_t, ut)
        assert route.dtype == torch.int32 and route.shape == (n,)
        for got in (route, P._jnp_systematic(lw_t, u),
                    P._sorted_systematic(lw_t, u)):
            np.testing.assert_array_equal(got.numpy(), ref)
        if n <= 4096:
            cdf = P.normalized_cdf(lw_t)
            np.testing.assert_array_equal(
                P.systematic_parents_count(cdf, ut).numpy(), ref)
            np.testing.assert_array_equal(P.resample_cdf(cdf, u).numpy(),
                                          ref)
        np.testing.assert_array_equal(
            P._counting_systematic(lw_t, u).numpy(),
            np.asarray(J._counting_systematic(lw_j, uj)))
        j_sorted = np.asarray(J._sorted_systematic(lw_j, uj))
        if case == "dominant" and u == 0.0 and n > 1:
            # position 0 equals the zero cdf of the particles before the
            # dominant one: gen_tpu's rank merge counts them
            k = (3 * n) // 4
            assert ref[0] == 0 and j_sorted[0] == k
            np.testing.assert_array_equal(j_sorted[1:], ref[1:])
        else:
            np.testing.assert_array_equal(j_sorted, ref)
        if u > 0:
            # a zero-weight particle is never chosen (at u = 0 position 0
            # counts no cdf entry below it and lands on particle 0)
            assert not np.isin(ref, zero).any()
        if case == "dominant" and u > 0:
            assert (ref == (3 * n) // 4).all()
        assert np.all(np.diff(ref) >= 0)


def test_offspring_proportional_to_weights():
    """tests/test_aux.py's check, with the port's keys."""
    lw = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=torch.float64))
    parents = P.systematic_resample(lw, 0.5)
    counts = np.bincount(parents.numpy(), minlength=4)
    assert parents.shape == (4,) and counts[3] >= counts[0]
    key = tt.random.PRNGKey(0, "cpu")
    total = np.zeros(4)
    for s in range(200):
        u = tt.random.uniform(tt.random.fold_in(key, s), (),
                              torch.float64)
        total += np.bincount(P.systematic_resample(lw, u).numpy(),
                             minlength=4)
    np.testing.assert_allclose(total / total.sum(), [0.1, 0.2, 0.3, 0.4],
                               atol=0.02)


def test_rank_merge_any_query_length():
    """The rank merge answers m != n queries (conditional SMC uses n-1)."""
    rng = np.random.default_rng(5)
    cdf = np.cumsum(rng.uniform(size=50))
    cdf /= cdf[-1]
    q = np.sort(rng.uniform(size=37))
    np.testing.assert_array_equal(
        P._rank_merge_parents(torch.tensor(cdf), torch.tensor(q)).numpy(),
        np.asarray(J._rank_merge_parents(jnp.asarray(cdf), jnp.asarray(q))))


def test_positions_round_like_xla():
    """``(i + u) / n`` compiled by XLA is ``(i + u) * (1/n)``."""
    for n in (7, 999, 1000):
        for dt, tdt in ((jnp.float32, torch.float32),
                        (jnp.float64, torch.float64)):
            u = 0.37
            ref = np.asarray(jax.jit(
                lambda u: (jnp.arange(n, dtype=dt) + u) / n)(dt(u)))
            got = P.positions(n, torch.tensor(u, dtype=tdt), tdt, "cpu")
            np.testing.assert_array_equal(got.numpy(), ref)


def test_source_and_build_job():
    name, src, sigs = P.build_job()
    assert name == "resample"
    assert set(sigs) == {"resample_systematic_f32",
                         "resample_systematic_f64"}
    for entry in sigs:
        assert f'extern "C" int {entry}(' in src
    assert "gen_tpu/ops/resample.py" in src


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    for dtype in (torch.float32, torch.float64):
        for n in (1, 1000, 4096, 32768):
            for case in ("random", "zero_runs", "dominant"):
                lw = torch.tensor(_log_weights(n, case, rng), dtype=dtype,
                                  device=dev)
                cdf = P.normalized_cdf(lw)
                for u in US:
                    ut = torch.tensor(u, dtype=dtype, device=dev)
                    before = P.systematic_resample.launches
                    got = P.resample_cdf(cdf, ut)
                    assert P.systematic_resample.launches == before + 1
                    torch.testing.assert_close(
                        got, P.systematic_parents_count(cdf, ut),
                        rtol=0, atol=0)
