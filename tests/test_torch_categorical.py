"""gen_tpu_torch's batched categorical (kernel K5's module) against
gen_tpu's ``ops/categorical.py``.

On the CPU: K5's plain version equals gen_tpu's Pallas kernel run under
the TPU interpreter with injected uniforms, index for index, at (300, 37)
(not multiples of the TPU tiles); the CPU route equals
``jax.random.categorical`` under the same key; a vmapped call equals its
per-key calls. The kernel itself runs only on the card: the
``cuda``-marked test holds it to its plain version with injected
uniforms (ties and a NaN row, K from 4 to 256: every sub-warp width), and
its vmap rule to per-key calls."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gen_tpu.ops.categorical import batched_categorical as j_bc  # noqa: E402
from gen_tpu_torch import random  # noqa: E402
from gen_tpu_torch.ops import categorical as C  # noqa: E402


def _inputs(n, k, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, k)) * 2.0).astype(np.float32)
    u = rng.uniform(1e-6, 1.0, (n, k)).astype(np.float32)
    return logits, u


def test_plain_version_matches_interpret_kernel():
    logits, u = _inputs(300, 37)
    # ties and a constant row: the lowest index must win in both
    logits[7, :] = 0.0
    u[7, :] = 0.5
    with jax.enable_x64(False):
        want = np.asarray(j_bc(jax.random.PRNGKey(0), jnp.asarray(logits),
                               injected_u=jnp.asarray(u), interpret=True))
    got = C.batched_categorical_plain(torch.tensor(logits), torch.tensor(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[7] == 0
    # the CPU entry point with injected uniforms is the plain version
    np.testing.assert_array_equal(C.batched_categorical(
        None, torch.tensor(logits), injected_u=torch.tensor(u)).numpy(),
        want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpu_route_matches_jax_random(dtype):
    logits, _ = _inputs(64, 7, seed=1)
    logits = logits.astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jax.random.categorical(
            jax.random.PRNGKey(5), jnp.asarray(logits), axis=-1))
        want_bc = np.asarray(j_bc(jax.random.PRNGKey(5),
                                  jnp.asarray(logits)))
    got = C.categorical_fast(random.PRNGKey(5, "cpu"), torch.tensor(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want_bc)


def test_vmapped_call_equals_per_key_calls():
    logits = torch.tensor(_inputs(20, 27, seed=2)[0])
    keys = random.split(random.PRNGKey(3, "cpu"), 4)
    got = torch.func.vmap(lambda k: C.categorical_fast(k, logits))(keys)
    for b in range(4):
        torch.testing.assert_close(got[b], C.categorical_fast(keys[b],
                                                              logits))


def test_vmap_rule_folds_the_batch_into_rows(monkeypatch):
    """The custom op's vmap rule, with a CPU stand-in for the launch: the
    batch folds into rows, each batch index keeps its key words, an
    unbatched key serves every batch index."""
    calls = []

    def launch(logits, keys, u, rows_per_key):
        calls.append((logits, keys, u, rows_per_key))
        return torch.arange(logits.shape[0], dtype=torch.int32)

    monkeypatch.setattr(C, "_categorical_op", launch)

    class Info:
        batch_size = 3

    logits = torch.randn(5, 3, 4)        # batch on dim 1
    keys = torch.arange(6, dtype=torch.int64).reshape(3, 1, 2)
    out, out_dim = C._categorical_vmap(Info(), (1, 0, None, None), logits,
                                       keys, None, 5)
    (lg, ks, u, rpk), = calls
    assert out_dim == 0 and out.shape == (3, 5) and u is None and rpk == 5
    torch.testing.assert_close(lg, logits.movedim(1, 0).reshape(15, 4))
    torch.testing.assert_close(ks, keys.reshape(3, 2))
    C._categorical_vmap(Info(), (0, None, 0, None), logits.movedim(1, 0),
                        keys[0], torch.rand(3, 5, 4), 5)
    assert calls[1][1].shape == (3, 2) and calls[1][2].shape == (15, 4)
    assert bool((calls[1][1] == keys[0]).all())


def test_kernel_source_names_its_tpu_kernel():
    src = C.kernel_source()
    assert "gen_tpu/ops/categorical.py::_kernel" in src
    assert "philox4x32_10" in src and "@@NUTS_COMMON@@" not in src


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for n, k in ((300, 37), (432, 27), (4672, 27), (1000, 256), (64, 4),
                 (64, 256), (16384, 27), (131072, 64), (4096, 256),
                 (50, 6), (77, 9), (33, 130)):
        logits, u = _inputs(n, k, seed=n)
        logits[1], u[1] = 0.0, 0.5            # a row of ties
        logits[2, k // 2] = np.nan            # a NaN row
        lt = torch.tensor(logits, device=dev)
        ut = torch.tensor(u, device=dev)
        before = C.batched_categorical.launches
        got = C.batched_categorical(None, lt, injected_u=ut)
        assert C.batched_categorical.launches == before + 1
        torch.testing.assert_close(got, C.batched_categorical_plain(lt, ut),
                                   rtol=0, atol=0)
        assert int(got[1]) == 0 and int(got[2]) == k - 1
    # the vmap rule: one launch, each batch index with its own key
    lt = torch.tensor(_inputs(27, 27, seed=9)[0], device=dev)
    keys = random.split(random.PRNGKey(3, dev), 16)
    before = C.batched_categorical.launches
    got = torch.func.vmap(lambda kk: C.categorical_fast(kk, lt))(keys)
    assert C.batched_categorical.launches == before + 1
    for b in range(16):
        torch.testing.assert_close(got[b], C.categorical_fast(keys[b], lt),
                                   rtol=0, atol=0)
    assert not torch.equal(got[0], got[1])
