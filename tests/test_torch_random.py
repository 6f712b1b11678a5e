"""gen_tpu_torch.random against jax.random: threefry keys and bits bit for
bit (partitionable threefry, JAX's default), uniforms and randint exact,
float32 normals within 4 ulp (XLA's erf_inv polynomial, reproduced)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gen_tpu_torch import random as tr  # noqa: E402

SEEDS = [0, 1, 42, 2 ** 31 - 7]
SHAPES = [(), (3,), (4, 5), (1000,)]


def _words(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bits_exact(seed):
    kj, kt = jax.random.PRNGKey(seed), tr.PRNGKey(seed, "cpu")
    np.testing.assert_array_equal(_words(kj), kt.numpy())
    for num in [2, 5, (3, 4)]:
        np.testing.assert_array_equal(_words(jax.random.split(kj, num)),
                                      tr.split(kt, num).numpy())
    for data in [0, 7, 123456, 2 ** 31 + 3]:
        np.testing.assert_array_equal(_words(jax.random.fold_in(kj, data)),
                                      tr.fold_in(kt, data).numpy())
    for shape in SHAPES:
        np.testing.assert_array_equal(
            _words(jax.random.bits(kj, shape, jnp.uint32)),
            tr.bits(kt, shape).numpy())
        hi, lo = tr.bits(kt, shape, width=64)
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(kj, shape, jnp.uint64)).view(
                np.int64), ((hi << 32) | lo).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_randint_exact(seed):
    kj, kt = jax.random.PRNGKey(seed), tr.PRNGKey(seed, "cpu")
    for shape in SHAPES:
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(kj, shape, jnp.float32)),
            tr.uniform(kt, shape).numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(kj, shape, jnp.float32, -2.0,
                                          3.0)),
            tr.uniform(kt, shape, minval=-2.0, maxval=3.0).numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(kj, shape, jnp.float64)),
            tr.uniform(kt, shape, torch.float64).numpy())
        for lo, hi in [(0, 37), (-5, 300000), (0, 256)]:
            np.testing.assert_array_equal(
                np.asarray(jax.random.randint(kj, shape, lo, hi,
                                              jnp.int32)),
                tr.randint(kt, shape, lo, hi).numpy())
            np.testing.assert_array_equal(
                np.asarray(jax.random.randint(kj, shape, lo, hi,
                                              jnp.int64)),
                tr.randint(kt, shape, lo, hi, torch.int64).numpy())


@pytest.mark.parametrize("seed", [3, 99])
def test_normal_float32_within_4_ulp(seed):
    a = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (200000,),
                                     jnp.float32))
    b = tr.normal(tr.PRNGKey(seed, "cpu"), (200000,)).numpy()
    assert b.dtype == np.float32
    ulp = np.abs(a.view(np.int32).astype(np.int64)
                 - b.view(np.int32).astype(np.int64))
    assert ulp.max() <= 4


def test_vmap_over_keys_matches_jax_vmap():
    keys_j = jax.random.split(jax.random.PRNGKey(5), 16)
    keys_t = tr.split(tr.PRNGKey(5, "cpu"), 16)
    ref = jax.vmap(lambda k: jax.random.uniform(
        jax.random.split(k)[1], (3,), jnp.float32))(keys_j)
    out = torch.func.vmap(lambda k: tr.uniform(tr.split(k)[1], (3,)))(keys_t)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())


@pytest.mark.parametrize("seed", [0, 7])
def test_bernoulli_matches_jax(seed):
    kj, kt = jax.random.PRNGKey(seed), tr.PRNGKey(seed, "cpu")
    for dtype_j, dtype_t in ((jnp.float32, torch.float32),
                             (jnp.float64, torch.float64)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(kj, jnp.asarray(0.3, dtype_j),
                                            (500,))),
            tr.bernoulli(kt, 0.3, (500,), dtype_t).numpy())


def test_entry_points_default_to_the_card():
    """No device named means the card (the helper is checked, not an
    allocation: this machine may have none); ``device="cpu"`` still gives
    CPU tensors."""
    from gen_tpu_torch.convert import flat_values_from_numpy
    from gen_tpu_torch.utils import default_device
    assert default_device() == torch.device("cuda")
    assert tr.PRNGKey(3, "cpu").device.type == "cpu"
    assert flat_values_from_numpy(np.zeros((2, 3)), "cpu").device.type == \
        "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tr.PRNGKey(3)
