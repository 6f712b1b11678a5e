"""Structured mass metrics of the port (``inference/mass.py``) against
gen_tpu, in float32 on the same numpy population.

- Dense: the Cholesky factor, ``whiten`` and ``unwhiten`` within float32
  rounding (1e-5 relative to the population's scale: LAPACK builds order
  their sums differently).
- Low rank: the scale factors, and the transforms ``A y`` and ``A^-1 x``
  themselves. ``U`` is never compared: SVD signs differ between LAPACK
  builds, and ``U diag U^T`` does not depend on them.
- Partial embeddings: the identity on frozen coordinates, exactly.
- The whitened logp stages through the port's scalarizer; its staged value
  and gradient equal gen_tpu's ``plane_vag`` of the same whitened logp
  (1e-5: two staged float32 programs, sums in different orders).
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gen_tpu.ops.scalarize import stage_scalarized as j_stage  # noqa: E402
from gen_tpu_torch.ops.scalarize import stage_scalarized  # noqa: E402

j_mass = importlib.import_module("gen_tpu.inference.mass")
t_mass = importlib.import_module("gen_tpu_torch.inference.mass")

D = 5
SDS = np.array([0.5, 1.0, 3.0, 2.0, 0.2], np.float32)


def _population(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((D, D)))
    cov = (q * np.geomspace(0.05, 20.0, D)) @ q.T
    return rng.multivariate_normal(np.zeros(D), cov, n).astype(np.float32)


def _j(f, *a):
    with jax.enable_x64(False):
        out = f(*[jnp.asarray(x) for x in a])
        return jax.tree_util.tree_map(np.asarray, out)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def test_dense_chol_whiten_unwhiten_match_gen_tpu():
    flat = _population()
    L_j = _j(j_mass.dense_mass_chol, flat)
    L_t = t_mass.dense_mass_chol(_t(flat))
    np.testing.assert_allclose(L_t.numpy(), L_j, rtol=1e-4, atol=1e-5)
    # the rest from the same factor, so only the transform is compared
    L = _t(L_j)
    y_t = t_mass.whiten(L, _t(flat))
    np.testing.assert_allclose(y_t.numpy(), _j(j_mass.whiten, L_j, flat),
                               rtol=1e-5, atol=1e-5)
    ys = np.random.default_rng(1).standard_normal((3, 7, D)).astype(
        np.float32)
    np.testing.assert_allclose(t_mass.unwhiten(L, _t(ys)).numpy(),
                               _j(j_mass.unwhiten, L_j, ys), rtol=1e-5,
                               atol=1e-5)
    # whitened population is ~isotropic
    np.testing.assert_allclose(np.cov(y_t.numpy().T), np.eye(D), atol=1e-3)


def test_lowrank_factors_and_transforms_match_gen_tpu():
    flat = _population(seed=2)
    inv = SDS ** 2
    sd_j, U_j, sk_j, s0_j = _j(
        lambda f, i: j_mass.lowrank_mass_factors(f, 2, inv_mass_diag=i),
        flat, inv)
    f_t = t_mass.lowrank_mass_factors(_t(flat), 2, inv_mass_diag=_t(inv))
    for a, b in ((f_t[0], sd_j), (f_t[2], sk_j), (f_t[3], s0_j)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4)
    assert f_t[1].shape == U_j.shape == (D, 2)
    y = np.random.default_rng(3).standard_normal((11, D)).astype(np.float32)
    A_y_j = _j(j_mass.lowrank_transform, sd_j, U_j, sk_j, s0_j, y)
    A_y_t = t_mass.lowrank_transform(*f_t, _t(y))
    np.testing.assert_allclose(A_y_t.numpy(), A_y_j, rtol=1e-4, atol=1e-4)
    Ai_x_j = _j(j_mass.lowrank_inverse_transform, sd_j, U_j, sk_j, s0_j,
                flat[:11])
    Ai_x_t = t_mass.lowrank_inverse_transform(*f_t, _t(flat[:11]))
    np.testing.assert_allclose(Ai_x_t.numpy(), Ai_x_j, rtol=1e-4, atol=1e-4)
    # round trip, and a flipped singular vector gives the same transform
    np.testing.assert_allclose(
        t_mass.lowrank_inverse_transform(*f_t, A_y_t).numpy(), y, atol=1e-4)
    flipped = (f_t[0], -f_t[1], f_t[2], f_t[3])
    torch.testing.assert_close(t_mass.lowrank_transform(*flipped, _t(y)),
                               A_y_t, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="rank"):
        t_mass.lowrank_mass_factors(_t(flat), D)


def test_partial_embeddings_are_identity_on_frozen():
    flat = _population(seed=4)
    free = np.array([0, 2, 3])
    frozen = np.array([1, 4])
    L_j = _j(lambda f: j_mass.partial_dense_chol(f, free, D), flat)
    L_t = t_mass.partial_dense_chol(_t(flat), free, D)
    np.testing.assert_allclose(L_t.numpy(), L_j, rtol=1e-4, atol=1e-5)
    eye = np.eye(D, dtype=np.float32)
    np.testing.assert_array_equal(L_t.numpy()[frozen], eye[frozen])
    np.testing.assert_array_equal(L_t.numpy()[:, frozen], eye[:, frozen])
    inv = (SDS ** 2) * np.isin(np.arange(D), free)
    f_j = _j(lambda f, i: j_mass.partial_lowrank_factors(
        f, free, D, 2, inv_mass_diag=i), flat, inv)
    f_t = t_mass.partial_lowrank_factors(_t(flat), free, D, 2,
                                         inv_mass_diag=_t(inv))
    y = np.random.default_rng(5).standard_normal((9, D)).astype(np.float32)
    x_t = t_mass.partial_lowrank_transform(*f_t, _t(y))
    np.testing.assert_allclose(
        x_t.numpy(), _j(j_mass.partial_lowrank_transform, *f_j, y),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(x_t.numpy()[:, frozen], y[:, frozen])
    back = t_mass.partial_lowrank_inverse_transform(*f_t, x_t)
    np.testing.assert_array_equal(back.numpy()[:, frozen], y[:, frozen])
    np.testing.assert_allclose(back.numpy(), y, atol=1e-4)
    np.testing.assert_array_equal(f_t[4].numpy(),
                                  np.isin(np.arange(D), free).astype(
                                      np.float32))


@pytest.mark.parametrize("kind", ["dense", "lowrank"])
def test_whitened_logp_stages_like_gen_tpu(kind):
    """The kernels run the whitened logp; staged with the port's
    scalarizer (``L @ y`` and ``y @ U`` become multiply-adds over residual
    constants), its value and gradient equal gen_tpu's staged program."""
    flat = _population(seed=6)

    def logp_of(sum_, s):
        return lambda x: -0.5 * sum_((x / s) ** 2) - 0.3 * x[0] * x[2]

    lj = logp_of(jnp.sum, jnp.asarray(SDS))
    lt = logp_of(torch.sum, _t(SDS))
    with jax.enable_x64(False):
        if kind == "dense":
            L = j_mass.dense_mass_chol(jnp.asarray(flat))
            wj = j_mass.whiten_logp(lj, L)
            wt = t_mass.whiten_logp(lt, _t(L))
        else:
            f = j_mass.lowrank_mass_factors(jnp.asarray(flat), 2)
            wj = j_mass.lowrank_whiten_logp(lj, *f)
            wt = t_mass.lowrank_whiten_logp(lt, *[_t(a) for a in f])
        y = np.random.default_rng(7).standard_normal((D, 32)).astype(
            np.float32)
        js = j_stage(wj, D)
        lp_j, g_j = map(np.asarray, js.plane_vag(jnp.asarray(y),
                                                 js.res_consts))
    staged = stage_scalarized(wt, D)
    lp_t, g_t = staged.vag(_t(y))
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-5, atol=1e-5)
    # and equal to torch.func on the whitened logp itself
    ref = torch.func.vmap(torch.func.grad_and_value(wt))(_t(y.T))
    np.testing.assert_allclose(lp_t.numpy(), ref[1].numpy(), rtol=1e-5,
                               atol=1e-5)
    if kind == "dense":      # L's d^2 entries ride in as residual constants
        assert staged.n_res >= D * D
