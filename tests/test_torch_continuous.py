"""gen_tpu_torch's continuous distributions against gen_tpu's
(``gen_tpu/dists/continuous.py``), in float64 (JAX's x64 mode).

Every ported ``logpdf`` equals gen_tpu's at 1e-12 relative, -inf where
gen_tpu gives -inf, on values inside and outside the support."""

import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
import gen_tpu_torch as tt  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

V5 = np.array([-1.3, 0.2, 0.7, 2.5, 4.0])
COV3 = np.array([[2.0, 0.3, -0.4], [0.3, 1.0, 0.2], [-0.4, 0.2, 0.7]])
UNIT = np.array([0.05, 0.3, 0.99])

# name -> [(args, value), ...]; numpy arrays become tensors on each side
CASES = {
    "normal": [((0.4, 1.7), V5), ((V5, np.full(5, 0.5)), V5[::-1].copy())],
    "broadcasted_normal": [((np.zeros((2, 1)), np.array([1.0, 2.0, 3.0])),
                            np.arange(6.0).reshape(2, 3))],
    "mvnormal": [((np.array([0.1, -0.2, 0.3]), COV3),
                  np.array([0.5, 0.1, -1.0]))],
    "uniform": [((-1.0, 2.0), 0.5), ((-1.0, 2.0), 2.5),
                ((np.array([0.0, 1.0]), np.array([1.0, 4.0])),
                 np.array([0.5, 3.9]))],
    "beta": [((2.0, 3.5), UNIT), ((0.7, 0.4), 0.5), ((2.0, 3.5), 1.0)],
    "gamma": [((2.5, 1.5), np.array([0.3, 2.0, 7.0])), ((2.5, 1.5), -1.0)],
    "inv_gamma": [((3.0, 2.0), np.array([0.3, 2.0, 7.0])),
                  ((3.0, 2.0), 0.0)],
    "exponential": [((1.7,), np.array([0.0, 0.4, 3.0])), ((1.7,), -0.1)],
    "cauchy": [((0.5, 2.0), V5)],
    "laplace": [((0.5, 2.0), V5), ((V5, 0.3), np.zeros(5))],
    "student_t": [((4.0, 0.5, 2.0), V5), ((np.array([1.0, 30.0]), 0.0,
                                          1.3), np.array([0.2, -4.0]))],
}


def _j(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _t(x):
    return torch.as_tensor(x) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("name", sorted(CASES))
def test_logpdf_matches_gen_tpu(name):
    jd, td = getattr(gt, name), getattr(tt, name)
    with float64_default():
        for args, v in CASES[name]:
            want = float(jd.logpdf(_j(v), *map(_j, args)))
            got = td.logpdf(_t(v), *map(_t, args))
            assert got.dtype == torch.float64
            if math.isinf(want):
                assert float(got) == want, (name, args, v, float(got), want)
            else:
                np.testing.assert_allclose(float(got), want, rtol=1e-12,
                                           err_msg=f"{name} {args} {v}")
