"""The rolled scan of staging part b (``gen_tpu_torch/ops/scan.py``,
``scalarize.Loop``) against gen_tpu and against the loop it replaces.

- The staged AR(1) model (D = 1) at T = 100 gives gen_tpu's logp and
  ``jax.value_and_grad`` (``gen_tpu.models.lgssm``, whose ``lax.scan``
  gen_tpu's staging unrolls) at the tolerances of
  ``test_staged_kalman_logp_matches_gen_tpu`` (rtol 1e-4 and 3e-3).
- Eager ``kalman_filter`` through ``scan`` equals the Python loop over
  time it replaces, bit for bit, at D = 1 and D = 2.
- The staged program does not grow with T: the same instruction count and
  the same CUDA source, but for the trip counts and the tape's size, at
  T = 10 and T = 100; T = 1 stages, and the ``first`` flag is computed
  from the step, off the tape.
- A stacked output used other than by a sum over its steps, and a scan
  beside a streamed likelihood, raise ``ValueError`` naming the node.
- The kernel sources splice the rolled program, inlined, one thread per
  chain whatever d; the ``cuda``-marked test holds K1, K3 and the
  staged-code kernel to their plain versions on a card, bit for bit.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from gen_tpu_torch.models import LGSSMParams, kalman_filter  # noqa: E402
from gen_tpu_torch.ops import (hmc_fused, nuts_fused, scalarize,  # noqa: E402
                               staged_eval)
from gen_tpu_torch.ops.scalarize import stage_scalarized  # noqa: E402

_HALF_LOG_2PI = 0.9189385332046727


def _ys(T, seed=0):
    rng = np.random.default_rng(seed)
    x, ys = 0.0, np.empty((T, 1), np.float32)
    for t in range(T):
        x = (0.8 * x if t else 0.0) + np.sqrt(0.3) * rng.standard_normal()
        ys[t, 0] = x + np.sqrt(0.5) * rng.standard_normal()
    return ys


def _ar1_logp(lib, filt, params, T, extra=None, dev=None):
    """chip_smoke.py's AR(1)+noise model as a flat logp over (phi, log_q,
    log_r): normal priors, the lgssm(T) Kalman marginal, P0 = 2 (``dev``:
    the torch model's device)."""
    kw = {} if dev is None else {"device": dev}
    ys = lib.asarray(_ys(T)) if lib is not torch else \
        torch.from_numpy(_ys(T)).to(**kw)

    def normal(v, m, s):
        return -0.5 * ((v - m) / s) ** 2 - math.log(s) - _HALF_LOG_2PI

    def logp(x):
        phi, log_q, log_r = x[0], x[1], x[2]
        eye = lib.eye(1, dtype=lib.float32, **kw)
        zero = lib.zeros(1, dtype=lib.float32, **kw)
        res = filt(params(phi * eye, lib.exp(log_q) * eye, eye,
                          lib.exp(log_r) * eye, zero, 2.0 * eye), ys)
        lp = (normal(phi, 0.0, 1.0) + normal(log_q, -1.0, 1.0)
              + normal(log_r, -1.0, 1.0))
        return lp + (res.log_ml if extra is None else extra(res))

    return logp


def _points(n=16, seed=1):
    rng = np.random.default_rng(seed)
    return (np.array([[0.6], [-1.2], [-0.7]])
            + 0.2 * rng.standard_normal((3, n))).astype(np.float32)


def test_staged_ar1_matches_gen_tpu():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from gen_tpu.models.lgssm import LGSSMParams as JParams
    from gen_tpu.models.lgssm import kalman_filter as j_filter
    staged = stage_scalarized(_ar1_logp(torch, kalman_filter, LGSSMParams,
                                        100), 3, "cpu")
    assert staged.loop_shape[0][0] == 100 and not staged.streams
    V = _points()
    lp, g = staged.vag(torch.from_numpy(V))
    jlogp = _ar1_logp(jnp, j_filter, JParams, 100)
    ref, gref = jax.jit(jax.vmap(jax.value_and_grad(jlogp)))(
        jnp.asarray(V.T))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(g.numpy(), np.asarray(gref).T, rtol=3e-3,
                               atol=3e-3)


def _loop_filter(params, ys):
    """The Python loop over time that ``kalman_filter`` ran before
    ``scan``: the prior at t == 0 by a branch."""
    from gen_tpu_torch.models.lgssm import _cho_solve, _sym
    A, Q, C, R, mu0, P0 = params
    p = C.shape[-2]
    eye_d = torch.eye(A.shape[-1], dtype=A.dtype)
    m, P = mu0, P0
    lml, m_f, P_f, m_p, P_p = [], [], [], [], []
    for t in range(ys.shape[0]):
        m_pred = mu0 if t == 0 else A @ m
        P_pred = P0 if t == 0 else _sym(A @ P @ A.T + Q)
        v = ys[t] - C @ m_pred
        S = _sym(C @ P_pred @ C.T + R)
        chol_s = torch.linalg.cholesky(S)
        lml.append(-0.5 * (v @ _cho_solve(chol_s, v) + p * 1.8378770664093453)
                   - torch.sum(torch.log(torch.diagonal(chol_s))))
        K = _cho_solve(chol_s, C @ P_pred).T
        m = m_pred + K @ v
        ImKC = eye_d - K @ C
        P = _sym(ImKC @ P_pred @ ImKC.T + K @ R @ K.T)
        m_f.append(m)
        P_f.append(P)
        m_p.append(m_pred)
        P_p.append(P_pred)
    return (torch.sum(torch.stack(lml)), torch.stack(m_f), torch.stack(P_f),
            torch.stack(m_p), torch.stack(P_p))


@pytest.mark.parametrize("d,p,dtype", [(1, 1, torch.float32),
                                       (2, 3, torch.float64)])
def test_eager_scan_equals_the_loop(d, p, dtype):
    rng = np.random.default_rng(d)
    a = 0.6 * rng.standard_normal((d, d))
    a = a / max(1.0, 1.1 * np.max(np.abs(np.linalg.eigvals(a))))
    qh, rh, ph = (rng.standard_normal(s) for s in ((d, d), (p, p), (d, d)))
    ps = [torch.as_tensor(v, dtype=dtype) for v in (
        a, qh @ qh.T / d + 0.3 * np.eye(d), rng.standard_normal((p, d)),
        rh @ rh.T / p + 0.2 * np.eye(p), rng.standard_normal(d),
        ph @ ph.T / d + 0.5 * np.eye(d))]
    ys = torch.as_tensor(rng.standard_normal((12, p)), dtype=dtype)
    for got, want in zip(kalman_filter(LGSSMParams(*ps), ys),
                         _loop_filter(ps, ys)):
        assert got.dtype == dtype and torch.equal(got, want)


def _staged_ar1(T):
    return stage_scalarized(_ar1_logp(torch, kalman_filter, LGSSMParams, T),
                            3, "cpu")


def test_program_does_not_grow_with_T():
    st10, st100 = _staged_ar1(10), _staged_ar1(100)
    assert st10.n_instructions == st100.n_instructions < 400
    assert [n for _, n in st10.loop_shape] == [n for _, n in st100.loop_shape]
    assert st100.loop_shape[0][0] == 100 and st100.tape_floats == 200
    assert st100.executed_instructions > 100 * st100.loop_shape[0][1]

    def rolled(src, T):
        for a, b in ((f"_t < {T};", "_t < T;"),
                     (f"_t = {T - 1};", "_t = T-1;"),
                     (f"_tape0[{2 * T}];", "_tape0[2T];"),
                     (f" {T} steps", " T steps")):
            src = src.replace(a, b)
        return src

    s10, s100 = st10.cuda_source(), st100.cuda_source()
    assert rolled(s10, 10) == rolled(s100, 100)
    assert len(s10.splitlines()) == len(s100.splitlines())
    assert s100.count("#pragma unroll 1") == 2
    assert "__device__ __forceinline__ void staged_vag(" in s100


def test_one_step_and_the_first_flag():
    """T = 1: the forward and backward loops run once; the ``first`` flag
    is a fixed slot (true at step 0, computed from t), so the tape holds
    the two float slots (m, P) only. Value and gradient equal eager torch
    (``torch.func``) through the same select."""
    staged = _staged_ar1(1)
    fwd, bwd = staged.loops
    assert not fwd.reverse and bwd.reverse and bwd.fwd is fwd
    assert list(fwd.fixed.values()) == [(True, False)]
    assert fwd.tape_slots() == [0, 1] and staged.tape_floats == 2
    src = staged.cuda_source()
    assert "const bool c2 = _t == 0 ? true : false;" in src
    assert "const bool k2 = _t == 0 ? true : false;" in src
    V = _points()
    logp = _ar1_logp(torch, kalman_filter, LGSSMParams, 1)
    lp_ref, g_ref = torch.func.vmap(torch.func.grad_and_value(logp))(
        torch.from_numpy(V.T.copy()))[::-1]
    lp, g = staged.vag(torch.from_numpy(V))
    np.testing.assert_allclose(lp.numpy(), lp_ref.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_ref.T.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("use", ["weighted", "last_mean"])
def test_other_use_of_a_stacked_output_raises(use):
    extra = {"weighted": lambda res: torch.sum(res.filtered_covs * 0.5),
             "last_mean": lambda res: res.log_ml
             + res.filtered_means[-1, 0]}[use]
    logp = _ar1_logp(torch, kalman_filter, LGSSMParams, 8, extra)
    with pytest.raises(ValueError, match=r"scalarize: '\w+' .*stacked output "
                       r"of the scan '\w+'"):
        stage_scalarized(logp, 3, "cpu")


def test_scan_beside_a_stream_raises():
    data = torch.linspace(-1.0, 1.0, 2048)
    base = _ar1_logp(torch, kalman_filter, LGSSMParams, 4)

    def logp(x):
        return base(x) - 0.5 * torch.sum((data - x[0]) ** 2)

    with pytest.raises(ValueError, match=r"the scan '\w+' and a streamed "
                       r"likelihood \('\w+'\)"):
        stage_scalarized(logp, 3, "cpu")


def test_kernel_sources_splice_the_rolled_body():
    """K1, K3, K6 and the staged-code kernel inline the rolled program
    (K3 its rendering without the scan bodies' run-time reciprocals);
    a model with scan loops keeps one thread per chain at d > 32, where
    ``SplitProgram`` would split a straight-line program over a warp."""
    staged = _staged_ar1(100)
    src = staged.cuda_source()
    k3_src = staged.cuda_source(scan_rcps=False)
    for s_, k_src in ((src, hmc_fused.kernel_source(staged)),
                      (k3_src, nuts_fused.kernel_source(staged, 8, True)),
                      (src, nuts_fused.kernel_source(staged, 8, False)),
                      (src, staged_eval.build_job(staged)[1])):
        assert s_ in k_src and "@@" not in k_src
    base = _ar1_logp(torch, kalman_filter, LGSSMParams, 5)

    def wide(x):
        return base(x[:3]) - 0.5 * torch.sum(x[3:] ** 2)

    st40 = stage_scalarized(wide, 40, "cpu")
    assert st40.loops and nuts_fused.kernel_layout(st40) == "wide"
    with pytest.raises(ValueError, match="with scan loops"):
        st40.warp_split()
    assert "#define NUTS_LANES 1\n" in nuts_fused.kernel_source(st40, 6, True)


@pytest.mark.cuda
def test_rolled_kernels_match_plain_versions_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    logp = _ar1_logp(torch, kalman_filter, LGSSMParams, 30, dev=dev)
    x = torch.from_numpy(_points(2000)).to(dev)
    staged = hmc_fused.stage(logp, 3, dev)
    lk, gk = staged_eval.staged_vag(staged, x)
    lp, gp = staged_eval.staged_vag_plain(staged, x)
    assert torch.equal(lk, lp) and torch.equal(gk, gp)
    before = scalarize.body_launches["scan"]
    v0 = x.T.contiguous()
    gen = torch.Generator(dev).manual_seed(3)
    inj = (torch.full((3,), 0.05, device=dev),
           torch.randn(3, 2000, 3, device=dev, generator=gen),
           torch.rand(3, 2000, device=dev, generator=gen).clamp_min(1e-30))
    key = torch.zeros(2, dtype=torch.int64, device=dev)
    kw = dict(n_steps=3, L=2, eps=0.05, collect_idx=None, injected_rng=inj)
    vk, ck, ak = hmc_fused.hmc_chains_fused(key, logp, v0, **kw)
    vp, cp, ap = hmc_fused.hmc_chains_fused_plain(key, logp, v0, **kw)
    assert torch.equal(vk, vp) and torch.equal(ak, ap)
    gen = torch.Generator(dev).manual_seed(4)
    inj = (torch.randn(4, 2000, 3, device=dev, generator=gen),) + tuple(
        torch.rand(4, 2000, device=dev, generator=gen).clamp(1e-6, 1 - 1e-6)
        for _ in range(7))
    kw = dict(num_ticks=8, eps=0.05, max_depth=6, collect_idx=0,
              injected_rng=inj, paired=True)
    out_k = nuts_fused.nuts_chains_fused(key, logp, v0, **kw)
    out_p = nuts_fused.nuts_chains_fused_plain(key, logp, v0, **kw)
    assert torch.equal(out_k[0], out_p[0]) and torch.equal(out_k[3],
                                                           out_p[3])
    assert scalarize.body_launches["scan"] == before + 2
