"""Drive gen_tpu_torch's main paths on one NVIDIA GPU and check them.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, so the exit code is
nonzero and no result line is printed):

1. Environment and build: card name and power limit, torch/CUDA/nvcc
   versions; the staging of every model and the build of every kernel from
   ``gen_tpu_torch/ops/csrc`` (one ``nvcc`` per source, all at once), with
   registers, spills and local memory from ptxas.
2. Each kernel against its plain PyTorch version, both on the card, with
   injected randomness, at the shapes the main paths give it:
   - K1 (fused HMC): the regression model at 8,192 and 524,288 chains, a
     3-d Gaussian with one frozen coordinate. Accept counts equal, values
     and histories within 2e-4.
   - K3 (pair-scheduled NUTS): eight_schools d=10 at 8,192 chains (all
     coordinates) and at 131,072 chains, the 100-school model (d=102) at
     32,768 chains, a 4-d Gaussian (8,000 chains, a ragged last block) at
     eps 0.9 with divergence threshold 4 (the divergence paths) and the
     same Gaussian with one frozen coordinate, which must never move. Completed and history counts
     equal, values, histories and stats within 1e-5.
3. The headline path (``bench.py::main``): the regression model at 524,288
   chains, ``hmc_chains`` warmup, then the fused HMC kernel; gates of
   ``benchmarks/bench_verify.py`` (quadrature moments, split-R-hat).
4. The general-model paths (``bench.py`` metrics 2 and 3): eight_schools at
   131,072 chains (d=10) and the 100-school model at 32,768 chains (d=102),
   vmapped ``generate``, 400 iterations of ChEES warmup, then
   ``nuts_chains_fused_chunked(paired=True)``: one decorrelation call and
   three timed calls of 2,000 leapfrog slots. Gates of
   ``benchmarks/bench_nuts_fused.py``: 1,536 completed draws on each of
   4,096 chains (``nuts_collect_draws``, all coordinates; gen_tpu's own
   d=102 gate takes 1,536), a 25% burn, every coordinate within 0.05 sd
   (mean) and 6% (sd) of the exact quadrature, split-R-hat below 1.01 on
   2,048 chains.
5. Numbers: per kernel its time, its plain version's time, its bound and
   launches on the main path, as one JSON line; then the card; then the
   result line.

Each main path is driven with the kernels' launch counts set to 0 just
before it and read just after. The script imports neither JAX nor gen_tpu.
It refuses to run without a CUDA device.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np

N_CHAINS = 524288
N_WARMUP = 100
N_SAMPLE = 500
N_PLAIN = 50        # K1's plain version is timed over 50 steps, not 500
L, EPS = 10, 0.035
TOL = 2e-4          # tests/test_hmc_fused.py's kernel-vs-reference tolerance
NUTS_TOL = 1e-5     # tests/test_nuts_fused.py's kernel-vs-twin tolerance
NUTS_TICKS = 2000
NUTS_WARMUP = 400
GATE_DRAWS = 1536   # completed draws per chain for the gates
PLAIN_PAIRS = 10    # K3's plain version is timed over 10 pairs
GAUSS_SDS = [1.0, 3.0, 0.5, 2.0]
YS_8 = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
SIGMAS_8 = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]
SCHOOL_ADDRS = ("mu", "log_tau", "theta_std")
# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores and HBM3 bandwidth
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def make_schools(K=100, seed=0, mu_true=4.0, tau_true=6.0):
    """K synthetic schools (benchmarks/bench_hard_targets.py)."""
    rng = np.random.default_rng(seed)
    sigmas = rng.uniform(9.0, 18.0, K)
    theta = mu_true + tau_true * rng.standard_normal(K)
    ys = theta + sigmas * rng.standard_normal(K)
    return ys, sigmas


def bound_ms(ops, nbytes):
    """The least time for ``ops`` operations and ``nbytes`` bytes on the
    published peaks, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def k1_ops(n_instr, d, L_):
    """Operations per chain and step of the fused HMC kernel, counting each
    float or integer operation of the algorithm once: an IEEE division,
    expf, logf, sqrtf and each of sin and cos count 1 (the hardware spends
    ~10-20 instructions on each; the bound does not charge them). L
    leapfrogs of the staged program (n_instr) plus 7d updates; two kinetic
    energies; momenta; MH accept and selects; the jittered step size;
    Box-Muller (10 float + 4 integer per pair of normals); Philox4x32-10
    (100 integer operations per call, 2 + ceil(d/4) calls)."""
    calls = 2 + (d + 3) // 4
    return (L_ * (n_instr + 7 * d) + 1 + 2 * (3 * d + 1) + d + 6
            + (2 * d + 1) + 1 + 5 + 14 * 2 * ((d + 3) // 4) + 100 * calls)


def k3_ops(n_instr, d, pairs, n, completed, divergent):
    """Operations of one fused NUTS call that this run's data needs (a lower
    bound, conventions as :func:`k1_ops`): per computed leapfrog the staged
    program plus 11d + 21 (leapfrog, kinetic energy, energy error,
    accept statistic, logaddexp, multinomial take, momentum sum); per pair
    the bf16x2 checkpoint pack (12d integer); per active slot 2 the level-1
    U-turn test (6d); per trajectory start the momenta (7 per normal) and
    their Philox calls. A slot 2 idles after every trajectory's first
    subtree and after a slot-1 divergence, so computed leapfrogs are
    2 pairs n - (completed + n) - divergent."""
    starts = completed + n
    leapfrogs = 2 * pairs * n - starts - divergent
    slot2 = leapfrogs - pairs * n
    return (leapfrogs * (n_instr + 11 * d + 21) + pairs * n * 12 * d
            + slot2 * 6 * d
            + starts * (7 * d + 3 * d + 2 + 100 * (2 + (d + 3) // 4)))


def phase_env(torch):
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")
    from gen_tpu_torch.ops import _cuda_build
    nvcc = subprocess.run([_cuda_build.nvcc(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"nvcc: {nvcc.splitlines()[-1]}")
    return card


def regression_setup(torch, tt, device):
    """bench.py's model and data (xs = linspace(-3, 3, 50), ys from
    default_rng(0)), on ``device``."""
    n_points = 50
    xs = np.linspace(-3.0, 3.0, n_points).astype(np.float32)
    noise = np.random.default_rng(0).standard_normal(n_points)
    ys = (np.float32(0.7) * xs - np.float32(0.4)
          + np.float32(0.5) * noise.astype(np.float32))
    X = torch.tensor(np.stack([xs, np.ones_like(xs)], axis=1),
                     device=device)
    ys_t = torch.tensor(ys, device=device)

    @tt.gen
    def regression_model(X):
        slope = tt.normal(0.0, 2.0) @ "slope"
        intercept = tt.normal(0.0, 2.0) @ "intercept"
        log_noise = tt.normal(0.0, 1.0) @ "log_noise"
        beta = torch.stack([slope, intercept])
        tt.normal_linear(X, beta, torch.exp(log_noise)) @ "ys"
        return slope

    obs = tt.choicemap(ys=ys_t)
    sel = tt.select("slope", "intercept", "log_noise")
    return regression_model, X, obs, sel, xs, ys


def schools_setup(torch, tt, ys, sigmas, device):
    """benchmarks/bench_hard_targets.py's eight_schools (non-centered, any
    number of schools) with its data, on ``device``."""
    @tt.gen
    def eight_schools(sigmas):
        mu = tt.normal(0.0, 10.0) @ "mu"
        log_tau = tt.normal(0.0, 1.5) @ "log_tau"
        theta_std = tt.normal(torch.zeros(sigmas.shape[0], device=device),
                              1.0) @ "theta_std"
        tt.normal(mu + torch.exp(log_tau) * theta_std, sigmas) @ "ys"
        return mu

    sig = torch.tensor(np.asarray(sigmas, np.float32), device=device)
    obs = tt.choicemap(ys=torch.tensor(np.asarray(ys, np.float32),
                                       device=device))
    return eight_schools, (sig,), obs, tt.select(*SCHOOL_ADDRS)


def init_values(torch, model, args, obs, sel, keys):
    return torch.func.vmap(
        lambda k: model.generate(k, args, obs)[0].get_choices()
        .filter(sel).to_array())(keys)


def flat_layout(tt, trace, sel):
    """(paths, offsets) of the flat vector, in gen_tpu's sorted order."""
    paths, sizes = [], []
    for p, v in trace.get_choices().filter(sel).leaf_items():
        paths.append(p)
        sizes.append(int(v.numel()))
    return paths, np.concatenate([[0], np.cumsum(sizes)])


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def compare_k1(torch, fused, plain, key, logp, values0, n_steps, L_, eps,
               collect_idx, inv_mass, rng, label):
    """K1 vs its plain version on the card under the same injected
    randomness."""
    n, d = values0.shape
    dev = values0.device
    eps_steps = torch.tensor(eps * rng.uniform(0.8, 1.2, n_steps),
                             dtype=torch.float32, device=dev)
    z = torch.randn(n_steps, n, d, device=dev,
                    generator=torch.Generator(dev).manual_seed(
                        int(rng.integers(1 << 30))))
    u = torch.rand(n_steps, n, device=dev,
                   generator=torch.Generator(dev).manual_seed(
                       int(rng.integers(1 << 30)))).clamp_min(1e-30)
    kw = dict(n_steps=n_steps, L=L_, eps=eps, collect_idx=collect_idx,
              inv_mass_diag=inv_mass, injected_rng=(eps_steps, z, u))
    vk, ck, ak = fused(key, logp, values0, **kw)
    vp, cp, ap = plain(key, logp, values0, **kw)
    torch.cuda.synchronize()
    err = max(float((vk - vp).abs().max()), float((ck - cp).abs().max()))
    n_diff = int((ak != ap).sum())
    print(f"K1 {label}: max |kernel - plain| = {err:.3e}, accept counts "
          f"differ in {n_diff} of {n} chains, accept rate "
          f"{float(ak.mean()) / n_steps:.3f}")
    check(n_diff == 0, f"{label}: accept counts differ")
    check(torch.allclose(vk, vp, rtol=TOL, atol=TOL)
          and torch.allclose(ck, cp, rtol=TOL, atol=TOL),
          f"{label}: kernel and plain version disagree beyond {TOL}")
    return vk, ck, err


def nuts_streams(torch, pairs, n, d, dev, seed):
    """The 8 injected streams: z (pairs, n, d), 7 uniforms (pairs, n) in
    [1e-6, 1 - 1e-6], drawn on the card."""
    gen = torch.Generator(dev).manual_seed(seed)
    z = torch.randn(pairs, n, d, device=dev, generator=gen)
    us = [torch.rand(pairs, n, device=dev, generator=gen).clamp(1e-6,
                                                                1 - 1e-6)
          for _ in range(7)]
    return (z, *us)


def compare_k3(torch, nf, logp, values0, pairs, eps, max_depth, collect_idx,
               inv_mass, thr, seed, label):
    """K3 vs its plain version on the card under the same injected
    randomness; returns the kernel's outputs and the largest difference."""
    n, d = values0.shape
    inj = nuts_streams(torch, pairs, n, d, values0.device, seed)
    kw = dict(num_ticks=2 * pairs, eps=eps, max_depth=max_depth,
              inv_mass_diag=inv_mass, collect_idx=collect_idx,
              divergence_threshold=thr, injected_rng=inj, paired=True)
    key = torch.zeros(2, dtype=torch.int64, device=values0.device)
    out_k = nf.nuts_chains_fused(key, logp, values0, **kw)
    out_p = nf.nuts_chains_fused_plain(key, logp, values0, **kw)
    torch.cuda.synchronize()
    (vk, hk, hck, ck, sk), (vp, hp, hcp, cp, sp) = out_k, out_p
    errs = [float((vk - vp).abs().max()), float((hk - hp).abs().max())]
    errs += [float((sk[s].float() - sp[s].float()).abs().max()) for s in sk]
    n_diff = int((ck != cp).sum()) + int((hck != hcp).any(dim=0).sum())
    ndiv = int(sk["num_divergent"].sum())
    print(f"K3 {label}: max |kernel - plain| = {max(errs):.3e}, counts "
          f"differ in {n_diff} of {n} chains, {int(ck.sum())} completed "
          f"trajectories, {ndiv} divergent, mean depth "
          f"{float(sk['mean_depth'].mean()):.2f}")
    check(n_diff == 0, f"{label}: completed counts differ")
    for a, b in ((vk, vp), (hk, hp)):
        check(torch.allclose(a, b, rtol=NUTS_TOL, atol=NUTS_TOL),
              f"{label}: kernel and plain version disagree beyond "
              f"{NUTS_TOL}")
    for s in sk:
        check(torch.allclose(sk[s].float(), sp[s].float(), rtol=NUTS_TOL,
                             atol=NUTS_TOL), f"{label}: stats {s} differ")
    return out_k, max(errs)


def phase_headline(torch, tt, dev, k1, tag, rng):
    """K1 checks, the headline path and its gates. Returns the kernel's
    JSON entry and the errors of its checks."""
    from gen_tpu_torch import random
    from gen_tpu_torch._verify import exact_posterior_moments
    from gen_tpu_torch.diagnostics import autocorr_ess, rhat
    from gen_tpu_torch.inference import hmc_chains
    from gen_tpu_torch.ops.hmc_fused import (hmc_chains_fused,
                                             hmc_chains_fused_plain)
    from gen_tpu_torch.ops.nuts_fused import nuts_chains_fused

    model, X, obs, sel, xs, ys, target, gauss_logp, sds = k1
    paths = flat_layout(tt, model.generate(random.PRNGKey(1, dev), (X,),
                                           obs)[0], sel)[0]
    slope_idx = paths.index(("slope",))
    errs = []
    k_cmp = random.PRNGKey(7, dev)
    v8k = init_values(torch, model, (X,), obs, sel,
                      random.split(random.PRNGKey(11, dev), 8192))
    errs.append(compare_k1(torch, hmc_chains_fused, hmc_chains_fused_plain,
                           k_cmp, target.logp, v8k, 20, 10, EPS, None, None,
                           rng, "regression n=8192 collect=all")[2])
    vfull = init_values(torch, model, (X,), obs, sel,
                        random.split(random.PRNGKey(12, dev), N_CHAINS))
    errs.append(compare_k1(torch, hmc_chains_fused, hmc_chains_fused_plain,
                           k_cmp, target.logp, vfull, 20, L, EPS, slope_idx,
                           None, rng,
                           f"regression n={N_CHAINS} collect=slope")[2])
    g0 = torch.randn(8192, 3, device=dev) * sds
    inv_mass = torch.stack([sds[0] ** 2, sds[1] ** 2,
                            torch.zeros((), device=dev)])
    vg, cg, err = compare_k1(torch, hmc_chains_fused, hmc_chains_fused_plain,
                             k_cmp, gauss_logp, g0, 20, 10, 0.3, None,
                             inv_mass, rng, "gaussian frozen-coordinate")
    errs.append(err)
    check(torch.equal(vg[:, 2], g0[:, 2])
          and torch.equal(cg[:, :, 2], g0[:, 2].expand(20, -1)),
          "frozen coordinate moved")
    check(not torch.equal(vg[:, 0], g0[:, 0]), "free coordinate never moved")
    print("K1 frozen coordinate: unchanged in every chain and step")

    # -- the headline path at full width --------------------------------
    key = random.PRNGKey(0, dev)
    k_init, k_run = random.split(key)
    hmc_chains_fused.launches = nuts_chains_fused.launches = 0
    values, init_s = timed(torch, lambda: init_values(
        torch, model, (X,), obs, sel, random.split(k_init, N_CHAINS)))
    (values, _, w_acc), warm_s = timed(torch, lambda: hmc_chains(
        random.fold_in(k_run, 0), target, values, n_steps=N_WARMUP, L=L,
        eps=EPS, collect=lambda v: v[:, slope_idx], teleport_after=10))
    values, _, _ = hmc_chains_fused(random.fold_in(k_run, 2), target.logp,
                                    values, N_SAMPLE, L=L, eps=EPS,
                                    collect_idx=slope_idx)
    times = []
    for rep in range(3):
        (values, slopes, accs), t = timed(torch, lambda: hmc_chains_fused(
            random.fold_in(k_run, 10 + rep), target.logp, values, N_SAMPLE,
            L=L, eps=EPS, collect_idx=slope_idx))
        times.append(t)
    launches = hmc_chains_fused.launches
    print(f"headline path: {launches} fused HMC launches, "
          f"{nuts_chains_fused.launches} fused NUTS launches")
    check(launches >= 1, "the headline path did not launch the kernel")
    check(values.shape == (N_CHAINS, 3) and slopes.shape == (N_SAMPLE,
                                                               N_CHAINS),
          "unexpected output shapes")
    check(bool(torch.isfinite(values).all())
          and bool(torch.isfinite(slopes).all()), "non-finite samples")
    elapsed = float(np.median(times))
    accept = float(accs.mean()) / N_SAMPLE
    ess, ess_s = timed(torch, lambda: autocorr_ess(slopes))
    _, plain_s = timed(torch, lambda: hmc_chains_fused_plain(
        random.fold_in(k_run, 20), target.logp, values, N_PLAIN, L=L,
        eps=EPS, collect_idx=slope_idx))

    # -- gates ------------------------------------------------------------
    X_np = np.stack([xs, np.ones_like(xs)], axis=1)
    mean_beta, sd_beta, mean_ln, sd_ln = exact_posterior_moments(X_np, ys)
    exact = {("slope",): (mean_beta[0], sd_beta[0]),
             ("intercept",): (mean_beta[1], sd_beta[1]),
             ("log_noise",): (mean_ln, sd_ln)}
    vv = values.double().cpu().numpy()
    for i, pth in enumerate(paths):
        m_ex, s_ex = exact[pth]
        m, s = vv[:, i].mean(), vv[:, i].std()
        good = abs(m - m_ex) < 0.03 * s_ex and abs(s / s_ex - 1) < 0.03
        print(f"{pth[0]:<10} mean {m:+.5f} (exact {m_ex:+.5f})  sd {s:.5f} "
              f"(exact {s_ex:.5f})  {'OK' if good else 'FAIL'}")
        check(good, f"posterior moments of {pth[0]} outside the gate")
    val0 = init_values(torch, model, (X,), obs, sel, random.split(
        random.fold_in(k_init, 1), 8192))
    k_w, k_s = random.split(random.fold_in(k_run, 3))
    val0, _, _ = hmc_chains(k_w, target, val0, n_steps=N_WARMUP, L=L,
                            eps=EPS, collect=lambda v: v[:, 0],
                            teleport_after=10)
    _, hist_val, _ = hmc_chains_fused(k_s, target.logp, val0, N_SAMPLE,
                                      L=L, eps=EPS, collect_idx=None)
    for i, pth in enumerate(paths):
        rh = float(rhat(hist_val[:, :, i].contiguous()))
        print(f"rhat[{pth[0]}] = {rh:.4f}", "OK" if rh < 1.01 else "FAIL")
        check(rh < 1.01, f"split-R-hat of {pth[0]} is {rh}")

    us_step = elapsed / N_SAMPLE * 1e6
    plain_us = plain_s / N_PLAIN * 1e6
    from gen_tpu_torch.ops.hmc_fused import stage
    st = stage(target.logp, 3, dev)
    ops = k1_ops(st.n_instructions, 3, L) * N_CHAINS
    nbytes = 4 * N_CHAINS * (2 * 3 + N_SAMPLE + 1) / N_SAMPLE
    b_ms, b_by = bound_ms(ops, nbytes)
    print(f"{tag} init (vmapped generate, {N_CHAINS} chains): "
          f"{init_s:.3f} s")
    print(f"{tag} warmup hmc_chains: {warm_s:.3f} s for {N_WARMUP} steps "
          f"({warm_s / N_WARMUP * 1e3:.2f} ms/step), accept "
          f"{float(w_acc.float().mean()):.3f}")
    print(f"{tag} K1 fused HMC: median of 3 = {elapsed * 1e3:.2f} ms for "
          f"{N_SAMPLE} steps ({us_step:.2f} us/step; reps "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms), "
          f"accept {accept:.3f}")
    print(f"{tag} K1 plain version: {plain_s * 1e3:.1f} ms for {N_PLAIN} "
          f"steps ({plain_us:.1f} us/step)")
    print(f"{tag} K1 bound: {ops / N_CHAINS:.0f} operations per chain-step "
          f"({st.n_instructions} staged), {nbytes / 1e6:.3f} MB per step "
          f"-> {b_ms * 1e3:.2f} us/step, bound by {b_by}")
    print(f"{tag} ESS {ess:.4e} of {N_SAMPLE * N_CHAINS:.4e} draws, "
          f"ESS/s {ess / elapsed:.4e} (ESS on the card in {ess_s:.2f} s)")
    return dict(name="hmc_fused", route="cuda",
                source="gen_tpu_torch/ops/csrc/hmc_fused.cu",
                replaces="gen_tpu/ops/hmc_fused.py:86",
                per=f"step of {N_CHAINS} chains (L={L})",
                launches=launches, max_abs_err=max(errs),
                ms=elapsed / N_SAMPLE * 1e3,
                plain_ms=plain_s / N_PLAIN * 1e3, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def phase_nuts_path(torch, tt, dev, label, setup, n_chains, tag, k3_err,
                    staged):
    """One general-model path at full width: vmapped generate, ChEES
    warmup, the chunked fused NUTS driver, its gates. Returns the kernel's
    JSON entry."""
    from gen_tpu_torch import random
    from gen_tpu_torch._verify import schools_exact
    from gen_tpu_torch.diagnostics import autocorr_ess, rhat
    from gen_tpu_torch.inference import chees_hmc_warmup_and_sample
    from gen_tpu_torch.ops import nuts_fused as nf
    from gen_tpu_torch.ops.hmc_fused import hmc_chains_fused

    (model, args, obs, sel), ys, sigmas = setup
    key = random.PRNGKey(0, dev)
    k_init, k_warm, k_run, k_time = random.split(key, 4)
    hmc_chains_fused.launches = nf.nuts_chains_fused.launches = 0
    (traces, _), init_s = timed(torch, lambda: torch.func.vmap(
        lambda k: model.generate(k, args, obs))(
        random.split(k_init, n_chains)))
    one = model.generate(random.PRNGKey(1, dev), args, obs)[0]
    from gen_tpu_torch.inference import FlatTarget
    target = FlatTarget(one, sel)
    paths, offsets = flat_layout(tt, one, sel)
    d = int(offsets[-1])
    (_, values, winfo), warm_s = timed(
        torch, lambda: chees_hmc_warmup_and_sample(
            k_warm, traces, sel, num_warmup=NUTS_WARMUP, num_samples=1,
            target_accept=0.8))
    del traces
    eps = float(winfo["step_size"])
    inv_mass = winfo["inv_mass"]
    print(f"{label}: ChEES warmup {warm_s:.2f} s for {NUTS_WARMUP} "
          f"iterations ({warm_s / NUTS_WARMUP * 1e3:.1f} ms/iteration), "
          f"eps {eps:.4f}, trajectory "
          f"{float(winfo['trajectory_length']):.3f}, accept "
          f"{float(winfo['mean_accept']):.3f}, inv_mass "
          f"[{float(inv_mass.min()):.3g}, {float(inv_mass.max()):.3g}]")
    kw = dict(eps=eps, max_depth=8, inv_mass_diag=inv_mass, paired=True)

    def run(vals, k):
        return nf.nuts_chains_fused_chunked(
            k, target.logp, vals, num_ticks=NUTS_TICKS, collect_idx=0, **kw)

    (values, hist, _, _, _), first_s = timed(torch, lambda: run(values,
                                                                k_run))
    del hist
    times = []
    for rep in range(3):
        out, t = timed(torch, lambda: run(values, random.fold_in(k_time,
                                                                  rep)))
        times.append(t)
    launches = nf.nuts_chains_fused.launches
    _, hist_t, _, cnt_t, stats = out
    print(f"{label}: {launches} fused NUTS launches, "
          f"{hmc_chains_fused.launches} fused HMC launches")
    check(launches >= 1, f"{label}: the path did not launch the kernel")
    check(hist_t.shape == (NUTS_TICKS // 2, n_chains)
          and bool(torch.isfinite(hist_t).all()),
          f"{label}: bad history")
    elapsed = float(np.median(times))
    ess, ess_s = timed(torch, lambda: autocorr_ess(hist_t))
    depth = float(stats["mean_depth"].mean())
    accept = float(stats["mean_accept"].mean())
    ndiv = int(stats["num_divergent"].sum())
    completed = int(cnt_t.sum())
    del hist_t

    # the plain version at the same width, over a few pairs
    _, plain_s = timed(torch, lambda: nf.nuts_chains_fused_plain(
        random.fold_in(k_time, 9), target.logp, values, 2 * PLAIN_PAIRS,
        collect_idx=0, **kw))

    # -- gates ------------------------------------------------------------
    exact = schools_exact(ys, sigmas)
    (draws, _, cnt_v, used), gate_s = timed(
        torch, lambda: nf.nuts_collect_draws(
            random.fold_in(k_run, 1), target.logp, values[:4096],
            num_draws=GATE_DRAWS, collect_idx=None, **kw))
    m = int(cnt_v.min())
    print(f"{label} gates: {GATE_DRAWS} draws on 4096 chains took {used} "
          f"slots, {gate_s:.2f} s; completed draws min {m} mean "
          f"{float(cnt_v.float().mean()):.1f}")
    check(m >= GATE_DRAWS and bool(torch.isfinite(draws).all()),
          f"{label}: only {m} completed draws on the slowest chain")
    draws = draws[GATE_DRAWS // 4:].double()
    worst_rh = 0.0
    for p, lo, hi in zip(paths, offsets[:-1], offsets[1:]):
        m_ex, s_ex = (np.atleast_1d(v) for v in exact[p])
        worst_m = worst_s = worst_r = 0.0
        for c in range(lo, hi):
            col = draws[:, :, c]
            mu_c, sd_c = float(col.mean()), float(col.std(correction=0))
            worst_m = max(worst_m, abs(mu_c - m_ex[c - lo]) / s_ex[c - lo])
            worst_s = max(worst_s, abs(sd_c / s_ex[c - lo] - 1.0))
            rh = float(rhat(col[:, :2048].contiguous()))
            worst_r = max(worst_r, rh if math.isfinite(rh) else math.inf)
        worst_rh = max(worst_rh, worst_r)
        good = worst_m < 0.05 and worst_s < 0.06
        print(f"  {p[0]:<10} worst |dmean|/sd={worst_m:.4f} worst "
              f"|dsd|/sd={worst_s:.4f} worst split-R-hat {worst_r:.4f} "
              f"{'OK' if good and worst_r < 1.01 else 'FAIL'}")
        check(good, f"{label}: moments of {p[0]} outside the gate")
    check(worst_rh < 1.01, f"{label}: split-R-hat {worst_rh}")

    pairs = NUTS_TICKS // 2
    ops = k3_ops(staged.n_instructions, d, pairs, n_chains, completed, ndiv)
    nbytes = 4 * n_chains * (2 * d + 2 * pairs + 1 + 5)
    b_ms, b_by = bound_ms(ops, nbytes)
    print(f"{tag} {label} K3: median of 3 = {elapsed * 1e3:.2f} ms for "
          f"{NUTS_TICKS} slots ({elapsed / pairs * 1e6:.2f} us/pair, "
          f"{elapsed / NUTS_TICKS * 1e6:.2f} us/tick; reps "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms; first call "
          f"{first_s:.2f} s)")
    print(f"{tag} {label} K3 plain version: {plain_s * 1e3:.1f} ms for "
          f"{PLAIN_PAIRS} pairs ({plain_s / PLAIN_PAIRS * 1e3:.2f} "
          f"ms/pair)")
    print(f"{tag} {label} K3 bound: {ops:.4e} operations "
          f"({staged.n_instructions} staged), {nbytes / 1e6:.1f} MB -> "
          f"{b_ms:.3f} ms per call, bound by {b_by}")
    print(f"{tag} {label}: ESS(coord 0) {ess:.4e}, ESS/s "
          f"{ess / elapsed:.4e}, mean depth {depth:.2f}, mean accept "
          f"{accept:.3f}, divergent {ndiv}, completed {completed}; init "
          f"{init_s:.2f} s, ESS on the card {ess_s:.2f} s")
    return dict(route="cuda", source="gen_tpu_torch/ops/csrc/nuts_pair.cu",
                replaces="gen_tpu/ops/nuts_fused.py:550",
                per=f"pair of {n_chains} chains, d={d}",
                launches=launches, max_abs_err=k3_err,
                ms=elapsed / pairs * 1e3,
                plain_ms=plain_s / PLAIN_PAIRS * 1e3,
                bound_ms=b_ms / pairs, bound_by=b_by, library_ms=None)


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    import gen_tpu_torch as tt
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import FlatTarget
    from gen_tpu_torch.ops import _cuda_build, hmc_fused
    from gen_tpu_torch.ops import nuts_fused as nf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- phase 1: environment, staging and build --------------------------
    card = phase_env(torch)
    tag = f"[{card}]"
    model, X, obs, sel, xs, ys = regression_setup(torch, tt, dev)
    target = FlatTarget(model.generate(random.PRNGKey(1, dev), (X,),
                                       obs)[0], sel)
    sds = torch.tensor([1.0, 4.0, 0.5], device=dev)

    def gauss_logp(x):
        return -0.5 * torch.sum((x / sds) ** 2)

    gsds = torch.tensor(GAUSS_SDS, device=dev)

    def gauss4_logp(x):
        return -0.5 * torch.sum((x / gsds) ** 2) - 0.3 * x[0] * x[2]

    s8 = (schools_setup(torch, tt, YS_8, SIGMAS_8, dev), YS_8, SIGMAS_8)
    ys100, sig100 = make_schools(100, seed=0)
    s100 = (schools_setup(torch, tt, ys100, sig100, dev), ys100, sig100)
    school_targets = {}
    for name, ((m_, a_, o_, sl_), _, _) in (("d10", s8), ("d102", s100)):
        school_targets[name] = FlatTarget(
            m_.generate(random.PRNGKey(1, dev), a_, o_)[0], sl_)

    (st_reg, st_g3, st_10, st_102, st_g4), stage_s = timed(torch, lambda: (
        hmc_fused.stage(target.logp, 3, dev),
        hmc_fused.stage(gauss_logp, 3, dev),
        hmc_fused.stage(school_targets["d10"].logp, 10, dev),
        hmc_fused.stage(school_targets["d102"].logp, 102, dev),
        hmc_fused.stage(gauss4_logp, 4, dev)))
    jobs = [hmc_fused.build_job(st_reg), hmc_fused.build_job(st_g3),
            nf.build_job(st_10, 8), nf.build_job(st_102, 8),
            nf.build_job(st_g4, 5)]
    names = ["K1 regression", "K1 gaussian", "K3 eight_schools d=10",
             "K3 schools d=102", "K3 gaussian d=4"]
    _, build_s = timed(torch, lambda: _cuda_build.build_all(jobs))
    by_hash = {h: (secs, rep) for h, secs, rep in _cuda_build.BUILD_LOG}
    for name, st, (_, src, _) in zip(
            names, (st_reg, st_g3, st_10, st_102, st_g4), jobs):
        secs, report = by_hash.get(_cuda_build.source_hash(src),
                                   (float("nan"), ""))
        regs = [ln.strip() for ln in report.splitlines()
                if "registers" in ln or "spill" in ln or "stack" in ln]
        print(f"{name}: {st.n_instructions} staged instructions, "
              f"{st.n_res} residual constants; nvcc {secs:.2f} s; "
              + " | ".join(regs))
    print(f"{tag} staging {stage_s:.3f} s, parallel nvcc build "
          f"{build_s:.2f} s")

    # -- phase 2: K3 against its plain version -----------------------------
    errs = []
    v10 = init_values(torch, *s8[0], random.split(random.PRNGKey(11, dev),
                                                  131072))
    errs.append(compare_k3(torch, nf, school_targets["d10"].logp,
                           v10[:8192].contiguous(), 40, 0.3, 8, None, None,
                           1000.0, 1, "eight_schools d=10 n=8192 "
                           "collect=all")[1])
    errs.append(compare_k3(torch, nf, school_targets["d10"].logp, v10, 6,
                           0.3, 8, 0, None, 1000.0, 2,
                           "eight_schools d=10 n=131072 collect=0")[1])
    del v10
    v102 = init_values(torch, *s100[0], random.split(
        random.PRNGKey(12, dev), 32768))
    errs.append(compare_k3(torch, nf, school_targets["d102"].logp, v102, 4,
                           0.1, 8, 0, None, 1000.0, 3,
                           "schools d=102 n=32768 collect=0")[1])
    del v102
    g4 = torch.randn(8000, 4, device=dev) * gsds    # a ragged last block
    errs.append(compare_k3(torch, nf, gauss4_logp, g4, 40, 0.9, 5, 2, None,
                           4.0, 7, "gaussian d=4 eps=0.9 threshold=4")[1])
    inv4 = (gsds ** 2) * torch.tensor([1.0, 1.0, 0.0, 1.0], device=dev)
    (vk, hk, _, _, _), err = compare_k3(
        torch, nf, gauss4_logp, g4, 24, 0.5, 5, 2, inv4, 1000.0, 3,
        "gaussian d=4 frozen coordinate")
    errs.append(err)
    check(torch.equal(vk[:, 2], g4[:, 2])
          and torch.equal(hk, g4[:, 2].expand(24, -1)),
          "K3: frozen coordinate moved")
    check(not torch.equal(vk[:, 0], g4[:, 0]),
          "K3: free coordinate never moved")
    print("K3 frozen coordinate: unchanged in every chain and pair")
    k3_err = max(errs)

    # -- phases 3-4: the main paths, each with its gates --------------------
    rng = np.random.default_rng(123)
    k1_entry = phase_headline(
        torch, tt, dev, (model, X, obs, sel, xs, ys, target, gauss_logp,
                         sds), tag, rng)
    e10 = phase_nuts_path(torch, tt, dev, "eight_schools d=10", s8, 131072,
                          tag, k3_err, st_10)
    e102 = phase_nuts_path(torch, tt, dev, "schools d=102", s100, 32768,
                           tag, k3_err, st_102)
    print(f"{tag} staging {stage_s:.3f} s, nvcc build {build_s:.2f} s")

    # -- phase 5: numbers ---------------------------------------------------
    print(json.dumps({"kernels": [k1_entry, dict(name="nuts_pair", **e10),
                                  dict(name="nuts_pair_d102", **e102)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
