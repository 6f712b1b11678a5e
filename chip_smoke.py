"""Drive gen_tpu_torch's main paths on one NVIDIA GPU and check them.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, so the exit code is
nonzero and no result line is printed):

1. Environment and build: card name and power limit, torch/CUDA/nvcc
   versions; the staging of every model and the build of every kernel
   variant from ``gen_tpu_torch/ops/csrc`` (two K1, three K3, three K6,
   K4 in float32 and float64; one ``nvcc`` per source, all at once), with
   registers, spills and stack from ptxas.
2. Each kernel against its plain PyTorch version, both on the card, with
   injected randomness, at the shapes the main paths give it:
   - K1 (fused HMC): the regression model at 8,192 and 524,288 chains, a
     3-d Gaussian with one frozen coordinate. Accept counts equal, values
     and histories within 2e-4.
   - K3 (pair-scheduled NUTS) and K6 (one leapfrog per tick), each on five
     configurations at the same leapfrog slots: eight_schools d=10 at
     8,192 chains (all coordinates) and at 131,072 chains, the 100-school
     model (d=102) at 32,768 chains, a 4-d Gaussian (8,000 chains, a
     ragged last block) at eps 0.9 with divergence threshold 4 (the
     divergence paths) and the same Gaussian with one frozen coordinate,
     which must never move. Completed and history counts equal, values,
     histories and stats within 1e-5.
   - K4 (systematic resampling) against its plain version, the literal
     count ``systematic_parents_count``, and against torch.searchsorted +
     clamp: integer equality at N 1, 1,000 (ragged), 4,096, 32,768,
     131,072 and 1,048,576, u 0, 0.5 and 1 - 2^-24, float32 and float64,
     random weights, zero-weight runs and one dominant particle.
3. The headline path (``bench.py::main``): the regression model at 524,288
   chains, ``hmc_chains`` warmup, then the fused HMC kernel; gates of
   ``benchmarks/bench_verify.py`` (quadrature moments, split-R-hat).
4. The general-model paths (``bench.py`` metrics 2 and 3): eight_schools at
   131,072 chains (d=10) and the 100-school model at 32,768 chains (d=102),
   vmapped ``generate`` and 400 iterations of ChEES warmup once, then for
   each of K3 (``paired=True``) and K6 (``paired=False``) from that warmed
   state: ``nuts_chains_fused_chunked`` with one decorrelation call and
   three timed calls of 2,000 leapfrog slots. Gates of
   ``benchmarks/bench_nuts_fused.py`` for each kernel: 1,536 completed
   draws on each of 4,096 chains (``nuts_collect_draws``, all
   coordinates), a 25% burn, every coordinate within 0.05 sd (mean) and 6%
   (sd) of the exact quadrature, split-R-hat below 1.01 on 2,048 chains.
5. The one-call sampler ``sample_posterior`` on eight_schools through every
   engine (``SAMPLE_RUNS``): ``auto`` (must dispatch to ``nuts_fused`` and
   launch K3) and ``hmc_fused`` (K1) at 131,072 chains, ``nuts_fused`` with
   ``mass="dense"`` (K3 on the whitened logp) at 32,768 chains, and the
   torch-op engines ``nuts_fsm``, ``chees`` and ``nuts`` at 4,096 chains;
   each call's wall time split into generate, warmup and sampling; gates
   on the returned samples and summary.
6. The SMC slice, every resampling ``systematic`` (K4) unless named,
   K4's launch count set to 0 before each path and read after:
   a. ``smc_genealogy`` on ``benchmarks/workloads.py::
      bench_smc_genealogy``'s nonlinear state-space model at 131,072
      particles and T=32: one warm call, three timed calls, one call split
      into extend (vmapped ``generate``) and resample (uniform, cdf, K4,
      gather); then one filter at 1,048,576 particles. Particle-steps/s;
      K4's launches must equal the resampling steps.
   b. The linear-Gaussian model of ``tests/test_arena.py`` at T=32 and
      131,072 particles against the exact Kalman filter, five seeds per
      path: ``smc_genealogy``, ``smc_run`` on ``UnfoldArena`` and the
      particle-filter API on ``Unfold`` (``initialize_particle_filter``,
      ``maybe_resample``, ``particle_filter_step`` with ``(IntDiff(1),
      NoChange)``). Gates: mean log-ML within 0.05, weighted filtered mean
      of x_T-1 within 0.02 sd and its variance within 3%. Multinomial and
      residual resampling on the particle-filter path (three seeds each,
      the log-ML gate, no K4 launch); 1,000 reconstructed trajectories
      re-assessed against their stored scores (relative 1e-5);
      ``importance_sampling`` at T=2 within 0.05 of the exact log-ML.
7. Numbers: per kernel its time, its plain version's time, its bound, the
   library call's time where there is one and launches on the main path,
   as one JSON line; then the card; then the result line.

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
PLAIN_PAIRS = 10    # the NUTS plain versions are timed over 20 slots
GAUSS_SDS = [1.0, 3.0, 0.5, 2.0]
YS_8 = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
SIGMAS_8 = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]
SCHOOL_ADDRS = ("mu", "log_tau", "theta_std")
SMC_N = 131072         # benchmarks/workloads.py::bench_smc_genealogy
SMC_N_BIG = 1048576    # benchmarks/RESULTS.md's second SMC row
SMC_T = 32
SMC_SEEDS = 5          # seeds per path for the Kalman gates
OTHER_SEEDS = 3        # seeds for multinomial and residual resampling
K4_NS = (1, 1000, 4096, 32768, SMC_N, SMC_N_BIG)
K4_US = (0.0, 0.5, 1.0 - 2.0 ** -24)
K4_REPS = 100
LML_TOL, MEAN_TOL, VAR_TOL = 0.05, 0.02, 0.03
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


def k6_ops(n_instr, d, ticks, n, completed, divergent):
    """Operations of one K6 call that this run's data needs (a lower bound,
    conventions as :func:`k1_ops`): every chain does one leapfrog per tick,
    each the staged program plus 11d + 21 as in :func:`k3_ops`; per tick
    the bf16x2 checkpoint pack (12d integer) and one Philox call for the
    four uniforms; the level-1 U-turn test (6d) at every odd in-subtree
    position, at least (leapfrogs - starts - divergent - n) / 2 of them
    (a trajectory's one-leapfrog first subtree has none, a divergence or
    a chunk end can cut a pair); per trajectory start the momenta (7 per
    normal) and their Philox calls."""
    starts = completed + n
    leapfrogs = ticks * n
    level1 = max(0, (leapfrogs - starts - divergent - n) // 2)
    return (leapfrogs * (n_instr + 11 * d + 21 + 12 * d + 100)
            + level1 * 6 * d
            + starts * (7 * d + 3 * d + 2 + 100 * ((d + 3) // 4)))


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


def nuts_streams(torch, steps, n, d, dev, seed, n_u):
    """The injected streams: z (steps, n, d) and ``n_u`` uniforms (steps,
    n) in [1e-6, 1 - 1e-6] (7 per pair for K3, 4 per tick for K6), drawn
    on the card."""
    gen = torch.Generator(dev).manual_seed(seed)
    z = torch.randn(steps, n, d, device=dev, generator=gen)
    us = [torch.rand(steps, n, device=dev, generator=gen).clamp(1e-6,
                                                                1 - 1e-6)
          for _ in range(n_u)]
    return (z, *us)


def compare_nuts(torch, nf, logp, values0, steps, eps, max_depth,
                 collect_idx, inv_mass, thr, seed, label, paired):
    """K3 (``paired``, ``steps`` pairs) or K6 (``steps`` ticks) vs its
    plain version on the card under the same injected randomness; returns
    the kernel's outputs and the largest difference."""
    n, d = values0.shape
    kname = "K3" if paired else "K6"
    inj = nuts_streams(torch, steps, n, d, values0.device, seed,
                       7 if paired else 4)
    kw = dict(num_ticks=2 * steps if paired else steps, eps=eps,
              max_depth=max_depth, inv_mass_diag=inv_mass,
              collect_idx=collect_idx, divergence_threshold=thr,
              injected_rng=inj, paired=paired)
    key = torch.zeros(2, dtype=torch.int64, device=values0.device)
    out_k = nf.nuts_chains_fused(key, logp, values0, **kw)
    out_p = nf.nuts_chains_fused_plain(key, logp, values0, **kw)
    torch.cuda.synchronize()
    (vk, hk, hck, ck, sk), (vp, hp, hcp, cp, sp) = out_k, out_p
    errs = [float((vk - vp).abs().max()), float((hk - hp).abs().max())]
    errs += [float((sk[s].float() - sp[s].float()).abs().max()) for s in sk]
    n_diff = int((ck != cp).sum()) + int((hck != hcp).any(dim=0).sum())
    ndiv = int(sk["num_divergent"].sum())
    print(f"{kname} {label}: max |kernel - plain| = {max(errs):.3e}, counts "
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


def phase_nuts_path(torch, tt, dev, label, setup, n_chains, tag, errs,
                    staged):
    """One general-model workload at full width: vmapped generate and ChEES
    warmup once, then each fused NUTS kernel (K3 pair-scheduled, K6 one
    leapfrog per tick) from the same warmed state, each with its timed
    calls, plain-version time and gates. Returns the two JSON entries."""
    from gen_tpu_torch import random
    from gen_tpu_torch._verify import schools_exact
    from gen_tpu_torch.inference import FlatTarget, chees_hmc_warmup_and_sample

    (model, args, obs, sel), ys, sigmas = setup
    key = random.PRNGKey(0, dev)
    k_init, k_warm, k_run, k_time = random.split(key, 4)
    (traces, _), init_s = timed(torch, lambda: torch.func.vmap(
        lambda k: model.generate(k, args, obs))(
        random.split(k_init, n_chains)))
    one = model.generate(random.PRNGKey(1, dev), args, obs)[0]
    target = FlatTarget(one, sel)
    paths, offsets = flat_layout(tt, one, sel)
    (_, values, winfo), warm_s = timed(
        torch, lambda: chees_hmc_warmup_and_sample(
            k_warm, traces, sel, num_warmup=NUTS_WARMUP, num_samples=1,
            target_accept=0.8))
    del traces
    eps = float(winfo["step_size"])
    inv_mass = winfo["inv_mass"]
    print(f"{label}: init {init_s:.2f} s; ChEES warmup {warm_s:.2f} s for "
          f"{NUTS_WARMUP} iterations ({warm_s / NUTS_WARMUP * 1e3:.1f} "
          f"ms/iteration), eps {eps:.4f}, trajectory "
          f"{float(winfo['trajectory_length']):.3f}, accept "
          f"{float(winfo['mean_accept']):.3f}, inv_mass "
          f"[{float(inv_mass.min()):.3g}, {float(inv_mass.max()):.3g}]")
    run = dict(label=label, target=target, values=values, eps=eps,
               inv_mass=inv_mass, keys=(k_run, k_time), paths=paths,
               offsets=offsets, exact=schools_exact(ys, sigmas),
               n_chains=n_chains, staged=staged, tag=tag)
    return (nuts_kernel_path(torch, run, True, errs[True]),
            nuts_kernel_path(torch, run, False, errs[False]))


def nuts_kernel_path(torch, run, paired, k_err):
    """The main path of one fused NUTS kernel from the warmed state: launch
    counts set to 0, one decorrelation call and three timed
    ``nuts_chains_fused_chunked`` calls of ``NUTS_TICKS`` leapfrog slots,
    counts read; ESS/s of coordinate 0; the plain version's time; the gates
    through ``nuts_collect_draws``. Returns the kernel's JSON entry."""
    from gen_tpu_torch import random
    from gen_tpu_torch.diagnostics import autocorr_ess, rhat
    from gen_tpu_torch.ops import nuts_fused as nf
    from gen_tpu_torch.ops.hmc_fused import hmc_chains_fused

    label, tag, n_chains = run["label"], run["tag"], run["n_chains"]
    k_run, k_time = run["keys"]
    logp, staged = run["target"].logp, run["staged"]
    kname, kernel = ("K3", "nuts_pair") if paired else ("K6", "nuts_tick")
    d = int(run["offsets"][-1])
    kw = dict(eps=run["eps"], max_depth=8, inv_mass_diag=run["inv_mass"],
              paired=paired)
    steps = NUTS_TICKS // 2 if paired else NUTS_TICKS

    def call(vals, k):
        return nf.nuts_chains_fused_chunked(
            k, logp, vals, num_ticks=NUTS_TICKS, collect_idx=0, **kw)

    hmc_chains_fused.launches = nf.nuts_chains_fused.launches = 0
    nf.nuts_chains_fused.kernel_launches.update(nuts_pair=0, nuts_tick=0)
    (values, hist, _, _, _), first_s = timed(
        torch, lambda: call(run["values"], k_run))
    del hist
    times = []
    for rep in range(3):
        out, t = timed(torch, lambda: call(values, random.fold_in(k_time,
                                                                  rep)))
        times.append(t)
    launches = nf.nuts_chains_fused.kernel_launches[kernel]
    other = nf.nuts_chains_fused.launches - launches
    print(f"{label} {kname}: {launches} launches of {kname}, {other} of the "
          f"other NUTS kernel, {hmc_chains_fused.launches} of K1")
    check(launches >= 1 and other == 0,
          f"{label}: the {kname} path did not run through {kname} alone")
    _, hist_t, _, cnt_t, stats = out
    check(hist_t.shape == (steps, n_chains)
          and bool(torch.isfinite(hist_t).all()), f"{label}: bad history")
    elapsed = float(np.median(times))
    ess, ess_s = timed(torch, lambda: autocorr_ess(hist_t))
    depth = float(stats["mean_depth"].mean())
    accept = float(stats["mean_accept"].mean())
    ndiv = int(stats["num_divergent"].sum())
    completed = int(cnt_t.sum())
    del hist_t

    # the plain version at the same width, over a few pairs of slots
    _, plain_s = timed(torch, lambda: nf.nuts_chains_fused_plain(
        random.fold_in(k_time, 9), logp, values, 2 * PLAIN_PAIRS,
        collect_idx=0, **kw))

    # -- gates ------------------------------------------------------------
    (draws, _, cnt_v, used), gate_s = timed(
        torch, lambda: nf.nuts_collect_draws(
            random.fold_in(k_run, 1), logp, values[:4096],
            num_draws=GATE_DRAWS, collect_idx=None, **kw))
    m = int(cnt_v.min())
    print(f"{label} {kname} gates: {GATE_DRAWS} draws on 4096 chains took "
          f"{used} slots, {gate_s:.2f} s; completed draws min {m} mean "
          f"{float(cnt_v.float().mean()):.1f}")
    check(m >= GATE_DRAWS and bool(torch.isfinite(draws).all()),
          f"{label}: only {m} completed draws on the slowest chain")
    gate_moments(torch, rhat, draws[GATE_DRAWS // 4:], run["paths"],
                 run["offsets"], run["exact"], 2048, 0.05, 0.06, 1.01,
                 f"{label} {kname}")

    if paired:
        ops = k3_ops(staged.n_instructions, d, steps, n_chains, completed,
                     ndiv)
    else:
        ops = k6_ops(staged.n_instructions, d, steps, n_chains, completed,
                     ndiv)
    nbytes = 4 * n_chains * (2 * d + 2 * steps + 1 + 5)
    b_ms, b_by = bound_ms(ops, nbytes)
    unit = "pair" if paired else "tick"
    print(f"{tag} {label} {kname}: median of 3 = {elapsed * 1e3:.2f} ms for "
          f"{NUTS_TICKS} slots ({elapsed / steps * 1e6:.2f} us/{unit}, "
          f"{elapsed / NUTS_TICKS * 1e6:.2f} us per leapfrog slot; reps "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms; first call "
          f"{first_s:.2f} s)")
    print(f"{tag} {label} {kname} plain version: {plain_s * 1e3:.1f} ms for "
          f"{2 * PLAIN_PAIRS} slots "
          f"({plain_s / (2 * PLAIN_PAIRS) * 1e3:.2f} ms per leapfrog slot)")
    print(f"{tag} {label} {kname} bound: {ops:.4e} operations "
          f"({staged.n_instructions} staged), {nbytes / 1e6:.1f} MB -> "
          f"{b_ms:.3f} ms per call, bound by {b_by}")
    print(f"{tag} {label} {kname}: ESS(coord 0) {ess:.4e}, ESS/s "
          f"{ess / elapsed:.4e}, mean depth {depth:.2f}, mean accept "
          f"{accept:.3f}, divergent {ndiv}, completed {completed}; ESS on "
          f"the card {ess_s:.2f} s")
    slots_per_step = 2 if paired else 1
    return dict(route="cuda",
                source="gen_tpu_torch/ops/csrc/" + ("nuts_pair.cu" if paired
                                                    else "nuts_tick.cu"),
                replaces="gen_tpu/ops/nuts_fused.py:"
                + ("550" if paired else "230"),
                per=f"{unit} of {n_chains} chains, d={d}",
                launches=launches, max_abs_err=k_err,
                ms=elapsed / steps * 1e3,
                plain_ms=plain_s / (2 * PLAIN_PAIRS) * slots_per_step * 1e3,
                bound_ms=b_ms / steps, bound_by=b_by, library_ms=None)


def gate_moments(torch, rhat, draws, paths, offsets, exact, rhat_chains,
                 tol_mean, tol_sd, tol_rhat, label):
    """Every coordinate's mean within ``tol_mean`` sd and sd within
    ``tol_sd`` of the exact posterior, split-R-hat below ``tol_rhat`` on the
    first ``rhat_chains`` chains; ``draws`` is ``(draws, chains, d)``."""
    draws = draws.double()
    worst_rh = 0.0
    for p, lo, hi in zip(paths, offsets[:-1], offsets[1:]):
        m_ex, s_ex = (np.atleast_1d(v) for v in exact[p])
        worst_m = worst_s = worst_r = 0.0
        for c in range(lo, hi):
            col = draws[:, :, c]
            mu_c, sd_c = float(col.mean()), float(col.std(correction=0))
            worst_m = max(worst_m, abs(mu_c - m_ex[c - lo]) / s_ex[c - lo])
            worst_s = max(worst_s, abs(sd_c / s_ex[c - lo] - 1.0))
            rh = float(rhat(col[:, :rhat_chains].contiguous()))
            worst_r = max(worst_r, rh if math.isfinite(rh) else math.inf)
        worst_rh = max(worst_rh, worst_r)
        good = worst_m < tol_mean and worst_s < tol_sd
        print(f"  {p[0]:<10} worst |dmean|/sd={worst_m:.4f} worst "
              f"|dsd|/sd={worst_s:.4f} worst split-R-hat {worst_r:.4f} "
              f"{'OK' if good and worst_r < tol_rhat else 'FAIL'}")
        check(good, f"{label}: moments of {p[0]} outside the gate")
    check(worst_rh < tol_rhat, f"{label}: split-R-hat {worst_rh}")


# sample_posterior on eight_schools: (engine, chains, keywords, gate,
# kernel that must launch). The strict gate is the NUTS paths' (every
# coordinate's mean within 0.05 sd and sd within 6% of schools_exact,
# split-R-hat < 1.01 from the returned summary). The torch-op engines run
# at 4,096 chains on small budgets, so their gate is looser: 0.15 sd, 15%
# and split-R-hat < 1.1. Their warmups are short, and they return few
# draws per chain (``nuts`` 30; ``nuts_fsm`` the slowest chain's count,
# ~16 in 1,024 ticks): split-R-hat on half-chains of 8-15 autocorrelated
# draws is biased upward by about (tau - 1) / n, which a converged run of
# this length already puts near 1.07.
STRICT, LOOSE = (0.05, 0.06, 1.01), (0.15, 0.15, 1.1)
SAMPLE_RUNS = [
    ("auto", 131072, dict(num_warmup=400, num_samples=500), STRICT,
     "nuts_pair"),
    ("hmc_fused", 131072, dict(num_warmup=400, num_samples=500), STRICT,
     "hmc_fused"),
    ("nuts_fused", 32768, dict(num_warmup=400, num_samples=500,
                               mass="dense"), STRICT, "nuts_pair"),
    ("nuts_fsm", 4096, dict(num_samples=64, num_ticks=1024, max_depth=6),
     LOOSE, None),
    ("chees", 4096, dict(num_warmup=300, num_samples=200), LOOSE, None),
    ("nuts", 4096, dict(num_warmup=40, num_samples=30, max_depth=6), LOOSE,
     None),
]


class PhaseClock:
    """Wall time of every call of the named module functions, each call
    synchronized, while the block runs: how a ``sample_posterior`` call's
    time splits into warmup and sampling without a timing option in the
    library."""

    def __init__(self, torch, targets):
        self.torch, self.targets, self.calls = torch, targets, {}

    def __enter__(self):
        import importlib
        self.saved = []
        for mod_name, fn_name in self.targets:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name)
            self.calls.setdefault(fn_name, [])   # one log per name
            self.saved.append((mod, fn_name, fn))
            setattr(mod, fn_name, self._wrap(fn, self.calls[fn_name]))
        return self

    def _wrap(self, fn, log):
        def timed_fn(*a, **k):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.torch.cuda.synchronize()
            log.append(time.perf_counter() - t0)
            return out
        return timed_fn

    def __exit__(self, *exc):
        for mod, fn_name, fn in self.saved:
            setattr(mod, fn_name, fn)
        return False


def phase_sample(torch, tt, dev, tag, s8):
    """The one-call sampler on eight_schools through every engine, each
    call with the kernels' launch counts set to 0 just before it and read
    just after; gates on the returned samples and summary. Returns the
    launches per kernel over all calls."""
    from gen_tpu_torch import random
    from gen_tpu_torch._verify import schools_exact
    from gen_tpu_torch.inference import sample_posterior
    from gen_tpu_torch.ops import nuts_fused as nf
    from gen_tpu_torch.ops.hmc_fused import hmc_chains_fused

    (model, args, obs, _), ys, sigmas = s8
    exact = schools_exact(ys, sigmas)
    totals = dict(hmc_fused=0, nuts_pair=0, nuts_tick=0)
    for engine, chains, kw, (t_mean, t_sd, t_rhat), kernel in SAMPLE_RUNS:
        key = random.PRNGKey(5, dev)
        k_init = random.split(key)[0]
        _, gen_s = timed(torch, lambda: torch.func.vmap(
            lambda k: model.generate(k, args, obs))(
            random.split(k_init, chains)))
        hmc_chains_fused.launches = nf.nuts_chains_fused.launches = 0
        nf.nuts_chains_fused.kernel_launches.update(nuts_pair=0, nuts_tick=0)
        clock = PhaseClock(torch, [
            ("gen_tpu_torch.inference.chees", "chees_warmup_flat"),
            ("gen_tpu_torch.inference.nuts_fsm", "nuts_fsm"),
            ("gen_tpu_torch.inference.nuts", "nuts_flat")])
        with clock:
            out, total_s = timed(torch, lambda: sample_posterior(
                key, model, args, obs, num_chains=chains, engine=engine,
                **kw))
        launches = dict(hmc_fused=hmc_chains_fused.launches,
                        **nf.nuts_chains_fused.kernel_launches)
        for k_, v_ in launches.items():
            totals[k_] += v_
        c = clock.calls
        if engine == "nuts_fsm":       # the last FSM call is the sampling run
            sampling = c["nuts_fsm"][-1]
        elif engine == "nuts":         # the last num_samples transitions
            sampling = sum(c["nuts_flat"][-kw["num_samples"]:])
        elif engine == "chees":        # one function warms up and samples
            sampling = float("nan")
        else:                          # ChEES (and whitened re-)warmup
            sampling = total_s - gen_s - sum(c["chees_warmup_flat"])
        warm = total_s - gen_s - (0.0 if math.isnan(sampling) else sampling)
        info = out.info
        n_draws = out.samples["mu"].shape[0]
        print(f"{tag} sample_posterior(engine={engine!r}, {chains} chains"
              f"{', mass=' + kw['mass'] if 'mass' in kw else ''}): ran "
              f"{info['engine']}, {n_draws} draws per chain; {total_s:.2f} "
              f"s = generate {gen_s:.2f} s + warmup "
              + (f"{warm:.2f} s + sampling {sampling:.2f} s"
                 if not math.isnan(sampling) else
                 f"and sampling {warm:.2f} s (one function)")
              + f"; launches {launches}")
        if engine == "auto":
            check(info["engine"] == "nuts_fused"
                  and info["engine_reason"] == "scalarization probe passed",
                  f"auto dispatched to {info['engine']}")
        if kernel is None:
            check(sum(launches.values()) == 0,
                  f"{engine}: a torch-op engine launched a kernel")
        else:
            check(launches[kernel] >= 1,
                  f"{engine}: the path did not launch {kernel}")
        check(n_draws >= 2 and all(bool(torch.isfinite(v).all())
                                   for v in out.samples.values()),
              f"{engine}: bad samples")
        worst = [0.0, 0.0, 0.0]
        for name, arr in out.samples.items():
            m_ex, s_ex = (np.atleast_1d(v) for v in exact[(name,)])
            flat = arr.double().reshape(arr.shape[0] * arr.shape[1], -1)
            worst[0] = max(worst[0], float(((flat.mean(0).cpu().numpy()
                                             - m_ex) / s_ex).__abs__().max()))
            worst[1] = max(worst[1], float(abs(flat.std(0, correction=0)
                                               .cpu().numpy() / s_ex
                                               - 1.0).max()))
            worst[2] = max(worst[2], float(out.summary[name]["rhat"].max()))
        ok = worst[0] < t_mean and worst[1] < t_sd and worst[2] < t_rhat
        print(f"  gates (mean {t_mean} sd, sd {t_sd:.0%}, split-R-hat "
              f"{t_rhat}): worst |dmean|/sd={worst[0]:.4f} |dsd|/sd="
              f"{worst[1]:.4f} split-R-hat={worst[2]:.4f} "
              f"{'OK' if ok else 'FAIL'}")
        check(ok, f"sample_posterior(engine={engine!r}) outside its gate")
        del out
    return totals


# -- K4 and the SMC slice ---------------------------------------------------

def k4_log_weights(n, case, rng):
    """Log weights for K4's checks: normals x 2, with runs of zero weight
    (inside and at the end; particle 0 keeps mass), or all the mass on
    one particle (tests/test_torch_resample.py's cases)."""
    lw = rng.standard_normal(n) * 2.0
    if case == "zero_runs" and n > 1:
        lw[1 + n // 7: 1 + n // 3] = -np.inf
        lw[-max(1, n // 10):] = -np.inf
        lw[n // 2] = -np.inf
    elif case == "dominant":
        lw[:] = -np.inf
        lw[(3 * n) // 4] = 0.0
    return lw


def k4_ops(n):
    """Operations of K4 on N positions (conventions as :func:`k1_ops`):
    per position the reciprocal, the index conversion, the add and the
    multiply (4), ceil(log2(N + 1)) binary-search steps of a comparison
    and an index update (2 each), and the clamp (1)."""
    return n * (4 + 2 * math.ceil(math.log2(n + 1)) + 1)


def gpu_ms(torch, fn, reps):
    """Device time per call of ``fn`` (CUDA events around ``reps`` calls),
    with the calls enqueued behind a spin kernel so that the host's time
    between launches does not count."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(5e7))       # ~25 ms of device time
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_compare_k4(torch, dev):
    """Phase 2 for K4: the kernel against its plain version (the literal
    count) and against torch.searchsorted + clamp, integer equality, at
    every N of ``K4_NS`` and u of ``K4_US``, float32 and float64, with
    random weights, zero-weight runs and one dominant particle (at
    1,048,576 only zero-weight runs: the literal count is O(N^2)).
    Returns the largest difference (0 when all agree)."""
    from gen_tpu_torch.ops import resample as rs
    rng = np.random.default_rng(4)
    runs = dips = 0
    worst = 0
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        for n in K4_NS:
            cases = (("zero_runs",) if n > SMC_N
                     else ("random", "zero_runs", "dominant"))
            for case in cases:
                lw = torch.tensor(k4_log_weights(n, case, rng), dtype=dtype,
                                  device=dev)
                cdf = rs.normalized_cdf(lw)
                raw = torch.cumsum(torch.exp(lw - lw.max()), dim=0)
                dips += int((raw[1:] < raw[:-1]).sum())
                for u in K4_US:
                    ut = torch.tensor(u, dtype=dtype, device=dev)
                    # on the same cdf: the card's cumsum is not run-to-run
                    # reproducible in the last ulp above ~32k elements
                    got = rs.resample_cdf(cdf, ut)
                    count = rs.systematic_parents_count(cdf, ut)
                    lib = torch.searchsorted(
                        cdf, rs.positions(n, ut, dtype, dev),
                        out_int32=True).clamp_(max=n - 1)
                    worst = max(worst, int((got - count).abs().max()),
                                int((got - lib).abs().max()))
                    runs += 1
                    check(torch.equal(got, count) and torch.equal(got, lib),
                          f"K4 {dtype} n={n} {case} u={u}: "
                          f"{int((got != count).sum())} parents differ from "
                          f"the count, {int((got != lib).sum())} from "
                          "searchsorted")
    print(f"K4: kernel == literal count == searchsorted+clamp on all {runs} "
          f"configurations (float32 and float64; N {list(K4_NS)}; u 0, 0.5, "
          f"1-2^-24; random, zero-weight runs, one dominant particle); "
          f"{dips} decreasing steps in the raw cumsums (removed by the "
          f"running max); "
          f"{time.perf_counter() - t0:.1f} s")
    return float(worst)


def smc_bench_setup(torch, tt, dev):
    """benchmarks/workloads.py::bench_smc_genealogy's model and data."""
    from gen_tpu_torch.combinators import VectorChoiceMap

    @tt.gen
    def ssm_kernel(t, prev):
        x = tt.normal(0.8 * prev + 2.0 * torch.sin(0.5 * prev), 0.5) @ "x"
        tt.normal(x, 0.4) @ "y"
        return x

    rng = np.random.default_rng(0)
    ys = torch.tensor(np.cumsum(rng.standard_normal(SMC_T)) * 0.3,
                      dtype=torch.float32, device=dev)
    return ssm_kernel, VectorChoiceMap(tt.ChoiceMap().set_value("y", ys),
                                       SMC_T)


def resampled_steps(torch, ancestry):
    """Steps whose ancestry row is not the identity (a resampling step)."""
    ident = torch.arange(ancestry.shape[1], dtype=ancestry.dtype,
                         device=ancestry.device)
    return int((ancestry != ident).any(dim=1).sum())


def phase_smc_throughput(torch, tt, dev, tag):
    """Phase 6a: smc_genealogy on bench_smc_genealogy's model at 131,072
    particles (one warm call, three timed, one synchronized call split
    into extend and resample) and one timed filter at 1,048,576; K4's
    launches must equal the resampling steps. Returns path a's numbers."""
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import smc
    from gen_tpu_torch.ops import resample as rs

    kernel, obs = smc_bench_setup(torch, tt, dev)
    key = random.PRNGKey(0, dev)

    def run(rep, n):
        return smc.smc_genealogy(random.fold_in(key, rep), kernel, 0.0, (),
                                 obs, n)

    rs.systematic_resample.launches = 0
    out, warm_s = timed(torch, lambda: run(0, SMC_N))
    steps = resampled_steps(torch, out[1])
    times = []
    for rep in range(3):
        out, t = timed(torch, lambda: run(1 + rep, SMC_N))
        times.append(t)
        steps += resampled_steps(torch, out[1])
    clock = PhaseClock(torch, [
        ("gen_tpu_torch.inference.smc", "extend_particles"),
        ("gen_tpu_torch.inference.smc", "resample_states")])
    with clock:
        out, split_s = timed(torch, lambda: run(4, SMC_N))
    steps += resampled_steps(torch, out[1])
    launches = rs.systematic_resample.launches
    subs, anc, lw, lml = out
    print(f"{tag} smc_genealogy N={SMC_N} T={SMC_T}: {steps} resampling "
          f"steps and {launches} K4 launches over 5 filters")
    check(launches == steps and launches >= 1,
          "smc_genealogy: K4 launches differ from resampling steps")
    check(anc.shape == (SMC_T, SMC_N) and lw.shape == (SMC_N,)
          and subs.get_choices()["x"].shape == (SMC_T, SMC_N)
          and math.isfinite(float(lml)), "smc_genealogy: bad output")
    elapsed = float(np.median(times))
    ext, res = clock.calls["extend_particles"], clock.calls["resample_states"]
    print(f"{tag} smc_genealogy N={SMC_N} T={SMC_T}: median of 3 = "
          f"{elapsed * 1e3:.2f} ms per filter, "
          f"{SMC_N * SMC_T / elapsed:.4e} particle-steps/s (reps "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms; warm call "
          f"{warm_s * 1e3:.1f} ms); log-ML {float(lml):.4f}")
    print(f"{tag}   split, one synchronized filter of {split_s * 1e3:.2f} "
          f"ms: extend (vmapped generate) {sum(ext) * 1e3:.2f} ms over "
          f"{len(ext)} steps ({sum(ext) / len(ext) * 1e3:.3f} ms/step), "
          f"resample (uniform, cdf, K4, gather) {sum(res) * 1e3:.2f} ms over "
          f"{len(res)} steps ({sum(res) / max(len(res), 1) * 1e3:.3f} "
          f"ms/step), rest {(split_s - sum(ext) - sum(res)) * 1e3:.2f} ms")
    del out, subs, anc
    rs.systematic_resample.launches = 0
    out, big_s = timed(torch, lambda: run(5, SMC_N_BIG))
    big_steps = resampled_steps(torch, out[1])
    big_launches = rs.systematic_resample.launches
    big_lml = float(out[3])
    print(f"{tag} smc_genealogy N={SMC_N_BIG} T={SMC_T}: one filter "
          f"{big_s * 1e3:.2f} ms, {SMC_N_BIG * SMC_T / big_s:.4e} "
          f"particle-steps/s; {big_steps} resampling steps, {big_launches} "
          f"K4 launches; log-ML {big_lml:.4f}")
    check(math.isfinite(big_lml) and big_launches == big_steps
          and big_launches >= 1, "smc_genealogy at 1,048,576: bad run")
    del out
    return dict(launches=launches, filters=5, ms=elapsed * 1e3,
                big_ms=big_s * 1e3)


def ssm_data(T, seed=3):
    """tests/test_arena.py's linear-Gaussian data."""
    rng = np.random.default_rng(seed)
    x, ys = 0.0, []
    for _ in range(T):
        x = 0.8 * x + 0.5 * rng.standard_normal()
        ys.append(x + 0.3 * rng.standard_normal())
    return np.asarray(ys)


def weighted_moments(torch, x, log_w):
    w = torch.softmax(log_w.double(), dim=0)
    x = x.double()
    m = (w * x).sum()
    return float(m), float((w * (x - m) ** 2).sum())


def phase_smc_gates(torch, tt, dev, tag):
    """Phase 6b: the linear-Gaussian SSM of tests/test_arena.py at T=32 and
    131,072 particles through smc_genealogy, smc_run on UnfoldArena and the
    particle-filter API on Unfold, five seeds each, against the exact
    Kalman filter; multinomial and residual resampling on the
    particle-filter path; reconstructed trajectories re-assessed;
    importance sampling at T=2."""
    from gen_tpu_torch import random
    from gen_tpu_torch._verify import kalman_filter
    from gen_tpu_torch.combinators import (Unfold, UnfoldArena,
                                           vector_choicemap)
    from gen_tpu_torch.diff import IntDiff, NoChange
    from gen_tpu_torch.inference import importance_sampling, smc
    from gen_tpu_torch.inference import particle_filter as pf
    from gen_tpu_torch.ops import resample as rs

    @tt.gen
    def lg_kernel(t, prev):
        x = tt.normal(0.8 * prev, 0.5) @ "x"
        tt.normal(x, 0.3) @ "y"
        return x

    ys = ssm_data(SMC_T)
    lml_ex, means, variances = kalman_filter(ys)
    m_ex, v_ex = means[-1], variances[-1]
    y_t = torch.tensor(ys, dtype=torch.float32, device=dev)
    obs = vector_choicemap(SMC_T, y=y_t)
    arena, unfold = UnfoldArena(lg_kernel, SMC_T), Unfold(lg_kernel)
    kept = {}

    def genealogy(k, method):
        subs, anc, lw, lml = smc.smc_genealogy(
            k, lg_kernel, 0.0, (), obs, SMC_N, resample_method=method)
        kept.setdefault("genealogy", (subs, anc))
        return lml, lw, subs.get_choices()["x"][-1]

    def arena_run(k, method):
        traces, lw, lml = tt.smc_run(k, arena, 0.0, (), obs, SMC_N,
                                     resample_method=method)
        return lml, lw, traces.subtraces.get_choices()["x"][:, SMC_T - 1]

    def pf_run(k, method):
        k0, *ks = random.split(k, SMC_T)
        state = pf.initialize_particle_filter(
            k0, unfold, (1, 0.0), tt.choicemap(((0, "y"), y_t[0])), SMC_N)
        for t in range(1, SMC_T):
            k_res, k_ext = random.split(ks[t - 1])
            state, _ = pf.maybe_resample(k_res, state, method=method)
            state = pf.particle_filter_step(
                k_ext, state, (t + 1, 0.0), (IntDiff(1), NoChange),
                tt.choicemap(((t, "y"), y_t[t])))
        return (pf.log_ml_estimate(state), state.log_weights,
                state.traces.get_retval()[:, SMC_T - 1])

    def gate(label, run, method, seeds, moments):
        rs.systematic_resample.launches = 0
        clock = PhaseClock(torch, [
            ("gen_tpu_torch.inference.particle_filter", "_resample_parents"),
            ("gen_tpu_torch.inference.smc", "_resample_parents")])
        with clock:
            res, secs = timed(torch, lambda: [
                run(random.PRNGKey(100 + s, dev), method)
                for s in range(seeds)])
        steps = len(clock.calls["_resample_parents"])
        launches = rs.systematic_resample.launches
        lmls = [float(r[0]) for r in res]
        mom = np.array([weighted_moments(torch, r[2], r[1]) for r in res])
        d_lml = float(np.mean(lmls)) - lml_ex
        d_m = (mom[:, 0].mean() - m_ex) / math.sqrt(v_ex)
        d_v = mom[:, 1].mean() / v_ex - 1.0
        ok = abs(d_lml) < LML_TOL and (not moments or (
            abs(d_m) < MEAN_TOL and abs(d_v) < VAR_TOL))
        print(f"{tag} {label} ({method}, {seeds} seeds, {secs:.2f} s): "
              f"log-ML {np.mean(lmls):.4f} (Kalman {lml_ex:.4f}, diff "
              f"{d_lml:+.4f}; per seed "
              f"{', '.join(f'{v:.4f}' for v in lmls)}); filtered x_T-1 mean "
              f"diff {d_m:+.4f} sd, var {d_v:+.2%}; {steps} resampling "
              f"steps, {launches} K4 launches {'OK' if ok else 'FAIL'}")
        check(ok, f"{label} ({method}) outside the Kalman gates")
        check(steps >= 1 and launches == (steps if method == "systematic"
                                          else 0),
              f"{label} ({method}): {launches} K4 launches for {steps} "
              "resampling steps")

    print(f"SSM T={SMC_T}: Kalman log-ML {lml_ex:.4f}, filtered x_T-1 "
          f"mean {m_ex:.4f} sd {math.sqrt(v_ex):.4f}")
    gate("smc_genealogy", genealogy, "systematic", SMC_SEEDS, True)
    gate("smc_run (UnfoldArena)", arena_run, "systematic", SMC_SEEDS, True)
    gate("particle-filter API (Unfold)", pf_run, "systematic", SMC_SEEDS,
         True)
    for method in ("multinomial", "residual"):
        gate("particle-filter API (Unfold)", pf_run, method, OTHER_SEEDS,
             False)

    # coherence: re-assess the kernel along reconstructed columns
    subs, anc = kept.pop("genealogy")
    traj = smc.reconstruct_trajectories(subs, anc)
    x = traj.get_choices()["x"][:, :1000]
    prev = torch.cat([torch.zeros_like(x[:1]), x[:-1]])
    worst = 0.0
    for t in range(SMC_T):
        w_t = torch.func.vmap(lambda p, xx: lg_kernel.assess(
            (t, p), tt.choicemap(x=xx, y=y_t[t]))[0])(prev[t], x[t])
        stored = traj.get_score()[t, :1000]
        worst = max(worst, float(((w_t - stored).abs()
                                  / stored.abs().clamp_min(1e-30)).max()))
    print(f"reconstruct_trajectories: 1000 columns re-assessed over {SMC_T} "
          f"steps, worst relative difference from the stored scores "
          f"{worst:.3e}")
    check(worst < 1e-5, "reconstructed trajectories are not coherent")
    del subs, anc, traj

    lml2 = kalman_filter(ys[:2])[0]
    _, _, lml_is = importance_sampling(
        random.PRNGKey(7, dev), unfold, (2, 0.0),
        vector_choicemap(2, y=y_t[:2]), SMC_N)
    print(f"importance_sampling T=2, {SMC_N} particles: log-ML "
          f"{float(lml_is):.4f} (Kalman {lml2:.4f})")
    check(abs(float(lml_is) - lml2) < LML_TOL,
          "importance sampling outside the Kalman gate")


def k4_entry(torch, dev, tag, smc_a, k4_err):
    """Phase 7 for K4: its device time at 131,072 and 1,048,576 float32
    particles, the literal count's time, torch.searchsorted + clamp's
    time and the bound. Returns its JSON entry."""
    from gen_tpu_torch.ops import resample as rs
    rng = np.random.default_rng(5)
    t = {}
    for n in (SMC_N, SMC_N_BIG):
        lw = torch.tensor(rng.standard_normal(n) * 2.0, dtype=torch.float32,
                          device=dev)
        cdf = rs.normalized_cdf(lw)
        u = torch.tensor(0.5, dtype=torch.float32, device=dev)
        pos = rs.positions(n, u, torch.float32, dev)
        rs.resample_cdf(cdf, u)
        k_ms = gpu_ms(torch, lambda: rs.resample_cdf(cdf, u), K4_REPS)
        lib_ms = gpu_ms(torch, lambda: torch.searchsorted(
            cdf, pos, out_int32=True).clamp_(max=n - 1), K4_REPS)
        plain_ms = None
        if n == SMC_N:
            _, plain_s = timed(torch, lambda: rs.systematic_parents_count(
                cdf, u))
            plain_ms = plain_s * 1e3
        b_ms, b_by = bound_ms(k4_ops(n), 4 * n + 4 * n + 4)
        t[n] = (k_ms, lib_ms, plain_ms, b_ms, b_by)
        print(f"{tag} K4 N={n} float32: kernel {k_ms * 1e3:.2f} us, "
              f"searchsorted+clamp {lib_ms * 1e3:.2f} us, bound "
              f"{b_ms * 1e3:.3f} us ({b_by})"
              + (f", literal count {plain_ms:.2f} ms" if plain_ms else ""))
    k_ms, lib_ms, plain_ms, b_ms, b_by = t[SMC_N]
    return dict(name="resample_systematic", route="cuda",
                source="gen_tpu_torch/ops/csrc/resample.cu",
                replaces="gen_tpu/ops/resample.py:40",
                per=f"launch at {SMC_N} float32 particles",
                launches=smc_a["launches"],
                launches_per_filter=smc_a["launches"] / smc_a["filters"],
                max_abs_err=k4_err, ms=k_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                ms_1m=t[SMC_N_BIG][0], library_ms_1m=t[SMC_N_BIG][1],
                bound_ms_1m=t[SMC_N_BIG][3])


def phase_build(torch, tt, dev, tag):
    """Phase 1 after the environment: the models, their staging and the
    parallel build of every kernel variant. Returns the models and staged
    programs the later phases use."""
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import FlatTarget
    from gen_tpu_torch.ops import _cuda_build, hmc_fused, resample
    from gen_tpu_torch.ops import nuts_fused as nf

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
    builds = [("K1 regression", st_reg, hmc_fused.build_job(st_reg)),
              ("K1 gaussian", st_g3, hmc_fused.build_job(st_g3)),
              ("K4 resample (float32, float64)", None, resample.build_job())]
    for paired, k in ((True, "K3"), (False, "K6")):
        builds += [
            (f"{k} eight_schools d=10", st_10, nf.build_job(st_10, 8, paired)),
            (f"{k} schools d=102", st_102, nf.build_job(st_102, 8, paired)),
            (f"{k} gaussian d=4", st_g4, nf.build_job(st_g4, 5, paired))]
    _, build_s = timed(torch, lambda: _cuda_build.build_all(
        [job for _, _, job in builds]))
    by_hash = {h: (secs, rep) for h, secs, rep in _cuda_build.BUILD_LOG}
    for name, st, (_, src, _) in builds:
        secs, report = by_hash.get(_cuda_build.source_hash(src),
                                   (float("nan"), ""))
        regs = [ln.strip() for ln in report.splitlines()
                if "registers" in ln or "spill" in ln or "stack" in ln]
        staged = ("" if st is None else f"{st.n_instructions} staged "
                  f"instructions, {st.n_res} residual constants; ")
        print(f"{name}: {staged}nvcc {secs:.2f} s; " + " | ".join(regs))
    print(f"{tag} staging {stage_s:.3f} s, parallel nvcc build of "
          f"{len(builds)} sources {build_s:.2f} s")
    return dict(k1=(model, X, obs, sel, xs, ys, target, gauss_logp, sds),
                s8=s8, s100=s100, school_targets=school_targets,
                gauss4_logp=gauss4_logp, gsds=gsds, st_10=st_10,
                st_102=st_102, stage_s=stage_s, build_s=build_s)


def phase_compare(torch, ctx, dev, paired):
    """Phase 2: K3 (``paired``) or K6 against its plain version on the five
    injected configurations, at the same leapfrog slots (a K3 pair is two
    K6 ticks). Returns the largest difference."""
    from gen_tpu_torch import random
    from gen_tpu_torch.ops import nuts_fused as nf

    k = "K3" if paired else "K6"
    per = 1 if paired else 2          # steps per pair of leapfrog slots
    st, gsds, g4_logp = ctx["school_targets"], ctx["gsds"], ctx["gauss4_logp"]
    errs = []
    v10 = init_values(torch, *ctx["s8"][0], random.split(
        random.PRNGKey(11, dev), 131072))
    errs.append(compare_nuts(torch, nf, st["d10"].logp,
                             v10[:8192].contiguous(), 40 * per, 0.3, 8, None,
                             None, 1000.0, 1, "eight_schools d=10 n=8192 "
                             "collect=all", paired)[1])
    errs.append(compare_nuts(torch, nf, st["d10"].logp, v10, 6 * per, 0.3, 8,
                             0, None, 1000.0, 2,
                             "eight_schools d=10 n=131072 collect=0",
                             paired)[1])
    del v10
    v102 = init_values(torch, *ctx["s100"][0], random.split(
        random.PRNGKey(12, dev), 32768))
    errs.append(compare_nuts(torch, nf, st["d102"].logp, v102, 4 * per, 0.1,
                             8, 0, None, 1000.0, 3,
                             "schools d=102 n=32768 collect=0", paired)[1])
    del v102
    g4 = torch.randn(8000, 4, device=dev) * gsds    # a ragged last block
    errs.append(compare_nuts(torch, nf, g4_logp, g4, 40 * per, 0.9, 5, 2,
                             None, 4.0, 7, "gaussian d=4 eps=0.9 threshold=4",
                             paired)[1])
    inv4 = (gsds ** 2) * torch.tensor([1.0, 1.0, 0.0, 1.0], device=dev)
    (vk, hk, _, _, _), err = compare_nuts(
        torch, nf, g4_logp, g4, 24 * per, 0.5, 5, 2, inv4, 1000.0, 3,
        "gaussian d=4 frozen coordinate", paired)
    errs.append(err)
    check(torch.equal(vk[:, 2], g4[:, 2])
          and torch.equal(hk, g4[:, 2].expand(24 * per, -1)),
          f"{k}: frozen coordinate moved")
    check(not torch.equal(vk[:, 0], g4[:, 0]),
          f"{k}: free coordinate never moved")
    print(f"{k} frozen coordinate: unchanged in every chain and step")
    return max(errs)


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    import gen_tpu_torch as tt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- phase 1: environment, staging and build --------------------------
    card = phase_env(torch)
    tag = f"[{card}]"
    ctx = phase_build(torch, tt, dev, tag)

    # -- phase 2: K3, K6 and K4 against their plain versions ---------------
    k3_err = phase_compare(torch, ctx, dev, paired=True)
    k6_err = phase_compare(torch, ctx, dev, paired=False)
    k4_err = phase_compare_k4(torch, dev)

    # -- phases 3-5: the main paths, each with its gates --------------------
    rng = np.random.default_rng(123)
    k1_entry = phase_headline(torch, tt, dev, ctx["k1"], tag, rng)
    errs = {True: k3_err, False: k6_err}
    k3_10, k6_10 = phase_nuts_path(torch, tt, dev, "eight_schools d=10",
                                   ctx["s8"], 131072, tag, errs, ctx["st_10"])
    k3_102, k6_102 = phase_nuts_path(torch, tt, dev, "schools d=102",
                                     ctx["s100"], 32768, tag, errs,
                                     ctx["st_102"])
    sample_launches = phase_sample(torch, tt, dev, tag, ctx["s8"])
    print(f"{tag} sample_posterior launches over all engines: "
          f"{sample_launches}")
    print(f"{tag} staging {ctx['stage_s']:.3f} s, nvcc build "
          f"{ctx['build_s']:.2f} s")

    # -- phase 6: the SMC slice ------------------------------------------------
    smc_a = phase_smc_throughput(torch, tt, dev, tag)
    phase_smc_gates(torch, tt, dev, tag)

    # -- phase 7: numbers ---------------------------------------------------
    k4 = k4_entry(torch, dev, tag, smc_a, k4_err)
    print(json.dumps({"kernels": [
        k1_entry, dict(name="nuts_pair", **k3_10),
        dict(name="nuts_pair_d102", **k3_102),
        dict(name="nuts_tick", **k6_10), dict(name="nuts_tick_d102", **k6_102),
        k4]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
