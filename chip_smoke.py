"""Drive gen_tpu_torch's main paths on one NVIDIA GPU and check them.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, so the exit code is
nonzero and no result line is printed):

1. Environment and build: card name and power limit, torch/CUDA/nvcc
   versions; the staging of every model and the build of every kernel
   variant from ``gen_tpu_torch/ops/csrc`` (nine K1, fifteen K3, ten
   K6, seven staged-code kernels, K4 in float32 and float64, K5, and the
   division sweep of phase 1b; one ``nvcc`` per source, all at once),
   with registers, spills and stack from
   ptxas. K3 and K6 above 32 coordinates (the 100-school model, the d=33
   and d=40 Gaussians, the mixed regression's extended logp) run one warp
   per chain; for those the split program's largest per-lane instruction
   count, hubs and classes are printed beside the serial count. K3's and
   K6's census on eight_schools d=10 (``nuts_census``): registers, spills,
   shared bytes a block, blocks and warps an SM (the runtime's occupancy
   calculator), waves at 131,072 chains, SASS counts of local and shared
   loads and stores and MUFU.
1b. The division rule of the staged code (``_div_rcp``): all 2^32
   float32 numerators of every residual constant that a staged model
   divides by through a staged reciprocal, and of edge and random
   denominators, against IEEE division (``DIV_SWEEP_SRC``); any differing
   bit fails.
2. Each kernel against its plain PyTorch version, both on the card, with
   injected randomness, at the shapes the main paths give it:
   - K1 (fused HMC): the regression model at 8,192 and 524,288 chains, a
     3-d Gaussian with one frozen coordinate, eight_schools d=10 at
     131,072 chains. Accept counts equal, values and histories bit for
     bit.
   - K3 (pair-scheduled NUTS) and K6 (one leapfrog per tick), each on
     nine configurations at the same leapfrog slots: eight_schools d=10
     at 8,192 chains (all coordinates) and at 131,072 chains, the
     100-school model (d=102, one warp per chain) at 32,768 chains, a 4-d
     Gaussian (8,000 chains, a ragged last block) at eps 0.9 with
     divergence threshold 4 (the divergence paths), the same Gaussian
     with one frozen coordinate, which must never move, a d=32 Gaussian
     coupling coordinates 0 and 31 (5,000 chains; all coordinates and
     coordinate 31 collected), and in the
     warp-per-chain layout a d=33 Gaussian (lane 8 owns one coordinate)
     coupling coordinates 0 and 32 across lanes, and a d=40 one whose
     coordinate 7 is frozen (8,000 chains each). Completed and history
     counts equal, values, histories and stats bit for bit.
   - K5 (batched categorical) against its plain version with injected
     uniforms (with exact zeros, a row of ties and a NaN row): index
     equality at (300, 37), decode's (432, 27) and (4,672, 27), (16,384,
     27), (131,072, 64) and (4,096, 256).
   - K4 (systematic resampling) against its plain version, the literal
     count ``systematic_parents_count``, and against torch.searchsorted +
     clamp: integer equality at N 1, 1,000 (ragged), 4,096, 32,768,
     131,072 and 1,048,576, u 0, 0.5 and 1 - 2^-24, float32 and float64,
     random weights, zero-weight runs and one dominant particle (at
     1,048,576 the literal count for one u a weight case).
3. The headline path (``bench.py::main``): the regression model at 524,288
   chains, ``hmc_chains`` warmup, then the fused HMC kernel; gates of
   ``benchmarks/bench_verify.py`` (quadrature moments, split-R-hat).
4. The general-model paths (``bench.py`` metrics 2 and 3): eight_schools at
   131,072 chains (d=10) and the 100-school model at 32,768 chains (d=102),
   vmapped ``generate`` and 200 iterations of ChEES warmup once, then for
   each of K3 (``paired=True``) and K6 (``paired=False``) from that warmed
   state: ``nuts_chains_fused_chunked`` with one decorrelation call and
   three timed calls of 2,000 leapfrog slots. Gates of
   ``benchmarks/bench_nuts_fused.py`` for each kernel: 1,536 completed
   draws on each of 4,096 chains (``nuts_collect_draws``, all
   coordinates), a 25% burn, every coordinate within 0.05 sd (mean) and 6%
   (sd) of the exact quadrature, split-R-hat below 1.01 on 2,048 chains.
   At d=102 both kernels must launch in the warp-per-chain layout.
5. The one-call sampler ``sample_posterior`` on eight_schools through every
   engine (``SAMPLE_RUNS``): ``auto`` (must dispatch to ``nuts_fused`` and
   launch K3) and ``hmc_fused`` (K1) at 131,072 chains, ``nuts_fused`` with
   ``mass="dense"`` (K3 on the whitened logp) at 32,768 chains, and the
   torch-op engines ``nuts_fsm``, ``chees`` and ``nuts`` at 4,096 chains;
   then ``nuts_fused`` on the 100-school model at 32,768 chains
   (``WIDE_RUN``), whose K3 launches must all be warp-per-chain (the
   kernel's ``layout_launches``); each call's wall time split into
   generate, warmup and sampling; gates on the returned samples and
   summary.
6. The SMC slice, every resampling ``systematic`` (K4) unless named,
   K4's launch count set to 0 before each path and read after:
   a. ``smc_genealogy`` on ``benchmarks/workloads.py::
      bench_smc_genealogy``'s nonlinear state-space model at 131,072
      particles and T=32: one warm call, three timed calls, one call split
      into extend (vmapped ``generate``) and resample (uniform, cdf, K4,
      gather); then one filter at 1,048,576 particles. Particle-steps/s;
      K4's launches must equal the resampling steps.
   b. The linear-Gaussian model of ``tests/test_arena.py`` at T=32 and
      131,072 particles against the exact Kalman filter, ten seeds per
      path (each path's mean log-ML offset and its standard error):
      ``smc_genealogy``, ``smc_run`` on ``UnfoldArena`` and the
      particle-filter API on ``Unfold`` (``initialize_particle_filter``,
      ``maybe_resample``, ``particle_filter_step`` with ``(IntDiff(1),
      NoChange)``). Gates: mean log-ML within 0.05, weighted filtered mean
      of x_T-1 within 0.02 sd and its variance within 3%. Multinomial and
      residual resampling on the particle-filter path (ten seeds each,
      the log-ML gate, no K4 launch); 1,000 reconstructed trajectories
      re-assessed against their stored scores (relative 1e-5);
      ``importance_sampling`` at T=2 within 0.05 of the exact log-ML.
7. K5's own Philox draws: a vmapped call over 16 keys equals its
   per-key calls (the custom op's vmap rule), a chi-square on 65,536
   equal rows of 7 categories (under 30), distinct draws across equal
   rows and across two keys.
8. The mixed discrete + continuous slice, K5's and K3's launch counts set
   to 0 before each path and read after:
   a. The cipher-decode example (``gen_tpu_torch.examples.decode``) at its
      size: 292 characters, K=27, 16 restarts under vmap, 300 sweeps
      (its own 600 halved for the time limit); gate: the best restart
      decodes > 90% of characters; K5 launches 3 per sweep (900).
   b. ``sample_posterior(engine="auto")`` on tests/test_mixed.py's GMM
      (N=6, 16,384 chains) and examples/regression.py's flagship (n=50,
      256 chains), both ``gibbs_nuts_fused`` (K3 launches > 0), and on the
      scalar categorical model (1,024 chains, ``gibbs_nuts``, no K3
      launch); then the GMM under ``engine="nuts"`` (``gibbs_nuts``) at
      the same 16,384 chains (40 + 40 iterations at tests/test_mixed.py's
      max_depth 6: its lockstep loop waits for the slowest chain's tree),
      to compare the drivers; the gates of
      tests/test_mixed.py (exact enumeration; the regression's slope and
      intercept); wall time split into generate,
      warmup and sampling, with the Gibbs sweeps' and the kernel's share.
10. The streamed likelihood (staging part c, K2c) and the Kalman
    recursion (part b, K2b: a rolled loop over time, a tape of the carry,
    a backward loop that recomputes each step from it), K1, K3 and K6's
    launch counts and the staged
    code's (``scalarize.body_launches``, ``staged_eval.staged_vag``) set
    to 0 before each path and read after:
    a. The staged code alone and K1, K3 and K6 with the stream loop
       (robust-t n = 10,000 at 8,192 chains, n = 10^6 at 1,024; the
       layouts' edges n = 2,049 and 1,000,003 at 1, 3 and 1,027 chains:
       ragged tiles, chains split over blocks, tail blocks; the staged
       code alone also at n = 10^6 with 128 and 256 chains, phase (b)'s
       shapes), and the staged code alone, K1 and K3 with the Kalman body
       (the AR(1) model at T = 100 and 131,072 chains and at T = 1, a
       two-state model at T = 6) against their plain versions under
       injected randomness, bit for bit.
    b. ``benchmarks/bench_stream.py``'s robust-t regression: n = 10,000 at
       8,192 chains through ``sample_posterior(engine="auto")``, which
       must pick ``nuts_fused`` and stream; gates 0.05 sd, 6% against
       ``_verify.robust_t_quadrature``, split-R-hat < 1.02. Then n = 10^6
       at 1,024 chains: ChEES on 128 chains (bench_stream.py:178-196),
       tiled, then K3; the house gate (0.05 sd, 6%; gen_tpu's float32
       floor for this row was 0.3 sd, 12%), split-R-hat < 1.02, the
       absolute errors printed. Then a short
       ``sample_posterior(engine="auto")`` at n = 10^6 and 256 chains
       (20 + 20 iterations), gated on the dispatch, the launches and
       finite draws.
    c. ``benchmarks/bench_statespace_fused.py``'s collapsed AR(1)+noise
       model (T = 100, ``lgssm``) at 131,072 chains through
       ``sample_posterior`` with ``engine="hmc_fused"`` (K1) and
       ``"auto"`` (K3); gates 0.05 sd, 6% against
       ``_verify.ar1_quadrature`` (121 points per axis), split-R-hat < 1.01
       from the returned summary.
11. The rest of SMC, K4's launch count set to 0 before each path that
    resamples and read after:
    a. ``smc_sampler`` on tests/test_tempering.py's conjugate model (20
       observations, prior sd 3, noise sd 1) at 131,072 particles, 20
       rungs, L=5, eps 0.1, two moves a rung, systematic resampling, three
       seeds: mean log-ML within 0.1 of the exact evidence, each seed's
       weighted posterior mean and sd within 0.05; K4 launches > 0.
    b. ``smc_sampler_adaptive`` on the same model (target ESS 0.6):
       log-ML within 0.15, posterior within 0.05, 1 <= stages < 64, a
       ladder rising to 1, K4 launches == stages (one resampling a stage).
    c. ``ais`` on the same model, three seeds: mean log-ML within 0.1;
       ``psis`` of the first run's weights on the card against the same
       weights on the CPU (smoothed weights and k-hat within 1e-5
       relative), with k-hat and the PSIS ESS printed.
    d. ``parallel_tempering`` on tests/test_tempering.py's bimodal model
       (y = 4), six betas 0.02-1.0, 1,000 sweeps, L=8, eps 0.15, the first
       250 dropped: swap rate > 0.2, 0.2 < share of x > 0 < 0.8, mean |x|
       within 0.15 of 2.
    e. ``particle_gibbs`` with ancestor sampling on
       examples/particle_gibbs.py's kernel (phi 0.8) at 4,096 particles
       and T = 40 (benchmarks/workloads.py:469's width), 60 sweeps, 10 of
       burn-in, against ``models.lgssm.kalman_smoother`` with
       tests/test_csmc.py's gate form; CSMC particle-steps/s.
    f. A two-branch ``Switch`` mixture (the component index a batched
       categorical choice) at 131,072 traces: vmapped ``generate``, then
       an ``update`` that flips every index, on the card and on the CPU
       under the same keys: weights, scores and choices within 1e-5
       relative to max(|x|, 1).
12. Gradients and the local moves (no kernel: the slice runs torch ops
    under ``torch.func``), on tests/test_tempering.py's conjugate model
    (phase 11's) unless named:
    a. ``mh_selection`` (200 steps), ``hmc`` (L=5, eps 0.05; 100),
       ``mala`` (tau 0.005; 150) and ``elliptical_slice`` (the prior
       N(0, 9); 20) on "mu", each vmapped over 131,072 chains from prior
       draws: the pooled final states within 0.05 sd (mean) and 6% (sd)
       of the exact posterior; seconds a step and accept rates printed.
    b. ``map_optimize`` (30 moves, vmapped over 131,072 float64 chains
       from prior draws): every chain's mode within 1e-4 sd of the exact
       posterior mean; ``laplace_approx`` (float64): mean within 1e-4 sd,
       sd within 1e-6 relative, log-ML within 1e-4 of the exact evidence
       (the posterior is Gaussian, so Laplace is exact).
    c. ``gibbs``, two blocked moves over (z1, z2) of tests/test_gibbs.py's
       two-site model at 131,072 chains: total variation to the card's
       ``enumerate_posterior`` below 0.01; that posterior equals the
       CPU's within 1e-5 relative.
    d. ``choice_gradients`` (with a return-value gradient) and
       ``param_gradients`` (a copy of the model with trainable prior
       means, scale factor 2) on 131,072 traces of the headline regression
       model, vmapped, on the card, and the first 8,192 of them on the CPU
       under the same keys: equal within 1e-5 (float32) relative to each
       trace's largest entry of the output (``row_rel_err``). Both are
       recomputed in float64 on the CPU at the same choices: each float32
       side within 5e-4 of it elementwise (relative to max(|x|, 1); the
       Gram form's cancellation leaves the CPU's float32 ~1e-4 from it),
       the card's error at most 4x the CPU's or 1e-6.
    e. 10^6 draws of each new distribution (``beta_uniform``,
       ``dirichlet``, ``piecewise_uniform``, ``piecewise_poisson_process``
       with 48 slots, both mixtures, ``exp_of(normal)``, ``normal * 2 +
       3``, a relabeled categorical) against the exact law (KS, marginal
       KS, chi-square, or the Poisson count and the intensity's cdf),
       their logpdfs on the card against the CPU within 1e-5.
9. Numbers (printed after phase 12): per kernel its time, its plain
   version's time, its bound, the library call's time where there is one
   and launches on the main path, as one JSON line (K1's launches summed
   over its three paths, the headline, ``sample_posterior``'s
   ``hmc_fused`` engine and phase 10(c), with its SASS census: hot
   instructions a chain-step, MUFU a leapfrog, registers, spills, waves
   and the issue bound at the SM clock read under load; K2c and K2b per
   gradient of the staged-code kernel; K2c at 10^6 also at the ChEES
   warmup's 128 chains; K2b with its registers, spills, tape bytes and
   executed operations; K4's launches summed over phase 6a and phase
   11's paths); then the card; then the result line.

Each main path is driven with the kernels' launch counts set to 0 just
before it and read just after. The script imports neither JAX nor gen_tpu.
It refuses to run without a CUDA device.
"""

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

N_CHAINS = 524288
N_WARMUP = 100
N_SAMPLE = 500
N_PLAIN = 50        # K1's plain version is timed over 50 steps, not 500
L, EPS = 10, 0.035
TOL = 2e-4          # tests/test_hmc_fused.py's kernel-vs-reference tolerance
NUTS_TOL = 1e-5     # tests/test_nuts_fused.py's kernel-vs-twin tolerance
NUTS_TICKS = 2000
NUTS_WARMUP = 200   # ChEES iterations (400 before the script's time limit)
GATE_DRAWS = 1536   # completed draws per chain for the gates
PLAIN_PAIRS = 10    # the NUTS plain versions are timed over 20 slots
GAUSS_SDS = [1.0, 3.0, 0.5, 2.0]
WARP_DS = (33, 40)  # Gaussians for the warp-per-chain layout's edge cases
YS_8 = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
SIGMAS_8 = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]
SCHOOL_ADDRS = ("mu", "log_tau", "theta_std")
SMC_N = 131072         # benchmarks/workloads.py::bench_smc_genealogy
SMC_N_BIG = 1048576    # benchmarks/RESULTS.md's second SMC row
SMC_T = 32
# seeds per path for the Kalman gates, and for multinomial and residual
# resampling (20 each before the script's time limit; the gates are kept)
SMC_SEEDS = 10
OTHER_SEEDS = 10
K4_NS = (1, 2, 33, 1000, 4096, 32768, SMC_N, SMC_N_BIG)
K4_US = (0.0, 0.5, 1.0 - 2.0 ** -24)
K4_REPS = 100
# the literal count is O(N^2), ~6.7 s a count at 1,048,576 on an H100:
# above this N it runs for one u a weight case (each u once over the three
# cases, both dtypes); searchsorted + clamp checks every configuration
K4_FULL_COUNT_MAX = 131072
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


SM_COUNT = 132            # an H100 SXM's streaming multiprocessors
ISSUE_PER_CLOCK = 4       # warp instructions an SM issues per clock (4
                          # schedulers, one each)


def resident_blocks(registers, threads):
    """Blocks of ``threads`` threads an SM holds at ``registers`` a thread
    (the occupancy calculator's rule for sm_90: registers are allocated per
    warp in units of 256; 65,536 an SM, 64 warps, 32 blocks; the kernels
    here use a few bytes of static shared memory)."""
    per_warp = -(-registers * 32 // 256) * 256
    warps = -(-threads // 32)
    return min(65536 // (per_warp * warps), 64 // warps, 32)


def ptxas_functions(report):
    """ptxas's ``-v`` report as ``{mangled name: dict(registers,
    spill_bytes, stack_bytes)}``."""
    out, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out[name] = dict(registers=None, spill_bytes=0, stack_bytes=0)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and name:
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_bytes=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def sass_functions(job):
    """The SASS of every kernel in ``job``'s built library (``cuobjdump
    -sass``) as ``{mangled name: [(address, opcode, operands)]}``, the
    predicate guard stripped."""
    from gen_tpu_torch.ops import _cuda_build
    so = (_cuda_build.BUILD_DIR
          / f"{job[0]}_{_cuda_build.source_hash(job[1])}.so")
    tool = Path(_cuda_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        # a branch to a label (`(.L_x_3)) as a branch to its address
        labels = {m.group(1): m.group(2) for m in re.finditer(
            r"(\.L_x_\d+):\s*/\*([0-9a-f]{4,})\*/", part)}
        part = re.sub(r"`\((\.L_x_\d+)\)",
                      lambda m: "0x" + labels.get(m.group(1), "0"), part)
        instrs = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part):
            ins = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2).strip())
            op, _, args = ins.partition(" ")
            instrs.append((int(m.group(1), 16), op, args.strip()))
        out[name] = instrs
    return out


SASS_CLASSES = (
    ("FP32", ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "FSET")),
    ("MUFU", ("MUFU",)), ("FCHK", ("FCHK",)),
    ("branch", ("BRA", "CALL", "RET", "BSSY", "BSYNC", "EXIT")),
    ("LDS", ("LDS",)), ("LDC", ("LDC", "ULDC")),
    ("integer", ("IMAD", "IADD3", "LOP3", "SHF", "IMNMX", "ISETP", "LEA",
                 "IABS", "I2F", "F2I", "IMUL", "PRMT", "SEL")),
    ("LDG/STG", ("LDG", "STG")), ("local", ("LDL", "STL")))


def sass_classes(instrs):
    """Instruction counts by class (``SASS_CLASSES``; the rest as
    "other") and by opcode."""
    by_op, by_class = {}, {}
    for _, op, _ in instrs:
        base = op.split(".")[0]
        by_op[base] = by_op.get(base, 0) + 1
        cls = next((c for c, ops in SASS_CLASSES if base in ops), "other")
        by_class[cls] = by_class.get(cls, 0) + 1
    return by_class, by_op


def _branches(instrs):
    """``(address, target)`` of every branch with a constant target."""
    out = []
    for addr, op, args in instrs:
        m = re.match(r"(0x[0-9a-f]+)", args)
        if op.split(".")[0] == "BRA" and m:
            out.append((addr, int(m.group(1), 16)))
    return out


def loop_census(instrs, L_):
    """The SASS of a fused HMC kernel split by its loops: the step loop is
    the widest backward branch's range, the leapfrog loop the widest one
    inside it. The hot path leaves out the slow paths: a range that a
    forward branch skips, holding a call or a local-memory access and no
    back edge of those two loops (an IEEE division's slow-path call, the
    Payne-Hanek reduction of a large sincosf argument, a guarded
    division's IEEE fallback). Returns the hot instructions of a
    chain-step (the rest of the step loop's body once, the leapfrog body
    ``L_`` times), the leapfrog's and the rest's, their class counts, and
    the static counts."""
    br = _branches(instrs)
    loops = [(t, a) for a, t in br if t < a]
    step = max(loops, key=lambda r: r[1] - r[0])
    leap = max([r for r in loops if step[0] <= r[0] and r[1] < step[1]],
               key=lambda r: r[1] - r[0])
    slow = ("CALL", "LDL", "STL")
    cold = [(a, t) for a, t in br if a < t and not a < leap[1] < t
            and not a < step[1] < t
            and any(op.split(".")[0] in slow for x, op, _ in instrs
                    if a < x < t)]

    def hot(lo, hi, skip=None):
        return [i for i in instrs if lo <= i[0] <= hi
                and not (skip and skip[0] <= i[0] <= skip[1])
                and not any(a < i[0] < t for a, t in cold)]

    body, rest = hot(*leap), hot(*step, skip=leap)
    lf, lf_ops = sass_classes(body)
    st, st_ops = sass_classes(rest)
    n_body = sum(1 for i in instrs if leap[0] <= i[0] <= leap[1])
    n_step = sum(1 for i in instrs if step[0] <= i[0] <= step[1])
    return dict(per_chain_step=len(rest) + L_ * len(body),
                leapfrog=len(body), step_rest=len(rest),
                static_per_chain_step=n_step - n_body + L_ * n_body,
                static_leapfrog=n_body,
                mufu_per_leapfrog=lf.get("MUFU", 0),
                fchk_per_leapfrog=lf.get("FCHK", 0),
                lds_per_leapfrog=lf.get("LDS", 0),
                leapfrog_classes=lf, step_rest_classes=st,
                leapfrog_ops=lf_ops, step_rest_ops=st_ops)


def sm_clock_mhz():
    """The SM clock now, in MHz (``nvidia-smi``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def issue_bound_ms(sass_per_chain_step, n_chains, mhz):
    """The least time of one step of ``n_chains`` chains (one thread each)
    at ``ISSUE_PER_CLOCK`` warp instructions per clock on every SM at SM
    clock ``mhz``."""
    warp_instrs = sass_per_chain_step * n_chains / 32
    return warp_instrs / (ISSUE_PER_CLOCK * SM_COUNT * mhz * 1e6) * 1e3


def k1_census(job, collect_all, L_):
    """K1's main instantiation in ``job``'s library (no injected
    randomness; ``collect_all`` the ``collect_idx=None`` history): its
    registers, spills and stack (ptxas), block size and resident blocks an
    SM, and :func:`loop_census` of its SASS."""
    from gen_tpu_torch.ops import _cuda_build
    tag = f"hmc_fused_kernelILb0ELb{int(collect_all)}E"
    fns = sass_functions(job)
    name = next(n for n in fns if tag in n)
    rep = ptxas_functions(_cuda_build.ptxas_report(job[0], job[1]) or "")
    regs = rep.get(name, {})
    block = int(re.search(r"#define HMC_BLOCK (\d+)", job[1]).group(1))
    out = dict(loop_census(fns[name], L_), **regs, block=block)
    if regs.get("registers"):
        out["blocks_per_sm"] = resident_blocks(regs["registers"], block)
    return out


def k1_waves(census, n_chains):
    """Waves of one launch over ``n_chains`` chains (one thread each) and
    the share of its last round that is busy."""
    waves = n_chains / (SM_COUNT * census["blocks_per_sm"]
                        * census["block"])
    return waves, waves / math.ceil(waves)


def nuts_census(job, n_chains):
    """K3's or K6's library built from ``job``: for each instantiation
    with Philox draws (one coordinate collected, all collected) the
    registers, spill bytes and stack (ptxas), the SASS count of local
    (LDL/STL) and shared (LDS/STS) loads and stores and of MUFU, the
    block, the shared bytes a block (static, and the "thread" layout's
    dynamic columns), the blocks and warps an SM (the runtime's occupancy
    calculator where the library reports it, else
    :func:`resident_blocks`) and the waves of ``n_chains`` chains."""
    from gen_tpu_torch.ops import _cuda_build
    name, src = job[0], job[1]

    def define(key, default=0):
        m = re.search(rf"#define {key} (\d+)", src)
        return int(m.group(1)) if m else default

    block, d = define("NUTS_BLOCK"), define("NUTS_D")
    static = 4 * (define("NUTS_R") + 2 * d)
    words = define("NUTS_COLD_WORDS", None)
    fns = ptxas_functions(_cuda_build.ptxas_report(name, src) or "")
    sass = sass_functions(job)
    lib = _cuda_build.build(*job)
    out = {}
    for all_ in (False, True):
        fn = next(f for f in fns if f"{name}_kernelILb0ELb{int(all_)}E" in f)
        ops = sass_classes(sass[fn])[1]
        dyn = 0 if words is None else 4 * block * words
        occ = getattr(lib, f"{name}_occupancy", None) if words else None
        blocks = (occ(int(all_)) if occ is not None
                  else resident_blocks(fns[fn]["registers"], block))
        if blocks <= 0:
            raise RuntimeError(f"{name}: occupancy query failed ({blocks})")
        out["all" if all_ else "one"] = dict(
            fns[fn], block=block, shared_bytes=static + dyn,
            blocks_per_sm=blocks, warps_per_sm=blocks * block // 32,
            waves=n_chains / (SM_COUNT * blocks * block),
            **{k: ops.get(k, 0) for k in ("LDL", "STL", "LDS", "STS",
                                          "MUFU")})
    return out


def census_line(c):
    """One instantiation's :func:`nuts_census` as a line."""
    return (f"{c['registers']} registers, {c['spill_bytes']} B spills, "
            f"{c['stack_bytes']} B stack; block {c['block']}, "
            f"{c['shared_bytes']} B shared a block, {c['blocks_per_sm']} "
            f"blocks ({c['warps_per_sm']} warps) an SM, {c['waves']:.2f} "
            f"waves; SASS LDL {c['LDL']}, STL {c['STL']}, LDS {c['LDS']}, "
            f"STS {c['STS']}, MUFU {c['MUFU']}")


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
    bitwise = torch.equal(vk, vp) and torch.equal(hk, hp) and all(
        torch.equal(sk[s], sp[s]) for s in sk)
    layout = nf.kernel_layout(nf.stage(logp, d, values0.device))
    print(f"{kname} {label} ({layout} layout): "
          f"{'bit for bit' if bitwise else 'not bit for bit'}, "
          f"max |kernel - plain| = {max(errs):.3e}, counts "
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
    check(bitwise, f"{label}: {kname} is not bit for bit its plain version")
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
    check(max(errs) == 0.0, f"K1 differs from its plain version by "
          f"{max(errs)}: not bit for bit")
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
    # the SM clock under this load: calls queued for about half a second,
    # read while they run (not counted as launches of the path)
    for rep in range(20):
        hmc_chains_fused(random.fold_in(k_run, 30), target.logp, values,
                         N_SAMPLE, L=L, eps=EPS, collect_idx=slope_idx)
    mhz = float(np.median([sm_clock_mhz() for _ in range(3)]))
    torch.cuda.synchronize()
    hmc_chains_fused.launches = launches
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
    from gen_tpu_torch.ops.hmc_fused import build_job, stage
    st = stage(target.logp, 3, dev)
    ops = k1_ops(st.n_instructions, 3, L) * N_CHAINS
    nbytes = 4 * N_CHAINS * (2 * 3 + N_SAMPLE + 1) / N_SAMPLE
    b_ms, b_by = bound_ms(ops, nbytes)
    cen = k1_census(build_job(st), False, L)
    waves, busy = k1_waves(cen, N_CHAINS)
    issue_ms = issue_bound_ms(cen["per_chain_step"], N_CHAINS, mhz)
    print(f"{tag} K1 census (main instantiation): {cen['registers']} "
          f"registers, {cen['spill_bytes']} B spills, block {cen['block']}, "
          f"{cen['blocks_per_sm']} blocks an SM, {waves:.2f} waves "
          f"({busy:.1%} of the last round busy); SASS per chain-step "
          f"{cen['per_chain_step']} (leapfrog {cen['leapfrog']} x {L} + "
          f"{cen['step_rest']}), MUFU {cen['mufu_per_leapfrog']} and FCHK "
          f"{cen['fchk_per_leapfrog']} per leapfrog; issue bound "
          f"{issue_ms * 1e3:.2f} us/step at {mhz:.0f} MHz")
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
                bound_by=b_by, library_ms=None,
                sass_per_chain_step=cen["per_chain_step"],
                mufu_per_leapfrog=cen["mufu_per_leapfrog"],
                registers=cen["registers"], spill_bytes=cen["spill_bytes"],
                waves=waves, issue_bound_ms=issue_ms, sm_mhz=mhz)


def compare_k1_schools(torch, ctx, dev, rng):
    """K1 on eight_schools d=10 (the ``hmc_fused`` engine's model, 36
    divisions by residual constants a gradient) against its plain version
    at 131,072 chains under injected randomness, bit for bit."""
    from gen_tpu_torch import random
    from gen_tpu_torch.ops.hmc_fused import (hmc_chains_fused,
                                             hmc_chains_fused_plain)
    v10 = init_values(torch, *ctx["s8"][0], random.split(
        random.PRNGKey(11, dev), 131072))
    err = compare_k1(torch, hmc_chains_fused, hmc_chains_fused_plain,
                     random.PRNGKey(7, dev), ctx["school_targets"]["d10"].logp,
                     v10, 6, 10, 0.25, None, None, rng,
                     "eight_schools d=10 n=131072 collect=all")[2]
    check(err == 0.0, f"K1 eight_schools d=10 differs from its plain version "
          f"by {err}: not bit for bit")
    return err


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
    nf.nuts_chains_fused.layout_launches.update(thread=0, wide=0, warp=0,
                                                  stream=0)
    layout = nf.kernel_layout(staged)
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
    in_layout = nf.nuts_chains_fused.layout_launches[layout]
    print(f"{label} {kname}: {launches} launches of {kname} ({in_layout} in "
          f"the {layout} layout), {other} of the other NUTS kernel, "
          f"{hmc_chains_fused.launches} of K1")
    check(launches >= 1 and other == 0 and in_layout == launches,
          f"{label}: the {kname} path did not run through {kname} alone, "
          f"in the {layout} layout")
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
    return dict(route="cuda", layout=layout,
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
# draws per chain (``nuts`` 20; ``nuts_fsm`` the slowest chain's count,
# ~16 in 1,024 ticks): split-R-hat on half-chains of 8-15 autocorrelated
# draws is biased upward by about (tau - 1) / n, which a converged run of
# this length already puts near 1.07. For the script's time limit the
# runs take about half their earlier depth, gates kept: 200 warmup
# iterations of 400 (``nuts_fsm`` of its default 500), the dense run 250
# draws of 500, ``chees`` 150 + 100 of 300 + 200, ``nuts`` 20 + 20 of
# 40 + 30.
STRICT, LOOSE = (0.05, 0.06, 1.01), (0.15, 0.15, 1.1)
SAMPLE_RUNS = [
    ("auto", 131072, dict(num_warmup=200, num_samples=500), STRICT,
     "nuts_pair"),
    ("hmc_fused", 131072, dict(num_warmup=200, num_samples=500), STRICT,
     "hmc_fused"),
    ("nuts_fused", 32768, dict(num_warmup=200, num_samples=250,
                               mass="dense"), STRICT, "nuts_pair"),
    ("nuts_fsm", 4096, dict(num_warmup=200, num_samples=64, num_ticks=1024,
                            max_depth=6), LOOSE, None),
    ("chees", 4096, dict(num_warmup=150, num_samples=100), LOOSE, None),
    ("nuts", 4096, dict(num_warmup=20, num_samples=20, max_depth=6), LOOSE,
     None),
]
# the same entry point at d=102 (the 100-school model of metric 3), where K3
# runs one warp per chain. The engine keeps every slot's whole state, so
# 200 samples (1,600 slots: ~11 GB of history at 102 coordinates and 32,768
# chains) is what the card holds twice over; the slowest chain then
# completes ~97 draws. The moments take the strict gate; split-R-hat on
# half-chains of ~48 autocorrelated draws carries the (tau - 1) / n bias of
# the short torch-op runs (1.054 on an H100, moments within 0.0012 sd), so
# it takes their 1.1. Phase 4 holds the d=102 kernels to split-R-hat < 1.01
# on 1,536 draws per chain.
WIDE_RUN = ("nuts_fused", 32768, dict(num_warmup=200, num_samples=200),
            (0.05, 0.06, 1.1), "nuts_pair")


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


def phase_sample(torch, tt, dev, tag, s8, s100):
    """The one-call sampler on eight_schools through every engine, then
    (``WIDE_RUN``) ``nuts_fused`` on the 100-school model, where K3 runs
    one warp per chain; each call with the kernels' launch counts set to 0
    just before it and read just after; gates on the returned samples and
    summary. Returns the launches per kernel over all calls."""
    from gen_tpu_torch import random
    from gen_tpu_torch._verify import schools_exact
    from gen_tpu_torch.inference import sample_posterior
    from gen_tpu_torch.ops import nuts_fused as nf
    from gen_tpu_torch.ops.hmc_fused import hmc_chains_fused

    totals = dict(hmc_fused=0, nuts_pair=0, nuts_tick=0)
    runs = [(s8, r) for r in SAMPLE_RUNS] + [(s100, WIDE_RUN)]
    for (model_args, ys, sigmas), (engine, chains, kw, (t_mean, t_sd, t_rhat),
                                   kernel) in runs:
        model, args, obs, _ = model_args
        exact = schools_exact(ys, sigmas)
        d = 2 + len(ys)
        key = random.PRNGKey(5, dev)
        k_init = random.split(key)[0]
        _, gen_s = timed(torch, lambda: torch.func.vmap(
            lambda k: model.generate(k, args, obs))(
            random.split(k_init, chains)))
        hmc_chains_fused.launches = nf.nuts_chains_fused.launches = 0
        nf.nuts_chains_fused.kernel_launches.update(nuts_pair=0, nuts_tick=0)
        nf.nuts_chains_fused.layout_launches.update(thread=0, wide=0,
                                                  warp=0, stream=0)
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
        layouts = dict(nf.nuts_chains_fused.layout_launches)
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
        print(f"{tag} sample_posterior(engine={engine!r}, d={d}, {chains} "
              f"chains{', mass=' + kw['mass'] if 'mass' in kw else ''}): ran "
              f"{info['engine']}, {n_draws} draws per chain; {total_s:.2f} "
              f"s = generate {gen_s:.2f} s + warmup "
              + (f"{warm:.2f} s + sampling {sampling:.2f} s"
                 if not math.isnan(sampling) else
                 f"and sampling {warm:.2f} s (one function)")
              + f"; launches {launches}, by layout {layouts}")
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
        if d > 32 and kernel in ("nuts_pair", "nuts_tick"):
            check(layouts["warp"] >= 1 and layouts["thread"] == 0
                  and layouts["wide"] == 0,
                  f"{engine} at d={d}: K3/K6 did not run one warp per chain")
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
    multiply (4), its count in a window of at most 1,024 cdf entries (10
    halving steps of a comparison and a select, and the last comparison
    and add: 22), the clamp (1); the blocks' 32-ary rounds add less than 1
    a position. Below 1,024 particles the window is the whole cdf."""
    steps = math.ceil(math.log2(min(n, 1024))) if n > 1 else 0
    return n * (4 + 2 * steps + 2 + 1)


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


def launch_floor_ms(torch, dev, reps, timings=1):
    """The launch floor: device time of one launch of the empty kernel
    (``ops/launch_floor.py``), through the same ``ctypes`` path and
    ``torch.empty`` as K4 and K5, by :func:`gpu_ms` at ``reps`` launches
    (the median of ``timings`` such timings)."""
    from gen_tpu_torch.ops import launch_floor as lf
    lf.launch_floor(dev)
    return float(np.median([gpu_ms(torch, lambda: lf.launch_floor(dev), reps)
                            for _ in range(timings)]))


def small_waves(blocks, threads, registers, smem_bytes):
    """Rounds of the card that ``blocks`` blocks of ``threads`` take:
    blocks an SM by :func:`resident_blocks` and by the shared memory (228
    KB an SM, 1 KB reserved a block)."""
    per_sm = min(resident_blocks(registers, threads),
                 233472 // (smem_bytes + 1024))
    return per_sm, blocks / (per_sm * SM_COUNT)


def ptxas_function(job, part):
    """ptxas's numbers (registers, spill and stack bytes) of the function
    of ``job``'s library whose mangled name holds ``part``."""
    from gen_tpu_torch.ops import _cuda_build
    fns = ptxas_functions(_cuda_build.ptxas_report(job[0], job[1]) or "")
    return next(v for k, v in fns.items() if part in k)


def phase_compare_k4(torch, dev):
    """Phase 2 for K4: the kernel against its plain version (the literal
    count) and against torch.searchsorted + clamp, integer equality, at
    every N of ``K4_NS`` and u of ``K4_US``, float32 and float64, with
    random weights, zero-weight runs and one dominant particle; above
    ``K4_FULL_COUNT_MAX`` the literal count (O(N^2)) for one u a case.
    Returns the largest difference (0 when all agree)."""
    from gen_tpu_torch.ops import resample as rs
    rng = np.random.default_rng(4)
    runs = dips = counted = 0
    worst = 0
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        for n in K4_NS:
            for ci, case in enumerate(("random", "zero_runs", "dominant")):
                lw = torch.tensor(k4_log_weights(n, case, rng), dtype=dtype,
                                  device=dev)
                cdf = rs.normalized_cdf(lw)
                raw = torch.cumsum(torch.exp(lw - lw.max()), dim=0)
                dips += int((raw[1:] < raw[:-1]).sum())
                for ui, u in enumerate(K4_US):
                    ut = torch.tensor(u, dtype=dtype, device=dev)
                    # on the same cdf: the card's cumsum is not run-to-run
                    # reproducible in the last ulp above ~32k elements
                    got = rs.resample_cdf(cdf, ut)
                    lib = torch.searchsorted(
                        cdf, rs.positions(n, ut, dtype, dev),
                        out_int32=True).clamp_(max=n - 1)
                    if n <= K4_FULL_COUNT_MAX or ui == ci:
                        count = rs.systematic_parents_count(cdf, ut)
                        counted += 1
                    else:
                        count = lib
                    worst = max(worst, int((got - count).abs().max()),
                                int((got - lib).abs().max()))
                    runs += 1
                    check(torch.equal(got, count) and torch.equal(got, lib),
                          f"K4 {dtype} n={n} {case} u={u}: "
                          f"{int((got != count).sum())} parents differ from "
                          f"the count, {int((got != lib).sum())} from "
                          "searchsorted")
    print(f"K4: kernel == searchsorted+clamp on all {runs} configurations "
          f"and == the literal count on {counted} (float32 and float64; N "
          f"{list(K4_NS)}; u 0, 0.5, 1-2^-24; random, zero-weight runs, one "
          f"dominant particle; above N={K4_FULL_COUNT_MAX} one u a case); "
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
        se = float(np.std(lmls, ddof=1)) / math.sqrt(seeds)
        d_m = (mom[:, 0].mean() - m_ex) / math.sqrt(v_ex)
        d_v = mom[:, 1].mean() / v_ex - 1.0
        ok = abs(d_lml) < LML_TOL and (not moments or (
            abs(d_m) < MEAN_TOL and abs(d_v) < VAR_TOL))
        print(f"{tag} {label} ({method}, {seeds} seeds, {secs:.2f} s): "
              f"log-ML {np.mean(lmls):.4f} (Kalman {lml_ex:.4f}, diff "
              f"{d_lml:+.4f}, SE {se:.4f}, {d_lml / se:+.2f} SE; per seed "
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


def k4_entry(torch, dev, tag, smc_a, k4_err, tempered):
    """Phase 9 for K4: its device time at 131,072 and 1,048,576 float32
    particles in each weight case of :func:`k4_log_weights` (random, the
    headline; zero-weight runs; one dominant particle), the launch floor,
    the literal count's time, torch.searchsorted + clamp's time, the bound,
    registers, spills and waves. Its launches are summed over its main
    paths: phase 6a's genealogy filters and phase 11's tempered samplers
    and Particle Gibbs (``tempered``, by path). Returns its JSON entry."""
    from gen_tpu_torch.ops import resample as rs
    rng = np.random.default_rng(5)
    floor = launch_floor_ms(torch, dev, K4_REPS)
    fn = ptxas_function(rs.build_job(), "IfE")      # the float32 kernel
    t = {}
    for n in (SMC_N, SMC_N_BIG):
        run, threads, blocks, smem = rs.launch_shape(n)
        per_sm, waves = small_waves(blocks, threads, fn["registers"], smem)
        for case in ("random", "zero_runs", "dominant"):
            lw = torch.tensor(k4_log_weights(n, case, rng),
                              dtype=torch.float32, device=dev)
            cdf = rs.normalized_cdf(lw)
            u = torch.tensor(0.5, dtype=torch.float32, device=dev)
            pos = rs.positions(n, u, torch.float32, dev)
            rs.resample_cdf(cdf, u)
            k_ms = gpu_ms(torch, lambda: rs.resample_cdf(cdf, u), K4_REPS)
            lib_ms = gpu_ms(torch, lambda: torch.searchsorted(
                cdf, pos, out_int32=True).clamp_(max=n - 1), K4_REPS)
            plain_ms = None
            if n == SMC_N and case == "random":
                _, plain_s = timed(torch, lambda: rs.systematic_parents_count(
                    cdf, u))
                plain_ms = plain_s * 1e3
            b_ms, b_by = bound_ms(k4_ops(n), 4 * n + 4 * n + 4)
            t[n, case] = (k_ms, lib_ms, plain_ms, b_ms, b_by)
            print(f"{tag} K4 N={n} float32 {case}: kernel {k_ms * 1e3:.2f} "
                  f"us (launch floor {floor * 1e3:.2f} us), "
                  f"searchsorted+clamp {lib_ms * 1e3:.2f} us, bound "
                  f"{b_ms * 1e3:.3f} us ({b_by}); {fn['registers']} "
                  f"registers, {fn['spill_bytes']} B spills, {blocks} blocks "
                  f"of {threads} ({run} positions a block), {per_sm} blocks "
                  f"an SM, {waves:.2f} waves"
                  + (f", literal count {plain_ms:.2f} ms" if plain_ms else ""))
    k_ms, lib_ms, plain_ms, b_ms, b_by = t[SMC_N, "random"]
    return dict(name="resample_systematic", route="cuda",
                source="gen_tpu_torch/ops/csrc/resample.cu",
                replaces="gen_tpu/ops/resample.py:40",
                per=f"launch at {SMC_N} float32 particles",
                launches=smc_a["launches"] + sum(tempered.values()),
                launches_by_path=dict(smc_genealogy=smc_a["launches"],
                                      **tempered),
                launches_per_filter=smc_a["launches"] / smc_a["filters"],
                max_abs_err=k4_err, ms=k_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                floor_ms=floor, registers=fn["registers"],
                spill_bytes=fn["spill_bytes"],
                ms_1m=t[SMC_N_BIG, "random"][0],
                library_ms_1m=t[SMC_N_BIG, "random"][1],
                bound_ms_1m=t[SMC_N_BIG, "random"][3],
                cases={f"{n}_{case}": dict(ms=v[0], library_ms=v[1])
                       for (n, case), v in t.items()})


# -- phase 8: the mixed discrete + continuous slice and K5 --------------------

K5_SHAPES = ((300, 37), (16 * 27, 27), (16 * 292, 27), (16384, 27),
             (131072, 64))
K5_TIMED_ONLY = (4096, 256)
K5_MAIN_SHAPE = (16 * 292, 27)      # decode's plaintext blocks
K5_CHI_PROBS = (0.05, 0.1, 0.2, 0.02, 0.33, 0.25, 0.05)
K5_CHI_ROWS = 65536
DECODE_SWEEPS, DECODE_RESTARTS = 300, 16   # 600 sweeps before the time limit
GMM_YS = (-2.3, -1.8, -0.4, 0.6, 2.2, 1.9)
GMM_SIGMA, GMM_TAU, GMM_LOCS = 1.0, 1.5, (-2.0, 2.0)
SCALAR_LOCS, SCALAR_PRIOR, SCALAR_Y = (-3.0, 0.0, 3.0), (0.5, 0.3, 0.2), 2.4
# (model, chains, sample_posterior keywords, the engine that must run:
# gen_tpu's pick under "auto"); the last run is the GMM on the
# alternating driver at the same chains, to compare the two drivers. The
# last three run at a quarter to a half of their earlier depth (regression
# 120 + 120, scalar 60 + 120, GMM alternating 40 + 40) for the script's
# time limit, with the gates kept: the alternating GMM keeps its 40 warmup
# iterations (at 20 + 20 its pooled variance was 38% off, against 11% at
# 40 + 40 and at the fused run's 150 + 120)
MIXED_RUNS = (
    ("gmm", 16384, dict(engine="auto", num_warmup=150, num_samples=120),
     "gibbs_nuts_fused"),
    ("regression", 256, dict(engine="auto", num_warmup=30,
                             num_samples=30), "gibbs_nuts_fused"),
    ("scalar", 1024, dict(engine="auto", num_warmup=30, num_samples=25,
                          max_depth=6), "gibbs_nuts"),
    ("gmm", 16384, dict(engine="nuts", num_warmup=40, num_samples=10,
                        max_depth=6), "gibbs_nuts"),
)


def mixed_setup(torch, tt, dev):
    """tests/test_mixed.py's GMM (N=6) and scalar categorical model and
    examples/regression.py's flagship (make_dataset's n=50), on ``dev``.
    Returns name -> (model, args, observations)."""
    from gen_tpu_torch.combinators import vector_choicemap

    @tt.gen
    def gmm_datum(mu0, mu1):
        z = tt.bernoulli(0.5) @ "z"
        return tt.normal(torch.where(z, mu1, mu0), GMM_SIGMA) @ "y"

    gmm_data = tt.Map(gmm_datum)

    @tt.gen
    def gmm(n):
        mu0 = tt.normal(GMM_LOCS[0], GMM_TAU) @ "mu0"
        mu1 = tt.normal(GMM_LOCS[1], GMM_TAU) @ "mu1"
        return gmm_data(mu0.expand(n), mu1.expand(n)) @ "data"

    @tt.gen
    def reg_datum(x, slope, intercept, inlier_std, outlier_std):
        is_outlier = tt.bernoulli(0.5) @ "is_outlier"
        std = torch.where(is_outlier, outlier_std, inlier_std)
        return tt.normal(slope * x + intercept, std) @ "y"

    reg_data = tt.Map(reg_datum)

    @tt.gen
    def regression(xs):
        slope = tt.normal(0.0, 2.0) @ "slope"
        intercept = tt.normal(0.0, 2.0) @ "intercept"
        inlier_log_std = tt.normal(0.0, 1.0) @ "inlier_log_std"
        outlier_log_std = tt.normal(2.0, 1.0) @ "outlier_log_std"
        n = xs.shape[0]
        return reg_data(xs, slope.expand(n), intercept.expand(n),
                        torch.exp(inlier_log_std).expand(n),
                        torch.exp(outlier_log_std).expand(n)) @ "data"

    prior = torch.tensor(SCALAR_PRIOR, device=dev)
    locs = torch.tensor(SCALAR_LOCS, device=dev)

    @tt.gen
    def scalar_mix():
        k = tt.categorical(prior) @ "k"
        mu = tt.normal(locs[k.long().reshape(1)][0], 1.0) @ "mu"
        return tt.normal(mu, 0.5) @ "y"

    rng = np.random.default_rng(0)          # make_dataset(n=50, seed=0)
    xs = np.linspace(-5, 5, 50)
    ys = -1.2 * xs + 2.0 + rng.normal(0, 0.5, 50)
    outliers = rng.random(50) < 0.15
    ys[outliers] = rng.normal(0, 8.0, outliers.sum())

    def vec_obs(y):
        obs = tt.ChoiceMap()
        obs.set_submap("data", vector_choicemap(
            len(y), y=torch.tensor(np.asarray(y, np.float32), device=dev)))
        return obs

    return dict(
        gmm=(gmm, (len(GMM_YS),), vec_obs(GMM_YS)),
        regression=(regression, (torch.tensor(xs.astype(np.float32),
                                              device=dev),), vec_obs(ys)),
        scalar=(scalar_mix, (), tt.choicemap(
            y=torch.tensor(SCALAR_Y, device=dev))))


def mixed_jobs(torch, tt, dev, models):
    """K3 build jobs for the two models whose extended logp stages (the
    fused mixed driver launches K3 on them at sample_posterior's default
    max_depth 8), so that they build with the other kernels."""
    from gen_tpu_torch import random
    from gen_tpu_torch.inference.mixed import extended_layout
    from gen_tpu_torch.inference.target import FlatTarget
    from gen_tpu_torch.ops import hmc_fused
    from gen_tpu_torch.ops import nuts_fused as nf
    jobs = []
    for name in ("gmm", "regression"):
        model, args, obs = models[name]
        tr = model.generate(random.PRNGKey(1, dev), args, obs)[0]
        target = FlatTarget(tr, extended_layout(tr, obs)[0])
        st = hmc_fused.stage(target.logp, target.dim, dev)
        jobs.append((f"K3 {name} extended d={target.dim}", st,
                     nf.build_job(st, 8, True)))
    return jobs


def k5_inputs(torch, n, k, dev, seed):
    """Logits ~ 2 N(0, 1) and uniforms on [0, 1) with exact zeros, a
    constant row (ties) and a NaN row."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    logits = torch.randn(n, k, generator=g) * 2.0
    u = torch.rand(n, k, generator=g)
    u[0, : min(k, 5)] = 0.0
    if n > 2:
        logits[1], u[1] = 0.0, 0.5
        logits[2, k // 2] = float("nan")
    return logits.to(dev), u.to(dev)


def phase_compare_k5(torch, dev):
    """Phase 2 for K5: the kernel against its plain version with injected
    uniforms at every shape of ``K5_SHAPES`` and ``K5_TIMED_ONLY`` (index
    equality). Returns the largest index difference (0 when all agree)."""
    from gen_tpu_torch.ops import categorical as cat
    worst = 0
    for n, k in K5_SHAPES + (K5_TIMED_ONLY,):
        logits, u = k5_inputs(torch, n, k, dev, n + k)
        got = cat.batched_categorical(None, logits, injected_u=u)
        want = cat.batched_categorical_plain(logits, u)
        worst = max(worst, int((got - want).abs().max()))
        check(torch.equal(got, want),
              f"K5 ({n}, {k}): {int((got != want).sum())} rows differ from "
              "the plain version")
        check(int(got[2]) == k - 1 and int(got[1]) == 0,
              f"K5 ({n}, {k}): NaN row or tie rule wrong")
    print(f"K5: kernel == plain version (injected uniforms, zeros, ties, a "
          f"NaN row) at {list(K5_SHAPES + (K5_TIMED_ONLY,))}")
    return float(worst)


def phase_k5_draws(torch, dev):
    """Phase 7: K5's own Philox draws. The vmap rule against per-key
    calls, a chi-square on (65,536, 7) rows of equal logits, distinct
    draws across such rows and across two keys."""
    from gen_tpu_torch import random
    from gen_tpu_torch.ops import categorical as cat
    lt = torch.randn(27, 27, device=dev)
    keys = random.split(random.PRNGKey(3, dev), DECODE_RESTARTS)
    batched = torch.func.vmap(lambda kk: cat.categorical_fast(kk, lt))(keys)
    check(all(torch.equal(batched[b], cat.categorical_fast(keys[b], lt))
              for b in range(DECODE_RESTARTS)),
          "K5 vmap rule: a batched call differs from its per-key calls")
    probs = torch.tensor(K5_CHI_PROBS, device=dev)
    logits = torch.log(probs).expand(K5_CHI_ROWS, -1).contiguous()
    draws = cat.categorical_fast(random.PRNGKey(0, dev), logits)
    counts = torch.bincount(draws.long(), minlength=7).double()
    expected = probs.double() * K5_CHI_ROWS
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    other = cat.categorical_fast(random.PRNGKey(1, dev), logits)
    distinct = int(torch.unique(draws[:64]).numel())
    print(f"K5: vmap over {DECODE_RESTARTS} keys == per-key calls; own "
          f"draws: chi-square "
          f"{chi2:.2f} (df 6, limit 30) on {K5_CHI_ROWS} equal rows, "
          f"{distinct} distinct values in the first 64 rows, "
          f"{int((draws != other).sum())} of {K5_CHI_ROWS} rows differ "
          "between two keys")
    check(chi2 < 30, f"K5 chi-square {chi2:.2f} >= 30")
    check(distinct > 1 and not torch.equal(draws, other),
          "K5: equal rows or two keys drew the same values")


def gmm_exact_moments():
    """tests/test_mixed.py::_gmm_exact_moments: mu0's posterior mean and
    variance and P(z_i = 1) by enumeration of all 2^N assignments with
    conjugate per-cluster evidence."""
    import itertools
    y = np.asarray(GMM_YS, np.float64)
    logws, m0s, v0s, zs = [], [], [], []
    for z in itertools.product([0, 1], repeat=len(y)):
        z = np.asarray(z)
        lw, ms, vs = 0.0, [], []
        for k in (0, 1):
            yk = y[z == k]
            vk = 1.0 / (1.0 / GMM_TAU ** 2 + len(yk) / GMM_SIGMA ** 2)
            mk = vk * (GMM_LOCS[k] / GMM_TAU ** 2 + yk.sum() / GMM_SIGMA ** 2)
            lw += 0.5 * np.log(vk / GMM_TAU ** 2) + 0.5 * mk ** 2 / vk
            ms.append(mk)
            vs.append(vk)
        logws.append(lw)
        m0s.append(ms[0])
        v0s.append(vs[0])
        zs.append(z)
    w = np.exp(np.asarray(logws) - max(logws))
    w /= w.sum()
    mean = float(w @ np.asarray(m0s))
    var = float(w @ (np.asarray(v0s) + np.asarray(m0s) ** 2) - mean ** 2)
    return mean, var, w @ np.asarray(zs, np.float64)


def scalar_exact_posterior():
    """P(k | y) of the scalar categorical model, mu integrated out."""
    locs, pri = np.asarray(SCALAR_LOCS), np.asarray(SCALAR_PRIOR)
    var = 1.0 + 0.25
    log_ev = (np.log(pri) - 0.5 * (SCALAR_Y - locs) ** 2 / var
              - 0.5 * np.log(2 * np.pi * var))
    post = np.exp(log_ev - log_ev.max())
    return post / post.sum()


def mixed_gate(torch, name, out):
    """The gates of tests/test_mixed.py. Returns (ok, text)."""
    s = {k: v.double().cpu().numpy() for k, v in out.samples.items()}
    if name == "gmm":
        mean, var, pz = gmm_exact_moments()
        burn = s["mu0"].shape[0] // 4
        mu0, z = s["mu0"][burn:].ravel(), s[("data", "z")][burn:]
        dm, dv = abs(mu0.mean() - mean), abs(mu0.var() / var - 1.0)
        dz = float(np.abs(z.mean(axis=(0, 1)) - pz).max())
        return (dm < 0.12 and dv < 0.3 and dz < 0.06,
                f"mu0 mean {mu0.mean():.4f} (exact {mean:.4f}, |d| {dm:.4f} "
                f"< 0.12), var {mu0.var():.4f} (exact {var:.4f}, "
                f"{dv:.1%} < 30%), max |P(z=1) - exact| {dz:.4f} < 0.06")
    if name == "regression":
        sl, it = s["slope"].mean(), s["intercept"].mean()
        return (abs(sl + 1.2) < 0.3 and abs(it - 2.0) < 0.5,
                f"slope {sl:.4f} (|+1.2| < 0.3), intercept {it:.4f} "
                "(|-2.0| < 0.5)")
    freqs = np.bincount(s["k"].astype(np.int64).ravel(), minlength=3)
    freqs = freqs / freqs.sum()
    post = scalar_exact_posterior()
    d = float(np.abs(freqs - post).max())
    return (d < 0.06, f"P(k) {np.round(freqs, 4).tolist()} against "
            f"enumeration {np.round(post, 4).tolist()}, max |d| {d:.4f} "
            "< 0.06")


def phase_decode(torch, dev, tag):
    """Phase 8a: the cipher-decode example at its own width (292
    characters, K=27, 16 restarts; 300 sweeps of its 600), with its gate (best
    restart > 90% of characters, asserted by ``main``); K5's launches must
    be 3 per sweep. Returns its numbers."""
    from gen_tpu_torch.examples import decode
    from gen_tpu_torch.ops import categorical as cat
    from gen_tpu_torch.ops import nuts_fused as nf
    cat.batched_categorical.launches = 0
    nf.nuts_chains_fused.launches = 0
    torch.cuda.synchronize()
    res = decode.main(DECODE_SWEEPS, DECODE_RESTARTS, 0, dev)
    torch.cuda.synchronize()
    launches = cat.batched_categorical.launches
    print(f"{tag} decode: {DECODE_RESTARTS} restarts x {DECODE_SWEEPS} "
          f"sweeps in {res['seconds']:.2f} s "
          f"({res['seconds'] / DECODE_SWEEPS * 1e3:.2f} ms per sweep), best "
          f"accuracy {res['accuracy']:.2%}, K5 launches {launches}")
    check(launches == 3 * DECODE_SWEEPS,
          f"decode launched K5 {launches} times, not 3 per sweep")
    check(nf.nuts_chains_fused.launches == 0, "decode launched K3")
    return dict(launches=launches, seconds=res["seconds"],
                accuracy=res["accuracy"])


def phase_mixed(torch, tt, dev, tag, models):
    """Phase 8b: sample_posterior on the three mixed models of
    ``MIXED_RUNS``, each with the kernels' launch counts set to 0 just
    before it and read just after; the engine must be the one gen_tpu's
    probe picks, K3 must launch on the fused runs and not on the
    alternating one, and the gates of tests/test_mixed.py must hold.
    Returns per-run numbers."""
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import sample_posterior
    from gen_tpu_torch.ops import categorical as cat
    from gen_tpu_torch.ops import nuts_fused as nf
    out_runs = {}
    for name, chains, kw, engine in MIXED_RUNS:
        model, args, obs = models[name]
        key = random.PRNGKey(0, dev)
        k_init = random.split(key)[0]
        _, gen_s = timed(torch, lambda: torch.func.vmap(
            lambda k: model.generate(k, args, obs))(
            random.split(k_init, chains)))
        nf.nuts_chains_fused.kernel_launches.update(nuts_pair=0, nuts_tick=0)
        cat.batched_categorical.launches = 0
        clock = PhaseClock(torch, [
            ("gen_tpu_torch.inference.chees", "chees_warmup_flat"),
            ("gen_tpu_torch.ops.nuts_fused", "nuts_chains_fused_chunked"),
            ("gen_tpu_torch.inference.mixed", "nuts_flat"),
            ("gen_tpu_torch.inference.mixed", "gibbs_sweep")])
        with clock:
            out, total_s = timed(torch, lambda: sample_posterior(
                key, model, args, obs, num_chains=chains, **kw))
        k3 = nf.nuts_chains_fused.kernel_launches["nuts_pair"]
        c = clock.calls
        sweeps = c["gibbs_sweep"]
        if engine == "gibbs_nuts_fused":
            n_seg = 3                    # the warmup's Gibbs segments
            warm = sum(c["chees_warmup_flat"]) + sum(sweeps[:n_seg])
            kernel_s = sum(c["nuts_chains_fused_chunked"])
        else:
            n_s = kw["num_samples"]
            kernel_s = sum(c["nuts_flat"][-n_s:])
            warm = total_s - gen_s - kernel_s - sum(sweeps[-n_s:])
        sampling = total_s - gen_s - warm
        gibbs_s = sum(sweeps)
        ok, text = mixed_gate(torch, name, out)
        info = out.info
        draws = out.samples[next(iter(out.samples))].shape[0]
        print(f"{tag} sample_posterior({name}, {chains} chains, engine="
              f"{kw['engine']!r}): ran {info['engine']}, {draws} draws per "
              f"chain; {total_s:.2f} s = generate {gen_s:.2f} s + "
              f"warmup {warm:.2f} s + sampling {sampling:.2f} s "
              f"({sampling / draws * 1e3:.1f} ms per draw of all chains); "
              f"{len(sweeps)} Gibbs sweeps {gibbs_s:.2f} s "
              f"({gibbs_s / max(len(sweeps), 1) * 1e3:.2f} ms each, "
              f"{info['discrete_evals_per_sweep']} model updates each), "
              + ("K3 chunks" if engine == "gibbs_nuts_fused" else
                 "NUTS transitions (sampling)")
              + f" {kernel_s:.2f} s; K3 launches {k3}, K5 launches "
              f"{cat.batched_categorical.launches}")
        print(f"{tag}   gate: {text} {'OK' if ok else 'FAIL'}")
        check(info["engine"] == engine,
              f"{name}: ran {info['engine']}, gen_tpu's probe picks {engine}"
              f" ({info.get('engine_reason')})")
        check((k3 > 0) == (engine == "gibbs_nuts_fused"),
              f"{name}: {k3} K3 launches on {engine}")
        check(all(bool(torch.isfinite(v.double()).all())
                  for v in out.samples.values()), f"{name}: bad samples")
        check(ok, f"{name}: outside its gate")
        out_runs[(name, kw["engine"])] = dict(
            seconds=total_s, generate=gen_s, warmup=warm, sampling=sampling,
            draws=draws, gibbs_s=gibbs_s, sweeps=len(sweeps),
            kernel_s=kernel_s, k3_launches=k3)
        del out
    return out_runs


def k5_ops(n, k):
    """Operations of K5 on (n, k) logits (conventions as :func:`k1_ops`):
    per column a quarter of a Philox4x32-10 call (10 rounds of two 32-bit
    products, two high products, four XORs and two key adds: 25), the
    uniform (shift, or, subtract: 3), the clamp, two logs, two negations
    and the add (6), the comparison and select (3); per row log2(G)
    shuffle steps of a comparison, a select and two moves (4 each; G lanes
    a row, ``categorical.launch_shape``) and the clamp."""
    from gen_tpu_torch.ops import categorical as cat
    g = cat.launch_shape(n, k)[0]
    return n * k * (25 + 3 + 6 + 3) + n * (4 * int(math.log2(g)) + 1)


def k5_entry(torch, dev, tag, decode_run, k5_err):
    """Phase 9 for K5: device time per launch (CUDA events, median of 3
    timings of 20 launches) of the kernel (the custom op, given the key as
    the port holds it) and of the whole wrapper ``batched_categorical`` at
    every shape, the launch floor timed the same way, its plain version's
    time, the library call's time (torch.multinomial of torch.softmax: the
    same distribution from other noise), the bound, registers, spills and
    the launch shape. Returns its JSON entry, with decode's shape as the
    headline."""
    from gen_tpu_torch import random
    from gen_tpu_torch.ops import categorical as cat
    rows = {}
    floor = launch_floor_ms(torch, dev, 20, timings=3)
    print(f"{tag} launch floor (an empty kernel through ctypes): "
          f"{floor * 1e3:.2f} us a launch")

    def med(fn):
        fn()
        return float(np.median([gpu_ms(torch, fn, 20) for _ in range(3)]))

    for n, k in K5_SHAPES + (K5_TIMED_ONLY,):
        logits, u = k5_inputs(torch, n, k, dev, n * k)
        logits = torch.nan_to_num(logits)
        key = random.PRNGKey(9, dev)
        g, threads, blocks = cat.launch_shape(n, k)
        fn = ptxas_function(cat.build_job(), f"ILb0ELi{g}E")   # Philox, G
        per_sm, waves = small_waves(blocks, threads, fn["registers"], 0)
        k_ms = med(lambda: cat._categorical_op(logits, key, None, n))
        w_ms = med(lambda: cat.batched_categorical(key, logits))
        plain_ms = med(lambda: cat.batched_categorical_plain(logits, u))
        lib_ms = med(lambda: torch.multinomial(torch.softmax(logits, -1), 1))
        b_ms, b_by = bound_ms(k5_ops(n, k), 4 * n * k + 4 * n)
        rows[(n, k)] = dict(ms=k_ms, wrapper_ms=w_ms, plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                            lanes_a_row=g, blocks=blocks,
                            registers=fn["registers"],
                            spill_bytes=fn["spill_bytes"], waves=waves)
        print(f"{tag} K5 ({n}, {k}): kernel {k_ms * 1e3:.2f} us (wrapper "
              f"{w_ms * 1e3:.2f} us, launch floor {floor * 1e3:.2f} us), "
              f"plain {plain_ms * 1e3:.2f} us, multinomial(softmax) "
              f"{lib_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by}); "
              f"{g} lanes a row, {blocks} blocks of {threads}, "
              f"{fn['registers']} registers, {fn['spill_bytes']} B spills, "
              f"{per_sm} blocks an SM, {waves:.2f} waves")
    head = rows[K5_MAIN_SHAPE]
    return dict(name="categorical", route="cuda",
                source="gen_tpu_torch/ops/csrc/categorical.cu",
                replaces="gen_tpu/ops/categorical.py:46",
                per=f"launch at {K5_MAIN_SHAPE} float32 logits",
                launches=decode_run["launches"], max_abs_err=k5_err,
                **head, floor_ms=floor,
                library="torch.multinomial(torch.softmax(logits, -1), 1)",
                shapes={f"{n}x{k}": v for (n, k), v in rows.items()})


# -- phase 1b: the division rule, exhaustively --------------------------------

# random denominators beside the staged ones and the edges: the run-time
# reciprocals of the staged code divide by values no sweep can list
DIV_RANDOM = 1024
# the sweep: every float32 bit pattern as a numerator of each denominator b,
# through the staged code's _div_rcp with y = _div_y(RN(1 / b)) (the host's
# float32 reciprocal, which staging stages where it is normal; the card's
# own 1.0f / b, which the code computes for a repeated denominator, must
# equal it), against the IEEE quotient a / b; where y is exact (b a power of
# two), also a * y, the rendering's multiply. Per denominator: differing helper
# results, numerators on the helper's fast path, differing multiplies, and
# whether the card's reciprocal differs from the host's.
DIV_SWEEP_SRC = r"""
__global__ void div_sweep_kernel(const float* __restrict__ dens,
                                 const float* __restrict__ rcps,
                                 unsigned long long* __restrict__ out) {
  const int j = (int)blockIdx.y;
  const float b = dens[j], y = rcps[j];
  const bool exact = __fmaf_rn(b, y, -1.0f) == 0.0f;
  unsigned long long bad = 0, fast = 0, bad_mul = 0;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long k = (unsigned long long)blockIdx.x * blockDim.x
       + threadIdx.x; k < (1ull << 32); k += stride) {
    const float a = __uint_as_float((uint32_t)k);
    const uint32_t ref = __float_as_uint(a / b);
    bad += __float_as_uint(_div_rcp(a, b, _div_y(y))) != ref;
    fast += _div_rcp_ok(a, a * _div_y(y));
    bad_mul += exact && __float_as_uint(a * y) != ref;
  }
  for (int o = 16; o; o >>= 1) {
    bad += __shfl_xor_sync(0xffffffffu, bad, o);
    fast += __shfl_xor_sync(0xffffffffu, fast, o);
    bad_mul += __shfl_xor_sync(0xffffffffu, bad_mul, o);
  }
  if ((threadIdx.x & 31u) == 0) {
    atomicAdd(out + 4 * j, bad);
    atomicAdd(out + 4 * j + 1, fast);
    atomicAdd(out + 4 * j + 2, bad_mul);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    out[4 * j + 3] = __float_as_uint(1.0f / b) != __float_as_uint(y);
}

extern "C" int div_sweep_launch(const float* dens, const float* rcps,
                                int n_den, unsigned long long* out,
                                void* stream) {
  const dim3 grid(132 * 8, (unsigned)n_den);
  div_sweep_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      dens, rcps, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def div_sweep_job():
    """The sweep's build job: the staged code's helpers (``_div_rcp`` as
    the kernels inline it) and ``DIV_SWEEP_SRC``."""
    import ctypes
    from gen_tpu_torch.ops import scalarize
    src = ("#include <cuda_runtime.h>\n#include <stdint.h>\n"
           + scalarize._CUDA_HELPERS + DIV_SWEEP_SRC)
    return ("div_sweep", src, {"div_sweep_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]})


def div_denominators(staged_models, rng):
    """The residual denominators that the staged models divide by through
    a staged reciprocal, then edge denominators (powers of two, mantissas
    of all ones, the ends of the normal range, above 2^126 where the
    reciprocal is subnormal, subnormals, negatives) and ``DIV_RANDOM``
    random ones of every exponent: (values, how many are staged)."""
    staged = sorted({float(st.res_consts[k]) for st in staged_models
                     for k in st.rcp_res})
    f32 = np.float32
    big = float(np.finfo(np.float32).max)
    ones = float(np.nextafter(f32(2.0), f32(0.0)))       # 1.11...1 binary
    edges = [1.0, 2.0, 0.5, -4.0, 3.0, 10.0, ones, -ones, 2.0 ** -126,
             1.5 * 2.0 ** -126, ones * 2.0 ** -126, 2.0 ** 125,
             ones * 2.0 ** 125, 2.0 ** 126, 1.5 * 2.0 ** 126, 2.0 ** 127,
             big, -big, 2.0 ** -127, 2.0 ** -149, 1e-40]
    bits = (rng.integers(1, 255, DIV_RANDOM) << 23 | rng.integers(
        0, 1 << 23, DIV_RANDOM) | rng.integers(0, 2, DIV_RANDOM) << 31)
    rand = bits.astype(np.uint32).view(np.float32).astype(float).tolist()
    return staged + edges + rand, len(staged)


def phase_division(torch, ctx, dev):
    """Phase 1b: every float32 numerator of every denominator of
    :func:`div_denominators` through the staged code's ``_div_rcp``
    against IEEE division, bit for bit (``DIV_SWEEP_SRC``)."""
    from gen_tpu_torch.ops import _cuda_build
    dens, n_staged = div_denominators(ctx["staged_all"],
                                      np.random.default_rng(17))
    with np.errstate(all="ignore"):
        rcps = (np.float32(1.0) / np.asarray(dens, np.float32))
    d_t = torch.tensor(dens, dtype=torch.float32, device=dev)
    y_t = torch.from_numpy(rcps).to(dev)
    out = torch.zeros((len(dens), 4), dtype=torch.int64, device=dev)
    lib = _cuda_build.build(*div_sweep_job())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = lib.div_sweep_launch(d_t.data_ptr(), y_t.data_ptr(), len(dens),
                              out.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    _cuda_build.check_launch(rc, "div_sweep")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    res = out.cpu().numpy()
    bad = [(dens[j], int(res[j, 0]), int(res[j, 2]), int(res[j, 3]))
           for j in range(len(dens)) if res[j, 0] or res[j, 2] or res[j, 3]]
    fast = res[:, 1].astype(float) / 2.0 ** 32
    print(f"division rule: {len(dens)} denominators ({n_staged} staged "
          f"residual constants, {len(dens) - n_staged} edge and random) x "
          f"2^32 numerators in {secs:.2f} s ({secs / len(dens) * 1e3:.2f} "
          f"ms a denominator); fast path for {fast.min():.1%}-"
          f"{fast.max():.1%} of the numerators; differing results "
          f"{int(res[:, 0].sum())} (helper), {int(res[:, 2].sum())} "
          f"(multiply by an exact reciprocal), reciprocals differing from "
          f"the host's {int(res[:, 3].sum())}")
    check(not bad, f"division rule: results differ from IEEE division for "
          f"(denominator, helper, multiply, reciprocal) {bad[:8]}")
    return dict(denominators=len(dens), staged=n_staged, seconds=secs)


# -- phase 10: the streamed likelihood (K2c) and the Kalman body (K2b) -----

STREAM_N, STREAM_CHAINS = 10_000, 8192          # bench_stream.py main()
STREAM_N_BIG, STREAM_CHAINS_BIG = 1_000_000, 1024
# the stream layouts' edges: a ragged last tile (2,049 points, 1,000,003),
# chains split over blocks (1 and 3 chains), a tail block (1,027 chains)
STREAM_EDGE_NS = (2049, 1_000_003)
STREAM_EDGE_CHAINS = (1, 3, 1027)
STREAM_CHAINS_AUTO_BIG = 256      # the short sample_posterior call at 10^6
STREAM_WARM_CHAINS = 128          # bench_stream.py:178-196's warmup subset
STREAM_TICKS = 1600
AR1_T, AR1_CHAINS = 100, 131072   # bench_statespace_fused.py
# the Kalman bodies phase 10(a) holds to their plain versions: (name, T,
# chains); "kalman2" is the two-state model of tests/test_hmc_fused.py
KALMAN_CASES = (("ar1", AR1_T, AR1_CHAINS), ("ar1_t1", 1, 8192),
                ("kalman2", 6, 8192))
# operations per chain of the T = 100 AR(1) program as staging unrolled it
# before the scan loops (10,070 instructions): the work K2b's bound
# divides, kept so that its rows stay comparable (the rolled program
# executes more: the backward loop recomputes each step). It holds for the
# rolled program of this shape only: (straight-line instructions, (steps,
# body instructions) of each loop), which k2_ops checks
K2B_WORK = 10070
K2B_SHAPE = (40, [(100, 36), (100, 89)])
ROBUST_ADDRS = ("slope", "intercept", "log_noise")
AR1_ADDRS = ("phi", "log_q", "log_r")


def stream_data(n, seed=0):
    """benchmarks/bench_stream.py::make_data, with numpy."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-2.0, 2.0, n)
    noise = 0.5 * rng.standard_t(4.0, n)
    ys = 0.7 * xs + -0.4 + noise
    return xs.astype(np.float32), ys.astype(np.float32)


def stream_setup(torch, tt, dev, n):
    """bench_stream.py's robust regression: slope, intercept, log_noise and
    a student_t(4) likelihood over n points."""
    xs_np, ys_np = stream_data(n)
    xs = torch.tensor(xs_np, device=dev)

    @tt.gen
    def robust_reg():
        slope = tt.normal(0.0, 2.0) @ "slope"
        intercept = tt.normal(0.0, 2.0) @ "intercept"
        log_noise = tt.normal(0.0, 1.0) @ "log_noise"
        tt.student_t(4.0, slope * xs + intercept,
                     torch.exp(log_noise)) @ "ys"

    obs = tt.choicemap(ys=torch.tensor(ys_np, device=dev))
    return robust_reg, (), obs, tt.select(*ROBUST_ADDRS), xs_np, ys_np


def ar1_data(T=AR1_T, seed=0):
    """benchmarks/bench_statespace_fused.py::make_dataset, with numpy."""
    rng = np.random.default_rng(seed)
    x, ys = 0.0, np.empty((T, 1), np.float32)
    for t in range(T):
        x = (0.8 * x if t else 0.0) + np.sqrt(0.3) * rng.standard_normal()
        ys[t, 0] = x + np.sqrt(0.5) * rng.standard_normal()
    return ys


def ar1_setup(torch, tt, dev, T=AR1_T):
    """bench_statespace_fused.py's collapsed AR(1)+noise model: priors on
    (phi, log_q, log_r), the lgssm(T) Kalman likelihood, P0 = 2."""
    from gen_tpu_torch.models import lgssm
    like = lgssm(T)
    eye1 = torch.eye(1, device=dev)
    z1 = torch.zeros(1, device=dev)

    @tt.gen
    def ar1_model(cap):
        phi = tt.normal(0.0, 1.0) @ "phi"
        log_q = tt.normal(-1.0, 1.0) @ "log_q"
        log_r = tt.normal(-1.0, 1.0) @ "log_r"
        A = phi * eye1
        Q = torch.exp(log_q) * eye1
        R = torch.exp(log_r) * eye1
        like(A, Q, eye1, R, z1, cap * eye1) @ "ys"
        return phi

    ys_np = ar1_data(T)
    obs = tt.choicemap(ys=torch.tensor(ys_np, device=dev))
    return (ar1_model, (torch.tensor(2.0, device=dev),), obs,
            tt.select(*AR1_ADDRS), ys_np)


def kalman2_logp(torch, dev, T=6, seed=0):
    """tests/test_hmc_fused.py's two-state Kalman logp (the port's
    counterpart is tests/torch_port_models.py::torch_kalman_logp): priors
    on (phi, log_q, log_r) and the exact Kalman marginal, float32."""
    from gen_tpu_torch.models import LGSSMParams, kalman_filter
    ys = torch.tensor(np.random.default_rng(seed).standard_normal((T, 1)),
                      dtype=torch.float32, device=dev)
    eye2 = torch.eye(2, device=dev)
    shift = torch.tensor([[0.0, 1.0], [0.0, 0.0]], device=dev)
    c = torch.tensor([[1.0, 0.0]], device=dev)

    def logp(x):
        phi, log_q, log_r = x[0], x[1], x[2]
        params = LGSSMParams(shift + phi * eye2, torch.exp(log_q) * eye2, c,
                             torch.exp(log_r) * torch.eye(1, device=dev),
                             torch.zeros(2, device=dev), eye2)
        return (kalman_filter(params, ys).log_ml
                - 0.5 * (phi ** 2 + log_q ** 2 + log_r ** 2))

    return logp


def k2_setup(torch, tt, dev):
    """Phase 1's part of phase 10: the models, one FlatTarget each, staged
    (timed) and their kernels' build jobs: K1, K3, K6 and the staged-code
    kernel for the stream model at each data size (the layout of K1, K3
    and K6 follows the size), K1, K3 and the staged-code kernel for each
    Kalman model of ``KALMAN_CASES``."""
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import FlatTarget
    from gen_tpu_torch.ops import hmc_fused, staged_eval
    from gen_tpu_torch.ops import nuts_fused as nf

    out, stage_s = {}, {}
    sizes = [("stream", STREAM_N), ("stream_big", STREAM_N_BIG)] + [
        (f"stream_{n}", n) for n in STREAM_EDGE_NS]
    for name, setup in [(name, (lambda n=n: stream_setup(torch, tt, dev, n)))
                        for name, n in sizes] + [
                            ("ar1", lambda: ar1_setup(torch, tt, dev)),
                            ("ar1_t1", lambda: ar1_setup(torch, tt, dev, 1)),
                            ("kalman2", lambda: None)]:
        s = setup()
        if s is None:           # a bare logp where a FlatTarget goes
            target = SimpleNamespace(logp=kalman2_logp(torch, dev))
        else:
            target = FlatTarget(s[0].generate(random.PRNGKey(1, dev), s[1],
                                              s[2])[0], s[3])
        st, secs = timed(torch, lambda: hmc_fused.stage(target.logp, 3,
                                                        dev))
        out[name] = (s, target, st)
        stage_s[name] = secs
    jobs = []
    for name, n in sizes:
        st_s = out[name][2]
        jobs += [(f"K1 robust-t n={n} {st_s.layout}", st_s,
                  hmc_fused.build_job(st_s))]
        jobs += [(f"K{k} robust-t n={n} {nf.stream_layout(st_s, paired)}",
                  st_s, nf.build_job(st_s, 6, paired))
                 for k, paired in ((3, True), (6, False))]
        jobs += [(f"K2c staged stream n={n}", st_s,
                  staged_eval.build_job(st_s))]
    for name, T, _ in KALMAN_CASES:
        st_k = out[name][2]
        label = f"{'AR(1)' if name.startswith('ar1') else 'Kalman D=2'} T={T}"
        jobs += [(f"K1 {label}", st_k, hmc_fused.build_job(st_k)),
                 (f"K3 {label}", st_k, nf.build_job(st_k, 8, True)),
                 (f"K2b staged {label}", st_k, staged_eval.build_job(st_k))]
    for name, secs in stage_s.items():
        st = out[name][2]
        print(f"staging {name}: {secs:.2f} s, {st.n_instructions} "
              f"instructions outside the stream loop, "
              f"{st.n_point_instructions} per point, {len(st.sums)} "
              f"data-sums, {st.n_res} residual constants"
              + (f", stream table {tuple(st.stream_data.shape)}"
                 if st.streams else "")
              + (f", scan loops (steps, body instructions) "
                 f"{st.loop_shape}, {st.executed_instructions} executed, "
                 f"tape {4 * st.tape_floats} B a chain" if st.loops else ""))
    return out, jobs, sum(stage_s.values())


def stream_start(torch, xs, ys, n, dev, seed):
    """Chains near the posterior for the kernel checks: the least-squares
    fit (slope, intercept, log residual sd) in the flat order (intercept,
    log_noise, slope), plus a little noise."""
    A = np.stack([xs, np.ones_like(xs)], 1).astype(np.float64)
    beta = np.linalg.lstsq(A, ys.astype(np.float64), rcond=None)[0]
    ln = np.log(np.std(ys - A @ beta))
    center = torch.tensor([beta[1], ln, beta[0]], dtype=torch.float32,
                          device=dev)
    g = torch.Generator(dev).manual_seed(seed)
    return center + 0.01 * torch.randn(n, 3, device=dev, generator=g)


def compare_staged(torch, st, x, label):
    """The staged-code kernel against the staged program's torch rendering
    in the kernel's layout on the same points: bit for bit."""
    from gen_tpu_torch.ops import staged_eval
    lk, gk = staged_eval.staged_vag(st, x.T.contiguous())
    lp, gp = staged_eval.staged_vag_plain(st, x.T.contiguous())
    torch.cuda.synchronize()
    err = max(float((lk - lp).abs().max()), float((gk - gp).abs().max()))
    same = torch.equal(lk, lp) and torch.equal(gk, gp)
    lay = (f", {staged_eval.layout(st, x.shape[0])}" if st.streams else "")
    print(f"staged code {label}: max |kernel - plain| = {err:.3e} over "
          f"{x.shape[0]} chains{lay} "
          f"({'bit for bit' if same else 'DIFFERENT'})")
    check(same and bool(torch.isfinite(lk).all()),
          f"staged code {label}: kernel and plain version differ")
    return err


def phase_compare_k2(torch, ctx, dev, rng):
    """Phase 10a: the staged code alone, then K1, K3 and K6 with the stream
    loop (n = 10,000 at 8,192 chains, n = 1,000,000 at 1,024, and the
    layouts' edges: n = 2,049 and 1,000,003 at 1, 3 and 1,027 chains) and
    K1 and K3 with the unrolled Kalman body (T = 100, 131,072 chains),
    each against its plain version under injected randomness; the stream
    kernels bit for bit. The staged code alone also at n = 1,000,000 with
    the chain counts phase 10(b) hands it (the ChEES warmup's 128 and the
    short sample_posterior call's 256), whose split counts no other check
    reaches. Returns the largest differences per kernel, and per
    (model, chains) the staged code's under "K2c at"."""
    from gen_tpu_torch.ops import hmc_fused
    from gen_tpu_torch.ops import nuts_fused as nf

    errs = {"K1": [], "K3": [], "K6": [], "K2b": [], "K2c": []}
    at = {}
    key = torch.zeros(2, dtype=torch.int64, device=dev)
    shapes = [("stream", STREAM_CHAINS, 0.004, 4),
              ("stream_big", STREAM_CHAINS_BIG, 0.0004, 2)]
    shapes += [(f"stream_{n_pts}", n, 0.004 if n_pts < 10 ** 5 else 0.0004,
                2) for n_pts in STREAM_EDGE_NS for n in STREAM_EDGE_CHAINS]
    for name, n, eps, steps in shapes:
        (_, _, _, _, xs, ys), target, st = ctx["k2"][name]
        v0 = stream_start(torch, xs, ys, n, dev, 3)
        label = f"robust-t n={len(xs)} ({n} chains)"
        at[name, n] = compare_staged(torch, st, v0, label)
        errs["K2c"].append(at[name, n])
        errs["K1"].append(compare_k1(
            torch, hmc_fused.hmc_chains_fused,
            hmc_fused.hmc_chains_fused_plain, key, target.logp, v0, steps,
            3, eps, None, None, rng, f"{label}, {st.layout}")[2])
        check(errs["K1"][-1] == 0.0, f"K1 {label}: not bit for bit")
        for paired, k in ((True, "K3"), (False, "K6")):
            errs[k].append(compare_nuts(
                torch, nf, target.logp, v0, steps if paired else 2 * steps,
                eps, 6, None, None, 1000.0, 5,
                f"{label}, {nf.stream_layout(st, paired)}", paired)[1])
            check(errs[k][-1] == 0.0, f"{k} {label}: not bit for bit")
    (_, _, _, _, xs, ys), _, st = ctx["k2"]["stream_big"]
    for n in (STREAM_WARM_CHAINS, STREAM_CHAINS_AUTO_BIG):
        at["stream_big", n] = compare_staged(
            torch, st, stream_start(torch, xs, ys, n, dev, 3),
            f"robust-t n={len(xs)} ({n} chains, phase 10(b)'s)")
        errs["K2c"].append(at["stream_big", n])
    for name, T, n in KALMAN_CASES:
        _, target, st = ctx["k2"][name]
        g = torch.Generator(dev).manual_seed(9)
        v0 = (torch.tensor([0.6, -1.2, -0.7], device=dev)
              + 0.2 * torch.randn(n, 3, device=dev, generator=g))
        label = (f"{'AR(1)' if name.startswith('ar1') else 'D=2'} Kalman "
                 f"T={T} ({n} chains)")
        errs["K2b"].append(compare_staged(torch, st, v0, label))
        errs["K1"].append(compare_k1(
            torch, hmc_fused.hmc_chains_fused,
            hmc_fused.hmc_chains_fused_plain, key, target.logp, v0, 3, 2,
            0.05, None, None, rng, label)[2])
        check(errs["K1"][-1] == 0.0, f"K1 {label}: not bit for bit")
        errs["K3"].append(compare_nuts(torch, nf, target.logp, v0, 4, 0.05,
                                       8, 0, None, 1000.0, 6, label,
                                       True)[1])
        check(errs["K3"][-1] == 0.0, f"K3 {label}: not bit for bit")
    return dict({k: max(v) for k, v in errs.items()}, **{"K2c at": at})


def posterior_gate(torch, samples, summary, exact, tols, label):
    """Each coordinate's mean within ``tols[0]`` sd and sd within
    ``tols[1]`` of ``exact`` (name -> (mean, sd)) over all draws and
    chains, split-R-hat from ``summary`` below ``tols[2]``; prints the
    absolute errors too."""
    worst = [0.0, 0.0, 0.0]
    for name, (m_ex, s_ex) in exact.items():
        arr = samples[name].double().reshape(-1)
        m, s = float(arr.mean()), float(arr.std(correction=0))
        rh = float(torch.as_tensor(summary[name]["rhat"]).max())
        dm, ds = abs(m - m_ex) / s_ex, abs(s / s_ex - 1.0)
        worst = [max(worst[0], dm), max(worst[1], ds), max(worst[2], rh)]
        print(f"  {name:<10} mean {m:+.6f} (exact {m_ex:+.6f}, |d| "
              f"{abs(m - m_ex):.3e} = {dm:.4f} sd)  sd {s:.6f} (exact "
              f"{s_ex:.6f}, {s / s_ex - 1.0:+.2%})  split-R-hat {rh:.4f}")
    ok = worst[0] < tols[0] and worst[1] < tols[1] and worst[2] < tols[2]
    print(f"  gates (mean {tols[0]} sd, sd {tols[1]:.0%}, split-R-hat "
          f"{tols[2]}): worst {worst[0]:.4f} sd, {worst[1]:.4f}, "
          f"{worst[2]:.4f} {'OK' if ok else 'FAIL'}")
    check(ok, f"{label} outside its gates")


def launch_counts(nf, hmc):
    from gen_tpu_torch.ops import scalarize, staged_eval
    return dict(hmc_fused=hmc.launches, **nf.nuts_chains_fused.kernel_launches,
                staged_eval=staged_eval.staged_vag.launches,
                **{f"body_{k}": v for k, v in scalarize.body_launches.items()})


def reset_counts(nf, hmc):
    from gen_tpu_torch.ops import scalarize, staged_eval
    hmc.launches = nf.nuts_chains_fused.launches = 0
    nf.nuts_chains_fused.kernel_launches.update(nuts_pair=0, nuts_tick=0)
    staged_eval.staged_vag.launches = 0
    scalarize.body_launches.update(stream=0, structured=0, scan=0)


def phase_stream(torch, tt, dev, tag, ctx):
    """Phase 10b: the robust-t regression. (a) n = 10,000 at 8,192 chains
    through ``sample_posterior(engine="auto")``, which must dispatch
    ``nuts_fused`` with a stream; gates 0.05 sd, 6%, split-R-hat < 1.02
    against the 3-D quadrature. (b) n = 1,000,000 at 1,024 chains: ChEES on
    128 chains (the staged kernel evaluates the logp), tiled to 1,024, then
    K3; the house gate, 0.05 sd and 6% (gen_tpu needed a 0.3 sd, 12% floor
    for this row in float32; the per-lane Kahan sums meet the house gate),
    split-R-hat < 1.02. (c) n = 10^6 through
    ``sample_posterior(engine="auto")`` at 256 chains, 20 + 20 iterations:
    the dispatch and the 8-warp variant under the entry point, gated on the
    launches and finite draws. Returns launches and times per path."""
    from gen_tpu_torch import random
    from gen_tpu_torch._verify import robust_t_quadrature
    from gen_tpu_torch.diagnostics import rhat
    from gen_tpu_torch.inference import sample_posterior
    from gen_tpu_torch.inference.chees import chees_warmup_flat
    from gen_tpu_torch.ops import hmc_fused, staged_eval
    from gen_tpu_torch.ops import nuts_fused as nf

    res = {}
    (model, args, obs, sel, xs, ys), _, _ = ctx["k2"]["stream"]
    exact, q_s = timed(torch, lambda: robust_t_quadrature(xs, ys,
                                                          device=dev))
    print(f"robust-t n={STREAM_N}: quadrature {q_s:.2f} s: "
          + ", ".join(f"{k} {m:+.5f} +- {s:.5f}"
                      for k, (m, s) in exact.items()))
    reset_counts(nf, hmc_fused.hmc_chains_fused)
    out, total_s = timed(torch, lambda: sample_posterior(
        random.PRNGKey(21, dev), model, args, obs,
        num_chains=STREAM_CHAINS, engine="auto", num_warmup=200,
        num_samples=200, num_ticks=STREAM_TICKS, max_depth=6))
    launches = launch_counts(nf, hmc_fused.hmc_chains_fused)
    info = out.info
    print(f"{tag} robust-t n={STREAM_N}, {STREAM_CHAINS} chains: "
          f"sample_posterior(auto) ran {info['engine']} "
          f"({info.get('engine_reason')}); "
          f"{out.samples['slope'].shape[0]} draws per chain in "
          f"{total_s:.2f} s; launches {launches}")
    check(info["engine"] == "nuts_fused" and "streams" in
          info.get("engine_reason", ""), "auto did not dispatch the stream")
    check(launches["nuts_pair"] >= 1 and launches["body_stream"] >= 1,
          "the stream path did not launch K3 with the stream loop")
    posterior_gate(torch, out.samples, out.summary, exact,
                   (0.05, 0.06, 1.02), f"robust-t n={STREAM_N}")
    res["a"] = dict(launches=launches["body_stream"],
                    staged_launches=launches["staged_eval"], total_s=total_s)
    del out

    # (b) one million points
    (model, args, obs, sel, xs, ys), target, st = ctx["k2"]["stream_big"]
    exact, q_s = timed(torch, lambda: robust_t_quadrature(xs, ys,
                                                          device=dev))
    print(f"robust-t n={STREAM_N_BIG}: quadrature {q_s:.2f} s: "
          + ", ".join(f"{k} {m:+.6f} +- {s:.6f}"
                      for k, (m, s) in exact.items()))
    paths, offsets = flat_layout(tt, target._trace, sel)
    reset_counts(nf, hmc_fused.hmc_chains_fused)
    k_init, k_warm, k_run, k_gate = random.split(random.PRNGKey(22, dev), 4)
    t0 = time.perf_counter()
    xs0 = init_values(torch, model, args, obs, sel,
                      random.split(k_init, STREAM_WARM_CHAINS))

    def batched(x):
        lp, g = staged_eval.staged_vag(st, x.T)
        return lp, g.T

    (_, warm, winfo), warm_s = timed(torch, lambda: chees_warmup_flat(
        k_warm, target.value_and_grad, xs0, num_warmup=250, num_samples=1,
        batched_vag=batched))
    reps = -(-STREAM_CHAINS_BIG // STREAM_WARM_CHAINS)
    warm = warm.repeat(reps, 1)[:STREAM_CHAINS_BIG].contiguous()
    eps = float(winfo["step_size"])
    kw = dict(eps=eps, max_depth=6, inv_mass_diag=winfo["inv_mass"],
              collect_idx=None, paired=True)
    (values, _, _, _, _), burn_s = timed(torch, lambda: (
        nf.nuts_chains_fused_chunked(k_run, target.logp, warm,
                                     num_ticks=STREAM_TICKS, **kw)))
    (values, hist, hcnt, cnt, stats), run_s = timed(torch, lambda: (
        nf.nuts_chains_fused_chunked(k_gate, target.logp, values,
                                     num_ticks=STREAM_TICKS, **kw)))
    total_s = time.perf_counter() - t0
    launches = launch_counts(nf, hmc_fused.hmc_chains_fused)
    m = int(cnt.min())
    print(f"{tag} robust-t n={STREAM_N_BIG}, {STREAM_CHAINS_BIG} chains: "
          f"ChEES on {STREAM_WARM_CHAINS} chains {warm_s:.2f} s (eps "
          f"{eps:.3e}), K3 burn {burn_s:.2f} s and {STREAM_TICKS} slots "
          f"{run_s:.2f} s ({run_s / STREAM_TICKS * 1e3:.3f} ms per slot), "
          f"mean depth {float(stats['mean_depth'].mean()):.2f}, accept "
          f"{float(stats['mean_accept'].mean()):.3f}, slowest chain {m} "
          f"draws; total {total_s:.2f} s; launches {launches}")
    check(m >= 8 and launches["body_stream"] >= 1,
          "the n=1M stream path did not run")
    draws = nf.extract_completed_draws(hist, hcnt, m)[m // 4:]
    samples, summary = {}, {}
    for p, lo in zip(paths, offsets[:-1]):
        col = draws[:, :, lo].contiguous()
        samples[p[0]] = col
        summary[p[0]] = {"rhat": rhat(col)}
    posterior_gate(torch, samples, summary, exact, (0.05, 0.06, 1.02),
                   f"robust-t n={STREAM_N_BIG}")
    res["b"] = dict(launches=launches["body_stream"],
                    staged_launches=launches["staged_eval"], total_s=total_s,
                    slot_ms=run_s / STREAM_TICKS * 1e3)

    # (c) the same data through the entry point, briefly: the dispatch and
    # the 8-warp variant under sample_posterior
    reset_counts(nf, hmc_fused.hmc_chains_fused)
    out, total_s = timed(torch, lambda: sample_posterior(
        random.PRNGKey(23, dev), model, args, obs,
        num_chains=STREAM_CHAINS_AUTO_BIG, engine="auto", num_warmup=20,
        num_samples=20, num_ticks=320, max_depth=6))
    launches = launch_counts(nf, hmc_fused.hmc_chains_fused)
    info = out.info
    n_draws = out.samples["slope"].shape[0]
    print(f"{tag} robust-t n={STREAM_N_BIG}, {STREAM_CHAINS_AUTO_BIG} "
          f"chains: sample_posterior(auto) ran {info['engine']} "
          f"({info.get('engine_reason')}); {n_draws} draws per chain in "
          f"{total_s:.2f} s; launches {launches}")
    check(info["engine"] == "nuts_fused" and "streams" in
          info.get("engine_reason", ""), "auto did not dispatch the stream")
    check(launches["nuts_pair"] >= 1 and launches["body_stream"] >= 1
          and launches["staged_eval"] >= 1,
          "the n=1M entry point did not launch the stream kernels")
    check(n_draws >= 2 and all(bool(torch.isfinite(v).all())
                               for v in out.samples.values()),
          "the n=1M entry point returned no finite draws")
    res["c"] = dict(launches=launches["body_stream"],
                    staged_launches=launches["staged_eval"], total_s=total_s)
    return res


def phase_ar1(torch, tt, dev, tag, ctx):
    """Phase 10c: the collapsed AR(1)+noise model (T = 100) at 131,072
    chains through ``sample_posterior`` with ``engine="hmc_fused"`` (K1)
    and ``engine="auto"`` (K3); gates 0.05 sd, 6% of the 3-D quadrature
    (121 points per axis), split-R-hat < 1.01 from the returned summary."""
    from gen_tpu_torch import random
    from gen_tpu_torch._verify import ar1_quadrature
    from gen_tpu_torch.inference import sample_posterior
    from gen_tpu_torch.ops import hmc_fused
    from gen_tpu_torch.ops import nuts_fused as nf

    (model, args, obs, sel, ys), _, _ = ctx["k2"]["ar1"]
    exact, q_s = timed(torch, lambda: ar1_quadrature(ys, device=dev))
    print(f"AR(1) T={AR1_T}: quadrature {q_s:.2f} s: "
          + ", ".join(f"{k} {m:+.4f} +- {s:.4f}"
                      for k, (m, s) in exact.items()))
    res = {}
    for engine, kw, kernel in (
            ("hmc_fused", dict(num_warmup=400, num_samples=4000),
             "hmc_fused"),
            ("auto", dict(num_warmup=400, num_samples=500), "nuts_pair")):
        reset_counts(nf, hmc_fused.hmc_chains_fused)
        clock = PhaseClock(torch, [
            ("gen_tpu_torch.inference.chees", "chees_warmup_flat"),
            ("gen_tpu_torch.ops.hmc_fused", "stage")])
        with clock:
            out, total_s = timed(torch, lambda: sample_posterior(
                random.PRNGKey(31, dev), model, args, obs,
                num_chains=AR1_CHAINS, engine=engine, **kw))
        launches = launch_counts(nf, hmc_fused.hmc_chains_fused)
        info = out.info
        warm = sum(clock.calls["chees_warmup_flat"])
        stage_s = sum(clock.calls["stage"])
        print(f"{tag} AR(1) T={AR1_T}, {AR1_CHAINS} chains: "
              f"sample_posterior({engine!r}) ran {info['engine']}, "
              f"{out.samples['phi'].shape[0]} draws per chain, "
              f"{total_s:.2f} s (ChEES {warm:.2f} s, staging "
              f"{stage_s:.2f} s); launches {launches}")
        check(launches[kernel] >= 1 and launches["body_scan"] >= 1,
              f"AR(1) {engine}: {kernel} with the Kalman body not launched")
        posterior_gate(torch, out.samples, out.summary, exact,
                       (0.05, 0.06, 1.01), f"AR(1) {engine}")
        res[engine] = dict(launches=launches["body_scan"],
                           staged_launches=launches["staged_eval"],
                           k1_launches=launches["hmc_fused"],
                           total_s=total_s)
        del out
    return res


def k2_ops(st, n_chains):
    """Operations of one evaluation of the staged code for ``n_chains``
    chains (conventions as :func:`k1_ops`): the straight-line part, and per
    data point the loop body plus 4 per Kahan-compensated sum. The T = 100
    Kalman program counts ``K2B_WORK``, as it did unrolled, and must have
    the shape ``K2B_SHAPE`` that this count was kept for."""
    if st.loops:
        shape = (len(st.prog.instrs), st.loop_shape)
        check(shape == K2B_SHAPE, f"the Kalman program's shape {shape} is "
              f"not K2B_SHAPE {K2B_SHAPE}: recount K2B_WORK for it")
        return K2B_WORK * n_chains
    per_chain = st.n_instructions + st.n_pts * (st.n_point_instructions
                                                + 4 * len(st.sums))
    return per_chain * n_chains


def ptxas_numbers(job):
    """``(registers, spill bytes, stack frame bytes)`` of the library built
    from the build job ``job``: the most registers and stack of its
    functions, spill stores and loads summed, from the ptxas report saved
    beside it; each None where there is no report."""
    from gen_tpu_torch.ops import _cuda_build
    fns = ptxas_functions(_cuda_build.ptxas_report(job[0], job[1]) or "")
    if not fns:
        return None, None, None
    return (max(f["registers"] for f in fns.values()),
            sum(f["spill_bytes"] for f in fns.values()),
            max(f["stack_bytes"] for f in fns.values()))


def k2_entry(torch, dev, st, n_chains, x, runs, err, label, kind):
    """The kernels-line entry of K2b or K2c: the staged-code kernel's time
    per gradient (CUDA events), its plain version's (the torch rendering),
    and the bound: the stream table read once, the chains' state read and
    the value and gradient written once, or the operations. ``launches``
    counts the code's launches on the main paths ``runs``: the K1, K3 and
    K6 launches that embedded it and the staged-code kernel's (the ChEES
    warmup evaluates the population through it)."""
    from gen_tpu_torch.ops import staged_eval
    xt = x.T.contiguous()
    staged_eval.staged_vag(st, xt)
    ms = gpu_ms(torch, lambda: staged_eval.staged_vag(st, xt), 5)
    _, plain_s = timed(torch, lambda: staged_eval.staged_vag_plain(st, xt))
    nbytes = 4 * (n_chains * (2 * st.d + 1) + st.n_res
                  + (st.stream_data.numel() if st.streams else 0))
    b_ms, b_by = bound_ms(k2_ops(st, n_chains), nbytes)
    extra = {}
    if st.loops:
        regs, spill, stack = ptxas_numbers(staged_eval.build_job(st))
        extra = dict(registers=regs, spill_bytes=spill, stack_bytes=stack,
                     tape_bytes=4 * st.tape_floats,
                     staged_instructions=st.n_instructions,
                     loop_shape=st.loop_shape,
                     executed_ops=st.executed_instructions * n_chains)
    print(f"{label}: {ms:.4f} ms per gradient of {n_chains} chains "
          f"(plain {plain_s * 1e3:.2f} ms, bound {b_ms:.4f} ms by {b_by}, "
          f"{k2_ops(st, n_chains):.4e} operations)"
          + (f"; {extra['registers']} registers, {extra['spill_bytes']} "
             f"spill bytes, {extra['stack_bytes']} B stack frame (the tape: "
             f"{extra['tape_bytes']} B a chain), {st.n_instructions} staged "
             f"instructions, loops {st.loop_shape}, "
             f"{extra['executed_ops']:.4e} operations executed"
             if extra else ""))
    return dict(**extra,
        name=kind, route="cuda",
        source="gen_tpu_torch/ops/scalarize.py",
        replaces=("gen_tpu/ops/scalarize.py:582" if kind.startswith("k2c")
                  else "gen_tpu/ops/scalarize.py:957"),
        per=f"gradient of {n_chains} chains ({label})",
        launches=sum(r["launches"] + r["staged_launches"] for r in runs),
        launches_in_fused=sum(r["launches"] for r in runs),
        max_abs_err=err, ms=ms,
        plain_ms=plain_s * 1e3, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)


def k2_entries(torch, dev, ctx, k2_err, stream_res, ar1_res):
    """Phase 10d: K2c at n = 10,000 (8,192 chains) and 1,000,000 (1,024
    chains; and 128, the ChEES warmup's shape, whose launches are the
    staged-code kernel's), K2b at T = 100 (131,072 chains); launches are
    the K1/K3/K6 launches whose body held that code on the phase's main
    paths and the staged-code kernel's."""
    out = []
    for name, n, run, kind in (
            ("stream", STREAM_CHAINS, [stream_res["a"]], "k2c_stream_1e4"),
            ("stream_big", STREAM_CHAINS_BIG,
             [stream_res["b"], stream_res["c"]], "k2c_stream_1e6"),
            ("stream_big", STREAM_WARM_CHAINS,
             [dict(r, launches=0) for r in (stream_res["b"],
                                            stream_res["c"])],
             "k2c_stream_1e6_chees")):
        (_, _, _, _, xs, ys), _, st = ctx["k2"][name]
        x = stream_start(torch, xs, ys, n, dev, 4)
        out.append(k2_entry(torch, dev, st, n, x, run,
                            k2_err["K2c at"][name, n],
                            f"robust-t n={len(xs)}", kind))
    _, _, st = ctx["k2"]["ar1"]
    x = torch.tensor([0.6, -1.2, -0.7], device=dev).expand(AR1_CHAINS, 3)
    out.append(k2_entry(torch, dev, st, AR1_CHAINS, x,
                        list(ar1_res.values()), k2_err["K2b"],
                        f"AR(1) Kalman T={AR1_T}", "k2b_kalman"))
    return out


def phase_build(torch, tt, dev, tag):
    """Phase 1 after the environment: the models, their staging and the
    parallel build of every kernel variant. Returns the models and staged
    programs the later phases use."""
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import FlatTarget
    from gen_tpu_torch.ops import _cuda_build, categorical, hmc_fused, resample
    from gen_tpu_torch.ops import launch_floor
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

    # the warp-per-chain layout's edges: d=33 (lane 8 owns one coordinate)
    # with a coupling across lanes, d=40 (a frozen coordinate in phase 2)
    wsds = {d_: torch.tensor(np.random.default_rng(d_).uniform(
        0.5, 2.0, d_).astype(np.float32), device=dev) for d_ in WARP_DS}

    def wide_logp(d_):
        def logp(x):
            return (-0.5 * torch.sum((x / wsds[d_]) ** 2)
                    - 0.3 * x[0] * x[d_ - 1])
        return logp
    wide_logps = {d_: wide_logp(d_) for d_ in WARP_DS}
    # the one-thread layouts' top: d=32, whose couplings span it
    g32_sds = torch.tensor(np.random.default_rng(32).uniform(
        0.5, 2.0, 32).astype(np.float32), device=dev)

    def gauss32_logp(x):
        return (-0.5 * torch.sum((x / g32_sds) ** 2) - 0.3 * x[0] * x[31]
                - 0.1 * x[1] * x[2])

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
    st_w = {d_: hmc_fused.stage(wide_logps[d_], d_, dev) for d_ in WARP_DS}
    st_g32 = hmc_fused.stage(gauss32_logp, 32, dev)
    mixed = mixed_setup(torch, tt, dev)
    t_stage = time.perf_counter()
    mixed_builds = mixed_jobs(torch, tt, dev, mixed)
    stage_s += time.perf_counter() - t_stage
    k2, k2_builds, k2_stage_s = k2_setup(torch, tt, dev)
    stage_s += k2_stage_s
    builds = [("K1 regression", st_reg, hmc_fused.build_job(st_reg)),
              ("K1 gaussian", st_g3, hmc_fused.build_job(st_g3)),
              ("K4 resample (float32, float64)", None, resample.build_job()),
              ("K5 categorical", None, categorical.build_job()),
              ("launch floor (empty kernel)", None,
               launch_floor.build_job())]
    builds += mixed_builds + k2_builds
    for paired, k in ((True, "K3"), (False, "K6")):
        builds += [
            (f"{k} eight_schools d=10", st_10, nf.build_job(st_10, 8, paired)),
            (f"{k} schools d=102", st_102, nf.build_job(st_102, 8, paired)),
            (f"{k} gaussian d=4", st_g4, nf.build_job(st_g4, 5, paired)),
            (f"{k} gaussian d=32", st_g32, nf.build_job(st_g32, 6, paired))]
        builds += [(f"{k} gaussian d={d_}", st_w[d_],
                    nf.build_job(st_w[d_], 6, paired)) for d_ in WARP_DS]
    staged_all = list({id(st): st for _, st, _ in builds
                       if st is not None}.values())
    builds.append(("division sweep", None, div_sweep_job()))
    _, build_s = timed(torch, lambda: _cuda_build.build_all(
        [job for _, _, job in builds]))
    by_hash = {h: secs for h, secs, _ in _cuda_build.BUILD_LOG}
    for name, st, (kind, src, _) in builds:
        secs = by_hash.get(_cuda_build.source_hash(src), float("nan"))
        report = _cuda_build.ptxas_report(kind, src) or ""
        regs = [ln.strip() for ln in report.splitlines()
                if "registers" in ln or "spill" in ln or "stack" in ln]
        staged = ("" if st is None else f"{st.n_instructions} staged "
                  f"instructions, {st.n_res} residual constants; ")
        if name[:2] in ("K3", "K6") and nf.kernel_layout(st) == "warp":
            split = st.warp_split()
            staged += (f"warp per chain, split program: at most "
                       f"{split.max_lane_instructions} instructions per "
                       f"lane, {bin(split.hubs).count('1')} hubs, "
                       f"{len(split.classes)} classes; ")
        print(f"{name}: {staged}nvcc {secs:.2f} s; " + " | ".join(regs))
    print(f"{tag} staging {stage_s:.3f} s, parallel nvcc build of "
          f"{len(builds)} sources {build_s:.2f} s")
    # K3 and K6 on metric 2's model (eight_schools d=10, 131,072 chains)
    census = {}
    for paired, k in ((True, "K3"), (False, "K6")):
        census[k] = nuts_census(nf.build_job(st_10, 8, paired), 131072)
        for which, c in census[k].items():
            print(f"{tag} {k} eight_schools d=10 ({nf.kernel_layout(st_10)} "
                  f"layout, collect {which}): {census_line(c)}")
    return dict(k1=(model, X, obs, sel, xs, ys, target, gauss_logp, sds),
                s8=s8, s100=s100, school_targets=school_targets,
                gauss4_logp=gauss4_logp, gsds=gsds, st_10=st_10,
                gauss32_logp=gauss32_logp, g32_sds=g32_sds, census=census,
                wide_logps=wide_logps, wsds=wsds,
                st_102=st_102, stage_s=stage_s, build_s=build_s,
                mixed=mixed, k2=k2, staged_all=staged_all)


def phase_compare(torch, ctx, dev, paired):
    """Phase 2: K3 (``paired``) or K6 against its plain version on the nine
    injected configurations, at the same leapfrog slots (a K3 pair is two
    K6 ticks), bit for bit. Returns the largest difference."""
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
    # the one-thread layouts' top, d=32 (a ragged last block), both ways of
    # collecting
    g32 = torch.randn(5000, 32, device=dev) * ctx["g32_sds"]
    for cidx, seed in ((None, 32), (31, 33)):
        errs.append(compare_nuts(
            torch, nf, ctx["gauss32_logp"], g32, 30 * per, 0.4, 6, cidx,
            ctx["g32_sds"] ** 2, 1000.0, seed,
            f"gaussian d=32 collect={'all' if cidx is None else cidx}",
            paired)[1])
    # the warp-per-chain layout: d=33 with a coupling across lanes, d=40
    # with coordinate 7 frozen (a ragged last block of chains in both)
    for d_ in WARP_DS:
        logp_w, sd_w = ctx["wide_logps"][d_], ctx["wsds"][d_]
        xw = torch.randn(8000, d_, device=dev) * sd_w
        inv_w = sd_w ** 2
        if d_ == 40:
            inv_w = inv_w * (torch.arange(d_, device=dev) != 7).float()
        (vk, hk, _, _, _), err = compare_nuts(
            torch, nf, logp_w, xw, 30 * per, 0.5, 6, None if d_ == 40 else 32,
            inv_w, 1000.0, 20 + d_, f"gaussian d={d_} (warp per chain)",
            paired)
        errs.append(err)
        if d_ == 40:
            check(torch.equal(vk[:, 7], xw[:, 7])
                  and torch.equal(hk[:, :, 7], xw[:, 7].expand(30 * per, -1)),
                  f"{k}: frozen coordinate moved (d=40)")
            print(f"{k} d=40 frozen coordinate: unchanged in every chain and "
                  "step")
    return max(errs)


# -- phase 11: the rest of SMC (tempered samplers on K4, PSIS, Particle
#    Gibbs, Switch) ------------------------------------------------------

TEMPER_N = 131072                 # particles of parts (a)-(c)
TEMPER_OBS, TEMPER_SD0, TEMPER_SD = 20, 3.0, 1.0   # tests/test_tempering.py
TEMPER_RUNGS = 20
TEMPER_SEEDS = 3
PT_BETAS = (0.02, 0.06, 0.15, 0.35, 0.65, 1.0)
PT_SWEEPS, PT_BURN = 1000, 250   # 3,000 and 500 before: the time limit
PG_N, PG_T, PG_PHI = 4096, 40, 0.8   # benchmarks/workloads.py:469's width
PG_SWEEPS, PG_BURN = 60, 10
PG_Q, PG_R = 0.5, 0.4             # examples/particle_gibbs.py's noise sds
SWITCH_N = 131072
SWITCH_RTOL = 1e-5


def temper_data():
    """tests/test_tempering.py's observations, exact log evidence and
    exact posterior (mean, sd) of the conjugate Gaussian model."""
    ys = np.random.default_rng(1).normal(2.0, TEMPER_SD, TEMPER_OBS)
    cov = (TEMPER_SD0 ** 2 * np.ones((TEMPER_OBS, TEMPER_OBS))
           + TEMPER_SD ** 2 * np.eye(TEMPER_OBS))
    chol = np.linalg.cholesky(cov)
    z = np.linalg.solve(chol, ys)
    lml = float(-0.5 * (z @ z + TEMPER_OBS * np.log(2 * np.pi))
                - np.sum(np.log(np.diag(chol))))
    prec = 1 / TEMPER_SD0 ** 2 + TEMPER_OBS / TEMPER_SD ** 2
    return ys, lml, (np.sum(ys) / TEMPER_SD ** 2) / prec, 1 / np.sqrt(prec)


def temper_setup(torch, tt, dev):
    """The conjugate model's template trace (observations constrained) and
    the bimodal model's (y = 4), with their latent selections."""
    from gen_tpu_torch import random
    ys = temper_data()[0]
    ones = torch.ones(TEMPER_OBS, device=dev)

    @tt.gen
    def gauss_model():
        mu = tt.normal(0.0, TEMPER_SD0) @ "mu"
        tt.normal(mu * ones, TEMPER_SD) @ "ys"

    @tt.gen
    def bimodal_model():
        x = tt.normal(0.0, 3.0) @ "x"
        tt.normal(x * x, 0.5) @ "y"

    key = random.PRNGKey(0, dev)
    gauss, _ = gauss_model.generate(key, (), tt.choicemap(
        ys=torch.tensor(ys, dtype=torch.float32, device=dev)))
    bimodal, _ = bimodal_model.generate(key, (), tt.choicemap(
        y=torch.tensor(4.0, device=dev)))
    return gauss, tt.select("mu"), bimodal, tt.select("x")


def posterior_moments(torch, x, log_w=None):
    """(mean, sd) of particle positions, weighted by ``log_w``."""
    x = x.double().reshape(-1)
    w = (torch.softmax(log_w.double(), dim=0) if log_w is not None
         else torch.full_like(x, 1.0 / x.shape[0]))
    m = (w * x).sum()
    return float(m), float(((w * (x - m) ** 2).sum()).sqrt())


def phase_tempering(torch, tt, dev, tag):
    """Phase 11 (a)-(d): smc_sampler, smc_sampler_adaptive and ais on the
    conjugate model at 131,072 particles against the exact evidence and
    posterior, PSIS of the AIS weights on the card against the CPU, and
    parallel_tempering on the bimodal model. K4's launches are set to 0
    before (a) and (b) and read after. Returns the launches by path."""
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import (ais, parallel_tempering,
                                         psis_effective_sample_size,
                                         smc_sampler, smc_sampler_adaptive)
    from gen_tpu_torch.inference.psis import psis
    from gen_tpu_torch.ops import resample as rs
    _, lml_ex, mean_ex, sd_ex = temper_data()
    gauss, sel, bimodal, bsel = temper_setup(torch, tt, dev)
    betas = torch.linspace(0.0, 1.0, TEMPER_RUNGS + 1, device=dev)[1:]
    launches = {}
    print(f"phase 11: conjugate model, {TEMPER_OBS} observations: exact "
          f"log-ML {lml_ex:.4f}, posterior mean {mean_ex:.4f} sd "
          f"{sd_ex:.4f}")

    # (a) tempered SMC, three seeds
    rs.systematic_resample.launches = 0
    runs, secs = timed(torch, lambda: [smc_sampler(
        random.PRNGKey(3 + s, dev), gauss, sel, betas, TEMPER_N, L=5,
        eps=0.1, moves_per_rung=2) for s in range(TEMPER_SEEDS)])
    launches["smc_sampler"] = rs.systematic_resample.launches
    lmls = [float(r[2]) for r in runs]
    d_lml = float(np.mean(lmls)) - lml_ex
    moms = [posterior_moments(torch, r[0], r[1]) for r in runs]
    d_m = max(abs(m - mean_ex) for m, _ in moms)
    d_s = max(abs(s - sd_ex) for _, s in moms)
    print(f"{tag} 11a smc_sampler N={TEMPER_N}, {TEMPER_RUNGS} rungs, L=5, "
          f"2 moves a rung, systematic, {TEMPER_SEEDS} seeds: {secs:.2f} s; "
          f"log-ML {', '.join(f'{v:.4f}' for v in lmls)} (mean - exact "
          f"{d_lml:+.4f}, gate 0.1); weighted posterior mean err {d_m:.4f}, "
          f"sd err {d_s:.4f} (gate 0.05); K4 launches "
          f"{launches['smc_sampler']}")
    check(abs(d_lml) < 0.1 and d_m < 0.05 and d_s < 0.05,
          "smc_sampler outside the exact-evidence gates")
    check(launches["smc_sampler"] > 0, "smc_sampler launched no K4")
    check(all(r[0].shape == (TEMPER_N, 1) and bool(torch.isfinite(
        r[0]).all()) for r in runs), "smc_sampler: bad particles")
    del runs

    # (b) the ESS-adaptive ladder: one resampling (one K4 launch) a stage
    rs.systematic_resample.launches = 0
    (flats, lml, n_stages, hist), secs = timed(
        torch, lambda: smc_sampler_adaptive(
            random.PRNGKey(9, dev), gauss, sel, TEMPER_N, target_ess=0.6,
            L=5, eps=0.1, moves_per_rung=2))
    launches["smc_sampler_adaptive"] = rs.systematic_resample.launches
    m, s = posterior_moments(torch, flats)
    ladder = hist[:n_stages].tolist()
    print(f"{tag} 11b smc_sampler_adaptive N={TEMPER_N}, target ESS 0.6: "
          f"{secs:.2f} s, {n_stages} stages (betas "
          f"{', '.join(f'{b:.4f}' for b in ladder)}); log-ML "
          f"{float(lml):.4f} (diff {float(lml) - lml_ex:+.4f}, gate 0.15); "
          f"posterior mean err {abs(m - mean_ex):.4f}, sd err "
          f"{abs(s - sd_ex):.4f} (gate 0.05); K4 launches "
          f"{launches['smc_sampler_adaptive']}")
    check(abs(float(lml) - lml_ex) < 0.15 and abs(m - mean_ex) < 0.05
          and abs(s - sd_ex) < 0.05, "smc_sampler_adaptive outside gates")
    check(1 <= n_stages < 64 and ladder[-1] == 1.0
          and all(b1 > b0 for b0, b1 in zip(ladder, ladder[1:])),
          "smc_sampler_adaptive: bad ladder")
    check(launches["smc_sampler_adaptive"] == n_stages,
          f"smc_sampler_adaptive: {launches['smc_sampler_adaptive']} K4 "
          f"launches for {n_stages} stages")
    del flats

    # (c) AIS, three seeds; PSIS of the first run's weights, card vs CPU
    runs, secs = timed(torch, lambda: [ais(
        random.PRNGKey(s, dev), gauss, sel, betas, TEMPER_N, L=5, eps=0.1)
        for s in range(TEMPER_SEEDS)])
    lmls = [float(r[2]) for r in runs]
    d_lml = float(np.mean(lmls)) - lml_ex
    lw = runs[0][1]
    (res, psis_s) = timed(torch, lambda: psis(lw))
    res_cpu = psis(lw.cpu())
    err_w = float(((res.log_weights.cpu() - res_cpu.log_weights).abs()
                   / res_cpu.log_weights.abs().clamp_min(1e-30)).max())
    err_k = abs(float(res.khat) - float(res_cpu.khat)) / max(
        abs(float(res_cpu.khat)), 1e-30)
    ess = float(psis_effective_sample_size(res.log_weights))
    print(f"{tag} 11c ais N={TEMPER_N}, {TEMPER_RUNGS} rungs, L=5, "
          f"{TEMPER_SEEDS} seeds: {secs:.2f} s; log-ML "
          f"{', '.join(f'{v:.4f}' for v in lmls)} (mean - exact "
          f"{d_lml:+.4f}, gate 0.1); psis on the card {psis_s * 1e3:.2f} "
          f"ms: k-hat {float(res.khat):.4f}, PSIS ESS {ess:.1f} of "
          f"{TEMPER_N}; card vs CPU: smoothed weights {err_w:.2e}, k-hat "
          f"{err_k:.2e} relative (gate 1e-5)")
    check(abs(d_lml) < 0.1, "ais outside the exact-evidence gate")
    check(err_w < 1e-5 and err_k < 1e-5 and res.tail_len
          == res_cpu.tail_len, "psis on the card differs from the CPU's")
    del runs, res

    # (d) parallel tempering on the bimodal model
    pt_betas = torch.tensor(PT_BETAS, device=dev)
    (samples, swap_rate), secs = timed(torch, lambda: parallel_tempering(
        random.PRNGKey(5, dev), bimodal, bsel, pt_betas, n_sweeps=PT_SWEEPS,
        L=8, eps=0.15))
    xs = samples[PT_BURN:, 0].double().cpu().numpy()
    frac_pos = float(np.mean(xs > 0))
    abs_mean = float(np.mean(np.abs(xs)))
    print(f"{tag} 11d parallel_tempering, {len(PT_BETAS)} replicas, "
          f"{PT_SWEEPS} sweeps, L=8: {secs:.2f} s "
          f"({secs / PT_SWEEPS * 1e3:.2f} ms a sweep); swap rate "
          f"{float(swap_rate):.4f} (gate > 0.2), share of x > 0 "
          f"{frac_pos:.4f} (gate 0.2-0.8), mean |x| {abs_mean:.4f} (gate "
          f"2 +- 0.15)")
    check(float(swap_rate) > 0.2 and 0.2 < frac_pos < 0.8
          and abs(abs_mean - 2.0) < 0.15,
          "parallel_tempering outside the bimodal gates")
    return launches


def pg_setup(torch, tt, dev):
    """examples/particle_gibbs.py's kernel and data (simulate_data, phi =
    0.8) at T = 40, and the Kalman smoother of the same LGSSM."""
    from gen_tpu_torch.combinators import VectorChoiceMap
    from gen_tpu_torch.models import LGSSMParams, kalman_smoother

    @tt.gen
    def ssm_kernel(t, prev, phi):
        x = tt.normal(phi * prev, PG_Q) @ "x"
        tt.normal(x, PG_R) @ "y"
        return x

    rng = np.random.default_rng(3)
    x, ys = 0.0, []
    for _ in range(PG_T):
        x = PG_PHI * x + PG_Q * rng.standard_normal()
        ys.append(x + PG_R * rng.standard_normal())
    ys = np.asarray(ys)
    obs = VectorChoiceMap(tt.ChoiceMap().set_value(
        "y", torch.tensor(ys, dtype=torch.float32, device=dev)), PG_T)
    f64 = dict(dtype=torch.float64)
    params = LGSSMParams(
        A=torch.tensor([[PG_PHI]], **f64), Q=torch.tensor([[PG_Q ** 2]], **f64),
        C=torch.tensor([[1.0]], **f64), R=torch.tensor([[PG_R ** 2]], **f64),
        mu0=torch.tensor([0.0], **f64), P0=torch.tensor([[PG_Q ** 2]], **f64))
    means, covs = kalman_smoother(params, torch.tensor(ys, **f64)[:, None])
    return ssm_kernel, obs, means[:, 0].numpy(), covs[:, 0, 0].numpy()


def phase_particle_gibbs(torch, tt, dev, tag):
    """Phase 11(e): particle_gibbs with ancestor sampling at 4,096
    particles and T = 40 against the Kalman smoother (tests/test_csmc.py's
    gate form). Returns K4's launches (the initial genealogy run)."""
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import particle_gibbs
    from gen_tpu_torch.ops import resample as rs
    kernel, obs, sm_means, sm_vars = pg_setup(torch, tt, dev)
    rs.systematic_resample.launches = 0
    (refs, lmls), secs = timed(torch, lambda: particle_gibbs(
        random.PRNGKey(8, dev), kernel, 0.0, (PG_PHI,), obs,
        num_particles=PG_N, num_sweeps=PG_SWEEPS, ancestor_sampling=True))
    launches = rs.systematic_resample.launches
    xs = refs.inner.get_value("x").double().cpu().numpy()   # (sweeps, T)
    kept = PG_SWEEPS - PG_BURN
    post_mean, post_var = xs[PG_BURN:].mean(axis=0), xs[PG_BURN:].var(axis=0)
    se = float((np.sqrt(sm_vars / kept) * 6 + 0.05).max())
    d_mean = float(np.abs(post_mean - sm_means).max())
    var_ok = bool(np.all(np.abs(post_var - sm_vars)
                         <= 0.05 + 0.45 * np.abs(sm_vars)))
    d_var = float(np.max(np.abs(post_var - sm_vars)
                         / (0.05 + 0.45 * np.abs(sm_vars))))
    rate = PG_SWEEPS * PG_N * PG_T / secs
    print(f"{tag} 11e particle_gibbs N={PG_N} T={PG_T} phi={PG_PHI}, "
          f"ancestor sampling, {PG_SWEEPS} sweeps ({PG_BURN} burn-in): "
          f"{secs:.2f} s, {rate:.4e} CSMC particle-steps/s; smoothed means "
          f"max |err| {d_mean:.4f} (gate {se:.4f}), variances at "
          f"{d_var:.3f} of their gate (rtol 0.45, atol 0.05); log-ML "
          f"estimates {float(lmls[PG_BURN:].mean()):.4f} mean; K4 launches "
          f"{launches} (the initial genealogy run)")
    check(d_mean <= se and var_ok and bool(np.isfinite(xs).all()),
          "particle_gibbs outside the Kalman-smoother gates")
    return launches


def phase_switch(torch, tt, dev, tag):
    """Phase 11(f): a two-branch Switch mixture at 131,072 traces, vmapped
    generate (the component index a batched choice) then an update that
    flips every index, on the card and on the CPU under the same keys:
    weights, scores, indices and each branch's choices equal within
    1e-5 relative to max(|x|, 1) (float32: below 1 in magnitude, where a
    weight's sum of logs nears 0 and the two devices' last-ulp differences
    in log and exp no longer shrink with it, 1e-5 absolute)."""
    from gen_tpu_torch import random

    def model_on(d):
        @tt.gen
        def b0(mu):
            return tt.normal(mu, 1.0) @ "x"

        @tt.gen
        def b1(mu):
            x = tt.normal(-mu, 2.0) @ "x"
            z = tt.normal(x, 0.5) @ "z"
            return x + z

        sw = tt.Switch(b0, b1)
        probs = torch.tensor([0.4, 0.6], device=d)

        @tt.gen
        def mixture(mu):
            k = tt.categorical(probs) @ "k"
            v = sw(k, mu) @ "comp"
            tt.normal(v, 0.5) @ "y"
            return v
        return mixture

    def run(d):
        mixture = model_on(d)
        ys = torch.linspace(-3.0, 3.0, SWITCH_N, device=d)

        def one(k, y):
            k1, k2 = random.split(k)
            tr, w = mixture.generate(k1, (0.5,), tt.choicemap(y=y))
            new, uw, _, _ = tr.update(k2, tt.choicemap(k=1 - tr["k"]))
            branches = new.get_call(("comp",)).subtrace.branch_traces
            return (w, tr.get_score(), tr["k"], uw, new.get_score(),
                    new["k"], new.get_retval()) + tuple(
                        b.get_choices().to_array() for b in branches)

        keys = random.split(random.PRNGKey(11, d), SWITCH_N)
        return torch.func.vmap(one)(keys, ys)

    card, secs = timed(torch, lambda: run(dev))
    t0 = time.perf_counter()
    cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    names = ("generate weight", "score", "k", "update weight", "new score",
             "new k", "new return value", "branch 0 choices",
             "branch 1 choices")
    worst = {}
    for name, a, b in zip(names, card, cpu):
        a, b = a.cpu().double(), b.double()
        worst[name] = float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
    flipped = float((card[5] != card[2]).double().mean())
    print(f"{tag} 11f Switch mixture, {SWITCH_N} traces: vmapped generate + "
          f"index-flipping update {secs:.2f} s on the card ({cpu_s:.2f} s on "
          f"the CPU); card vs CPU max relative error "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" (gate {SWITCH_RTOL:.0e}); indices flipped {flipped:.3f}")
    check(all(v < SWITCH_RTOL for v in worst.values()) and flipped == 1.0,
          "Switch on the card differs from the CPU")


def phase_rest_of_smc(torch, tt, dev, tag):
    """Phase 11: (a)-(d) tempering and PSIS, (e) Particle Gibbs, (f)
    Switch. Returns K4's launches by path."""
    t0 = time.perf_counter()
    launches = phase_tempering(torch, tt, dev, tag)
    launches["particle_gibbs"] = phase_particle_gibbs(torch, tt, dev, tag)
    phase_switch(torch, tt, dev, tag)
    print(f"{tag} phase 11 took {time.perf_counter() - t0:.1f} s")
    return launches


# -- phase 12: gradients and the local moves ---------------------------------

LOCAL_N = TEMPER_N                 # chains of parts (a)-(d)
LOCAL_STEPS = (("mh_selection", 200), ("hmc", 100), ("mala", 150),
               ("elliptical_slice", 20))
GRAD_CPU_N = 8192                  # 12(d)'s traces recomputed on the CPU
MAP_MOVES = 30
DRAWS_N = 10 ** 6
DEVICE_RTOL = 1e-5                 # card against the CPU, float32
GRAD_F64_RTOL = 5e-4               # 12(d): float32 against float64
GRAD_F64_RATIO = 4.0               # 12(d): card's error over the CPU's


def conj_model(torch, tt, dev, dtype):
    """temper_setup's conjugate Gaussian model in ``dtype``, its
    observations as a choice map."""
    ys = temper_data()[0]
    ones = torch.ones(TEMPER_OBS, dtype=dtype, device=dev)
    sd0 = torch.tensor(TEMPER_SD0, dtype=dtype, device=dev)
    sd = torch.tensor(TEMPER_SD, dtype=dtype, device=dev)

    @tt.gen
    def gauss_model():
        mu = tt.normal(0.0 * sd0, sd0) @ "mu"
        tt.normal(mu * ones, sd) @ "ys"

    return gauss_model, tt.choicemap(ys=torch.tensor(ys, dtype=dtype,
                                                     device=dev))


def prior_chains(torch, tt, model, obs, dev, n, seed):
    """``n`` traces of ``model``, the latents drawn from the prior and the
    observations constrained."""
    from gen_tpu_torch import random
    keys = random.split(random.PRNGKey(seed, dev), n)
    return torch.func.vmap(lambda k: model.generate(k, (), obs)[0])(keys)


def rel_err(torch, a, b):
    """Largest |a - b| / max(|b|, 1) of two tensors (``b`` on the CPU)."""
    a, b = a.detach().cpu().double(), b.detach().double()
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


def row_rel_err(torch, a, b):
    """Largest over traces (rows) of max |a - b| / max(max |b|, 1) within
    the row: each trace's gradient against its own scale. Elementwise, a
    float32 gradient of normal_linear's Gram form is not comparable
    between devices: a residual (X beta)_i - y_i that cancels to ~1e-3
    keeps the absolute rounding error of its ~6-sized terms, ~1e-4
    relative to itself."""
    a = a.detach().cpu().double().reshape(a.shape[0], -1)
    b = b.detach().double().reshape(b.shape[0], -1)
    scale = b.abs().max(dim=1).values.clamp_min(1.0)
    return float(((a - b).abs().max(dim=1).values / scale).max())


def phase_local_moves(torch, tt, dev, tag):
    """Phase 12(a)-(b): mh_selection, hmc, mala and elliptical_slice on
    "mu" of the conjugate model, vmapped over LOCAL_N chains from prior
    draws; map_optimize to the mode in float64 and laplace_approx."""
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import (elliptical_slice, hmc,
                                         laplace_approx, mala, map_optimize,
                                         mh_selection)
    _, lml_ex, mean_ex, sd_ex = temper_data()
    model, obs = conj_model(torch, tt, dev, torch.float32)
    sel = tt.select("mu")
    prior_mu = torch.zeros(1, device=dev)
    prior_cov = torch.full((1, 1), TEMPER_SD0 ** 2, device=dev)
    moves = {
        "mh_selection": lambda k, tr: mh_selection(k, tr, sel),
        "hmc": lambda k, tr: hmc(k, tr, sel, L=5, eps=0.05),
        "mala": lambda k, tr: mala(k, tr, sel, 0.005),
        "elliptical_slice": lambda k, tr: (elliptical_slice(
            k, tr, "mu", prior_mu, prior_cov), torch.ones((), dtype=bool,
                                                          device=dev)),
    }
    print(f"phase 12: conjugate model, {TEMPER_OBS} observations: exact "
          f"posterior mean {mean_ex:.4f} sd {sd_ex:.4f}, log-ML "
          f"{lml_ex:.4f}; {LOCAL_N} chains from prior draws")
    for name, steps in LOCAL_STEPS:
        traces = prior_chains(torch, tt, model, obs, dev, LOCAL_N, 12)
        step = torch.func.vmap(moves[name])

        def run(traces=traces, step=step):
            acc = torch.zeros(LOCAL_N, device=dev)
            for s in range(steps):
                keys = random.split(random.fold_in(
                    random.PRNGKey(21, dev), s), LOCAL_N)
                traces, a = step(keys, traces)
                acc = acc + a.float()
            return traces, acc / steps

        (traces, acc), secs = timed(torch, run)
        mu = traces["mu"].double().reshape(LOCAL_N, -1)[:, 0]
        m, s = float(mu.mean()), float(mu.std())
        dm, ds = abs(m - mean_ex) / sd_ex, abs(s / sd_ex - 1)
        rate = float(acc.mean())
        print(f"{tag} 12a {name}: {steps} steps of {LOCAL_N} chains in "
              f"{secs:.2f} s ({1e3 * secs / steps:.2f} ms a step); pooled "
              f"final mean {m:.4f} ({dm:.4f} sd off, gate 0.05), sd "
              f"{s:.4f} ({100 * ds:.2f}% off, gate 6%); accept rate "
              f"{rate:.4f}")
        check(dm < 0.05 and ds < 0.06 and 0.0 < rate <= 1.0,
              f"{name} misses the conjugate posterior")

    # (b) map_optimize and laplace_approx, float64: in float32 the score
    # is flat to its last bit ~2e-3 sd around the mode
    model64, obs64 = conj_model(torch, tt, dev, torch.float64)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        traces = prior_chains(torch, tt, model64, obs64, dev, LOCAL_N, 13)
        move = torch.func.vmap(lambda tr: map_optimize(tr, sel))

        def run_map(traces=traces):
            for _ in range(MAP_MOVES):
                traces = move(traces)
            return traces

        modes, secs = timed(torch, run_map)
        err = float((modes["mu"] - mean_ex).abs().max()) / sd_ex
        lap, lap_s = timed(torch, lambda: laplace_approx(
            model64.generate(random.PRNGKey(0, dev), (), obs64)[0], sel))
    finally:
        torch.set_default_dtype(prev)
    lap_mean_err = abs(float(lap.mean[0]) - mean_ex) / sd_ex
    lap_sd_err = abs(math.sqrt(float(lap.cov[0, 0])) / sd_ex - 1)
    lml_err = abs(float(lap.log_ml) - lml_ex)
    print(f"{tag} 12b map_optimize: {MAP_MOVES} moves of {LOCAL_N} float64 "
          f"chains in {secs:.2f} s; worst chain's mode {err:.2e} sd from "
          f"the exact mean (gate 1e-4)")
    print(f"{tag} 12b laplace_approx (200 moves, Hessian) {lap_s:.2f} s: "
          f"mean {lap_mean_err:.2e} sd off, sd {lap_sd_err:.2e} off, log-ML "
          f"{float(lap.log_ml):.6f} against {lml_ex:.6f} ({lml_err:.2e}, "
          "gate 1e-4)")
    check(err < 1e-4 and lap_mean_err < 1e-4 and lap_sd_err < 1e-6
          and lml_err < 1e-4, "map_optimize or laplace_approx misses")


def two_site_model(torch, tt, d):
    """tests/test_gibbs.py's two-site model on device ``d``."""
    probs = torch.tensor([0.2, 0.5, 0.3], device=d)
    means = torch.tensor([-2.0, 0.0, 2.0], device=d)

    @tt.gen
    def two_site():
        z1 = tt.categorical(probs) @ "z1"
        z2 = tt.bernoulli(0.4) @ "z2"
        mean = means[z1.reshape(1)][0] + torch.where(z2, 1.0, 0.0)
        tt.normal(mean, 0.7) @ "x"
        return z1

    supports = {"z1": torch.arange(3, device=d),
                "z2": torch.tensor([False, True], device=d)}
    return two_site, tt.choicemap(x=torch.tensor(0.4, device=d)), supports


def phase_gibbs(torch, tt, dev, tag):
    """Phase 12(c): two blocked gibbs moves over (z1, z2) at LOCAL_N chains
    against the card's enumerate_posterior; that posterior against the
    CPU's."""
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import enumerate_posterior, gibbs
    model, obs, supports = two_site_model(torch, tt, dev)
    (grid, _, lml, lpost), e_s = timed(torch, lambda: enumerate_posterior(
        model, (), obs, supports))
    cmodel, cobs, csupports = two_site_model(torch, tt, "cpu")
    _, _, lml_c, lpost_c = enumerate_posterior(cmodel, (), cobs, csupports)
    e_err = max(rel_err(torch, lpost, lpost_c), rel_err(torch, lml, lml_c))
    traces = torch.func.vmap(lambda k: model.generate(k, (), obs)[0])(
        random.split(random.PRNGKey(14, dev), LOCAL_N))
    move = torch.func.vmap(lambda k, tr: gibbs(k, tr, supports))

    def run(traces=traces):
        for s in range(2):
            traces = move(random.split(random.fold_in(
                random.PRNGKey(22, dev), s), LOCAL_N), traces)
        return traces

    traces, secs = timed(torch, run)
    cell = traces["z1"].long() * 2 + traces["z2"].long()
    freq = torch.bincount(cell, minlength=6).double() / LOCAL_N
    tv = 0.5 * float((freq - torch.exp(lpost.double())).abs().sum())
    print(f"{tag} 12c enumerate_posterior (6 cells) {1e3 * e_s:.2f} ms, "
          f"card vs CPU {e_err:.2e} (gate {DEVICE_RTOL:.0e}); gibbs, two "
          f"blocked moves of {LOCAL_N} chains in {secs:.2f} s; total "
          f"variation to the enumerated posterior {tv:.4f} (gate 0.01)")
    check(e_err < DEVICE_RTOL and tv < 0.01, "gibbs or enumerate_posterior")


def phase_gradients(torch, tt, dev, tag):
    """Phase 12(d): choice_gradients and param_gradients on LOCAL_N traces
    of the headline regression model (a copy with trainable prior means
    for the parameters), on the card and on the CPU, and in float64 on the
    CPU at the float32 traces' choices, the witness of which side rounds."""
    from gen_tpu_torch import random
    from gen_tpu_torch.dynamic import init_param, param

    addrs = ("slope", "intercept", "log_noise")

    def run(d, n, at=None):
        """Float32 traces from keys, or (``at``: the float32 run's choices
        of both models) the same traces in float64."""
        model, X, obs, sel, _, _ = regression_setup(torch, tt, d)
        keyed = at is None
        dt = torch.float32 if keyed else torch.float64
        X, ys = X.to(dt), obs["ys"].to(dt)

        @tt.gen
        def pmodel(X):
            w = param("w_mu")
            slope = tt.normal(w[0], 2.0) @ "slope"
            intercept = tt.normal(w[1], 2.0) @ "intercept"
            log_noise = tt.normal(param("log_noise_mu"), 1.0) @ "log_noise"
            tt.normal_linear(X, torch.stack([slope, intercept]),
                             torch.exp(log_noise)) @ "ys"
            return slope

        init_param(pmodel, "w_mu", torch.tensor([0.1, -0.2], dtype=dt,
                                                device=d))
        init_param(pmodel, "log_noise_mu", torch.tensor(0.3, dtype=dt,
                                                        device=d))
        keys = random.split(random.PRNGKey(15, d), LOCAL_N)[:n]

        def one(k, mv, pv):
            if keyed:
                tr = model.generate(k, (X,), tt.choicemap(ys=ys))[0]
                ptr = pmodel.generate(k, (X,), tt.choicemap(ys=ys))[0]
            else:
                tr = model.generate(k, (X,), tt.choicemap(
                    ys=ys, **dict(zip(addrs, mv))))[0]
                ptr = pmodel.generate(k, (X,), tt.choicemap(
                    ys=ys, **dict(zip(addrs, pv))))[0]
            ag, vals, cg = model.choice_gradients(tr, sel, retgrad=1.5)
            pag, pg = pmodel.param_gradients(ptr, scale_factor=2.0)
            return ((ag[0], cg.to_array(), vals.to_array(), pag[0],
                     pg[pmodel]["w_mu"], pg[pmodel]["log_noise_mu"]),
                    torch.stack([tr[a] for a in addrs]),
                    torch.stack([ptr[a] for a in addrs]))

        if keyed:
            at = (torch.zeros(n, 3, device=d),) * 2
        return torch.func.vmap(one)(keys, *at)

    (card, _, _), secs = timed(torch, lambda: run(dev, LOCAL_N))
    card = [c[:GRAD_CPU_N] for c in card]
    cpu, mvals, pvals = run("cpu", GRAD_CPU_N)
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        ref = run("cpu", GRAD_CPU_N, (mvals.double(), pvals.double()))[0]
    finally:
        torch.set_default_dtype(default)
    names = ("d/dX", "choice grads", "choice values", "param model d/dX",
             "d/dw_mu", "d/dlog_noise_mu")
    errs = {n: row_rel_err(torch, a, b) for n, a, b in zip(names, card,
                                                            cpu)}
    card64 = {n: rel_err(torch, a, b) for n, a, b in zip(names, card, ref)}
    cpu64 = {n: rel_err(torch, a, b) for n, a, b in zip(names, cpu, ref)}
    print(f"{tag} 12d choice_gradients + param_gradients of {LOCAL_N} "
          f"regression traces {secs:.2f} s on the card; on the first "
          f"{GRAD_CPU_N}, card vs CPU, each trace against its largest entry "
          f"(gate {DEVICE_RTOL:.0e}), and [card, CPU] elementwise against "
          f"float64 (gate {GRAD_F64_RTOL:.0e}, the card within "
          f"{GRAD_F64_RATIO:g}x the CPU's error or 1e-6): "
          + ", ".join(f"{k} {v:.2e} [{card64[k]:.2e}, {cpu64[k]:.2e}]"
                      for k, v in errs.items()))
    check(all(v < DEVICE_RTOL for v in errs.values()),
          "gradients on the card differ from the CPU")
    check(all(card64[k] < GRAD_F64_RTOL and cpu64[k] < GRAD_F64_RTOL
              and card64[k] <= GRAD_F64_RATIO * max(cpu64[k], 1e-6)
              for k in names),
          "float32 gradients differ from float64 beyond rounding")


def phase_draws(torch, tt, dev, tag):
    """Phase 12(e): DRAWS_N draws of each new distribution on the card
    against its exact law (Kolmogorov-Smirnov, chi-square or moments), and
    their logpdfs on the card against the CPU."""
    from scipy import stats
    from gen_tpu_torch import random
    from gen_tpu_torch.dists import dist_dsl

    def t(x, d):
        return torch.tensor(x, dtype=torch.float32, device=d)

    def cases(d):
        bounds, rates = t([0.0, 2.0, 5.0, 10.0], d), t([0.5, 2.0, 1.0], d)
        return {
            "beta_uniform": (tt.beta_uniform, (t(0.4, d), t(2.0, d),
                                               t(3.0, d))),
            "dirichlet": (tt.dirichlet, (t([2.0, 3.0, 1.5], d),)),
            "piecewise_uniform": (tt.piecewise_uniform,
                                  (t([0.0, 1.0, 3.0], d), t([0.6, 0.4], d))),
            "piecewise_poisson_process": (
                tt.PiecewisePoissonProcess(max_events=48), (bounds, rates)),
            "HomogeneousMixture": (
                tt.HomogeneousMixture(tt.normal, [0, 0]),
                (t([0.4, 0.6], d), t([-1.0, 2.0], d), t([0.5, 1.0], d))),
            "HeterogeneousMixture": (
                tt.HeterogeneousMixture([tt.normal, tt.uniform]),
                (t([0.3, 0.7], d), t(0.0, d), t(1.0, d), t(0.0, d),
                 t(2.0, d))),
            "exp_of(normal)": (dist_dsl.exp_of(tt.normal),
                               (t(0.5, d), t(0.4, d))),
            "normal * 2 + 3": (tt.normal * 2.0 + 3.0, (t(0.0, d), t(1.0, d))),
            "enum_dist": (tt.RelabeledDistribution(
                torch.tensor([10, 20, 10], device=d), tt.categorical),
                (t([0.2, 0.3, 0.5], d),)),
        }

    def mix_cdf(w, cdfs):
        return lambda x: sum(wi * c(x) for wi, c in zip(w, cdfs))

    laws = {
        "beta_uniform": ("ks", mix_cdf((0.4, 0.6), (stats.beta(2, 3).cdf,
                                                    stats.uniform.cdf))),
        "piecewise_uniform": ("ks", lambda x: np.where(
            x < 1.0, 0.6 * x, 0.6 + 0.2 * (x - 1.0))),
        "HomogeneousMixture": ("ks", mix_cdf((0.4, 0.6), (
            stats.norm(-1, 0.5).cdf, stats.norm(2, 1).cdf))),
        "HeterogeneousMixture": ("ks", mix_cdf((0.3, 0.7), (
            stats.norm.cdf, stats.uniform(0, 2).cdf))),
        "exp_of(normal)": ("ks", stats.lognorm(0.4, scale=np.exp(0.5)).cdf),
        "normal * 2 + 3": ("ks", stats.norm(3, 2).cdf),
    }
    card_cases, cpu_cases = cases(dev), cases("cpu")
    keys = random.split(random.PRNGKey(16, dev), DRAWS_N)
    for name, (dist, args) in card_cases.items():
        draws, secs = timed(torch, lambda: torch.func.vmap(
            lambda k: dist.sample(k, *args))(keys))
        lp = torch.func.vmap(lambda v: dist.logpdf(v, *args))(draws)
        cdist, cargs = cpu_cases[name]
        lp_cpu = torch.func.vmap(lambda v: cdist.logpdf(v, *cargs))(
            draws.cpu())
        lp_err = rel_err(torch, lp, lp_cpu)
        x = draws.detach().cpu().double().numpy()
        if name in laws:
            p = stats.kstest(x, laws[name][1]).pvalue
            law = f"KS p {p:.3g}"
            ok = p > 1e-4
        elif name == "dirichlet":
            alpha = np.array([2.0, 3.0, 1.5])
            ps = [stats.kstest(x[:, i], stats.beta(
                a, alpha.sum() - a).cdf).pvalue for i, a in enumerate(alpha)]
            law = "marginal KS p " + ", ".join(f"{p:.3g}" for p in ps)
            ok = min(ps) > 1e-4 and np.abs(x.sum(1) - 1).max() < 1e-5
        elif name == "enum_dist":
            obs = np.array([(x == 10).sum(), (x == 20).sum()])
            p = stats.chisquare(obs, DRAWS_N * np.array([0.7, 0.3])).pvalue
            law = f"chi-square p {p:.3g}"
            ok = p > 1e-4 and obs.sum() == DRAWS_N
        else:   # the process: counts Poisson(12), positions by intensity
            finite = np.isfinite(x)
            counts = finite.sum(1)
            pos = x[finite]
            cum = lambda v: np.interp(v, [0, 2, 5, 10], [0, 1, 7, 12]) / 12
            p_n = stats.kstest(pos, cum).pvalue
            z = (counts.mean() - 12.0) / math.sqrt(12.0 / DRAWS_N)
            law = (f"count mean {counts.mean():.4f} (z {z:.2f}), var "
                   f"{counts.var():.3f}; positions KS p {p_n:.3g}")
            ok = abs(z) < 5 and abs(counts.var() / 12 - 1) < 0.02 \
                and p_n > 1e-4 and counts.max() < 48
        print(f"{tag} 12e {name}: {DRAWS_N} draws {secs:.2f} s; {law}; "
              f"logpdf card vs CPU {lp_err:.2e} (gate {DEVICE_RTOL:.0e})")
        check(ok and lp_err < DEVICE_RTOL and bool(torch.isfinite(lp).all()),
              f"{name} draws or logpdf")


def phase_local(torch, tt, dev, tag):
    """Phase 12: (a)-(b) the local moves, map_optimize and laplace, (c)
    gibbs against enumeration, (d) gradients, (e) the new distributions."""
    t0 = time.perf_counter()
    phase_local_moves(torch, tt, dev, tag)
    phase_gibbs(torch, tt, dev, tag)
    phase_gradients(torch, tt, dev, tag)
    phase_draws(torch, tt, dev, tag)
    print(f"{tag} phase 12 took {time.perf_counter() - t0:.1f} s")


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    import gen_tpu_torch as tt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- phase 1: environment, staging and build --------------------------
    card = phase_env(torch)
    tag = f"[{card}]"
    lap = [t_start]

    def stamp(label):
        """Print the wall time since the previous stamp: where the
        script's 1,200 s go, phase by phase."""
        now = time.perf_counter()
        print(f"{tag} time: {label} {now - lap[0]:.1f} s")
        lap[0] = now

    ctx = phase_build(torch, tt, dev, tag)
    phase_division(torch, ctx, dev)
    stamp("phase 1 (staging, build, division sweep)")

    # -- phase 2: K3, K6 and K4 against their plain versions ---------------
    k3_err = phase_compare(torch, ctx, dev, paired=True)
    stamp("phase 2 (K3 against its plain version)")
    k6_err = phase_compare(torch, ctx, dev, paired=False)
    stamp("phase 2 (K6 against its plain version)")
    k4_err = phase_compare_k4(torch, dev)
    k5_err = phase_compare_k5(torch, dev)
    stamp("phase 2 (K4, K5 against their plain versions)")

    # -- phases 3-5: the main paths, each with its gates --------------------
    rng = np.random.default_rng(123)
    k1_d10_err = compare_k1_schools(torch, ctx, dev, rng)
    k1_entry = phase_headline(torch, tt, dev, ctx["k1"], tag, rng)
    k1_entry["max_abs_err"] = max(k1_entry["max_abs_err"], k1_d10_err)
    stamp("phase 3 (headline)")
    errs = {True: k3_err, False: k6_err}
    k3_10, k6_10 = phase_nuts_path(torch, tt, dev, "eight_schools d=10",
                                   ctx["s8"], 131072, tag, errs, ctx["st_10"])
    for entry, k in ((k3_10, "K3"), (k6_10, "K6")):
        c = ctx["census"][k]["one"]         # the path collects coordinate 0
        entry.update({key: c[key] for key in (
            "registers", "spill_bytes", "shared_bytes", "warps_per_sm",
            "waves")})
    k3_102, k6_102 = phase_nuts_path(torch, tt, dev, "schools d=102",
                                     ctx["s100"], 32768, tag, errs,
                                     ctx["st_102"])
    stamp("phase 4 (metrics 2 and 3)")
    sample_launches = phase_sample(torch, tt, dev, tag, ctx["s8"],
                                   ctx["s100"])
    print(f"{tag} sample_posterior launches over all engines: "
          f"{sample_launches}")
    print(f"{tag} staging {ctx['stage_s']:.3f} s, nvcc build "
          f"{ctx['build_s']:.2f} s")
    stamp("phase 5 (sample_posterior, seven runs)")

    # -- phase 6: the SMC slice ------------------------------------------------
    smc_a = phase_smc_throughput(torch, tt, dev, tag)
    stamp("phase 6a (SMC throughput)")
    phase_smc_gates(torch, tt, dev, tag)
    stamp("phase 6b (SMC gates)")

    # -- phases 7 and 8: K5's own draws, the mixed/decode slice ------------
    phase_k5_draws(torch, dev)
    decode_run = phase_decode(torch, dev, tag)
    stamp("phases 7 and 8a (K5 draws, decode)")
    phase_mixed(torch, tt, dev, tag, ctx["mixed"])
    stamp("phase 8b (mixed models)")

    # -- phase 10: the streamed likelihood and the Kalman body ------------
    k2_err = phase_compare_k2(torch, ctx, dev, rng)
    stream_res = phase_stream(torch, tt, dev, tag, ctx)
    ar1_res = phase_ar1(torch, tt, dev, tag, ctx)
    stamp("phase 10 (stream and Kalman body)")

    # -- phase 11: the rest of SMC -----------------------------------------
    tempered = phase_rest_of_smc(torch, tt, dev, tag)
    stamp("phase 11 (rest of SMC)")

    # -- phase 12: gradients and the local moves ---------------------------
    phase_local(torch, tt, dev, tag)
    stamp("phase 12 (gradients, local moves)")

    # -- phase 9: numbers ---------------------------------------------------
    # K1 runs on three main paths: the headline, sample_posterior's
    # hmc_fused engine and phase 10(c)'s AR(1) model
    k1_entry["launches_by_path"] = dict(
        headline=k1_entry["launches"], sample_posterior=sample_launches[
            "hmc_fused"], ar1=ar1_res["hmc_fused"]["k1_launches"])
    k1_entry["launches"] = sum(k1_entry["launches_by_path"].values())
    k4 = k4_entry(torch, dev, tag, smc_a, k4_err, tempered)
    k5 = k5_entry(torch, dev, tag, decode_run, k5_err)
    k2 = k2_entries(torch, dev, ctx, k2_err, stream_res, ar1_res)
    stamp("phase 9 (kernel timings)")
    print(f"{tag} chip_smoke.py took {time.perf_counter() - t_start:.1f} s "
          "in all")
    print(json.dumps({"kernels": [
        k1_entry, dict(name="nuts_pair", **k3_10),
        dict(name="nuts_pair_d102", **k3_102),
        dict(name="nuts_tick", **k6_10), dict(name="nuts_tick_d102", **k6_102),
        k4, k5] + k2}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
