"""Time K3 and K6 at d=102 in two builds on one warmed state, in turns.

The 100-school eight_schools model (metric 3, 32,768 chains) is warmed up
once with ChEES; then K3 (``paired=True``, 1,000 pairs) and K6 (2,000
ticks) are timed, three calls each after a warm call, first with the
kernel sources in ``OTHER_CSRC`` (a copy of ``gen_tpu_torch/ops/csrc``:
an earlier one, which has only the one-thread layout and is rendered in
it, or an edited one, rendered in this checkout's layout), then with this
checkout's, in the order other, this, this, other, so that both builds
share the card and its state. Run from the repository root on a machine
with a CUDA card:

    python3 layout_timing.py OTHER_CSRC

Prints each build's ptxas report for K3, each timing, a summary per build
and kernel, and the card's name and power limit.

Stream mode times the streamed likelihood's loop (staging part c) in two
trees of the package, each in its own process, in the order other,
this, this, other on one card:

    python3 layout_timing.py --stream OTHER_ROOT [POINTS ...]

``OTHER_ROOT`` holds an earlier ``gen_tpu_torch`` package (for example
``git archive <commit> gen_tpu_torch | tar -x -C OTHER_ROOT``). Each
process stages chip_smoke.py's robust-t regression at n = 10^6 and 10^4
and times the staged-code kernel per gradient at (10^6, 128 chains: the
ChEES warmup's shape), (10^6, 1,024) and (10^4, 8,192), then K3
(``paired=True``) and K6 per leapfrog slot over ``STREAM_SLOTS`` slots
at (10^6, 1,024) and (10^4, 8,192) from chains near the posterior at a
fixed step size. A tree with ``scalarize.StreamLayout`` is timed at each
of ``POINTS`` points per lane and tile (default
``STREAM_POINT_VARIANTS``), the staged-code kernel also at the split
counts ``STREAM_SPLITS``, K6 (whose layout K1 shares) at each of
``STREAM_BLOCK_WARP_VARIANTS`` warps a block; the staged-code kernel's
SASS opcode counts are printed (``cuobjdump``). Prints the ptxas report
of every kernel built, every timing, a summary, and the card's name and
power limit.

Variant mode times this tree's stream kernels under source variants in
one process, in turns (each variant, then the same in reverse):

    python3 layout_timing.py --stream-variants [NAME ...]

``STREAM_VARIANTS`` names them (all by default): the tile copies cached
in L1 as well (``cp.async.ca``), a three-stage ring, 4 or 2 points a
lane, and a register cap of about 200 at 10^4 (``STREAM_SM_WARPS`` 10),
each against ``base``, this tree as it is; each is timed on the
staged-code kernel at STREAM_SHAPES and on K3 and K6 at
STREAM_FUSED_SHAPES.

Kalman mode times the Kalman body (staging part b, K2b) in two trees of
the package, each in its own process, in the order other, this, this,
other on one card:

    python3 layout_timing.py --kalman OTHER_ROOT

``OTHER_ROOT`` holds an earlier ``gen_tpu_torch`` package, as for
``--stream``. Each process stages chip_smoke.py's AR(1) model at T = 1
(the process's first trace) and at T = 100, builds K1, K3 and the
staged-code kernel for T = 100 (one ``nvcc`` per source, in parallel),
and times the staged-code kernel per gradient at 131,072 chains, K1 per
step (``KALMAN_K1_STEPS`` steps of ``KALMAN_L`` leapfrogs) and K3 per
leapfrog slot (``STREAM_SLOTS`` slots), from chains near the posterior
at a fixed step size. A tree whose staged program has scan loops also
times the staged-code kernel with the loops' tape moved by text
substitution into a shared-memory slab (blocks of ``KALMAN_SHARED_BLOCK``
threads, :func:`shared_tape`), and K1 and K3 built
asking for one block an SM at least (``__launch_bounds__``' second
argument; ptxas's own choice spills a few bytes in some of their
instantiations); this tree also times the staged-code kernel, K1 and K3
with the run-time reciprocals undone (``REPEATED_DIVISIONS`` set out of
reach). Prints the staging and
``nvcc`` seconds, each kernel's ptxas report, the staged-code kernel's
and K3's SASS opcode counts, every timing, a summary, and the card's name and
power limit.

K1 mode times the fused HMC kernel (K1) in two trees of the package, each
in its own process, in the order other, this, this, other on one card:

    python3 layout_timing.py --k1 OTHER_ROOT

``OTHER_ROOT`` holds an earlier ``gen_tpu_torch`` package, as for
``--stream``. Each process stages chip_smoke.py's headline regression
and eight_schools (d = 10), builds K1 for both (one ``nvcc`` each, in
parallel), prints the main instantiation's ptxas report and SASS census
(``chip_smoke.k1_census``: instructions per chain-step, per leapfrog and
by class, MUFU and FCHK per leapfrog, blocks an SM, waves), runs
``K1_CHECK_STEPS`` steps from the same start under the same key at both
shapes and prints a digest of every output (the two trees must agree bit
for bit), then times K1 per step (median of three calls of ``K1_STEPS``
steps after a warm call) at 524,288 chains (L = 10, the headline's step
size, the slope collected) and at 131,072 chains of eight_schools
(``K1_D10``, every coordinate collected, as the ``hmc_fused`` engine
does), with the SM clock read while the timed calls run and the issue
rate achieved. In this tree it also times the variants of
``K1_VARIANTS`` (the run-time reciprocals undone, the
repeated-denominator rule from two divisions, the step size drawn in the
chain loop in place of the prologue's table, another block size, launch
bounds), whose outputs must agree bit for bit too; a variant that fails
to build or run is reported and skipped. The parent checks the digests and prints a
summary per tree and variant.

Thread mode times K3 and K6 in the one-thread layout at small d in two
trees of the package, each in its own process, in the order other, this,
this, other on one card:

    python3 layout_timing.py --thread OTHER_ROOT

``OTHER_ROOT`` holds an earlier ``gen_tpu_torch`` package, as for
``--stream``. The parent warms up each model of ``THREAD_MODELS``
(eight_schools d = 10 at 131,072 chains, the 15-, 22- and 30-school
models, d = 17, 24 and 32, at 32,768) once with ChEES, with this tree's
package, and hands every process the same warmed state. Each process
builds K3 and K6 at max_depth 8 for every model (one ``nvcc`` each, in
parallel), prints their ptxas report and census (``chip_smoke.
nuts_census``: registers, spills, shared bytes a block, blocks and warps
an SM, waves, SASS counts of LDL/STL, LDS/STS and MUFU), runs
``THREAD_CHECK_SLOTS`` slots under one key with one coordinate and with
every coordinate collected and prints a digest of the outputs (every
tree and variant must agree bit for bit), then times K3 per pair and K6
per tick (median of three calls of ``SLOTS`` slots after a warm call,
coordinate 0 collected, as metric 2). This tree takes the one-thread
layout at every d of the models (``THREAD_MAX_D`` set to 32) and also
times the variants of ``THREAD_VARIANTS`` (blocks of 32, 64 and 128,
ptxas's own registers, at most 128 registers, the block's constants left
to the compiler to hoist into registers); a variant that fails to build
or run is reported and skipped. The parent checks the digests and prints a
summary per tree, variant, model and kernel.

Small mode times the small kernels K4 (systematic resampling) and K5
(batched categorical draws) in two trees of the package, each in its own
process, in the order other, this, this, other on one card:

    python3 layout_timing.py --small OTHER_ROOT

``OTHER_ROOT`` holds an earlier ``gen_tpu_torch`` package, as for
``--stream``. Each process builds K4, K5 and the launch floor (the empty
kernel of this checkout's ``ops/csrc/launch_floor.cu``, launched through
``ctypes`` and ``torch.empty`` as K4 and K5 are; one ``nvcc`` each, in
parallel), prints their ptxas reports, each launch's shape and waves
(blocks an SM by ``chip_smoke.small_waves`` from ptxas's registers),
then times (``chip_smoke.gpu_ms``, median of three timings) the launch
floor, K4 at ``SMALL_K4_NS`` float32 particles in each weight case of
``chip_smoke.k4_log_weights`` (random, zero-weight runs, one dominant
particle) at u = 0.5, and K5's kernel (the custom op) and wrapper
(``batched_categorical``) at every shape of ``chip_smoke.K5_SHAPES`` and
``K5_TIMED_ONLY`` under one key. It prints a digest of the outputs: K4
in every case at u in ``chip_smoke.K4_US``, float32 and float64, on cdfs
made on the host (the card's cumsum is not reproducible in the last ulp
from run to run), and K5's Philox draws at every shape under one key;
both trees must agree. In this tree it also times the variants of
``SMALL_VARIANTS`` (other warps a block, positions a lane or window for K4,
warps a block for K5, by text substitution of the sources' defines),
whose digests must agree too. The parent checks the digests and prints a
summary per tree and variant.
"""

import ctypes
import hashlib
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

import chip_smoke as C

CHAINS = 32768
SLOTS = 2000
STREAM_SLOTS = 400
STREAM_SHAPES = ((1_000_000, 128), (1_000_000, 1024), (10_000, 8192))
# K3 and K6: (points, chains, step size)
STREAM_FUSED_SHAPES = ((1_000_000, 1024, 0.0004), (10_000, 8192, 0.004))
# warps a block of K6 timed (``scalarize.STREAM_BLOCK_WARPS``'s candidates)
STREAM_BLOCK_WARP_VARIANTS = (16, 8)
# --stream-variants: name -> changes to scalarize
# (a three-stage ring of 8 warps' tiles would pass 48 KB of static shared
# memory: K3 and K6 at 10^6 are left out of it)
STREAM_VARIANTS = {"base": {}, "ca": {"copy": "ca"},
                   "stages3": {"STREAM_STAGES": 3, "fused_max_pts": 10_000},
                   "points4": {"STREAM_POINTS": 4, "points": 4},
                   "points4_stages3": {"STREAM_POINTS": 4, "points": 4,
                                       "STREAM_STAGES": 3},
                   "points2": {"STREAM_POINTS": 2, "points": 2},
                   "regs200": {"STREAM_SM_WARPS": 10}}
STREAM_POINT_VARIANTS = (16, 8, 4)
# --kalman: K1's steps and leapfrogs a step, the step size, and the block
# of the staged-code kernel with its tape in shared memory (25,600 B of
# tape at T = 100, within the 48 KB of static shared memory)
KALMAN_K1_STEPS, KALMAN_L, KALMAN_EPS = 20, 10, 0.05
KALMAN_SHARED_BLOCK = 32
# other split counts of the staged-code kernel timed beside its rule's
STREAM_SPLITS = {(1_000_000, 128): (33, 200), (1_000_000, 1024): (5, 26)}
# --k1: the timed calls' steps, the identity check's steps, and
# eight_schools' shape (chains, leapfrogs, step size)
K1_STEPS, K1_CHECK_STEPS = 200, 20
K1_D10 = (131072, 10, 0.25)
# --thread: (schools, chains) of each model (d = schools + 2), and the
# slots of the identity check
THREAD_MODELS = ((8, 131072), (15, 32768), (22, 32768), (30, 32768))
THREAD_CHECK_SLOTS = 200
# --small: K4's particle counts, and this tree's variants: name ->
# {(source, define): value}
SMALL_K4_NS = (131072, 1048576)
SMALL_VARIANTS = {
    "K4 8 positions a lane, window 2048": {("resample", "RESAMPLE_R"): 8,
                                           ("resample", "RESAMPLE_TILE"):
                                           2048},
    "K5 8 warps": {("categorical", "CAT_WARPS"): 8},
}


def main(other: Path):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("layout_timing.py needs a CUDA device")
    import gen_tpu_torch as tt
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import (FlatTarget,
                                         chees_hmc_warmup_and_sample)
    from gen_tpu_torch.ops import _cuda_build
    from gen_tpu_torch.ops import nuts_fused as nf
    from gen_tpu_torch.ops.hmc_fused import stage

    dev = torch.device("cuda", 0)
    card = C.phase_env(torch)
    ys, sig = C.make_schools(100, seed=0)
    model, args, obs, sel = C.schools_setup(torch, tt, ys, sig, dev)
    k_init, k_warm, k_run, k_time = random.split(random.PRNGKey(0, dev), 4)
    traces, _ = torch.func.vmap(lambda k: model.generate(k, args, obs))(
        random.split(k_init, CHAINS))
    target = FlatTarget(model.generate(random.PRNGKey(1, dev), args,
                                       obs)[0], sel)
    _, values, winfo = chees_hmc_warmup_and_sample(
        k_warm, traces, sel, num_warmup=C.NUTS_WARMUP, num_samples=1,
        target_accept=0.8)
    del traces
    staged = stage(target.logp, 102, dev)
    layouts = ("@@LAYOUT warp@@" in (other / "nuts_pair.cu").read_text()
               and nf.kernel_layout)
    if "@@LAYOUT wide" not in (other / "nuts_pair.cu").read_text():
        # an earlier csrc names its one-thread code "thread", which this
        # tree renders as "wide": a copy with the markers renamed
        renamed = Path(tempfile.mkdtemp())
        for f in other.iterdir():
            (renamed / f.name).write_text(f.read_text().replace(
                "// @@LAYOUT thread", "// @@LAYOUT wide"))
        other = renamed
    builds = {"other": (other.resolve(), layouts or (lambda s: "wide")),
              "this": (nf._CSRC_DIR, nf.kernel_layout)}

    def use(which):
        nf._CSRC_DIR, nf.kernel_layout = builds[which]
        staged.libs.clear()
        _cuda_build.build_all([nf.build_job(staged, 8, p)
                               for p in (True, False)])

    for which in builds:
        use(which)
        h = _cuda_build.source_hash(nf.kernel_source(staged, 8, True))
        report = {k: r for k, _, r in _cuda_build.BUILD_LOG}.get(h, "")
        print(f"{which} K3 ptxas: " + " | ".join(
            ln.strip() for ln in report.splitlines()
            if "registers" in ln or "spill" in ln))
    res = {}
    kw = dict(eps=float(winfo["step_size"]), max_depth=8,
              inv_mass_diag=winfo["inv_mass"], collect_idx=0)
    for which in ("other", "this", "this", "other"):
        use(which)
        for paired in (True, False):
            steps = SLOTS // 2 if paired else SLOTS
            v = nf.nuts_chains_fused(k_run, target.logp, values, SLOTS,
                                     paired=paired, **kw)[0]
            times = []
            for rep in range(3):
                _, t = C.timed(torch, lambda: nf.nuts_chains_fused(
                    random.fold_in(k_time, rep), target.logp, v, SLOTS,
                    paired=paired, **kw))
                times.append(t)
            us = float(np.median(times)) / steps * 1e6
            name = "K3" if paired else "K6"
            res.setdefault((which, name), []).append(us)
            print(f"[{card}] {which} {name} d=102 {CHAINS} chains: "
                  f"{us:.2f} us per {'pair' if paired else 'tick'} (reps "
                  + ", ".join(f"{t * 1e3:.2f}" for t in times)
                  + f" ms for {SLOTS} slots)")
    for (which, name), v in res.items():
        print(f"summary {which} {name}: "
              + ", ".join(f"{x:.2f}" for x in v) + " us")
    print(card)


def time_splits(torch, staged_eval, st, x, splits):
    """The staged-code kernel's time per gradient with each chain split
    over ``splits`` blocks (a launch parameter), its layout otherwise."""
    rule = staged_eval.layout
    lay = rule(st, x.shape[1])
    staged_eval.layout = (lambda s, n: type(lay)(
        lay.warps, lay.points, lay.chains, splits))
    try:
        staged_eval.staged_vag(st, x)
        return C.gpu_ms(torch, lambda: staged_eval.staged_vag(st, x), 20)
    finally:
        staged_eval.layout = rule


def sass_summary(job, kernel="staged_stream_kernel") -> str:
    """Opcode counts of ``kernel`` in the built library of ``job``
    (``chip_smoke.sass_functions``): FCHK marks an IEEE division, MUFU a
    reciprocal or logarithm, CALL a division's slow path, STL/LDL local
    memory."""
    instrs = next(v for k, v in C.sass_functions(job).items()
                  if kernel in k)
    counts = C.sass_classes(instrs)[1]
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:12]
    return (f"{len(instrs)} instructions; " + ", ".join(
        f"{k} {v}" for k, v in top) + f"; FCHK {counts.get('FCHK', 0)}, "
        f"MUFU {counts.get('MUFU', 0)}, CALL {counts.get('CALL', 0)}, "
        f"STL {counts.get('STL', 0)}, LDL {counts.get('LDL', 0)}")


def time_fused(torch, nf, random, target, v0, paired, eps):
    """K3 (``paired``) or K6 per leapfrog slot over ``STREAM_SLOTS``
    slots (median of three after a warm call) and the mean tree depth."""
    kw = dict(eps=eps, max_depth=6, collect_idx=0, paired=paired)
    key = random.PRNGKey(3, v0.device)
    vals = nf.nuts_chains_fused(key, target.logp, v0, STREAM_SLOTS, **kw)[0]
    times = []
    for rep in range(3):
        res, t = C.timed(torch, lambda: nf.nuts_chains_fused(
            random.fold_in(key, rep), target.logp, vals, STREAM_SLOTS,
            **kw))
        times.append(t)
    return (float(np.median(times)) / STREAM_SLOTS * 1e3, times,
            float(res[4]["mean_depth"].mean()))


def stream_child(label: str, root: str, point_variants):
    """One tree's stream timings, with the package under ``root``; prints
    them as one JSON line. In a tree with ``scalarize.StreamLayout`` each
    of ``point_variants`` (``scalarize.STREAM_POINTS``, staged anew) is
    timed, and K6 at each of ``STREAM_BLOCK_WARP_VARIANTS`` warps a
    block."""
    sys.path.insert(0, root)
    import torch
    import gen_tpu_torch as tt
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import FlatTarget
    from gen_tpu_torch.ops import _cuda_build, scalarize, staged_eval
    from gen_tpu_torch.ops import nuts_fused as nf

    dev = torch.device("cuda", 0)
    print(f"{label}: gen_tpu_torch from {Path(tt.__file__).parent}",
          flush=True)
    new = hasattr(scalarize, "StreamLayout")
    models = {}
    for n_pts in sorted({n for n, _ in STREAM_SHAPES}):
        model, args, obs, sel, xs, ys = C.stream_setup(torch, tt, dev, n_pts)
        models[n_pts] = (FlatTarget(model.generate(
            random.PRNGKey(1, dev), args, obs)[0], sel), xs, ys)
    out = {"label": label, "staged_ms": {}, "fused_ms_per_slot": {}}
    for points in (point_variants if new else (None,)):
        if points is not None:
            scalarize.STREAM_POINTS = points
        staged = {n: scalarize.stage_scalarized(m[0].logp, 3, dev)
                  for n, m in models.items()}
        nf.stage = (lambda logp, d, device: next(
            staged[n] for n, m in models.items() if m[0].logp == logp))

        def k6_layouts(st):
            """K6's layouts to time: (tag, StreamLayout or None)."""
            if not new:
                return [("", None)]
            w, p = st.layout.warps, st.layout.points
            return [(f" {bw} warps a block",
                     scalarize.StreamLayout(w, p, max(1, bw // w)))
                    for bw in STREAM_BLOCK_WARP_VARIANTS]

        default = {n: getattr(st, "layout", None)
                   for n, st in staged.items()}

        def use(n_pts, lay):
            """K1/K6's layout of the staged model at ``n_pts`` (the
            default for None), its built kernels dropped."""
            if new:
                staged[n_pts].layout = lay or default[n_pts]
            staged[n_pts].libs.clear()

        jobs = [(f"staged code n={n}", staged_eval.build_job(st))
                for n, st in staged.items()]
        for n_pts, _, _ in STREAM_FUSED_SHAPES:
            jobs.append((f"K3 n={n_pts}", nf.build_job(staged[n_pts], 6,
                                                        True)))
            for t, lay in k6_layouts(staged[n_pts]):
                use(n_pts, lay)
                jobs.append((f"K6{t} n={n_pts}",
                             nf.build_job(staged[n_pts], 6, False)))
            use(n_pts, None)
        _cuda_build.build_all([job for _, job in jobs])
        reports = {h: r for h, _, r in _cuda_build.BUILD_LOG}
        tag = "" if points is None else f" P={points}"
        for name, job in jobs:
            rep = reports.get(_cuda_build.source_hash(job[1]), "")
            print(f"{label}{tag} {name} ptxas: " + " | ".join(
                ln.strip() for ln in rep.splitlines()
                if "registers" in ln or "spill" in ln or "smem" in ln),
                flush=True)
        for n_pts, n in STREAM_SHAPES:
            st = staged[n_pts]
            x = C.stream_start(torch, *models[n_pts][1:], n, dev,
                               4).T.contiguous()
            staged_eval.staged_vag(st, x)
            ms = C.gpu_ms(torch, lambda: staged_eval.staged_vag(st, x), 20)
            out["staged_ms"][f"{n_pts}x{n}{tag}"] = ms
            lay = (f" ({staged_eval.layout(st, n)})" if new else "")
            print(f"{label}{tag} staged code n={n_pts}, {n} chains: "
                  f"{ms:.4f} ms per gradient{lay}", flush=True)
            for g in (STREAM_SPLITS.get((n_pts, n), ()) if new else ()):
                ms = time_splits(torch, staged_eval, st, x, g)
                out["staged_ms"][f"{n_pts}x{n}{tag} splits={g}"] = ms
                print(f"{label}{tag} staged code n={n_pts}, {n} chains, "
                      f"{g} splits: {ms:.4f} ms per gradient", flush=True)
        if new:
            print(f"{label}{tag} staged-code kernel SASS: "
                  + sass_summary(staged_eval.build_job(staged[1_000_000])),
                  flush=True)
        for n_pts, n, eps in STREAM_FUSED_SHAPES:
            st = staged[n_pts]
            target, xs, ys = models[n_pts]
            v0 = C.stream_start(torch, xs, ys, n, dev, 5)
            variants = [("K3", True, None)] + [
                ("K6" + t, False, lay) for t, lay in k6_layouts(st)]
            for name, paired, lay in variants:
                use(n_pts, lay)
                per_slot, times, depth = time_fused(
                    torch, nf, random, target, v0, paired, eps)
                shape = f"{name}{tag} n={n_pts}, {n} chains"
                out["fused_ms_per_slot"][shape] = per_slot
                print(f"{label} {shape}: {per_slot:.4f} ms per slot (reps "
                      + ", ".join(f"{t:.3f}" for t in times)
                      + f" s for {STREAM_SLOTS} slots; mean depth "
                      f"{depth:.2f})", flush=True)
            use(n_pts, None)
    print("STREAM_RESULT " + json.dumps(out), flush=True)


def stream_variants(names):
    """This tree's stream kernels under each of ``names`` (keys of
    ``STREAM_VARIANTS``), in turns; prints every timing and a summary."""
    import torch
    import gen_tpu_torch as tt
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import FlatTarget
    from gen_tpu_torch.ops import _cuda_build, scalarize, staged_eval
    from gen_tpu_torch.ops import nuts_fused as nf

    if not torch.cuda.is_available():
        raise RuntimeError("layout_timing.py needs a CUDA device")
    card = C.phase_env(torch)
    dev = torch.device("cuda", 0)
    models, staged = {}, {}
    for n_pts in sorted({n for n, _ in STREAM_SHAPES}):
        model, args, obs, sel, xs, ys = C.stream_setup(torch, tt, dev, n_pts)
        models[n_pts] = (FlatTarget(model.generate(
            random.PRNGKey(1, dev), args, obs)[0], sel), xs, ys)
        staged[n_pts] = scalarize.stage_scalarized(models[n_pts][0].logp, 3,
                                                   dev)
    nf.stage = (lambda logp, d, device: next(
        staged[n] for n, m in models.items() if m[0].logp == logp))
    saved = {k: getattr(scalarize, k) for k in
             ("_CUDA_STREAM", "STREAM_STAGES", "STREAM_SM_WARPS",
              "STREAM_POINTS")}
    layouts = {n: st.layout for n, st in staged.items()}

    def use(name):
        for k, v in saved.items():
            setattr(scalarize, k, v)
        change = STREAM_VARIANTS[name]
        for k, v in change.items():
            if k.isupper():
                setattr(scalarize, k, v)
        if change.get("copy"):
            scalarize._CUDA_STREAM = saved["_CUDA_STREAM"].replace(
                "cp.async.cg", "cp.async." + change["copy"])
        for n, st in staged.items():
            lay = layouts[n]
            st.layout = scalarize.StreamLayout(
                lay.warps, change.get("points", lay.points), lay.chains)
            st._cuda_src.clear()
            st.libs.clear()

    def fused_shapes(name):
        top = STREAM_VARIANTS[name].get("fused_max_pts", 1 << 62)
        return [sh for sh in STREAM_FUSED_SHAPES if sh[0] <= top]

    jobs = []
    for name in names:
        use(name)
        for n_pts, n in STREAM_SHAPES:
            jobs.append((f"{name} staged code {n_pts}x{n}",
                         staged_eval.build_job(staged[n_pts])))
        for n_pts, _, _ in fused_shapes(name):
            for paired in (True, False):
                jobs.append((f"{name} K{3 if paired else 6} {n_pts}",
                             nf.build_job(staged[n_pts], 6, paired)))
    _cuda_build.build_all([job for _, job in jobs])
    reports = {h: r for h, _, r in _cuda_build.BUILD_LOG}
    for label, job in jobs:
        rep = reports.get(_cuda_build.source_hash(job[1]), "")
        print(f"{label} ptxas: " + " | ".join(
            ln.strip() for ln in rep.splitlines()
            if "registers" in ln or "spill" in ln or "smem" in ln)[:300],
            flush=True)
    res = {}
    order = list(names)
    for name in order + order[::-1]:
        use(name)
        for n_pts, n in STREAM_SHAPES:
            st = staged[n_pts]
            x = C.stream_start(torch, *models[n_pts][1:], n, dev,
                               4).T.contiguous()
            staged_eval.staged_vag(st, x)
            ms = C.gpu_ms(torch, lambda: staged_eval.staged_vag(st, x), 20)
            res.setdefault(f"staged code {n_pts}x{n}", {}).setdefault(
                name, []).append(ms)
            print(f"{name} staged code {n_pts}x{n}: {ms:.4f} ms per "
                  f"gradient", flush=True)
        for n_pts, n, eps in fused_shapes(name):
            target, xs, ys = models[n_pts]
            v0 = C.stream_start(torch, xs, ys, n, dev, 5)
            for paired in (True, False):
                per_slot, times, depth = time_fused(
                    torch, nf, random, target, v0, paired, eps)
                shape = f"K{3 if paired else 6} {n_pts}x{n}"
                res.setdefault(shape, {}).setdefault(name, []).append(
                    per_slot)
                print(f"{name} {shape}: {per_slot:.4f} ms per slot "
                      f"(mean depth {depth:.2f})", flush=True)
    for shape, by in res.items():
        print(f"summary {shape}: " + "; ".join(
            f"{name} " + ", ".join(f"{v:.4f}" for v in vs)
            for name, vs in by.items()))
    print(card)


def shared_tape(job, block: int, threads: int):
    """The staged-code kernel's build job ``job`` (blocks of ``block``
    threads) with each scan loop's tape moved from the thread's local
    array to a shared-memory slab for blocks of ``threads`` threads,
    indexed by ``threadIdx.x``."""
    name, src, signatures = job
    src, n_decl = re.subn(r"\n  float (_tape\d+)\[(\d+)\];",
                          rf"\n  __shared__ float \1[\2][{threads}];", src)
    src, n_cells = re.subn(r"(_tape\d+\[_t \* \d+ \+ \d+\])",
                           r"\1[threadIdx.x]", src)
    src, n_block = re.subn(rf"#define SE_BLOCK {block}\b",
                           f"#define SE_BLOCK {threads}", src)
    if not (n_decl and n_cells and n_block == 1):
        raise ValueError("shared_tape: the source has no scan tape to move")
    return name, src, signatures


def ptxas_report(_cuda_build, job) -> str:
    """ptxas's report of ``job``'s library: the one saved beside it, or,
    in a tree that does not save it, the one this process's build logged."""
    if hasattr(_cuda_build, "ptxas_report"):
        return _cuda_build.ptxas_report(job[0], job[1]) or ""
    return {h: r for h, _, r in _cuda_build.BUILD_LOG}.get(
        _cuda_build.source_hash(job[1]), "")


def kalman_child(label: str, root: str):
    """One tree's Kalman timings, with the package under ``root``; prints
    them as one JSON line."""
    sys.path.insert(0, root)
    import torch
    import gen_tpu_torch as tt
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import FlatTarget
    from gen_tpu_torch.ops import _cuda_build, hmc_fused
    from gen_tpu_torch.ops import nuts_fused as nf
    from gen_tpu_torch.ops import staged_eval

    dev = torch.device("cuda", 0)
    print(f"{label}: gen_tpu_torch from {Path(tt.__file__).parent}",
          flush=True)
    out = {"label": label}

    def target_at(T):
        model, args, obs, sel, _ = C.ar1_setup(torch, tt, dev, T)
        return FlatTarget(model.generate(random.PRNGKey(1, dev), args,
                                         obs)[0], sel)

    t1 = target_at(1)
    _, out["stage_s_T1_first"] = C.timed(
        torch, lambda: hmc_fused.stage(t1.logp, 3, dev))
    target = target_at(C.AR1_T)
    st, out["stage_s"] = C.timed(
        torch, lambda: hmc_fused.stage(target.logp, 3, dev))
    out["instructions"] = st.n_instructions
    print(f"{label} staging: T=1 (first trace) {out['stage_s_T1_first']:.2f}"
          f" s, T={C.AR1_T} {out['stage_s']:.2f} s, {st.n_instructions} "
          "staged instructions"
          + (f", loops {st.loop_shape}, tape {4 * st.tape_floats} B a chain"
             if getattr(st, "loops", None) else ""), flush=True)
    # a tree with scan loops also builds the staged-code kernel with the
    # tape in a shared-memory slab, and K1 and K3 asking for one block an SM
    rolled = bool(getattr(st, "loops", None))
    g = torch.Generator(dev).manual_seed(9)
    v0 = (torch.tensor([0.6, -1.2, -0.7], device=dev)
          + 0.05 * torch.randn(C.AR1_CHAINS, 3, device=dev, generator=g))
    xt = v0.T.contiguous()
    key = random.PRNGKey(5, dev)
    kw = dict(n_steps=KALMAN_K1_STEPS, L=KALMAN_L, eps=KALMAN_EPS,
              collect_idx=0)

    def build(tag, shared):
        """Build the staged-code kernel, K1 and K3 (and the shared-tape
        variant); print nvcc seconds, ptxas and the SASS summaries."""
        st.libs.clear()
        getattr(st, "_cuda_src", {}).clear()
        jobs = [("staged code", staged_eval.build_job(st)),
                ("K1", hmc_fused.build_job(st)),
                ("K3", nf.build_job(st, 6, True))]
        if shared:
            jobs.append(("staged code, tape shared",
                         shared_tape(jobs[0][1], staged_eval.BLOCK,
                                     KALMAN_SHARED_BLOCK)))
        _, out[f"build_s{tag}"] = C.timed(torch, lambda: _cuda_build.build_all(
            [job for _, job in jobs]))
        secs_of = {h: secs for h, secs, _ in _cuda_build.BUILD_LOG}
        for name, job in jobs:
            secs = secs_of.get(_cuda_build.source_hash(job[1]), float("nan"))
            out[f"nvcc_s {name}{tag}"] = secs
            print(f"{label} {name}{tag}: nvcc {secs:.2f} s, {len(job[1])} B "
                  "of source; ptxas: " + " | ".join(
                      ln.strip() for ln in ptxas_report(_cuda_build, job)
                      .splitlines()
                      if "registers" in ln or "spill" in ln
                      or "stack" in ln), flush=True)
        print(f"{label} staged-code kernel{tag} SASS: " + sass_summary(
            jobs[0][1], "staged_eval_kernel"), flush=True)
        print(f"{label} K3{tag} SASS: " + sass_summary(
            jobs[2][1], "nuts_pair_kernel"), flush=True)
        return jobs

    def time_staged(places):
        for name, job in places:
            st.libs["staged_eval"] = _cuda_build.build(*job)
            staged_eval.staged_vag(st, xt)
            out[name] = C.gpu_ms(
                torch, lambda: staged_eval.staged_vag(st, xt), 20)
            print(f"{label} {name}: {out[name]:.4f} ms per gradient of "
                  f"{C.AR1_CHAINS} chains", flush=True)
        st.libs.clear()

    def time_k1_k3(tag):
        hmc_fused.hmc_chains_fused(key, target.logp, v0, **kw)
        _, secs = C.timed(torch, lambda: hmc_fused.hmc_chains_fused(
            key, target.logp, v0, **kw))
        out[f"k1_ms_per_step{tag}"] = secs / KALMAN_K1_STEPS * 1e3
        per_slot, times, depth = time_fused(torch, nf, random, target, v0,
                                            True, KALMAN_EPS)
        out[f"k3_ms_per_slot{tag}"] = per_slot
        print(f"{label} K1{tag}: {out[f'k1_ms_per_step{tag}']:.4f} ms per "
              f"step of {KALMAN_L} leapfrogs; K3{tag}: {per_slot:.4f} ms per "
              f"slot (mean depth {depth:.2f})", flush=True)

    jobs = build("", rolled)
    time_staged([("staged_ms", jobs[0][1])] + (
        [("staged_ms tape shared", jobs[3][1])] if rolled else []))
    time_k1_k3("")
    if rolled:
        # K1 and K3 asking ptxas for one block an SM at least
        k1_src, nf_src = hmc_fused.kernel_source, nf.kernel_source
        hmc_fused.kernel_source = lambda s_: k1_src(s_).replace(
            "__launch_bounds__(HMC_BLOCK)",
            "__launch_bounds__(HMC_BLOCK, 1)")
        nf.kernel_source = lambda s_, md, p: re.sub(
            r"__launch_bounds__\(NUTS_BLOCK(, NUTS_MIN_BLOCKS)?\)",
            "__launch_bounds__(NUTS_BLOCK, 1)", nf_src(s_, md, p))
        st.libs.clear()
        bjobs = [hmc_fused.build_job(st), nf.build_job(st, 6, True)]
        _cuda_build.build_all(bjobs)
        for name, job in zip(("K1", "K3"), bjobs):
            print(f"{label} {name} min blocks 1 ptxas: " + " | ".join(
                ln.strip() for ln in ptxas_report(_cuda_build, job)
                .splitlines()
                if "registers" in ln or "spill" in ln), flush=True)
        time_k1_k3(" min blocks 1")
        hmc_fused.kernel_source, nf.kernel_source = k1_src, nf_src
    if label == "this":
        # the run-time reciprocals undone (the residual rule alone, which
        # this model, dividing by no residual constant, does not take)
        from gen_tpu_torch.ops import scalarize
        saved = scalarize.REPEATED_DIVISIONS
        scalarize.REPEATED_DIVISIONS = 10 ** 9
        try:
            tag = " [residual rule only]"
            jobs = build(tag, False)
            time_staged([(f"staged_ms{tag}", jobs[0][1])])
            time_k1_k3(tag)
        finally:
            scalarize.REPEATED_DIVISIONS = saved
            st.libs.clear()
            st._cuda_src.clear()
    print("KALMAN_RESULT " + json.dumps(out), flush=True)


def kalman_main(other: Path):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("layout_timing.py needs a CUDA device")
    card = C.phase_env(torch)
    here = Path(__file__).resolve().parent
    roots = {"other": other.resolve(), "this": here}
    results = []
    for which in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, __file__, "--kalman-child",
                               which, str(roots[which])],
                              capture_output=True, text=True, cwd=here)
        print(proc.stdout, end="")
        if proc.returncode != 0:
            print(proc.stderr[-6000:])
            raise RuntimeError(f"the {which} tree's timing failed")
        results += [json.loads(ln.split(" ", 1)[1])
                    for ln in proc.stdout.splitlines()
                    if ln.startswith("KALMAN_RESULT ")]
    for which in ("other", "this"):
        rows = [r for r in results if r["label"] == which]
        for k in rows[0]:
            if k != "label":
                print(f"summary {which} {k}: " + ", ".join(
                    f"{r[k]:.4f}" for r in rows))
    print(card)


def stream_main(other: Path, point_variants):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("layout_timing.py needs a CUDA device")
    card = C.phase_env(torch)
    here = Path(__file__).resolve().parent
    roots = {"other": other.resolve(), "this": here}
    results = []
    for which in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, __file__, "--stream-child",
                               which, str(roots[which]),
                               *map(str, point_variants)],
                              capture_output=True, text=True, cwd=here)
        print(proc.stdout, end="")
        if proc.returncode != 0:
            print(proc.stderr[-6000:])
            raise RuntimeError(f"the {which} tree's timing failed")
        results += [json.loads(ln.split(" ", 1)[1])
                    for ln in proc.stdout.splitlines()
                    if ln.startswith("STREAM_RESULT ")]
    for key in ("staged_ms", "fused_ms_per_slot"):
        for which in ("other", "this"):
            rows = [r[key] for r in results if r["label"] == which]
            for shape in rows[0]:
                print(f"summary {which} {key} {shape}: "
                      + ", ".join(f"{r[shape]:.4f}" for r in rows))
    print(card)


def _setting(module, name, value):
    """A variant of ``--k1``: ``module.name = value`` in the package
    (``module`` relative to ``gen_tpu_torch.ops``); returns the undo."""
    def change(modules):
        mod = modules[f"gen_tpu_torch.ops.{module}"]
        saved = getattr(mod, name)
        setattr(mod, name, value)
        return lambda: setattr(mod, name, saved)
    return change


def _bounds(blocks_by_d):
    """A variant of ``--k1``: K1 built asking ptxas for
    ``blocks_by_d[d]`` blocks an SM (``__launch_bounds__``' second
    argument) for a model of ``d`` coordinates."""
    def change(modules):
        hf = modules["gen_tpu_torch.ops.hmc_fused"]
        source = hf.kernel_source

        def edited(staged):
            src = source(staged)
            if staged.d not in blocks_by_d:
                return src
            return src.replace(
                "__launch_bounds__(HMC_BLOCK)",
                f"__launch_bounds__(HMC_BLOCK, {blocks_by_d[staged.d]})")
        hf.kernel_source = edited
        return lambda: setattr(hf, "kernel_source", source)
    return change


def _eps_in_loop():
    """A variant of ``--k1``: K1 with the jittered step size drawn by every
    chain in its step loop (one Philox call a step, as before the prologue
    kernel existed) in place of ``hmc_eps_kernel``'s table; injected step
    sizes are still read from the table."""
    edits = [
        ("int n, int n_steps, int L, int collect_idx,",
         "int n, int n_steps, int L, float eps, float eps_jitter, "
         "int collect_idx,"),
        ("    const float eps_s = __ldg(eps_tab + s);\n",
         "    float eps_s;\n    if (INJECTED) {\n"
         "      eps_s = __ldg(eps_tab + s);\n    } else {\n"
         "      const uint4 jb = philox4x32_10(make_uint4(0xFFFFFFFFu, s, 0u,"
         " 0u), key);\n      eps_s = eps * (1.0f - eps_jitter + 2.0f * "
         "eps_jitter * u01(jb.x));\n    }\n"),
        ("n_steps, L, collect_idx, seed0,",
         "n_steps, L, eps, eps_jitter, collect_idx, seed0,"),
        ("  if (!injected) {\n    hmc_eps_kernel<<<",
         "  if (false) {\n    hmc_eps_kernel<<<")]

    def change(modules):
        hf = modules["gen_tpu_torch.ops.hmc_fused"]
        source = hf.kernel_source

        def edited(staged):
            src = source(staged)
            for old, new in edits:
                if src.count(old) != 1:
                    raise RuntimeError(f"K1's source lacks {old!r}")
                src = src.replace(old, new)
            return src
        hf.kernel_source = edited
        return lambda: setattr(hf, "kernel_source", source)
    return change


# variants of this tree's K1 timed beside it: one design step undone, or
# another launch shape (the regression is d = 3, eight_schools d = 10)
K1_VARIANTS = {
    "residual rule only": _setting("scalarize", "REPEATED_DIVISIONS",
                                   10 ** 9),
    "repeated from 2 divisions": _setting("scalarize",
                                          "REPEATED_DIVISIONS", 2),
    "step size drawn in the loop": _eps_in_loop(),
    "block 256": _setting("hmc_fused", "BLOCK", 256),
    "8 and 4 blocks an SM asked": _bounds({3: 8, 10: 4}),
}


def k1_models(torch, tt, dev):
    """(name, logp, d, chains, L, eps, collect_idx, prior start, start near
    the posterior) of the headline regression and eight_schools d = 10:
    the prior starts drawn with fixed keys (the identity check's, whose
    first steps also meet extreme values), the others from the exact
    posterior moments, each coordinate normal (the timed calls' state, as
    the main paths' after warmup)."""
    from gen_tpu_torch import random
    from gen_tpu_torch._verify import exact_posterior_moments, schools_exact
    from gen_tpu_torch.inference import FlatTarget

    def near(tr, sel, moments, n, seed):
        paths, offsets = C.flat_layout(tt, tr, sel)
        mean = np.concatenate([np.atleast_1d(moments[p][0]) for p in paths])
        sd = np.concatenate([np.atleast_1d(moments[p][1]) for p in paths])
        z = np.random.default_rng(seed).standard_normal((n, len(mean)))
        return torch.tensor((mean + sd * z).astype(np.float32), device=dev)

    model, X, obs, sel, xs, ys = C.regression_setup(torch, tt, dev)
    tr = model.generate(random.PRNGKey(1, dev), (X,), obs)[0]
    mb, sb, ml, sl = exact_posterior_moments(
        np.stack([xs, np.ones_like(xs)], axis=1), ys)
    moments = {("slope",): (mb[0], sb[0]), ("intercept",): (mb[1], sb[1]),
               ("log_noise",): (ml, sl)}
    v_reg = C.init_values(torch, model, (X,), obs, sel, random.split(
        random.PRNGKey(12, dev), C.N_CHAINS))
    m10, a10, o10, s10 = C.schools_setup(torch, tt, C.YS_8, C.SIGMAS_8, dev)
    tr10 = m10.generate(random.PRNGKey(1, dev), a10, o10)[0]
    n10, l10, e10 = K1_D10
    v10 = C.init_values(torch, m10, a10, o10, s10, random.split(
        random.PRNGKey(11, dev), n10))
    return [("regression", FlatTarget(tr, sel).logp, 3, C.N_CHAINS, C.L,
             C.EPS, 0, v_reg, near(tr, sel, moments, C.N_CHAINS, 1)),
            ("eight_schools d=10", FlatTarget(tr10, s10).logp, 10, n10,
             l10, e10, None, v10,
             near(tr10, s10, schools_exact(C.YS_8, C.SIGMAS_8), n10, 2))]


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def k1_child(label: str, root: str):
    """One tree's K1 census, digests and timings, with the package under
    ``root``; prints them as one JSON line."""
    sys.path.insert(0, root)
    import torch
    import gen_tpu_torch as tt
    from gen_tpu_torch import random
    from gen_tpu_torch.ops import _cuda_build, hmc_fused

    dev = torch.device("cuda", 0)
    print(f"{label}: gen_tpu_torch from {Path(tt.__file__).parent}",
          flush=True)
    models = k1_models(torch, tt, dev)
    staged = {m[0]: hmc_fused.stage(m[1], m[2], dev) for m in models}
    variants = {"": None}
    if label == "this":
        variants.update(K1_VARIANTS)
    out = {"label": label}
    for vname, change in variants.items():
        restore = change(sys.modules) if change else None
        try:
            k1_variant(torch, random, _cuda_build, hmc_fused, models,
                       staged, vname, out, label)
        except Exception as e:      # a variant that fails is reported only
            if not vname:
                raise
            print(f"{label} [{vname}] failed: {type(e).__name__}: "
                  f"{str(e)[-3000:]}", flush=True)
        finally:
            if restore:
                restore()
    print("K1_RESULT " + json.dumps(out), flush=True)


def k1_variant(torch, random, _cuda_build, hmc_fused, models, staged, vname,
               out, label):
    """K1 of this build (``vname`` names a variant; "" the tree as it is):
    build, census, digests and timings of both models into ``out``."""
    tag = f" [{vname}]" if vname else ""
    for st in staged.values():
        st.libs.clear()
        getattr(st, "_cuda_src", {}).clear()
    jobs = {name: hmc_fused.build_job(staged[name]) for name, *_ in models}
    _cuda_build.build_all(list(jobs.values()))
    key = random.PRNGKey(5, models[0][-1].device)
    for name, logp, d, n, L_, eps, cidx, v0, v_post in models:
        cen = C.k1_census(jobs[name], cidx is None, L_)
        waves, eff = C.k1_waves(cen, n)
        print(f"{label}{tag} K1 {name}: {cen.get('registers')} registers, "
              f"{cen.get('spill_bytes')} B spills, {cen.get('stack_bytes')} "
              f"B stack, block {cen['block']}, {cen.get('blocks_per_sm')} "
              f"blocks an SM, {waves:.2f} waves at {n} chains "
              f"({eff:.1%} of the last round busy); SASS per chain-step "
              f"{cen['per_chain_step']} on the hot path (leapfrog "
              f"{cen['leapfrog']} x {L_} + {cen['step_rest']}; static "
              f"{cen['static_per_chain_step']}, leapfrog "
              f"{cen['static_leapfrog']}), MUFU {cen['mufu_per_leapfrog']} "
              "and "
              f"FCHK {cen['fchk_per_leapfrog']} per leapfrog; leapfrog "
              f"classes {cen['leapfrog_classes']}; rest of the step "
              f"{cen['step_rest_classes']}", flush=True)
        print(f"{label}{tag} K1 {name} leapfrog opcodes: "
              f"{cen['leapfrog_ops']}; rest {cen['step_rest_ops']}",
              flush=True)
        kw = dict(L=L_, eps=eps, collect_idx=cidx)
        res = hmc_fused.hmc_chains_fused(key, logp, v0, K1_CHECK_STEPS, **kw)
        dig = digest(*res)
        vals, _, acc = hmc_fused.hmc_chains_fused(
            random.fold_in(key, 1), logp, v_post, K1_STEPS, **kw)
        times = []
        for rep in range(3):
            _, t = C.timed(torch, lambda: hmc_fused.hmc_chains_fused(
                random.fold_in(key, 2 + rep), logp, vals, K1_STEPS, **kw))
            times.append(t)
        us = float(np.median(times)) / K1_STEPS * 1e6
        # the SM clock under this load: calls queued for a few tenths of a
        # second, read while they run
        for rep in range(max(1, int(0.3 / min(times)))):
            hmc_fused.hmc_chains_fused(random.fold_in(key, 9), logp, vals,
                                       K1_STEPS, **kw)
        clock = float(np.median([C.sm_clock_mhz() for _ in range(3)]))
        torch.cuda.synchronize()
        ib = C.issue_bound_ms(cen["per_chain_step"], n, clock) * 1e3
        rate = (cen["per_chain_step"] * n / 32
                / (us * 1e-6 * clock * 1e6 * C.SM_COUNT))
        print(f"{label}{tag} K1 {name}: {us:.2f} us per step of {n} chains "
              f"(reps " + ", ".join(f"{t * 1e3:.2f}" for t in times)
              + f" ms for {K1_STEPS} steps; accept "
              f"{float(acc.mean()) / K1_STEPS:.3f}); SM clock {clock:.0f} "
              "MHz; issue "
              f"bound {ib:.2f} us; {rate:.2f} warp instructions per clock "
              f"an SM; digest {dig}", flush=True)
        out[f"{name}{tag}"] = dict(
            us=us, digest=dig, mhz=clock, issue_bound_us=ib, rate=rate,
            waves=waves, busy=eff, **{k: cen.get(k) for k in (
                "registers", "spill_bytes", "stack_bytes", "block",
                "blocks_per_sm", "per_chain_step", "leapfrog",
                "static_per_chain_step", "static_leapfrog",
                "mufu_per_leapfrog", "fchk_per_leapfrog",
                "lds_per_leapfrog")})


def k1_main(other: Path):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("layout_timing.py needs a CUDA device")
    card = C.phase_env(torch)
    here = Path(__file__).resolve().parent
    roots = {"other": other.resolve(), "this": here}
    results = []
    for which in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, __file__, "--k1-child",
                               which, str(roots[which])],
                              capture_output=True, text=True, cwd=here)
        print(proc.stdout, end="")
        if proc.returncode != 0:
            print(proc.stderr[-6000:])
            raise RuntimeError(f"the {which} tree's timing failed")
        results += [json.loads(ln.split(" ", 1)[1])
                    for ln in proc.stdout.splitlines()
                    if ln.startswith("K1_RESULT ")]
    digests = {}
    for r in results:
        for shape, v in r.items():
            if shape != "label":
                digests.setdefault(shape.split(" [")[0], set()).add(
                    v["digest"])
    for shape, ds in digests.items():
        print(f"K1 {shape}: outputs of every run "
              + ("identical" if len(ds) == 1 else f"DIFFER {sorted(ds)}"))
    for which in ("other", "this"):
        rows = [r for r in results if r["label"] == which]
        for shape in rows[0]:
            if shape != "label":
                print(f"summary {which} {shape}: us per step "
                      + ", ".join(f"{r[shape]['us']:.2f}" for r in rows)
                      + "; " + ", ".join(
                          f"{k} {rows[0][shape][k]}" for k in (
                              "registers", "spill_bytes", "blocks_per_sm",
                              "waves", "per_chain_step",
                              "static_per_chain_step", "mufu_per_leapfrog",
                              "fchk_per_leapfrog", "lds_per_leapfrog")))
    print(card)
    if any(len(ds) > 1 for ds in digests.values()):
        raise RuntimeError("K1's outputs differ between the trees")


def _thread_cap(registers):
    """A variant of ``--thread``: the "thread" layout asking ptxas for as
    many blocks an SM as ``registers`` registers a thread allow, whatever
    the shared memory allows."""
    def change(modules):
        nf = modules["gen_tpu_torch.ops.nuts_fused"]
        shape = nf.thread_shape

        def capped(*a, **k):
            block, blocks, smem = shape(*a, **k)
            return block, max(blocks, 65536 // (block * registers)), smem
        nf.thread_shape = capped
        return lambda: setattr(nf, "thread_shape", shape)
    return change


def _constants_hoisted():
    """A variant of ``--thread``: the block's constants no longer read at
    an offset the compiler cannot see (``opaque_zero`` replaced by 0), so
    that it may keep them in registers across the chain's loop."""
    def change(modules):
        nf = modules["gen_tpu_torch.ops.nuts_fused"]
        source = nf.kernel_source

        def edited(staged, md, paired):
            src = source(staged, md, paired)
            if nf.kernel_layout(staged) != "thread":
                return src
            if "o = opaque_zero();" not in src:
                raise RuntimeError("the thread layout lacks opaque_zero")
            return src.replace("o = opaque_zero();", "o = 0;")
        nf.kernel_source = edited
        return lambda: setattr(nf, "kernel_source", source)
    return change


# variants of this tree's "thread" layout timed beside it
THREAD_VARIANTS = {
    "blocks of 32": _setting("nuts_fused", "THREAD_BLOCKS", (32,)),
    "blocks of 64": _setting("nuts_fused", "THREAD_BLOCKS", (64,)),
    "blocks of 128": _setting("nuts_fused", "THREAD_BLOCKS", (128,)),
    "ptxas's own registers": _setting("nuts_fused", "THREAD_REGS", 255),
    "at most 128 registers": _thread_cap(128),
    "constants hoisted": _constants_hoisted(),
}


def thread_models(torch, tt, dev):
    """``{d: (logp, chains)}`` of ``THREAD_MODELS``, each the schools model
    (eight_schools' data for 8 schools, ``chip_smoke.make_schools``
    otherwise) as a flat target."""
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import FlatTarget
    out = {}
    for k, chains in THREAD_MODELS:
        ys, sig = ((C.YS_8, C.SIGMAS_8) if k == 8
                   else C.make_schools(k, seed=0))
        model, args, obs, sel = C.schools_setup(torch, tt, ys, sig, dev)
        out[k + 2] = (model, args, obs, sel, chains, FlatTarget(
            model.generate(random.PRNGKey(1, dev), args, obs)[0], sel))
    return out


def thread_warm(path: Path):
    """Warm every model of ``THREAD_MODELS`` up once (ChEES, this tree's
    package) and save the states, step sizes and inverse masses to
    ``path`` for every process."""
    import torch
    import gen_tpu_torch as tt
    from gen_tpu_torch import random
    from gen_tpu_torch.inference import chees_hmc_warmup_and_sample

    dev = torch.device("cuda", 0)
    states = {}
    for d, (model, args, obs, sel, chains, _) in thread_models(
            torch, tt, dev).items():
        k_init, k_warm = random.split(random.PRNGKey(d, dev))
        traces, _ = torch.func.vmap(lambda k: model.generate(k, args, obs))(
            random.split(k_init, chains))
        _, values, winfo = chees_hmc_warmup_and_sample(
            k_warm, traces, sel, num_warmup=C.NUTS_WARMUP, num_samples=1,
            target_accept=0.8)
        states[d] = dict(values=values.cpu(),
                         eps=float(winfo["step_size"]),
                         inv_mass=winfo["inv_mass"].cpu())
        print(f"warmup d={d} at {chains} chains: eps {states[d]['eps']:.4f}",
              flush=True)
        del traces
    torch.save(states, path)


def thread_child(label: str, root: str, warm: str):
    """One tree's K3 and K6 census, digests and timings in the one-thread
    layout, with the package under ``root`` and the warmed states in
    ``warm``; prints them as one JSON line."""
    sys.path.insert(0, root)
    import torch
    import gen_tpu_torch as tt
    from gen_tpu_torch import random
    from gen_tpu_torch.ops import _cuda_build
    from gen_tpu_torch.ops import nuts_fused as nf

    dev = torch.device("cuda", 0)
    print(f"{label}: gen_tpu_torch from {Path(tt.__file__).parent}",
          flush=True)
    if hasattr(nf, "THREAD_MAX_D"):
        nf.THREAD_MAX_D = 32
    models = thread_models(torch, tt, dev)
    states = torch.load(warm)
    staged = {d: nf.stage(m[5].logp, d, dev) for d, m in models.items()}
    variants = {"": None}
    if label == "this":
        variants.update(THREAD_VARIANTS)
    out = {"label": label}
    for vname, change in variants.items():
        restore = change(sys.modules) if change else None
        try:
            thread_variant(torch, random, _cuda_build, nf, models, staged,
                           states, vname, out, label)
        except Exception as e:      # a variant that fails is reported only
            if not vname:
                raise
            print(f"{label} [{vname}] failed: {type(e).__name__}: "
                  f"{str(e)[-3000:]}", flush=True)
        finally:
            if restore:
                restore()
    print("THREAD_RESULT " + json.dumps(out), flush=True)


def thread_variant(torch, random, _cuda_build, nf, models, staged, states,
                   vname, out, label):
    """K3 and K6 of this build (``vname`` names a variant; "" the tree as it
    is) on every model: build, census, digests and timings into ``out``."""
    tag = f" [{vname}]" if vname else ""
    for st in staged.values():
        st.libs.clear()
    jobs = {(d, p): nf.build_job(staged[d], 8, p) for d in models
            for p in (True, False)}
    _cuda_build.build_all(list(jobs.values()))
    for (d, paired), job in jobs.items():
        chains = models[d][4]
        kname = "K3" if paired else "K6"
        layout = nf.kernel_layout(staged[d])
        print(f"{label}{tag} {kname} d={d} ({layout} layout) ptxas: "
              + " | ".join(ln.strip() for ln in ptxas_report(
                  _cuda_build, job).splitlines()
                  if "registers" in ln or "spill" in ln), flush=True)
        cen = C.nuts_census(job, chains)
        for which, c in cen.items():
            print(f"{label}{tag} {kname} d={d} collect {which}: "
                  + C.census_line(c), flush=True)
        s = states[d]
        v0 = s["values"].to(torch.device("cuda", 0))
        kw = dict(eps=s["eps"], max_depth=8,
                  inv_mass_diag=s["inv_mass"].to(v0.device), paired=paired)
        logp = models[d][5].logp
        key = random.PRNGKey(7, v0.device)
        digests = {}
        for cidx in (0, None):
            res = nf.nuts_chains_fused(key, logp, v0, THREAD_CHECK_SLOTS,
                                       collect_idx=cidx, **kw)
            digests["one" if cidx == 0 else "all"] = digest(
                res[0], res[1], res[2], res[3], *res[4].values())
        steps = SLOTS // 2 if paired else SLOTS
        vals = nf.nuts_chains_fused(random.fold_in(key, 1), logp, v0,
                                    SLOTS, collect_idx=0, **kw)[0]
        times = []
        for rep in range(3):
            res, t = C.timed(torch, lambda: nf.nuts_chains_fused(
                random.fold_in(key, 2 + rep), logp, vals, SLOTS,
                collect_idx=0, **kw))
            times.append(t)
        us = float(np.median(times)) / steps * 1e6
        depth = float(res[4]["mean_depth"].mean())
        print(f"{label}{tag} {kname} d={d} {chains} chains: {us:.2f} us per "
              f"{'pair' if paired else 'tick'} (reps "
              + ", ".join(f"{x * 1e3:.2f}" for x in times)
              + f" ms for {SLOTS} slots; mean depth {depth:.2f}); digests "
              f"{digests}", flush=True)
        out[f"{kname} d={d}{tag}"] = dict(
            us=us, digests=digests, layout=layout, **{
                k: cen["one"][k] for k in (
                    "registers", "spill_bytes", "shared_bytes",
                    "blocks_per_sm", "warps_per_sm", "waves", "LDL", "STL",
                    "LDS", "STS", "MUFU")})


def thread_main(other: Path):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("layout_timing.py needs a CUDA device")
    card = C.phase_env(torch)
    here = Path(__file__).resolve().parent
    roots = {"other": other.resolve(), "this": here}
    with tempfile.TemporaryDirectory() as tmp:
        warm = Path(tmp) / "warm.pt"
        thread_warm(warm)
        torch.cuda.empty_cache()
        results = []
        for which in ("other", "this", "this", "other"):
            proc = subprocess.run(
                [sys.executable, __file__, "--thread-child", which,
                 str(roots[which]), str(warm)],
                capture_output=True, text=True, cwd=here)
            print(proc.stdout, end="")
            if proc.returncode != 0:
                print(proc.stderr[-6000:])
                raise RuntimeError(f"the {which} tree's timing failed")
            results += [json.loads(ln.split(" ", 1)[1])
                        for ln in proc.stdout.splitlines()
                        if ln.startswith("THREAD_RESULT ")]
    digests = {}
    for r in results:
        for name, v in r.items():
            if name != "label":
                for which, dg in v["digests"].items():
                    digests.setdefault((name.split(" [")[0], which),
                                       set()).add(dg)
    for (name, which), ds in digests.items():
        print(f"{name} collect {which}: outputs of every run "
              + ("identical" if len(ds) == 1 else f"DIFFER {sorted(ds)}"))
    for which in ("other", "this"):
        rows = [r for r in results if r["label"] == which]
        for name in rows[0]:
            if name != "label":
                print(f"summary {which} {name}: us "
                      + ", ".join(f"{r[name]['us']:.2f}" for r in rows
                                  if name in r)
                      + "; " + ", ".join(
                          f"{k} {rows[0][name][k]}" for k in (
                              "layout", "registers", "spill_bytes",
                              "shared_bytes", "warps_per_sm", "LDL", "STL",
                              "LDS", "STS", "MUFU"))
                      + f", waves {rows[0][name]['waves']:.2f}")
    print(card)
    if any(len(ds) > 1 for ds in digests.values()):
        raise RuntimeError("K3's or K6's outputs differ between the trees")


def _median_ms(fn, reps):
    import torch
    fn()
    return float(np.median([C.gpu_ms(torch, fn, reps) for _ in range(3)]))


def _with_define(src: str, name: str, value: int) -> str:
    """``src`` with ``#define name <value>``."""
    out, n = re.subn(rf"#define {name} \d+", f"#define {name} {value}", src)
    if n != 1:
        raise ValueError(f"no single #define {name}")
    return out


def small_shapes(rs, cat, n, k, srcs):
    """(K4 positions a block, threads, blocks, shared bytes at n particles)
    and (K5 lanes a row, threads, blocks at (n, k)) under the sources
    ``srcs``; the earlier tree's launch shapes where its modules have no
    ``launch_shape``."""
    k4 = rs.launch_shape(n, srcs[0]) if hasattr(rs, "launch_shape") else \
        (256, 256, -(-n // 256), 0)
    k5 = cat.launch_shape(n, k, srcs[1]) if hasattr(cat, "launch_shape") \
        else (32, 256, -(-n // 8))
    return k4, k5


def small_run(torch, random, rs, cat, floor, label, tag, out):
    """Digests, census and timings of one build of K4 and K5 (the
    modules' ``build`` as they stand) into ``out[tag]``."""
    dev = torch.device("cuda", 0)
    res = dict(k4={}, k5={})
    rng = np.random.default_rng(5)
    h4 = hashlib.sha256()
    for dtype in (torch.float32, torch.float64):
        for n in SMALL_K4_NS:
            for case in ("random", "zero_runs", "dominant"):
                lw = torch.tensor(C.k4_log_weights(n, case, rng),
                                  dtype=dtype)
                cdf = rs.normalized_cdf(lw).to(dev)   # made on the host
                for u in C.K4_US:
                    ut = torch.tensor(u, dtype=dtype, device=dev)
                    h4.update(rs.resample_cdf(cdf, ut).cpu().numpy()
                              .tobytes())
                if dtype == torch.float32:
                    ut = torch.tensor(0.5, dtype=dtype, device=dev)
                    res["k4"][f"{n} {case}"] = _median_ms(
                        lambda: rs.resample_cdf(cdf, ut), C.K4_REPS) * 1e3
    res["k4_digest"] = h4.hexdigest()[:16]
    h5 = hashlib.sha256()
    key = random.PRNGKey(9, dev)
    key_arg = cat._key_words(key) if hasattr(cat, "_key_words") else key
    for n, k in C.K5_SHAPES + (C.K5_TIMED_ONLY,):
        logits, _ = C.k5_inputs(torch, n, k, dev, n * k)
        h5.update(cat.batched_categorical(key, logits).cpu().numpy()
                  .tobytes())
        logits = torch.nan_to_num(logits)
        res["k5"][f"{n}x{k}"] = dict(
            kernel=_median_ms(lambda: cat._categorical_op(
                logits, key_arg, None, n), 20) * 1e3,
            wrapper=_median_ms(lambda: cat.batched_categorical(key, logits),
                               20) * 1e3)
    res["k5_digest"] = h5.hexdigest()[:16]
    res["floor_us_100"] = _median_ms(floor, C.K4_REPS) * 1e3
    res["floor_us_20"] = _median_ms(floor, 20) * 1e3
    for name, v in res["k4"].items():
        print(f"{label}{tag} K4 {name} float32: {v:.2f} us", flush=True)
    for name, v in res["k5"].items():
        print(f"{label}{tag} K5 {name}: kernel {v['kernel']:.2f} us, wrapper "
              f"{v['wrapper']:.2f} us", flush=True)
    print(f"{label}{tag} launch floor {res['floor_us_100']:.2f} us (100 "
          f"launches), {res['floor_us_20']:.2f} us (20); digests K4 "
          f"{res['k4_digest']}, K5 {res['k5_digest']}", flush=True)
    out[tag or "tree"] = res


def small_census(_cuda_build, rs, cat, label, tag, jobs):
    """ptxas's numbers of K4's and K5's functions, and the launch shapes
    and waves of K4 at ``SMALL_K4_NS`` and K5 at its shapes."""
    fns = {}
    for job in jobs:
        fns.update(C.ptxas_functions(_cuda_build.ptxas_report(job[0],
                                                              job[1]) or ""))
    for name, f in fns.items():
        print(f"{label}{tag} ptxas {name}: {f['registers']} registers, "
              f"{f['spill_bytes']} B spills, {f['stack_bytes']} B stack",
              flush=True)
    srcs = (jobs[0][1], jobs[1][1])
    f4 = next(v for k, v in fns.items() if "resample" in k and "IfE" in k)
    for n in SMALL_K4_NS:
        (run, threads, blocks, smem), _ = small_shapes(rs, cat, n, 1, srcs)
        per_sm, waves = C.small_waves(blocks, threads, f4["registers"],
                                      smem)
        print(f"{label}{tag} K4 at {n}: {blocks} blocks of {threads}, {run} "
              f"positions a block, {per_sm} blocks an SM, {waves:.2f} waves",
              flush=True)
    for n, k in C.K5_SHAPES + (C.K5_TIMED_ONLY,):
        _, (g, threads, blocks) = small_shapes(rs, cat, n, k, srcs)
        f5 = [v for kk, v in fns.items() if "categorical" in kk
              and "ILb0E" in kk and (f"Li{g}E" in kk or "Li" not in kk)]
        per_sm, waves = C.small_waves(blocks, threads, f5[0]["registers"], 0)
        print(f"{label}{tag} K5 ({n}, {k}): {g} lanes a row, {blocks} "
              f"blocks of {threads}, {f5[0]['registers']} registers, "
              f"{per_sm} blocks an SM, {waves:.2f} waves", flush=True)


def small_child(label: str, root: str):
    """One tree's K4 and K5 (and this tree's variants), with the package
    under ``root``; prints the results as one JSON line."""
    sys.path.insert(0, root)
    import torch
    import gen_tpu_torch as tt
    from gen_tpu_torch import random
    from gen_tpu_torch.ops import _cuda_build
    from gen_tpu_torch.ops import categorical as cat
    from gen_tpu_torch.ops import resample as rs

    dev = torch.device("cuda", 0)
    print(f"{label}: gen_tpu_torch from {Path(tt.__file__).parent}",
          flush=True)
    here = Path(__file__).resolve().parent
    floor_job = ("launch_floor", (here / "gen_tpu_torch" / "ops" / "csrc" /
                                  "launch_floor.cu").read_text(),
                 {"launch_floor": [ctypes.c_void_p, ctypes.c_void_p]})
    base = {"resample": rs.build_job(), "categorical": cat.build_job()}
    variants = {"": {}}
    if label == "this":
        variants.update(SMALL_VARIANTS)
    jobs = {}
    for vname, change in variants.items():
        jobs[vname] = dict(base)
        for (which, define), value in change.items():
            name, src, sigs = jobs[vname][which]
            jobs[vname][which] = (name, _with_define(src, define, value),
                                  sigs)
    _cuda_build.build_all([floor_job] + [j for v in jobs.values()
                                         for j in v.values()])
    floor_lib = _cuda_build.build(*floor_job)

    def floor():
        with torch.cuda.device(dev):
            o = torch.empty(1, dtype=torch.int32, device=dev)
            rc = floor_lib.launch_floor(
                o.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _cuda_build.check_launch(rc, "launch_floor")

    out = {"label": label}
    for vname, vjobs in jobs.items():
        tag = f" [{vname}]" if vname else ""
        libs = {w: _cuda_build.build(*j) for w, j in vjobs.items()}
        rs.build, cat.build = (lambda: libs["resample"]), \
            (lambda: libs["categorical"])
        small_census(_cuda_build, rs, cat, label, tag,
                     [vjobs["resample"], vjobs["categorical"]])
        small_run(torch, random, rs, cat, floor, label, tag, out)
    print("SMALL_RESULT " + json.dumps(out), flush=True)


def small_main(other: Path):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("layout_timing.py needs a CUDA device")
    card = C.phase_env(torch)
    here = Path(__file__).resolve().parent
    roots = {"other": other.resolve(), "this": here}
    results = []
    for which in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, __file__, "--small-child",
                               which, str(roots[which])],
                              capture_output=True, text=True, cwd=here)
        print(proc.stdout, end="")
        if proc.returncode != 0:
            print(proc.stderr[-6000:])
            raise RuntimeError(f"the {which} tree's timing failed")
        results += [json.loads(ln.split(" ", 1)[1])
                    for ln in proc.stdout.splitlines()
                    if ln.startswith("SMALL_RESULT ")]
    digests = {}
    for r in results:
        for tag, v in r.items():
            if tag != "label":
                for kname in ("k4_digest", "k5_digest"):
                    digests.setdefault(kname, set()).add(v[kname])
    for kname, ds in digests.items():
        print(f"{kname[:2].upper()}: outputs of every run and variant "
              + ("identical" if len(ds) == 1 else f"DIFFER {sorted(ds)}"))
    for which in ("other", "this"):
        rows = [r for r in results if r["label"] == which]
        for tag in rows[0]:
            if tag == "label":
                continue
            v0 = rows[0][tag]
            for name in v0["k4"]:
                print(f"summary {which} {tag} K4 {name}: us "
                      + ", ".join(f"{r[tag]['k4'][name]:.2f}" for r in rows))
            for name in v0["k5"]:
                print(f"summary {which} {tag} K5 {name}: kernel us "
                      + ", ".join(f"{r[tag]['k5'][name]['kernel']:.2f}"
                                  for r in rows)
                      + "; wrapper us " + ", ".join(
                          f"{r[tag]['k5'][name]['wrapper']:.2f}"
                          for r in rows))
            print(f"summary {which} {tag} launch floor us (100 launches) "
                  + ", ".join(f"{r[tag]['floor_us_100']:.2f}" for r in rows)
                  + "; (20) " + ", ".join(f"{r[tag]['floor_us_20']:.2f}"
                                          for r in rows))
    print(card)
    if any(len(ds) > 1 for ds in digests.values()):
        raise RuntimeError("K4's or K5's outputs differ between the trees")


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--stream":
        stream_main(Path(sys.argv[2]), tuple(int(a) for a in sys.argv[3:])
                    or STREAM_POINT_VARIANTS)
    elif len(sys.argv) == 3 and sys.argv[1] == "--k1":
        k1_main(Path(sys.argv[2]))
    elif len(sys.argv) == 4 and sys.argv[1] == "--k1-child":
        k1_child(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 3 and sys.argv[1] == "--thread":
        thread_main(Path(sys.argv[2]))
    elif len(sys.argv) == 5 and sys.argv[1] == "--thread-child":
        thread_child(sys.argv[2], sys.argv[3], sys.argv[4])
    elif len(sys.argv) == 3 and sys.argv[1] == "--small":
        small_main(Path(sys.argv[2]))
    elif len(sys.argv) == 4 and sys.argv[1] == "--small-child":
        small_child(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 3 and sys.argv[1] == "--kalman":
        kalman_main(Path(sys.argv[2]))
    elif len(sys.argv) == 4 and sys.argv[1] == "--kalman-child":
        kalman_child(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--stream-variants"]:
        stream_variants(sys.argv[2:] or list(STREAM_VARIANTS))
    elif len(sys.argv) >= 5 and sys.argv[1] == "--stream-child":
        stream_child(sys.argv[2], sys.argv[3],
                     tuple(int(a) for a in sys.argv[4:]))
    elif len(sys.argv) == 2:
        main(Path(sys.argv[1]))
    else:
        sys.exit(__doc__)
