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
instantiations). Prints the staging and
``nvcc`` seconds, each kernel's ptxas report, the staged-code kernel's
SASS opcode counts, every timing, a summary, and the card's name and
power limit.
"""

import json
import re
import subprocess
import sys
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
    builds = {"other": (other.resolve(), layouts or (lambda s: "thread")),
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


def sass_summary(_cuda_build, job, kernel="staged_stream_kernel") -> str:
    """Opcode counts of ``kernel`` in the built library of ``job``
    (``cuobjdump -sass``): FCHK marks an IEEE division, MUFU a reciprocal
    or logarithm, CALL a division's slow path, STL/LDL local memory."""
    so = (_cuda_build.BUILD_DIR
          / f"{job[0]}_{_cuda_build.source_hash(job[1])}.so")
    tool = Path(_cuda_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    body = text.split(kernel)[-1]
    ops = [re.sub(r"^@!?U?P[T0-9]+\s+", "",
                  ln.split("*/", 1)[1].strip()).split()[0]
           for ln in body.splitlines()
           if ln.strip().startswith("/*") and "*/" in ln and ";" in ln]
    counts = {}
    for op in ops:
        counts[op.split(".")[0]] = counts.get(op.split(".")[0], 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:12]
    return (f"{len(ops)} instructions; " + ", ".join(
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
                  + sass_summary(_cuda_build, staged_eval.build_job(
                      staged[1_000_000])), flush=True)
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
    jobs = [("staged code", staged_eval.build_job(st)),
            ("K1", hmc_fused.build_job(st)),
            ("K3", nf.build_job(st, 6, True))]
    if rolled:
        jobs.append(("staged code, tape shared",
                     shared_tape(jobs[0][1], staged_eval.BLOCK,
                                 KALMAN_SHARED_BLOCK)))
    _, out["build_s"] = C.timed(torch, lambda: _cuda_build.build_all(
        [job for _, job in jobs]))
    secs_of = {h: secs for h, secs, _ in _cuda_build.BUILD_LOG}
    for name, job in jobs:
        secs = secs_of.get(_cuda_build.source_hash(job[1]), float("nan"))
        out[f"nvcc_s {name}"] = secs
        print(f"{label} {name}: nvcc {secs:.2f} s, {len(job[1])} B of "
              "source; ptxas: " + " | ".join(
                  ln.strip() for ln in ptxas_report(_cuda_build, job)
                  .splitlines()
                  if "registers" in ln or "spill" in ln or "stack" in ln),
              flush=True)
    print(f"{label} staged-code kernel SASS: " + sass_summary(
        _cuda_build, jobs[0][1], "staged_eval_kernel"), flush=True)
    g = torch.Generator(dev).manual_seed(9)
    v0 = (torch.tensor([0.6, -1.2, -0.7], device=dev)
          + 0.05 * torch.randn(C.AR1_CHAINS, 3, device=dev, generator=g))
    xt = v0.T.contiguous()
    places = [("staged_ms", jobs[0][1])] + (
        [("staged_ms tape shared", jobs[3][1])] if rolled else [])
    for key, job in places:
        st.libs["staged_eval"] = _cuda_build.build(*job)
        staged_eval.staged_vag(st, xt)
        out[key] = C.gpu_ms(torch, lambda: staged_eval.staged_vag(st, xt),
                            20)
        print(f"{label} {key}: {out[key]:.4f} ms per gradient of "
              f"{C.AR1_CHAINS} chains", flush=True)
    st.libs.clear()
    key = random.PRNGKey(5, dev)
    kw = dict(n_steps=KALMAN_K1_STEPS, L=KALMAN_L, eps=KALMAN_EPS,
              collect_idx=0)
    k1_src, nf_src = hmc_fused.kernel_source, nf.kernel_source
    for tag, bounds in [("", False)] + ([(" min blocks 1", True)] if rolled
                                         else []):
        if bounds:
            # K1 and K3 asking ptxas for one block an SM at least
            hmc_fused.kernel_source = lambda s_: k1_src(s_).replace(
                "__launch_bounds__(HMC_BLOCK)",
                "__launch_bounds__(HMC_BLOCK, 1)")
            nf.kernel_source = lambda s_, md, p: nf_src(s_, md, p).replace(
                "__launch_bounds__(NUTS_BLOCK)",
                "__launch_bounds__(NUTS_BLOCK, 1)")
            st.libs.clear()
            jobs = [hmc_fused.build_job(st), nf.build_job(st, 6, True)]
            _cuda_build.build_all(jobs)
            for name, job in zip(("K1", "K3"), jobs):
                print(f"{label} {name}{tag} ptxas: " + " | ".join(
                    ln.strip() for ln in ptxas_report(_cuda_build, job)
                    .splitlines()
                    if "registers" in ln or "spill" in ln), flush=True)
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
    hmc_fused.kernel_source, nf.kernel_source = k1_src, nf_src
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


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--stream":
        stream_main(Path(sys.argv[2]), tuple(int(a) for a in sys.argv[3:])
                    or STREAM_POINT_VARIANTS)
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
