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
"""

import sys
from pathlib import Path

import numpy as np

import chip_smoke as C

CHAINS = 32768
SLOTS = 2000


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


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(Path(sys.argv[1]))
