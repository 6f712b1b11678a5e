"""Time the fused engines' ChEES warmup two ways on one NVIDIA GPU.

``sample_posterior``'s fused engines (``hmc_fused``, ``nuts_fused``) warm up
with ChEES over the whole population. On the card the population's value
and gradient come from the staged-code kernel (``ops/staged_eval.py``, one
launch per evaluation); the other way, gen_tpu's and the CPU's, is
``torch.func.vmap`` of the model's torch logp. Run from the repository root
on a machine with a CUDA card:

    python3 warmup_timing.py [--models eight_schools,stream,stream_big,ar1]

For each model, at the width ``chip_smoke.py`` drives it: the staging time;
the ``nvcc`` time of the staged-code kernel (what a first call builds on top
of the engine's own kernel) and of K3 for the same model (built either way);
the wall time of one population evaluation each way; and
``chees_warmup_flat`` both ways from the same population and key at the
same iteration count, with the evaluations it made. One JSON line per
model, then the card's name and power limit.
"""

import argparse
import json
import sys
import time

import chip_smoke as C

# (name, chains, ChEES iterations, K3 max_depth): the widths and warmup
# lengths of chip_smoke.py's paths, but for two that the vmapped way cannot
# finish in a call: the n = 10^6 warmup is cut to 50 iterations
# (chip_smoke.py runs 250), the AR(1) warmup to 20 (400)
MODELS = {
    "eight_schools": (131072, 400, 8),
    "stream": (C.STREAM_CHAINS, 200, 6),
    "stream_big": (C.STREAM_WARM_CHAINS, 50, 6),
    "ar1": (C.AR1_CHAINS, 20, 8),
}
EVAL_REPS = 5


def setup(torch, tt, dev, name):
    """``(model, args, obs, sel)`` of ``name``."""
    if name == "eight_schools":
        return C.schools_setup(torch, tt, C.YS_8, C.SIGMAS_8, dev)
    if name == "stream":
        return C.stream_setup(torch, tt, dev, C.STREAM_N)[:4]
    if name == "stream_big":
        return C.stream_setup(torch, tt, dev, C.STREAM_N_BIG)[:4]
    return C.ar1_setup(torch, tt, dev)[:4]


def counted(fn):
    """``fn`` with a call count in ``.calls``."""
    def wrapped(xs):
        wrapped.calls += 1
        return fn(xs)
    wrapped.calls = 0
    return wrapped


def per_eval_s(torch, fn, xs):
    """Wall seconds per call of ``fn(xs)``, synchronized, after one warm
    call."""
    fn(xs)
    _, secs = C.timed(torch, lambda: [fn(xs) for _ in range(EVAL_REPS)])
    return secs / EVAL_REPS


def time_model(torch, tt, dev, name):
    from torch.func import vmap

    from gen_tpu_torch import random
    from gen_tpu_torch.inference import FlatTarget
    from gen_tpu_torch.inference.chees import chees_warmup_flat
    from gen_tpu_torch.inference.sample import _staged_population_vag
    from gen_tpu_torch.ops import _cuda_build, hmc_fused, staged_eval
    from gen_tpu_torch.ops import nuts_fused as nf

    chains, iters, depth = MODELS[name]
    model, args, obs, sel = setup(torch, tt, dev, name)
    xs0 = C.init_values(torch, model, args, obs, sel,
                        random.split(random.PRNGKey(5, dev), chains))
    target = FlatTarget(model.generate(random.PRNGKey(1, dev), args,
                                       obs)[0], sel)
    st, stage_s = C.timed(torch, lambda: hmc_fused.stage(
        target.logp, target.dim, dev))

    def nvcc_s(job):
        """Seconds of this job's nvcc, 0.0 when an earlier model built the
        same source."""
        n_log = len(_cuda_build.BUILD_LOG)
        _cuda_build.build(*job)
        return sum(s for _, s, _ in _cuda_build.BUILD_LOG[n_log:])

    nvcc_eval = nvcc_s(staged_eval.build_job(st))
    nvcc_k3 = nvcc_s(nf.build_job(st, depth, True))

    ways = {"staged": _staged_population_vag(target, xs0.dtype),
            "vmap": vmap(target.value_and_grad)}
    out = dict(model=name, chains=chains, d=target.dim,
               chees_iterations=iters, stage_s=stage_s,
               nvcc_staged_eval_s=nvcc_eval, nvcc_k3_s=nvcc_k3)
    for way, fn in ways.items():
        out[f"{way}_eval_ms"] = per_eval_s(torch, fn, xs0) * 1e3
    key = random.PRNGKey(7, dev)
    for way, fn in ways.items():
        fn = counted(fn)
        (_, _, info), secs = C.timed(torch, lambda: chees_warmup_flat(
            key, target.value_and_grad, xs0, num_warmup=iters,
            num_samples=1, batched_vag=fn))
        out[f"{way}_warmup_s"] = secs
        out[f"{way}_warmup_evals"] = fn.calls
        out[f"{way}_step_size"] = float(info["step_size"])
    out["warmup_speedup"] = out["vmap_warmup_s"] / out["staged_warmup_s"]
    out["first_call_gain_s"] = (out["vmap_warmup_s"] - out["staged_warmup_s"]
                                - nvcc_eval)
    return out


def main(argv=None):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("warmup_timing.py needs a CUDA device")
    import gen_tpu_torch as tt

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--models", default=",".join(MODELS))
    names = p.parse_args(argv).models.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = C.phase_env(torch)
    t0 = time.perf_counter()
    for name in names:
        print(json.dumps(time_model(torch, tt, dev, name)), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(card)


if __name__ == "__main__":
    sys.exit(main())
