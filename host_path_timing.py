"""Time two paths of the port that run as plain torch ops on one NVIDIA GPU,
in two trees of the package: the posterior summary that
``sample_posterior`` returns (``diagnostics.summarize``) and float64
``random.normal``. Run from the repository root on a machine with a CUDA
card:

    python3 host_path_timing.py OTHER_ROOT

``OTHER_ROOT`` holds another ``gen_tpu_torch`` package (for example
``git archive <commit> gen_tpu_torch | tar -x -C OTHER_ROOT``). Each tree
runs in its own process, in the order other, this, this, other, so that
both share the card. Each process times, after one warm call, ``REPEATS``
calls of:

- ``summarize`` of a ``(500, 131072, 3)`` float32 pool of normals and of
  a ``(500, 131072)`` pool of integers 0-4 held as float32 (a discrete
  entry: long runs of tied values), the two kinds of entry
  ``sample_posterior`` summarizes;
- ``random.normal`` of 131,072 float64 lanes.

Times are wall-clock seconds around a synchronized call (the summary
reads its results back to the host). Prints every time, the median of
each, and the card's name and power limit.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPEATS = 5
DRAWS, CHAINS, COORDS = 500, 131072, 3
NORMAL_LANES = 131072


def measure():
    """Time both paths with the ``gen_tpu_torch`` found first on the path;
    prints one JSON line of lists of seconds."""
    import torch
    from gen_tpu_torch import diagnostics, random

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cont = torch.randn(DRAWS, CHAINS, COORDS, device=dev, generator=gen)
    disc = torch.randint(0, 5, (DRAWS, CHAINS), device=dev,
                         generator=gen).to(torch.float32)
    key = random.PRNGKey(0, dev)

    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def summary():
        for leaf in (cont, disc):
            out = diagnostics.summarize({"x": leaf})["x"]
            [v.tolist() for v in out.values()]

    paths = {"summarize": summary,
             "normal_f64": lambda: random.normal(key, (NORMAL_LANES,),
                                                 torch.float64)}
    times = {}
    for name, fn in paths.items():
        wall(fn)
        times[name] = [wall(fn) for _ in range(REPEATS)]
    print(json.dumps({"package": os.path.dirname(
        os.path.dirname(os.path.abspath(diagnostics.__file__))),
        "times": times}))


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        sys.path.insert(0, sys.argv[2])
        measure()
        return
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("host_path_timing.py needs a CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(sys.argv[1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    runs = {"other": [], "this": []}
    for label, root in (("other", other), ("this", here), ("this", here),
                        ("other", other)):
        out = subprocess.run([sys.executable, __file__, "--measure", root],
                             capture_output=True, text=True, check=True,
                             cwd=root)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{label} ({res['package']}): " + ", ".join(
            f"{k} " + " ".join(f"{t:.4f}" for t in v)
            for k, v in res["times"].items()))
        runs[label].append(res["times"])
    for label, got in runs.items():
        print(f"{label} median: " + ", ".join(
            f"{k} {statistics.median(t for g in got for t in g[k]):.4f} s"
            for k in got[0]))


if __name__ == "__main__":
    main()
