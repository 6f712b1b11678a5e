"""Profiling and timing utilities.

Counterpart: ``gen_tpu/profiling.py``, all of it. ``profile_trace`` goes
over ``torch.profiler`` (CPU activity, and CUDA activity where a card is
present) and writes a Chrome trace into ``logdir``, which also holds the
kernels' names. ``timed`` and ``time_fn`` wait for the card at their ends,
as gen_tpu's wait on ``jax.block_until_ready``: an asynchronous launch
would otherwise be timed as free. On the CPU they are plain wall clocks.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch
import torch.utils._pytree as pytree


def _block(value=None):
    """Wait for every CUDA device that ``value`` has a tensor on (every
    initialized device when ``value`` is None)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return
    devices = {x.device for x in pytree.tree_leaves(value)
               if isinstance(x, torch.Tensor) and x.is_cuda}
    if value is None or not devices:
        torch.cuda.synchronize()
        return
    for d in devices:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def profile_trace(logdir: str = None):
    """Capture a device trace: ``with profile_trace(dir): run()``, then
    open ``dir/trace_<pid>_<ns>.json`` in Perfetto or chrome://tracing.
    ``logdir`` defaults to a folder under the temporary directory."""
    from torch.profiler import ProfilerActivity, profile
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "gen_tpu_torch_profile")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield logdir
    finally:
        _block()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def timed(label: str = "block", results: dict = None):
    """Wall-clock a block, waiting for the card's work at exit (for the
    devices of ``out["value"]`` when the block sets it)."""
    t0 = time.perf_counter()
    out = {}
    try:
        yield out
    finally:
        _block(out.get("value"))
        elapsed = time.perf_counter() - t0
        out["seconds"] = elapsed
        if results is not None:
            results[label] = elapsed


def time_fn(fn, *args, warmup: int = 1, iters: int = 10, **kwargs):
    """Time a function: ``warmup`` calls first (kernel builds, caches),
    then the mean of ``iters`` calls. Returns (seconds per call, last
    output)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _block(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _block(out)
    return (time.perf_counter() - t0) / iters, out
