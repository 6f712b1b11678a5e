"""The launch floor: an empty CUDA kernel, launched as K4 and K5 are.

No counterpart in gen_tpu. :func:`launch_floor` allocates its output with
``torch.empty`` and launches ``csrc/launch_floor.cu`` through ``ctypes``
on the current stream, as :func:`gen_tpu_torch.ops.resample.resample_cdf`
and :func:`gen_tpu_torch.ops.categorical.batched_categorical` launch their
kernels; its device time is the least that any single launch takes, which
``chip_smoke.py`` and ``layout_timing.py --small`` print beside the small
kernels' times. It lies on no path of the system.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from . import _cuda_build

_CSRC = Path(__file__).resolve().parent / "csrc" / "launch_floor.cu"
_SIGNATURES = {"launch_floor": [ctypes.c_void_p, ctypes.c_void_p]}


def build_job():
    """``(name, source, signatures)`` for :func:`_cuda_build.build_all`."""
    return ("launch_floor", _CSRC.read_text(), _SIGNATURES)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once per source) and load the kernel library."""
    return _cuda_build.build(*build_job())


def launch_floor(device) -> torch.Tensor:
    """Launch the empty kernel once on ``device`` (a CUDA device); returns
    its (unwritten) one-element output."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"launch_floor: needs a CUDA device, not {device}")
    lib = build()
    with torch.cuda.device(device):
        out = torch.empty(1, dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.launch_floor(out.data_ptr(), stream)
    _cuda_build.check_launch(rc, "launch_floor")
    return out
