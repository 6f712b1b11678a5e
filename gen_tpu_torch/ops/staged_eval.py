"""The staged model code on its own: one value-and-gradient per chain.

No counterpart function in gen_tpu: there the staged code (``plane_vag``,
with its stream loops ``_stream_loop``/``_stream_loop_hbm`` and the
unrolled scan/cholesky/triangular_solve) exists only inside the fused
Pallas kernels. Here the same ``staged_vag`` that
:mod:`gen_tpu_torch.ops.scalarize` writes into K1, K3 and K6 is also built
into a kernel of its own (``csrc/staged_eval.cu``), which evaluates it
once per chain. That times the staged code per gradient and holds it to its
torch rendering (:meth:`StagedLogp.vag`) without a sampler around it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import _cuda_build, scalarize
from .scalarize import StagedLogp, block_size

BLOCK = 128
_CSRC = Path(__file__).resolve().parent / "csrc" / "staged_eval.cu"
_SIGNATURES = {"staged_eval_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


def build_job(staged: StagedLogp):
    """``(name, source, signatures)`` for :func:`_cuda_build.build_all`."""
    defines = (f"#define SE_D {staged.d}\n#define SE_R {staged.n_res}\n"
               f"#define SE_BLOCK {block_size(staged, BLOCK)}\n"
               f"#define SE_LANES {staged.lanes}")
    src = (_CSRC.read_text().replace("// @@DEFINES@@", defines)
           .replace("// @@STAGED_VAG@@", staged.cuda_source()))
    return ("staged_eval", src, _SIGNATURES)


def staged_vag(staged: StagedLogp, x: torch.Tensor):
    """``(lp (n,), grad (d, n))`` at the ``(d, n)`` float32 points ``x``: the
    kernel on a CUDA tensor, :meth:`StagedLogp.vag` on a CPU tensor."""
    if x.device.type == "cpu":
        return staged.vag(x)
    d, n = x.shape
    if "staged_eval" not in staged.libs:
        staged.libs["staged_eval"] = _cuda_build.build(*build_job(staged))
    lib = staged.libs["staged_eval"]
    x = x.to(torch.float32).contiguous()
    with torch.cuda.device(x.device):
        lp = torch.empty((n,), dtype=torch.float32, device=x.device)
        g = torch.empty((d, n), dtype=torch.float32, device=x.device)
        res = staged.res_consts.to(x.device).contiguous()
        sd = scalarize.stream_table(staged, x.device)
        rc = lib.staged_eval_launch(
            x.data_ptr(), lp.data_ptr(), g.data_ptr(), res.data_ptr(),
            None if sd is None else sd.data_ptr(), staged.n_pts, n,
            torch.cuda.current_stream(x.device).cuda_stream)
    _cuda_build.check_launch(rc, "staged_eval")
    staged_vag.launches += 1
    return lp, g


staged_vag.launches = 0
