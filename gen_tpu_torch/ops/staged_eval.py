"""The staged model code on its own: one value-and-gradient per chain.

No counterpart function in gen_tpu: there the staged code (``plane_vag``,
with its stream loops ``_stream_loop``/``_stream_loop_hbm`` and the
unrolled scan/cholesky/triangular_solve) exists only inside the fused
Pallas kernels. Here the same staged code that
:mod:`gen_tpu_torch.ops.scalarize` writes into K1, K3 and K6 is also built
into a kernel of its own, which evaluates it once per chain. That times
the staged code per gradient and holds it to its torch rendering
(:meth:`StagedLogp.vag`) without a sampler around it, and the fused
engines' ChEES warmup evaluates its population through it.

- Without a stream loop: ``csrc/staged_eval.cu``, a thread per chain
  (the Kalman model's scan loops inside it).
- A streamed likelihood: ``csrc/staged_stream.cu`` in the layout
  :func:`~gen_tpu_torch.ops.scalarize.eval_layout` picks for the call's
  chain and point counts (a warp per chain, up to 8 chains a block sharing
  the data tiles, and each chain's tiles split over several blocks when
  chains are few, their partial sums added in block order by a second
  kernel). Its order of sums is its own: the plain version is
  ``staged.vag(x, layout)`` in that layout (:func:`staged_vag_plain`), and
  it differs in the last bits from K1's, K3's and K6's, whose layouts are
  fixed when they are built (``staged.layout``). Nothing needs the two to
  agree bit for bit: the ChEES warmup that runs on this kernel hands the
  fused kernels a step size, a mass matrix and positions, which they take
  as inputs, and each kernel is held to its own plain version.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import _cuda_build, scalarize
from .scalarize import EVAL_BLOCK_CHAINS, LANES, StagedLogp

BLOCK = 128
_CSRC = Path(__file__).resolve().parent / "csrc"
_SIGNATURES = {"staged_eval_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p]}
_STREAM_SIGNATURES = {"staged_stream_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


def layout(staged: StagedLogp, n_chains: int) -> scalarize.StreamLayout:
    """The stream layout of a call on ``n_chains`` chains."""
    return scalarize.eval_layout(staged.n_pts, len(staged.stream_data),
                                 n_chains)


def build_job(staged: StagedLogp):
    """``(name, source, signatures)`` for :func:`_cuda_build.build_all`:
    one source per staged program, whatever the chain count (the layout's
    chains a block and splits are launch parameters)."""
    if not staged.streams:
        defines = (f"#define SE_D {staged.d}\n#define SE_R {staged.n_res}\n"
                   f"#define SE_BLOCK {BLOCK}")
        src = ((_CSRC / "staged_eval.cu").read_text()
               .replace("// @@DEFINES@@", defines)
               .replace("// @@STAGED_VAG@@", staged.cuda_source()))
        return ("staged_eval", src, _SIGNATURES)
    defines = (f"#define SE_D {staged.d}\n#define SE_R {staged.n_res}\n"
               f"#define SE_K {len(staged.sums)}\n"
               f"#define SE_THREADS {LANES * EVAL_BLOCK_CHAINS}")
    src = ((_CSRC / "staged_stream.cu").read_text()
           .replace("// @@DEFINES@@", defines)
           .replace("// @@STAGED_VAG@@",
                    staged.cuda_source(layout(staged, 1))))
    return ("staged_stream", src, _STREAM_SIGNATURES)


def staged_vag_plain(staged: StagedLogp, x: torch.Tensor):
    """The kernel's plain version: :meth:`StagedLogp.vag` in the kernel's
    layout for ``x.shape[1]`` chains."""
    if not staged.streams:
        return staged.vag(x)
    return staged.vag(x, layout(staged, int(x.shape[1])))


def staged_vag(staged: StagedLogp, x: torch.Tensor):
    """``(lp (n,), grad (d, n))`` at the ``(d, n)`` float32 points ``x``: the
    kernel on a CUDA tensor, :func:`staged_vag_plain` on a CPU tensor."""
    if x.device.type == "cpu":
        return staged_vag_plain(staged, x)
    d, n = x.shape
    name = "staged_stream" if staged.streams else "staged_eval"
    if name not in staged.libs:
        staged.libs[name] = _cuda_build.build(*build_job(staged))
    lib = staged.libs[name]
    x = x.to(torch.float32).contiguous()
    with torch.cuda.device(x.device):
        lp = torch.empty((n,), dtype=torch.float32, device=x.device)
        g = torch.empty((d, n), dtype=torch.float32, device=x.device)
        res = staged.res_consts.to(x.device).contiguous()
        sd = scalarize.stream_table(staged, x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if staged.streams:
            lay = layout(staged, n)
            part = torch.empty((n, lay.splits, len(staged.sums))
                               if lay.splits > 1 else (1,),
                               dtype=torch.float32, device=x.device)
            rc = lib.staged_stream_launch(
                x.data_ptr(), lp.data_ptr(), g.data_ptr(), part.data_ptr(),
                res.data_ptr(), sd.data_ptr(), staged.n_pts, n, lay.chains,
                lay.splits, stream)
        else:
            rc = lib.staged_eval_launch(
                x.data_ptr(), lp.data_ptr(), g.data_ptr(), res.data_ptr(), n,
                stream)
    _cuda_build.check_launch(rc, name)
    staged_vag.launches += 1
    return lp, g


staged_vag.launches = 0
