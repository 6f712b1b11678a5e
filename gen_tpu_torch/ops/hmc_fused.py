"""Fused many-chain HMC: the whole sampling run as one CUDA kernel launch.

Counterpart: ``gen_tpu/ops/hmc_fused.py::hmc_chains_fused`` (kernel K1,
``_kernel``). The TPU kernel kept a block of chains resident in VMEM for
all ``n_steps x L`` leapfrogs; the Hopper kernel
(``csrc/hmc_fused.cu``) keeps each chain in one thread's registers for the
same span. The model's value and gradient is staged by
:mod:`gen_tpu_torch.ops.scalarize` and spliced into the kernel source as a
straight-line ``__device__`` function.

Where PyTorch and Hopper forced differences:

- Dispatch is by the device of ``values0`` and nothing else: a CUDA tensor
  launches the kernel (a failed build or launch raises; nothing falls back),
  a CPU tensor runs the plain twin :func:`hmc_chains_fused_plain`. There is
  no ``use_pallas``-style switch.
- The TPU-only machinery (the ``(d, 8, n/8)`` plane layout, ``VMEM_LIMIT``,
  the VMEM envelope estimator, ``auto_tile_hmc``'s v5e table) is not
  ported. The layout is ``(d, n)`` with chains contiguous; the public API
  stays ``(n, d)``. The chunked runner :func:`hmc_chains_fused_chunked`
  sizes its chunks by a device-memory budget for the history
  (``HIST_BUDGET_BYTES``) instead of the VMEM envelope.
- The kernel is built on first use with ``nvcc`` for ``sm_90a``
  (:mod:`._cuda_build`, shared with the fused NUTS kernel), keyed by a
  hash of the generated source, and bound through a plain C entry point
  with ``ctypes``.
- The kernel's PRNG is Philox seeded from the key's two words, so its
  draws differ from the twin's (which uses :mod:`gen_tpu_torch.random`);
  with ``injected_rng`` both consume the same numbers and agree.
- A streamed likelihood (``StagedLogp.stream_data``) runs in
  ``StagedLogp.layout`` (:class:`~gen_tpu_torch.ops.scalarize.StreamLayout`):
  one to eight warps per chain by the data length, and several chains a
  block that read the data tiles from one ring of shared memory, as
  gen_tpu's ``stream_hbm`` variant DMA'd tiles into VMEM. The loop is
  bound by its per-point arithmetic; each lane evaluates a block of points
  as independent instructions and Kahan-adds the block's total. The
  block's barriers need every chain of the block, so a CUDA launch fills
  the last block with copies of the last chain and drops them. gen_tpu's
  ``use_pallas=None`` dispatch (stream models to the XLA twin below a
  TPU-measured crossover) is not ported: on CUDA the kernel runs.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from pathlib import Path
from typing import Callable, Optional

import torch

from .. import random
from ..utils import sqrt_mass_safe
from . import _cuda_build, scalarize
from .scalarize import (StagedLogp, block_size, pad_chains,
                        stage_scalarized)

# threads (chains) per block: at the 64 registers ptxas gives the
# headline regression's kernel, 8 blocks an SM and 3.88 waves of the
# H100's 132 SMs at 524,288 chains (256 measured the same; PERF.md)
BLOCK = 128
HIST_BUDGET_BYTES = 8 << 30    # device memory for one chunk's history
_CSRC = Path(__file__).resolve().parent / "csrc" / "hmc_fused.cu"
_TINY = 1.1754944e-38

_STAGED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def stage(logp: Callable, d: int, device) -> StagedLogp:
    """``stage_scalarized(logp, d, device)``, cached per logp function."""
    per_fn = _STAGED.setdefault(logp, {})
    key = (d, str(torch.device(device)))
    if key not in per_fn:
        per_fn[key] = stage_scalarized(logp, d, device)
    return per_fn[key]


def kernel_source(staged: StagedLogp) -> str:
    """The kernel's CUDA source with the staged program spliced in."""
    defines = (f"#define HMC_D {staged.d}\n#define HMC_R {staged.n_res}\n"
               f"#define HMC_BLOCK {block_size(staged, BLOCK)}\n"
               f"#define HMC_LANES {staged.lanes}")
    return (_cuda_build.csrc_text(_CSRC).replace("// @@DEFINES@@", defines)
            .replace("// @@STAGED_VAG@@", staged.cuda_source()))


_SIGNATURES = {"hmc_fused_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p]}


def build_job(staged: StagedLogp):
    """``(name, source, signatures)`` for :func:`_cuda_build.build_all`."""
    return ("hmc_fused", kernel_source(staged), _SIGNATURES)


def build(staged: StagedLogp) -> ctypes.CDLL:
    """Compile (once per generated source) and load the kernel library;
    kept with ``staged``, so that a launch renders no source."""
    if "hmc_fused" not in staged.libs:
        staged.libs["hmc_fused"] = _cuda_build.build(*build_job(staged))
    return staged.libs["hmc_fused"]


def _prepare(logp, values0, inv_mass_diag, injected_rng, n_steps,
             collect_idx):
    if not isinstance(values0, torch.Tensor) or values0.ndim != 2 \
            or 0 in values0.shape:
        raise ValueError("values0 must be a non-empty (n_chains, d) tensor")
    device = values0.device
    n, d = values0.shape
    if collect_idx is not None and not 0 <= collect_idx < d:
        raise ValueError(f"collect_idx {collect_idx} out of range for d={d}")
    staged = stage(logp, d, device)
    vt = values0.to(torch.float32).T.contiguous()
    inv = (torch.ones(d, dtype=torch.float32, device=device)
           if inv_mass_diag is None else
           torch.as_tensor(inv_mass_diag, dtype=torch.float32,
                           device=device).reshape(d).contiguous())
    inj = None
    if injected_rng is not None:
        eps_steps, z, u = injected_rng

        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        inj = (dev(eps_steps).reshape(n_steps).contiguous(),
               dev(z).reshape(n_steps, n, d).permute(0, 2, 1).contiguous(),
               dev(u).reshape(n_steps, n).contiguous())
    return staged, vt, inv, inj


def _outputs(vout, hist, acc, collect_idx):
    collected = hist if collect_idx is not None else hist.permute(0, 2, 1)
    return vout.T, collected, acc


def hmc_chains_fused(key, logp: Callable, values0: torch.Tensor,
                     n_steps: int, L: int = 10, eps: float = 0.1,
                     eps_jitter: float = 0.2,
                     collect_idx: Optional[int] = 0, inv_mass_diag=None,
                     injected_rng=None):
    """Run ``n_steps`` full HMC updates on the ``(n_chains, d)`` float32
    state ``values0``.

    Returns ``(values (n, d), collected, accept_counts (n,))``;
    ``collected`` is ``(n_steps, n)`` holding coordinate ``collect_idx``
    after each step, or ``(n_steps, n, d)`` (a strided view) when
    ``collect_idx=None``. ``logp`` maps a ``(d,)`` tensor to a scalar, e.g.
    ``FlatTarget(...).logp``; it is staged once per function and device.
    ``inv_mass_diag``: optional ``(d,)`` inverse-mass diagonal (0 freezes a
    coordinate). ``injected_rng=(step_sizes (n_steps,), z (n_steps, n, d),
    u (n_steps, n))`` replaces the kernel's Philox draws, which makes the
    kernel and its twin agree step for step.

    A CUDA ``values0`` launches the kernel; a CPU ``values0`` runs
    :func:`hmc_chains_fused_plain`."""
    if values0.device.type == "cpu":
        return hmc_chains_fused_plain(
            key, logp, values0, n_steps, L, eps, eps_jitter, collect_idx,
            inv_mass_diag, injected_rng)
    if values0.device.type != "cuda":
        raise ValueError(f"hmc_chains_fused: unsupported device "
                         f"{values0.device}")
    staged, vt, inv, inj = _prepare(logp, values0, inv_mass_diag,
                                    injected_rng, n_steps, collect_idx)
    d, n = vt.shape
    lib = build(staged)
    # a stream layout's blocks hold whole groups of chains: the kernel runs
    # n_k chains, copies of the last one past n, and drops the copies
    c = staged.layout.chains if staged.streams else 1
    n_k = -(-n // c) * c
    vt = pad_chains(vt, n_k)
    if inj is not None:
        inj = (inj[0], pad_chains(inj[1], n_k), pad_chains(inj[2], n_k))
    with torch.cuda.device(vt.device):
        vout = torch.empty_like(vt)
        hist = torch.empty((n_steps, n_k) if collect_idx is not None
                           else (n_steps, d, n_k), dtype=torch.float32,
                           device=vt.device)
        acc = torch.empty((n_k,), dtype=torch.float32, device=vt.device)
        # the step sizes: the caller's, or a table the kernel's prologue
        # fills from the key
        eps_tab = inj[0] if inj is not None else torch.empty(
            (n_steps,), dtype=torch.float32, device=vt.device)
        seed0, seed1 = (int(w) for w in key.reshape(-1)[:2].tolist())
        res = staged.res_consts.contiguous()
        sd = scalarize.stream_table(staged, vt.device)
        stream = torch.cuda.current_stream(vt.device).cuda_stream
        rc = lib.hmc_fused_launch(
            vt.data_ptr(), vout.data_ptr(), hist.data_ptr(), acc.data_ptr(),
            res.data_ptr(), inv.data_ptr(),
            None if sd is None else sd.data_ptr(), staged.n_pts, n_k,
            n_steps, L, float(eps),
            float(eps_jitter), -1 if collect_idx is None else collect_idx,
            seed0, seed1, eps_tab.data_ptr(),
            *([t.data_ptr() for t in inj[1:]] if inj is not None
              else [None, None]), stream)
    _cuda_build.check_launch(rc, "hmc_fused")
    hmc_chains_fused.launches += 1
    scalarize.count_body_launch(staged)
    return _outputs(vout[:, :n], hist[..., :n], acc[:n], collect_idx)


hmc_chains_fused.launches = 0


def hmc_chains_fused_plain(key, logp: Callable, values0: torch.Tensor,
                           n_steps: int, L: int = 10, eps: float = 0.1,
                           eps_jitter: float = 0.2,
                           collect_idx: Optional[int] = 0,
                           inv_mass_diag=None, injected_rng=None):
    """The kernel's plain PyTorch twin, on any device: the same loop and the
    same roundings, coordinate by coordinate, through the torch rendering
    of the staged program. Without ``injected_rng`` it draws its step
    sizes, momenta and accept uniforms with :mod:`gen_tpu_torch.random`."""
    staged, vt, inv, inj = _prepare(logp, values0, inv_mass_diag,
                                    injected_rng, n_steps, collect_idx)
    d, n = vt.shape
    device = vt.device
    inv_k = list(inv)
    msc_k = list(sqrt_mass_safe(inv))

    def kinetic(m):
        k = (inv_k[0] * m[0]) * m[0]
        for j in range(1, d):
            k = k + (inv_k[j] * m[j]) * m[j]
        return 0.5 * k

    v = list(vt)
    lp, gs = staged.vag(vt)
    g = list(gs)
    acc = torch.zeros((n,), dtype=torch.float32, device=device)
    hist = []
    step_keys = None if inj is not None else random.split(key.to(device),
                                                           n_steps)
    for s in range(n_steps):
        if inj is not None:
            eps_s, z, u = inj[0][s], list(inj[1][s]), inj[2][s]
        else:
            k_mom, k_acc, k_jit = random.split(step_keys[s], 3)
            eps_s = eps * random.uniform(k_jit, (), torch.float32,
                                         1.0 - eps_jitter, 1.0 + eps_jitter)
            z = list(random.normal(k_mom, (d, n)))
            u = torch.clamp(random.uniform(k_acc, (n,)), min=_TINY)
        m0 = [msc_k[j] * z[j] for j in range(d)]
        m, vn, gn, lpn = list(m0), list(v), list(g), lp
        half = eps_s * 0.5
        for _ in range(L):
            m = [m[j] + half * gn[j] for j in range(d)]
            vn = [vn[j] + eps_s * (inv_k[j] * m[j]) for j in range(d)]
            lpn, gst = staged.vag(torch.stack(vn))
            gn = list(gst)
            m = [m[j] + half * gn[j] for j in range(d)]
        alpha = lpn - lp - kinetic(m) + kinetic(m0)
        alpha = torch.where(torch.isnan(alpha), -math.inf, alpha)
        accept = torch.log(u) < alpha
        v = [torch.where(accept, vn[j], v[j]) for j in range(d)]
        g = [torch.where(accept, gn[j], g[j]) for j in range(d)]
        lp = torch.where(accept, lpn, lp)
        acc = acc + accept.to(torch.float32)
        hist.append(v[collect_idx] if collect_idx is not None
                    else torch.stack(v))
    return _outputs(torch.stack(v), torch.stack(hist), acc, collect_idx)


def hmc_chains_fused_chunked(key, logp: Callable, values0: torch.Tensor,
                             n_steps: int, chunk_steps: Optional[int] = None,
                             **kw):
    """Drive :func:`hmc_chains_fused` in step chunks and concatenate the
    collected histories. A chunk boundary is exact for fixed-L HMC (the
    chain state is the whole sampler state); each chunk draws with
    ``key, k_use = split(key)``, so the draws depend on the chunking.
    Chunks are sized so that one chunk's history stays within
    ``HIST_BUDGET_BYTES`` of device memory (``chunk_steps`` overrides).
    Returns the same ``(values, collected, accept_counts)`` as one call."""
    n, d = values0.shape
    if chunk_steps is None:
        per_step = (d if kw.get("collect_idx", 0) is None else 1) * 4 * n
        chunk_steps = max(1, min(n_steps, HIST_BUDGET_BYTES // per_step))
    chunks = []
    acc = torch.zeros((n,), dtype=torch.float32, device=values0.device)
    values = values0
    key = key.to(values0.device)
    done = 0
    while done < n_steps:
        t = int(min(chunk_steps, n_steps - done))
        key, k_use = random.split(key)
        values, collected, acc_c = hmc_chains_fused(k_use, logp, values,
                                                    n_steps=t, **kw)
        chunks.append(collected)
        acc = acc + acc_c
        done += t
    return values, torch.cat(chunks, dim=0), acc
