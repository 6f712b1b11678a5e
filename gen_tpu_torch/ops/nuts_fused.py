"""Fused many-chain FSM-NUTS: the whole sampling run as one CUDA kernel launch.

Counterpart: ``gen_tpu/ops/nuts_fused.py``. Ported: the one-leapfrog-per-
tick kernel K6 (``_kernel``, ``nuts_chains_fused(paired=False)``, the
default) as ``csrc/nuts_tick.cu``, the pair-scheduled kernel K3
(``_kernel_pair``, ``paired=True``) as ``csrc/nuts_pair.cu``, the two
sharing ``csrc/nuts_common.cuh``; their plain version
:func:`nuts_chains_fused_plain`, and the chunked runners
:func:`nuts_chains_fused_chunked`, :func:`nuts_collect_draws` and
:func:`extract_completed_draws`.

Where PyTorch and Hopper forced differences:

- Dispatch is by the device of ``values0``: a CUDA tensor launches the
  kernel (a failed build or launch raises; nothing falls back), a CPU
  tensor runs :func:`nuts_chains_fused_plain`. There is no ``use_pallas``,
  ``interpret`` or ``tile``. gen_tpu's ``use_pallas=None`` dispatch sent
  stream models to its XLA twin below a crossover measured on the TPU;
  that dispatch is not ported: on CUDA the kernel runs.
- A streamed likelihood (``StagedLogp.stream_data``) runs the one-thread
  layout's code in the ``"stream"`` layout (:func:`stream_layout`): one to
  eight warps per chain by the data length, whose lanes split the loop
  over the data tiles (staging part c). What bounds the loop is its
  per-point arithmetic; each lane evaluates a block of points as
  independent instructions and Kahan-adds the block's total, and the data
  tiles are copied into shared memory, as gen_tpu's ``stream_hbm``
  variant DMA'd them. K6's blocks hold several chains that share the
  tiles (a launch fills the last block with copies of the last chain and
  drops them, since the loop's barriers need every warp); K3's hold one,
  as its slot 2 is conditional per chain.
- Layouts (:func:`kernel_layout`): one thread per chain holds the
  chain's state where it fits (d <= 32, streams, and for now d > 128);
  for 32 < d <= 128 a warp runs one chain, lane l holding coordinates
  ``4l .. 4l+3`` in registers, every sum over coordinates split into lane
  partials and a butterfly, the staged program split over the lanes
  (:class:`~gen_tpu_torch.ops.scalarize.SplitProgram`). The plain version
  follows the layout's order of sums (``run_pairs``/``run_ticks``
  ``layout=``), so it stays the kernel's plain version at every d.
- The plain versions are :func:`gen_tpu_torch.inference.nuts_fsm.run_ticks`
  (K6) and :func:`~gen_tpu_torch.inference.nuts_fsm.run_pairs` (K3), the
  port's ``nuts_fsm`` and ``nuts_fsm_paired`` loops, driven by the torch
  rendering of the staged program: one function is both the algorithm's
  twin and the kernel's plain version.
- The chunked runners bound the history (one row per tick for K6, per pair
  for K3) by a byte budget in device memory (``HIST_BUDGET_BYTES``), not by
  the TPU's VMEM envelope; the kernels' state does not live in the
  history's memory.
- The kernel draws with Philox seeded from the key's two words, so its
  draws differ from the plain version's (:mod:`gen_tpu_torch.random`);
  with ``injected_rng`` both consume the same numbers and agree.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Callable, Optional

import torch

from .. import random
from ..inference.nuts_fsm import (injected_draws, key_draws, run_pairs,
                                  run_ticks, summary_stats)
from ..utils import sqrt_mass_safe
from . import _cuda_build, scalarize
from .hmc_fused import stage
from .scalarize import (LANES, WARP_CPL, StagedLogp, StreamLayout,
                        block_size, pad_chains)

BLOCK = 128                    # threads (chains) per block; tuning is later
# points a lane of K3's stream loop where a chain is one warp: at 8 its
# 128 registers spilled 200 bytes; 4 ran 24% faster at 10^4 points and
# 8,192 chains on the H100, 2 slower (PERF.md)
PAIR_ONE_WARP_POINTS = 4
HIST_BUDGET_BYTES = 8 << 30    # device memory for one chunk's history
_CSRC_DIR = Path(__file__).resolve().parent / "csrc"
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
# paired -> (kernel name, source, injected uniforms per step)
_KERNELS = {True: ("nuts_pair", "nuts_pair.cu", 7),
            False: ("nuts_tick", "nuts_tick.cu", 4)}


def extract_completed_draws(hist, hist_cnt, m: int):
    """``(ticks, n[, d])`` tick series + completed-count streams ->
    ``(m, n[, d])`` completed draws: draw i of chain j is the series value
    at the first tick where the count reaches i+1 (a per-chain
    searchsorted; ``hist_cnt`` is nondecreasing per chain). Each completed
    trajectory's endpoint counts once, so use these for moments; the raw
    tick series is length-biased. A draw not reached takes the last tick,
    as gen_tpu's clamped gather does."""
    t = hist_cnt.shape[0]
    targets = torch.arange(1, m + 1, dtype=hist_cnt.dtype,
                           device=hist_cnt.device)
    idx = torch.searchsorted(hist_cnt.T.contiguous(),
                             targets.expand(hist_cnt.shape[1], m)
                             .contiguous())                  # (n, m)
    idx = torch.clamp(idx, max=t - 1)
    if hist.dim() == 2:
        return torch.gather(hist.T, 1, idx).T
    d = hist.shape[2]
    out = torch.gather(hist.permute(1, 0, 2), 1,
                       idx[:, :, None].expand(-1, -1, d))    # (n, m, d)
    return out.permute(1, 0, 2)


def kernel_layout(staged: StagedLogp) -> str:
    """``"stream"`` for a streamed likelihood (the one-thread layout's
    code, run by the warps of :func:`stream_layout`); ``"warp"`` (one warp
    per chain, lane l holding coordinates ``4l .. 4l+3``) for ``32 < d <=
    128`` without scan loops (``SplitProgram`` does not split them); else
    ``"thread"``: one thread per chain."""
    if staged.streams:
        return "stream"
    if LANES < staged.d <= LANES * WARP_CPL and not staged.loops:
        return "warp"
    return "thread"


def stream_layout(staged: StagedLogp, paired: bool) -> StreamLayout:
    """The stream loop's layout in K3 (``paired``) or K6: K6 calls the
    staged code at the same point in every chain, so its blocks hold
    several chains that share the tiles (``staged.layout``); K3's hold one,
    since its slot 2 is conditional per chain (two a block, running slot 2
    for both when one needed it, were slower on the H100: PERF.md). K3
    keeps more state than K6: where its chain is one warp, so that the
    work around the loop weighs most, it takes at most
    ``PAIR_ONE_WARP_POINTS`` points a lane, which keeps that state out of
    local memory."""
    lay = staged.layout
    if not paired:
        return lay
    return StreamLayout(lay.warps, lay.points if lay.warps > 1
                        else min(lay.points, PAIR_ONE_WARP_POINTS))


def keep_layout(text: str, layout: str) -> str:
    """``text`` without the marker lines ``// @@LAYOUT <names>@@`` and ``//
    @@LAYOUT end@@``, and without the lines after a marker that does not
    name ``layout`` (up to the next marker)."""
    out, keep = [], True
    for line in text.splitlines(keepends=True):
        if line.startswith("// @@LAYOUT "):
            names = line.strip()[len("// @@LAYOUT "):-2].split()
            keep = names == ["end"] or layout in names
            continue
        if keep:
            out.append(line)
    return "".join(out)


def kernel_source(staged: StagedLogp, max_depth: int, paired: bool) -> str:
    """The CUDA source of K3 (``paired``) or K6 in the layout
    :func:`kernel_layout` picks, with the shared helpers and the staged
    program spliced in (the build hashes this whole text)."""
    layout = kernel_layout(staged)
    if layout == "thread":
        defines = (f"#define NUTS_D {staged.d}\n"
                   f"#define NUTS_R {staged.n_res}\n"
                   f"#define NUTS_MD {int(max_depth)}\n"
                   f"#define NUTS_BLOCK {block_size(staged, BLOCK)}\n"
                   f"#define NUTS_LANES {staged.lanes}")
        # K3 takes the scan loops' bodies without run-time reciprocals:
        # each _div_rcp keeps an IEEE division as its slow path, and with
        # them K3's code grew 9% and ran 1-2% slower a slot on the AR(1)
        # model, while K1 and the staged-code kernel ran 22% and 8%
        # faster (PERF.md)
        vag_src = staged.cuda_source(scan_rcps=not paired)
    elif layout == "stream":
        lay = stream_layout(staged, paired)
        defines = (f"#define NUTS_D {staged.d}\n"
                   f"#define NUTS_R {staged.n_res}\n"
                   f"#define NUTS_MD {int(max_depth)}\n"
                   f"#define NUTS_BLOCK {lay.threads}\n"
                   f"#define NUTS_MIN_BLOCKS {lay.min_blocks}\n"
                   f"#define NUTS_LANES {lay.lanes}")
        vag_src = staged.cuda_source(lay)
    else:
        split = staged.warp_split()
        defines = (f"#define NUTS_D {staged.d}\n#define NUTS_R {split.n_res}\n"
                   f"#define NUTS_MD {int(max_depth)}\n"
                   f"#define NUTS_BLOCK {BLOCK}\n"
                   f"#define NUTS_LANES {LANES}\n"
                   f"#define NUTS_CPL {WARP_CPL}")
        vag_src = split.cuda_source()
    src = keep_layout((_CSRC_DIR / _KERNELS[paired][1]).read_text(), layout)
    common = keep_layout(_cuda_build.csrc_text(_CSRC_DIR / "nuts_common.cuh"),
                         layout)
    return (src.replace("// @@DEFINES@@", defines)
            .replace("// @@STAGED_VAG@@", vag_src)
            .replace("// @@NUTS_COMMON@@", common))


def build_job(staged: StagedLogp, max_depth: int, paired: bool):
    """``(name, source, signatures)`` for :func:`_cuda_build.build_all`."""
    name = _KERNELS[paired][0]
    return (name, kernel_source(staged, max_depth, paired),
            {f"{name}_launch": _ARGTYPES})


def build(staged: StagedLogp, max_depth: int, paired: bool) -> ctypes.CDLL:
    """Compile (once per generated source) and load the kernel library;
    kept with ``staged``, so that a launch renders no source."""
    key = (_KERNELS[paired][0], int(max_depth))
    if key not in staged.libs:
        staged.libs[key] = _cuda_build.build(*build_job(staged, max_depth,
                                                        paired))
    return staged.libs[key]


def _prepare(logp, values0, inv_mass_diag, collect_idx):
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
    return staged, vt, inv


def _outputs(vout, hist, hist_cnt, counts, stats5, collect_idx):
    hist = hist if collect_idx is not None else hist.permute(0, 2, 1)
    stats = summary_stats(counts, *stats5)
    return vout.T, hist, hist_cnt, counts, stats


def nuts_chains_fused(key, logp: Callable, values0: torch.Tensor,
                      num_ticks: int, eps: float, max_depth: int = 8,
                      inv_mass_diag=None, collect_idx: Optional[int] = 0,
                      divergence_threshold: float = 1000.0,
                      injected_rng=None, paired: bool = False):
    """Run ``num_ticks`` FSM-NUTS leapfrog slots on the ``(n, d)`` chains
    ``values0``: one leapfrog per tick (``paired=False``, the kernel K6) or
    ``ceil(num_ticks / 2)`` pairs of two (``paired=True``, the
    pair-scheduled kernel K3).

    Returns ``(values (n, d), hist (steps, n), hist_counts (steps, n)
    int32, counts (n,) int32, stats)`` with one step per tick (K6) or per
    pair (K3): ``hist[s, j]`` is coordinate ``collect_idx`` of chain j's
    current sample after step s (the whole ``(steps, n, d)`` state, a
    strided view, for ``collect_idx=None``); ``hist_counts`` the
    completed-trajectory count after step s (feed both to
    :func:`extract_completed_draws`); ``stats`` the dict
    ``mean_accept``/``mean_depth``/``num_divergent`` per chain.
    ``injected_rng`` replaces the kernel's Philox draws, which makes the
    kernel and its plain version agree step for step: ``(z (ticks, n, d),
    u_dir0, u_take, u_bias, u_dir each (ticks, n))`` for K6, ``(z (pairs,
    n, d), u_dir0, u_take1, u_bias1, u_dir1, u_take2, u_bias2, u_dir2 each
    (pairs, n))`` for K3. A CUDA ``values0`` launches the kernel; a CPU
    ``values0`` runs :func:`nuts_chains_fused_plain`."""
    if values0.device.type == "cpu":
        return nuts_chains_fused_plain(
            key, logp, values0, num_ticks, eps, max_depth, inv_mass_diag,
            collect_idx, divergence_threshold, injected_rng, paired)
    if values0.device.type != "cuda":
        raise ValueError(f"nuts_chains_fused: unsupported device "
                         f"{values0.device}")
    staged, vt, inv = _prepare(logp, values0, inv_mass_diag, collect_idx)
    d, n = vt.shape
    name, _, n_u = _KERNELS[paired]
    steps = (num_ticks + 1) // 2 if paired else num_ticks
    lib = build(staged, max_depth, paired)
    dev = vt.device
    layout = kernel_layout(staged)
    # a stream layout's blocks hold whole groups of chains: the kernel runs
    # n_k chains, copies of the last one past n, and drops the copies
    c = stream_layout(staged, paired).chains if layout == "stream" else 1
    n_k = -(-n // c) * c
    with torch.cuda.device(dev):
        msc = sqrt_mass_safe(inv).contiguous()
        inj = [None, None]
        if injected_rng is not None:
            if len(injected_rng) != n_u + 1:
                raise ValueError(
                    f"injected_rng needs {n_u + 1} streams (z and {n_u} "
                    f"uniforms) for paired={paired} "
                    f"({'K3' if paired else 'K6'}), got "
                    f"{len(injected_rng)}")
            z, *us = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                      for x in injected_rng)
            inj = [pad_chains(z.reshape(steps, n, d).permute(0, 2, 1), n_k),
                   pad_chains(torch.stack([u.reshape(steps, n) for u in us],
                                          dim=1), n_k)]
        v_k = pad_chains(vt, n_k)
        vout = torch.empty_like(v_k)
        hist = torch.empty((steps, n_k) if collect_idx is not None
                           else (steps, d, n_k), dtype=torch.float32,
                           device=dev)
        hist_cnt = torch.empty((steps, n_k), dtype=torch.int32, device=dev)
        counts = torch.empty((n_k,), dtype=torch.int32, device=dev)
        stats = torch.empty((5, n_k), dtype=torch.float32, device=dev)
        seed0, seed1 = (int(w) for w in key.reshape(-1)[:2].tolist())
        res = (staged.warp_split().res_consts if layout == "warp"
               else staged.res_consts).contiguous()
        sd = scalarize.stream_table(staged, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            v_k.data_ptr(), vout.data_ptr(), hist.data_ptr(),
            hist_cnt.data_ptr(), counts.data_ptr(), stats.data_ptr(),
            res.data_ptr(), inv.data_ptr(), msc.data_ptr(),
            None if sd is None else sd.data_ptr(), staged.n_pts, n_k, steps,
            float(eps), float(divergence_threshold),
            -1 if collect_idx is None else collect_idx, seed0, seed1,
            *[None if t is None else t.data_ptr() for t in inj], stream)
    _cuda_build.check_launch(rc, name)
    nuts_chains_fused.launches += 1
    nuts_chains_fused.kernel_launches[name] += 1
    nuts_chains_fused.layout_launches[layout] += 1
    scalarize.count_body_launch(staged)
    # accept sum, depth sum, divergences, in-flight alpha sum and leapfrogs
    stats = stats[:, :n]
    five = (stats[0], stats[1], stats[2].to(torch.int32), stats[3],
            stats[4].to(torch.int32))
    return _outputs(vout[:, :n], hist[..., :n], hist_cnt[:, :n],
                    counts[:n], five, collect_idx)


# launches of either kernel, of each (K3 "nuts_pair", K6 "nuts_tick") and
# in each layout (kernel_layout: "thread", "warp" or "stream")
nuts_chains_fused.launches = 0
nuts_chains_fused.kernel_launches = {"nuts_pair": 0, "nuts_tick": 0}
nuts_chains_fused.layout_launches = {"thread": 0, "warp": 0, "stream": 0}


def nuts_chains_fused_plain(key, logp: Callable, values0: torch.Tensor,
                            num_ticks: int, eps: float, max_depth: int = 8,
                            inv_mass_diag=None,
                            collect_idx: Optional[int] = 0,
                            divergence_threshold: float = 1000.0,
                            injected_rng=None, paired: bool = False):
    """The kernels' plain PyTorch version, on any device: the port's
    ``nuts_fsm`` loop (:func:`run_ticks`, K6) or ``nuts_fsm_paired`` loop
    (:func:`run_pairs`, K3) through the torch rendering of the staged
    program, in float32 with the kernel's roundings and summation order:
    in the warp-per-chain layout the split program and the lanes' sums
    (:func:`kernel_layout`). Without ``injected_rng`` each chain draws from
    its own key, ``random.split(key, n)``, as gen_tpu's XLA path does."""
    staged, vt, inv = _prepare(logp, values0, inv_mass_diag, collect_idx)
    layout = "warp" if kernel_layout(staged) == "warp" else "thread"
    vag = staged.vag if layout == "thread" else staged.warp_split().vag
    if staged.streams:
        lay = stream_layout(staged, paired)
        vag = (lambda x: staged.vag(x, lay))
    d, n = vt.shape
    dev = vt.device
    n_u = _KERNELS[paired][2]
    loop, steps = ((run_pairs, (num_ticks + 1) // 2) if paired
                   else (run_ticks, num_ticks))
    draw = (key_draws(random.split(key.to(dev), n), d, torch.float32, n_u,
                      steps)
            if injected_rng is None
            else injected_draws(injected_rng, n, d, torch.float32, dev, n_u))
    s, hist, hist_cnt = loop(
        vag, vt, float(eps), steps, max_depth, inv.reshape(d, 1),
        divergence_threshold, draw, collect_idx, ckpt_bf16=True,
        layout=layout)
    five = (s["acc_sum"], s["depth_sum"], s["div"], s["asum"], s["nlf"])
    return _outputs(s["theta"], hist, hist_cnt, s["count"], five,
                    collect_idx)


def _chunk_ticks(n, d, collect_idx, num_ticks, paired):
    """Ticks per chunk so that one chunk's history (values and counts, one
    row per tick for K6, per pair for K3) stays within
    ``HIST_BUDGET_BYTES``."""
    per_row = ((d if collect_idx is None else 1) + 1) * 4 * n
    per = 2 if paired else 1
    return max(per, min(num_ticks, per * (HIST_BUDGET_BYTES // per_row)))


def nuts_chains_fused_chunked(key, logp, values0, num_ticks: int,
                              eps: float, chunk_ticks: Optional[int] = None,
                              **kw):
    """Drive :func:`nuts_chains_fused` in tick chunks and stitch the
    streams. A chunk boundary restarts the in-flight trajectory from the
    current sample, a valid transition boundary. ``hist_counts`` comes back
    cumulative across chunks, so :func:`extract_completed_draws` works on
    the stitched streams; stats are count-weighted across chunks. Chunks
    are sized by device memory for the history (``HIST_BUDGET_BYTES``)."""
    n, d = values0.shape
    if chunk_ticks is None:
        chunk_ticks = _chunk_ticks(n, d, kw.get("collect_idx", 0),
                                   num_ticks, kw.get("paired", False))
    dev = values0.device
    hists, hcnts = [], []
    cnt_total = torch.zeros((n,), dtype=torch.int32, device=dev)
    acc_w = torch.zeros((n,), dtype=torch.float32, device=dev)
    depth_w = torch.zeros((n,), dtype=torch.float32, device=dev)
    div_total = torch.zeros((n,), dtype=torch.int32, device=dev)
    values = values0
    key = key.to(dev)
    done = 0
    last_stats = None
    while done < num_ticks:
        t = min(chunk_ticks, num_ticks - done)
        key, k_use = random.split(key)
        values, hist, hcnt, cnt, stats = nuts_chains_fused(
            k_use, logp, values, num_ticks=t, eps=eps, **kw)
        hists.append(hist)
        hcnts.append(hcnt + cnt_total[None, :])
        cntf = cnt.to(torch.float32)
        acc_w = acc_w + stats["mean_accept"] * cntf
        depth_w = depth_w + stats["mean_depth"] * cntf
        div_total = div_total + stats["num_divergent"]
        cnt_total = cnt_total + cnt
        last_stats = stats
        done += t
    denom = torch.clamp(cnt_total.to(torch.float32), min=1.0)
    # a chain with no completed trajectory reports the last chunk's
    # in-flight accept statistic, as nuts_chains_fused does
    mean_accept = torch.where(cnt_total > 0, acc_w / denom,
                              last_stats["mean_accept"])
    stats = dict(mean_accept=mean_accept, mean_depth=depth_w / denom,
                 num_divergent=div_total)
    return (values, torch.cat(hists, dim=0), torch.cat(hcnts, dim=0),
            cnt_total, stats)


def nuts_collect_draws(key, logp, values0, num_draws: int, eps: float,
                       max_ticks: Optional[int] = None,
                       chunk_ticks: Optional[int] = None, **kw):
    """Bounded-memory draw collection: drive :func:`nuts_chains_fused` in
    chunks, fold each chunk's COMPLETED draws into a fixed ``(num_draws,
    n[, d])`` buffer and drop the streams, so memory is O(num_draws x n)
    whatever the slowest chain needs. Returns ``(draws, values, counts,
    ticks_used)``; ``draws[j, i]`` is chain i's (j+1)-th completed endpoint,
    NaN where a chain completed fewer than ``num_draws`` within
    ``max_ticks`` (default ``64 * num_draws``)."""
    n, d = values0.shape
    ci = kw.get("collect_idx", 0)
    if chunk_ticks is None:
        chunk_ticks = _chunk_ticks(n, d, ci, 4096, kw.get("paired", False))
    if max_ticks is None:
        max_ticks = 64 * num_draws
    dev = values0.device
    targets = torch.arange(1, num_draws + 1, dtype=torch.int32, device=dev)
    draws = torch.full((num_draws, n) if ci is not None
                       else (num_draws, n, d), math.nan,
                       dtype=torch.float32, device=dev)
    base = torch.zeros((n,), dtype=torch.int32, device=dev)
    values = values0
    key = key.to(dev)
    done = 0
    while done < max_ticks:
        t = int(min(chunk_ticks, max_ticks - done))
        key, k_use = random.split(key)
        values, hist, hcnt, _, _ = nuts_chains_fused(
            k_use, logp, values, num_ticks=t, eps=eps, **kw)
        hcnt_abs = hcnt + base[None, :]                     # (steps, n)
        pos = torch.searchsorted(hcnt_abs.T.contiguous(),
                                 targets.expand(n, num_draws).contiguous())
        pos = torch.clamp(pos, max=hcnt.shape[0] - 1)     # (n, num_draws)
        new_base = base + hcnt[-1]
        mask = (targets[None, :] > base[:, None]) \
            & (targets[None, :] <= new_base[:, None])
        if hist.dim() == 2:
            vals = torch.gather(hist.T, 1, pos)             # (n, num_draws)
            draws = torch.where(mask.T, vals.T, draws)
        else:
            vals = torch.gather(hist.permute(1, 0, 2), 1,
                                pos[:, :, None].expand(-1, -1, d))
            draws = torch.where(mask.T[:, :, None], vals.permute(1, 0, 2),
                                draws)
        base = new_base
        del hist, hcnt
        done += t
        if int(base.min()) >= num_draws:
            break
    return draws, values, base, done
