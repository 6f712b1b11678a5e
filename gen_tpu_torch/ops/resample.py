"""Systematic resampling: the SMC hot op, with kernel K4 in CUDA C++.

Counterpart: ``gen_tpu/ops/resample.py`` (``systematic_resample`` and its
Pallas kernel ``_pallas_kernel``). For log weights and one uniform u the
parents are ``parents[i] = #{j : cdf[j] < (i + u)/N}`` over the normalized
cdf (searchsorted-left), clamped to N-1.

Where PyTorch and Hopper forced differences:

- Dispatch is by the device of the log weights. A CUDA tensor launches K4
  (``csrc/resample.cu``, through :func:`resample_cdf`) at every N: the
  TPU's cap of 65,536 particles and its multiple of 1,024 were VMEM
  limits. A failed build or launch raises; nothing falls back. A CPU
  tensor follows gen_tpu's own dispatch: :func:`_jnp_systematic` up to
  32,768 particles, :func:`_sorted_systematic` above.
- The max, exp, cumsum and normalization run outside the kernel, in torch
  ops, as gen_tpu runs them in XLA (:func:`normalized_cdf`), plus a
  running max that keeps the card's parallel cumsum nondecreasing; u
  stays a device tensor that the kernel reads through a pointer.
- Positions are ``(i + u) * (1/N)`` with the reciprocal rounded once: XLA
  compiles gen_tpu's ``/ n`` into that product, and on the card torch
  divides by a Python number the same way.
- K4 runs a binary search per position where the TPU kernel counted all
  N x N comparisons; :func:`systematic_parents_count` is that count, the
  plain version K4 is held to on the card.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from . import _cuda_build

_CSRC = Path(__file__).resolve().parent / "csrc" / "resample.cu"
_SORT_THRESHOLD = 32768
COUNT_CHUNK_ELEMS = 1 << 28   # comparisons per chunk of the literal count

_SIGNATURES = {f"resample_systematic_{s}": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p] for s in ("f32", "f64")}


def build_job():
    """``(name, source, signatures)`` for :func:`_cuda_build.build_all`:
    one source with the float32 and float64 entry points."""
    return ("resample", _CSRC.read_text(), _SIGNATURES)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once per source) and load the kernel library."""
    return _cuda_build.build(*build_job())


def normalized_cdf(log_weights: torch.Tensor) -> torch.Tensor:
    """max, exp, cumsum and normalize, as gen_tpu's wrappers compute it,
    with a running max after the cumsum. The card's cumsum is a parallel
    scan whose rounding can dip by an ulp where two partial sums meet (seen
    at 131,072 float32 particles); the running max, which is exact, keeps
    the cdf nondecreasing, the assumption under which K4's binary search
    equals the literal count. A sequential cumsum (the CPU's) never dips,
    so there it changes nothing."""
    w = torch.exp(log_weights - torch.max(log_weights))
    cdf = torch.cummax(torch.cumsum(w, dim=0), dim=0).values
    return cdf / cdf[-1]


def positions(n: int, u, dtype, device) -> torch.Tensor:
    """``(arange(n) + u) * (1/n)`` in ``dtype``, the reciprocal rounded
    once (by an IEEE division of two 0-dim CPU tensors)."""
    recip = (torch.tensor(1.0, dtype=dtype)
             / torch.tensor(float(n), dtype=dtype))
    u = torch.as_tensor(u, dtype=dtype, device=device)
    return (torch.arange(n, dtype=dtype, device=device) + u) * recip


def _jnp_systematic(log_weights, u):
    cdf = normalized_cdf(log_weights)
    pos = positions(cdf.shape[0], u, cdf.dtype, cdf.device)
    return torch.searchsorted(cdf, pos, side="left").to(torch.int32)


def _rank_merge_parents(cdf, positions_):
    """parents_i = #{j : cdf_j < positions_i} for sorted positions, by two
    argsorts (rank = argsort of argsort); ``positions_`` may have any
    length m. The queries sort before the data at equal keys, so a cdf
    entry equal to a position is not counted (searchsorted-left).
    gen_tpu's ``lexsort`` puts the data first and counts it: on exact ties
    its rank merge departs from its own definition (ROADMAP queue 3)."""
    m = positions_.shape[0]
    order = torch.argsort(torch.cat([positions_, cdf]), stable=True)
    rank = torch.argsort(order)
    # query i sits at sorted position rank[i]; the data elements before it
    # number rank[i] - (queries before it) = rank[i] - i
    return (rank[:m] - torch.arange(m, device=cdf.device)).to(torch.int32)


def _sorted_systematic(log_weights, u):
    cdf = normalized_cdf(log_weights)
    pos = positions(cdf.shape[0], u, cdf.dtype, cdf.device)
    return torch.clamp(_rank_merge_parents(cdf, pos), 0, cdf.shape[0] - 1)


def _counting_systematic(log_weights, u):
    """Sort-free O(N) exact systematic resampling: particle j's offspring
    boundary ``m_j = ceil(cdf_j N - u)`` (= #positions below cdf_j); one
    scatter-add of boundary markers and a cumsum expand the counts into
    parents. gen_tpu measured it slower than the rank merge on the TPU at
    1M particles (10.2 ms vs 7.7 ms) and kept the sort; it is kept here as
    the same documented reference formulation, ties included (a cdf entry
    equal to a position counts, as in gen_tpu's rank merge)."""
    n = log_weights.shape[0]
    cdf = normalized_cdf(log_weights)
    m = torch.ceil(cdf * n - torch.as_tensor(u, dtype=cdf.dtype)).long()
    ind = torch.zeros(n + 1, dtype=torch.int32, device=cdf.device)
    ind.index_add_(0, m[:-1], torch.ones(n - 1, dtype=torch.int32,
                                         device=cdf.device))
    return torch.cumsum(ind[:n], dim=0).to(torch.int32)


def systematic_parents_count(cdf: torch.Tensor, u) -> torch.Tensor:
    """The TPU kernel's own definition, ``min(#{j : cdf[j] < pos_i},
    N-1)``, counted literally in chunks of positions: K4's plain
    version, on any device. O(N^2) comparisons."""
    n = cdf.shape[0]
    pos = positions(n, u, cdf.dtype, cdf.device)
    out = torch.empty(n, dtype=torch.int32, device=cdf.device)
    chunk = max(1, COUNT_CHUNK_ELEMS // n)
    for s in range(0, n, chunk):
        out[s:s + chunk] = (cdf[None, :] < pos[s:s + chunk, None]).sum(
            dim=1, dtype=torch.int32)
    return torch.clamp(out, max=n - 1)


def resample_cdf(cdf: torch.Tensor, u) -> torch.Tensor:
    """K4's wrapper: parents from a normalized cdf ``(N,)`` (float32 or
    float64) and a uniform ``u`` (a 0-dim tensor or a number). A CUDA
    ``cdf`` launches the kernel; a CPU ``cdf`` runs
    :func:`systematic_parents_count`. Returns ``(N,)`` int32."""
    if cdf.device.type == "cpu":
        return systematic_parents_count(cdf, u)
    if cdf.device.type != "cuda":
        raise ValueError(f"resample_cdf: unsupported device {cdf.device}")
    if cdf.dim() != 1 or cdf.shape[0] == 0:
        raise ValueError("resample_cdf: cdf must be a non-empty (N,) tensor")
    entry = {torch.float32: "resample_systematic_f32",
             torch.float64: "resample_systematic_f64"}.get(cdf.dtype)
    if entry is None:
        raise ValueError(f"resample_cdf: unsupported dtype {cdf.dtype}")
    n = cdf.shape[0]
    cdf = cdf.contiguous()
    u = torch.as_tensor(u, dtype=cdf.dtype, device=cdf.device).reshape(1)
    lib = build()
    with torch.cuda.device(cdf.device):
        out = torch.empty(n, dtype=torch.int32, device=cdf.device)
        stream = torch.cuda.current_stream(cdf.device).cuda_stream
        rc = getattr(lib, entry)(cdf.data_ptr(), u.data_ptr(),
                                 out.data_ptr(), n, stream)
    _cuda_build.check_launch(rc, "resample_systematic")
    systematic_resample.launches += 1
    return out


def systematic_resample(log_weights: torch.Tensor, u) -> torch.Tensor:
    """Parent indices ``(N,)`` int32 for systematic resampling.

    log_weights: ``(N,)`` unnormalized log weights; u: a uniform in [0, 1)
    (a 0-dim tensor on the weights' device, or a number). A CUDA tensor
    launches K4 at every N; a CPU tensor runs gen_tpu's dispatch
    (searchsorted up to 32,768 particles, the rank merge above)."""
    log_weights = torch.as_tensor(log_weights)
    if log_weights.device.type == "cuda":
        return resample_cdf(normalized_cdf(log_weights), u)
    if log_weights.device.type != "cpu":
        raise ValueError(f"systematic_resample: unsupported device "
                         f"{log_weights.device}")
    if log_weights.shape[0] > _SORT_THRESHOLD:
        return _sorted_systematic(log_weights, u)
    return _jnp_systematic(log_weights, u)


systematic_resample.launches = 0
