"""Batched categorical sampling, with kernel K5 in CUDA C++.

Counterpart: ``gen_tpu/ops/categorical.py`` (``batched_categorical``,
``categorical_fast`` and the Pallas kernel ``_kernel``): draw
``out[i] ~ Categorical(softmax(logits[i]))`` for every row of an ``(N,
K)`` logit matrix by Gumbel-argmax, ties to the lowest index.

Where PyTorch and Hopper forced differences:

- Dispatch is by the device of the logits. A CUDA tensor launches K5
  (``csrc/categorical.cu``) at every K: gen_tpu's ``_MAX_PALLAS_K = 128``
  cut was a TPU measurement. A failed build or launch raises; nothing
  falls back. A CPU tensor runs gen_tpu's off-TPU route,
  :func:`gen_tpu_torch.random.categorical`, whose threefry bits equal
  ``jax.random.categorical``'s.
- The kernel draws its uniforms from Philox keyed by the key's two words,
  so on the card the draws equal gen_tpu's in distribution, not bit for
  bit. With ``injected_u`` the kernel and :func:`batched_categorical_plain`
  consume the same uniforms and agree index for index.
- The kernel packs rows into sub-warps (``G`` lanes a row, 4 columns a
  lane: :func:`launch_shape`) where gen_tpu's kernel padded each row to a
  128-lane tile, and reads the key as the port holds it (int64 words with
  uint32 values), so a call on the card launches K5 and nothing else.
- The kernel is registered as the custom op ``gen_tpu_torch::categorical``
  with a ``torch.func.vmap`` rule, because the cipher-decode example calls
  :func:`categorical_fast` inside a vmap over restarts, as gen_tpu vmaps
  its chains, and a ``ctypes`` launch cannot run under vmap. The rule
  folds the batch into rows and passes one key per batch index, so each
  restart keeps its own key and a batched call launches the kernel once.
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path
from typing import Optional, Tuple

import torch

from .. import random
from . import _cuda_build

_CSRC_DIR = Path(__file__).resolve().parent / "csrc"
TINY = 1.1754944e-38          # FLT_MIN: keeps the inner log finite
_SIGNATURES = {"categorical_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]}


def kernel_source() -> str:
    """K5's source with the shared Philox helpers spliced in."""
    return (_CSRC_DIR / "categorical.cu").read_text().replace(
        "// @@NUTS_COMMON@@", _cuda_build.csrc_text(_CSRC_DIR
                                                    / "nuts_common.cuh"))


def build_job():
    """``(name, source, signatures)`` for :func:`_cuda_build.build_all`."""
    return ("categorical", kernel_source(), _SIGNATURES)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once per source) and load the kernel library."""
    return _cuda_build.build(*build_job())


def batched_categorical_plain(logits: torch.Tensor,
                              u: torch.Tensor) -> torch.Tensor:
    """K5's plain version on any device: Gumbel-argmax of ``logits``
    (cast to float32) with the given uniforms ``u`` ``(N, K)``: the same
    clamp, double log, lowest-index argmax and clamp to K - 1 as the
    kernel. Returns ``(N,)`` int32."""
    x = logits.to(torch.float32)
    g = -torch.log(-torch.log(torch.clamp(u.to(torch.float32), min=TINY)))
    x = x + g
    k = x.shape[-1]
    m = torch.amax(x, dim=-1, keepdim=True)
    col = torch.arange(k, device=x.device)
    idx = torch.amin(torch.where(x == m, col, k), dim=-1)
    return torch.clamp(idx, max=k - 1).to(torch.int32)


def launch_shape(n: int, k: int,
                 src: Optional[str] = None) -> Tuple[int, int, int]:
    """K5's launch over ``(n, k)`` logits, as its source (``src``, or the
    module's) computes it: ``(lanes a row, threads a block, blocks)``. A
    row takes the smallest power of two >= ceil(k / 4) lanes, at most
    32."""
    g = 1
    while g < 32 and 4 * g < k:
        g *= 2
    src = (_CSRC_DIR / "categorical.cu").read_text() if src is None else src
    warps = int(re.search(r"#define CAT_WARPS (\d+)", src).group(1))
    rows = warps * (32 // g)
    return g, 32 * warps, -(-n // rows)


@torch.library.custom_op("gen_tpu_torch::categorical", mutates_args=(),
                         device_types="cuda")
def _categorical_op(logits: torch.Tensor, keys: Optional[torch.Tensor],
                    u: Optional[torch.Tensor],
                    rows_per_key: int) -> torch.Tensor:
    """Launch K5 on ``logits`` ``(N, K)`` float32 with keys ``keys``
    (``N / rows_per_key`` keys of two int64 words with uint32 values, as
    the port holds them), or uniforms ``u`` ``(N, K)`` and no keys."""
    n, k = logits.shape
    if n % rows_per_key:
        raise ValueError("categorical: rows_per_key must divide N")
    if u is None and (keys is None or keys.dtype != torch.int64
                      or keys.numel() != 2 * (n // rows_per_key)
                      or keys.device != logits.device):
        raise ValueError("categorical: keys must be N / rows_per_key int64 "
                         "word pairs on the logits' device")
    keys = None if u is not None else keys.contiguous()
    lib = build()
    with torch.cuda.device(logits.device):
        out = torch.empty(n, dtype=torch.int32, device=logits.device)
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        rc = lib.categorical_launch(
            logits.data_ptr(), 0 if u is None else u.data_ptr(),
            0 if keys is None else keys.data_ptr(), n, k, rows_per_key,
            out.data_ptr(), stream)
    _cuda_build.check_launch(rc, "categorical")
    batched_categorical.launches += 1
    return out


@_categorical_op.register_fake
def _(logits, keys, u, rows_per_key):
    return logits.new_empty((logits.shape[0],), dtype=torch.int32)


def _batch_first(x, dim, size):
    """``x`` with its vmapped dimension first (expanded if unbatched)."""
    if x is None:
        return None
    if dim is None:
        return x.expand(size, *x.shape)
    return x.movedim(dim, 0)


def _categorical_vmap(info, in_dims, logits, keys, u, rows_per_key):
    """Fold the vmapped dimension into rows; batch index b keeps its own
    key words, so the launch draws what B separate calls would."""
    b = info.batch_size
    l_dim, k_dim, u_dim, _ = in_dims
    logits = _batch_first(logits, l_dim, b)
    n, k = logits.shape[1], logits.shape[2]
    keys = _batch_first(keys, k_dim, b)
    u = _batch_first(u, u_dim, b)
    out = _categorical_op(
        logits.reshape(b * n, k).contiguous(),
        None if keys is None else keys.reshape(-1, 2).contiguous(),
        None if u is None else u.reshape(b * n, k).contiguous(),
        rows_per_key)
    return out.reshape(b, n), 0


torch.library.register_vmap("gen_tpu_torch::categorical", _categorical_vmap)


def batched_categorical(key, logits: torch.Tensor,
                        injected_u: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Sample ``out[i] ~ Categorical(softmax(logits[i]))`` for ``(N, K)``
    logits; returns ``(N,)`` int32. A CUDA tensor launches K5 (Philox
    noise from ``key``, or the uniforms ``injected_u`` ``(N, K)``); a CPU
    tensor runs :func:`gen_tpu_torch.random.categorical` on ``key`` (or
    :func:`batched_categorical_plain` on ``injected_u``)."""
    if logits.dim() != 2:
        raise ValueError("batched_categorical: logits must be (N, K)")
    if logits.device.type == "cpu":
        if injected_u is not None:
            return batched_categorical_plain(logits, injected_u)
        return random.categorical(key, logits).to(torch.int32)
    if logits.device.type != "cuda":
        raise ValueError(f"batched_categorical: unsupported device "
                         f"{logits.device}")
    return _launch(key, logits, injected_u)


def _launch(key, logits, injected_u):
    """K5's launch for :func:`batched_categorical`: the key goes to the
    kernel as it is, float32 contiguous logits and uniforms as they are
    (no copy), and in injected mode no key at all."""
    u = None if injected_u is None else \
        injected_u.to(torch.float32).contiguous()
    return _categorical_op(logits.to(torch.float32).contiguous(),
                           key if u is None else None, u, logits.shape[0])


batched_categorical.launches = 0


def categorical_fast(key, logits: torch.Tensor) -> torch.Tensor:
    """gen_tpu's auto-dispatching entry point: K5 for a CUDA tensor at
    every K, ``random.categorical`` for a CPU tensor."""
    return batched_categorical(key, logits)
