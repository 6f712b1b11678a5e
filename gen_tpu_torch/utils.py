"""Small pytree and numeric helpers shared across the port.

Counterpart: ``gen_tpu/utils.py``. Pytrees go through
``torch.utils._pytree``; ``sqrt_mass_safe`` keeps gen_tpu's frozen-coordinate
convention; the bf16 helpers use gen_tpu's integer bit arithmetic, so the
fused NUTS kernel (``ops/csrc/nuts_pair.cu``) and its twin round alike.
``partition_inexact``/``combine``/``tree_vdot`` serve the gradient
methods; ``None`` is a leaf of torch's pytrees (an empty node of JAX's),
so :func:`combine` maps the two halves leaf by leaf.

Not in gen_tpu: :func:`default_device`. The port's entry points put new
tensors on the card unless the caller names another device. And
:func:`default_int`, JAX's default integer under the port's counterpart
of the x64 flag.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree

_M32 = 0xFFFFFFFF
_HI16 = 0xFFFF0000


def default_device() -> torch.device:
    """Where the port's entry points create tensors when the caller names
    no device: the CUDA card. There is no CPU fallback; without CUDA a
    call that allocates there raises, as torch does. Pass ``device="cpu"``
    to run on the CPU (the tests do)."""
    return torch.device("cuda")


def default_int() -> torch.dtype:
    """JAX's default integer as the port reads it: int64 when torch's
    default float is float64 (the counterpart of JAX's x64 mode), else
    int32. Integer draws (``categorical``, ``uniform_discrete``, ...) take
    it, as ``jax.random``'s do."""
    return (torch.int64 if torch.get_default_dtype() == torch.float64
            else torch.int32)


def is_inexact(x) -> bool:
    """True for floating or complex tensors and Python floats/complexes."""
    if isinstance(x, torch.Tensor):
        return x.is_floating_point() or x.is_complex()
    return isinstance(x, (float, complex))


def partition_inexact(tree):
    """Split a pytree into (differentiable, static) halves: inexact leaves
    go to the first, everything else (ints, bools, non-tensors) to the
    second; ``None`` fills the holes."""
    dyn = pytree.tree_map(lambda x: x if is_inexact(x) else None, tree)
    static = pytree.tree_map(lambda x: None if is_inexact(x) else x, tree)
    return dyn, static


def combine(dyn, static):
    """Inverse of :func:`partition_inexact`."""
    return pytree.tree_map(lambda a, b: b if a is None else a, dyn, static)


def tree_vdot(a, b):
    """Sum of elementwise products over matching leaves; ``a`` may be None
    (-> 0). The <retgrad, retval> term of the gradient methods."""
    if a is None:
        return torch.tensor(0.0)
    total = torch.tensor(0.0)
    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
        total = total + torch.sum(torch.as_tensor(x) * torch.as_tensor(y))
    return total


def is_static_scalar(x) -> bool:
    """Values that stay in the pytree spec rather than becoming leaves:
    everything that is not a tensor (Python numbers, strings, None).
    ``torch.func.vmap`` accepts only tensors as leaves."""
    return not isinstance(x, torch.Tensor)


def split_static(tree, mask=None):
    """Partition a pytree's leaves into tensor children and hashable static
    aux, for trace pytree registrations. Returns (dyn_children, aux).
    ``mask`` (from an earlier aux) fixes which leaves are static: pytree
    utilities re-flatten a tree whose tensors were replaced by other
    leaves, and the structure must not change under them."""
    flat, spec = pytree.tree_flatten(tree)
    if mask is None:
        mask = tuple(is_static_scalar(x) for x in flat)
    dyn = [x for x, s in zip(flat, mask) if not s]
    static = tuple(x for x, s in zip(flat, mask) if s)
    return dyn, (spec, mask, static)


def join_static(dyn, aux):
    spec, mask, static = aux
    dyn_iter = iter(dyn)
    static_iter = iter(static)
    flat = [next(static_iter) if s else next(dyn_iter) for s in mask]
    return pytree.tree_unflatten(flat, spec)


def logsumexp(x, dim=None):
    """Numerically stable logsumexp over ``dim`` (all elements if None)."""
    x = torch.as_tensor(x)
    if dim is None:
        return torch.logsumexp(x.reshape(-1), dim=0)
    return torch.logsumexp(x, dim=dim)


def sqrt_mass_safe(inv_mass: torch.Tensor) -> torch.Tensor:
    """Momentum scale with frozen-coordinate support: inv_mass == 0 means
    infinite mass; its momentum draw is zero and every other momentum use
    is inv_mass-weighted, so the coordinate never moves. The one definition
    the sampler, the twin and (in C) the CUDA kernel share."""
    return torch.where(inv_mass > 0,
                       1.0 / torch.sqrt(torch.clamp(inv_mass, min=1e-30)),
                       torch.zeros_like(inv_mass))


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The bits of a float32 (or int32) tensor as uint32 values in int64
    (torch's uint32 lacks shifts on the CPU)."""
    if x.dtype == torch.float32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & _M32


def _as_i32(u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the int32 with the same bits."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def _bf16_bits(u: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even to bf16, as uint32 bits with the low half
    cleared. The carry of an all-ones-mantissa NaN wraps exactly as in
    uint32 arithmetic."""
    return (u + 0x7FFF + ((u >> 16) & 1)) & _HI16


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest bf16 value (ties to even), returned as
    float32, with gen_tpu's bit arithmetic ``(u + 0x7FFF + ((u >> 16) & 1))
    & 0xFFFF0000``. Equal to a cast through ``torch.bfloat16`` for every
    finite value; an all-ones-mantissa NaN can carry into the sign bit, the
    same artifact as in gen_tpu and in the CUDA kernel."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return _as_i32(_bf16_bits(_u32(x))).view(torch.float32)


def bf16_pack2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pack two float32 tensors as bf16x2 into one int32 tensor, ``a`` in
    the high half and ``b`` in the low half. Round trip = :func:`bf16_round`
    exactly."""
    hi = _bf16_bits(_u32(torch.as_tensor(a, dtype=torch.float32)))
    lo = _bf16_bits(_u32(torch.as_tensor(b, dtype=torch.float32))) >> 16
    return _as_i32(hi | lo)


def bf16_unpack2(p: torch.Tensor):
    """Inverse of :func:`bf16_pack2`: int32 -> (a, b) float32 tensors."""
    u = _u32(p)
    a = _as_i32(u & _HI16).view(torch.float32)
    b = _as_i32((u << 16) & _M32).view(torch.float32)
    return a, b
