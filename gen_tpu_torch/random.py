"""Explicit-key random numbers: threefry2x32, bit for bit as ``jax.random``.

Counterpart: ``jax.random`` (gen_tpu threads its keys through every
sampling GFI method). PyTorch's stateful ``torch.Generator`` cannot take its
place: ``torch.func.vmap`` rejects random ops that take a generator, and
``generate`` is vmapped over chains. So keys here are tensors of two 32-bit
words, held in ``int64`` (torch's ``uint32`` lacks shifts on the CPU) and
masked to 32 bits after every add and shift.

Matches ``jax.random`` under ``jax_threefry_partitionable=True`` (the
default from JAX 0.5): ``split``/``fold_in``/``bits`` hash a 64-bit iota
split into (hi, lo) words, and 32-bit bits are the XOR of the two output
words. Default dtypes follow JAX's 32-bit mode (float32, int32).

Normals use XLA's single-precision ``erf_inv`` polynomial (Giles 2010), not
``torch.special.erfinv``, which differs from it by up to 63 ulp. float64
normals fall back to ``torch.special.erfinv``: XLA's double-precision
coefficients are not reproduced here, so f64 normals agree with JAX to
~1e-12 relative, not bit for bit. ``exponential``, ``gumbel`` and
``categorical`` use ``jax.random``'s constructions on the same bits; their
logs are torch's, which may differ from XLA's in the last ulp.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from .utils import default_device

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block cipher (20 rounds) on int64 tensors holding
    uint32 words; ``k*`` broadcast against ``x*``. Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Key from an integer seed: words ``(seed >> 32, seed & 0xFFFFFFFF)``,
    as ``jax.random.PRNGKey`` builds them from a 64-bit seed. On the card
    unless ``device`` names another (:func:`gen_tpu_torch.utils.
    default_device`); everything drawn from a key follows its device."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64,
                        device=default_device() if device is None
                        else device)


def _hash_iota(key, shape):
    """threefry of the (hi, lo) words of ``arange(prod(shape))``."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0:1], key[..., 1:2], idx >> 32,
                          idx & _M32)
    return y0.reshape(shape), y1.reshape(shape)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``num`` new keys, shape ``(*num, 2)``."""
    y0, y1 = _hash_iota(key, _shape(num))
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """New key from ``key`` and a 32-bit integer. ``data`` may be a 1-D
    integer tensor: then one key per element, shape ``(n, 2)``, as
    ``jax.vmap(jax.random.fold_in, in_axes=(None, 0))`` gives them."""
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & _M32
        y0, y1 = threefry2x32(key[..., 0:1], key[..., 1:2],
                              torch.zeros_like(d), d)
        return torch.stack([y0, y1], dim=-1)
    d = torch.tensor([int(data) & _M32], dtype=torch.int64,
                     device=key.device)
    y0, y1 = threefry2x32(key[..., 0:1], key[..., 1:2],
                          torch.zeros_like(d), d)
    return torch.cat([y0, y1], dim=-1)


def bits(key: torch.Tensor, shape: Shape = (), width: int = 32):
    """Random bits as int64: ``width=32`` gives uint32 values; ``width=64``
    gives the (hi, lo) uint32 word pair of each 64-bit draw."""
    shape = _shape(shape)
    y0, y1 = _hash_iota(key, shape)
    if width == 32:
        return y0 ^ y1
    if width == 64:
        return y0, y1
    raise ValueError(f"bits: width must be 32 or 64, got {width}")


def uniform(key: torch.Tensor, shape: Shape = (), dtype=torch.float32,
            minval=0.0, maxval=1.0) -> torch.Tensor:
    """Uniform on [minval, maxval) from the top mantissa bits of one draw
    (``jax.random.uniform``'s construction; the float is built
    arithmetically, which is exact, so that it runs under vmap)."""
    shape = _shape(shape)
    if dtype == torch.float32:
        mant = (bits(key, shape, 32) >> 9).to(torch.float32)
        floats = mant * 2.0 ** -23
    elif dtype == torch.float64:
        hi, lo = bits(key, shape, 64)
        mant = ((hi << 20) | (lo >> 12)).to(torch.float64)
        floats = mant * 2.0 ** -52
    else:
        raise ValueError(f"uniform: unsupported dtype {dtype}")
    lo_t = torch.as_tensor(minval, dtype=dtype, device=key.device)
    hi_t = torch.as_tensor(maxval, dtype=dtype, device=key.device)
    if dtype == torch.float32:
        # XLA fuses the scale-and-shift into one fma; the float64 product
        # of a 23-bit and a 24-bit mantissa is exact, so one rounding of
        # the float64 sum reproduces it
        out = (floats.double() * (hi_t - lo_t).double()
               + lo_t.double()).float()
    else:
        out = floats * (hi_t - lo_t) + lo_t
    return torch.maximum(lo_t, out)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: Giles' two-branch polynomial in
    ``w = -log1p(-x*x)``, with erfinv(+-1) = +-inf."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(x.dtype)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b).to(x.dtype) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Shape = (),
           dtype=torch.float32) -> torch.Tensor:
    """Standard normals: ``sqrt(2) * erf_inv(u)`` with u uniform on the open
    interval (-1, 1), as ``jax.random.normal``."""
    lo = math.nextafter(-1.0, 0.0) if dtype == torch.float64 else \
        float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, dtype, lo, 1.0)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype, device=key.device)
    if dtype == torch.float32:
        return sqrt2 * erfinv_f32(u)
    return sqrt2 * torch.special.erfinv(u)


def bernoulli(key: torch.Tensor, p: float = 0.5, shape: Shape = (),
              dtype=None) -> torch.Tensor:
    """``uniform(key, shape, dtype) < p``, as ``jax.random.bernoulli``
    (its default mode). ``dtype`` is that of ``p``: JAX's default float,
    here ``torch.get_default_dtype()``."""
    dtype = torch.get_default_dtype() if dtype is None else dtype
    return uniform(key, shape, dtype) < p


def exponential(key: torch.Tensor, shape: Shape = (),
                dtype=None) -> torch.Tensor:
    """Standard exponentials ``-log1p(-u)``, as ``jax.random.exponential``.
    ``dtype`` defaults to ``torch.get_default_dtype()``, the counterpart of
    JAX's default float."""
    dtype = torch.get_default_dtype() if dtype is None else dtype
    return -torch.log1p(-uniform(key, shape, dtype))


def gumbel(key: torch.Tensor, shape: Shape = (), dtype=None) -> torch.Tensor:
    """Standard Gumbels ``-log(-log(u))`` with u uniform on [tiny, 1):
    ``jax.random.gumbel`` in its default ("low") mode."""
    dtype = torch.get_default_dtype() if dtype is None else dtype
    u = uniform(key, shape, dtype, torch.finfo(dtype).tiny, 1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                shape: Shape = None) -> torch.Tensor:
    """Draws from the categoricals over the last axis of ``logits`` by
    Gumbel-argmax, as ``jax.random.categorical`` (axis -1, with
    replacement): one Gumbel per category and draw, ties to the lowest
    index. ``shape`` defaults to the batch shape ``logits.shape[:-1]``;
    extra leading dimensions are independent draws. Returns int64."""
    batch_shape = tuple(logits.shape[:-1])
    shape = batch_shape if shape is None else _shape(shape)
    if shape[len(shape) - len(batch_shape):] != batch_shape:
        raise ValueError(f"categorical: shape {shape} is not compatible "
                         f"with the batch shape {batch_shape}")
    g = gumbel(key, (*shape, logits.shape[-1]), logits.dtype)
    return torch.argmax(g + logits, dim=-1)


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int,
            dtype=torch.int32) -> torch.Tensor:
    """Integers in [minval, maxval), ``jax.random.randint``'s construction:
    two draws of ``nbits`` each, combined modulo the span. Spans are
    limited to < 2**31."""
    shape = _shape(shape)
    minval, maxval = int(minval), int(maxval)
    span = max(maxval - minval, 1)
    if span >= 2 ** 31:
        raise ValueError("randint: span must be < 2**31")
    k1, k2 = split(key)
    if dtype == torch.int32:
        hb, lb = bits(k1, shape, 32), bits(k2, shape, 32)
        mult = (((2 ** 16 % span) ** 2) & _M32) % span   # uint32 wraps
        off = ((((hb % span) * mult) & _M32) + lb % span) & _M32
    elif dtype == torch.int64:
        r32 = 2 ** 32 % span

        def mod64(hl):
            hi, lo = hl
            return ((hi % span) * r32 + lo % span) % span

        hb, lb = mod64(bits(k1, shape, 64)), mod64(bits(k2, shape, 64))
        mult = r32 * r32 % span
        off = hb * mult + lb
    else:
        raise ValueError(f"randint: unsupported dtype {dtype}")
    return (minval + off % span).to(dtype)
