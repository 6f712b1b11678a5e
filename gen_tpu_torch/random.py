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

Normals use XLA's ``erf_inv`` polynomials (Giles 2010), not
``torch.special.erfinv``, which differs from them by up to 63 ulp in
float32 and ~5e5 ulp in float64. In float64 XLA's CPU backend fuses each
multiply-add of the polynomial and of its ``log1p`` into an FMA; torch has
no fused multiply-add, so :func:`_fma` emulates one exactly (Dekker's
product and a two-sum). Over 10^6 inputs, both tails included, the float64
``erf_inv`` equals ``jax.lax.erf_inv`` on the CPU bit for bit in 99.7% of
them and within 3 ulp in all (``log`` differs from XLA's in the last bit
for ~1% of arguments). ``exponential``, ``gumbel`` and
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


# XLA's ErfInv64 (Giles' double-precision coefficients), highest order
# first: 23 for w < 6.25, 19 for w < 16, 17 above
_ERFINV64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)
# XLA's log1p below sqrt(2) - 1: the Cephes rational, highest order first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_SPLIT = 134217729.0  # 2**27 + 1, Veltkamp's splitting constant


def _fma(a, b, c):
    """``a * b + c`` rounded once, in float64: Dekker's exact product and a
    two-sum of its high part with ``c`` (finite, non-overflowing inputs)."""
    p = a * b
    t = _SPLIT * a
    ah = t - (t - a)
    al = a - ah
    t = _SPLIT * b
    bh = t - (t - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    return s + (((p - (s - bb)) + (c - bb)) + e)


def _log1p_f64(x: torch.Tensor) -> torch.Tensor:
    """XLA's float64 ``log1p``: the Cephes rational below sqrt(2) - 1,
    ``log(1 + x)`` above, its multiply-adds fused."""
    xs = x * x

    def poly(cs):
        p = torch.full_like(x, cs[0])
        for c in cs[1:]:
            p = _fma(p, x, torch.full_like(x, c))
        return p

    small = (x * xs) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN))
    small = x + _fma(torch.full_like(x, -0.5), xs, small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       torch.log(x + 1.0))


def erfinv_f64(x: torch.Tensor) -> torch.Tensor:
    """XLA's float64 ``erf_inv``: Giles' three-branch polynomial in ``w =
    -log1p(-x*x)`` (w < 6.25, w < 16, above), Horner's steps fused as
    XLA's CPU backend fuses them, with erfinv(+-1) = +-inf."""
    w = -_log1p_f64(-x * x)
    lt6, lt16 = w < 6.25, w < 16.0
    w = torch.where(lt6, w - 3.125,
                    torch.sqrt(w) - torch.where(lt16, 3.25, 5.0))

    def coef(i):
        c = torch.full_like(x, _ERFINV64_LT625[i])
        if i < len(_ERFINV64_LT16):
            c = torch.where(lt6, c, _ERFINV64_LT16[i])
        if i < len(_ERFINV64_GE16):
            c = torch.where(lt16, c, _ERFINV64_GE16[i])
        return c

    p = coef(0)
    for i in range(1, len(_ERFINV64_GE16)):
        p = _fma(p, w, coef(i))
    for i in range(len(_ERFINV64_GE16), len(_ERFINV64_LT16)):
        p = torch.where(lt16, _fma(p, w, coef(i)), p)
    for i in range(len(_ERFINV64_LT16), len(_ERFINV64_LT625)):
        p = torch.where(lt6, _fma(p, w, coef(i)), p)
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
    return sqrt2 * erfinv_f64(u)


def multivariate_normal(key: torch.Tensor, mean, cov):
    """``jax.random.multivariate_normal(..., method="svd")``: ``mean +
    (u * sqrt(s)) @ z`` with ``u, s`` the SVD of ``cov`` (its signs are
    LAPACK's through torch, which may differ from XLA's) and ``z`` standard
    normals of shape ``(*batch, d)`` from ``key``, ``batch`` the broadcast
    batch shape of ``mean`` and ``cov``, in their promoted dtype."""
    mean, cov = torch.as_tensor(mean), torch.as_tensor(cov)
    if not mean.is_floating_point():
        mean = mean.to(torch.get_default_dtype())
    common = torch.promote_types(mean.dtype, cov.dtype)
    mean, cov = mean.to(common), cov.to(common)
    batch = torch.broadcast_shapes(mean.shape[:-1], cov.shape[:-2])
    u, s, _ = torch.linalg.svd(cov)
    factor = u * torch.sqrt(s[..., None, :])
    z = normal(key, (*batch, mean.shape[-1]), common)
    return mean + torch.einsum("...ij,...j->...i", factor, z)


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
