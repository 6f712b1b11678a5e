"""Staging: turn a ``logp: (d,) -> scalar`` into straight-line per-chain code.

Counterpart: ``gen_tpu/ops/scalarize.py::stage_scalarized`` (part a: a
straight-line residual). On the TPU the pass had two jobs: avoid vmap's
tiny minor axes, which wasted the (8, 128) vector tile, and hoist the data
work out of the kernel. The first does not exist on Hopper; the second
does, and it is what lets an arbitrary ``@gen`` model run inside a
hand-written kernel at all.

The pass:

- **Trace** ``torch.func.grad_and_value(logp)`` with ``make_fx`` at a
  ``(d,)`` float32 input into a functionalized aten graph. The joint graph already holds
  the reverse-mode gradient, so the pass needs forward semantics only and
  never differentiates anything itself (gen_tpu's ``plane_vag`` takes a
  vjp of the scalarized program instead).
- **Partial-evaluate**: every node that does not depend on ``x`` runs once,
  in torch, on the target device. The results that the rest of the graph
  reads become ``res_consts``, one float32 vector; for ``normal_linear``
  that is the Gram matrix, so the kernel never sees the data points.
- **Scalarize the residual**: every remaining value is a
  :class:`ScalarArray` (its shape plus a flat list of elements); an element
  is a Python constant or a symbol ``x[i]``, ``r[k]`` or ``t<j>``. Array
  ops become Python loops over elements; each arithmetic element op
  appends one instruction to a straight-line program over ``x[0..d-1]`` and
  ``r[0..R-1]`` whose outputs are ``lp`` and ``g[0..d-1]``. Identical
  instructions are emitted once; operations on constants fold.
- **Render twice**: as a CUDA C++ ``__device__`` function that the fused
  kernel inlines (:meth:`StagedLogp.cuda_source`), and as torch ops on
  ``(n_chains,)`` tensors (:meth:`StagedLogp.vag`), the CPU and reference
  twin. Both run the same arithmetic in the same order.

A cast between float32 and bool becomes ``x != 0`` or ``b ? 1 : 0``, and
``xlogy``/``xlog1py`` are written out as torch computes them: the mixed
driver stages a model's discrete values as float coordinates. An aten op
outside the table raises ``ValueError`` naming it; nothing falls back
silently. gen_tpu's structured pieces (``scan``, ``cond``,
``cholesky``, ``triangular_solve``: part b) and streamed likelihoods
(``StreamArray`` and the in-kernel data loops: part c) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

aten = torch.ops.aten


class Sym:
    """A program symbol: ``x[i]`` (chain coordinate), ``r[i]`` (staged
    residual constant) or ``t<i>`` (instruction result)."""

    __slots__ = ("kind", "idx", "dtype")

    def __init__(self, kind: str, idx: int, dtype: str = "f"):
        self.kind, self.idx, self.dtype = kind, idx, dtype

    def key(self):
        return (self.kind, self.idx)

    def __repr__(self):
        return f"{self.kind}{self.idx}"


class ScalarArray:
    """An array value as original shape + flat element list."""

    __slots__ = ("shape", "elems")

    def __init__(self, shape, elems: List[Any]):
        self.shape = tuple(int(s) for s in shape)
        if len(elems) != math.prod(self.shape):
            raise AssertionError("ScalarArray: element count mismatch")
        self.elems = list(elems)

    @property
    def size(self):
        return len(self.elems)

    def index_array(self):
        return np.arange(self.size).reshape(self.shape)

    def take(self, idx: np.ndarray) -> "ScalarArray":
        return ScalarArray(idx.shape, [self.elems[i] for i in
                                       idx.reshape(-1)])

    def __repr__(self):
        return f"ScalarArray(shape={self.shape}, n={self.size})"


def _dtype_of(e) -> str:
    if isinstance(e, Sym):
        return e.dtype
    return "b" if isinstance(e, (bool, np.bool_)) else "f"


def _f32(v) -> float:
    return float(np.float32(v))


# element ops: name -> (result dtype, numpy fold, CUDA, torch)
_OPS: Dict[str, Tuple[str, Any, str, str]] = {
    "neg": ("f", np.negative, "(-{0})", "(-{0})"),
    "exp": ("f", np.exp, "expf({0})", "torch.exp({0})"),
    "log": ("f", np.log, "logf({0})", "torch.log({0})"),
    "log1p": ("f", np.log1p, "log1pf({0})", "torch.log1p({0})"),
    "expm1": ("f", np.expm1, "expm1f({0})", "torch.expm1({0})"),
    "sqrt": ("f", np.sqrt, "sqrtf({0})", "torch.sqrt({0})"),
    "rsqrt": ("f", lambda a: 1 / np.sqrt(a), "rsqrtf({0})",
              "torch.rsqrt({0})"),
    "reciprocal": ("f", lambda a: 1 / a, "(1.0f / {0})",
                   "torch.reciprocal({0})"),
    "abs": ("f", np.abs, "fabsf({0})", "torch.abs({0})"),
    "sin": ("f", np.sin, "sinf({0})", "torch.sin({0})"),
    "cos": ("f", np.cos, "cosf({0})", "torch.cos({0})"),
    "tanh": ("f", np.tanh, "tanhf({0})", "torch.tanh({0})"),
    "sigmoid": ("f", lambda a: 1 / (1 + np.exp(-a)),
                "(1.0f / (1.0f + expf(-{0})))", "torch.sigmoid({0})"),
    "erf": ("f", None, "erff({0})", "torch.erf({0})"),
    "lgamma": ("f", None, "lgammaf({0})", "torch.lgamma({0})"),
    "sign": ("f", np.sign, "_sgn({0})", "torch.sign({0})"),
    "isnan": ("b", np.isnan, "isnan({0})", "torch.isnan({0})"),
    "not": ("b", np.logical_not, "(!{0})", "torch.logical_not({0})"),
    "add": ("f", np.add, "({0} + {1})", "({0} + {1})"),
    "sub": ("f", np.subtract, "({0} - {1})", "({0} - {1})"),
    "mul": ("f", np.multiply, "({0} * {1})", "({0} * {1})"),
    "div": ("f", np.divide, "({0} / {1})", "({0} / {1})"),
    "pow": ("f", np.power, "powf({0}, {1})", "torch.pow({0}, {1})"),
    "maximum": ("f", np.maximum, "_nanmax({0}, {1})",
                "torch.maximum({0}, {1})"),
    "minimum": ("f", np.minimum, "_nanmin({0}, {1})",
                "torch.minimum({0}, {1})"),
    "lt": ("b", np.less, "({0} < {1})", "({0} < {1})"),
    "le": ("b", np.less_equal, "({0} <= {1})", "({0} <= {1})"),
    "gt": ("b", np.greater, "({0} > {1})", "({0} > {1})"),
    "ge": ("b", np.greater_equal, "({0} >= {1})", "({0} >= {1})"),
    "eq": ("b", np.equal, "({0} == {1})", "({0} == {1})"),
    "ne": ("b", np.not_equal, "({0} != {1})", "({0} != {1})"),
    "and": ("b", np.logical_and, "({0} && {1})",
            "torch.logical_and({0}, {1})"),
    "or": ("b", np.logical_or, "({0} || {1})",
           "torch.logical_or({0}, {1})"),
    "where": ("f", np.where, "({0} ? {1} : {2})",
              "torch.where({0}, {1}, {2})"),
}

_CUDA_HELPERS = """\
__device__ __forceinline__ float _nanmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float _nanmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float _sgn(float a) {
  return a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : a);
}
"""


class Program:
    """A straight-line program over ``x[0..d-1]`` and ``r[0..R-1]``."""

    def __init__(self):
        self.instrs: List[Tuple[str, Tuple]] = []   # (op, args)
        self.dtypes: List[str] = []
        self._memo: Dict[Tuple, Sym] = {}

    def emit(self, op: str, *args):
        out_dt, fold, _, _ = _OPS[op]
        if op == "where":
            out_dt = "f" if "f" in (_dtype_of(args[1]),
                                    _dtype_of(args[2])) else "b"
        elif out_dt == "f" and any(_dtype_of(a) == "b" for a in args):
            raise ValueError(f"scalarize: arithmetic '{op}' on a boolean "
                             "value is not supported")
        if op == "where" and not isinstance(args[0], Sym):
            return args[1] if args[0] else args[2]
        if not any(isinstance(a, Sym) for a in args):
            if fold is None:
                raise ValueError(f"scalarize: cannot fold '{op}' on "
                                 "constants")
            with np.errstate(all="ignore"):
                v = fold(*[np.float32(a) if isinstance(a, float) else a
                           for a in args])
            return bool(v) if out_dt == "b" else _f32(v)
        # exact identities only (1*y = y for every y, NaN included)
        if op == "mul":
            if isinstance(args[0], float) and args[0] == 1.0:
                return args[1]
            if isinstance(args[1], float) and args[1] == 1.0:
                return args[0]
        if op in ("add", "sub") and isinstance(args[1], float) \
                and args[1] == 0.0:
            return args[0]
        if op == "add" and isinstance(args[0], float) and args[0] == 0.0:
            return args[1]
        if op == "div" and isinstance(args[1], float):
            # torch divides by a scalar as a multiply by its float32
            # reciprocal; emit that in both renderings
            return self.emit("mul", args[0], _f32(np.float32(1.0)
                                                  / np.float32(args[1])))
        if op == "div" and isinstance(args[0], float):
            return self.emit("mul", self.emit("reciprocal", args[1]),
                             args[0])
        if op == "pow" and isinstance(args[1], float) \
                and args[1] in (2.0, 3.0):
            # torch's pow kernel special-cases these as products
            y = self.emit("mul", args[0], args[0])
            return y if args[1] == 2.0 else self.emit("mul", y, args[0])
        key = (op,) + tuple(a.key() if isinstance(a, Sym)
                            else (type(a).__name__, a) for a in args)
        if key in self._memo:
            return self._memo[key]
        sym = Sym("t", len(self.instrs), out_dt)
        self.instrs.append((op, args))
        self.dtypes.append(out_dt)
        self._memo[key] = sym
        return sym


def _cuda_lit(e) -> str:
    if isinstance(e, Sym):
        return f"{e.kind}[{e.idx}]" if e.kind in "xr" else f"t{e.idx}"
    if isinstance(e, (bool, np.bool_)):
        return "true" if e else "false"
    if math.isnan(e):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(e):
        return "__int_as_float(0x7f800000)" if e > 0 else \
            "__int_as_float(0xff800000)"
    return float(e).hex() + "f"


def _torch_lit(e) -> str:
    if isinstance(e, Sym):
        return f"{e.kind}[{e.idx}]" if e.kind in "xr" else f"t{e.idx}"
    if isinstance(e, (bool, np.bool_)):
        return repr(bool(e))
    if math.isnan(e):
        return "nan"
    if math.isinf(e):
        return "inf" if e > 0 else "(-inf)"
    return repr(float(e))


class StagedLogp:
    """Result of :func:`stage_scalarized`.

    - ``res_consts``: float32 ``(R,)`` tensor of staged residual constants,
      on the device the logp was staged for.
    - ``vag(x)``: the torch rendering; ``x`` is ``(d, n)``, returns
      ``(lp (n,), grad (d, n))``.
    - ``cuda_source()``: the CUDA C++ rendering, a ``__device__`` function
      ``staged_vag(const float* x, const float* r, float& lp, float* g)``.
    """

    def __init__(self, d: int, prog: Program, lp, grads, res_consts):
        self.d = d
        self.prog = prog
        self.lp = lp
        self.grads = list(grads)
        self.res_consts = res_consts
        self.n_res = int(res_consts.shape[0])
        self.torch_source = self._render_torch()
        namespace = {"torch": torch, "inf": math.inf, "nan": math.nan}
        exec(compile(self.torch_source, "<staged_vag>", "exec"), namespace)
        self._torch_fn = namespace["staged_vag"]

    @property
    def n_instructions(self) -> int:
        return len(self.prog.instrs)

    def _render_torch(self) -> str:
        lines = ["def staged_vag(x, r):"]
        for j, (op, args) in enumerate(self.prog.instrs):
            lits = [_torch_lit(a) for a in args]
            if op in ("maximum", "minimum") and not all(
                    isinstance(a, Sym) for a in args):
                # torch.maximum takes tensors only; clamp has the same
                # NaN propagation
                t, c = (lits if isinstance(args[0], Sym) else lits[::-1])
                bound = "min" if op == "maximum" else "max"
                expr = f"torch.clamp({t}, {bound}={c})"
            else:
                expr = _OPS[op][3].format(*lits)
            lines.append(f"    t{j} = {expr}")
        outs = ", ".join(_torch_lit(g) for g in self.grads)
        lines.append(f"    return {_torch_lit(self.lp)}, [{outs}]")
        return "\n".join(lines) + "\n"

    def cuda_source(self) -> str:
        lines = [_CUDA_HELPERS,
                 "__device__ __forceinline__ void staged_vag("
                 "const float* x, const float* r, float& lp, float* g) {"]
        for j, (op, args) in enumerate(self.prog.instrs):
            ctype = "bool" if self.prog.dtypes[j] == "b" else "float"
            expr = _OPS[op][2].format(*[_cuda_lit(a) for a in args])
            lines.append(f"  const {ctype} t{j} = {expr};")
        lines.append(f"  lp = {_cuda_lit(self.lp)};")
        for i, g in enumerate(self.grads):
            lines.append(f"  g[{i}] = {_cuda_lit(g)};")
        lines.append("}")
        return "\n".join(lines) + "\n"

    def vag(self, x: torch.Tensor):
        """Value and gradient at ``x`` of shape ``(d, n)`` through the torch
        rendering: ``(lp (n,), grad (d, n))``."""
        lp, gs = self._torch_fn(list(x), list(self.res_consts))
        shape = x.shape[1:]

        def full(v):
            v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
            return v.expand(shape)

        return full(lp), torch.stack([full(g) for g in gs])


# -- evaluation of the residual graph at the ScalarArray level ----------------

_UNARY_ATEN = {
    aten.neg.default: "neg", aten.exp.default: "exp",
    aten.log.default: "log", aten.log1p.default: "log1p",
    aten.expm1.default: "expm1", aten.sqrt.default: "sqrt",
    aten.rsqrt.default: "rsqrt", aten.reciprocal.default: "reciprocal",
    aten.abs.default: "abs", aten.sin.default: "sin",
    aten.cos.default: "cos", aten.tanh.default: "tanh",
    aten.sigmoid.default: "sigmoid", aten.erf.default: "erf",
    aten.lgamma.default: "lgamma", aten.sign.default: "sign",
    aten.sgn.default: "sign", aten.isnan.default: "isnan",
    aten.logical_not.default: "not",
}
_BINARY_ATEN = {
    aten.mul.Tensor: "mul", aten.mul.Scalar: "mul",
    aten.div.Tensor: "div", aten.div.Scalar: "div",
    aten.pow.Tensor_Scalar: "pow", aten.pow.Tensor_Tensor: "pow",
    aten.pow.Scalar: "pow",
    aten.maximum.default: "maximum", aten.minimum.default: "minimum",
    aten.lt.Tensor: "lt", aten.lt.Scalar: "lt",
    aten.le.Tensor: "le", aten.le.Scalar: "le",
    aten.gt.Tensor: "gt", aten.gt.Scalar: "gt",
    aten.ge.Tensor: "ge", aten.ge.Scalar: "ge",
    aten.eq.Tensor: "eq", aten.eq.Scalar: "eq",
    aten.ne.Tensor: "ne", aten.ne.Scalar: "ne",
    aten.logical_and.default: "and", aten.logical_or.default: "or",
}
_XLOGY_ATEN = {
    aten.xlogy.Tensor: "log", aten.xlogy.Scalar_Other: "log",
    aten.xlogy.Scalar_Self: "log",
    aten.special_xlog1py.default: "log1p",
    aten.special_xlog1py.other_scalar: "log1p",
    aten.special_xlog1py.self_scalar: "log1p",
}
_IDENTITY_ATEN = {
    aten.clone.default, aten.alias.default, aten.detach.default,
    aten.lift_fresh_copy.default, aten.contiguous.default,
}
_FILL_ATEN = {
    aten.zeros.default: 0.0, aten.ones.default: 1.0,
    aten.zeros_like.default: 0.0, aten.ones_like.default: 1.0,
    aten.new_zeros.default: 0.0, aten.new_ones.default: 1.0,
}
# staged constants the kernel keeps in shared memory (gen_tpu's cap)
MAX_RESIDUAL_SCALARS = 1024
_DEFERRED = ("cond", "scan", "while_loop", "cholesky", "triangular_solve",
             "solve_triangular")


def _as_sa(v) -> ScalarArray:
    if isinstance(v, ScalarArray):
        return v
    if isinstance(v, (bool, np.bool_)):
        return ScalarArray((), [bool(v)])
    if isinstance(v, (int, float)):
        return ScalarArray((), [_f32(v)])
    raise ValueError(f"scalarize: unexpected operand {type(v).__name__}")


def _broadcast(*args):
    """The broadcast shape of the operands and their elements, zipped."""
    sas = [_as_sa(a) for a in args]
    shape = np.broadcast_shapes(*[a.shape for a in sas])
    cols = [a.take(np.broadcast_to(a.index_array(), shape)).elems
            for a in sas]
    return shape, zip(*cols)


def _elementwise(prog: Program, op: str, *args) -> ScalarArray:
    shape, rows = _broadcast(*args)
    return ScalarArray(shape, [prog.emit(op, *xs) for xs in rows])


def _sum_elems(prog, elems):
    acc = elems[0]
    for e in elems[1:]:
        acc = prog.emit("add", acc, e)
    return acc


def _reduce_sum(prog, a: ScalarArray, dims, keepdim=False):
    nd = len(a.shape)
    dims = sorted({d % nd for d in dims}) if dims else list(range(nd))
    keep = [i for i in range(nd) if i not in dims]
    out_shape = tuple(a.shape[i] for i in keep)
    idx = np.transpose(a.index_array(), keep + dims).reshape(
        math.prod(out_shape), -1)
    elems = [_sum_elems(prog, [a.elems[i] for i in row]) for row in idx]
    if keepdim:
        out_shape = tuple(1 if i in dims else s
                          for i, s in enumerate(a.shape))
    return ScalarArray(out_shape, elems)


def _matmul(prog, a: ScalarArray, b: ScalarArray):
    """mm / mv / dot as explicit sums of products, k in order."""
    A = a.index_array().reshape(a.shape if len(a.shape) == 2
                                else (1, a.shape[0]))
    B = b.index_array().reshape(b.shape if len(b.shape) == 2
                                else (b.shape[0], 1))
    elems = []
    for i in range(A.shape[0]):
        for j in range(B.shape[1]):
            elems.append(_sum_elems(prog, [
                prog.emit("mul", a.elems[A[i, k]], b.elems[B[k, j]])
                for k in range(A.shape[1])]))
    shape = tuple(s for s, keep in ((A.shape[0], len(a.shape) == 2),
                                    (B.shape[1], len(b.shape) == 2))
                  if keep)
    return ScalarArray(shape, elems)


def _view_shape(shape, size):
    shape = list(shape)
    if -1 in shape:
        k = shape.index(-1)
        rest = math.prod(s for i, s in enumerate(shape) if i != k)
        shape[k] = size // rest
    return tuple(shape)


def _scatter_zeros(grad: ScalarArray, sizes, dst_index):
    """Zeros of ``sizes`` with ``grad`` written at ``dst_index`` (an index
    array into the output, shaped like ``grad``)."""
    out = [0.0] * math.prod(sizes)
    for src, dst in zip(grad.elems, dst_index.reshape(-1)):
        out[int(dst)] = src
    return ScalarArray(tuple(sizes), out)


def _cast_elem(prog: Program, e, dt: str):
    if _dtype_of(e) == dt:
        return e
    if dt == "b":
        return prog.emit("ne", e, 0.0)
    return prog.emit("where", e, 1.0, 0.0)


def _cast(prog: Program, a, dt: str) -> ScalarArray:
    """Elementwise cast between float32 and bool: a float becomes ``x !=
    0``, a bool 1.0 or 0.0, so that a cast value carries the cast's
    semantics into whatever reads it."""
    a = _as_sa(a)
    return ScalarArray(a.shape, [_cast_elem(prog, e, dt) for e in a.elems])


def _xlogy(prog: Program, log_op: str, x, y) -> ScalarArray:
    """torch's ``xlogy``/``xlog1py``: NaN where y is NaN, else 0 where x
    is 0, else x * log(y) (log1p(y))."""
    def one(a, b):
        out = prog.emit("where", prog.emit("eq", a, 0.0), 0.0,
                        prog.emit("mul", a, prog.emit(log_op, b)))
        return prog.emit("where", prog.emit("isnan", b), math.nan, out)

    shape, rows = _broadcast(x, y)
    return ScalarArray(shape, [one(a, b) for a, b in rows])


def _apply(prog: Program, target, args, kwargs) -> ScalarArray:
    name = getattr(target, "__name__", str(target))
    if target in _UNARY_ATEN:
        return _elementwise(prog, _UNARY_ATEN[target], args[0])
    if target in _BINARY_ATEN:
        if target in (aten.div.Tensor, aten.div.Scalar) and \
                kwargs.get("rounding_mode") is not None:
            raise ValueError("scalarize: aten.div with rounding_mode is "
                             "not supported")
        return _elementwise(prog, _BINARY_ATEN[target], args[0], args[1])
    if target in (aten.add.Tensor, aten.add.Scalar, aten.sub.Tensor,
                  aten.sub.Scalar, aten.rsub.Scalar, aten.rsub.Tensor):
        a, b = args[0], args[1]
        alpha = kwargs.get("alpha", args[2] if len(args) > 2 else 1)
        if alpha != 1:
            b = _elementwise(prog, "mul", b, float(alpha))
        if target in (aten.rsub.Scalar, aten.rsub.Tensor):
            a, b = b, a
        op = "add" if target in (aten.add.Tensor, aten.add.Scalar) else "sub"
        return _elementwise(prog, op, a, b)
    if target is aten.where.self:
        return _elementwise(prog, "where", *args)
    if target is aten.sigmoid_backward.default:     # g * (1 - y) * y
        g, y = args
        return _elementwise(prog, "mul", _elementwise(
            prog, "mul", g, _elementwise(prog, "sub", 1.0, y)), y)
    if target is aten.tanh_backward.default:        # g * (1 - y * y)
        g, y = args
        return _elementwise(prog, "mul", g, _elementwise(
            prog, "sub", 1.0, _elementwise(prog, "mul", y, y)))
    if target in (aten.masked_fill.Scalar, aten.masked_fill.Tensor):
        return _elementwise(prog, "where", args[1], args[2], args[0])
    if target in (aten.clamp.default, aten.clamp_min.default,
                  aten.clamp_max.default):
        x = args[0]
        lo = args[1] if target is not aten.clamp_max.default else None
        hi = (args[2] if len(args) > 2 else kwargs.get("max")) \
            if target is aten.clamp.default else \
            (args[1] if target is aten.clamp_max.default else None)
        if lo is not None:
            x = _elementwise(prog, "maximum", x, lo)
        if hi is not None:
            x = _elementwise(prog, "minimum", x, hi)
        return x
    if target in _IDENTITY_ATEN:
        return args[0]
    if target is aten._to_copy.default:
        dt = kwargs.get("dtype")
        if dt is torch.bool:
            return _cast(prog, args[0], "b")
        if dt in (None, torch.float32):
            return _cast(prog, args[0], "f")
        raise ValueError(f"scalarize: conversion to {dt} in the "
                         "x-dependent part of logp; the staged "
                         "program is float32")
    if target in _XLOGY_ATEN:       # torch's xlogy/xlog1py, written out
        return _xlogy(prog, _XLOGY_ATEN[target], args[0], args[1])
    if target in _FILL_ATEN:
        src = args[0]
        shape = src.shape if isinstance(src, ScalarArray) else tuple(src)
        if target in (aten.new_zeros.default, aten.new_ones.default):
            shape = tuple(args[1])
        return ScalarArray(shape, [_FILL_ATEN[target]] * math.prod(shape))
    if target in (aten.full.default, aten.full_like.default):
        shape = tuple(args[0]) if target is aten.full.default \
            else args[0].shape
        return ScalarArray(shape, [_f32(args[1])] * math.prod(shape))
    if target is aten.scalar_tensor.default:
        return _as_sa(args[0])
    if target in (aten.view.default, aten._unsafe_view.default,
                  aten.reshape.default):
        a = args[0]
        return ScalarArray(_view_shape(args[1], a.size), a.elems)
    if target in (aten.squeeze.default, aten.squeeze.dim,
                  aten.squeeze.dims):
        a = args[0]
        dims = range(len(a.shape)) if len(args) < 2 else (
            [args[1]] if isinstance(args[1], int) else args[1])
        dims = {d % max(len(a.shape), 1) for d in dims}
        return ScalarArray(tuple(s for i, s in enumerate(a.shape)
                                 if not (i in dims and s == 1)), a.elems)
    if target is aten.unsqueeze.default:
        a = args[0]
        shape = list(a.shape)
        dim = args[1] % (len(shape) + 1)
        shape.insert(dim, 1)
        return ScalarArray(shape, a.elems)
    if target is aten.expand.default:
        a = args[0]
        shape = list(args[1])
        off = len(shape) - len(a.shape)
        shape = [a.shape[i - off] if s == -1 else s
                 for i, s in enumerate(shape)]
        return a.take(np.broadcast_to(a.index_array(), shape))
    if target is aten.permute.default:
        a = args[0]
        return a.take(np.transpose(a.index_array(), args[1]))
    if target is aten.t.default:
        a = args[0]
        return a.take(a.index_array().T)
    if target is aten.transpose.int:
        a = args[0]
        return a.take(np.swapaxes(a.index_array(), args[1], args[2]))
    if target is aten.slice.Tensor:
        a = args[0]
        dim, start, end, step = (list(args[1:]) + [0, None, None, 1][
            len(args) - 1:])[:4]
        sl = [slice(None)] * len(a.shape)
        sl[dim] = slice(start, end, step)
        return a.take(a.index_array()[tuple(sl)])
    if target is aten.select.int:
        a = args[0]
        sl = [slice(None)] * len(a.shape)
        sl[args[1]] = args[2]
        return a.take(a.index_array()[tuple(sl)])
    if target is aten.slice_backward.default:
        grad, sizes, dim, start, end, step = args
        sl = [slice(None)] * len(sizes)
        sl[dim] = slice(start, end, step)
        dst = np.arange(math.prod(sizes)).reshape(sizes)[tuple(sl)]
        return _scatter_zeros(grad, sizes, dst)
    if target is aten.select_backward.default:
        grad, sizes, dim, index = args
        sl = [slice(None)] * len(sizes)
        sl[dim] = index
        dst = np.arange(math.prod(sizes)).reshape(sizes)[tuple(sl)]
        return _scatter_zeros(grad, sizes, dst)
    if target in (aten.cat.default, aten.stack.default):
        parts = [_as_sa(p) for p in args[0]]
        dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
        if target is aten.stack.default:
            nd = len(parts[0].shape) + 1
            dim %= nd
            parts = [ScalarArray(p.shape[:dim] + (1,) + p.shape[dim:],
                                 p.elems) for p in parts]
        parts = [p for p in parts if p.size or len(p.shape) > 1]
        nd = len(parts[0].shape)
        dim %= nd
        offsets = np.cumsum([0] + [p.size for p in parts])
        ids = np.concatenate(
            [p.index_array() + off for p, off in zip(parts, offsets)],
            axis=dim)
        allel = [e for p in parts for e in p.elems]
        return ScalarArray(ids.shape, [allel[i] for i in ids.reshape(-1)])
    if target is aten.sum.default:
        return _reduce_sum(prog, args[0], None)
    if target is aten.sum.dim_IntList:
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        return _reduce_sum(prog, args[0], dims, keep)
    if target in (aten.mm.default, aten.mv.default, aten.dot.default):
        return _matmul(prog, args[0], args[1])
    if any(k in name for k in _DEFERRED):
        raise ValueError(
            f"scalarize: op '{name}' is not supported: staging of "
            "scan/cond/cholesky/triangular_solve is not ported yet")
    raise ValueError(f"scalarize: aten op '{name}' is not supported in the "
                     "x-dependent part of logp")


def _to_elements(v, res_vals: List[torch.Tensor]):
    """A known (partially evaluated) value as program elements: tensors
    become staged residual constants, Python numbers stay literals."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bool or not torch.is_floating_point(v):
            vals = v.detach().cpu().reshape(-1).tolist()
            return ScalarArray(v.shape, [bool(e) if v.dtype == torch.bool
                                         else _f32(e) for e in vals])
        base = sum(int(t.numel()) for t in res_vals)
        res_vals.append(v.detach().reshape(-1))
        return ScalarArray(v.shape, [Sym("r", base + i)
                                     for i in range(v.numel())])
    return v


def stage_scalarized(logp, d: int, device=None) -> StagedLogp:
    """Stage ``logp`` for per-chain evaluation; see :class:`StagedLogp`.
    The data-only part runs once, here, on ``device``."""
    x0 = torch.zeros((d,), dtype=torch.float32, device=device)
    # functionalized, so that in-place ops from autograd's backward
    # formulas (e.g. clamp's masked_fill_) arrive as pure ops
    gm = make_fx(torch.func.functionalize(torch.func.grad_and_value(logp),
                                          remove="mutations"))(x0)

    known: Dict[Any, Any] = {}
    residual = {}
    # known nodes computed from graph literals alone (fills and what
    # follows from them): their elements become literals, not residual
    # constants, so they fold; the generated source stays data-independent
    literal_nodes = set()
    as_elements: Dict[Any, ScalarArray] = {}
    prog = Program()
    res_vals: List[torch.Tensor] = []
    out_node = None

    def is_res(a):
        return isinstance(a, torch.fx.Node) and a in residual

    def known_val(a):
        return torch.fx.node.map_arg(a, lambda n: known[n])

    def sa_val(a):
        def conv(n):
            if n in residual:
                return residual[n]
            if n not in as_elements:
                v = known[n]
                if n in literal_nodes:
                    as_elements[n] = ScalarArray(v.shape, [
                        _f32(e) for e in v.detach().cpu().reshape(-1)
                        .tolist()])
                else:
                    as_elements[n] = _to_elements(v, res_vals)
                    total = sum(int(t.numel()) for t in res_vals)
                    if total > MAX_RESIDUAL_SCALARS:
                        raise ValueError(
                            f"scalarized residual needs {total} staged "
                            f"scalars (> {MAX_RESIDUAL_SCALARS}): the "
                            "x-dependent part of this logp touches large "
                            "arrays (non-sufficient-statistic likelihood?); "
                            "streamed likelihoods are not ported yet")
            return as_elements[n]
        return torch.fx.node.map_arg(a, conv)

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            residual[node] = ScalarArray((d,), [Sym("x", i)
                                                for i in range(d)])
        elif node.op == "get_attr":
            known[node] = getattr(gm, node.target)
        elif node.op == "call_function":
            deps = []
            torch.fx.node.map_arg((node.args, node.kwargs), deps.append)
            if not any(is_res(a) for a in deps):
                val = node.target(*known_val(node.args),
                                  **known_val(node.kwargs))
                known[node] = val
                if (isinstance(val, torch.Tensor)
                        and torch.is_floating_point(val)
                        and val.numel() <= 64
                        and (node.target in _FILL_ATEN
                             or node.target in (aten.full.default,
                                                aten.scalar_tensor.default)
                             or (deps and all(a in literal_nodes
                                              for a in deps)))):
                    literal_nodes.add(node)
            else:
                residual[node] = _apply(prog, node.target,
                                        sa_val(node.args),
                                        sa_val(node.kwargs))
        elif node.op == "output":
            out_node = node
        else:
            raise ValueError(f"scalarize: graph node kind {node.op!r}")

    grad_out, val_out = sa_val(out_node.args[0])
    grad_out, val_out = _as_sa(grad_out), _as_sa(val_out)
    if val_out.size != 1 or grad_out.shape != (d,):
        raise ValueError(f"scalarize: logp must map (d,) to a scalar; got "
                         f"value {val_out.shape}, grad {grad_out.shape}")
    if res_vals:
        res = torch.cat([t.to(device=device, dtype=torch.float32)
                         for t in res_vals])
    else:
        res = torch.zeros((1,), dtype=torch.float32, device=device)
    return StagedLogp(d, prog, val_out.elems[0], grad_out.elems, res)
