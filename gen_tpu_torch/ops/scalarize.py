"""Staging: turn a ``logp: (d,) -> scalar`` into straight-line per-chain code.

Counterpart: ``gen_tpu/ops/scalarize.py::stage_scalarized``, all three
parts. On the TPU the pass had two jobs: avoid vmap's tiny minor axes,
which wasted the (8, 128) vector tile, and hoist the data work out of the
kernel. The first does not exist on Hopper; the second does, and it is
what lets an arbitrary ``@gen`` model run inside a hand-written kernel at
all.

The pass:

- **Trace** the logp's value and gradient (``torch.autograd.grad``) with
  ``make_fx`` at a ``(d,)`` float32 input, then functionalize that graph,
  into an aten graph without in-place ops. The joint graph already holds
  the reverse-mode gradient, so the pass needs forward semantics only and
  never differentiates anything itself (gen_tpu's ``plane_vag`` takes a
  vjp of the scalarized program, and assembles the stream gradients by
  hand). Plain autograd, not ``torch.func.grad_and_value``: a
  :func:`~gen_tpu_torch.ops.scan.scan` arrives as a pair of custom ops,
  whose gradient functorch's transforms do not trace, and for every other
  model the two routes give the same program.
- **Partial-evaluate**: every node that does not depend on ``x`` runs once,
  in torch, on the target device. The results that the rest of the graph
  reads become ``res_consts``, one float32 vector; for ``normal_linear``
  that is the Gram matrix, so the kernel never sees the data points.
- **Scalarize the residual** (part a): every remaining value is a
  :class:`ScalarArray` (its shape plus a flat list of elements); an element
  is a Python constant or a symbol ``x[i]``, ``r[k]`` or ``t<j>``. Array
  ops become Python loops over elements; each arithmetic element op
  appends one instruction to a straight-line program whose outputs are
  ``lp`` and ``g[0..d-1]``. Identical instructions are emitted once;
  operations on constants fold.
- **Unroll the structured ops** (part b): ``linalg_cholesky_ex`` becomes
  gen_tpu's Cholesky-Banachiewicz, ``linalg_solve_triangular`` and
  ``cholesky_solve`` its forward and back substitutions, ``tril``,
  ``diagonal`` and their backward ops index arithmetic, each element plain
  arithmetic. gen_tpu's ``cond`` is ``torch.where`` over both branches,
  which part a stages.
- **Keep a scan rolled** (part b; gen_tpu's ``_eval_scan`` unrolls it):
  :func:`~gen_tpu_torch.ops.scan.scan` arrives as two nodes, its forward
  and its pullback. The step is traced once at the scan's real inputs and
  staged into the body of a :class:`Loop` over the T steps, which keeps
  the carry before each step on a tape; the pullback (the step recomputed
  from the carry, then its vjp) into the body of a second loop over the
  steps in reverse, which reads the tape. ``xs`` become residual
  constants indexed by the step. A sum over the steps of a stacked output
  becomes an accumulator of the forward loop, the gradient of each
  per-chain value the step reads one of the backward loop; any other use
  of a stacked output raises ``ValueError`` naming the node. A body
  instruction that reads nothing that changes from step to step runs
  before the loop. The staged program's size no longer grows with T.
- **Stream the data** (part c): a known float (or bool) array with one
  axis of at least ``stream_threshold`` points becomes a row of the stream
  table ``StagedLogp.stream_data``, and a value along that axis a
  :class:`StreamArray`: its per-point element is an instruction of a
  second, per-point program (``p<j>``, reading data rows ``d<i>`` and
  per-chain values). Every sum over the data axis (the logp's and each
  gradient coordinate's, which the joint graph holds as reductions)
  becomes one accumulator ``s<k>`` of a loop over the points, blocked and
  Kahan-compensated as gen_tpu's ``_blocked_accumulate``. A data-sum may
  not flow back into per-point arithmetic: a non-additive use of the
  likelihood shows in the joint graph as its derivative re-entering the
  loop, and is refused naming the data-sum, as gen_tpu refuses it.
- **The stream loop on Hopper** (:class:`StreamLayout`, one definition
  that both renderings read). What bounds it is the issue of the
  per-point arithmetic: a few dozen float operations per point and
  chain under ``-fmad=false``, each IEEE division ~10 instructions and a
  ``log1pf`` ~20 on the H100. So the loop spends little around it: each
  lane evaluates ``points`` points of a tile (gen_tpu's
  ``STREAM_BLOCK``), adds them by a pairwise tree and the tile's total
  into its Kahan sum (gen_tpu's ``_block_contrib``): one compensated add
  per block, not four instructions per point and sum; the tiles
  (gen_tpu's ``STREAM_TILE`` DMA) are copied into a ring of shared
  memory that every chain of the block reads, with ``cp.async``, so the
  table crosses L2 once per block; the stream table
  (:func:`stream_table`) is padded to whole tiles and a point past the
  data contributes 0.0 by a select, as gen_tpu's edge padding is
  masked. K1, K3 and K6 take a layout fixed when they are built
  (:func:`fused_layout`: warps per chain from the data length, several
  chains a block where the gradient call is block-uniform); the
  staged-code kernel one chosen per call from chains and points
  (:func:`eval_layout`), which splits a chain's tiles over blocks when
  chains are few. The two orders differ in the last bits; each kernel
  equals its own plain version.
- **Render twice**: as CUDA C++ ``__device__`` functions that the fused
  kernels inline (:meth:`StagedLogp.cuda_source`), and as torch ops on
  ``(n_chains,)`` tensors (:meth:`StagedLogp.vag`), the CPU and reference
  twin. Both run the same arithmetic in the same order, the stream loop
  included (:func:`_stream_sums` is the loop's plain version), and the
  scan loops (``#pragma unroll 1`` loops in CUDA, the tape a local array
  of each thread; Python loops over the same steps in torch).
- **Split over a warp** (:class:`SplitProgram`, no counterpart in gen_tpu):
  for the warp-per-chain layout of K3 and K6 (32 < d <= 128) the same
  instructions run on the lanes that own their coordinates, and each
  reduction (recorded in ``Program.reductions``) becomes lane partials
  plus the butterfly; rendered as CUDA and as torch in that order. It
  does not split a program with scan loops: such a model takes the
  one-thread layout whatever its d.

A cast between float32 and bool becomes ``x != 0`` or ``b ? 1 : 0``, and
``xlogy``/``xlog1py`` are written out as torch computes them: the mixed
driver stages a model's discrete values as float coordinates. An aten op
outside the table raises ``ValueError`` naming it; nothing falls back
silently. ``while_loop``-style data-dependent recursions have no static
unrolling, in gen_tpu as here. A model with both a scan and a streamed
likelihood raises ``ValueError``.
"""

from __future__ import annotations

import heapq
import math
import operator
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from . import scan

aten = torch.ops.aten
_SCAN_OPS = (torch.ops.gen_tpu_torch.scan_fwd.default,
             torch.ops.gen_tpu_torch.scan_bwd.default)


class Sym:
    """A program symbol: ``x[i]`` (chain coordinate), ``r[i]`` (staged
    residual constant), ``t<i>`` (instruction result), ``s<i>`` (a data-sum,
    the stream loop's result), ``p<i>`` (a per-point instruction of the
    stream loop) or ``d<i>`` (data row i at the loop's current point); in
    a scan :class:`Loop`, ``u<i>`` (a body instruction), ``y<i>`` (element
    i of the step's data), ``c<i>`` (the loop's state: the forward loop's
    carry, the backward loop's cotangent of it), ``k<i>`` (slot i of the
    carry before the step, in the backward loop) and ``a<i>`` (a loop's
    result, read after it)."""

    __slots__ = ("kind", "idx", "dtype")

    def __init__(self, kind: str, idx: int, dtype: str = "f"):
        self.kind, self.idx, self.dtype = kind, idx, dtype

    def key(self):
        return (self.kind, self.idx)

    def __repr__(self):
        return f"{self.kind}{self.idx}"


def _per_point(e) -> bool:
    return isinstance(e, Sym) and e.kind in "pd"


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


class StreamArray:
    """A per-point value over the data axis (part c; gen_tpu's
    ``StreamArray``): ``shape`` holds the data axis (length ``n_pts``, the
    only axis longer than 1) and ``elem`` is the value at one point: a
    constant, a scalar symbol (the same at every point) or a per-point
    symbol of the stream loop. The data axis is never unrolled; a sum over
    it becomes one of the loop's accumulators."""

    __slots__ = ("shape", "elem")

    def __init__(self, shape, elem):
        self.shape = tuple(int(s) for s in shape)
        self.elem = elem

    @property
    def size(self):
        return math.prod(self.shape)

    def __repr__(self):
        return f"StreamArray(shape={self.shape})"


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
// a / b with IEEE rounding, given y = RN(1 / b), a normal number, without
// a reciprocal-unit call: q0 = RN(a y), then RN(q0 + (a - b q0) y) by two
// FMAs. Markstein's theorem proves this where q0 lies within one ulp of
// a / b: the remainder a - b q0 is then exact in one FMA. That premise can
// fail: where y is rounded away from 1 / b by nearly half an ulp (b's
// mantissa near all ones) and a / b lies just below a power of two, q0 is
// up to 1.5 ulp off and the remainder rounds. The helper's exactness rests
// on checks instead: chip_smoke.py's phase 1b sweeps all 2^32 numerators of
// every staged denominator and of edge and random ones on the card, and
// tests/test_torch_division.py emulates the two FMAs exactly, pairs aimed at
// that case included. The guard keeps what the checks cover: a quotient
// q0 between 2^-125 and 2^126 and a numerator of at least 2^-102 (the
// remainder, about 2^-24 |a|, then is not subnormal). Other inputs (zeros,
// subnormal or huge quotients, infinities, NaN) take the IEEE division
// itself, the same function there.
__device__ __forceinline__ bool _div_rcp_ok(float a, float q0) {
  return fabsf(a) >= 0x1p-102f && fabsf(q0) >= 0x1p-125f
      && fabsf(q0) <= 0x1p+126f;
}
__device__ __forceinline__ float _div_rcp(float a, float b, float y) {
  const float q0 = a * y;
  if (_div_rcp_ok(a, q0)) return __fmaf_rn(__fmaf_rn(-b, q0, a), y, q0);
  return a / b;
}
// a reciprocal computed at run time as _div_rcp's y: a subnormal one (|b|
// above 2^126) has lost precision, and becomes NaN, which fails the guard
__device__ __forceinline__ float _div_y(float y) {
  return fabsf(y) >= 0x1p-126f ? y : __int_as_float(0x7fc00000);
}
"""

_CUDA_KAHAN = """\
__device__ __forceinline__ void _kahan(float& a, float& c, float v) {
  const float y_ = v - c;
  const float s_ = a + y_;
  c = (s_ - a) - y_;
  a = s_;
}
"""

# the stream loop's tile copies: 16 bytes a thread with cp.async (cached
# in L2 only), waited on per thread, then made visible to the block by a
# barrier
_CUDA_STREAM = """\
__device__ __forceinline__ void _cp_commit() {
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void _cp_wait() {
  asm volatile("cp.async.wait_group %0;\\n" :: "n"(N) : "memory");
}
// points [p0, p0 + T) of each of the rows of the padded table sd (row
// stride ld) into dst (rows x T), every thread of the block copying
__device__ __forceinline__ void _stream_tile(float* dst,
                                             const float* __restrict__ sd,
                                             int ld, int p0, int T,
                                             int rows) {
  const int q4 = T / 4;
  for (int q = (int)threadIdx.x; q < rows * q4; q += (int)blockDim.x) {
    const int row = q / q4, c = 4 * (q - row * q4);
    const unsigned a = (unsigned)__cvta_generic_to_shared(dst + row * T + c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n"
                 :: "r"(a), "l"(sd + (size_t)row * ld + p0 + c) : "memory");
  }
}
"""

# exponents that torch's pow kernel computes by another op (so both
# renderings compute them that way)
_POW_AS = {1.0: None, 0.5: "sqrt", -0.5: "rsqrt", -1.0: "reciprocal"}


class Program:
    """A straight-line program. The main program runs over ``x[0..d-1]``,
    ``r[0..R-1]`` and the data-sums ``s<k>``; ``after`` maps each of its
    instructions that reads a data-sum (directly or not) to that sum, so
    that it can run after the stream loop. A per-point program (``kind
    "p"``) is the stream loop's body. ``reductions`` maps the last add of
    each reduction's chain to the chain's operands (three or more, after
    folding): the serial renderings write the chain, the warp-per-chain
    rendering (:class:`SplitProgram`) one n-ary sum split over lanes."""

    def __init__(self, kind: str = "t"):
        self.kind = kind
        self.instrs: List[Tuple[str, Tuple]] = []   # (op, args)
        self.dtypes: List[str] = []
        self.after: Dict[int, int] = {}
        self.reductions: Dict[int, Tuple] = {}
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
        if op == "pow" and isinstance(args[1], float):
            # torch's pow kernel special-cases these exponents
            if args[1] in (2.0, 3.0, -2.0):
                y = self.emit("mul", args[0], args[0])
                if args[1] == 3.0:
                    return self.emit("mul", y, args[0])
                return y if args[1] == 2.0 else self.emit("reciprocal", y)
            if args[1] in _POW_AS:
                as_op = _POW_AS[args[1]]
                return args[0] if as_op is None else self.emit(as_op,
                                                               args[0])
        key = (op,) + tuple(a.key() if isinstance(a, Sym)
                            else (type(a).__name__, a) for a in args)
        if key in self._memo:
            return self._memo[key]
        sym = Sym(self.kind, len(self.instrs), out_dt)
        for a in args:
            if isinstance(a, Sym) and a.kind == "s":
                self.after[sym.idx] = a.idx
            elif isinstance(a, Sym) and a.kind == "t" and a.idx in self.after:
                self.after[sym.idx] = self.after[a.idx]
        self.instrs.append((op, args))
        self.dtypes.append(out_dt)
        self._memo[key] = sym
        return sym


class _Stager:
    """The programs being built, and the stream loop's state: the data rows
    (``d<i>``), the data length ``n_pts`` and the data-sums (``s<k>``, each
    the sum over the points of one per-point element)."""

    def __init__(self, threshold: Optional[int]):
        self.prog = Program("t")
        self.pprog = Program("p")
        self.threshold = threshold
        self.n_pts: Optional[int] = None
        self.rows: List[torch.Tensor] = []
        self._row_of: Dict[Tuple, int] = {}
        self.sums: List[Any] = []
        self.sum_names: List[str] = []
        self._sum_of: Dict[Tuple, Sym] = {}
        self.node_name = ""
        self.structured = False     # a part-b op was unrolled
        self.loops: List["Loop"] = []
        self.scans: Dict[int, "Loop"] = {}    # a scan's key -> forward loop
        self._n_syms = {"c": 0, "a": 0}
        # residual constant -> its staged reciprocal (_stage_reciprocals),
        # and the constants whose reciprocal is exact (powers of two)
        self.rcp_res: Dict[int, int] = {}
        self.rcp_exact: set = set()

    def new_sym(self, kind: str, dtype: str = "f") -> Sym:
        """A fresh loop state (``c``) or loop result (``a``) symbol,
        numbered over the whole program."""
        i = self._n_syms[kind]
        self._n_syms[kind] += 1
        return Sym(kind, i, dtype)

    def emit(self, op: str, *args):
        if not any(_per_point(a) for a in args):
            return self.prog.emit(op, *args)
        for a in args:
            if isinstance(a, Sym) and a.kind in "st":
                k = a.idx if a.kind == "s" else self.prog.after.get(a.idx)
                if k is not None:
                    raise ValueError(
                        f"scalarize: the data-sum '{self.sum_names[k]}' "
                        f"re-enters per-point arithmetic at "
                        f"'{self.node_name}' (a data-sum combined "
                        "non-additively, or a second pass over the data); "
                        "a streamed likelihood must enter logp additively")
        return self.pprog.emit(op, *args)

    def set_length(self, n: int):
        if self.n_pts is None:
            self.n_pts = n
        elif self.n_pts != n:
            raise ValueError(f"scalarize: data arrays of lengths "
                             f"{self.n_pts} and {n} in one streamed "
                             "likelihood are not supported")

    def is_stream_shape(self, shape) -> bool:
        n = math.prod(shape)
        return (self.threshold is not None and n >= self.threshold
                and sum(s > 1 for s in shape) == 1)

    def data_leaf(self, v: torch.Tensor) -> "StreamArray":
        """A known array along the data axis: a constant if every element
        is equal, else a row of the data table."""
        self.set_length(int(v.numel()))
        flat = v.detach().reshape(-1)
        if bool((flat == flat[0]).all()):
            e = flat[0].item()
            return StreamArray(v.shape, bool(e) if v.dtype == torch.bool
                               else _f32(e))
        key = (flat.data_ptr(), flat.dtype, int(flat.numel()),
               flat.stride(0))
        if key not in self._row_of:
            self._row_of[key] = len(self.rows)
            self.rows.append(flat.to(torch.float32))
        d = Sym("d", self._row_of[key])
        return StreamArray(v.shape, self.emit("ne", d, 0.0)
                           if v.dtype == torch.bool else d)

    def data_sum(self, e):
        """The sum of ``e`` over the ``n_pts`` points."""
        if not _per_point(e):
            # the same value at every point: n times it, one rounding
            if isinstance(e, Sym):
                return self.prog.emit("mul", e, float(self.n_pts))
            return _f32(np.float64(e) * self.n_pts)
        if e.key() not in self._sum_of:
            self._sum_of[e.key()] = Sym("s", len(self.sums))
            self.sums.append(e)
            self.sum_names.append(self.node_name)
        return self._sum_of[e.key()]


class Loop:
    """A loop of the staged program over the ``n_steps`` steps of a scan:
    the forward loop (``reverse`` False) or the backward one, which runs
    over the same steps last to first and reads the forward loop's tape
    (``fwd``). It runs before main-program instruction ``pos``.

    - ``body`` (a :class:`Program` of kind ``"u"``) runs once a step. It
      reads the values before the loop, the step's data ``y<i>`` =
      ``r[ybase + t ywidth + i]``, the loop's state ``c<i>`` and, in the
      backward loop, the forward carry before the step ``k<i>`` (slot i).
    - ``state``/``inits``/``updates``: the state's symbols, their values
      before the first step and the body elements that replace them after
      each step. In the forward loop the state is the carry, one slot per
      element; a slot in ``fixed`` (a boolean flag that every step sets to
      one constant, as the ``first`` flag of the Kalman step) is ``init``
      at step 0 and the constant after, computed from t, and stays off
      the tape. The tape holds every other slot before each step.
    - ``accs``: loop results ``(a<i>, element)``, each the sum over the
      steps, in the loop's order, of a body element: a sum over the scan
      axis of a stacked output in the forward loop, the gradient of a
      value before the loop in the backward one.
    - ``live``: the body instructions the state and the results need, in
      order; the renderings emit only these."""

    def __init__(self, name: str, n_steps: int, reverse: bool, ywidth: int):
        self.name, self.n_steps, self.reverse = name, n_steps, reverse
        self.ybase, self.ywidth = 0, ywidth
        self.xs: Optional[torch.Tensor] = None     # a forward loop's data
        self.body = Program("u")
        self.state: List[Sym] = []
        self.inits: List[Any] = []
        self.updates: List[Any] = []
        self.fixed: Dict[int, Tuple[Any, Any]] = {}
        self.accs: List[Tuple[Sym, Any]] = []
        self._acc_of: Dict[Any, Sym] = {}
        self.fwd: Optional["Loop"] = None
        self.leaves: List[Tuple[Tuple[int, ...], str]] = []
        self.y_example: List[torch.Tensor] = []
        self.pos = 0
        self.live: List[int] = []

    def accumulate(self, st, e):
        """The symbol of the sum of body element ``e`` over the steps."""
        if not isinstance(e, Sym) and e == 0.0:
            return 0.0
        key = _elem_key(e)
        if key not in self._acc_of:
            self._acc_of[key] = getattr(st, "outer", st).new_sym("a")
            self.accs.append((self._acc_of[key], e))
        return self._acc_of[key]

    def tape_slots(self) -> List[int]:
        """The forward carry's slots on the tape, in column order."""
        return [i for i in range(len(self.state)) if i not in self.fixed]

    def carried(self):
        """``(state symbol, update)`` of every slot assigned each step."""
        return [(s, u) for i, (s, u) in enumerate(zip(self.state,
                                                      self.updates))
                if i not in self.fixed]

    def find_live(self):
        stack = [e.idx for e in [u for _, u in self.carried()]
                 + [e for _, e in self.accs]
                 if isinstance(e, Sym) and e.kind == "u"]
        live = set()
        while stack:
            j = stack.pop()
            if j not in live:
                live.add(j)
                stack += [a.idx for a in self.body.instrs[j][1]
                          if isinstance(a, Sym) and a.kind == "u"]
        self.live = sorted(live)


class _LoopStager:
    """Stages a loop's body: an instruction that reads nothing that changes
    from step to step is emitted into the main program, before the loop,
    instead."""

    def __init__(self, outer: _Stager, loop: Loop):
        self.outer, self.loop, self.prog = outer, loop, loop.body
        self.node_name = outer.node_name
        self._state = {s.key() for s in loop.state}

    @property
    def structured(self):
        return self.outer.structured

    @structured.setter
    def structured(self, v):
        self.outer.structured = v

    def _varies(self, a) -> bool:
        return isinstance(a, Sym) and (a.kind in "uyk"
                                       or a.key() in self._state)

    def emit(self, op: str, *args):
        if any(self._varies(a) for a in args):
            return self.prog.emit(op, *args)
        return self.outer.emit(op, *args)

    def is_stream_shape(self, shape) -> bool:
        return False


class Stacked:
    """An output of a scan stacked over its steps (shape ``(T,) + s``):
    ``elems`` are the forward loop's body elements of one step. Only a sum
    over the scan axis stages (a loop accumulator)."""

    __slots__ = ("loop", "shape", "elems")

    def __init__(self, loop: Loop, shape, elems):
        self.loop, self.shape, self.elems = loop, tuple(shape), list(elems)


def _cuda_lit(e) -> str:
    if isinstance(e, Sym):
        return f"{e.kind}[{e.idx}]" if e.kind in "xr" else f"{e.kind}{e.idx}"
    if isinstance(e, (bool, np.bool_)):
        return "true" if e else "false"
    if math.isnan(e):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(e):
        return "__int_as_float(0x7f800000)" if e > 0 else \
            "__int_as_float(0xff800000)"
    return float(e).hex() + "f"


def _torch_lit(e, scalar_prefix: str = "") -> str:
    """``scalar_prefix`` renames the per-chain symbols read inside the
    stream loop's body to their broadcastable copies."""
    if isinstance(e, Sym):
        if e.kind in "pd":
            return f"{e.kind}{e.idx}"
        if scalar_prefix:
            return f"{scalar_prefix}{e.kind}{e.idx}"
        return f"{e.kind}[{e.idx}]" if e.kind in "xr" else f"{e.kind}{e.idx}"
    if isinstance(e, (bool, np.bool_)):
        return repr(bool(e))
    if math.isnan(e):
        return "nan"
    if math.isinf(e):
        return "inf" if e > 0 else "(-inf)"
    return repr(float(e))


def _torch_expr(op, args, prefix=""):
    lits = [_torch_lit(a, prefix) for a in args]
    if op in ("maximum", "minimum") and not all(
            isinstance(a, Sym) for a in args):
        # torch.maximum takes tensors only; clamp has the same NaN
        # propagation
        t, c = (lits if isinstance(args[0], Sym) else lits[::-1])
        bound = "min" if op == "maximum" else "max"
        return f"torch.clamp({t}, {bound}={c})"
    return _OPS[op][3].format(*lits)


def _div_expr(a: str, b: str, y: str, exact: bool) -> str:
    """CUDA for ``a / b`` given ``y``, the reciprocal of ``b``: a multiply
    where ``y`` is exact, else ``_div_rcp``."""
    return f"({a} * {y})" if exact else f"_div_rcp({a}, {b}, {y})"


# above this many instructions the CUDA rendering is not inlined
INLINE_MAX_INSTRUCTIONS = 2000
# the CUDA rendering divides through a known reciprocal (``_div_rcp``) by a
# residual constant (its reciprocal is staged beside it) and by a per-chain
# value that one evaluation divides by at least REPEATED_DIVISIONS times (a
# division inside a loop by a value from before it counts once a step or a
# point; the reciprocal is computed once, after the value). On the H100 an
# IEEE division issues ~11 instructions on its fast path, with a
# reciprocal-unit call; the helper 9 and a multiply by an exact reciprocal
# 1, so a reciprocal computed at run time (~9) pays from about five
# divisions on; two (the regression's exp(x1)^2) measured no faster
# (PERF.md). The torch rendering divides as it did.
REPEATED_DIVISIONS = 5
# device memory the plain rendering of a stream loop may hold for one chunk
# of points (all per-point intermediates of all chains)
PLAIN_STREAM_BYTES = 256 << 20
LANES = 32     # a warp: the stream loop's lanes per chain, at least
# a stream loop over more than POINTS_PER_WARP points per warp gets more
# warps per chain in K1, K3 and K6, up to MAX_STREAM_WARPS
POINTS_PER_WARP = 1 << 16
MAX_STREAM_WARPS = 8
# points each lane evaluates per tile as independent instructions (halved
# while the tile ring would outgrow STREAM_SMEM_BYTES; 8 was faster than
# 16 and 4 on the H100, PERF.md)
STREAM_POINTS = 8
STREAM_STAGES = 2                  # the tile ring: double buffering
STREAM_SMEM_BYTES = 32 << 10       # the ring's shared memory, at most
# every row of the kernels' stream table is padded to a multiple of this
# many points, the largest tile (so that every tile copy is whole)
STREAM_PAD = 4096
# warps per block of K1 and K6: several chains share the tiles (K6 on the
# H100: 16 warps a block 4.6% faster than 8 at 10^6 points and 1,024
# chains, 1.5% at 10^4 and 8,192; PERF.md)
STREAM_BLOCK_WARPS = 16
# warps an SM that K3 and K6 with a stream loop ask registers for
# (``__launch_bounds__``' minimum blocks): 16, at most 128 registers
STREAM_SM_WARPS = 16
# the staged-code kernel: chains (one warp each) per block, the warps it
# launches at least by splitting chains over blocks (132 SMs x 96: about
# four waves of the 24 warps an SM holds at the robust-t body's 80
# registers; more splits measured faster on the H100, PERF.md), and the
# tiles a block walks at least when it does
EVAL_BLOCK_CHAINS = 8
EVAL_TARGET_WARPS = 132 * 96
EVAL_MIN_TILES = 4


class StreamLayout:
    """How a stream loop spreads over a kernel's threads, and so the order
    of its sums (both renderings read it):

    - ``warps`` per chain (``lanes = 32 warps``); each lane evaluates
      ``points`` points of every tile of ``tile = lanes * points`` points:
      lane l of warp w the points ``(w points + p) 32 + l``, p = 0 ..
      points-1, as independent instructions. A point past ``n_pts``
      contributes 0.0 by a select (whatever the body gives there, NaN
      too). For each data-sum the lane adds its ``points`` values by a
      pairwise tree (``v[2q] + v[2q+1]``, level by level) and adds the
      tile's total into its running Kahan-compensated sum.
    - ``chains`` chains per block read every tile from one ring of
      ``STREAM_STAGES`` shared-memory stages (``cp.async`` copies of 16
      bytes); ``splits`` blocks share one chain's tiles: block g walks
      tiles g, g + splits, ... (the staged-code kernel only; K1, K3 and K6
      keep ``splits`` 1).
    - A lane's total is ``acc - comp``; a warp's lanes combine by the
      butterfly ``v + v[lane ^ off]``, off = 16 .. 1; a block adds its
      warps' totals in warp order, and the chain its blocks' in block
      order.

    ``chains`` does not change the sums; the others do."""

    __slots__ = ("warps", "points", "chains", "splits")

    def __init__(self, warps: int, points: int, chains: int = 1,
                 splits: int = 1):
        self.warps, self.points = int(warps), int(points)
        self.chains, self.splits = int(chains), int(splits)

    @property
    def lanes(self) -> int:
        return LANES * self.warps

    @property
    def tile(self) -> int:
        return self.lanes * self.points

    @property
    def threads(self) -> int:
        return self.lanes * self.chains

    @property
    def min_blocks(self) -> int:
        """Blocks an SM to hold ``STREAM_SM_WARPS`` warps."""
        return max(1, STREAM_SM_WARPS * LANES // self.threads)

    def tiles(self, n_pts: int) -> int:
        return -(-n_pts // self.tile)

    def __repr__(self):
        return ("StreamLayout(" + ", ".join(
            f"{k}={getattr(self, k)}" for k in self.__slots__) + ")")


def _stream_points(warps: int, rows: int) -> int:
    """``STREAM_POINTS`` halved while the ring of ``rows`` rows would
    outgrow ``STREAM_SMEM_BYTES``."""
    p = STREAM_POINTS
    while p > 1 and (STREAM_STAGES * rows * LANES * warps * p * 4
                     > STREAM_SMEM_BYTES or LANES * warps * p > STREAM_PAD):
        p //= 2
    if STREAM_STAGES * rows * LANES * warps * p * 4 > STREAM_SMEM_BYTES:
        raise ValueError(f"scalarize: a stream table of {rows} rows does "
                         f"not fit the tile ring ({STREAM_SMEM_BYTES} "
                         "bytes of shared memory)")
    return p


def stream_warps(n_pts: int) -> int:
    """Warps per chain in K1, K3 and K6: one, doubled while each warp would
    have more than ``POINTS_PER_WARP`` points, up to
    ``MAX_STREAM_WARPS``."""
    w = 1
    while w < MAX_STREAM_WARPS and n_pts > w * POINTS_PER_WARP:
        w *= 2
    return w


def fused_layout(n_pts: int, rows: int) -> StreamLayout:
    """The layout of K1 and K6, fixed when they are built (K3 takes its
    warps and points): warps per chain from ``n_pts``, and as many chains
    a block, sharing the tiles, as make ``STREAM_BLOCK_WARPS`` warps."""
    w = stream_warps(n_pts)
    return StreamLayout(w, _stream_points(w, rows),
                        max(1, STREAM_BLOCK_WARPS // w), 1)


def eval_layout(n_pts: int, rows: int, n_chains: int) -> StreamLayout:
    """The staged-code kernel's layout for ``n_chains`` chains: a warp per
    chain, ``EVAL_BLOCK_CHAINS`` chains per block, and each chain's tiles
    split over as many blocks as bring the warps launched to
    ``EVAL_TARGET_WARPS`` (each block walking ``EVAL_MIN_TILES`` tiles at
    least)."""
    p = _stream_points(1, rows)
    tiles = -(-n_pts // (LANES * p))
    g = min(-(-EVAL_TARGET_WARPS // max(n_chains, 1)),
            tiles // EVAL_MIN_TILES)
    return StreamLayout(1, p, max(1, min(EVAL_BLOCK_CHAINS, n_chains)),
                        max(1, g))


def block_size(staged: "StagedLogp", chains_block: int) -> int:
    """Threads per block of a kernel that embeds ``staged``:
    ``chains_block`` chains without a stream loop, the stream layout's
    ``threads`` with one."""
    return staged.layout.threads if staged.streams else chains_block


def _state(v, like, dtype="f"):
    """A scan loop's value as a float32 (``dtype`` "b": bool) tensor on
    ``like``'s device: Python numbers would compute in float64."""
    return torch.as_tensor(v, dtype=torch.bool if dtype == "b"
                           else torch.float32, device=like.device)


def _pt(v):
    """A per-chain value, shaped to broadcast against a run of points."""
    return v.reshape(v.shape + (1,)) if isinstance(v, torch.Tensor) \
        and v.dim() else v


def butterfly(tot: torch.Tensor) -> torch.Tensor:
    """A warp's shuffle tree over the last axis (its 32 lanes): ``v + v[lane
    ^ off]`` for ``off = 16, 8, 4, 2, 1`` (``__shfl_xor_sync`` in the
    kernels), which leaves every lane with the same bits."""
    lane = torch.arange(LANES, device=tot.device)
    for off in (16, 8, 4, 2, 1):
        tot = tot + tot[..., lane ^ off]
    return tot


def _stream_sums(point, sd: torch.Tensor, n_pts: int, n_sums: int, batch,
                 n_instr: int, layout: StreamLayout):
    """The plain version of the kernels' stream loop in ``layout``'s order
    (:class:`StreamLayout`): per lane blocks of ``points`` points, masked
    past ``n_pts``, summed by the pairwise tree; one Kahan add per tile;
    the butterfly, warps in order, blocks in order. ``sd`` holds
    ``n_pts`` points a row or more (the kernels' padded table); a point
    past ``n_pts`` reads the row's last point, as the padding holds.
    ``point(rows)`` evaluates the per-point values of a run of points;
    runs are whole rounds of ``splits`` tiles, sized so that their
    intermediates stay within ``PLAIN_STREAM_BYTES``."""
    T, G, W, P = layout.tile, layout.splits, layout.warps, layout.points
    n_tiles = layout.tiles(n_pts)
    rounds = -(-n_tiles // G)
    chains = math.prod(batch)
    per_round = 4 * G * T * max(chains, 1) * (n_instr + int(sd.shape[0])
                                              + 3 * n_sums + 1)
    chunk = max(1, min(rounds, PLAIN_STREAM_BYTES // per_round))
    acc = torch.zeros((n_sums,) + tuple(batch) + (G, W, LANES),
                      dtype=sd.dtype, device=sd.device)
    comp = torch.zeros_like(acc)
    for r0 in range(0, rounds, chunk):
        r1 = min(rounds, r0 + chunk)
        k0, k1 = r0 * G, min(n_tiles, r1 * G)
        pts = torch.arange(k0 * T, k1 * T, device=sd.device)
        live = pts < n_pts
        idx = torch.clamp(pts, max=n_pts - 1)
        vals = torch.stack([torch.broadcast_to(
            torch.as_tensor(v, dtype=sd.dtype, device=sd.device),
            tuple(batch) + (len(pts),)) for v in point([row[idx]
                                                        for row in sd])])
        vals = torch.where(live, vals, torch.zeros((), dtype=sd.dtype,
                                                   device=sd.device))
        vals = vals.reshape(vals.shape[:-1] + (k1 - k0, W, P, LANES))
        while vals.shape[-2] > 1:
            vals = vals[..., 0::2, :] + vals[..., 1::2, :]
        block = vals[..., 0, :]              # (sums, *batch, tiles, W, 32)
        for r in range(r0, r1):
            lo, hi = r * G - k0, min(n_tiles, (r + 1) * G) - k0
            a, c = acc[..., :hi - lo, :, :], comp[..., :hi - lo, :, :]
            y = block[..., lo:hi, :, :] - c
            t = a + y
            comp[..., :hi - lo, :, :] = (t - a) - y
            acc[..., :hi - lo, :, :] = t
    tot = butterfly(acc - comp)[..., 0]      # (sums, *batch, G, W)
    per_block = tot[..., 0]
    for w in range(1, W):
        per_block = per_block + tot[..., w]
    out = per_block[..., 0]
    for g in range(1, G):
        out = out + per_block[..., g]
    return list(out)


# launches of K1, K3 and K6 whose body held a stream loop (part c),
# unrolled structured ops or scan loops (part b); the wrappers count them
body_launches = {"stream": 0, "structured": 0, "scan": 0}


def count_body_launch(staged: "StagedLogp") -> None:
    """Called by a kernel wrapper where it launches a kernel with
    ``staged`` spliced in."""
    if staged.streams:
        body_launches["stream"] += 1
    if staged.structured:
        body_launches["structured"] += 1
    if staged.loops:
        body_launches["scan"] += 1


def stream_table(staged: "StagedLogp", device):
    """The kernels' stream table on ``device`` (contiguous float32), or
    None: each row padded with its last point to a multiple of
    ``STREAM_PAD`` points, so that every tile copy is whole and aligned to
    16 bytes. Made once per device."""
    if staged.stream_data is None:
        return None
    key = str(torch.device(device))
    if key not in staged._tables:
        sd = staged.stream_data.to(device=device, dtype=torch.float32)
        n_pad = -(-staged.n_pts // STREAM_PAD) * STREAM_PAD
        staged._tables[key] = torch.cat(
            [sd, sd[:, -1:].expand(-1, n_pad - staged.n_pts)],
            dim=1).contiguous()
    return staged._tables[key]


def pad_chains(t: torch.Tensor, n_pad: int, dim: int = -1) -> torch.Tensor:
    """``t`` with its chain axis ``dim`` filled up to ``n_pad`` by copies
    of its last chain (contiguous): a kernel whose blocks hold several
    chains then has no chain past the end to leave its barriers; the
    copies' results are dropped."""
    n = t.shape[dim]
    if n == n_pad:
        return t.contiguous()
    last = t.narrow(dim, n - 1, 1)
    shape = list(t.shape)
    shape[dim] = n_pad - n
    return torch.cat([t, last.expand(shape)], dim=dim).contiguous()


class StagedLogp:
    """Result of :func:`stage_scalarized`.

    - ``res_consts``: float32 ``(R,)`` tensor of staged residual constants,
      on the device the logp was staged for.
    - ``stream_data``: float32 ``(rows, n_pts)`` data table of a streamed
      likelihood (part c), or None when the model collapses to residual
      constants.
    - ``layout``: the :class:`StreamLayout` of K1, K3 and K6
      (:func:`fused_layout`), or None without a stream loop; ``lanes`` its
      lanes per chain (1 without one).
    - ``vag(x, layout=None)``: the torch rendering; ``x`` is ``(d, n)``,
      returns ``(lp (n,), grad (d, n))``; a stream loop sums in
      ``layout``'s order (default ``self.layout``).
    - ``cuda_source(layout=None, scan_rcps=True)``: the CUDA C++
      rendering, a ``__device__`` function ``staged_vag(const float* x,
      const float* r, float& lp, float* g, const float* sd, int n_pts)``;
      ``scan_rcps=False`` gives the scan loops' bodies no run-time
      reciprocals (:meth:`_divisions`). With a stream
      loop (in ``layout``, default ``self.layout``) it is
      ``staged_partial`` (the loop over the tiles ``g0, g0 + gs, ...``
      into the block's sums ``s``) then ``staged_finish`` (the program
      after the loop), and every thread of the block must call it at once
      with ``layout.threads`` threads a block, each warp with its chain's
      ``x``: the block's warps share the tiles, and every lane of a chain
      returns the same bits. ``sd`` is :func:`stream_table`'s padded
      table.
    """

    def __init__(self, d: int, st: "_Stager", lp, grads, res_consts):
        self.d = d
        self.prog = st.prog
        self.pprog = st.pprog
        self.sums = list(st.sums)
        self.lp = lp
        self.grads = list(grads)
        self.res_consts = res_consts
        self.n_res = int(res_consts.shape[0])
        self.stream_data = (torch.stack(st.rows).to(res_consts.device)
                            .contiguous() if self.sums else None)
        self.n_pts = int(st.n_pts) if self.sums else 0
        self.layout = (fused_layout(self.n_pts, len(st.rows))
                       if self.sums else None)
        self.lanes = self.layout.lanes if self.sums else 1
        self.structured = st.structured
        self.loops = list(st.loops)
        for lp in self.loops:
            lp.find_live()
        self.rcp_res, self.rcp_exact = dict(st.rcp_res), set(st.rcp_exact)
        self.libs: Dict[Any, Any] = {}      # built kernels, per variant
        self._tables: Dict[str, torch.Tensor] = {}   # stream_table's
        self._cuda_src: Dict[Any, str] = {}
        self._warp: Optional["SplitProgram"] = None
        self.torch_source = self._render_torch()
        namespace = {"torch": torch, "inf": math.inf, "nan": math.nan,
                     "_pt": _pt, "_stream_sums": _stream_sums,
                     "_state": _state}
        exec(compile(self.torch_source, "<staged_vag>", "exec"), namespace)
        self._torch_fn = namespace["staged_vag"]

    @property
    def n_instructions(self) -> int:
        """Instructions outside the stream loop: the straight-line part,
        and each scan loop's body once (:attr:`loop_shape` has the trip
        counts)."""
        return len(self.prog.instrs) + sum(len(lp.live) for lp in self.loops)

    @property
    def loop_shape(self) -> List[Tuple[int, int]]:
        """``(steps, body instructions)`` of each scan loop, in order."""
        return [(lp.n_steps, len(lp.live)) for lp in self.loops]

    @property
    def executed_instructions(self) -> int:
        """Instructions a chain executes per evaluation (stream loop
        aside): the straight-line part plus each loop body per step."""
        return len(self.prog.instrs) + sum(s * n for s, n in self.loop_shape)

    @property
    def tape_floats(self) -> int:
        """Floats of the forward loops' tapes, per chain."""
        return sum(lp.n_steps * len(lp.tape_slots()) for lp in self.loops
                   if not lp.reverse)

    @property
    def n_point_instructions(self) -> int:
        """Instructions of the stream loop's body, per point."""
        return len(self.pprog.instrs)

    @property
    def streams(self) -> bool:
        return self.stream_data is not None

    def _split(self):
        """The main program's instructions before the stream loop (they
        read no data-sum) and after it, each in program order."""
        after = self.prog.after
        pre = [j for j in range(len(self.prog.instrs)) if j not in after]
        return pre, sorted(after)

    def _loop_inputs(self):
        seen, out = set(), []
        for _, args in self.pprog.instrs:
            for a in args:
                if isinstance(a, Sym) and a.kind in "xrt" \
                        and a.key() not in seen:
                    seen.add(a.key())
                    out.append(a)
        return out

    def _render_torch(self) -> str:
        lines = ["def staged_vag(x, r, sd"
                 + (", layout):" if self.sums else "):")]
        pre, post = self._split()
        at = self._loops_at()

        def instr(j):
            for lp in at.get(j, ()):
                self._loop_torch(lines, lp)
            op, args = self.prog.instrs[j]
            lines.append(f"    t{j} = {_torch_expr(op, args)}")

        for j in pre:
            instr(j)
        for lp in at.get(len(self.prog.instrs), ()):
            self._loop_torch(lines, lp)
        if self.sums:
            for a in self._loop_inputs():
                lines.append(f"    b_{a.kind}{a.idx} = _pt({_torch_lit(a)})")
            rows = ", ".join(f"d{i}" for i in range(len(self.stream_data)))
            lines.append("    def point(rows):")
            lines.append(f"        {rows}, = rows")
            for j, (op, args) in enumerate(self.pprog.instrs):
                lines.append(f"        p{j} = {_torch_expr(op, args, 'b_')}")
            lines.append("        return [" + ", ".join(
                _torch_lit(e) for e in self.sums) + "]")
            names = ", ".join(f"s{k}" for k in range(len(self.sums)))
            lines.append(f"    {names}, = _stream_sums(point, sd, "
                         f"{self.n_pts}, {len(self.sums)}, x[0].shape, "
                         f"{len(self.pprog.instrs)}, layout)")
        for j in post:
            instr(j)
        outs = ", ".join(_torch_lit(g) for g in self.grads)
        lines.append(f"    return {_torch_lit(self.lp)}, [{outs}]")
        return "\n".join(lines) + "\n"

    def _loops_at(self) -> Dict[int, List[Loop]]:
        at: Dict[int, List[Loop]] = {}
        for lp in self.loops:
            at.setdefault(lp.pos, []).append(lp)
        return at

    def _tape(self, lp: Loop):
        """The tape's name and the forward loop's tape columns."""
        fwd = lp.fwd or lp
        return f"_tape{self.loops.index(fwd)}", fwd.tape_slots()

    def _fixed(self, lp: Loop):
        """``(symbol, init, constant)`` of the forward carry's slots that
        are computed from t, named as ``lp``'s body reads them."""
        fwd = lp.fwd or lp
        return [(fwd.state[i] if lp is fwd
                 else Sym("k", i, fwd.state[i].dtype), init, lit)
                for i, (init, lit) in sorted(fwd.fixed.items())]

    def _loop_torch(self, lines, lp: Loop):
        """A scan loop as a Python loop over the steps, every value a
        per-chain tensor (float32, on ``x``'s device)."""
        tape, cols = self._tape(lp)
        T, P = lp.n_steps, lp.ywidth
        if not lp.reverse and cols:
            lines.append(f"    {tape} = [None] * {T}")
        for s, _ in lp.carried():
            init = lp.inits[lp.state.index(s)]
            lines.append(f"    {_torch_lit(s)} = _state({_torch_lit(init)}, "
                         "x[0])")
        for a, _ in lp.accs:
            lines.append(f"    {_torch_lit(a)} = _state(0.0, x[0])")
        steps = f"range({T - 1}, -1, -1)" if lp.reverse else f"range({T})"
        lines.append(f"    for _t in {steps}:")
        for i in range(P):
            lines.append(f"        y{i} = r[{lp.ybase + i} + _t"
                         + (f" * {P}]" if P > 1 else "]"))
        for sym, init, lit in self._fixed(lp):
            lines.append(f"        {_torch_lit(sym)} = _state("
                         f"{_torch_lit(init)} if _t == 0 else "
                         f"{_torch_lit(lit)}, x[0], {sym.dtype!r})")
        if cols and lp.reverse:
            lines.append("        " + "".join(f"k{i}, " for i in cols)
                         + f"= {tape}[_t]")
        elif cols:
            lines.append(f"        {tape}[_t] = (" + "".join(
                f"{_torch_lit(lp.state[i])}, " for i in cols) + ")")
        for j in lp.live:
            op, args = lp.body.instrs[j]
            lines.append(f"        u{j} = {_torch_expr(op, args)}")
        for a, e in lp.accs:
            lines.append(f"        {_torch_lit(a)} = ({_torch_lit(a)} + "
                         f"{_torch_lit(e)})")
        upd = lp.carried()
        if upd:
            lines.append("        " + "".join(f"{_torch_lit(s)}, "
                                               for s, _ in upd)
                         + "= " + "".join(f"{_torch_lit(u)}, "
                                          for _, u in upd))

    def _loop_cuda(self, lines, lp: Loop, plan):
        """A scan loop as a ``#pragma unroll 1`` loop over the steps; the
        forward loop writes the tape, the backward one reads it. The tape is
        an array in each thread's local memory, which the compiler
        interleaves across a warp, so that its accesses coalesce (faster
        than a shared-memory slab on the H100, PERF.md)."""
        tape, cols = self._tape(lp)
        T, P, C = lp.n_steps, lp.ywidth, len(cols)
        lines.append(f"  // scan '{lp.name}': "
                     + ("backward over its" if lp.reverse else "forward over")
                     + f" {T} steps")
        if not lp.reverse and C:
            lines.append(f"  float {tape}[{T * C}];")
        for s, _ in lp.carried():
            init = lp.inits[lp.state.index(s)]
            lines.append(f"  float {_cuda_lit(s)} = {_cuda_lit(init)};")
        for a, _ in lp.accs:
            lines.append(f"  float {_cuda_lit(a)} = 0.0f;")
        lines.append("#pragma unroll 1")
        lines.append(f"  for (int _t = {T - 1}; _t >= 0; --_t) {{"
                     if lp.reverse else
                     f"  for (int _t = 0; _t < {T}; ++_t) {{")
        for i in range(P):
            lines.append(f"    const float y{i} = r[{lp.ybase + i} + _t"
                         + (f" * {P}];" if P > 1 else "];"))
        for sym, init, lit in self._fixed(lp):
            ctype = "bool" if sym.dtype == "b" else "float"
            lines.append(f"    const {ctype} {_cuda_lit(sym)} = _t == 0 ? "
                         f"{_cuda_lit(init)} : {_cuda_lit(lit)};")
        for col, i in enumerate(cols):
            cell = f"{tape}[_t * {C} + {col}]"
            lines.append(f"    const float k{i} = {cell};" if lp.reverse
                         else f"    {cell} = {_cuda_lit(lp.state[i])};")
        for j in lp.live:
            self._instr(lines, j, lp.body, "    ", plan)
        for a, e in lp.accs:
            lines.append(f"    {_cuda_lit(a)} = {_cuda_lit(a)} + "
                         f"{_cuda_lit(e)};")
        upd = lp.carried()
        for n, (_, u) in enumerate(upd):
            lines.append(f"    const float _n{n} = {_cuda_lit(u)};")
        for n, (s, _) in enumerate(upd):
            lines.append(f"    {_cuda_lit(s)} = _n{n};")
        lines.append("  }")

    def _qualifier(self) -> str:
        """Inlined at every call site unless the program is long (an
        unrolled recursion): then one function, compiled once."""
        n = self.n_instructions + self.n_point_instructions
        return "__forceinline__" if n <= INLINE_MAX_INSTRUCTIONS \
            else "__noinline__"

    def cuda_source(self, layout: Optional[StreamLayout] = None,
                    scan_rcps: bool = True) -> str:
        layout = layout if self.sums and layout is not None else self.layout
        # chains a block shape the source only where a chain has warps to
        # combine (their sums' shared array)
        key = (None if layout is None else (
            layout.warps, layout.points,
            layout.chains if layout.warps > 1 else 1), scan_rcps)
        if key not in self._cuda_src:
            plan = self._divisions(scan_rcps)
            self._cuda_src[key] = (self._render_stream_cuda(layout, plan)
                                   if self.sums else self._render_cuda(plan))
        return self._cuda_src[key]

    def _divisions(self, scan_rcps: bool = True):
        """The plan of the run-time reciprocals: the per-chain values
        (coordinates ``x``, instructions ``t``, ``p``, ``u``) that one
        evaluation divides by ``REPEATED_DIVISIONS`` times or more, a
        division inside the stream loop or a scan loop by a value from
        before the loop counting once a point or a step. Each gets
        ``_rcp_<name> = 1.0f / <name>`` and ``_y_<name> =
        _div_y(_rcp_<name>)`` once, right after it (a coordinate at the
        function's start); its divisions use ``_y_<name>``, a reciprocal of
        it is ``_rcp_<name>``. Without ``scan_rcps`` the scan loops'
        divisions are not counted. Returns ``{id of the defining program:
        {instruction}}`` and the coordinates, which the render functions
        pass down."""
        progs = [(self.prog, range(len(self.prog.instrs)), 1)]
        if self.sums:
            progs.append((self.pprog, range(len(self.pprog.instrs)),
                          self.n_pts))
        if scan_rcps:
            progs += [(lp.body, lp.live, lp.n_steps) for lp in self.loops]
        uses: Dict[Tuple, int] = {}
        for P, js, runs in progs:
            for j in js:
                op, args = P.instrs[j]
                b = args[1] if op == "div" else None
                if not isinstance(b, Sym) or b.kind not in "xtpu":
                    continue
                inner = b.kind == P.kind
                owner = id(P) if inner else id(self.prog)
                key = (owner, b.kind, b.idx)
                uses[key] = uses.get(key, 0) + (1 if inner else runs)
        plan: Dict[int, set] = {}
        coords = set()
        for (owner, kind, idx), n in uses.items():
            if n >= REPEATED_DIVISIONS and kind == "x":
                coords.add(idx)
            elif n >= REPEATED_DIVISIONS:
                plan.setdefault(owner, set()).add(idx)
        return plan, coords

    def _has_rcp(self, b, prog, plan) -> bool:
        """Whether the per-chain value ``b``, read in ``prog``, has
        ``_rcp_<name>`` in ``plan`` (:meth:`_divisions`)."""
        by_prog, coords = plan
        if b.kind == "x":
            return b.idx in coords
        owner = prog if b.kind == prog.kind else self.prog
        return b.idx in by_prog.get(id(owner), ())

    def staged_rcp(self, op, args) -> Optional[Tuple[int, bool]]:
        """For a division by a residual constant with a staged reciprocal:
        the reciprocal's index and whether it is exact; else None."""
        b = args[1] if op == "div" else None
        if isinstance(b, Sym) and b.kind == "r" and b.idx in self.rcp_res:
            return self.rcp_res[b.idx], b.idx in self.rcp_exact
        return None

    def _cuda_expr(self, op, args, prog, plan) -> str:
        """An instruction's CUDA expression; a division by a residual
        constant with a staged reciprocal, or by a value with
        ``_rcp_<name>``, goes through the reciprocal (:func:`_div_expr`),
        and such a value's reciprocal is ``_rcp_<name>``."""
        lits = [_cuda_lit(a) for a in args]
        b = args[1] if op == "div" else args[0] if op == "reciprocal" \
            else None
        if isinstance(b, Sym) and b.kind in "xtpu" and \
                self._has_rcp(b, prog, plan):
            name = f"{b.kind}{b.idx}"
            return f"_rcp_{name}" if op == "reciprocal" else \
                _div_expr(lits[0], lits[1], f"_y_{name}", False)
        rcp = self.staged_rcp(op, args)
        if rcp is not None:
            return _div_expr(lits[0], lits[1], f"r[{rcp[0]}]", rcp[1])
        return _OPS[op][2].format(*lits)

    def _instr(self, lines, j, prog, indent, plan):
        op, args = prog.instrs[j]
        ctype = "bool" if prog.dtypes[j] == "b" else "float"
        expr = self._cuda_expr(op, args, prog, plan)
        lines.append(f"{indent}const {ctype} {prog.kind}{j} = {expr};")
        if j in plan[0].get(id(prog), ()):
            self._rcp_lines(lines, f"{prog.kind}{j}", indent)

    @staticmethod
    def _rcp_lines(lines, name, indent, lit=None):
        lines.append(f"{indent}const float _rcp_{name} = (1.0f / "
                     f"{lit or name});")
        lines.append(f"{indent}const float _y_{name} = _div_y(_rcp_{name});")

    def _coord_rcps(self, lines, plan):
        for k in sorted(plan[1]):
            self._rcp_lines(lines, f"x{k}", "  ", f"x[{k}]")

    def _outputs_cuda(self, lines):
        lines.append(f"  lp = {_cuda_lit(self.lp)};")
        for i, g in enumerate(self.grads):
            lines.append(f"  g[{i}] = {_cuda_lit(g)};")
        lines.append("}")

    def _render_cuda(self, plan) -> str:
        """The program without a stream loop: one straight-line
        function."""
        lines = [_CUDA_HELPERS,
                 f"__device__ {self._qualifier()} void staged_vag("
                 "const float* x, const float* r, float& lp, float* g, "
                 "const float* __restrict__ sd, int n_pts) {"]
        self._coord_rcps(lines, plan)
        at = self._loops_at()
        for j in range(len(self.prog.instrs)):
            for lp in at.get(j, ()):
                self._loop_cuda(lines, lp, plan)
            self._instr(lines, j, self.prog, "  ", plan)
        for lp in at.get(len(self.prog.instrs), ()):
            self._loop_cuda(lines, lp, plan)
        self._outputs_cuda(lines)
        return "\n".join(lines) + "\n"

    def _point_loop(self, lines, lay, rows, masked, plan):
        """Each lane's ``lay.points`` points of the tile ``_t``: the loop
        body per point, each data-sum's value into ``_b<i>[p]``."""
        T, P = lay.tile, lay.points
        lines.append("#pragma unroll")
        lines.append(f"      for (int _p = 0; _p < {P}; ++_p) {{")
        lines.append(f"        const int _o = (_w * {P} + _p) * 32 + _lane;")
        for row in range(rows):
            lines.append(f"        const float d{row} = _t[{row * T} + _o];")
        for j in range(len(self.pprog.instrs)):
            self._instr(lines, j, self.pprog, "        ", plan)
        if masked:
            lines.append("        const bool _live = _base + _o < n_pts;")
        for i, e in enumerate(self.sums):
            v = f"_live ? {_cuda_lit(e)} : 0.0f" if masked else _cuda_lit(e)
            lines.append(f"        _b{i}[_p] = {v};")
        lines.append("      }")

    def _render_stream_cuda(self, lay: StreamLayout, plan) -> str:
        """``staged_partial`` (the program before the loop, and the loop in
        ``lay``), ``staged_finish`` (the program before and after the loop;
        the compiler keeps one copy of the part before where both are
        inlined) and ``staged_vag``, the two in a row."""
        pre, post = self._split()
        k, rows = len(self.sums), len(self.stream_data)
        T, P, W, S = lay.tile, lay.points, lay.warps, STREAM_STAGES
        q = self._qualifier()
        lines = [_CUDA_HELPERS + _CUDA_KAHAN + _CUDA_STREAM,
                 f"__device__ {q} void staged_partial("
                 "const float* x, const float* r, float* s, "
                 "const float* __restrict__ sd, int n_pts, int g0, int gs) {"]
        self._coord_rcps(lines, plan)
        for j in pre:
            self._instr(lines, j, self.prog, "  ", plan)
        lines.append(f"  __shared__ __align__(16) float _tile[{S}]"
                     f"[{rows * T}];")
        if W > 1:
            lines.append(f"  __shared__ float _red[{lay.chains}][{k}]"
                         f"[{W}];")
        lines.append("  " + " ".join(f"float sa{i} = 0.0f, sc{i} = 0.0f;"
                                     for i in range(k)))
        lines.append(f"  const int _ld = (n_pts + {STREAM_PAD - 1}) / "
                     f"{STREAM_PAD} * {STREAM_PAD};")
        lines.append(f"  const int _nt = (n_pts + {T - 1}) / {T};")
        lines.append("  const int _cnt = g0 < _nt ? (_nt - g0 + gs - 1) / gs"
                     " : 0;")
        lines.append("  const int _lane = (int)(threadIdx.x & 31u);")
        lines.append(f"  const int _w = (int)(threadIdx.x >> 5) % {W};"
                     if W > 1 else "  const int _w = 0;")
        lines.append("  __syncthreads();   // the last call's reads are "
                     "done")
        lines.append(f"  for (int _q = 0; _q < {S - 1}; ++_q) {{")
        lines.append(f"    if (_q < _cnt) _stream_tile(_tile[_q], sd, _ld, "
                     f"(g0 + _q * gs) * {T}, {T}, {rows});")
        lines.append("    _cp_commit();")
        lines.append("  }")
        lines.append("  for (int _j = 0; _j < _cnt; ++_j) {")
        lines.append(f"    _cp_wait<{S - 2}>();")
        lines.append("    __syncthreads();   // tile _j is in; tile _j - 1 "
                     "is read")
        lines.append(f"    if (_j + {S - 1} < _cnt) _stream_tile(_tile[(_j "
                     f"+ {S - 1}) % {S}], sd, _ld, (g0 + (_j + {S - 1}) * "
                     f"gs) * {T}, {T}, {rows});")
        lines.append("    _cp_commit();")
        lines.append(f"    const float* _t = _tile[_j % {S}];")
        lines.append(f"    const int _base = (g0 + _j * gs) * {T};")
        lines.append("    " + " ".join(f"float _b{i}[{P}];"
                                       for i in range(k)))
        # a tile that the data fill needs no mask (the same sums: a live
        # point's select is the point); the last tile selects 0.0 past
        # n_pts
        lines.append(f"    if (_base + {T} <= n_pts) {{")
        self._point_loop(lines, lay, rows, False, plan)
        lines.append("    } else {")
        self._point_loop(lines, lay, rows, True, plan)
        lines.append("    }")
        # the pairwise tree, written out: constant indices keep the blocks
        # in registers
        h = P // 2
        while h:
            for i in range(k):
                lines.append("    " + " ".join(
                    f"_b{i}[{q}] = _b{i}[{2 * q}] + _b{i}[{2 * q + 1}];"
                    for q in range(h)))
            h //= 2
        for i in range(k):
            lines.append(f"    _kahan(sa{i}, sc{i}, _b{i}[0]);")
        lines.append("  }")
        for i in range(k):
            lines.append(f"  float s{i} = sa{i} - sc{i};")
            for off in (16, 8, 4, 2, 1):
                lines.append(f"  s{i} = s{i} + __shfl_xor_sync("
                             f"0xffffffffu, s{i}, {off});")
        if W > 1:
            # the chain's warps' sums, added in warp order
            lines.append(f"  const int _c = (int)threadIdx.x / {lay.lanes};")
            lines.append("  if (_lane == 0) {")
            for i in range(k):
                lines.append(f"    _red[_c][{i}][_w] = s{i};")
            lines.append("  }")
            lines.append("  __syncthreads();")
            for i in range(k):
                lines.append(f"  s{i} = _red[_c][{i}][0];")
                for w in range(1, W):
                    lines.append(f"  s{i} = s{i} + _red[_c][{i}][{w}];")
        for i in range(k):
            lines.append(f"  s[{i}] = s{i};")
        lines.append("}")
        lines.append(f"__device__ {q} void staged_finish("
                     "const float* x, const float* r, const float* s, "
                     "float& lp, float* g) {")
        self._coord_rcps(lines, plan)
        for j in pre:
            self._instr(lines, j, self.prog, "  ", plan)
        for i in range(k):
            lines.append(f"  const float s{i} = s[{i}];")
        for j in post:
            self._instr(lines, j, self.prog, "  ", plan)
        self._outputs_cuda(lines)
        lines.append(f"__device__ {q} void staged_vag("
                     "const float* x, const float* r, float& lp, float* g, "
                     "const float* __restrict__ sd, int n_pts) {")
        lines.append(f"  float s[{k}];")
        lines.append("  staged_partial(x, r, s, sd, n_pts, 0, 1);")
        lines.append("  staged_finish(x, r, s, lp, g);")
        lines.append("}")
        return "\n".join(lines) + "\n"

    def vag(self, x: torch.Tensor, layout: Optional[StreamLayout] = None):
        """Value and gradient at ``x`` of shape ``(d, n)`` through the torch
        rendering: ``(lp (n,), grad (d, n))``; a stream loop sums in
        ``layout``'s order (default ``self.layout``)."""
        return self._call(self._torch_fn, x, layout or self.layout)

    def warp_split(self) -> "SplitProgram":
        """The program split over a warp's lanes (:class:`SplitProgram`),
        made once."""
        if self._warp is None:
            self._warp = SplitProgram(self)
        return self._warp

    def _call(self, fn, x: torch.Tensor, layout=None):
        args = (list(x), list(self.res_consts.to(x.device)), None)
        if self.stream_data is not None:
            args = args[:2] + (self.stream_data.to(x.device), layout)
        lp, gs = fn(*args)
        shape = x.shape[1:]

        def full(v):
            v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
            return v.expand(shape)

        return full(lp), torch.stack([full(g) for g in gs])


# -- the warp-per-chain rendering ---------------------------------------------

# coordinates per lane in the warp-per-chain layout: lane l owns the
# WARP_CPL consecutive coordinates WARP_CPL l .. WARP_CPL l + WARP_CPL - 1,
# so one chain spans at most LANES * WARP_CPL coordinates
WARP_CPL = 4
# a coordinate that appears, outside the reductions, beside at least this
# many others is a hub: every lane reads it and computes what depends on
# the hubs alone
HUB_DEGREE = 8
_FULL = "0xffffffffu"


def _bits(m: int):
    while m:
        low = m & -m
        yield low.bit_length() - 1
        m ^= low


def _lane_sum(parts, like):
    """The plain version of a split sum: each lane adds its operands left
    to right in float32 (a lane with none gives 0.0), then
    :func:`butterfly`; every lane holds the result."""
    vals = []
    for ops in parts:
        acc = torch.zeros((), dtype=torch.float32, device=like.device)
        if ops:
            acc = torch.as_tensor(ops[0], dtype=torch.float32,
                                  device=like.device)
            for o in ops[1:]:
                acc = acc + o
        vals.append(acc)
    shape = torch.broadcast_shapes(*[v.shape for v in vals])
    tot = torch.stack([torch.broadcast_to(v, shape) for v in vals], dim=-1)
    return butterfly(tot)[..., 0]


class SplitProgram:
    """The staged program of a ``d``-coordinate model (``LANES < d <=
    LANES * WARP_CPL``, no stream) split over the 32 lanes of the warp that
    runs one chain; lane ``l`` owns coordinates ``WARP_CPL l`` to ``WARP_CPL
    l + WARP_CPL - 1``.

    - The **hubs** are picked greedily: while some coordinate appears,
      outside the reductions, beside ``HUB_DEGREE`` or more others, the one
      beside the most (the lowest on a tie) becomes a hub. Every lane reads
      the hubs (a ``__shfl_sync`` from their owners).
    - An instruction whose operands hold one non-hub coordinate ``k`` runs
      on ``k``'s owner lane (it is *local* to ``k``), and so does one of
      the hubs alone whose every user is local to ``k``. One whose
      operands hold none, or two or more, runs on every lane (*shared*):
      the values it needs from other lanes come by ``__shfl_sync``.
    - A reduction (``Program.reductions``) with an operand local to some
      lane is split: each lane adds its own operands in operand order (the
      shared ones go to lane 0; a lane with none gives 0.0), then the
      butterfly of :func:`butterfly`. Every lane ends with the same bits.
    - The local instructions of coordinates with the same structure form a
      **class**, rendered once as SIMT code over the lanes' slots; their
      residual constants are indexed by the coordinate (an affine index, or
      a block of gathered constants appended to ``res_consts``).
    - ``g[k]`` ends on ``k``'s owner lane, ``lp`` on every lane.

    The torch rendering (:meth:`vag`) evaluates the same instructions; it
    differs from the serial one only in the order of the split sums, which
    it follows exactly."""

    def __init__(self, staged: "StagedLogp"):
        d = self.d = staged.d
        if staged.streams or staged.loops or \
                not LANES < d <= LANES * WARP_CPL:
            raise ValueError(f"scalarize: no warp-per-chain split for d={d}"
                             + (" with a stream loop" if staged.streams
                                else " with scan loops" if staged.loops
                                else ""))
        self.staged = staged
        self._reach = self._reachable(staged)
        self.hubs = self._pick_hubs()
        self._place = self._placement()
        extra: List[float] = []
        self._build_classes(extra, singletons=False)
        if self._order is None:         # a cycle between classes: split them
            self._build_classes(extra, singletons=True)
        extra_t = torch.tensor(extra, dtype=torch.float32,
                               device=staged.res_consts.device)
        self.res_consts = torch.cat([staged.res_consts, extra_t]) \
            if extra else staged.res_consts
        self.n_res = int(self.res_consts.shape[0])
        self.n_lane_instructions = self._lane_counts()
        self._cuda_src: Optional[str] = None
        self.torch_source = self._render_torch()
        namespace = {"torch": torch, "inf": math.inf, "nan": math.nan,
                     "_lane_sum": _lane_sum}
        exec(compile(self.torch_source, "<staged_vag_warp>", "exec"),
             namespace)
        self._torch_fn = namespace["staged_vag_warp"]

    # -- analysis ---------------------------------------------------------

    def _args(self, j):
        red = self.staged.prog.reductions
        return ("sum", red[j]) if j in red else self.staged.prog.instrs[j]

    def _reachable(self, staged):
        """The instructions the outputs need, in program order, with each
        reduction as one node over its operands."""
        seen, stack = set(), [e.idx for e in [staged.lp] + staged.grads
                              if isinstance(e, Sym) and e.kind == "t"]
        while stack:
            j = stack.pop()
            if j in seen:
                continue
            seen.add(j)
            stack += [a.idx for a in self._args(j)[1]
                      if isinstance(a, Sym) and a.kind == "t"]
        return sorted(seen)

    def _pick_hubs(self) -> int:
        """The hub coordinates as a bit mask (see the class note): the
        footprints here stop at reductions."""
        foot: Dict[int, int] = {}
        for j in self._reach:
            op, args = self._args(j)
            m = 0
            if op != "sum":
                for a in args:
                    if isinstance(a, Sym) and a.kind == "x":
                        m |= 1 << a.idx
                    elif isinstance(a, Sym) and a.kind == "t":
                        m |= foot[a.idx]
            foot[j] = m
        masks = {m for m in foot.values() if m & (m - 1)}
        hubs = 0
        while True:
            near = [0] * self.d
            for m in {m & ~hubs for m in masks}:
                if m & (m - 1):
                    for k in _bits(m):
                        near[k] |= m
            deg = [bin(near[k] & ~(1 << k)).count("1")
                   for k in range(self.d)]
            best = max(range(self.d), key=lambda k: (deg[k], -k))
            if deg[best] < HUB_DEGREE:
                return hubs
            hubs |= 1 << best

    def _is_hub(self, k: int) -> bool:
        return bool(self.hubs >> k & 1)

    def _placement(self) -> Dict[int, int]:
        """Instruction -> the non-hub coordinate it is local to, or -1
        (shared: every lane runs it). An instruction of the hubs alone
        whose every user is local to one coordinate (a per-coordinate term
        such as ``slope * x_i + intercept``) is local to it too."""
        place: Dict[int, int] = {}
        users: Dict[int, List[int]] = {}
        hub_only = set()
        for j in self._reach:
            op, args = self._args(j)
            ks = set()
            for a in args:
                if isinstance(a, Sym) and a.kind == "t":
                    users.setdefault(a.idx, []).append(j)
                k = self._local_of(a, place)
                if k >= 0 and op != "sum":
                    ks.add(k)
            place[j] = ks.pop() if len(ks) == 1 else -1
            if op != "sum" and not any(self._local_of(a, place) >= 0
                                       for a in args):
                hub_only.add(j)
        outputs = {e.idx for e in [self.staged.lp] + self.staged.grads
                   if isinstance(e, Sym) and e.kind == "t"}
        for j in reversed(self._reach):
            if j not in hub_only or j in outputs or j not in users:
                continue
            ks = {place[u] for u in users[j]}
            if len(ks) == 1 and min(ks) >= 0:
                place[j] = ks.pop()
        return place

    def _local_of(self, a, place=None) -> int:
        place = self._place if place is None else place
        if isinstance(a, Sym) and a.kind == "x" and not self._is_hub(a.idx):
            return a.idx
        if isinstance(a, Sym) and a.kind == "t":
            return place[a.idx]
        return -1

    def _build_classes(self, extra, singletons: bool):
        """Group the coordinates whose local instructions have the same
        structure; schedule the classes' instruction positions and the
        shared instructions (``self._order``, None on a cycle)."""
        extra.clear()
        per_k: Dict[int, List[int]] = {}
        for j in self._reach:
            if self._place[j] >= 0:
                per_k.setdefault(self._place[j], []).append(j)
        self._pos = {j: p for js in per_k.values() for p, j in enumerate(js)}
        groups: Dict[Any, List[int]] = {}
        for k in sorted(per_k):
            key = (k,) if singletons else tuple(
                self._signature(j, k) for j in per_k[k])
            groups.setdefault(key, []).append(k)
        self.classes = list(groups.values())       # members, ascending
        self._class_of = {k: c for c, ks in enumerate(self.classes)
                          for k in ks}
        self._lists = per_k
        self._leaf: Dict[Tuple[int, int, Any], str] = {}
        self._exact: Dict[Tuple[int, int], bool] = {}
        for c, ks in enumerate(self.classes):
            for p in range(len(per_k[ks[0]])):
                args = self._args(per_k[ks[0]][p])[1]
                for ai, a in enumerate(args):
                    col = [self._args(per_k[k][p])[1][ai] for k in ks]
                    if isinstance(a, Sym) and a.kind == "r":
                        self._leaf[(c, p, ai)] = self._r_index(
                            ks, [e.idx for e in col], extra)
                    elif isinstance(a, float):
                        self._leaf[(c, p, ai)] = self._literal(
                            ks, col, extra)
                rcps = [self.staged.staged_rcp(*self._args(per_k[k][p]))
                        for k in ks]
                if all(i is not None for i in rcps):
                    # the division's reciprocal, and whether every
                    # member's is exact
                    self._leaf[(c, p, "rcp")] = self._r_index(
                        ks, [i for i, _ in rcps], extra)
                    self._exact[(c, p)] = all(e for _, e in rcps)
        self._order = self._schedule()

    def _signature(self, j, k):
        op, args = self._args(j)
        sig = []
        for a in args:
            if isinstance(a, Sym) and a.kind == "x":
                sig.append(("own",) if a.idx == k else ("hub", a.idx))
            elif isinstance(a, Sym) and a.kind == "t":
                sig.append(("loc", self._pos[a.idx])
                           if self._place[a.idx] == k else ("all", a.idx))
            elif isinstance(a, Sym):
                sig.append(("r",))
            elif isinstance(a, (bool, np.bool_)):
                sig.append(("lit", bool(a)))
            else:
                sig.append(("num",))
        return (op, self.staged.prog.dtypes[j], tuple(sig))

    def _r_index(self, ks, idx, extra) -> str:
        """``r[...]`` of one residual operand over a class's members: an
        affine index in the coordinate ``_k`` where there is one, else a
        block of the gathered constants appended to the residuals."""
        b = (idx[1] - idx[0]) // (ks[1] - ks[0]) if len(ks) > 1 else 0
        a = idx[0] - b * ks[0]
        if all(i == a + b * k for i, k in zip(idx, ks)):
            if b == 0:
                return f"r[{a}]"
            lin = "_k" if b == 1 else f"{b} * _k"
            return f"r[{a} + {lin}]" if a else f"r[{lin}]"
        vals = self.staged.res_consts.detach().cpu().tolist()
        return self._gather(ks, [vals[i] for i in idx], extra)

    def _literal(self, ks, vals, extra) -> str:
        """A literal operand over a class's members: the literal if it is
        the same for all, else a gathered block."""
        if len({_cuda_lit(v) for v in vals}) == 1:
            return _cuda_lit(vals[0])
        return self._gather(ks, vals, extra)

    def _gather(self, ks, vals, extra) -> str:
        """``vals[m]`` (float32) at ``r[base + ks[m]]``: a block of ``d``
        constants appended to the residuals."""
        base = self.staged.n_res + len(extra)
        block = [0.0] * self.d
        for v, k in zip(vals, ks):
            block[k] = v
        extra.extend(block)
        return f"r[{base} + _k]"

    def _unit(self, j):
        k = self._place[j]
        if k < 0:
            return ("a", j)
        return ("g", self._class_of[k], self._pos[j])

    def _schedule(self):
        """A topological order of the units (a shared instruction, or one
        position of a class over all its members), by program order where
        it is free; None if the units form a cycle."""
        deps: Dict[Tuple, set] = {}
        key: Dict[Tuple, int] = {}
        for j in self._reach:
            u = self._unit(j)
            key[u] = max(key.get(u, -1), j)
            ds = deps.setdefault(u, set())
            for a in self._args(j)[1]:
                if isinstance(a, Sym) and a.kind == "t":
                    v = self._unit(a.idx)
                    if v != u:
                        ds.add(v)
        users: Dict[Tuple, List] = {u: [] for u in deps}
        for u, ds in deps.items():
            for v in ds:
                users[v].append(u)
        left = {u: len(ds) for u, ds in deps.items()}
        heap = [(key[u], u) for u, n in left.items() if n == 0]
        heapq.heapify(heap)
        order = []
        while heap:
            _, u = heapq.heappop(heap)
            order.append(u)
            for w in users[u]:
                left[w] -= 1
                if left[w] == 0:
                    heapq.heappush(heap, (key[w], w))
        return order if len(order) == len(deps) else None

    def _lanes_of(self, c):
        """Per slot, the lanes whose coordinate in that slot is a member of
        class ``c``, as a bit mask."""
        masks = [0] * WARP_CPL
        for k in self.classes[c]:
            masks[k % WARP_CPL] |= 1 << (k // WARP_CPL)
        return masks

    # -- per-lane operands ------------------------------------------------

    def _reg(self, a) -> str:
        """The register of a local operand on its owner lane."""
        k = self._local_of(a)
        if isinstance(a, Sym) and a.kind == "x":
            return f"xv[{k % WARP_CPL}]"
        return f"v{self._class_of[k]}_{self._pos[a.idx]}[{k % WARP_CPL}]"

    def _shared_lit(self, a) -> str:
        """A shared operand (no local coordinate) in CUDA."""
        if isinstance(a, Sym) and a.kind == "x":
            return f"xh{a.idx}"
        if isinstance(a, Sym) and a.kind == "t":
            return f"a{a.idx}"
        return _cuda_lit(a)

    def _sum_parts(self, ops):
        """Per lane, its operands of a split sum in operand order, as
        (local operand or shared operand) pairs ``(is_local, a)``."""
        parts = [[] for _ in range(LANES)]
        for a in ops:
            k = self._local_of(a)
            parts[k // WARP_CPL if k >= 0 else 0].append((k >= 0, a))
        return parts

    def _is_split(self, j) -> bool:
        op, args = self._args(j)
        return op == "sum" and any(self._local_of(a) >= 0 for a in args)

    def _lane_counts(self) -> List[int]:
        """Instructions each lane executes for one value and gradient:
        shared instructions, its own slots of each class position, its
        partial adds and the butterfly (5 shuffles, 5 adds) of each split
        sum, the shuffles that bring operands from other lanes, the hub
        reads and the output moves."""
        counts = [bin(self.hubs).count("1")] * LANES
        for u in self._order:
            if u[0] == "g":
                for m in self._lanes_of(u[1]):
                    for lane in _bits(m):
                        counts[lane] += 1
                continue
            j = u[1]
            op, args = self._args(j)
            if op == "sum" and self._is_split(j):
                for lane, ops in enumerate(self._sum_parts(args)):
                    counts[lane] += max(len(ops) - 1, 0) + 10
            else:
                n = len(args) - 1 if op == "sum" else 1
                n += sum(self._local_of(a) >= 0 for a in args)
                counts = [c + n for c in counts]
        moves = sum(1 for g in self.staged.grads
                    if not (isinstance(g, Sym) and self._local_of(g) >= 0))
        return [c + moves for c in counts]

    @property
    def max_lane_instructions(self) -> int:
        return max(self.n_lane_instructions)

    # -- renderings -------------------------------------------------------

    def cuda_source(self) -> str:
        if self._cuda_src is None:
            self._cuda_src = self._render_cuda()
        return self._cuda_src

    def _render_cuda(self) -> str:
        P = self.staged.prog
        L = [_CUDA_HELPERS,
             "// lane owns coordinates 4 lane .. 4 lane + 3 (xv, gv); every "
             "lane of the warp calls this with the same r",
             "__device__ __forceinline__ void staged_vag_warp("
             "const float* xv, const float* r, float& lp, float* gv, "
             "const int lane) {"]
        for h in _bits(self.hubs):
            L.append(f"  const float xh{h} = __shfl_sync({_FULL}, "
                     f"xv[{h % WARP_CPL}], {h // WARP_CPL});")
        for c, ks in enumerate(self.classes):
            for p, j in enumerate(self._lists[ks[0]]):
                ctype = "bool" if P.dtypes[j] == "b" else "float"
                zero = "false" if ctype == "bool" else "0.0f"
                L.append(f"  {ctype} v{c}_{p}[{WARP_CPL}] = "
                         f"{{{', '.join([zero] * WARP_CPL)}}};")
        i = 0
        while i < len(self._order):
            u = self._order[i]
            if u[0] == "a":
                self._cuda_shared(L, u[1])
                i += 1
                continue
            run = [u]                   # consecutive positions of one class
            while i + len(run) < len(self._order) and \
                    self._order[i + len(run)][0] == "g" and \
                    self._order[i + len(run)][1] == u[1]:
                run.append(self._order[i + len(run)])
            self._cuda_class(L, u[1], [p for _, _, p in run])
            i += len(run)
        self._cuda_outputs(L)
        L.append("}")
        return "\n".join(L) + "\n"

    def _shfl(self, L, a, name) -> str:
        """A local operand read on every lane from its owner lane."""
        k = self._local_of(a)
        src = self._reg(a)
        bool_ = isinstance(a, Sym) and a.kind == "t" and \
            self.staged.prog.dtypes[a.idx] == "b"
        if bool_:
            L.append(f"  const bool {name} = (bool)__shfl_sync({_FULL}, "
                     f"(int){src}, {k // WARP_CPL});")
        else:
            L.append(f"  const float {name} = __shfl_sync({_FULL}, {src}, "
                     f"{k // WARP_CPL});")
        return name

    def _cuda_shared(self, L, j):
        P = self.staged.prog
        op, args = self._args(j)
        if op == "sum" and self._is_split(j):
            parts = self._sum_parts(args)
            pats: Dict[Tuple, int] = {}
            for lane, ops in enumerate(parts):
                expr = tuple(self._reg(a) if loc else self._shared_lit(a)
                             for loc, a in ops)
                pats[expr] = pats.get(expr, 0) | (1 << lane)
            L.append(f"  float a{j};")
            first = True
            for expr, mask in pats.items():
                if not expr:
                    continue
                acc = expr[0]
                for e in expr[1:]:
                    acc = f"({acc} + {e})"
                L.append(f"  {'if' if first else 'else if'} ((0x{mask:x}u >> "
                         f"lane) & 1u) a{j} = {acc};")
                first = False
            L.append(f"  else a{j} = 0.0f;" if not first else
                     f"  a{j} = 0.0f;")
            for off in (16, 8, 4, 2, 1):
                L.append(f"  a{j} = a{j} + __shfl_xor_sync({_FULL}, a{j}, "
                         f"{off});")
            return
        lits = []
        for ai, a in enumerate(args):
            if self._local_of(a) >= 0:
                lits.append(self._shfl(L, a, f"q{j}_{ai}"))
            else:
                lits.append(self._shared_lit(a))
        if op == "sum":
            acc = lits[0]
            for e in lits[1:]:
                acc = f"({acc} + {e})"
            L.append(f"  const float a{j} = {acc};")
            return
        ctype = "bool" if P.dtypes[j] == "b" else "float"
        rcp = self.staged.staged_rcp(op, args)
        expr = (_OPS[op][2].format(*lits) if rcp is None
                else _div_expr(lits[0], lits[1], f"r[{rcp[0]}]", rcp[1]))
        L.append(f"  const {ctype} a{j} = {expr};")

    def _cuda_class(self, L, ci, positions):
        ks = self.classes[ci]
        masks = self._lanes_of(ci)
        first = self._lists[ks[0]]
        L.append(f"  {{ const unsigned m_[{WARP_CPL}] = {{"
                 + ", ".join(f"0x{m:x}u" for m in masks) + "};")
        L.append("#pragma unroll")
        L.append(f"  for (int c = 0; c < {WARP_CPL}; ++c) {{")
        L.append("    if (!((m_[c] >> lane) & 1u)) continue;")
        if any(key[0] == ci and "_k" in e for key, e in self._leaf.items()):
            L.append(f"    const int _k = {WARP_CPL} * lane + c;")
        for p in positions:
            j = first[p]
            op, args = self._args(j)
            lits = []
            for ai, a in enumerate(args):
                if isinstance(a, Sym) and a.kind == "x":
                    lits.append("xv[c]" if not self._is_hub(a.idx)
                                else f"xh{a.idx}")
                elif isinstance(a, Sym) and a.kind == "t":
                    lits.append(f"v{ci}_{self._pos[a.idx]}[c]"
                                if self._place[a.idx] >= 0
                                else f"a{a.idx}")
                elif (ci, p, ai) in self._leaf:
                    lits.append(self._leaf[(ci, p, ai)])
                else:
                    lits.append(_cuda_lit(a))
            rcp = self._leaf.get((ci, p, "rcp"))
            expr = (_OPS[op][2].format(*lits) if rcp is None else
                    _div_expr(lits[0], lits[1], rcp, self._exact[(ci, p)]))
            L.append(f"    v{ci}_{p}[c] = {expr};")
        L.append("  } }")

    def _cuda_outputs(self, L):
        g = self.staged.grads
        lp = self.staged.lp
        if isinstance(lp, Sym) and self._local_of(lp) >= 0:
            lp_s = self._shfl(L, lp, "lp_")
        else:
            lp_s = self._shared_lit(lp) if isinstance(lp, Sym) \
                else _cuda_lit(lp)
        L.append(f"  lp = {lp_s};")
        for c in range(WARP_CPL):
            L.append(f"  gv[{c}] = 0.0f;")
            by_expr: Dict[str, int] = {}
            for lane in range(LANES):
                k = WARP_CPL * lane + c
                if k >= self.d:
                    continue
                e = g[k]
                if isinstance(e, Sym) and self._local_of(e) == k:
                    expr = self._reg(e)
                elif isinstance(e, Sym) and self._local_of(e) >= 0:
                    expr = self._shfl(L, e, f"o{k}_")
                elif isinstance(e, Sym):
                    expr = self._shared_lit(e)
                else:
                    expr = _cuda_lit(e)
                by_expr[expr] = by_expr.get(expr, 0) | (1 << lane)
            for expr, mask in by_expr.items():
                if expr == _cuda_lit(0.0):       # gv[c] is 0.0f already
                    continue
                L.append(f"  if ((0x{mask:x}u >> lane) & 1u) gv[{c}] = "
                         f"{expr};")

    def _render_torch(self) -> str:
        lines = ["def staged_vag_warp(x, r, sd):"]
        for j in self._reach:
            op, args = self._args(j)
            if op != "sum":
                lines.append(f"    t{j} = {_torch_expr(op, args)}")
            elif self._is_split(j):
                parts = ", ".join(
                    "[" + ", ".join(_torch_lit(a) for _, a in ops) + "]"
                    for ops in self._sum_parts(args))
                lines.append(f"    t{j} = _lane_sum([{parts}], x[0])")
            else:
                acc = _torch_lit(args[0])
                for a in args[1:]:
                    acc = f"({acc} + {_torch_lit(a)})"
                lines.append(f"    t{j} = {acc}")
        outs = ", ".join(_torch_lit(g) for g in self.staged.grads)
        lines.append(f"    return {_torch_lit(self.staged.lp)}, [{outs}]")
        return "\n".join(lines) + "\n"

    def vag(self, x: torch.Tensor):
        """Value and gradient at ``x`` ``(d, n)`` in the split order:
        ``(lp (n,), grad (d, n))``."""
        return self.staged._call(self._torch_fn, x)


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
# a known float array at least this long, along one axis, becomes a row of
# the stream table (gen_tpu's default)
STREAM_THRESHOLD = 2048


def _as_sa(v) -> ScalarArray:
    if isinstance(v, ScalarArray):
        return v
    if isinstance(v, (bool, np.bool_)):
        return ScalarArray((), [bool(v)])
    if isinstance(v, (int, float)):
        return ScalarArray((), [_f32(v)])
    if isinstance(v, StreamArray):
        raise ValueError("scalarize: a per-point (data-axis) value where an "
                         "unrolled array is needed")
    raise ValueError(f"scalarize: unexpected operand {type(v).__name__}")


def _shape_of(v):
    return v.shape if isinstance(v, (ScalarArray, StreamArray)) else ()


def _broadcast(*args):
    """The broadcast shape of the operands and their elements, zipped."""
    sas = [_as_sa(a) for a in args]
    shape = np.broadcast_shapes(*[a.shape for a in sas])
    cols = [a.take(np.broadcast_to(a.index_array(), shape)).elems
            for a in sas]
    return shape, zip(*cols)


def _map_elems(prog, fn, *args):
    """``fn`` applied elementwise under broadcasting. With a per-point
    operand the result is per-point: every other operand must hold one
    element, the same at every point."""
    if not any(isinstance(a, StreamArray) for a in args):
        shape, rows = _broadcast(*args)
        return ScalarArray(shape, [fn(*xs) for xs in rows])
    shape = tuple(np.broadcast_shapes(*[_shape_of(a) for a in args]))
    if math.prod(shape) != prog.n_pts:
        raise ValueError(f"scalarize: a per-point (data-axis) value "
                         f"broadcast to shape {shape}")
    elems = []
    for a in args:
        if isinstance(a, StreamArray):
            elems.append(a.elem)
            continue
        a = _as_sa(a)
        if a.size != 1:
            raise ValueError(f"scalarize: a per-point (data-axis) value "
                             f"combined with an unrolled array of shape "
                             f"{a.shape}")
        elems.append(a.elems[0])
    return StreamArray(shape, fn(*elems))


def _elementwise(prog, op: str, *args):
    return _map_elems(prog, lambda *xs: prog.emit(op, *xs), *args)


def _sum_elems(prog, elems):
    """The left-to-right chain of adds over ``elems`` (folded as ``emit``
    folds); a chain of three or more operands is recorded as one n-ary
    sum (``Program.reductions``)."""
    acc, ops = elems[0], [elems[0]]
    for e in elems[1:]:
        new = prog.emit("add", acc, e)
        if not isinstance(new, Sym):
            ops = [new]                     # constants folded
        elif new is e and not isinstance(acc, Sym):
            ops = [e]                       # 0.0 + e
        elif not (new is acc and not isinstance(e, Sym)):
            ops.append(e)                   # (acc + 0.0 is acc)
        acc = new
    if isinstance(acc, Sym) and acc.kind == "t" and len(ops) >= 3:
        owner = getattr(prog, "outer", prog)       # a loop body's: hoisted
        getattr(owner, "prog", owner).reductions[acc.idx] = tuple(ops)
    return acc


def _reduce_sum(prog, a, dims, keepdim=False):
    nd = len(a.shape)
    dims = sorted({d % nd for d in dims}) if dims else list(range(nd))
    keep = [i for i in range(nd) if i not in dims]
    out_shape = tuple(a.shape[i] for i in keep)
    if isinstance(a, StreamArray):
        summed = any(a.shape[i] > 1 for i in dims)
        if keepdim:
            out_shape = tuple(1 if i in dims else s
                              for i, s in enumerate(a.shape))
        if not summed:
            return StreamArray(out_shape, a.elem)
        return ScalarArray(out_shape, [prog.data_sum(a.elem)])
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


def _cast_elem(prog, e, dt: str):
    if _dtype_of(e) == dt:
        return e
    if dt == "b":
        return prog.emit("ne", e, 0.0)
    return prog.emit("where", e, 1.0, 0.0)


def _cast(prog, a, dt: str):
    """Elementwise cast between float32 and bool: a float becomes ``x !=
    0``, a bool 1.0 or 0.0, so that a cast value carries the cast's
    semantics into whatever reads it."""
    return _map_elems(prog, lambda e: _cast_elem(prog, e, dt), a)


def _xlogy(prog, log_op: str, x, y):
    """torch's ``xlogy``/``xlog1py``: NaN where y is NaN, else 0 where x
    is 0, else x * log(y) (log1p(y))."""
    def one(a, b):
        out = prog.emit("where", prog.emit("eq", a, 0.0), 0.0,
                        prog.emit("mul", a, prog.emit(log_op, b)))
        return prog.emit("where", prog.emit("isnan", b), math.nan, out)

    return _map_elems(prog, one, x, y)


def _filled(prog, shape, value):
    if prog.is_stream_shape(shape):
        prog.set_length(math.prod(shape))
        return StreamArray(shape, value)
    return ScalarArray(shape, [value] * math.prod(shape))


def _expand_shape(src_shape, shape):
    shape = list(shape)
    off = len(shape) - len(src_shape)
    return tuple(src_shape[i - off] if s == -1 else s
                 for i, s in enumerate(shape))


def _apply_stream(prog, target, args, kwargs):
    """The shape ops and reductions of a per-point value; None for the
    elementwise ops, which :func:`_apply` routes through
    :func:`_map_elems`."""
    name = getattr(target, "__name__", str(target))
    a = args[0]

    def reshaped(shape):
        shape = tuple(shape)
        if math.prod(shape) != prog.n_pts or \
                sum(s > 1 for s in shape) != 1:
            raise ValueError(f"scalarize: '{name}' moves a per-point "
                             f"(data-axis) value to shape {shape}")
        return StreamArray(shape, a.elem)

    if not isinstance(a, StreamArray):
        if target in (aten.cat.default, aten.stack.default):
            raise ValueError(f"scalarize: aten op '{name}' on a per-point "
                             "(data-axis) value is not supported")
        return None
    if target in (aten.view.default, aten._unsafe_view.default,
                  aten.reshape.default):
        return reshaped(_view_shape(args[1], a.size))
    if target in (aten.squeeze.default, aten.squeeze.dim,
                  aten.squeeze.dims):
        return reshaped([s for s in a.shape if s > 1])
    if target is aten.unsqueeze.default:
        shape = list(a.shape)
        shape.insert(args[1] % (len(shape) + 1), 1)
        return reshaped(shape)
    if target is aten.expand.default:
        return reshaped(_expand_shape(a.shape, args[1]))
    if target is aten.permute.default:
        return reshaped([a.shape[i] for i in args[1]])
    if target in (aten.t.default, aten.transpose.int):
        shape = list(a.shape)
        i, j = (0, -1) if target is aten.t.default else args[1:3]
        shape[i], shape[j] = shape[j], shape[i]
        return reshaped(shape)
    if target is aten.sum.default:
        return _reduce_sum(prog, a, None)
    if target is aten.sum.dim_IntList:
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        return _reduce_sum(prog, a, dims, keep)
    elementwise = (set(_UNARY_ATEN) | set(_BINARY_ATEN) | set(_XLOGY_ATEN)
                   | _IDENTITY_ATEN | set(_FILL_ATEN) | {
                       aten.add.Tensor, aten.add.Scalar, aten.sub.Tensor,
                       aten.sub.Scalar, aten.rsub.Scalar, aten.rsub.Tensor,
                       aten.where.self, aten.sigmoid_backward.default,
                       aten.tanh_backward.default, aten.masked_fill.Scalar,
                       aten.masked_fill.Tensor, aten.clamp.default,
                       aten.clamp_min.default, aten.clamp_max.default,
                       aten._to_copy.default, aten.full_like.default})
    if target in elementwise:
        return None
    raise ValueError(f"scalarize: aten op '{name}' on a per-point "
                     "(data-axis) value is not supported")


# -- part b: the structured ops, unrolled into straight-line arithmetic ------

def _mats(a: ScalarArray):
    """The matrices of a (..., n, m) array as nested element lists, with
    the batch shape."""
    *batch, n, m = a.shape
    idx = a.index_array().reshape(-1, n, m)
    return tuple(batch), [[[a.elems[idx[b, i, j]] for j in range(m)]
                           for i in range(n)] for b in range(idx.shape[0])]


def _from_mats(batch, mats) -> ScalarArray:
    n, m = len(mats[0]), len(mats[0][0])
    return ScalarArray(tuple(batch) + (n, m),
                       [e for M in mats for row in M for e in row])


def _transpose(M):
    return [list(col) for col in zip(*M)]


def _chol(prog, A):
    """Cholesky-Banachiewicz on the lower triangle, gen_tpu's order:
    ``s = A[i][j] - L[i][0] L[j][0] - ...``, then ``sqrt(s)`` on the
    diagonal and ``s / L[j][j]`` below it."""
    n = len(A)
    L = [[0.0] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            acc = A[i][j]
            for k in range(j):
                acc = prog.emit("sub", acc, prog.emit("mul", L[i][k],
                                                      L[j][k]))
            L[i][j] = prog.emit("sqrt", acc) if i == j else \
                prog.emit("div", acc, L[j][j])
    return L


def _trisolve(prog, A, B, lower: bool, unit: bool = False):
    """``A X = B`` for a triangular ``A`` by forward (``lower``) or back
    substitution, as gen_tpu's unrolled ``triangular_solve``."""
    n, m = len(A), len(B[0])
    X = [[None] * m for _ in range(n)]
    for i in (range(n) if lower else range(n - 1, -1, -1)):
        for c in range(m):
            acc = B[i][c]
            for k in (range(i) if lower else range(i + 1, n)):
                acc = prog.emit("sub", acc, prog.emit("mul", A[i][k],
                                                      X[k][c]))
            X[i][c] = acc if unit else prog.emit("div", acc, A[i][i])
    return X


def _pairs(a: ScalarArray, b: ScalarArray):
    """Matrix pairs of two batched arrays (equal batches, or a 2-D ``a``)."""
    ba, ma = _mats(a)
    bb, mb = _mats(b)
    if len(ma) != len(mb) and len(ma) != 1:
        raise ValueError(f"scalarize: batch shapes {ba} and {bb} of a "
                         "structured op are not supported")
    return bb, [(ma[k if len(ma) > 1 else 0], mb[k]) for k in range(len(mb))]


def _cholesky_ex(prog, a, upper=False, check_errors=False):
    batch, mats = _mats(a)
    out = []
    for A in mats:
        L = _chol(prog, _transpose(A) if upper else A)
        out.append(_transpose(L) if upper else L)
    info = ScalarArray(batch, [0.0] * math.prod(batch))
    return _from_mats(batch, out), info


def _solve_triangular(prog, a, b, *, upper, left=True, unitriangular=False):
    batch, pairs = _pairs(a, b)
    out = []
    for A, B in pairs:
        if left:
            out.append(_trisolve(prog, A, B, not upper, unitriangular))
        else:        # X A = B  <=>  A^T X^T = B^T
            out.append(_transpose(_trisolve(prog, _transpose(A),
                                            _transpose(B), upper,
                                            unitriangular)))
    return _from_mats(batch, out)


def _cholesky_solve(prog, b, l, upper=False):
    """``(L L^T) X = B`` (``U^T U`` when ``upper``): two substitutions."""
    batch, pairs = _pairs(l, b)
    out = []
    for L, B in pairs:
        low = _transpose(L) if upper else L
        y = _trisolve(prog, low, B, lower=True)
        out.append(_trisolve(prog, _transpose(low), y, lower=False))
    return _from_mats(batch, out)


def _cholesky_inverse(prog, l, upper=False):
    n = l.shape[-1]
    eye = ScalarArray((n, n), [1.0 if i == j else 0.0 for i in range(n)
                               for j in range(n)])
    return _cholesky_solve(prog, eye, l, upper)


def _tri_mask(prog, a, diagonal=0, lower=True):
    batch, mats = _mats(a)
    keep = (lambda i, j: j - i <= diagonal) if lower else \
        (lambda i, j: j - i >= diagonal)
    return _from_mats(batch, [[[e if keep(i, j) else 0.0
                                for j, e in enumerate(row)]
                               for i, row in enumerate(M)] for M in mats])


def _diagonal(prog, a, offset=0, dim1=0, dim2=1):
    return a.take(np.diagonal(a.index_array(), offset, dim1, dim2))


def _diagonal_backward(prog, grad, sizes, offset, dim1, dim2):
    ids = np.arange(math.prod(sizes)).reshape(sizes)
    return _scatter_zeros(grad, sizes, np.diagonal(ids, offset, dim1, dim2))


_STRUCTURED = {
    aten.linalg_cholesky_ex.default: _cholesky_ex,
    aten._linalg_check_errors.default: lambda prog, *a, **k: None,
    aten.linalg_solve_triangular.default: _solve_triangular,
    aten.cholesky_solve.default: _cholesky_solve,
    aten.cholesky_inverse.default: _cholesky_inverse,
    aten.tril.default: lambda prog, a, diagonal=0: _tri_mask(
        prog, a, diagonal, True),
    aten.triu.default: lambda prog, a, diagonal=0: _tri_mask(
        prog, a, diagonal, False),
    aten.diagonal.default: _diagonal,
    aten.diagonal_backward.default: _diagonal_backward,
}


def _apply_stacked(prog, target, args, kwargs):
    """An op that reads a scan's stacked output: picking it from the
    scan's outputs, or a sum over the scan axis (then the forward loop
    accumulates each of its elements, and the remaining axes sum after
    the loop)."""
    a = args[0]
    if target is operator.getitem:
        return a[args[1]]
    if isinstance(a, Stacked) and target in _IDENTITY_ATEN:
        return a
    others = [v for v in list(args[1:]) + list(kwargs.values())
              if isinstance(v, Stacked)]
    if isinstance(a, Stacked) and not others and target in (
            aten.sum.default, aten.sum.dim_IntList):
        nd = len(a.shape)
        dims = None if target is aten.sum.default else (
            args[1] if len(args) > 1 else kwargs.get("dim"))
        keep = target is aten.sum.dim_IntList and (
            args[2] if len(args) > 2 else kwargs.get("keepdim", False))
        dims = sorted({k % nd for k in dims}) if dims else list(range(nd))
        if 0 in dims:
            out = ScalarArray(a.shape[1:], [a.loop.accumulate(prog, e)
                                            for e in a.elems])
            if len(dims) > 1:
                out = _reduce_sum(prog, out, [k - 1 for k in dims[1:]])
            if keep:
                out = ScalarArray(tuple(1 if i in dims else s for i, s in
                                        enumerate(a.shape)), out.elems)
            return out
    loop = (a if isinstance(a, Stacked) else others[0]).loop
    name = getattr(target, "__name__", str(target))
    raise ValueError(f"scalarize: '{prog.node_name}' ({name}) reads the "
                     f"stacked output of the scan '{loop.name}' other than "
                     "by a sum over its steps; only such sums are staged")


def _apply(prog, target, args, kwargs):
    name = getattr(target, "__name__", str(target))
    flat = []
    torch.fx.node.map_aggregate((args, kwargs), flat.append)
    if any(isinstance(a, Stacked) for a in flat):
        return _apply_stacked(prog, target, args, kwargs)
    if any(isinstance(a, StreamArray) for a in flat):
        out = _apply_stream(prog, target, args, kwargs)
        if out is not None:
            return out
    elif target in _STRUCTURED:
        prog.structured = True
        return _STRUCTURED[target](prog, *args, **kwargs)
    if target is operator.getitem:
        return args[0][args[1]]
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
        shape = _shape_of(src) if isinstance(
            src, (ScalarArray, StreamArray)) else tuple(src)
        if target in (aten.new_zeros.default, aten.new_ones.default):
            shape = tuple(args[1])
        return _filled(prog, shape, _FILL_ATEN[target])
    if target in (aten.full.default, aten.full_like.default):
        shape = tuple(args[0]) if target is aten.full.default \
            else _shape_of(args[0])
        return _filled(prog, shape, _f32(args[1]))
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
        shape = _expand_shape(a.shape, args[1])
        if a.size == 1 and prog.is_stream_shape(shape):
            # a per-chain value broadcast along the data axis (e.g. the
            # cotangent of a data-sum)
            prog.set_length(math.prod(shape))
            return StreamArray(shape, a.elems[0])
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
    if target is aten.bmm.default:
        (ba, ma), (_, mb) = _mats(args[0]), _mats(args[1])
        out = [_matmul(prog, _from_mats((), [x]), _from_mats((), [y]))
               for x, y in zip(ma, mb)]
        return _from_mats(ba, [_mats(o)[1][0] for o in out])
    raise ValueError(f"scalarize: aten op '{name}' is not supported in the "
                     "x-dependent part of logp")


def _to_elements(v, res_vals: List[torch.Tensor], staged: Dict):
    """A known (partially evaluated) value as program elements: tensors
    become staged residual constants, Python numbers stay literals. A
    tensor equal to one staged already (the same constant read again, as
    the unrolled steps of a recursion do) reuses its constants."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bool or not torch.is_floating_point(v):
            vals = v.detach().cpu().reshape(-1).tolist()
            return ScalarArray(v.shape, [bool(e) if v.dtype == torch.bool
                                         else _f32(e) for e in vals])
        flat = v.detach().reshape(-1).to(torch.float32)
        key = (tuple(v.shape), flat.cpu().numpy().tobytes())
        if key not in staged:
            base = sum(int(t.numel()) for t in res_vals)
            res_vals.append(flat)
            staged[key] = ScalarArray(v.shape, [Sym("r", base + i)
                                                for i in range(v.numel())])
        return staged[key]
    return v


def _trace(fn, *args):
    """``make_fx`` of ``fn`` at ``args``, then of that graph functionalized,
    so that in-place ops from autograd's backward formulas (e.g. clamp's
    ``masked_fill_``) arrive as pure ops. Tracing records each node's value
    as a fake tensor; one fake mode for the whole trace (a tracing context)
    spares building a new one, stack trace and all, per node, which is most
    of the time of a long program's trace."""
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode

    def run():
        gm = make_fx(fn)(*args)
        return make_fx(torch.func.functionalize(gm, remove="mutations"))(
            *args)

    if TracingContext.try_get() is not None:
        return run()
    with tracing(TracingContext(FakeTensorMode(allow_fallback_kernels=True))):
        return run()


def _value_and_grad(logp):
    """``x -> (grad, value)`` of ``logp`` by plain autograd."""
    def vag(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = logp(x)
            if not lp.requires_grad:
                return torch.zeros_like(x), lp.detach()
            g, = torch.autograd.grad(lp, x, allow_unused=True,
                                     materialize_grads=True)
        return g, lp.detach()
    return vag


def _elem_key(e):
    return e.key() if isinstance(e, Sym) else ("v", _cuda_lit(e))


class _GraphEval:
    """Partial evaluation of a traced graph into a stager's programs: a
    node that reads no placeholder runs in torch; the rest become program
    elements. Holds what every graph of one staging shares: the staged
    residual constants and the scans' registry."""

    def __init__(self, registry, max_residual_scalars: int,
                 stream_threshold: int, allow_stream: bool):
        self.registry = registry
        self.max_res = max_residual_scalars
        self.stream_threshold = stream_threshold
        self.allow_stream = allow_stream
        self.res_vals: List[torch.Tensor] = []
        self.staged_res: Dict = {}

    def to_res(self, v):
        """``_to_elements`` of ``v``, within the residual cap."""
        out = _to_elements(v, self.res_vals, self.staged_res)
        total = sum(int(t.numel()) for t in self.res_vals)
        if total > self.max_res:
            raise ValueError(
                f"scalarized residual needs {total} staged scalars "
                f"(> {self.max_res}): the x-dependent part of this logp "
                "touches large arrays that do not stream (one data axis of "
                f">= {self.stream_threshold} points streams; "
                f"allow_stream={self.allow_stream})")
        return out

    def run(self, gm, inputs, st):
        """The graph's output, its placeholders bound to ``inputs``, its
        instructions emitted through ``st``."""
        known: Dict[Any, Any] = {}
        residual = {}
        # known nodes computed from graph literals alone (fills and what
        # follows from them): their elements become literals, not residual
        # constants, so they fold; the generated source stays
        # data-independent
        literal_nodes = set()
        as_elements: Dict[Any, Any] = {}
        inputs = iter(inputs)
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
                    elif isinstance(v, torch.Tensor) and \
                            st.is_stream_shape(v.shape) and \
                            (torch.is_floating_point(v)
                             or v.dtype == torch.bool):
                        as_elements[n] = st.data_leaf(v)
                    else:
                        as_elements[n] = self.to_res(v)
                return as_elements[n]
            return torch.fx.node.map_arg(a, conv)

        for node in gm.graph.nodes:
            if node.op == "placeholder":
                residual[node] = next(inputs)
            elif node.op == "get_attr":
                known[node] = getattr(gm, node.target)
            elif node.op == "call_function":
                deps = []
                torch.fx.node.map_arg((node.args, node.kwargs), deps.append)
                # a scan's pullback is always staged (its op computes
                # nothing: gen_tpu_torch/ops/scan.py)
                if (not any(is_res(a) for a in deps)
                        and node.target is not _SCAN_OPS[1]):
                    val = node.target(*known_val(node.args),
                                      **known_val(node.kwargs))
                    known[node] = val
                    if (isinstance(val, torch.Tensor)
                            and torch.is_floating_point(val)
                            and val.numel() <= 64
                            and (node.target in _FILL_ATEN
                                 or node.target in (aten.full.default,
                                                    aten.scalar_tensor.default,
                                                    aten.eye.default)
                                 or (deps and all(a in literal_nodes
                                                  for a in deps)))):
                        literal_nodes.add(node)
                elif node.target in _SCAN_OPS:
                    st.node_name = node.name
                    if not isinstance(st, _Stager):
                        raise ValueError(f"scalarize: the scan '{node.name}'"
                                         " inside another scan's step is "
                                         "not supported")
                    stage = (self._scan_fwd if node.target is _SCAN_OPS[0]
                             else self._scan_bwd)
                    residual[node] = stage(node, st, is_res, known, sa_val)
                else:
                    st.node_name = node.name
                    residual[node] = _apply(st, node.target,
                                            sa_val(node.args),
                                            sa_val(node.kwargs))
            elif node.op == "output":
                out_node = node
            else:
                raise ValueError(f"scalarize: graph node kind {node.op!r}")
        return sa_val(out_node.args[0])

    # -- scans ------------------------------------------------------------

    def _data(self, node, known, is_res):
        """The scan's ``xs``, which must be known float data."""
        xs_n = node.args[3]
        if is_res(xs_n):
            raise ValueError(f"scalarize: the scan '{node.name}' runs over "
                             "x-dependent data; its xs must be known")
        xs = known[xs_n]
        if not torch.is_floating_point(xs):
            raise ValueError(f"scalarize: the scan '{node.name}' runs over "
                             f"{xs.dtype} data; its xs must be float")
        return xs

    def stage_data(self, loops: List[Loop]):
        """Each scan's ``xs`` as residual constants after all others (so
        that the staged source depends on T only through the trip counts):
        step t's element i at ``r[ybase + t ywidth + i]``."""
        for lp in loops:
            if lp.fwd is None:
                lp.ybase = self.to_res(lp.xs).elems[0].idx
        for lp in loops:
            if lp.fwd is not None:
                lp.ybase = lp.fwd.ybase

    def _scan_fwd(self, node, st, is_res, known, sa_val):
        """The forward loop of a scan: its outputs are the final carry's
        leaves, then each output of the step stacked over the steps."""
        key = node.args[0]
        entry = self.registry[key]
        xs = self._data(node, known, is_res)
        T, width = int(xs.shape[0]), int(xs[0].numel())
        loop = Loop(node.name, T, False, width)
        loop.xs = xs
        consts = [_as_sa(v) for v in sa_val(node.args[1])]
        inits = [_as_sa(v) for v in sa_val(node.args[2])]
        carry = []
        for leaf in inits:
            syms = [st.new_sym("c", _dtype_of(e)) for e in leaf.elems]
            loop.state += syms
            loop.inits += leaf.elems
            loop.leaves.append((leaf.shape, _dtype_of(leaf.elems[0])))
            carry.append(ScalarArray(leaf.shape, syms))
        ex_c, ex_i, ex_x = entry.example
        x_t = ScalarArray(ex_x.shape[1:], [Sym("y", i) for i in range(width)])
        nc, ni = len(ex_c), len(ex_i)

        def step(*flat):
            new, y = entry.flat(list(flat[:nc]), list(flat[nc:nc + ni]),
                                flat[-1])
            return new + y

        with torch.no_grad():
            loop.y_example = entry.flat(ex_c, ex_i, ex_x[0])[1]
        outs = self.run(_trace(step, *ex_c, *ex_i, ex_x[0]),
                        consts + carry + [x_t], _LoopStager(st, loop))
        loop.updates = [e for v in outs[:ni] for e in _as_sa(v).elems]
        k = 0
        for (shape, dt), leaf in zip(loop.leaves, inits):
            upd = loop.updates[k:k + leaf.size]
            const = [not isinstance(u, Sym) for u in upd]
            if dt == "b" and all(const):
                for i, (init, u) in enumerate(zip(leaf.elems, upd)):
                    loop.fixed[k + i] = (init, bool(u))
            elif dt == "b" or any(const):
                raise ValueError(
                    f"scalarize: the carry of the scan '{node.name}' holds a "
                    "value that is neither a float every step computes nor "
                    "a boolean flag every step sets to a constant")
            k += leaf.size
        loop.pos = len(st.prog.instrs)
        st.loops.append(loop)
        st.scans[key] = loop
        finals = []
        k = 0
        for leaf in inits:
            finals.append(ScalarArray(leaf.shape, [
                loop.fixed[i][1] if i in loop.fixed else loop.state[i]
                for i in range(k, k + leaf.size)]))
            k += leaf.size
        return finals + [Stacked(loop, (T,) + _as_sa(v).shape,
                                 _as_sa(v).elems) for v in outs[ni:]]

    def _step_cotangent(self, node, fwd, a, j, is_res, known, sa_val):
        """The cotangent of step output ``j`` (one step's elements) from
        that of its stack, which must be the same at every step."""
        T = fwd.n_steps
        if is_res(a):
            elems = _as_sa(sa_val(a)).elems
            n = len(elems) // T
            rows = [elems[t * n:(t + 1) * n] for t in range(T)]
            same = all([_elem_key(e) for e in row]
                       == [_elem_key(e) for e in rows[0]] for row in rows)
            one = rows[0]
        else:
            v = known[a].detach().to(torch.float32).reshape(T, -1)
            bits = v.view(torch.int32)
            same = bool((bits == bits[:1]).all())
            one = [_f32(e) for e in v[0].tolist()]
        if not same:
            raise ValueError(
                f"scalarize: '{node.name}' takes a cotangent of output {j} of "
                f"the scan '{fwd.name}' that varies from step to step: a "
                "stacked output is used other than by a sum over its steps")
        return one

    def _scan_bwd(self, node, st, is_res, known, sa_val):
        """The backward loop of a scan: its outputs are the cotangents of
        the consts (loop accumulators) and of the initial carry."""
        key = node.args[0]
        entry, fwd = self.registry[key], st.scans.get(key)
        if fwd is None:
            raise ValueError(f"scalarize: '{node.name}' is the pullback of "
                             "a scan that was not staged")
        consts_n, cts_n = node.args[1], node.args[4]
        consts = [_as_sa(v) for v in sa_val(consts_n)]
        ex_c, ex_i, ex_x = entry.example
        nc, ni = len(ex_c), len(ex_i)
        need = [i for i, n in enumerate(consts_n)
                if is_res(n) and ex_c[i].is_floating_point()]
        floats = [li for li, (_, dt) in enumerate(fwd.leaves) if dt == "f"]

        def elems_of(a):
            if is_res(a):
                return _as_sa(sa_val(a)).elems
            return [_f32(e) for e in known[a].detach().to(torch.float32)
                    .reshape(-1).tolist()]

        ct_y, sel = [], []
        for j, a in enumerate(cts_n[ni:]):
            one = self._step_cotangent(node, fwd, a, j, is_res, known,
                                       sa_val)
            if any(isinstance(e, Sym) or e != 0.0 for e in one):
                sel.append(j)
                ct_y.append(ScalarArray(fwd.y_example[j].shape, one))
        loop = Loop(fwd.name, fwd.n_steps, True, fwd.ywidth)
        loop.fwd = fwd
        ct_carry = []
        for li in floats:
            init = elems_of(cts_n[li])
            syms = [st.new_sym("c") for _ in init]
            loop.state += syms
            loop.inits += init
            ct_carry.append(ScalarArray(fwd.leaves[li][0], syms))
        k_in, k = [], 0
        for shape, dt in fwd.leaves:
            n = math.prod(shape)
            k_in.append(ScalarArray(shape, [Sym("k", i, dt)
                                            for i in range(k, k + n)]))
            k += n
        x_t = ScalarArray(ex_x.shape[1:], [Sym("y", i)
                                           for i in range(fwd.ywidth)])

        def pullback(*flat):
            cs, ks = list(flat[:nc]), list(flat[nc:nc + ni])
            cts = flat[nc + ni + 1:]
            with torch.enable_grad():
                cs = [c.detach().requires_grad_(True) if i in need else c
                      for i, c in enumerate(cs)]
                ks = [c.detach().requires_grad_(True) if li in floats else c
                      for li, c in enumerate(ks)]
                new, y = entry.flat(cs, ks, flat[nc + ni])
                outs = [new[li] for li in floats] + [y[j] for j in sel]
                pairs = [(o, g) for o, g in zip(outs, cts) if o.requires_grad]
                wrt = [cs[i] for i in need] + [ks[li] for li in floats]
                if not pairs:
                    return [torch.zeros_like(w) for w in wrt]
                return list(torch.autograd.grad(
                    [o for o, _ in pairs], wrt, [g for _, g in pairs],
                    allow_unused=True, materialize_grads=True))

        ex = [*ex_c, *ex_i, ex_x[0]] + [torch.ones_like(ex_i[li])
                                        for li in floats] + [
            torch.ones_like(fwd.y_example[j]) for j in sel]
        outs = self.run(_trace(pullback, *ex),
                        consts + k_in + [x_t] + ct_carry + ct_y,
                        _LoopStager(st, loop))
        loop.updates = [e for v in outs[len(need):] for e in _as_sa(v).elems]
        grads = dict(zip(need, outs[:len(need)]))
        out = []
        for i, c in enumerate(consts):
            out.append(ScalarArray(c.shape, [loop.accumulate(st, e)
                                             for e in _as_sa(grads[i]).elems])
                       if i in grads else ScalarArray(c.shape,
                                                      [0.0] * c.size))
        for li, (shape, _) in enumerate(fwd.leaves):
            out.append(ct_carry[floats.index(li)] if li in floats
                       else ScalarArray(shape, [0.0] * math.prod(shape)))
        loop.pos = len(st.prog.instrs)
        st.loops.append(loop)
        return out


_FLT_MIN = 2.0 ** -126


def _stage_reciprocals(st: _Stager, ev: _GraphEval):
    """The correctly rounded float32 reciprocal ``1 / b`` of every residual
    constant ``b`` that a program divides by, staged (computed here, once)
    after all other residual constants, the scans' data included, so that
    no index the torch rendering reads moves; ``st.rcp_res`` maps ``b``'s
    index to its reciprocal's. A ``b`` that is not a normal number, or
    whose reciprocal is not one
    (zero, subnormal, infinite, NaN, or above 2^126), gets none: the CUDA
    rendering divides by it as IEEE division. Where ``1 / b`` is exact (a
    power of two), ``a / b`` and ``a * (1 / b)`` are the same real number
    for every ``a``, so they round alike: ``st.rcp_exact`` holds such
    ``b``, which the CUDA rendering multiplies by."""
    progs = [st.prog, st.pprog] + [lp.body for lp in st.loops]
    dens = sorted({a[1].idx for P in progs for op, a in P.instrs
                   if op == "div" and isinstance(a[1], Sym)
                   and a[1].kind == "r"})
    if not dens:
        return
    vals = torch.cat([t.detach().reshape(-1).to(torch.float32).cpu()
                      for t in ev.res_vals]).numpy()
    base = sum(int(t.numel()) for t in ev.res_vals)
    rcps = []
    with np.errstate(all="ignore"):
        for k in dens:
            b = np.float32(vals[k])
            y = np.float32(1.0) / b
            if (np.isfinite(b) and abs(b) >= _FLT_MIN and np.isfinite(y)
                    and abs(y) >= _FLT_MIN):
                st.rcp_res[k] = base + len(rcps)
                rcps.append(y)
                if np.float64(b) * np.float64(y) == 1.0:
                    st.rcp_exact.add(k)
    if rcps:
        ev.res_vals.append(torch.from_numpy(np.array(rcps, np.float32)))


def stage_scalarized(logp, d: int, device=None,
                     max_residual_scalars: int = MAX_RESIDUAL_SCALARS,
                     stream_threshold: int = STREAM_THRESHOLD,
                     allow_stream: bool = True) -> StagedLogp:
    """Stage ``logp`` for per-chain evaluation; see :class:`StagedLogp`.
    The data-only part runs once, here, on ``device``.

    A known float (or bool) array with one axis of at least
    ``stream_threshold`` elements that the x-dependent part reads becomes a
    row of the stream table instead of residual constants, and every sum
    over that axis one accumulator of the stream loop (part c). With
    ``allow_stream=False`` such an array counts against
    ``max_residual_scalars`` like any other, as in gen_tpu. gen_tpu's
    ``max_stream_bytes`` (its SMEM budget, above which it streamed from
    HBM in DMA tiles) has no counterpart: the kernels read the table from
    device memory in one loop whatever its size. A
    :func:`~gen_tpu_torch.ops.scan.scan` in ``logp`` becomes a pair of
    loops (part b)."""
    st = _Stager(stream_threshold if allow_stream else None)
    x = ScalarArray((d,), [Sym("x", i) for i in range(d)])
    with scan.staging() as registry:
        gm = _trace(_value_and_grad(logp),
                    torch.zeros((d,), dtype=torch.float32, device=device))
        ev = _GraphEval(registry, max_residual_scalars, stream_threshold,
                        allow_stream)
        grad_out, val_out = ev.run(gm, [x], st)
    ev.stage_data(st.loops)
    _stage_reciprocals(st, ev)
    grad_out, val_out = _as_sa(grad_out), _as_sa(val_out)
    if val_out.size != 1 or grad_out.shape != (d,):
        raise ValueError(f"scalarize: logp must map (d,) to a scalar; got "
                         f"value {val_out.shape}, grad {grad_out.shape}")
    if st.loops and st.sums:
        raise ValueError(f"scalarize: the scan '{st.loops[0].name}' and a "
                         f"streamed likelihood ('{st.sum_names[0]}') in one "
                         "logp are not supported")
    if ev.res_vals:
        res = torch.cat([t.to(device=device, dtype=torch.float32)
                         for t in ev.res_vals])
    else:
        res = torch.zeros((1,), dtype=torch.float32, device=device)
    return StagedLogp(d, st, val_out.elems[0], grad_out.elems, res)
