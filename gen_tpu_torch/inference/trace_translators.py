"""Trace transforms and trace translators (involutive / RJMCMC machinery).

Counterpart: ``gen_tpu/inference/trace_translators.py``, all of it. A
*trace transform* is a differentiable map between pairs of choice maps
(model_in, aux_in) -> (model_out, aux_out) built from read/write/copy
primitives with continuous/discrete annotations; its log-|det Jacobian| on
the continuous coordinates corrects the MH acceptance ratio. The transform
is a plain Python function over a :class:`TransformContext`, run once to
record its structure and again under ``torch.func.jacfwd`` (gen_tpu's
``jax.jacfwd``) for the Jacobian, whose ``torch.linalg.slogdet`` is the
correction. The context only stores references to the values it is given
(no tensor is written in place), so the Jacobian also runs inside
``torch.func.vmap`` over chains. Discrete reads and writes and copies stay
out of the Jacobian.

Four translator classes, with gen_tpu's key splits: Deterministic,
General, SimpleExtending and Symmetric; ``mh_involutive`` (alias
``involutive_mcmc``) takes a :class:`TraceTransform` or a plain involution
function.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .. import random
from ..choice_map import ChoiceMap, _allclose
from ..diff import all_no_change
from ..gfi import GenerativeFunction, Trace

MODEL_IN = "model_in"
AUX_IN = "aux_in"
MODEL_OUT = "model_out"
AUX_OUT = "aux_out"

_IN_STREAMS = (MODEL_IN, AUX_IN)
_OUT_STREAMS = (MODEL_OUT, AUX_OUT)


class _StreamReader:
    """Sugar: ``ctx.model_in["x"]`` reads a continuous value;
    ``ctx.model_in.discrete["k"]`` reads a discrete one."""

    def __init__(self, ctx, stream):
        self._ctx = ctx
        self._stream = stream
        self.discrete = _DiscreteReader(ctx, stream)

    def __getitem__(self, addr):
        return self._ctx.read(self._stream, addr, "continuous")


class _DiscreteReader:
    def __init__(self, ctx, stream):
        self._ctx = ctx
        self._stream = stream

    def __getitem__(self, addr):
        return self._ctx.read(self._stream, addr, "discrete")


class _StreamWriter:
    def __init__(self, ctx, stream):
        self._ctx = ctx
        self._stream = stream
        self.discrete = _DiscreteWriter(ctx, stream)

    def __setitem__(self, addr, value):
        self._ctx.write(self._stream, addr, value, "continuous")


class _DiscreteWriter:
    def __init__(self, ctx, stream):
        self._ctx = ctx
        self._stream = stream

    def __setitem__(self, addr, value):
        self._ctx.write(self._stream, addr, value, "discrete")


class TransformContext:
    """The object a transform body manipulates (the reference's @read/
    @write/@copy macros)."""

    def __init__(self, inputs, flat_reads=None):
        self._inputs = {s: (inputs.get(s) or ChoiceMap()) for s in _IN_STREAMS}
        self._outputs = {s: ChoiceMap() for s in _OUT_STREAMS}
        self.cont_reads = []       # [(stream, path)]
        self.cont_read_values = []
        self.cont_writes = []      # [(stream, path)]
        self.cont_write_values = []
        self.copies = []           # [(src_stream, src_addr, dst_stream, dst_addr)]
        self._flat_reads = flat_reads  # jacobian re-run: substituted values
        self._read_cursor = 0

        self.model_in = _StreamReader(self, MODEL_IN)
        self.aux_in = _StreamReader(self, AUX_IN)
        self.model_out = _StreamWriter(self, MODEL_OUT)
        self.aux_out = _StreamWriter(self, AUX_OUT)

    # -- primitives -------------------------------------------------------

    def read(self, stream, addr, typ="continuous"):
        if stream not in _IN_STREAMS:
            raise ValueError(f"cannot read from output stream {stream!r}")
        value = self._inputs[stream].get_value(addr)
        if typ == "continuous":
            if self._flat_reads is not None:
                value = self._flat_reads[self._read_cursor]
                self._read_cursor += 1
            else:
                self.cont_reads.append((stream, addr))
                self.cont_read_values.append(torch.as_tensor(value))
        return value

    def write(self, stream, addr, value, typ="continuous"):
        if stream not in _OUT_STREAMS:
            raise ValueError(f"cannot write to input stream {stream!r}")
        self._outputs[stream].set_value(addr, value)
        if typ == "continuous":
            self.cont_writes.append((stream, addr))
            self.cont_write_values.append(torch.as_tensor(value))

    def copy(self, src_stream, src_addr, dst_stream, dst_addr=None):
        """Copy a value or a whole submap; an identity block of the
        Jacobian, left out of its computation."""
        if dst_addr is None:
            dst_addr = src_addr
        src = self._inputs[src_stream]
        if src.has_value(src_addr):
            self._outputs[dst_stream].set_value(dst_addr,
                                                src.get_value(src_addr))
        else:
            sub = src.get_submap(src_addr)
            if sub.is_empty():
                raise KeyError(f"nothing to copy at {src_stream}[{src_addr!r}]")
            self._outputs[dst_stream].set_submap(dst_addr, sub.copy())
        self.copies.append((src_stream, src_addr, dst_stream, dst_addr))

    # -- results ----------------------------------------------------------

    @property
    def model_out_choices(self) -> ChoiceMap:
        return self._outputs[MODEL_OUT]

    @property
    def aux_out_choices(self) -> ChoiceMap:
        return self._outputs[AUX_OUT]


class TraceTransform:
    """A transform program: fn(ctx) using ctx.read/write/copy."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.__name__ = getattr(fn, "__name__", "transform")

    def run(self, model_in: ChoiceMap, aux_in: ChoiceMap):
        """Returns (model_out, aux_out, log_abs_det_jacobian)."""
        ctx = TransformContext({MODEL_IN: model_in, AUX_IN: aux_in})
        self.fn(ctx)
        n_read = len(ctx.cont_read_values)
        n_write = len(ctx.cont_write_values)
        if n_read != n_write:
            raise ValueError(
                f"transform {self.__name__} is not measure-preserving: "
                f"{n_read} continuous reads vs {n_write} continuous writes")
        if n_read == 0:
            logabsdet = torch.tensor(0.0)
        else:
            read_vals = ctx.cont_read_values

            def g(flat):
                ctx2 = TransformContext(
                    {MODEL_IN: model_in, AUX_IN: aux_in},
                    flat_reads=_unflatten_like(flat, read_vals))
                self.fn(ctx2)
                return _flatten(ctx2.cont_write_values)

            jac = torch.func.jacfwd(g)(_flatten(read_vals))
            total = jac.shape[0]
            if jac.shape != (total, total):
                raise ValueError(
                    f"transform {self.__name__}: non-square Jacobian "
                    f"{tuple(jac.shape)}")
            logabsdet = torch.linalg.slogdet(jac)[1]
        return ctx.model_out_choices, ctx.aux_out_choices, logabsdet


def _flatten(vals):
    return torch.cat([torch.as_tensor(v).reshape(-1) for v in vals]) \
        if vals else torch.zeros((0,))


def _unflatten_like(flat, protos):
    out, off = [], 0
    for p in protos:
        n = p.numel()
        out.append(flat[off:off + n].reshape(p.shape))
        off += n
    return out


def transform(fn) -> TraceTransform:
    """Decorator: the analogue of the reference's ``@transform``."""
    return TraceTransform(fn)


# -- translators ----------------------------------------------------------


class DeterministicTraceTranslator:
    """Deterministic bijection between model traces."""

    def __init__(self, p_new: GenerativeFunction, p_new_args: Tuple,
                 new_observations: ChoiceMap, f: TraceTransform):
        self.p_new = p_new
        self.p_new_args = p_new_args
        self.new_observations = new_observations
        self.f = f

    def __call__(self, key, prev_trace: Trace):
        model_out, _, logJ = self.f.run(prev_trace.get_choices(), ChoiceMap())
        constraints = model_out.merge(self.new_observations)
        new_trace, _ = self.p_new.generate(key, self.p_new_args, constraints)
        weight = (new_trace.get_score() - prev_trace.get_score() + logJ)
        return new_trace, weight


class GeneralTraceTranslator:
    """Between models with forward/backward auxiliary proposals."""

    def __init__(self, p_new: GenerativeFunction, p_new_args: Tuple,
                 new_observations: ChoiceMap, q_forward: GenerativeFunction,
                 q_forward_args: Tuple, q_backward: GenerativeFunction,
                 q_backward_args: Tuple, f: TraceTransform):
        self.p_new = p_new
        self.p_new_args = p_new_args
        self.new_observations = new_observations
        self.q_forward = q_forward
        self.q_forward_args = q_forward_args
        self.q_backward = q_backward
        self.q_backward_args = q_backward_args
        self.f = f

    def __call__(self, key, prev_trace: Trace):
        k_fwd, k_gen = random.split(key)
        fwd_choices, fwd_score, _ = self.q_forward.propose(
            k_fwd, (prev_trace,) + tuple(self.q_forward_args))
        model_out, aux_out, logJ = self.f.run(
            prev_trace.get_choices(), fwd_choices)
        constraints = model_out.merge(self.new_observations)
        new_trace, _ = self.p_new.generate(k_gen, self.p_new_args,
                                           constraints)
        bwd_score, _ = self.q_backward.assess(
            (new_trace,) + tuple(self.q_backward_args), aux_out)
        weight = (new_trace.get_score() - prev_trace.get_score()
                  + bwd_score - fwd_score + logJ)
        return new_trace, weight


class SimpleExtendingTraceTranslator:
    """Trace extension with a custom proposal, for SMC."""

    def __init__(self, p_new_args: Tuple, argdiffs: Tuple,
                 new_observations: ChoiceMap, q_forward: GenerativeFunction,
                 q_forward_args: Tuple = ()):
        self.p_new_args = p_new_args
        self.argdiffs = argdiffs
        self.new_observations = new_observations
        self.q_forward = q_forward
        self.q_forward_args = q_forward_args

    def __call__(self, key, prev_trace: Trace):
        k_fwd, k_up = random.split(key)
        fwd_choices, fwd_score, _ = self.q_forward.propose(
            k_fwd, (prev_trace,) + tuple(self.q_forward_args))
        constraints = fwd_choices.merge(self.new_observations)
        new_trace, weight, _, discard = prev_trace.get_gen_fn().update(
            k_up, prev_trace, self.p_new_args, self.argdiffs, constraints)
        if not discard.is_empty():
            raise ValueError(
                "SimpleExtendingTraceTranslator: update discarded choices — "
                "not a pure extension")
        return new_trace, weight - fwd_score


class SymmetricTraceTranslator:
    """Involution on one model's trace space: the engine of involutive
    MCMC / RJMCMC.

    ``involution`` is either a :class:`TraceTransform` over
    (model_in, aux_in) -> (model_out, aux_out), or a plain Python function
    ``(trace, fwd_choices, fwd_retval, proposal_args) ->
    (new_trace, bwd_choices, weight)``."""

    def __init__(self, q: GenerativeFunction, q_args: Tuple, involution,
                 check: bool = False):
        self.q = q
        self.q_args = tuple(q_args)
        self.involution = involution
        self.check = check

    def __call__(self, key, prev_trace: Trace):
        k_fwd, k_up = random.split(key)
        fwd_choices, fwd_score, fwd_retval = self.q.propose(
            k_fwd, (prev_trace,) + self.q_args)

        if isinstance(self.involution, TraceTransform):
            model_out, bwd_choices, logJ = self.involution.run(
                prev_trace.get_choices(), fwd_choices)
            gen_fn = prev_trace.get_gen_fn()
            args = prev_trace.get_args()
            new_trace, update_weight, _, _ = gen_fn.update(
                k_up, prev_trace, args, all_no_change(args), model_out)
            weight = update_weight + logJ
        else:
            new_trace, bwd_choices, weight = self.involution(
                prev_trace, fwd_choices, fwd_retval, self.q_args)

        bwd_score, _ = self.q.assess((new_trace,) + self.q_args, bwd_choices)
        weight = weight + bwd_score - fwd_score

        if self.check:
            self._check_round_trip(prev_trace, new_trace, fwd_choices,
                                   bwd_choices)
        return new_trace, weight

    def _check_round_trip(self, prev_trace, new_trace, fwd_choices,
                          bwd_choices):
        """Apply the involution again; it must recover the original."""
        if isinstance(self.involution, TraceTransform):
            model_out2, fwd_rt, _ = self.involution.run(
                new_trace.get_choices(), bwd_choices)
            orig = prev_trace.get_choices()
            for path, val in model_out2.leaf_items():
                ov = orig.get_value(path)
                if not _allclose(val, ov, 1e-5, 1e-5):
                    raise RuntimeError(
                        f"involution round trip failed at model[{path!r}]: "
                        f"{val} != {ov}")
            for path, val in fwd_rt.leaf_items():
                ov = fwd_choices.get_value(path)
                if not _allclose(val, ov, 1e-5, 1e-5):
                    raise RuntimeError(
                        f"involution round trip failed at aux[{path!r}]: "
                        f"{val} != {ov}")
        else:
            new2, fwd2, _ = self.involution(new_trace, bwd_choices, None,
                                            self.q_args)
            if not new2.get_choices().allclose(prev_trace.get_choices(),
                                               atol=1e-5):
                raise RuntimeError("involution round trip failed (choices)")


def mh_involutive(key, trace: Trace, proposal: GenerativeFunction,
                  proposal_args: Tuple, involution, check: bool = False):
    """Involutive MCMC: propose auxiliary choices, apply the involution,
    accept on the corrected weight. Returns (trace, accepted)."""
    from .common import mh_accept, select_trace
    translator = SymmetricTraceTranslator(proposal, proposal_args,
                                          involution, check=check)
    k_t, k_acc = random.split(key)
    new_trace, weight = translator(k_t, trace)
    accept = mh_accept(k_acc, weight)
    return select_trace(accept, new_trace, trace), accept


involutive_mcmc = mh_involutive
