"""One-call posterior sampling: adaptive NUTS/HMC over many chains with
diagnostics attached.

Counterpart: ``gen_tpu/inference/sample.py``. The whole pipeline, per-chain
``generate`` from the prior given the observations, warmup, sampling,
per-address sample arrays ``(draws, chains, ...)`` and split-R-hat /
bulk- and tail-ESS / MCSE per coordinate, is one call: the front door for
the common case, with programmable inference underneath. Engines: ``nuts``
(per-chain NUTS with dual averaging), ``chees`` (cross-chain ChEES-HMC),
``hmc_fused`` (ChEES warmup, then the fused HMC kernel K1), ``nuts_fused``
(ChEES warmup, then the pair-scheduled fused NUTS kernel K3), ``nuts_fsm``
(the tick-synchronous FSM-NUTS pipeline) and ``auto``; ``mass="dense"`` /
``"lowrank"`` whiten the fused engines' target (:mod:`.mass`).

Where PyTorch forced differences:

- No ``jit``: each engine runs eagerly, on the device of ``key`` (the card
  unless the caller names another). The chains are a batch dimension, so
  the per-chain engines (``nuts``, ``nuts_fsm``) run all chains at once
  where gen_tpu vmaps them.
- The fused engines launch the hand-written CUDA kernels on a CUDA key and
  run their plain versions on the CPU; ``auto`` probes whether the logp
  stages through :mod:`gen_tpu_torch.ops.scalarize` on a tiny batch.
- A model with unobserved discrete addresses takes gen_tpu's mixed path
  (:mod:`.mixed`): ``gibbs_nuts_fused`` (K3 with the discrete values as
  frozen coordinates) when ``engine`` is ``auto``/``mixed``, there are >= 2
  chains and the extended logp stages, else ``gibbs_nuts``; the probe's
  refusal lands in ``info["engine_reason"]``. gen_tpu ignores ``mass``,
  ``num_ticks`` and ``mesh`` there without a word; the port raises
  ``ValueError`` naming the argument (ROADMAP queue 3).
- On the card, the fused engines' ChEES warmup evaluates a float32
  population's value and gradient through the staged program's kernel
  (:mod:`gen_tpu_torch.ops.staged_eval`, one launch per evaluation) where
  gen_tpu's XLA compiles the vmapped logp: eager ``vmap`` dispatches every
  op of the logp per evaluation (``warmup_timing.py`` times both ways).
  On the CPU, and for a float64 population, it vmaps the torch logp.
  ``engine="auto"`` stages once: the fused engine reuses the probed
  target. Its reason says when the likelihood streams.
- Not ported yet, and refused with ``NotImplementedError`` naming the slice
  that brings it: ``mesh=`` (the parallel slice, ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.func import grad_and_value, vmap

from .. import random
from ..choice_map import ChoiceMap
from ..gfi import GenerativeFunction
from ..selection import Selection, select
from .nuts import nuts_warmup_and_sample


class PosteriorSamples(NamedTuple):
    samples: dict      # path -> (draws, chains, *event_shape)
    summary: dict      # path -> {mean, sd, rhat, ess_bulk, ess_tail, ...}
    info: dict         # per-chain step sizes, accept rates, leapfrog counts
    final_traces: object


def _inexact(v) -> bool:
    v = torch.as_tensor(v)
    return torch.is_floating_point(v) or torch.is_complex(v)


def _split_paths(trace, observations: ChoiceMap):
    """Unobserved addresses split by dtype: (continuous paths, discrete
    paths)."""
    obs_addrs = set(observations.addresses())
    cont, disc = [], []
    for path, v in trace.get_choices().leaf_items():
        if path in obs_addrs:
            continue
        (cont if _inexact(v) else disc).append(path)
    return cont, disc


def _default_selection(trace, observations: ChoiceMap):
    """All unobserved continuous (inexact-dtype) addresses. Errors if
    unobserved discrete addresses exist: NUTS cannot move them; pass an
    explicit ``selection`` (and handle them with gibbs/enumerate) or
    marginalize them out of the model."""
    paths, discrete = _split_paths(trace, observations)
    if discrete:
        raise ValueError(
            f"model has unobserved discrete addresses {discrete!r}; pass an "
            "explicit selection= of the continuous latents and handle the "
            "discrete ones with gibbs()/enumerate, or marginalize them")
    if not paths:
        raise ValueError("no unobserved continuous addresses to sample")
    return select(*paths), paths


def _free_mask_layout(one_trace, observations, selection):
    """Partial-selection support for the flat engines: returns
    ``(full_sel, free_mask (d_full,), sel_idx, partial)`` over the
    FULL-universe flat layout (every unobserved continuous address).
    Unselected coordinates get mask 0: frozen in the kernels (infinite
    mass), so each chain conditions on its OWN generate-sampled values,
    matching the per-chain ``nuts`` engine's partial-selection
    semantics."""
    full_sel, _ = _default_selection(one_trace, observations)
    full_items = list(one_trace.get_choices().filter(full_sel).leaf_items())
    sel_paths = {p for p, _ in
                 one_trace.get_choices().filter(selection).leaf_items()}
    universe = {p for p, _ in full_items}
    outside = sorted(sel_paths - universe)
    if outside:
        raise ValueError(
            f"selection includes addresses outside the unobserved "
            f"continuous universe: {outside!r} (observed and discrete "
            "addresses cannot be sampled by the flat engines)")
    dev = torch.as_tensor(full_items[0][1]).device
    mask_parts, sel_idx, off = [], [], 0
    for path, v in full_items:
        size = max(1, math.prod(torch.as_tensor(v).shape))
        is_sel = path in sel_paths
        mask_parts.append(torch.full((size,), 1.0 if is_sel else 0.0,
                                     dtype=torch.float32, device=dev))
        if is_sel:
            sel_idx.extend(range(off, off + size))
        off += size
    mask = torch.cat(mask_parts)
    return (full_sel, mask, torch.tensor(sel_idx, dtype=torch.int64,
                                         device=dev), len(sel_idx) != off)


def np_idx(sel_idx):
    """Static (host) index array for the partial-metric embedding."""
    return np.asarray(torch.as_tensor(sel_idx).cpu())


def _auto_engine(one_trace, observations, selection,
                 num_chains) -> Tuple[str, str]:
    """``engine="auto"`` dispatch: the fused FSM-NUTS engine whenever its
    preconditions hold (>= 2 chains for ChEES warmup, and the model's
    assess-logp stages through :func:`gen_tpu_torch.ops.scalarize.
    stage_scalarized` and evaluates on a tiny batch); otherwise per-chain
    ``nuts``, which has no preconditions. Partial selections dispatch to
    the fused engine too (frozen-coordinate conditioning); the probe runs
    over the full flat universe, which is what the fused engine samples.

    Returns ``(engine, reason)``: the reason lands in
    ``info["engine_reason"]`` and, on a fallback, in a one-line warning (a
    silent fallback would be a silent cliff of orders of magnitude)."""
    engine, _, reason = _auto_dispatch(one_trace, observations, selection,
                                       num_chains)
    return engine, reason


def _auto_dispatch(one_trace, observations, selection, num_chains):
    """:func:`_auto_engine` with the probed ``FlatTarget`` (None unless
    the fused engine was chosen): ``(engine, target, reason)``. The fused
    engine reuses the target, whose staging is cached with its logp."""
    if num_chains < 2:
        return "nuts", None, ("num_chains < 2: the fused engine warms up "
                              "with cross-chain ChEES statistics")
    try:
        full_sel, _ = _default_selection(one_trace, observations)
    except ValueError as e:
        return "nuts", None, f"flat-universe layout unavailable: {e}"
    from .target import FlatTarget
    target = FlatTarget(one_trace, full_sel)
    staged, refusal = _probe_staging(target)
    if refusal is not None:
        return "nuts", None, ("the model's assess-logp does not stage "
                              f"through ops.scalarize: {refusal}")
    if staged.streams:
        rows, n_pts = staged.stream_data.shape
        return "nuts_fused", target, (
            "scalarization probe passed; the likelihood streams "
            f"{n_pts} data points ({rows} rows) through the kernel's "
            "data loop")
    return "nuts_fused", target, "scalarization probe passed"


def _probe_staging(target):
    """``(staged, None)`` when ``target.logp`` stages through ops.scalarize
    and the staged program evaluates (with its stream table, if the
    likelihood streams); else ``(None, reason)``, the reason ``"Error:
    first line"``. Staging raises on an op outside the table, oversized
    residual constants or a data-sum that re-enters per-point arithmetic;
    evaluating the program (value and gradient) on a tiny batch catches
    what only shows there."""
    from ..ops.hmc_fused import stage
    d, dev = target.dim, target.flat0.device
    try:
        staged = stage(target.logp, d, dev)
        staged.vag(torch.zeros((d, 8), dtype=torch.float32, device=dev))
    except Exception as e:  # noqa: BLE001 - any failure means "no fusion"
        return None, f"{type(e).__name__}: {str(e).partition(chr(10))[0]}"
    return staged, None


def _value_and_grad(logp):
    gv = grad_and_value(logp)

    def vag(x):
        g, v = gv(x)
        return v, g

    return vag


def _maybe_dense(mass, target, warm_flat, winfo, k_warm, num_warmup,
                 target_accept, mass_rank=8, sel_idx=None, free_mask=None):
    """Structured-metric plumbing for the fused engines: returns
    ``(logp, inv_mass_diag, to_x_or_None, values0)`` where ``to_x`` maps
    whitened draws back to model coordinates (None for the diagonal
    pass-through). ``mass="dense"`` Cholesky-whitens against the full
    cross-chain covariance (stages d^2 residual scalars, d <~ 30);
    ``mass="lowrank"`` uses the diag + rank-``mass_rank`` metric. With
    ``sel_idx``/``free_mask`` (partial selections) the metric is estimated
    on the free subset and is the identity on the frozen coordinates,
    whose whitened-space inverse mass stays 0."""
    from . import mass as m
    d = warm_flat.shape[1]
    partial = sel_idx is not None
    ones_w = (torch.ones((d,), dtype=torch.float32, device=warm_flat.device)
              if not partial else free_mask.to(torch.float32))
    if mass == "diag":
        return target.logp, winfo["inv_mass"], None, warm_flat
    if mass == "dense":
        if d * d > 900:
            raise ValueError(
                f"mass='dense' stages d^2 = {d * d} residual scalars into "
                "the fused kernel, above the scalarization cap; use "
                "mass='lowrank' (diag + rank-k metric) for d this large")
        L = (m.partial_dense_chol(warm_flat, sel_idx, d) if partial
             else m.dense_mass_chol(warm_flat))
        return (m.whiten_logp(target.logp, L), ones_w,
                functools.partial(m.unwhiten, L), m.whiten(L, warm_flat))
    if mass == "lowrank":
        if partial:
            k = min(mass_rank, len(np.asarray(sel_idx)) - 1)
            f = m.partial_lowrank_factors(warm_flat, sel_idx, d, k,
                                          inv_mass_diag=winfo["inv_mass"])
            return (m.partial_lowrank_whiten_logp(target.logp, *f), ones_w,
                    functools.partial(m.partial_lowrank_transform, *f),
                    m.partial_lowrank_inverse_transform(*f, warm_flat))
        f = m.lowrank_mass_factors(warm_flat, min(mass_rank, d - 1),
                                   inv_mass_diag=winfo["inv_mass"])
        return (m.lowrank_whiten_logp(target.logp, *f), ones_w,
                functools.partial(m.lowrank_transform, *f),
                m.lowrank_inverse_transform(*f, warm_flat))
    raise ValueError(
        f"unknown mass {mass!r} (use 'diag', 'dense' or 'lowrank')")


def _dense_rewarmup(logp_w, ys0, key, num_warmup, target_accept,
                    free_mask=None):
    """Short step-size re-adaptation in whitened coordinates."""
    from .chees import chees_warmup_flat
    return chees_warmup_flat(
        key, _value_and_grad(logp_w), ys0,
        num_warmup=max(50, num_warmup // 2), num_samples=1,
        target_accept=target_accept, adapt_mass=False,
        free_mask=free_mask)


def _staged_population_vag(target, dtype):
    """For a float32 population on a CUDA target, the model's value and
    gradient over the ``(chains, d)`` population through the staged
    program's kernel (:func:`gen_tpu_torch.ops.staged_eval.staged_vag`,
    one launch per evaluation; the staging is cached with the logp, which
    the fused kernels then reuse). None otherwise: on the CPU, and for a
    float64 population, which the float32 kernel would round, the warmup
    vmaps the torch logp as gen_tpu vmaps its jnp logp."""
    if target.flat0.device.type != "cuda" or dtype != torch.float32:
        return None
    from ..ops import hmc_fused, staged_eval
    staged = hmc_fused.stage(target.logp, target.dim, target.flat0.device)

    def vag(xs):
        lp, g = staged_eval.staged_vag(staged, xs.T)
        return lp, g.T

    return vag


def _fused_warmup(traces, one_trace, full_sel, k_warm, num_warmup,
                  target_accept, adapt_mass, layout, mass, mass_rank,
                  target=None):
    """Phase 1 of the fused engines: ChEES warmup (one shared step size
    and trajectory length, diagonal mass from cross-chain variance), then
    the structured metric and, when one is used, a short re-warmup of the
    whitened population. ``layout`` is ``(free_mask, sel_idx, partial)``
    of :func:`_free_mask_layout`; ``target`` a ``FlatTarget`` over
    ``full_sel`` already built (and staged) by the ``auto`` probe.
    Returns ``(logp, inv_mass, to_x, warm_flat, winfo,
    winfo2_or_None)``."""
    from .chees import chees_warmup_flat
    from .target import FlatTarget
    free_mask, sel_idx, partial = layout
    fm = free_mask if partial else None
    if target is None:
        target = FlatTarget(one_trace, full_sel)
    xs0 = vmap(lambda tr: tr.get_choices().filter(full_sel).to_array())(
        traces)
    _, warm_flat, winfo = chees_warmup_flat(
        k_warm, target.value_and_grad, xs0, num_warmup=num_warmup,
        num_samples=1, target_accept=target_accept, adapt_mass=adapt_mass,
        free_mask=fm,
        batched_vag=_staged_population_vag(target, xs0.dtype))
    logp_use, inv_mass_use, to_x, warm_flat = _maybe_dense(
        mass, target, warm_flat, winfo, k_warm, num_warmup, target_accept,
        mass_rank, sel_idx=np_idx(sel_idx) if partial else None,
        free_mask=fm)
    winfo2 = None
    if to_x is not None:
        # keep the re-warmed POPULATION too: the whitened ChEES iterations
        # are real warmup, not just step-size adaptation
        _, warm_flat, winfo2 = _dense_rewarmup(
            logp_use, warm_flat, random.fold_in(k_warm, 99), num_warmup,
            target_accept, free_mask=fm)
    return logp_use, inv_mass_use, to_x, warm_flat, winfo, winfo2


def _probe_fused_mixed(one_trace, observations):
    """None when the EXTENDED (continuous + frozen discrete) universe's
    assess-logp stages; otherwise the refusal reason (e.g. a ``probs[z]``
    gather on a categorical site: such models take the alternating
    driver)."""
    from .mixed import extended_layout
    from .target import FlatTarget
    sel_ext, _ = extended_layout(one_trace, observations)
    return _probe_staging(FlatTarget(one_trace, sel_ext))[1]


def _summarize_each(samples):
    """Diagnostics per entry: the keys mix strings and tuples, and the
    discrete entries are summarized as float32."""
    from ..diagnostics import summarize
    return {k: summarize({"x": torch.as_tensor(v).to(torch.float32)})["x"]
            for k, v in samples.items()}


def _mixed_info(info, engine, requested_engine, sites):
    from .mixed import model_evals_per_sweep
    return dict(info, engine=engine, engine_requested=requested_engine,
                discrete_sites=[s.path for s in sites],
                discrete_evals_per_sweep=model_evals_per_sweep(sites))


def _sample_mixed_fused(observations, traces, one_trace, sites, k_run, *,
                        num_warmup, num_samples, max_depth, target_accept,
                        requested_engine, summarize):
    """Mixed models through the fused kernel (:func:`.mixed.
    mixed_fused_sample`). Samples include both blocks: the draws carry the
    frozen discrete coordinates of the chunk they were drawn in; a vector
    combinator's element leaves come back as one dense entry keyed by the
    int-stripped path, ``(draws, chains, n_elements, ...)``."""
    from .mixed import _is_int, mixed_fused_sample
    draws, sel_ext, _, info = mixed_fused_sample(
        k_run, traces, one_trace, sites, observations=observations,
        num_warmup=num_warmup, num_samples=num_samples, max_depth=max_depth,
        target_accept=target_accept)
    per_path, offset = {}, 0
    for path, v in one_trace.get_choices().filter(sel_ext).leaf_items():
        v = torch.as_tensor(v)
        size = v.numel()
        block = draws[:, :, offset:offset + size].to(v.dtype)
        per_path[path] = block.reshape(draws.shape[0], draws.shape[1],
                                       *v.shape)
        offset += size
    grouped, order = {}, []
    for path, arr in per_path.items():
        ints = [i for i, kk in enumerate(path) if _is_int(kk)]
        if len(ints) == 1:
            stripped = path[:ints[0]] + path[ints[0] + 1:]
            if stripped not in grouped:
                order.append(stripped)
                grouped[stripped] = {}
            grouped[stripped][path[ints[0]]] = arr
        else:
            order.append(path)
            grouped[path] = arr
    samples = {}
    for path in order:
        v = grouped[path]
        samples[path if len(path) > 1 else path[0]] = (
            torch.stack([v[i] for i in sorted(v)], dim=2)
            if isinstance(v, dict) else v)
    info = _mixed_info(info, "gibbs_nuts_fused", requested_engine, sites)
    summary = _summarize_each(samples) if summarize else None
    return PosteriorSamples(samples, summary, info, None)


def _sample_mixed(model, args, observations, traces, one_trace, k_run, *,
                  num_chains, num_warmup, num_samples, max_depth,
                  target_accept, adapt_mass, discrete_supports,
                  requested_engine, summarize):
    """One-call alternating Gibbs-within-NUTS over a mixed model (see
    :mod:`.mixed`). Supports are discovered from the model's own
    distribution calls; the result holds both the continuous and the
    discrete addresses (a vectorized discrete leaf comes back as one dense
    entry keyed by its int-stripped path, ``(draws, chains, n_elements,
    ...)``)."""
    from .mixed import discover_discrete_sites, mixed_warmup_and_sample
    cont_paths, _ = _split_paths(one_trace, observations)
    if not cont_paths:
        raise ValueError(
            "no unobserved continuous addresses: the model is purely "
            "discrete; enumerate it or run a Gibbs sweep directly")
    cont_sel = select(*cont_paths)
    sites = discover_discrete_sites(one_trace, observations, model, args,
                                    discrete_supports)
    if requested_engine not in ("auto", "mixed"):
        reason = f"engine={requested_engine!r} asks for the alternating driver"
    elif num_chains < 2:
        reason = ("num_chains < 2: the fused driver warms up with "
                  "cross-chain ChEES statistics")
    else:
        refusal = _probe_fused_mixed(one_trace, observations)
        if refusal is None:
            return _sample_mixed_fused(
                observations, traces, one_trace, sites, k_run,
                num_warmup=num_warmup, num_samples=num_samples,
                max_depth=max_depth, target_accept=target_accept,
                requested_engine=requested_engine, summarize=summarize)
        reason = ("the extended logp does not stage through ops.scalarize: "
                  f"{refusal}")

    layout = [(path, tuple(torch.as_tensor(v).shape)) for path, v in
              one_trace.get_choices().filter(cont_sel).leaf_items()]
    cont, discs, final_traces, info = mixed_warmup_and_sample(
        random.split(k_run, num_chains), traces, cont_sel, sites,
        num_warmup=num_warmup, num_samples=num_samples, max_depth=max_depth,
        target_accept=target_accept, adapt_mass=adapt_mass)
    flat = cont.transpose(0, 1)                 # -> (draws, chains, d)
    samples, offset = {}, 0
    for path, shape in layout:
        size = math.prod(shape)
        samples[path if len(path) > 1 else path[0]] = \
            flat[:, :, offset:offset + size].reshape(
                flat.shape[0], flat.shape[1], *shape)
        offset += size
    for site, d in zip(sites, discs):
        p = site.path
        samples[p if len(p) > 1 else p[0]] = d.transpose(0, 1)
    info = _mixed_info(info, "gibbs_nuts", requested_engine, sites)
    info["engine_reason"] = reason
    summary = _summarize_each(samples) if summarize else None
    return PosteriorSamples(samples, summary, info, final_traces)


def sample_posterior(key, model: GenerativeFunction, args: Tuple,
                     observations: ChoiceMap, *,
                     selection: Optional[Selection] = None,
                     num_chains: int = 8, num_warmup: int = 500,
                     num_samples: int = 1000, max_depth: int = 8,
                     target_accept: float = 0.8,
                     engine: str = "nuts",
                     adapt_mass: bool = True,
                     mass: str = "diag", mass_rank: int = 8,
                     num_ticks: Optional[int] = None,
                     mesh=None, mesh_axis: str = "chains",
                     discrete_supports: Optional[dict] = None,
                     summarize: bool = True) -> PosteriorSamples:
    """Sample ``p(selected latents | observations)`` with adaptive NUTS.

    Returns :class:`PosteriorSamples`; ``samples[path]`` has shape
    ``(num_samples, num_chains, *event_shape)``, what
    :func:`gen_tpu_torch.diagnostics.summarize` expects. Everything runs on
    the device of ``key``.

    ``engine="auto"`` dispatches to ``nuts_fused`` when there are >= 2
    chains and the model's assess-logp stages through
    :mod:`gen_tpu_torch.ops.scalarize` (probed), else to per-chain
    ``nuts``, with a warning and ``info["engine_reason"]``. The fused
    engines return completed-trajectory draws, possibly fewer than
    ``num_samples``; pin ``engine="nuts"`` for exactly ``num_samples``.

    ``mass="dense"``/``"lowrank"`` (fused engines only) whiten the target
    with a dense Cholesky (d <~ 30) or a diag + rank-``mass_rank`` metric
    estimated after the diagonal ChEES warmup; draws come back in model
    coordinates.

    ``engine="chees"``: cross-chain ChEES-HMC (>= 2 chains).
    ``engine="hmc_fused"``: ChEES warmup, then the fused HMC kernel,
    collecting every coordinate each step (chunked by device memory).
    ``engine="nuts_fused"``: ChEES warmup, then the pair-scheduled fused
    NUTS kernel for ``num_ticks`` leapfrog slots (default ``8 *
    num_samples``); draws are the completed-trajectory endpoints.
    ``engine="nuts_fsm"``: the FSM pipeline, per-chain warmup of
    ``num_ticks`` ticks then ``num_ticks`` ticks of sampling; the draw
    count is the smallest completed count across chains (capped at
    ``num_samples``).

    Partial selections (``chees``/``hmc_fused``/``nuts_fused``/
    ``nuts_fsm``) run over the full flat universe with the unselected
    coordinates frozen (inverse mass 0), so each chain conditions on its
    own generate-sampled values; only the selected addresses are returned.
    ``adapt_mass`` controls the cross-chain diagonal mass of the
    ``chees``/``hmc_fused`` engines. ``info["engine"]`` records the engine
    that ran.

    A model with unobserved discrete addresses (and no ``selection``)
    runs the mixed path under ``engine="nuts"``/``"auto"``/``"mixed"``:
    exact enumerative Gibbs over the discrete addresses alternating with
    NUTS over the continuous block (``gibbs_nuts``), or with K3 over the
    extended universe (``gibbs_nuts_fused``) where ``auto``/``mixed`` finds
    its extended logp stageable. ``discrete_supports`` (address -> values)
    overrides the discovered supports. ``mass``, ``num_ticks`` and ``mesh``
    do not apply there and raise ``ValueError`` when set. ``info`` then
    also holds ``discrete_sites`` and ``discrete_evals_per_sweep``.

    ``mesh`` raises ``NotImplementedError``: the parallel slice is not
    ported yet; ``mesh_axis`` is kept for gen_tpu's signature.
    """
    k_init, k_run = random.split(key)
    init_keys = random.split(k_init, num_chains)
    traces, _ = vmap(lambda k: model.generate(k, args, observations))(
        init_keys)
    one_trace = pytree.tree_map(lambda x: x[0], traces)

    if selection is None:
        cont_paths, disc_paths = _split_paths(one_trace, observations)
        if disc_paths:
            if engine not in ("nuts", "auto", "mixed"):
                raise ValueError(
                    f"model has unobserved discrete addresses "
                    f"{disc_paths!r}, which engine={engine!r} cannot "
                    "move; use engine='nuts'/'auto' (alternating "
                    "Gibbs-within-NUTS), pass an explicit selection= of "
                    "continuous latents, or marginalize them")
            for name, value, default in (("mass", mass, "diag"),
                                         ("num_ticks", num_ticks, None),
                                         ("mesh", mesh, None)):
                if (value is not None if default is None
                        else value != default):
                    raise ValueError(
                        f"{name}={value!r} does not apply to the mixed "
                        "discrete + continuous path (gibbs_nuts / "
                        "gibbs_nuts_fused), which adapts its own diagonal "
                        f"mass and budget; leave {name} at {default!r}")
            return _sample_mixed(
                model, args, observations, traces, one_trace, k_run,
                num_chains=num_chains, num_warmup=num_warmup,
                num_samples=num_samples, max_depth=max_depth,
                target_accept=target_accept, adapt_mass=adapt_mass,
                discrete_supports=discrete_supports,
                requested_engine=engine, summarize=summarize)
        selection, _ = _default_selection(one_trace, observations)
    if mesh is not None:
        raise NotImplementedError(
            "sample_posterior(mesh=...) shards the chains over devices; the "
            "parallel slice (ROADMAP queue 1 item 12, torch.distributed) is "
            "not ported yet")
    # flat layout (sorted-address to_array order) for unflattening
    values_chm = one_trace.get_choices().filter(selection)
    layout = [(path, tuple(torch.as_tensor(v).shape))
              for path, v in values_chm.leaf_items()]

    requested_engine = engine
    auto_reason = probed = None
    if engine == "auto":
        engine, probed, auto_reason = _auto_dispatch(
            one_trace, observations, selection, num_chains)
        if engine == "nuts":
            warnings.warn(
                "engine='auto' fell back to the per-chain 'nuts' engine: "
                f"{auto_reason}. The fused engine is orders of magnitude "
                "faster at large chain counts; see info['engine_reason'] "
                "for why it was not used.", stacklevel=2)
    if mass != "diag" and engine not in ("hmc_fused", "nuts_fused"):
        raise ValueError(
            f"mass={mass!r} is only supported by the fused engines "
            "(engine='hmc_fused'/'nuts_fused'); the XLA engines adapt "
            "their own diagonal mass")

    final_traces = None
    if engine == "nuts":
        flat, final_traces, info = nuts_warmup_and_sample(
            random.split(k_run, num_chains), traces, selection,
            num_warmup=num_warmup, num_samples=num_samples,
            max_depth=max_depth, target_accept=target_accept)
    elif engine == "chees":
        from .chees import chees_hmc_warmup_and_sample
        full_sel, free_mask, sel_idx, partial = _free_mask_layout(
            one_trace, observations, selection)
        if num_chains < 2:
            raise ValueError("engine='chees' adapts from cross-chain "
                             "statistics and needs num_chains >= 2")
        samples_sm, _, info = chees_hmc_warmup_and_sample(
            k_run, traces, full_sel, num_warmup=num_warmup,
            num_samples=num_samples, target_accept=target_accept,
            adapt_mass=adapt_mass,
            free_mask=free_mask if partial else None)
        if partial:
            samples_sm = samples_sm[:, :, sel_idx]
        flat = samples_sm.transpose(0, 1)      # -> (chains, draws, dim)
    elif engine in ("hmc_fused", "nuts_fused"):
        full_sel, free_mask, sel_idx, partial = _free_mask_layout(
            one_trace, observations, selection)
        if num_chains < 2:
            raise ValueError(f"engine={engine!r} warms up with ChEES and "
                             "needs num_chains >= 2")
        k_warm, k_fused = random.split(k_run)
        logp_use, inv_mass_use, to_x, warm_flat, winfo, winfo2 = \
            _fused_warmup(traces, one_trace, full_sel, k_warm, num_warmup,
                          target_accept, adapt_mass,
                          (free_mask, sel_idx, partial), mass, mass_rank,
                          target=probed)
        w = winfo if winfo2 is None else winfo2
        eps_adapted = float(w["step_size"])
        if engine == "hmc_fused":
            from ..ops.hmc_fused import hmc_chains_fused_chunked
            n_leap = max(1, int(w["num_leapfrogs"]))
            _, collected, accs = hmc_chains_fused_chunked(
                k_fused, logp_use, warm_flat, n_steps=num_samples,
                L=n_leap, eps=eps_adapted, collect_idx=None,
                inv_mass_diag=inv_mass_use)
            info = dict(step_size=eps_adapted, num_leapfrogs=n_leap,
                        inv_mass=winfo["inv_mass"],
                        mean_accept=torch.mean(accs) / num_samples)
        else:
            from ..ops.nuts_fused import (extract_completed_draws,
                                          nuts_chains_fused_chunked)
            ticks = num_ticks or 8 * num_samples
            # paired=True: the pair-scheduled kernel K3, as gen_tpu's engine
            _, hist, hcnt, cnt, fstats = nuts_chains_fused_chunked(
                k_fused, logp_use, warm_flat, num_ticks=ticks,
                eps=eps_adapted, max_depth=max_depth,
                inv_mass_diag=inv_mass_use, collect_idx=None, paired=True)
            m = int(cnt.min())
            if m < 2:
                raise ValueError(
                    f"nuts_fused completed only {m} trajectories on the "
                    f"slowest chain in {ticks} ticks; raise num_ticks")
            collected = extract_completed_draws(hist, hcnt, m)
            del hist, hcnt
            info = dict(step_size=eps_adapted, inv_mass=winfo["inv_mass"],
                        mean_depth=fstats["mean_depth"],
                        num_divergent=fstats["num_divergent"])
        if to_x is not None:
            collected = to_x(collected)         # (draws, n, d), d last
        if partial:
            collected = collected[:, :, sel_idx]
        flat = collected.transpose(0, 1)[:, :num_samples]
    elif engine == "nuts_fsm":
        from .nuts_fsm import nuts_fsm_warmup_and_sample
        from .target import FlatTarget
        full_sel, free_mask, sel_idx, partial = _free_mask_layout(
            one_trace, observations, selection)
        target = FlatTarget(one_trace, full_sel)
        ticks = num_ticks or 8 * num_samples
        theta0 = vmap(lambda tr: tr.get_choices().filter(full_sel)
                      .to_array())(traces)
        res, info = nuts_fsm_warmup_and_sample(
            random.split(k_run, num_chains), target.value_and_grad, theta0,
            num_warmup_ticks=ticks, num_ticks=ticks, max_depth=max_depth,
            target_accept=target_accept, num_sample_slots=num_samples,
            free_mask=free_mask if partial else None)
        m = min(int(res.counts.min()), num_samples)
        if m < 2:
            raise ValueError(
                f"FSM engine completed only {m} trajectories on the "
                f"slowest chain in {ticks} ticks; raise num_ticks")
        flat = res.slots[:, :m, :]              # (chains, m, dim)
        if partial:
            flat = flat[:, :, sel_idx]
        info = dict(info, counts=res.counts)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    # which engine actually ran, and (for auto) why
    info = dict(info, engine=engine, engine_requested=requested_engine)
    if auto_reason is not None:
        info["engine_reason"] = auto_reason
    flat = flat.transpose(0, 1)                 # -> (draws, chains, dim)

    samples = {}
    offset = 0
    for path, shape in layout:
        size = math.prod(shape)
        block = flat[:, :, offset:offset + size]
        samples[path if len(path) > 1 else path[0]] = \
            block.reshape(flat.shape[0], flat.shape[1], *shape)
        offset += size

    summary = None
    if summarize:
        from ..diagnostics import summarize as _summarize
        summary = _summarize(samples)
    return PosteriorSamples(samples, summary, info, final_traces)
