"""One-call inference on mixed discrete + continuous models.

Counterpart: ``gen_tpu/inference/mixed.py``. NUTS over the continuous block
(conditioned on each chain's current discrete values) alternates with
exact enumerative Gibbs over every finite-support discrete address: the
``update`` weights over a site's candidate values are its full
conditional up to normalization. Pieces, as in gen_tpu:

- **Support discovery**: one replay of the model under
  :class:`gen_tpu_torch.dynamic.handlers.record_dist_calls` records which
  distribution drew each address; finite discrete distributions expose
  ``enumerate_support``. Unbounded ones (poisson, geometric) need an
  explicit ``discrete_supports`` override.
- **Vector sites** (a dense leaf of a Map/Unfold) are moved one element at
  a time, each element's candidates scored by one vmapped ``update``.
- **The alternating driver** (:func:`mixed_warmup_and_sample`):
  dual-averaging NUTS warmup with a Gibbs sweep after every transition,
  then sampling with the same alternation.
- **The fused driver** (:func:`mixed_fused_sample`): ChEES warmup, then the
  pair-scheduled NUTS kernel K3 over the *extended* flat universe, where
  the discrete values ride along as frozen coordinates (inverse mass 0),
  with a Gibbs refresh of the discrete block between kernel chunks.

Where PyTorch forced differences:

- gen_tpu replays the model abstractly (``jax.eval_shape``) to record the
  distribution calls; the port runs one real ``generate`` on a key on the
  model's device (:func:`record_model_dists`).
- gen_tpu vmaps one chain's driver; here the chains are a batch dimension
  (``traces`` with a leading chain axis, one key per chain). Each chain's
  continuous logp conditions on its own discrete values, passed to NUTS as
  per-chain ``vag_args``; the Gibbs sweep runs under ``torch.func.vmap``
  over chains. A sweep's vmap over candidates is an ``update`` with an
  unbatched trace and batched constraints, nested inside that.
- ``lax.scan`` over a vector site's elements is a Python loop, and
  ``v.at[i].set(c)`` a ``torch.where`` on the element index.

Faults of gen_tpu not copied (ROADMAP queue 3): a vector leaf that is
observed at some elements and latent at others raises ``ValueError``
(gen_tpu looks at element 0 only and overwrites observed elements);
:func:`mixed_fused_sample` requires ``observations`` (gen_tpu dies with an
``AttributeError`` without them); and it counts each chain's completed
trajectories over the whole sampling phase, where gen_tpu keeps a chunk's
draws only if every chain completed one in that chunk, which at 16,384
chains almost no chunk does (a chunk restarts the trajectories in
flight, so a chain whose trajectory outgrows the chunk completes
nothing there), and the run raises.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch.func import grad_and_value, vmap

from .. import random
from ..address import addr_path
from ..choice_map import ChoiceMap
from ..combinators.vector import VectorChoiceMap
from ..dynamic.handlers import record_dist_calls
from ..selection import Selection, select
from .nuts import (_split, da_init, da_update, find_reasonable_step_size,
                   nuts_flat)


class DiscreteSite(NamedTuple):
    """One enumerable discrete block: a scalar address or one dense
    vectorized leaf of a vector combinator (Map/Unfold)."""
    kind: str              # "scalar" | "vector"
    pre: Tuple             # scalar: full path; vector: vector-combinator path
    post: Tuple            # vector: leaf path inside one element; scalar: ()
    support: Any           # (G,) candidate values (stored dtype)
    length: int            # number of elements (1 for scalar)

    @property
    def path(self) -> Tuple:
        return self.pre + self.post

    @property
    def n_candidates(self) -> int:
        return int(self.support.shape[0])


def _is_int(k) -> bool:
    return isinstance(k, int) and not isinstance(k, bool)


def _strip_ints(path: Tuple) -> Tuple:
    return tuple(k for k in path if not _is_int(k))


def _is_discrete_value(v) -> bool:
    v = torch.as_tensor(v)
    return not (torch.is_floating_point(v) or torch.is_complex(v))


def _device_of(trace) -> torch.device:
    return torch.as_tensor(trace.get_score()).device


def record_model_dists(model, args, observations: ChoiceMap, device=None):
    """Run one ``generate`` of the model (on a key on ``device``),
    recording (path, dist, args) for every distribution call. Paths omit
    combinator-inserted integer keys."""
    with record_dist_calls() as rec:
        model.generate(random.PRNGKey(0, device), args, observations)
    return rec.records


def _match_record(records, stripped: Tuple):
    """The recorded dist for an int-stripped trace path: an exact match on
    the int-stripped recorded path, else a unique suffix match."""
    exact = [(d, a) for p, d, a in records if _strip_ints(p) == stripped]
    if exact:
        if len({id(d) for d, _ in exact}) > 1:
            raise ValueError(
                f"address {stripped!r} was produced by more than one "
                "distribution across the execution; pass explicit "
                "discrete_supports= for it")
        return exact[0]
    suffix = [(d, a) for p, d, a in records
              if stripped[-len(_strip_ints(p)):] == _strip_ints(p)
              and len(_strip_ints(p)) > 0]
    if len({id(d) for d, _ in suffix}) == 1:
        return suffix[0]
    raise ValueError(
        f"could not identify the distribution behind discrete address "
        f"{stripped!r} (records: {[p for p, _, _ in records]!r}); pass "
        "explicit discrete_supports= for it")


def _submaps_deep(chm):
    for k, sub in chm.get_submaps_shallow().items():
        yield k, sub
        if not isinstance(sub, VectorChoiceMap):
            yield from _submaps_deep(sub)


def discover_discrete_sites(one_trace, observations: ChoiceMap, model,
                            args, discrete_supports: Optional[Dict] = None
                            ) -> Tuple[DiscreteSite, ...]:
    """All unobserved discrete addresses of ``one_trace`` as
    :class:`DiscreteSite` blocks with enumerated supports.
    ``discrete_supports`` (address -> (G,) values) overrides or adds to
    the automatic discovery; traced-bound and unbounded distributions need
    it. A vector leaf observed at some elements and not at others raises
    ``ValueError``."""
    overrides = {addr_path(k): torch.as_tensor(v)
                 for k, v in (discrete_supports or {}).items()}
    records = None
    choices = one_trace.get_choices()
    sites = []

    def support_for(path: Tuple, proto):
        nonlocal records
        proto = torch.as_tensor(proto)
        stripped = _strip_ints(path)
        for key in (path, stripped):
            if key in overrides:
                return overrides[key].to(dtype=proto.dtype,
                                         device=proto.device)
        if records is None:
            records = record_model_dists(model, args, observations,
                                         _device_of(one_trace))
        dist, dargs = _match_record(records, stripped)
        return torch.as_tensor(dist.enumerate_support(*dargs)).to(
            dtype=proto.dtype, device=proto.device)

    def walk(chm, prefix):
        for k, v in chm.get_values_shallow().items():
            path = prefix + (k,)
            if observations.has_value(path) or not _is_discrete_value(v):
                continue
            sites.append(DiscreteSite("scalar", path, (),
                                      support_for(path, v), 1))
        for k, sub in chm.get_submaps_shallow().items():
            path = prefix + (k,)
            if not isinstance(sub, VectorChoiceMap):
                walk(sub, path)
                continue
            if any(isinstance(s, VectorChoiceMap)
                   for _, s in _submaps_deep(sub.inner)):
                raise NotImplementedError(
                    f"nested vector combinators under {path!r}: "
                    "automatic discrete moves support one vector level; "
                    "hand-compose the moves instead")
            for post, v in sub.inner.leaf_items():
                if not _is_discrete_value(v):
                    continue
                observed = [observations.has_value(path + (i,) + post)
                            for i in range(sub.length)]
                if all(observed):
                    continue
                if any(observed):
                    raise ValueError(
                        f"vector leaf {path + post!r} is observed at "
                        f"elements {[i for i, o in enumerate(observed) if o]}"
                        " and latent at the others; a Gibbs move would "
                        "overwrite the observed elements. Observe all of its "
                        "elements or none")
                sites.append(DiscreteSite(
                    "vector", path, post, support_for(path + post, v),
                    sub.length))

    walk(choices, ())
    return tuple(sites)


def _dense_value(trace, site: DiscreteSite):
    chm = trace.get_choices()
    if site.kind == "scalar":
        return chm.get_value(site.pre)
    sub = chm.get_submap(site.pre)
    if isinstance(sub, VectorChoiceMap):
        return sub.inner.get_value(site.post)
    return torch.stack([sub.get_value((i,) + site.post)
                        for i in range(site.length)])


def _build_cons(site: DiscreteSite, newv) -> ChoiceMap:
    cons = ChoiceMap()
    if site.kind == "scalar":
        cons.set_value(site.pre, newv)
        return cons
    inner = ChoiceMap()
    inner.set_value(site.post, newv)
    cons.set_submap(site.pre, VectorChoiceMap(inner, site.length))
    return cons


def _pick(tree, j):
    """Candidate ``j`` of a pytree batched over candidates (``j`` may be
    batched over chains)."""
    return pytree.tree_map(
        lambda x: torch.index_select(x, 0, j.reshape(1))[0], tree)


def gibbs_sweep(key, trace, sites: Tuple[DiscreteSite, ...]):
    """One systematic exact-Gibbs sweep of one chain over every site: each
    scalar site, and each element of each vector site in turn, is
    resampled from its exact full conditional (the ``update`` weights over
    its support). Runs under ``torch.func.vmap`` over chains."""
    for si, site in enumerate(sites):
        k_site = random.fold_in(key, si)
        if site.kind == "scalar":
            def score(c, site=site, trace=trace):
                new_tr, w, _, _ = trace.update(None, _build_cons(site, c))
                return new_tr, w
            trs, ws = vmap(score)(site.support)
            trace = _pick(trs, random.categorical(k_site, ws))
            continue
        v = _dense_value(trace, site)
        ks = random.split(k_site, site.length)
        elem = torch.arange(site.length, device=site.support.device)
        elem = elem.reshape((site.length,) + (1,) * (v.dim() - 1))
        for i in range(site.length):
            def score(c, site=site, trace=trace, v=v, i=i):
                newv = torch.where(elem == i, c, v)
                new_tr, w, _, _ = trace.update(None, _build_cons(site, newv))
                return new_tr, w, newv
            trs, ws, newvs = vmap(score)(site.support)
            j = random.categorical(ks[i], ws)
            trace, v = _pick(trs, j), _pick(newvs, j)
    return trace


def model_evals_per_sweep(sites: Tuple[DiscreteSite, ...]) -> int:
    """Full-model ``update`` evaluations one Gibbs sweep costs."""
    return sum(s.length * s.n_candidates for s in sites)


def mixed_warmup_and_sample(key, traces, cont_sel: Selection,
                            sites: Tuple[DiscreteSite, ...],
                            num_warmup=500, num_samples=1000, max_depth=8,
                            target_accept=0.8, adapt_mass=True):
    """The alternating (NUTS then Gibbs) pipeline on a batch of chains:
    ``traces`` with a leading chain axis and ``key`` ``(n, 2)``, each chain
    on its own (gen_tpu vmaps its single-chain version). Dual-averaging
    warmup with the discrete sweep interleaved, then sampling. Returns
    ``(cont_samples (n, S, d), disc_samples (one (n, S, ...) per site),
    final_traces, info)`` with one info entry per chain."""
    one = pytree.tree_map(lambda x: x[0], traces)
    gen_fn, args = one.get_gen_fn(), one.get_args()
    values_chm = one.get_choices().filter(cont_sel)
    others = cont_sel.complement()

    def logp(flat, rest):
        """The continuous block's logp given one chain's other choices
        (its discrete values and the observations)."""
        w, _ = gen_fn.assess(args, rest.merge(values_chm.from_array(flat)))
        return w

    gv = grad_and_value(logp)

    def vag(flat, rest):
        g, v = gv(flat, rest)
        return v, g

    def split_choices(traces):
        """(continuous block (n, d), the other choices) of each chain."""
        return vmap(lambda tr: (tr.get_choices().filter(cont_sel).to_array(),
                                tr.get_choices().filter(others)))(traces)

    def rebuild(tr, theta):
        return tr.update(None, values_chm.from_array(theta))[0]

    def step(step_keys, traces, eps, inv_mass):
        kk = _split(step_keys, 2)
        theta, rests = split_choices(traces)
        theta, stats = nuts_flat(kk[:, 0], vag, theta, eps, max_depth,
                                 inv_mass, vag_args=(rests,))
        traces = vmap(lambda k, tr, th: gibbs_sweep(k, rebuild(tr, th),
                                                    sites))(
            kk[:, 1], traces, theta)
        return traces, theta, stats

    theta, rests = split_choices(traces)
    n, dim = theta.shape
    dt, dev = theta.dtype, theta.device
    ks = _split(key.to(dev), 3)
    k_find, k_warm, k_samp = ks[:, 0], ks[:, 1], ks[:, 2]
    eps0 = find_reasonable_step_size(k_find, vag, theta, vag_args=(rests,))

    da = da_init(eps0)
    mean = torch.zeros((n, dim), dtype=dt, device=dev)
    m2 = torch.zeros((n, dim), dtype=dt, device=dev)
    count = torch.zeros((n,), dtype=dt, device=dev)
    warm_keys = _split(k_warm, num_warmup)
    for m in range(num_warmup):
        traces, theta, stats = step(warm_keys[:, m], traces,
                                    torch.exp(da.log_eps), None)
        da = da_update(da, stats.accept_prob, target_accept)
        active = (da.t > (num_warmup // 2)).expand(n)[:, None]
        count = count + torch.where(active[:, 0], 1.0, 0.0)
        delta = theta - mean
        mean2 = mean + torch.where(
            active, delta / torch.clamp(count, min=1.0)[:, None], 0.0)
        m2 = m2 + torch.where(active, delta * (theta - mean2), 0.0)
        mean = mean2
    eps_final = torch.exp(da.log_eps_bar)
    var = m2 / torch.clamp(count - 1.0, min=1.0)[:, None]
    inv_mass = torch.where(torch.as_tensor(adapt_mass) & (count > 2)[:, None],
                           torch.clamp(var, min=1e-6),
                           torch.ones((n, dim), dtype=dt, device=dev))
    conts, discs, accepts, leapfrogs = [], [], [], []
    samp_keys = _split(k_samp, num_samples)
    for s in range(num_samples):
        traces, theta, stats = step(samp_keys[:, s], traces, eps_final,
                                    inv_mass)
        conts.append(theta)
        discs.append(tuple(vmap(lambda tr: _dense_value(tr, site))(traces)
                           for site in sites))
        accepts.append(stats.accept_prob)
        leapfrogs.append(stats.num_leapfrogs)
    info = dict(step_size=eps_final, inv_mass_diag=inv_mass,
                mean_accept=torch.stack(accepts).mean(dim=0),
                total_leapfrogs=torch.stack(leapfrogs).sum(dim=0))
    disc_samples = tuple(torch.stack([d[i] for d in discs], dim=1)
                         for i in range(len(sites)))
    return torch.stack(conts, dim=1), disc_samples, traces, info


# -- the fused driver: K3 over the extended universe, Gibbs between chunks --

def extended_layout(one_trace, observations: ChoiceMap):
    """(selection over ALL unobserved addresses, free_mask (d,) float32
    with 0 on the discrete coordinates) of the extended flat universe."""
    obs_addrs = set(observations.addresses())
    paths = [p for p, _ in one_trace.get_choices().leaf_items()
             if p not in obs_addrs]
    if not paths:
        raise ValueError("no unobserved addresses")
    sel = select(*paths)
    mask_parts = []
    for _, v in one_trace.get_choices().filter(sel).leaf_items():
        v = torch.as_tensor(v)
        size = max(1, math.prod(v.shape))
        mask_parts.append(torch.full(
            (size,), 0.0 if _is_discrete_value(v) else 1.0,
            dtype=torch.float32, device=v.device))
    return sel, torch.cat(mask_parts)


def stitch_chunks(chunks):
    """``[(hist (steps, n, d), hist_counts (steps, n), counts (n,)), ...]``
    of consecutive K3 calls, each with its own completed-trajectory counts,
    -> ``(draws (m, n, d), totals (n,))``: each chain's first ``m`` completed
    draws of the concatenated chunks, ``m`` the smallest total. A chain may
    complete no draw in some chunk (gen_tpu keeps a chunk's draws only if
    every chain completed one in it; at 16,384 GMM chains no chunk did)."""
    from ..ops.nuts_fused import extract_completed_draws
    hists, hcnts = [], []
    total = torch.zeros_like(chunks[0][2])
    for hist, hcnt, cnt in chunks:
        hists.append(hist)
        hcnts.append(hcnt + total[None, :])
        total = total + cnt
    m = int(torch.min(total))
    return (extract_completed_draws(torch.cat(hists), torch.cat(hcnts), m),
            total)


def mixed_fused_sample(key, traces, one_trace, sites, *, observations,
                       num_warmup=400, num_samples=1000, max_depth=8,
                       target_accept=0.8, num_outer=None,
                       warmup_gibbs_segments=3, chunk_ticks=16):
    """Alternating (fused pair-NUTS, then exact Gibbs) over the extended
    flat universe. Returns ``(draws (m, chains, d_ext), layout_sel,
    free_mask, info)``: each chain's first m completed-trajectory draws of
    the sampling phase (m = the fewest any chain completed), which include
    the frozen discrete coordinates, each chunk's rows carrying that
    chunk's per-chain discrete values. ``observations`` is required (it
    fixes the extended layout)."""
    from ..ops.nuts_fused import nuts_chains_fused_chunked
    from .chees import chees_hmc_warmup_and_sample
    from .target import FlatTarget

    if not isinstance(observations, ChoiceMap):
        raise ValueError(
            "mixed_fused_sample needs observations= (the ChoiceMap the "
            "traces were generated with): the extended flat universe is "
            "every address they leave unobserved")
    sel_ext, free_mask = extended_layout(one_trace, observations)
    target = FlatTarget(one_trace, sel_ext)
    n_chains = pytree.tree_leaves(traces)[0].shape[0]

    def gibbs_refresh(k, flat):
        def one(kk, f):
            tr = gibbs_sweep(kk, target.rebuild(f), sites)
            return tr.get_choices().filter(sel_ext).to_array()
        return vmap(one)(random.split(k, n_chains), flat).to(flat.dtype)

    # warmup: ChEES segments (discretes frozen per chain) interleaved with
    # Gibbs refreshes, so the adaptation sees discrete mixing
    k_w, k_s = random.split(key)
    cur = traces
    seg = max(50, num_warmup // warmup_gibbs_segments)
    winfo = None
    for i in range(warmup_gibbs_segments):
        kk = random.split(k_w, 3)
        k_w, k_c, k_g = kk[0], kk[1], kk[2]
        _, warm_flat, winfo = chees_hmc_warmup_and_sample(
            k_c, cur, sel_ext, num_warmup=seg, num_samples=1,
            target_accept=target_accept, free_mask=free_mask)
        warm_flat = gibbs_refresh(k_g, warm_flat)
        if i < warmup_gibbs_segments - 1:
            cur = vmap(target.rebuild)(warm_flat)
    eps = float(winfo["step_size"])

    # sampling: K3 chunks of ~chunk_ticks pairs with a Gibbs refresh after
    # each (the joint chain mixes at the rate of the slower alternation),
    # after a burn phase of half the budget
    ticks_total = 8 * num_samples
    if num_outer is None:
        num_outer = max(4, ticks_total // chunk_ticks)
    chunk = max(8, ticks_total // num_outer)
    flat = warm_flat
    n_burn_outer = max(2, (ticks_total // 2) // chunk)

    def run_chunk(collect_idx):
        nonlocal k_s, flat
        kk = random.split(k_s, 3)
        k_s, k_n, k_g = kk[0], kk[1], kk[2]
        out = nuts_chains_fused_chunked(
            k_n, target.logp, flat, num_ticks=chunk, eps=eps,
            max_depth=max_depth, inv_mass_diag=winfo["inv_mass"],
            collect_idx=collect_idx, paired=True)
        flat = gibbs_refresh(k_g, out[0])
        return out

    for _ in range(n_burn_outer):
        run_chunk(0)
    chunks = [run_chunk(None) for _ in range(num_outer)]
    stats = chunks[-1][4]
    draws, total = stitch_chunks([c[1:4] for c in chunks])
    del chunks
    m = int(torch.min(total))
    if m < 2:
        raise ValueError(
            "fused mixed driver completed too few trajectories; raise "
            "num_samples (the tick budget is 8*num_samples)")
    info = dict(step_size=eps, inv_mass=winfo["inv_mass"],
                mean_depth=stats["mean_depth"],
                num_divergent=stats["num_divergent"])
    return draws, sel_ext, free_mask, info
