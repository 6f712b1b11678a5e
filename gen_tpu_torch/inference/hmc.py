"""Hamiltonian Monte Carlo.

Counterpart: ``gen_tpu/inference/hmc.py``, all of it: ``hmc`` (one update
of a trace's selected choices), ``hmc_chain`` (a whole chain on the flat
vector, its step keys folded from the chain key by the step index) and
``hmc_chains`` (many chains in flat coordinates). Each is gen_tpu's draw
for draw: the same key splits, momenta, L leapfrogs, NaN-to-minus-infinity
energy error and MH accept (``hmc_chains`` also the jittered step size and
the optional warmup teleport), so under the same key it matches gen_tpu
step for step. Where gen_tpu scans, this is a Python loop over steps and
leapfrogs; ``hmc_chains`` evaluates ``FlatTarget.value_and_grad`` under
``torch.func.vmap``. ``hmc`` runs under ``torch.func.vmap`` over traces.
"""

from __future__ import annotations

import math

import torch
from torch.func import vmap

from .. import random
from ..gfi import Trace
from ..selection import Selection
from ..utils import sqrt_mass_safe
from .common import mh_accept, select_trace
from .target import FlatTarget

_HALF_LOG_2PI = 0.9189385332046727


def _momenta_score(m):
    return torch.sum(-0.5 * m * m - _HALF_LOG_2PI)


def hmc(key, trace: Trace, selection: Selection, L: int = 10,
        eps: float = 0.1, inv_mass_diag=None):
    """One HMC update on the selected addresses, optionally with a
    diagonal inverse mass. Returns (new_trace, accepted)."""
    target = FlatTarget(trace, selection)
    values0 = target.flat0
    logp0, grad0 = target.value_and_grad(values0)
    inv_mass = (torch.ones_like(values0) if inv_mass_diag is None
                else torch.as_tensor(inv_mass_diag, device=values0.device))
    sqrt_mass = sqrt_mass_safe(inv_mass)

    def kinetic(m):
        return 0.5 * torch.sum(m * (inv_mass * m))

    k_mom, k_acc = random.split(key)
    momenta0 = sqrt_mass * random.normal(k_mom, tuple(values0.shape),
                                         values0.dtype)
    values, momenta, grad = values0, momenta0, grad0
    for _ in range(L):
        momenta = momenta + (eps / 2) * grad
        values = values + eps * (inv_mass * momenta)
        logp, grad = target.value_and_grad(values)
        momenta = momenta + (eps / 2) * grad
    alpha = logp - logp0 - kinetic(momenta) + kinetic(momenta0)
    alpha = torch.where(torch.isnan(alpha), -math.inf, alpha)
    accept = mh_accept(k_acc, alpha)
    new_trace = target.rebuild(values)
    return select_trace(accept, new_trace, trace), accept


def hmc_chains(key, target, values0, n_steps: int, L: int = 10,
               eps: float = 0.1, inv_mass_diag=None, collect=None,
               eps_jitter: float = 0.2, teleport_after: int = 0):
    """``n_steps`` full HMC updates of the ``(chains, d)`` state
    ``values0``: per step one shared jittered step size
    ``eps * U(1 - eps_jitter, 1 + eps_jitter)`` (breaks the trajectory
    resonance of fixed L on near-Gaussian targets), momenta scaled by
    ``sqrt_mass_safe(inv_mass)`` (inverse mass 0 freezes a coordinate), L
    leapfrogs and an MH accept.

    ``teleport_after`` (warmup only: it breaks reversibility): after that
    many consecutive rejections a chain jumps to a uniformly random other
    chain's position, which rescues chains initialized where ``eps``
    exceeds the leapfrog stability limit.

    ``collect(values)`` maps the per-step state to what is recorded
    (default: the raw values). Returns ``(values, collected, accepts)``
    with collected stacked step-major and ``accepts`` of shape
    ``(n_steps, chains)``."""
    if collect is None:
        collect = lambda v: v
    vg = vmap(target.value_and_grad)
    dtype, device = values0.dtype, values0.device
    n, d = values0.shape
    inv_mass = (torch.ones(d, dtype=dtype, device=device)
                if inv_mass_diag is None
                else torch.as_tensor(inv_mass_diag, dtype=dtype,
                                     device=device))
    sqrt_mass = sqrt_mass_safe(inv_mass)

    def kin(m):
        return 0.5 * torch.sum(m * (inv_mass * m), dim=-1)

    values = values0
    logp, grad = vg(values)
    streak = torch.zeros(n, dtype=torch.int32, device=device)
    collected, accepts = [], []
    for step_key in random.split(key.to(device), n_steps):
        k_mom, k_acc, k_jit, k_tel = random.split(step_key, 4)
        eps_m = eps * random.uniform(k_jit, (), dtype, 1.0 - eps_jitter,
                                     1.0 + eps_jitter)
        momenta0 = sqrt_mass * random.normal(k_mom, (n, d), dtype)
        v, m, g, lp = values, momenta0, grad, logp
        for _ in range(L):
            m = m + (eps_m / 2) * g
            v = v + eps_m * (inv_mass * m)
            lp, g = vg(v)
            m = m + (eps_m / 2) * g
        alpha = lp - logp - kin(m) + kin(momenta0)
        alpha = torch.where(torch.isnan(alpha), -math.inf, alpha)
        acc = torch.log(random.uniform(k_acc, (n,))) < alpha
        values = torch.where(acc[:, None], v, values)
        logp = torch.where(acc, lp, logp)
        grad = torch.where(acc[:, None], g, grad)
        if teleport_after:
            streak = torch.where(acc, 0, streak + 1)
            stuck = streak >= teleport_after
            idx = random.randint(k_tel, (n,), 0, n)
            values = torch.where(stuck[:, None], values[idx], values)
            logp = torch.where(stuck, logp[idx], logp)
            grad = torch.where(stuck[:, None], grad[idx], grad)
            streak = torch.where(stuck, 0, streak)
        collected.append(collect(values))
        accepts.append(acc)
    return values, torch.stack(collected), torch.stack(accepts)


def hmc_chain(key, trace: Trace, selection: Selection, n_steps: int,
              L: int = 10, eps: float = 0.1):
    """A whole HMC chain on the flat selected-choice vector (unit mass),
    carrying only (values, logp, grad) from step to step; step i's keys
    are split from ``fold_in(key, i)``. Returns (final_trace, samples
    (n_steps, d), accepts (n_steps,))."""
    target = FlatTarget(trace, selection)
    values = target.flat0
    logp, grad = target.value_and_grad(values)
    samples, accepts = [], []
    for i in range(n_steps):
        k_mom, k_acc = random.split(random.fold_in(key, i))
        momenta0 = random.normal(k_mom, tuple(values.shape), values.dtype)
        v, m, g = values, momenta0, grad
        for _ in range(L):
            m = m + (eps / 2) * g
            v = v + eps * m
            lp, g = target.value_and_grad(v)
            m = m + (eps / 2) * g
        alpha = (lp - logp + _momenta_score(-m)
                 - _momenta_score(momenta0))
        alpha = torch.where(torch.isnan(alpha), -math.inf, alpha)
        accept = mh_accept(k_acc, alpha)
        values = torch.where(accept, v, values)
        logp = torch.where(accept, lp, logp)
        grad = torch.where(accept, g, grad)
        samples.append(values)
        accepts.append(accept)
    return (target.rebuild(values), torch.stack(samples),
            torch.stack(accepts))
