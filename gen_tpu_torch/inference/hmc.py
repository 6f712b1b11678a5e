"""Many-chain Hamiltonian Monte Carlo in flat coordinates.

Counterpart: ``gen_tpu/inference/hmc.py``; only ``hmc_chains`` is ported
(``hmc`` and ``hmc_chain``, the trace-level kernels, wait for
``inference/common.py``). The step is gen_tpu's, draw for draw: the same
key splits, the same jittered step size, momenta, L leapfrogs,
NaN-to-minus-infinity energy error, MH accept and optional warmup
teleport, so under the same key it matches gen_tpu step for step. Where
gen_tpu scans, this is a Python loop over steps and leapfrogs; the
per-chain value and gradient is ``torch.func.vmap`` of
``FlatTarget.value_and_grad``.
"""

from __future__ import annotations

import math

import torch
from torch.func import vmap

from .. import random
from ..utils import sqrt_mass_safe


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
