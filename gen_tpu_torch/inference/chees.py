"""ChEES-HMC: cross-chain adaptive Hamiltonian Monte Carlo.

Counterpart: ``gen_tpu/inference/chees.py`` (Hoffman, Radul & Sountsov
2021). All chains run the same jittered number of leapfrogs per iteration;
dual averaging adapts the step size toward the target acceptance, Adam on
log T ascends the ChEES criterion, and a diagonal inverse mass follows an
EWMA of the per-iteration cross-chain variance, eased in geometrically
from identity. Warmup-only teleport rescues chains that reject ten times
in a row; ``free_mask`` freezes coordinates (and disables teleport).

Where PyTorch forced differences:

- gen_tpu scans the iterations inside one jitted program, with the
  leapfrog count as a traced ``fori_loop`` bound. Here each iteration is a
  Python loop body, and the leapfrog count, one integer shared by all
  chains, is brought to the host once per iteration (``.item()``).
- The chains' value and gradient is ``torch.func.vmap`` of the per-chain
  ``vag``. The logp at the end of the trajectory is the one the last
  leapfrog computed (gen_tpu evaluates it again; the value is the same).
- The adaptation state (dual averaging, Adam, the Halton jitter) is held in
  the default float dtype, as gen_tpu holds it in JAX's default float; the
  chains in the dtype of ``xs0``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from .. import random
from ..selection import Selection
from ..utils import sqrt_mass_safe
from .nuts import da_init, da_update
from .target import FlatTarget


def _halton(i: int, base: int = 2) -> float:
    """Halton sequence value of index ``i`` (10 digits, exact)."""
    f, r, x = 1.0, 0.0, i + 1
    for _ in range(10):
        f = f / base
        r = r + f * (x % base)
        x = x // base
    return r


class CheesState(NamedTuple):
    log_t: torch.Tensor        # log total trajectory length
    adam_m: torch.Tensor
    adam_v: torch.Tensor
    step: torch.Tensor


def chees_hmc_warmup_and_sample(key, traces, selection: Selection,
                                num_warmup: int = 300,
                                num_samples: int = 500,
                                target_accept: float = 0.75,
                                init_step_size: float = 0.1,
                                init_traj_length: float = 1.0,
                                adam_lr: float = 0.025,
                                adapt_mass: bool = True,
                                mass_ema_decay: Optional[float] = None,
                                free_mask=None):
    """ChEES-adapted HMC on a BATCH of traces (leading chain axis, e.g. from
    a vmapped ``generate``). Returns ``(samples (num_samples, chains, d),
    final_flat (chains, d), info)`` with ``info`` holding ``step_size``,
    ``trajectory_length``, ``num_leapfrogs``, ``mean_accept`` and
    ``inv_mass`` (the diagonal inverse mass to hand to the fused kernels as
    ``inv_mass_diag``). See :func:`chees_warmup_flat`."""
    example = pytree.tree_map(lambda x: x[0], traces)
    target = FlatTarget(example, selection)
    xs0 = vmap(lambda tr: tr.get_choices().filter(selection).to_array())(
        traces)
    return chees_warmup_flat(
        key, target.value_and_grad, xs0, num_warmup=num_warmup,
        num_samples=num_samples, target_accept=target_accept,
        init_step_size=init_step_size, init_traj_length=init_traj_length,
        adam_lr=adam_lr, adapt_mass=adapt_mass,
        mass_ema_decay=mass_ema_decay, free_mask=free_mask)


def chees_warmup_flat(key, vag, xs0,
                      num_warmup: int = 300,
                      num_samples: int = 500,
                      target_accept: float = 0.75,
                      init_step_size: float = 0.1,
                      init_traj_length: float = 1.0,
                      adam_lr: float = 0.025,
                      adapt_mass: bool = True,
                      mass_ema_decay: Optional[float] = None,
                      free_mask=None, batched_vag=None):
    """Flat-coordinate core of :func:`chees_hmc_warmup_and_sample`:
    ``vag(x) -> (logp, grad)`` on a ``(d,)`` vector, ``xs0`` the
    ``(chains, d)`` initial population. ``free_mask``: optional ``(d,)``
    0/1 array; zero entries are frozen (inverse mass 0) and disable the
    warmup teleport, since each chain then has its own target.
    ``batched_vag`` (not in gen_tpu, where XLA compiles the vmapped
    ``vag``): the same function on the whole ``(chains, d)`` population at
    once, used in place of ``vmap(vag)`` (the fused engines pass the staged
    program's kernel)."""
    n_chains, dim = xs0.shape
    dt, dev = xs0.dtype, xs0.device
    fdt = torch.get_default_dtype()
    key = key.to(dev)
    vg = vmap(vag) if batched_vag is None else batched_vag
    logps, grads = vg(xs0)

    mass_floor = 1e-12
    if mass_ema_decay is None:
        # keep ~128 cross-chain variance samples in the EWMA window
        mass_ema_decay = 1.0 - 1.0 / max(10.0, 128.0 / n_chains)
    ema_new = 1.0 - mass_ema_decay
    fmask = (None if free_mask is None
             else torch.as_tensor(free_mask, dtype=dt, device=dev))

    def scalar(v, dtype=fdt):
        return torch.tensor(v, dtype=dtype, device=dev)

    def cur_inv_mass(ema, m: int):
        """Geometric ease-in from identity: exp(w log ema), w = m/(m+10)."""
        if not adapt_mass:
            base = torch.ones(dim, dtype=dt, device=dev)
        else:
            mm = scalar(m, dt)
            w = mm / (mm + 10.0)
            base = torch.exp(w * torch.log(torch.clamp(ema, min=mass_floor)))
        return base if fmask is None else base * fmask

    def n_leapfrogs(ratio) -> int:
        # NaN-safe and capped: a diverged iterate must never give n_leap=0
        ratio = torch.nan_to_num(ratio, nan=1.0, posinf=1000.0)
        return int(torch.round(torch.clamp(ratio, 1.0, 1000.0)).item())

    def trajectory(xs, momenta, grads, inv_mass, eps, n_leap):
        x, mom, g = xs, momenta, grads
        for _ in range(n_leap):
            mom = mom + 0.5 * eps * g
            x = x + eps * inv_mass * mom
            lp, g = vg(x)
            mom = mom + 0.5 * eps * g
        return x, mom, g, lp

    def kin(p, inv_mass):
        return 0.5 * torch.sum(inv_mass * p * p, dim=1)

    da = da_init(scalar(init_step_size))
    chees = CheesState(torch.log(scalar(init_traj_length)), scalar(0.0),
                       scalar(0.0), scalar(1.0))
    streak = torch.zeros(n_chains, dtype=torch.int32, device=dev)
    # EWMA seed: the initial cross-chain variance (prior spread)
    ema = torch.clamp(torch.var(xs0, dim=0, correction=0), min=mass_floor)
    xs = xs0
    k_warm, k_samp = random.split(key)

    for m, k in enumerate(random.split(k_warm, num_warmup)):
        inv_mass = cur_inv_mass(ema, m)
        eps = torch.exp(torch.clamp(da.log_eps, -20.0, 10.0))
        traj = torch.exp(chees.log_t)
        u = scalar(_halton(m))
        n_leap = n_leapfrogs(u * traj / eps)

        k_mom, k_acc, k_tel = random.split(k, 3)
        momenta = sqrt_mass_safe(inv_mass) * random.normal(
            k_mom, (n_chains, dim), dt)
        x_new, mom_new, g_new, lp_new = trajectory(xs, momenta, grads,
                                                   inv_mass, eps, n_leap)
        finite = (torch.isfinite(lp_new)
                  & torch.all(torch.isfinite(x_new), dim=1)
                  & torch.all(torch.isfinite(mom_new), dim=1))
        log_alpha = (lp_new - logps - kin(mom_new, inv_mass)
                     + kin(momenta, inv_mass))
        log_alpha = torch.where(finite & ~torch.isnan(log_alpha), log_alpha,
                                -math.inf)
        alpha = torch.clamp(torch.exp(log_alpha), max=1.0)
        accept = torch.log(random.uniform(k_acc, (n_chains,), fdt)) \
            < log_alpha

        xs_out = torch.where(accept[:, None], x_new, xs)
        logps_out = torch.where(accept, lp_new, logps)
        grads_out = torch.where(accept[:, None], g_new, grads)

        da = da_update(da, torch.mean(alpha), target_accept)

        # ChEES gradient on log T; diverged chains (non-finite ends) are
        # replaced by their start points and carry alpha 0, so the
        # cross-chain means stay finite
        x_stat = torch.where(finite[:, None], x_new, xs)
        mom_stat = torch.where(finite[:, None], mom_new, 0.0)
        xbar = torch.mean(xs, dim=0)
        xbar_new = torch.mean(x_stat, dim=0)
        d_old = torch.sum((xs - xbar) ** 2, dim=1)
        d_new = torch.sum((x_stat - xbar_new) ** 2, dim=1)
        delta = d_new - d_old
        # end VELOCITY, not momentum: v = M^{-1} p
        dot = torch.sum((x_stat - xbar_new) * (inv_mass * mom_stat), dim=1)
        per_chain = delta * dot * u
        ghat = (torch.sum(alpha * per_chain)
                / torch.clamp(torch.sum(alpha), min=1e-6))
        ghat = torch.nan_to_num(ghat)

        # warmup-only teleport of chains that rejected 10 times in a row
        streak = torch.where(accept, 0, streak + 1).to(torch.int32)
        if fmask is None:
            stuck = streak >= 10
            idx = random.randint(k_tel, (n_chains,), 0, n_chains).long()
            xs_out = torch.where(stuck[:, None], xs_out[idx], xs_out)
            logps_out = torch.where(stuck, logps_out[idx], logps_out)
            grads_out = torch.where(stuck[:, None], grads_out[idx],
                                    grads_out)
            streak = torch.where(stuck, 0, streak).to(torch.int32)
        # normalized-gradient Adam ascent on log T
        g_norm = ghat / (torch.abs(ghat) + 1e-12) * torch.clamp(
            torch.abs(ghat), max=1e3)
        am = 0.9 * chees.adam_m + 0.1 * g_norm
        av = 0.999 * chees.adam_v + 0.001 * g_norm ** 2
        t = chees.step
        mhat = am / (1 - 0.9 ** t)
        vhat = av / (1 - 0.999 ** t)
        log_t = chees.log_t + adam_lr * mhat / (torch.sqrt(vhat) + 1e-8)
        # keep trajectories between eps and 1000 eps
        log_t = torch.minimum(torch.maximum(log_t, da.log_eps),
                              da.log_eps + math.log(1000.0))
        chees = CheesState(log_t, am, av, t + 1)

        # mass EWMA: per-iteration cross-chain variance (post-teleport)
        xb = torch.mean(xs_out, dim=0)
        var_m = torch.nan_to_num(torch.mean((xs_out - xb) ** 2, dim=0))
        ema = mass_ema_decay * ema + ema_new * var_m
        xs, logps, grads = xs_out, logps_out, grads_out

    inv_mass = cur_inv_mass(ema, num_warmup)
    eps_final = torch.exp(torch.clamp(da.log_eps_bar, -20.0, 10.0))
    traj_final = torch.exp(chees.log_t)
    n_leap_final = n_leapfrogs(0.7 * traj_final / eps_final)

    samples, accepts = [], []
    for k in random.split(k_samp, num_samples):
        k_mom, k_acc = random.split(k)
        momenta = sqrt_mass_safe(inv_mass) * random.normal(
            k_mom, (n_chains, dim), dt)
        x_new, mom_new, g_new, lp_new = trajectory(
            xs, momenta, grads, inv_mass, eps_final, n_leap_final)
        finite = (torch.isfinite(lp_new)
                  & torch.all(torch.isfinite(x_new), dim=1))
        log_alpha = (lp_new - logps - kin(mom_new, inv_mass)
                     + kin(momenta, inv_mass))
        log_alpha = torch.where(finite & ~torch.isnan(log_alpha), log_alpha,
                                -math.inf)
        accept = torch.log(random.uniform(k_acc, (n_chains,), fdt)) \
            < log_alpha
        xs = torch.where(accept[:, None], x_new, xs)
        logps = torch.where(accept, lp_new, logps)
        grads = torch.where(accept[:, None], g_new, grads)
        samples.append(xs)
        accepts.append(accept)
    info = dict(step_size=eps_final, trajectory_length=traj_final,
                num_leapfrogs=n_leap_final,
                mean_accept=torch.stack(accepts).to(fdt).mean(),
                inv_mass=inv_mass)
    return torch.stack(samples), xs, info
