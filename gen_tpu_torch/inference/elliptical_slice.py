"""Elliptical slice sampling (Murray, Adams & MacKay 2010) for an address
with a multivariate-normal prior.

Counterpart: ``gen_tpu/inference/elliptical_slice.py``. Like gen_tpu, the
slice threshold is on the likelihood ratio, taken as ``project`` of the
complement of ``addr`` (the score of everything else), not on the joint
ratio of the raw ``update`` weight: the ellipse already preserves the
prior, so the joint ratio would count it twice. gen_tpu's angle-shrinking
``lax.while_loop`` is a loop that runs while any lane's proposal is still
below its threshold (:func:`~gen_tpu_torch.inference.common.any_lane`),
each lane's bracket, key and trace moving only while its own condition
holds: a vmapped ``while_loop``. The auxiliary draw is
:func:`gen_tpu_torch.random.multivariate_normal`'s ``svd`` construction,
whose factor's signs may differ from XLA's SVD.
"""

from __future__ import annotations

import math

import torch

from .. import random
from ..choice_map import ChoiceMap
from ..diff import all_no_change
from ..gfi import Trace
from ..selection import complement, select
from .common import any_lane, select_trace


def elliptical_slice(key, trace: Trace, addr, mu, cov):
    """One elliptical slice update of the choice at ``addr``; returns the
    new trace (always accepted)."""
    gen_fn = trace.get_gen_fn()
    args = trace.get_args()
    argdiffs = all_no_change(args)
    mu = torch.as_tensor(mu)
    dt = torch.get_default_dtype()

    k_nu, k_u, k_theta, k_loop = random.split(key, 4)
    nu = random.multivariate_normal(k_nu, torch.zeros_like(mu),
                                    torch.as_tensor(cov))
    log_u = torch.log(random.uniform(k_u, (), dt))
    theta0 = random.uniform(k_theta, (), dt) * 2 * math.pi
    f = trace[addr] - mu
    lik_sel = complement(select(addr))
    lik_old = trace.project(lik_sel)

    def propose(theta):
        new_f = f * torch.cos(theta) + nu * torch.sin(theta)
        cons = ChoiceMap().set_value(addr, new_f + mu)
        new_trace, _, _, _ = gen_fn.update(None, trace, args, argdiffs, cons)
        return new_trace, new_trace.project(lik_sel) - lik_old

    new_trace, weight = propose(theta0)
    theta, theta_min, theta_max = theta0, theta0 - 2 * math.pi, theta0
    k = k_loop
    active = weight <= log_u
    while any_lane(active):
        lo = torch.where(theta < 0, theta, theta_min)
        hi = torch.where(theta < 0, theta_max, theta)
        k_next, sub = random.split(k)
        cand = lo + random.uniform(sub, (), dt) * (hi - lo)
        cand_trace, cand_weight = propose(cand)
        theta_min = torch.where(active, lo, theta_min)
        theta_max = torch.where(active, hi, theta_max)
        theta = torch.where(active, cand, theta)
        k = torch.where(active, k_next, k)
        new_trace = select_trace(active, cand_trace, new_trace)
        weight = torch.where(active, cand_weight, weight)
        active = weight <= log_u
    return new_trace
