"""Importance sampling and resampling.

Counterpart: ``gen_tpu/inference/importance.py``. The N particles are one
``torch.func.vmap`` axis over ``generate``, with gen_tpu's keys (one per
particle, split in two inside each particle when there is a proposal).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.utils._pytree as pytree

from .. import random
from ..choice_map import ChoiceMap
from ..gfi import GenerativeFunction
from ..utils import logsumexp


def importance_sampling(key, model: GenerativeFunction, model_args: Tuple,
                        observations: ChoiceMap, num_samples: int,
                        proposal: Optional[GenerativeFunction] = None,
                        proposal_args: Tuple = (), verbose: bool = False):
    """Returns (vmapped_traces, log_normalized_weights, log_ml_estimate).

    Default proposal: the weights come straight from ``generate``. Custom
    proposal: propose, merge with the observations, then a fully
    constrained ``generate``; weight = model weight - proposal weight."""
    keys = random.split(key, num_samples)
    if verbose:
        print(f"importance sampling: {num_samples} particles")

    if proposal is None:
        def one(k):
            return model.generate(k, model_args, observations)
    else:
        def one(k):
            kp, km = random.split(k)
            prop_choices, prop_weight, _ = proposal.propose(kp, proposal_args)
            constraints = observations.merge(prop_choices)
            trace, model_weight = model.generate(km, model_args, constraints)
            return trace, model_weight - prop_weight
    traces, log_weights = torch.func.vmap(one)(keys)

    log_total_weight = logsumexp(log_weights)
    log_ml_estimate = log_total_weight - math.log(num_samples)
    return traces, log_weights - log_total_weight, log_ml_estimate


def importance_resampling(key, model: GenerativeFunction, model_args: Tuple,
                          observations: ChoiceMap, num_samples: int,
                          proposal: Optional[GenerativeFunction] = None,
                          proposal_args: Tuple = ()):
    """One trace drawn in proportion to its importance weight. Returns
    (trace, log_ml_estimate)."""
    k1, k2 = random.split(key)
    traces, log_normalized_weights, log_ml = importance_sampling(
        k1, model, model_args, observations, num_samples, proposal,
        proposal_args)
    idx = random.categorical(k2, log_normalized_weights)
    return pytree.tree_map(lambda x: x[idx], traces), log_ml
