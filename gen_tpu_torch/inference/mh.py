"""Metropolis-Hastings.

Counterpart: ``gen_tpu/inference/mh.py``, all of it: selection MH through
``regenerate`` and custom-proposal MH through ``propose``/``update``/
``assess`` (the involutive form belongs to the trace translators). Each is
a pure ``(key, trace, ...) -> (trace, accepted)`` step with gen_tpu's key
splits; it runs under ``torch.func.vmap`` over chains, the new or old
trace picked leaf by leaf.
"""

from __future__ import annotations

from typing import Tuple

from .. import random
from ..diff import all_no_change
from ..gfi import GenerativeFunction, Trace
from ..selection import Selection
from .common import mh_accept, select_trace


def mh(key, trace: Trace, selection: Selection = None,
       proposal: GenerativeFunction = None, proposal_args: Tuple = ()):
    """Selection MH if a selection is given, else custom-proposal MH."""
    if selection is not None:
        return mh_selection(key, trace, selection)
    if proposal is not None:
        return mh_proposal(key, trace, proposal, proposal_args)
    raise ValueError("mh: provide a selection or a proposal")


metropolis_hastings = mh


def mh_selection(key, trace: Trace, selection: Selection):
    """Resample the selected addresses from the internal proposal and
    accept on the regenerate weight."""
    k1, k2 = random.split(key)
    new_trace, weight, _ = trace.regenerate(k1, selection)
    accept = mh_accept(k2, weight)
    return select_trace(accept, new_trace, trace), accept


def mh_proposal(key, trace: Trace, proposal: GenerativeFunction,
                proposal_args: Tuple = ()):
    """Custom-proposal MH: propose, update, assess the discard under the
    reverse proposal; log alpha = weight - fwd + bwd. The proposal is a
    generative function whose first argument is the current trace."""
    k1, k2, k3 = random.split(key, 3)
    fwd_choices, fwd_weight, _ = proposal.propose(
        k1, (trace,) + tuple(proposal_args))
    model_args = trace.get_args()
    new_trace, weight, _, discard = trace.get_gen_fn().update(
        k2, trace, model_args, all_no_change(model_args), fwd_choices)
    bwd_weight, _ = proposal.assess((new_trace,) + tuple(proposal_args),
                                    discard)
    accept = mh_accept(k3, weight - fwd_weight + bwd_weight)
    return select_trace(accept, new_trace, trace), accept
