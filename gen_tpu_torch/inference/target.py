"""Flat-vector view of a trace's selected choices.

Counterpart: ``gen_tpu/inference/target.py``. ``logp`` is ``assess`` on the
merged choice map, as in gen_tpu; ``value_and_grad`` comes from
``torch.func.grad_and_value`` (reordered to gen_tpu's ``(value, grad)``).
``rebuild`` is a fully constrained ``generate`` (gen_tpu's is ``update``,
which the port has not yet): every choice is constrained, so the key is
unused and the trace is the same.
"""

from __future__ import annotations

from torch.func import grad_and_value

from .. import random
from ..gfi import Trace
from ..selection import Selection


class FlatTarget:
    """(logp(flat), grad) over the selected choices of a trace."""

    def __init__(self, trace: Trace, selection: Selection):
        gen_fn = trace.get_gen_fn()
        args = trace.get_args()
        choices = trace.get_choices()
        self.values_chm = choices.filter(selection)
        if len(self.values_chm) == 0:
            raise ValueError("selection matches no choices")
        rest = choices.filter(selection.complement())
        self.flat0 = self.values_chm.to_array()
        self.dim = self.flat0.shape[0]
        self._gen_fn, self._args, self._rest = gen_fn, args, rest

        def logp(flat):
            chm = self.values_chm.from_array(flat)
            w, _ = gen_fn.assess(args, rest.merge(chm))
            return w

        gv = grad_and_value(logp)

        def value_and_grad(flat):
            g, v = gv(flat)
            return v, g

        self.logp = logp
        self.value_and_grad = value_and_grad

    def rebuild(self, flat):
        """New trace with the selected choices set to ``flat``."""
        trace, _ = self._gen_fn.generate(
            random.PRNGKey(0, flat.device), self._args,
            self._rest.merge(self.values_chm.from_array(flat)))
        return trace
