"""The Generative Function Interface (GFI).

Counterpart: ``gen_tpu/gfi.py``. Same design: every sampling method takes an
explicit key (a :mod:`gen_tpu_torch.random` key tensor, not a
``torch.Generator``, so that ``torch.func.vmap`` can batch it), methods are
pure, and traces are pytrees whose structure is static and whose leaves are
tensors. Ported: ``simulate``, ``generate``, ``assess``, ``project``,
``propose``, ``update`` and ``regenerate``, with the trace-first
forwarding of ``update``/``regenerate``. The gradient methods wait for a
later slice.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from .choice_map import ChoiceMap
from .diff import all_no_change
from .selection import Selection


class Trace:
    """A recorded execution of a generative function."""

    def get_args(self) -> Tuple:
        raise NotImplementedError

    def get_retval(self):
        raise NotImplementedError

    def get_choices(self) -> ChoiceMap:
        raise NotImplementedError

    def get_score(self):
        """log p(t, r; x) / q(r; x, t); equals log p(t; x) when there is no
        non-addressed randomness."""
        raise NotImplementedError

    def get_gen_fn(self) -> "GenerativeFunction":
        raise NotImplementedError

    def __getitem__(self, addr):
        return self.get_choices()[addr]

    def update(self, key, constraints: ChoiceMap, args=None, argdiffs=None):
        fn = self.get_gen_fn()
        if args is None:
            args = self.get_args()
            argdiffs = all_no_change(args)
        return fn.update(key, self, args, argdiffs, constraints)

    def regenerate(self, key, selection: Selection, args=None,
                   argdiffs=None):
        fn = self.get_gen_fn()
        if args is None:
            args = self.get_args()
            argdiffs = all_no_change(args)
        return fn.regenerate(key, self, args, argdiffs, selection)

    def project(self, selection: Selection):
        return self.get_gen_fn().project(self, selection)


class GenerativeFunction:
    """Abstract generative function."""

    def simulate(self, key, args: Tuple) -> Trace:
        """Sample t ~ p(.; x); return the trace."""
        raise NotImplementedError

    def generate(self, key, args: Tuple,
                 constraints: Optional[ChoiceMap] = None
                 ) -> Tuple[Trace, Any]:
        """Constrained generation; weight = log p(t; x) / q(t; u, x)."""
        raise NotImplementedError

    def project(self, trace: Trace, selection: Selection):
        """log-density of the selected choices under the internal proposal
        decomposition."""
        raise NotImplementedError

    def propose(self, key, args: Tuple) -> Tuple[ChoiceMap, Any, Any]:
        """(choices, weight, retval); the default goes through simulate."""
        trace = self.simulate(key, args)
        return trace.get_choices(), trace.get_score(), trace.get_retval()

    def assess(self, args: Tuple, choices: ChoiceMap) -> Tuple[Any, Any]:
        """(weight, retval) with ALL addressed choices given; key-free and
        differentiable."""
        raise NotImplementedError

    def update(self, key, trace: Trace, args: Tuple, argdiffs: Tuple,
               constraints: ChoiceMap):
        """(new_trace, weight, retdiff, discard); the incremental edit move.
        weight = log [p(t';x') q(r;x,t)] / [p(t;x) q(r';x',t') q(t';x',t+u)].
        ``key`` may be None when nothing needs to be sampled."""
        raise NotImplementedError

    def regenerate(self, key, trace: Trace, args: Tuple, argdiffs: Tuple,
                   selection: Selection):
        """(new_trace, weight, retdiff); resample the selected addresses from
        the internal proposal."""
        raise NotImplementedError

    def __call__(self, *args):
        """Inside a model body, ``fn(args) @ "addr"`` traces a call at an
        address."""
        from .dynamic.handlers import Call
        return Call(self, args)

    def inline(self, *args):
        """Call another generative function without an address scope: its
        choices splice into the caller's trace."""
        from .dynamic.handlers import active_handler
        return active_handler().splice(self, args)
