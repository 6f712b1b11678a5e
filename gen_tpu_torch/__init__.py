"""gen_tpu_torch: the PyTorch/CUDA port of gen_tpu.

Each module ``gen_tpu_torch/<path>.py`` mirrors ``gen_tpu/<path>.py`` and
names its counterpart in its docstring. The package imports ``torch`` and
never ``jax``. Kernels are hand-written CUDA C++ for Hopper (``sm_90a``),
built on first use from the sources under ``ops/csrc``; a tensor on the CPU
runs each kernel's plain PyTorch twin instead.
"""

from . import combinators, diagnostics, inference, random
from .address import addr_path
from .choice_map import ChoiceMap, choicemap
from .combinators import (Map, Switch, SwitchCombinator, Unfold,
                          UnfoldArena, VectorChoiceMap, call_at, choice_at,
                          smc_run, vector_choicemap)
from .diff import IntDiff, NoChange, UnknownChange
from .dists import *  # noqa: F401,F403
from .dists import __all__ as _dists_all
from .dynamic import (DynamicTrace, GenFn, gen, get_param, get_param_grad,
                      init_param, param, set_param, set_param_grad, trace_at,
                      zero_param_grad)
from .gfi import GenerativeFunction, Trace
from .masked import MaskedSelection, MaskedValue, mask, masked_select
from .selection import complement, select, selectall, selectnone
from .utils import logsumexp

__all__ = [
    "combinators", "diagnostics", "inference", "random", "addr_path",
    "ChoiceMap", "choicemap", "Map", "Unfold", "UnfoldArena",
    "VectorChoiceMap", "smc_run", "vector_choicemap", "IntDiff", "NoChange",
    "UnknownChange", "GenFn", "gen", "init_param", "param", "trace_at",
    "get_param", "set_param", "get_param_grad", "zero_param_grad",
    "set_param_grad", "DynamicTrace", "logsumexp",
    "GenerativeFunction", "Trace", "complement", "select", "selectall",
    "selectnone", "Switch", "SwitchCombinator", "choice_at", "call_at",
    "MaskedValue", "mask", "MaskedSelection", "masked_select",
] + _dists_all
