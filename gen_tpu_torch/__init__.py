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
from .combinators import (Unfold, UnfoldArena, VectorChoiceMap, smc_run,
                          vector_choicemap)
from .diff import IntDiff, NoChange, UnknownChange
from .dists import normal, normal_linear
from .dynamic import gen, init_param, param, trace_at
from .gfi import GenerativeFunction, Trace
from .selection import complement, select

__all__ = [
    "combinators", "diagnostics", "inference", "random", "addr_path",
    "ChoiceMap", "choicemap", "Unfold", "UnfoldArena", "VectorChoiceMap",
    "smc_run", "vector_choicemap", "IntDiff", "NoChange", "UnknownChange",
    "normal", "normal_linear", "gen", "init_param", "param", "trace_at",
    "GenerativeFunction", "Trace", "complement", "select",
]
