from .arena import ArenaTrace, UnfoldArena, smc_run
from .at import CallAtCombinator, ChoiceAtCombinator, call_at, choice_at
from .custom_determ import (CustomDetermGF, CustomDetermGFTrace,
                            CustomGradientGF, CustomUpdateGF)
from .map_combinator import Map, MapCombinator, MapTrace
from .recurse import Recurse, RecurseCombinator, RecurseTrace
from .recurse_leveled import LeveledRecurseCombinator, RecurseLeveled
from .switch import Switch, SwitchCombinator, SwitchTrace
from .unfold import Unfold, UnfoldCombinator, UnfoldTrace
from .vector import (VectorChoiceMap, tree_index, tree_stack, try_densify,
                     vector_choicemap)

__all__ = [
    "VectorChoiceMap", "vector_choicemap", "try_densify", "tree_stack",
    "tree_index", "Unfold", "UnfoldCombinator", "UnfoldTrace",
    "UnfoldArena", "ArenaTrace", "smc_run", "Map", "MapCombinator",
    "MapTrace", "choice_at", "call_at", "ChoiceAtCombinator",
    "CallAtCombinator", "Switch", "SwitchCombinator", "SwitchTrace",
    "CustomDetermGF", "CustomUpdateGF", "CustomGradientGF",
    "CustomDetermGFTrace", "Recurse", "RecurseCombinator", "RecurseTrace",
    "RecurseLeveled", "LeveledRecurseCombinator",
]
