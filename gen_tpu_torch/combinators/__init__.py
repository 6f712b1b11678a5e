from .arena import ArenaTrace, UnfoldArena, smc_run
from .map_combinator import Map, MapCombinator, MapTrace
from .unfold import Unfold, UnfoldCombinator, UnfoldTrace
from .vector import (VectorChoiceMap, tree_index, tree_stack, try_densify,
                     vector_choicemap)

__all__ = [
    "VectorChoiceMap", "vector_choicemap", "try_densify", "tree_stack",
    "tree_index", "Unfold", "UnfoldCombinator", "UnfoldTrace",
    "UnfoldArena", "ArenaTrace", "smc_run", "Map", "MapCombinator",
    "MapTrace",
]
