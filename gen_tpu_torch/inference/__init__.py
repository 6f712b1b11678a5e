from .chees import chees_hmc_warmup_and_sample
from .hmc import hmc_chains
from .nuts import (da_init, da_update, find_reasonable_step_size, nuts,
                   nuts_flat, nuts_warmup_and_sample)
from .nuts_fsm import FSMResult, nuts_fsm_paired
from .target import FlatTarget

__all__ = ["FlatTarget", "hmc_chains", "nuts", "nuts_flat",
           "nuts_warmup_and_sample", "da_init", "da_update",
           "find_reasonable_step_size", "chees_hmc_warmup_and_sample",
           "FSMResult", "nuts_fsm_paired"]
