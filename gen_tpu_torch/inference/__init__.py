from . import mass
from ..combinators.arena import smc_run
from .chees import chees_hmc_warmup_and_sample, chees_warmup_flat
from .common import mh_accept, select_trace
from .hmc import hmc_chains
from .importance import importance_resampling, importance_sampling
from .mass import (dense_mass_chol, lowrank_mass_factors, unwhiten, whiten,
                   whiten_logp)
from .mixed import (DiscreteSite, discover_discrete_sites, gibbs_sweep,
                    mixed_warmup_and_sample)
from .nuts import (da_init, da_update, find_reasonable_step_size, nuts,
                   nuts_flat, nuts_warmup_and_sample)
from .nuts_fsm import (FSMResult, nuts_fsm, nuts_fsm_paired,
                       nuts_fsm_warmup_and_sample)
from .particle_filter import (ParticleFilterState, effective_sample_size,
                              initialize_particle_filter, log_ml_estimate,
                              maybe_resample, particle_filter_step,
                              sample_unweighted_traces)
from .sample import PosteriorSamples, sample_posterior
from .smc import reconstruct_trajectories, smc_genealogy
from .target import FlatTarget

__all__ = ["FlatTarget", "hmc_chains", "nuts", "nuts_flat",
           "nuts_warmup_and_sample", "da_init", "da_update",
           "find_reasonable_step_size", "chees_hmc_warmup_and_sample",
           "chees_warmup_flat", "FSMResult", "nuts_fsm", "nuts_fsm_paired",
           "nuts_fsm_warmup_and_sample", "mass", "dense_mass_chol",
           "whiten", "unwhiten", "whiten_logp", "lowrank_mass_factors",
           "PosteriorSamples", "sample_posterior",
           "importance_sampling", "importance_resampling",
           "ParticleFilterState", "initialize_particle_filter",
           "particle_filter_step", "maybe_resample", "log_ml_estimate",
           "effective_sample_size", "sample_unweighted_traces", "smc_run",
           "smc_genealogy", "reconstruct_trajectories", "select_trace",
           "mh_accept", "DiscreteSite", "discover_discrete_sites",
           "gibbs_sweep", "mixed_warmup_and_sample"]
