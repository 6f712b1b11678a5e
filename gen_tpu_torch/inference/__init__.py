from . import mass
from ..combinators.arena import smc_run
from .chees import chees_hmc_warmup_and_sample, chees_warmup_flat
from .common import flat_selected, mh_accept, select_trace
from .csmc import (check_state_is_choice_determined, csmc_genealogy,
                   particle_gibbs, particle_gibbs_step)
from .elliptical_slice import elliptical_slice
from .enumerate import enumerate_marginals, enumerate_posterior
from .gibbs import gibbs, gibbs_conditional
from .hmc import hmc, hmc_chain, hmc_chains
from .importance import importance_resampling, importance_sampling
from .kernel_dsl import (check_observations, checked, cond_kernel, for_range,
                         mixture, primitive_kernel, repeat, reversal, seq)
from .laplace import LaplaceResult, laplace_approx, laplace_sample
from .mala import mala
from .map_optimize import map_optimize
from .mass import (dense_mass_chol, lowrank_mass_factors, unwhiten, whiten,
                   whiten_logp)
from .mh import metropolis_hastings, mh, mh_proposal, mh_selection
from .mixed import (DiscreteSite, discover_discrete_sites, gibbs_sweep,
                    mixed_warmup_and_sample)
from .nuts import (NUTSStats, da_init, da_update, find_reasonable_step_size, nuts,
                   nuts_flat, nuts_warmup_and_sample)
from .nuts_fsm import (FSMResult, nuts_fsm, nuts_fsm_paired,
                       nuts_fsm_warmup_and_sample)
from .psis import PSISResult, gpd_fit, psis, psis_effective_sample_size
from .predictive import posterior_predictive, prior_predictive
from .particle_filter import (ParticleFilterState, effective_sample_size,
                              initialize_particle_filter, log_ml_estimate,
                              maybe_resample, particle_filter_step,
                              sample_unweighted_traces)
from .sample import PosteriorSamples, sample_posterior
from .sbc import sbc_ranks, sbc_uniformity
from .sgmcmc import MinibatchTarget, sghmc_step, sgld_chain, sgld_step
from .smc import reconstruct_trajectories, smc_genealogy
from .target import FlatTarget
from .tempering import (TemperedTarget, ais, parallel_tempering,
                        smc_sampler, smc_sampler_adaptive)
from .trace_translators import (DeterministicTraceTranslator,
                                GeneralTraceTranslator,
                                SimpleExtendingTraceTranslator,
                                SymmetricTraceTranslator, TraceTransform,
                                TransformContext, involutive_mcmc,
                                mh_involutive, transform)

__all__ = ["FlatTarget", "hmc", "hmc_chain", "hmc_chains",
           "mh", "metropolis_hastings", "mh_selection", "mh_proposal",
           "mala", "map_optimize", "elliptical_slice",
           "enumerate_posterior", "enumerate_marginals",
           "gibbs", "gibbs_conditional",
           "LaplaceResult", "laplace_approx", "laplace_sample",
           "flat_selected", "nuts", "nuts_flat",
           "nuts_warmup_and_sample", "NUTSStats", "da_init", "da_update",
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
           "gibbs_sweep", "mixed_warmup_and_sample",
           "csmc_genealogy", "particle_gibbs", "particle_gibbs_step",
           "check_state_is_choice_determined", "PSISResult", "psis",
           "psis_effective_sample_size", "gpd_fit", "TemperedTarget", "ais",
           "smc_sampler", "smc_sampler_adaptive", "parallel_tempering",
           "sbc_ranks", "sbc_uniformity", "posterior_predictive",
           "prior_predictive", "MinibatchTarget", "sgld_step", "sghmc_step",
           "sgld_chain", "transform", "TraceTransform", "TransformContext",
           "DeterministicTraceTranslator", "GeneralTraceTranslator",
           "SimpleExtendingTraceTranslator", "SymmetricTraceTranslator",
           "mh_involutive", "involutive_mcmc", "primitive_kernel",
           "reversal", "seq", "repeat", "for_range", "mixture",
           "cond_kernel", "check_observations", "checked"]

from .resumable import resumable_run  # noqa: E402,F401
