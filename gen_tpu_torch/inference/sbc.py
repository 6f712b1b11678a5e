"""Simulation-based calibration (SBC): validate an entire inference
pipeline against its own model.

Counterpart: ``gen_tpu/inference/sbc.py``, all of it. Draw theta ~ prior,
y ~ p(y | theta), run the inference procedure on y, and rank theta among
L posterior draws (Talts et al. 2018): if the procedure targets the
correct posterior, every rank is uniform on {0..L}. The study is one
``torch.func.vmap`` over trials of (simulate -> filter observations -> run
inference -> rank), as gen_tpu's is one ``jax.vmap``.

gen_tpu's vmapped trial returns its draw count beside the ranks and reads
it as ``int(ls[0])``; a function under ``torch.func.vmap`` returns only
tensors, so here the count is read from the (unbatched) shape of the
thinned draws while the trials run.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
from torch.func import vmap

from .. import random
from ..gfi import GenerativeFunction
from ..selection import Selection


def sbc_ranks(key, model: GenerativeFunction, args: Tuple,
              obs_selection: Selection, run_inference: Callable,
              num_trials: int, thin: int = 1):
    """Run an SBC study.

    ``run_inference(key, observations: ChoiceMap) -> (L, d) tensor`` must
    return posterior draws over the latent coordinates in the model's
    sorted-address ``to_array`` order and must run under
    ``torch.func.vmap``. ``thin`` subsamples the draws before ranking
    (SBC requires near-independent draws).

    Returns ``(ranks, L)``: ranks is (num_trials, d) integers in [0, L],
    the count of posterior draws below the prior draw per coordinate.
    """
    lengths = []

    def one(k):
        k_sim, k_inf = random.split(k)
        trace = model.simulate(k_sim, args)
        choices = trace.get_choices()
        obs = choices.filter(obs_selection)
        latents = choices.filter(obs_selection.complement())
        theta = latents.to_array()
        draws = run_inference(k_inf, obs)
        draws = draws[::thin]
        lengths.append(draws.shape[0])
        return torch.sum(draws < theta[None, :], dim=0)

    ranks = vmap(one)(random.split(key, num_trials))
    return ranks, int(lengths[0])


def sbc_uniformity(ranks, L: int, num_bins: int = 20):
    """Chi-square goodness-of-fit of the rank histograms against uniform.

    Returns (statistic, dof, pvalue) per coordinate (arrays of shape (d,)).
    Small p-values (< 0.01 across coordinates, after accounting for
    multiplicity) indicate a miscalibrated pipeline.
    """
    from scipy import stats as sps
    ranks = np.asarray(ranks.cpu() if isinstance(ranks, torch.Tensor)
                       else ranks)
    n, d = ranks.shape
    num_bins = min(num_bins, L + 1)
    edges = np.linspace(0, L + 1, num_bins + 1)
    # ranks are integers 0..L; equal-width bins cover unequal numbers of
    # integers unless num_bins divides L+1: the exact per-bin integer
    # coverage gives the expected counts
    ints = np.arange(L + 1)
    per_bin = np.histogram(ints, bins=edges)[0]
    expected = n * per_bin / (L + 1)
    stat = np.empty(d)
    for j in range(d):
        counts, _ = np.histogram(ranks[:, j], bins=edges)
        stat[j] = np.sum((counts - expected) ** 2 / expected)
    dof = num_bins - 1
    pval = sps.chi2.sf(stat, dof)
    return stat, dof, pval
