"""Mixture distributions.

Counterpart: ``gen_tpu/dists/mixture.py``, all of it.
``HomogeneousMixture(dist, dims)``: K components of one family, args =
``(weights, *stacked_args)``, each stacked argument with a leading K axis.
``HeterogeneousMixture(dists)``: one component a distribution, args =
``(weights, *args_of_dist1, *args_of_dist2, ...)``. The K component
logpdfs are one ``torch.func.vmap`` (gen_tpu: ``jax.vmap``) and a
logsumexp; gradients come from autodiff of that expression. Draws are
gen_tpu's: the component index from the same key, then the component's
own sampler.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch.func import vmap

from .. import random
from ..utils import logsumexp
from .distribution import Distribution, _f


def _pick(a, idx):
    """``a[idx]`` along the leading axis with the index as a 1-element
    tensor, which a batched index under ``torch.func.vmap`` needs."""
    return torch.as_tensor(a)[idx.reshape(1)][0]


class HomogeneousMixture(Distribution):
    """Mixture of K components from one distribution family."""

    def __init__(self, dist: Distribution, dims: Sequence[int]):
        self.dist = dist
        self.dims = tuple(dims)
        self.is_discrete = dist.is_discrete
        self.has_output_grad = dist.has_output_grad
        self.arg_grads = (True,) + tuple(dist.arg_grads)

    def __repr__(self):
        return f"HomogeneousMixture({self.dist!r})"

    def _component_logpdfs(self, v, args):
        def one(*component_args):
            return self.dist.logpdf(v, *component_args)
        return vmap(one)(*[torch.as_tensor(a) for a in args])

    def sample(self, key, weights, *args):
        kc, ks = random.split(key)
        idx = random.categorical(kc, torch.log(_f(weights)))
        return self.dist.sample(ks, *(_pick(a, idx) for a in args))

    def logpdf(self, v, weights, *args):
        lps = self._component_logpdfs(v, args)
        return logsumexp(torch.log(_f(weights)) + lps)


class HeterogeneousMixture(Distribution):
    """Mixture of distinct component distributions with flat-packed args:
    ``(weights, *args_of_dist1, *args_of_dist2, ...)``."""

    def __init__(self, dists: Sequence[Distribution]):
        self.dists = tuple(dists)
        self.num_args = tuple(len(d.arg_grads) for d in self.dists)
        self.is_discrete = all(d.is_discrete for d in self.dists)
        self.has_output_grad = all(d.has_output_grad for d in self.dists)
        grads = [True]
        for d in self.dists:
            grads.extend(d.arg_grads)
        self.arg_grads = tuple(grads)

    def __repr__(self):
        return f"HeterogeneousMixture({self.dists!r})"

    def _unpack(self, args):
        out, i = [], 0
        for n in self.num_args:
            out.append(tuple(args[i:i + n]))
            i += n
        if i != len(args):
            raise ValueError(
                f"HeterogeneousMixture expects {i} component args, got "
                f"{len(args)}")
        return out

    def sample(self, key, weights, *args):
        kc, ks = random.split(key)
        per = self._unpack(args)
        idx = random.categorical(kc, torch.log(_f(weights)))
        # every component draws (K is small) and the index selects, as
        # gen_tpu does branch-free
        samples = [torch.as_tensor(d.sample(k, *a)) for d, a, k in
                   zip(self.dists, per, random.split(ks, len(self.dists)))]
        dt = samples[0].dtype
        for s in samples[1:]:
            dt = torch.promote_types(dt, s.dtype)
        return _pick(torch.stack([s.to(dt) for s in samples]), idx)

    def logpdf(self, v, weights, *args):
        per = self._unpack(args)
        lps = torch.stack([torch.as_tensor(d.logpdf(v, *a))
                           for d, a in zip(self.dists, per)])
        return logsumexp(torch.log(_f(weights)) + lps)
