"""Substitution-cipher decoding via MCMC.

Counterpart: ``examples/decode.py``: text enciphered with an unknown
substitution table is recovered under a bigram language model. Both
conditionals are exact and vectorized: given the plaintext, each
cipher-table entry's posterior is an independent categorical; given the
table, the plaintext characters of one parity (even or odd positions) are
conditionally independent categoricals. A sweep is ``gibbs_enc``, two
``gibbs_plain_block``s and 40 ``transposition_move``s, each applied through
``trace.update``. The categorical draws go through
:func:`gen_tpu_torch.ops.categorical.categorical_fast`: kernel K5 on the
card, three launches per sweep. Also shows a custom
:class:`~gen_tpu_torch.dists.distribution.Distribution` (the Markov
chain).

Where PyTorch forced differences:

- The restarts run under ``torch.func.vmap``, as gen_tpu vmaps its chains;
  K5 runs under it through its custom op's vmap rule (one launch per
  call for all restarts, each restart with its own key).
- ``lax.scan`` over sweeps is a Python loop, and so is the Markov chain's
  sampler; ``.at[].add`` counting is a one-hot matrix product (exact
  integer counts) and ``.at[].set`` a ``torch.where``.
- A sweep draws the 40 transpositions' indices and accept uniforms in one
  vmapped call over their keys (:func:`transposition_draws`); the keys and
  bits are those of gen_tpu's per-move draws, so on the CPU the sweep
  equals gen_tpu's move for move.

Run: ``python -m gen_tpu_torch.examples.decode`` (on the card), or with
``--cpu``.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
from torch.func import vmap

from .. import random
from ..choice_map import choicemap
from ..dists import categorical
from ..dists.distribution import Distribution
from ..dynamic import gen
from ..inference.common import select_trace
from ..ops.categorical import categorical_fast
from ..utils import default_device, default_int

ALPHABET = "abcdefghijklmnopqrstuvwxyz "
K = len(ALPHABET)
EMIS_EPS = 0.02
N_MOVES = 40            # transposition moves per sweep

CORPUS = (
    "the quick brown fox jumps over the lazy dog and then the dog barks at "
    "the moon while the fox runs into the forest where the trees grow tall "
    "and the river flows to the sea and every morning the sun rises over "
    "the hills and the birds sing in the trees and people walk along the "
    "road to the market where they buy bread and fruit and talk about the "
    "weather and the harvest and the children play in the fields until the "
    "evening comes and the stars appear in the sky above the quiet town")

MESSAGE = ("the fox runs into the forest and the dog barks at the moon "
           "while the children play in the fields until the evening comes "
           "and the sun rises over the hills where the birds sing in the "
           "trees and the river flows to the sea while people walk along "
           "the road to the market and talk about the weather")


def _index(text):
    return np.array([ALPHABET.index(c) for c in text])


def bigram_stats(device=None):
    """Laplace-smoothed bigram matrix B (K, K) and unigram pi (K,) of the
    corpus, in torch's default float on ``device``."""
    idx = _index(CORPUS)
    counts = np.ones((K, K))
    for a, b in zip(idx[:-1], idx[1:]):
        counts[a, b] += 1
    B = counts / counts.sum(axis=1, keepdims=True)
    pi = np.bincount(idx, minlength=K).astype(float) + 1
    dt = torch.get_default_dtype()
    return (torch.tensor(B, dtype=dt, device=device),
            torch.tensor(pi / pi.sum(), dtype=dt, device=device))


def _one_hot(x, dtype):
    return (x[..., None] == torch.arange(K, device=x.device)).to(dtype)


class MarkovChain(Distribution):
    """First-order Markov chain over K symbols: a custom distribution whose
    logpdf is one gather and sum and whose sampler is a loop."""

    is_discrete = True
    has_output_grad = False
    arg_grads = (True, True, False)

    def sample(self, key, B, pi, length):
        k0, krest = random.split(key)
        prev = random.categorical(k0, torch.log(pi))
        keys = random.split(krest, length - 1)
        out = [prev]
        for t in range(length - 1):
            prev = random.categorical(keys[t], torch.log(B[prev]))
            out.append(prev)
        return torch.stack(out).to(default_int())

    def logpdf(self, v, B, pi, length):
        v = torch.as_tensor(v).long()
        lp0 = torch.log(pi[v[0]])
        trans = torch.log(B[v[:-1], v[1:]])
        return lp0 + torch.sum(trans)


markov_chain = MarkovChain()


@gen
def decode_model(B, pi, T):
    enc = categorical(torch.ones((K, K), dtype=B.dtype, device=B.device)
                      / K) @ "enc"                          # cipher table
    plain = markov_chain(B, pi, T) @ "plain"                 # latent text
    probs = ((1 - EMIS_EPS) * _one_hot(enc[plain.long()], B.dtype)
             + EMIS_EPS / K)
    categorical(probs) @ "cipher"
    return plain


def gibbs_enc(key, trace, cipher):
    """Exact conditional for the cipher table: its entries are independent
    categoricals given the plaintext."""
    plain = trace["plain"]
    dt = trace["enc"].dtype
    fdt = torch.get_default_dtype()
    # counts[l, s] = #positions where plain == l and cipher == s
    counts = _one_hot(plain, fdt).T @ _one_hot(cipher, fdt)
    hit = torch.log(torch.tensor((1 - EMIS_EPS) + EMIS_EPS / K, dtype=fdt))
    miss = torch.log(torch.tensor(EMIS_EPS / K, dtype=fdt))
    logits = (counts * hit
              + (counts.sum(dim=1, keepdim=True) - counts) * miss)
    new_enc = categorical_fast(key, logits).to(dt)
    return trace.update(None, choicemap(enc=new_enc))[0]


def gibbs_plain_block(key, trace, cipher, B, pi, parity):
    """Exact checkerboard conditional for the plaintext characters of one
    parity."""
    plain = trace["plain"]
    enc = trace["enc"]
    T = plain.shape[0]
    dev = plain.device
    pos = torch.arange(T, device=dev)
    sym = torch.arange(K, device=dev)
    match = (enc[sym][None, :] == cipher[:, None]).to(B.dtype)
    emis = torch.log((1 - EMIS_EPS) * match + EMIS_EPS / K)
    logB = torch.log(B)
    left = torch.where(pos[:, None] == 0, torch.log(pi)[None, :],
                       logB[plain[torch.clamp(pos - 1, min=0)].long(), :])
    right_idx = torch.clamp(pos + 1, max=T - 1)
    right = torch.where(pos[:, None] == T - 1, 0.0,
                        logB[:, plain[right_idx].long()].T)
    logits = left + right + emis
    proposal = categorical_fast(key, logits).to(plain.dtype)
    new_plain = torch.where((pos % 2) == parity, proposal, plain)
    return trace.update(None, choicemap(plain=new_plain))[0]


def transposition_draws(keys):
    """For each key of ``keys`` ``(m, 2)``: the two table entries ``(m,
    2)`` and the accept uniform ``(m,)`` that :func:`transposition_move`
    draws from it."""
    def one(k):
        kk = random.split(k)
        ab = random.randint(kk[0], (2,), 0, K, dtype=default_int())
        return ab, random.uniform(kk[1], (), torch.get_default_dtype())
    return vmap(one)(keys)


def transposition_move(key, trace, cipher, draws=None):
    """Diaconis-style transposition: swap two cipher-table entries and
    relabel the plaintext consistently, a joint discrete involution whose
    acceptance is the update weight. It escapes the local optima that the
    Gibbs moves lock into. ``draws``: this move's ``(ab, u)`` from
    :func:`transposition_draws`, drawn from ``key`` if not given."""
    if draws is None:
        ab, u = transposition_draws(key[None])
        draws = (ab[0], u[0])
    ab, u = draws
    a, b = ab[0], ab[1]
    enc, plain = trace["enc"], trace["plain"]
    idx = torch.arange(K, device=enc.device)
    new_enc = torch.where(idx == a, enc[b], torch.where(idx == b, enc[a],
                                                        enc))
    new_plain = torch.where(plain == a, b, torch.where(plain == b, a, plain))
    new_trace, w, _, _ = trace.update(
        None, choicemap(enc=new_enc, plain=new_plain.to(plain.dtype)))
    return select_trace(torch.log(u) < w, new_trace, trace)


def one_sweep(trace, key, cipher, B, pi):
    """gibbs_enc, the two plaintext blocks, then 40 transpositions."""
    ks = random.split(key, 3 + N_MOVES)
    trace = gibbs_enc(ks[0], trace, cipher)
    trace = gibbs_plain_block(ks[1], trace, cipher, B, pi, 0)
    trace = gibbs_plain_block(ks[2], trace, cipher, B, pi, 1)
    ab, u = transposition_draws(ks[3:])
    for i in range(N_MOVES):
        trace = transposition_move(None, trace, cipher, (ab[i], u[i]))
    return trace


def problem(seed=0, device=None, message=MESSAGE):
    """(B, pi, cipher, true_plain) for ``message`` under a random table."""
    B, pi = bigram_stats(device)
    rng = np.random.default_rng(seed)
    true_plain = _index(message)
    true_table = rng.permutation(K)
    cipher = torch.tensor(true_table[true_plain], device=device)
    return B, pi, cipher, true_plain


def main(n_sweeps=600, n_restarts=16, seed=0, device=None):
    """Decode the message with ``n_restarts`` independent chains of
    ``n_sweeps`` sweeps, vmapped, and keep the best-scoring one. Returns
    a dict with the accuracy, the best score and the wall time."""
    device = default_device() if device is None else torch.device(device)
    B, pi, cipher, true_plain = problem(seed, device)
    T = len(true_plain)
    key = random.PRNGKey(seed, device)

    def run_chain(k):
        ks = random.split(k)
        trace, _ = decode_model.generate(ks[0], (B, pi, T),
                                         choicemap(cipher=cipher))
        sweep_keys = random.split(ks[1], n_sweeps)
        for i in range(n_sweeps):
            trace = one_sweep(trace, sweep_keys[i], cipher, B, pi)
        return trace.get_score(), trace["plain"]

    t0 = time.perf_counter()
    scores, plains = vmap(run_chain)(random.split(key, n_restarts))
    best = int(torch.argmax(scores))
    plain = plains[best].cpu().numpy()
    wall = time.perf_counter() - t0
    decoded = "".join(ALPHABET[int(c)] for c in plain)
    acc = float(np.mean(plain == true_plain))
    print(f"best of {n_restarts} chains (score {float(scores[best]):.1f}):")
    print(f"decoded:  {decoded[:64]}...")
    print(f"original: {MESSAGE[:64]}...")
    print(f"character accuracy: {acc:.2%} ({n_restarts} restarts x "
          f"{n_sweeps} sweeps in {wall:.1f} s)")
    assert acc > 0.9 and math.isfinite(float(scores[best])), acc
    print("decode example OK")
    return dict(accuracy=acc, best_score=float(scores[best]), seconds=wall,
                scores=scores)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweeps", type=int, default=600)
    ap.add_argument("--restarts", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernel's plain route)")
    a = ap.parse_args()
    main(a.sweeps, a.restarts, a.seed, "cpu" if a.cpu else None)
