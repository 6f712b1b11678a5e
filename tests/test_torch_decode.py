"""gen_tpu_torch's cipher-decode example against gen_tpu's
(``examples/decode.py``): one sweep on a 24-character message with two
restarts under ``vmap``, move for move under the same keys, in float64
(JAX's x64 mode; the port's default float64). On the CPU the categorical
draws are threefry Gumbel-argmax on both sides (K5 runs only on the
card), so the traces are equal after every move: the table and the
plaintext exactly, the scores within 1e-9."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gen_tpu as gt  # noqa: E402
from gen_tpu_torch import random  # noqa: E402
from gen_tpu_torch.choice_map import choicemap as t_choicemap  # noqa: E402
from gen_tpu_torch.examples import decode as tdec  # noqa: E402
from torch_port_models import float64_default  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
import decode as jdec  # noqa: E402

LENGTH = 24


def _check(jtr, ttr, label):
    for addr in ("enc", "plain"):
        np.testing.assert_array_equal(np.asarray(jtr[addr]),
                                      ttr[addr].numpy(), err_msg=label)
    np.testing.assert_allclose(np.asarray(jtr.get_score()),
                               ttr.get_score().numpy(), rtol=1e-9,
                               err_msg=label)


def test_decode_sweep_matches_gen_tpu_move_for_move():
    with float64_default():
        B, pi, cipher, true_plain = tdec.problem(0, "cpu",
                                                 tdec.MESSAGE[:LENGTH])
        T = len(true_plain)
        jB, jpi = jnp.asarray(B.numpy()), jnp.asarray(pi.numpy())
        jcipher = jnp.asarray(cipher.numpy())
        jkeys = jax.random.split(jax.random.PRNGKey(7), 2)
        tkeys = random.split(random.PRNGKey(7, "cpu"), 2)
        jtr = jax.vmap(lambda k: jdec.decode_model.generate(
            k, (jB, jpi, T), gt.choicemap(cipher=jcipher))[0])(jkeys)
        ttr = torch.func.vmap(lambda k: tdec.decode_model.generate(
            k, (B, pi, T), t_choicemap(cipher=cipher))[0])(tkeys)
        _check(jtr, ttr, "generate")
        t_start = ttr
        # the sweep keys of each restart, split as one_sweep splits them
        jks = jax.vmap(lambda k: jax.random.split(k, 43))(jkeys)
        tks = torch.func.vmap(lambda k: random.split(k, 43))(tkeys)
        # each JAX move compiled once, vmapped over the restarts
        j_trans = jax.jit(jax.vmap(
            lambda tr, k: jdec.transposition_move(k, tr, jcipher)))
        moves = [
            ("gibbs_enc",
             jax.jit(jax.vmap(lambda tr, k: jdec.gibbs_enc(k, tr, jcipher))),
             lambda tr, k: tdec.gibbs_enc(k, tr, cipher)),
            ("plain block 0", jax.jit(jax.vmap(
                lambda tr, k: jdec.gibbs_plain_block(k, tr, jcipher, jB,
                                                     jpi, 0))),
             lambda tr, k: tdec.gibbs_plain_block(k, tr, cipher, B, pi, 0)),
            ("plain block 1", jax.jit(jax.vmap(
                lambda tr, k: jdec.gibbs_plain_block(k, tr, jcipher, jB,
                                                     jpi, 1))),
             lambda tr, k: tdec.gibbs_plain_block(k, tr, cipher, B, pi, 1))]
        moves += [(f"transposition {i}", j_trans,
                   lambda tr, k: tdec.transposition_move(k, tr, cipher))
                  for i in range(tdec.N_MOVES)]
        accepted = 0
        for i, (label, jmove, tmove) in enumerate(moves):
            jprev = jtr
            jtr = jmove(jtr, jks[:, i])
            ttr = torch.func.vmap(tmove)(ttr, tks[:, i])
            _check(jtr, ttr, label)
            if i >= 3:
                accepted += int(np.sum(np.asarray(jtr.get_score())
                                       != np.asarray(jprev.get_score())))
        assert accepted > 0          # the transpositions were exercised
        # the port's one_sweep (batched transposition draws) lands on the
        # same trace
        swept = torch.func.vmap(lambda tr, k: tdec.one_sweep(
            tr, k, cipher, B, pi))(t_start, tkeys)
        _check(jtr, swept, "one_sweep")


def test_mh_accept_matches_gen_tpu():
    """The accept decision the transposition move makes, as the shared
    inference helper gen_tpu's decode calls."""
    from gen_tpu.inference import mh_accept as j_accept
    from gen_tpu_torch.inference import mh_accept as t_accept
    with float64_default():
        for seed in range(6):
            for log_alpha in (-2.0, -0.3, 0.0, 0.4):
                want = bool(j_accept(jax.random.PRNGKey(seed), log_alpha))
                assert bool(t_accept(random.PRNGKey(seed, "cpu"),
                                     torch.tensor(log_alpha))) == want

