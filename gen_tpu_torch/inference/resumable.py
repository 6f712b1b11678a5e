"""Preemption-safe, self-healing inference driving.

Counterpart: ``gen_tpu/inference/resumable.py``, all of it. Any
``segment_fn(key, state) -> (state, draws)`` (a loop of fused HMC steps,
a particle-filter sweep, a training epoch) becomes

- **resumable**: the run is a deterministic schedule of segments with keys
  ``fold_in(base_key, segment)``; after every segment the carried state
  and the next segment's index are checkpointed ATOMICALLY in one file
  (tmp + rename), and each segment's draws are persisted first. A new
  process pointed at the same ``workdir`` continues where the dead one
  stopped, and the assembled draws are identical, bit for bit, to an
  uninterrupted run's (same keys, same arithmetic; a restored tensor goes
  back to the device and dtype of ``state0``'s).
- **self-healing**: after each segment a health check runs (default:
  every floating leaf of the state AND of the segment's draws finite). On
  failure the segment is re-run from the previous state with fresh
  randomness, ``fold_in(base_key, segment + retry * RETRY_STRIDE)`` for
  retry >= 1; ``max_retries`` failures raise with the segment named.

The base key's fingerprint is the SHA-256 of its two 32-bit words as
uint32 bytes, moved to the CPU: the bytes of ``jax.random.key_data`` of
the same key, so it is stable across processes. Checkpoints use
:mod:`gen_tpu_torch.checkpoint`.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import random
from ..checkpoint import restore_pytree, save_pytree

RETRY_STRIDE = 1_000_003    # prime; keeps retry keys off the main schedule


def _all_finite(state, draws=None) -> bool:
    return all(bool(torch.all(torch.isfinite(leaf)))
               for leaf in (torch.as_tensor(x) for x in pytree.tree_leaves(
                   (state, draws)) if x is not None)
               if leaf.is_floating_point() or leaf.is_complex())


def _call_health_check(health_check, state, draws) -> bool:
    """Call ``health_check(state, draws)``; single-argument checks keep
    working and see only the state. Arity is inspected rather than guessed
    from a TypeError, so a check that itself raises TypeError is not
    silently re-invoked."""
    try:
        params = inspect.signature(health_check).parameters
        n_required = sum(
            1 for p in params.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.default is p.empty)
        takes_two = (n_required >= 2
                     or any(p.kind == p.VAR_POSITIONAL
                            for p in params.values())
                     or len(params) >= 2)
    except (TypeError, ValueError):
        takes_two = True
    if takes_two:
        return bool(health_check(state, draws))
    return bool(health_check(state))


def _key_fingerprint(key) -> str:
    """Stable fingerprint of a key (schedule identity for resume
    validation)."""
    words = torch.as_tensor(key).detach().cpu().to(torch.int64).numpy()
    data = words.astype(np.uint32).tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def _state_fingerprint(state) -> str:
    """Fingerprint of the state's STRUCTURE (pytree spec + leaf shapes and
    dtypes). Leaf values are not hashed: the state evolves across
    segments; its structure must not."""
    leaves, spec = pytree.tree_flatten(state)
    desc = repr(spec) + "|" + ";".join(
        f"{tuple(torch.as_tensor(x).shape)}:{torch.as_tensor(x).dtype}"
        for x in leaves)
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


def _atomic_save(path: str, tree) -> None:
    tmp = path + ".tmp.npz"
    save_pytree(tmp, tree)
    os.replace(tmp, path)


def _meta_path(workdir):
    return os.path.join(workdir, "meta.json")


def _state_path(workdir):
    return os.path.join(workdir, "state.npz")


def _draws_path(workdir, seg):
    return os.path.join(workdir, f"draws_{seg:06d}.npz")


def resumable_run(workdir: str, key, segment_fn: Callable, state0,
                  num_segments: int,
                  health_check: Optional[Callable] = None,
                  max_retries: int = 2, verbose: bool = False):
    """Run ``num_segments`` segments of ``segment_fn``, checkpointing after
    each; resume automatically from ``workdir`` if a previous run died.

    Returns ``(state, draws, info)`` where ``draws`` is the pytree of all
    segments' draws concatenated on axis 0 and ``info`` records resumes
    and retries. For a given ``(key, state0, segment_fn, num_segments)``
    the result is identical whether or not the process died in between.
    The base key and the state's structure are fingerprinted into
    ``meta.json``; a run with another key or state structure pointed at an
    existing workdir is refused (``segment_fn`` itself cannot be
    fingerprinted: changing it between runs is the caller's
    responsibility).

    ``health_check(state, draws) -> bool`` validates both the carried
    state and the segment's draws (default: every floating leaf finite);
    single-argument ``health_check(state)`` functions keep working.
    """
    os.makedirs(workdir, exist_ok=True)
    health_check = health_check or _all_finite
    meta_p = _meta_path(workdir)
    key_fp = _key_fingerprint(key)
    state_fp = _state_fingerprint(state0)

    start_seg, resumed = 0, False
    state = state0
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            meta = json.load(f)
        if meta["num_segments"] != num_segments:
            raise ValueError(
                f"workdir {workdir!r} holds a run with "
                f"{meta['num_segments']} segments; this run asked for "
                f"{num_segments} (use a fresh workdir)")
        for name, got, want in (("base key", meta.get("key_fp", key_fp),
                                 key_fp),
                                ("state0 structure",
                                 meta.get("state_fp", state_fp), state_fp)):
            if got != want:
                raise ValueError(
                    f"workdir {workdir!r} holds a run with a different "
                    f"{name} (checkpoint fingerprint {got}, this run "
                    f"{want}); resuming would silently continue the old "
                    "checkpoint under a new schedule — use a fresh workdir")
        if os.path.exists(_state_path(workdir)):
            # the segment index lives inside the state checkpoint (one
            # atomic file), so a crash between two writes cannot re-apply
            # a segment to an already advanced state
            ckpt = restore_pytree(
                _state_path(workdir),
                {"next_segment": np.asarray(0), "state": state0})
            start_seg = int(ckpt["next_segment"])
            state = ckpt["state"]
            resumed = True
            if verbose:
                print(f"[resumable] resuming at segment {start_seg}")

    retries_done = []
    draws = None
    for seg in range(start_seg, num_segments):
        for retry in range(max_retries + 1):
            k_seg = random.fold_in(
                key, seg + (retry * RETRY_STRIDE if retry else 0))
            new_state, draws = segment_fn(k_seg, state)
            if _call_health_check(health_check, new_state, draws):
                break
            if verbose:
                print(f"[resumable] segment {seg} failed health check "
                      f"(retry {retry}) — rolling back with fresh "
                      "randomness")
            retries_done.append((seg, retry))
        else:
            raise RuntimeError(
                f"segment {seg} failed its health check {max_retries + 1} "
                "times — deterministic failure; inspect "
                f"{_state_path(workdir)}")
        state = new_state
        # draws first (a crash before the state checkpoint re-runs the
        # segment and rewrites identical draws), then the single atomic
        # state+index checkpoint
        _atomic_save(_draws_path(workdir, seg), draws)
        _atomic_save(_state_path(workdir),
                     {"next_segment": np.asarray(seg + 1), "state": state})
        with open(meta_p + ".tmp", "w") as f:
            json.dump({"num_segments": num_segments, "key_fp": key_fp,
                       "state_fp": state_fp}, f)
        os.replace(meta_p + ".tmp", meta_p)

    # assemble all segments' draws (template from the last one)
    draws_tmpl = draws
    if draws_tmpl is None:      # fully-resumed no-op run: load one
        draws_tmpl = _load_draws(workdir, num_segments - 1, None)
    per_seg = [_load_draws(workdir, s, draws_tmpl)
               for s in range(num_segments)]
    all_draws = pytree.tree_map(lambda *xs: torch.cat(xs, dim=0), *per_seg)
    info = dict(resumed=resumed, start_segment=start_seg,
                retries=retries_done)
    return state, all_draws, info


def _load_draws(workdir, seg, template):
    path = _draws_path(workdir, seg)
    if template is None:
        # the no-op-resume path has no template: a single tensor rebuilds
        # from the file itself
        with np.load(path, allow_pickle=True) as data:
            keys = list(data["__keys__"])
            leaves = [torch.as_tensor(data[f"leaf_{i}"])
                      for i in range(len(keys))]
        if keys == ["__root__"]:
            return leaves[0]
        raise ValueError(
            "resuming a fully-completed run with structured draws needs "
            "the same segment_fn to rebuild the template; run with at "
            "least one remaining segment or keep draws as a single array")
    return restore_pytree(path, template)
