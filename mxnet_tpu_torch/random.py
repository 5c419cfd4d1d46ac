"""Global random state (``mx.random``), counterpart of
``mxnet_tpu/random.py``: :func:`seed`, :func:`get_state`,
:func:`set_state`.

The port draws at random in three places: the initializers, from their
default ``torch.Generator`` (``initializer.py``), ``NDArrayIter``'s
shuffle, from numpy's global generator, and the decode tier's session
seeds (:func:`next_seed`, where the JAX package takes a word of its next
key).  :func:`seed` seeds all three.  No op of the port draws at run
time: decode sampling is a counter-based hash of (seed, position).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import initializer as _init

__all__ = ["seed", "get_seed", "get_state", "set_state", "next_seed"]

_lock = threading.Lock()
_seed_value = 0
#: the decode tier's session seeds (not part of :func:`get_state`)
_session_rng = np.random.RandomState(0)


def seed(seed_state):
    """Seed the initializers' generator and numpy's global generator."""
    global _seed_value
    with _lock:
        _seed_value = int(seed_state)
        _init.seed(_seed_value)
        np.random.seed(_seed_value & 0xFFFFFFFF)
        _session_rng.seed(_seed_value & 0xFFFFFFFF)


def next_seed():
    """A 32-bit sampling seed for a decode session that was given none;
    ``seed(n)`` makes the sequence of these reproducible."""
    with _lock:
        return int(_session_rng.randint(0, 1 << 32, dtype=np.uint64))


def get_seed():
    """The last value passed to :func:`seed` (0 before any call)."""
    return _seed_value


def get_state():
    """JSON-able state of both generators, for an exact mid-epoch
    resume: a resumed run draws what an uninterrupted one would."""
    with _lock:
        gen = _init._default_gen.get_state().tolist()
        seed_value = _seed_value
    kind, keys, pos, has_gauss, cached = np.random.get_state()
    return {"seed": seed_value, "init_generator": gen,
            "np_state": {"kind": kind, "keys": keys.tolist(), "pos": pos,
                         "has_gauss": has_gauss, "cached": cached}}


def set_state(state):
    """Inverse of :func:`get_state`."""
    global _seed_value
    with _lock:
        _seed_value = int(state.get("seed", 0))
        gen = state.get("init_generator")
        if gen is not None:
            _init._default_gen.set_state(torch.tensor(gen, dtype=torch.uint8))
    nps = state.get("np_state")
    if nps:
        np.random.set_state((nps["kind"], np.asarray(nps["keys"], np.uint32),
                             int(nps["pos"]), int(nps["has_gauss"]),
                             float(nps["cached"])))
