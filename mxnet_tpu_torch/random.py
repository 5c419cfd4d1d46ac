"""Global random state (``mx.random``), counterpart of
``mxnet_tpu/random.py``: :func:`seed`, :func:`get_state`,
:func:`set_state`, and :func:`generator`, the run-time generator of a
device.

The port draws at random in four places: the initializers, from their
default ``torch.Generator`` (``initializer.py``); the ops that draw at
run time (``Dropout``, ``ZoneoutCell``'s masks through it, and the
``RNN`` op's dropout between layers), from one ``torch.Generator`` per
device (:func:`generator`); ``NDArrayIter``'s shuffle, from numpy's
global generator; and the decode tier's session seeds (:func:`next_seed`,
where the JAX package takes a word of its next key).  :func:`seed` seeds
all four; :func:`get_state`/:func:`set_state` carry all but the session
seeds (the run-time generators of every device, CPU and CUDA), so a fit
resumed from a snapshot draws the masks an uninterrupted one would.  The
masks are the port's own: they never match the JAX package's threefry
draws.  Decode sampling is a counter-based hash of (seed, position) and
draws from none of these.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import initializer as _init

__all__ = ["seed", "get_seed", "get_state", "set_state", "next_seed",
           "generator"]

_lock = threading.Lock()
_seed_value = 0
#: the decode tier's session seeds (not part of :func:`get_state`)
_session_rng = np.random.RandomState(0)
#: the run-time generators, by device name ("cpu", "cuda:0")
_op_gens = {}


def _op_seed(value):
    """The run-time generators' seed for ``seed(value)``: another stream
    than the initializers' generator, which ``value`` seeds directly."""
    return (int(value) * 0x9E3779B97F4A7C15 + 1) & 0xFFFFFFFFFFFFFFFF


def _device_key(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def generator(device):
    """The generator the ops that draw use on ``device``, made on first
    use and seeded from the last :func:`seed` (0 before any call)."""
    key = _device_key(device)
    with _lock:
        gen = _op_gens.get(key)
        if gen is None:
            gen = torch.Generator(device=key)
            gen.manual_seed(_op_seed(_seed_value))
            _op_gens[key] = gen
    return gen


def seed(seed_state):
    """Seed the initializers' generator, every run-time generator, numpy's
    global generator and the session seeds."""
    global _seed_value
    with _lock:
        _seed_value = int(seed_state)
        _init.seed(_seed_value)
        for gen in _op_gens.values():
            gen.manual_seed(_op_seed(_seed_value))
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
    """JSON-able state of the generators, for an exact mid-epoch resume:
    a resumed run draws what an uninterrupted one would."""
    with _lock:
        gen = _init._default_gen.get_state().tolist()
        ops = {k: g.get_state().tolist() for k, g in _op_gens.items()}
        seed_value = _seed_value
    kind, keys, pos, has_gauss, cached = np.random.get_state()
    return {"seed": seed_value, "init_generator": gen, "op_generators": ops,
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
        ops = state.get("op_generators") or {}
        for key, gen in _op_gens.items():
            if key not in ops:  # not drawn from when the state was taken
                gen.manual_seed(_op_seed(_seed_value))
        for key, st in ops.items():
            if key.startswith("cuda") and not torch.cuda.is_available():
                continue  # a card's stream, read where there is none
            gen = _op_gens.get(key)
            if gen is None:
                gen = _op_gens[key] = torch.Generator(device=key)
            gen.set_state(torch.tensor(st, dtype=torch.uint8))
    nps = state.get("np_state")
    if nps:
        np.random.set_state((nps["kind"], np.asarray(nps["keys"], np.uint32),
                             int(nps["pos"]), int(nps["has_gauss"]),
                             float(nps["cached"])))
