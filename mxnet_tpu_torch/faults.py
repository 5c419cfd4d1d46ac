"""Deterministic fault injection for resilience testing (counterpart of
``mxnet_tpu/faults.py``).

Tests (and operators, through an environment variable) arm named
injection points that the runtime consults on its hot paths.  A disarmed
point costs one check of an empty registry, so the hooks stay in the
production paths.

The point names are the JAX package's.  The port consults these:

=========================  ==================================================
point                      effect when it fires
=========================  ==================================================
``serving.dispatch``       the Nth batched serving dispatch dies before the
                           device call: every request of that batch gets the
                           error, the batcher worker survives
``serving.model.write``    the Nth ``serving.save_model`` publish dies with
                           the manifest half-written (truncated, never
                           renamed): the previous version stays whole
``serving.decode``         the Nth continuous-batching decode STEP dies
                           before the device call: every session the engine
                           holds gets the error (or migrates, under a pool),
                           the slot state restarts clean, the worker survives
``serving.replica.kill``   the Nth decode step HARD-KILLS its engine: the
                           engine closes for good (its worker exits, submits
                           fail fast, ``rewarm`` refuses) and every session
                           it holds goes down the pool's migration path
=========================  ==================================================

The JAX package's other points (``fit.batch``, ``fit.preempt``,
``fit.wedge``, ``checkpoint.write``, ``recordio.read``,
``compile_cache.read``, ``audit.bitflip``, ``kvstore.push.socket``,
``kvstore.membership``, ``elastic.reshard``) have no site in the port
yet: arming one raises "not ported yet" rather than accepting a point
that would never fire.

Arming — programmatic::

    from mxnet_tpu_torch import faults
    faults.arm("serving.replica.kill", at=3)   # fire on the 3rd hit
    faults.arm("serving.decode", at=2, count=2)  # hits 2 and 3
    ...
    faults.disarm()                            # clear everything

or through the environment (read by any process)::

    MXNET_FAULT_SPEC="serving.decode:at=3;serving.dispatch:at=2,count=2"

Spec grammar: ``point[:key=value[,key=value...]]`` joined by ``;``.  Keys:
``at`` (1-based hit index of the first firing, default 1) and ``count``
(consecutive firings, default 1; ``count=-1`` fires on every hit from
``at`` on).  Hit counting is per process, across threads and engines, and
deterministic: a failing fault test replays exactly.
"""

from __future__ import annotations

import os
import threading

from . import telemetry as _telemetry
from .base import MXNetError

__all__ = ["POINTS", "PORTED", "FaultInjected", "arm", "disarm", "armed",
           "should_fire", "hits", "reset_counters", "parse_spec"]

#: every injection point the JAX package names (a name outside this list
#: is a typo and fails as such)
POINTS = ("kvstore.push.socket", "checkpoint.write", "fit.batch",
          "recordio.read", "serving.dispatch", "serving.model.write",
          "fit.preempt", "compile_cache.read", "serving.decode",
          "kvstore.membership", "elastic.reshard",
          "serving.replica.kill", "fit.wedge", "audit.bitflip")

#: the points the port consults; arming any other point of ``POINTS``
#: raises "not ported yet"
PORTED = ("serving.dispatch", "serving.model.write", "serving.decode",
          "serving.replica.kill")


class FaultInjected(MXNetError):
    """Raised by call sites that surface an armed fault as an error."""


class _Point:
    __slots__ = ("at", "count", "hits")

    def __init__(self, at=1, count=1):
        if at < 1:
            raise ValueError("fault 'at' is a 1-based hit index (got %d)"
                             % at)
        self.at = at
        self.count = count
        self.hits = 0


_lock = threading.Lock()
_armed = {}          # point -> _Point
_env_seen = None     # last MXNET_FAULT_SPEC value parsed (None = never)


def _check_point(point):
    if point not in POINTS:
        raise MXNetError("unknown fault point %r (valid: %s)"
                         % (point, ", ".join(POINTS)))
    if point not in PORTED:
        raise MXNetError("fault point %r is not ported yet: the port has "
                         "no site that consults it (ported: %s)"
                         % (point, ", ".join(PORTED)))


def parse_spec(spec):
    """Parse ``point:at=N,count=M;point2...`` into ``{point: (at, count)}``."""
    out = {}
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        point, _, args = part.partition(":")
        point = point.strip()
        _check_point(point)
        kw = {"at": 1, "count": 1}
        for item in args.split(","):
            item = item.strip()
            if not item:
                continue
            k, _, v = item.partition("=")
            k = k.strip()
            if k not in ("at", "count"):
                raise MXNetError("unknown fault spec key %r in %r"
                                 % (k, part))
            try:
                kw[k] = int(v)
            except ValueError:
                raise MXNetError("fault spec %r: %s must be an integer"
                                 % (part, k))
        out[point] = (kw["at"], kw["count"])
    return out


def _sync_env():
    """Re-arm from ``MXNET_FAULT_SPEC`` whenever its value changes (lock
    held).  Env-armed points replace the whole registry, so clearing the
    variable disarms them; programmatic ``arm`` calls after the last env
    change last until the env changes again."""
    global _env_seen
    spec = os.environ.get("MXNET_FAULT_SPEC", "")
    if spec == _env_seen:
        return
    _env_seen = spec
    _armed.clear()
    for point, (at, count) in parse_spec(spec).items():
        _armed[point] = _Point(at, count)


def arm(point, at=1, count=1):
    """Arm ``point`` to fire on hits ``at .. at+count-1`` (1-based);
    ``count=-1`` fires on every hit from ``at`` on.  Re-arming a point
    restarts its hit count."""
    _check_point(point)
    with _lock:
        _sync_env()
        _armed[point] = _Point(at, count)


def disarm(point=None):
    """Disarm one point, or everything (including env-armed) when None."""
    global _env_seen
    with _lock:
        if point is None:
            _armed.clear()
            # mark the current env value consumed so it does not re-arm
            _env_seen = os.environ.get("MXNET_FAULT_SPEC", "")
        else:
            _armed.pop(point, None)


def _nothing_armed():
    """Lock-free fast path: with nothing armed and no env spec, the hot
    paths do not serialize on ``_lock``."""
    return not _armed and not os.environ.get("MXNET_FAULT_SPEC")


def armed(point):
    """True when ``point`` is armed (it may or may not fire on this hit)."""
    if _nothing_armed():
        return False
    with _lock:
        _sync_env()
        return point in _armed


def should_fire(point):
    """Record one hit of ``point``; True when this hit is inside the armed
    firing window.  The one call every instrumented site makes."""
    if _nothing_armed():
        return False
    with _lock:
        _sync_env()
        st = _armed.get(point)
        if st is None:
            return False
        st.hits += 1
        if st.hits < st.at:
            return False
        fire = st.count < 0 or st.hits < st.at + st.count
    if fire:
        _telemetry.inc("resilience.fault_injected", point=point)
        _telemetry.event("fault_injected", point=point)
    return fire


def hits(point):
    """How many times ``point`` has been consulted while armed."""
    with _lock:
        st = _armed.get(point)
        return 0 if st is None else st.hits


def reset_counters():
    """Zero the hit counters of all armed points (keep them armed)."""
    with _lock:
        for st in _armed.values():
            st.hits = 0
