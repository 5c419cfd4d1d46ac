"""Telemetry — the process-wide metrics registry and event log, the
subset of ``mxnet_tpu/telemetry.py`` the serving path and the decode tier
call, with the Prometheus exposition ``GET /metrics`` serves.

Same metric names as the JAX package (``serving.request.latency_seconds``,
``serving.dispatch.count``, ``predict.cache.*``, ...).  Off by default:
every recording call checks one module-level boolean first, so a disabled
call is one early-returning function call.  Enable with
``MXNET_TELEMETRY=1`` or :func:`enable`.
"""

from __future__ import annotations

import bisect
import os
import re
import threading
import time
from collections import deque

__all__ = ["enabled", "enable", "disable", "reset", "inc", "set_gauge",
           "observe", "event", "snapshot", "prometheus_text",
           "counter_total", "gauge_value", "hist_quantile", "hist_state",
           "quantile_from_counts", "events_recent"]

#: default histogram bucket upper bounds (seconds)
DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 60.0)

_lock = threading.Lock()
_counters = {}   # (name, labels) -> float
_gauges = {}     # (name, labels) -> float
_hists = {}      # (name, labels) -> _Histogram
_events = deque(maxlen=10000)

_enabled = os.environ.get("MXNET_TELEMETRY", "0") not in ("0", "", "false")


#: counter keys declared at zero (``inc(name, 0)``), re-seeded by an
#: enabled :func:`reset`
_declared = set()


def enabled():
    """True when the registry records."""
    return _enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def reset():
    """Clear all metrics and events (enablement is unchanged).  While
    enabled, counters declared at zero are re-seeded rather than dropped."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _events.clear()
        if _enabled:
            for k in _declared:
                _counters[k] = 0


def _key(name, labels):
    if not labels:
        return (name, ())
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


def inc(name, value=1, **labels):
    """Add ``value`` to counter ``name`` (``inc(name, 0)`` declares it)."""
    if not _enabled:
        return
    k = _key(name, labels)
    with _lock:
        if value == 0:
            _declared.add(k)
        _counters[k] = _counters.get(k, 0) + value


def set_gauge(name, value, **labels):
    if not _enabled:
        return
    with _lock:
        _gauges[_key(name, labels)] = value


class _Histogram:
    __slots__ = ("buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, buckets):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +1: overflow
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v):
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)


def observe(name, value, buckets=None, **labels):
    """Record ``value`` into histogram ``name`` (bounds fixed by the first
    observation)."""
    if not _enabled:
        return
    k = _key(name, labels)
    with _lock:
        h = _hists.get(k)
        if h is None:
            h = _hists[k] = _Histogram(buckets or DEFAULT_BUCKETS)
        h.observe(value)


def event(name, **fields):
    if not _enabled:
        return
    rec = {"ts": round(time.time(), 6), "event": name}
    rec.update(fields)
    with _lock:
        _events.append(rec)


def events_recent(n=100):
    """The newest ``n`` structured events (copies)."""
    with _lock:
        return [dict(r) for r in list(_events)[-int(n):]]


def counter_total(name):
    """Sum of counter ``name`` across all label sets (0 when absent)."""
    with _lock:
        return sum(v for (n, _), v in _counters.items() if n == name)


def gauge_value(name, **labels):
    """Current value of gauge ``name`` (None when unset)."""
    with _lock:
        return _gauges.get(_key(name, labels))


def hist_quantile(name, q, **labels):
    """Estimate the ``q``-quantile of histogram ``name`` from its bucket
    counts (linear inside the target bucket, capped by the observed
    min/max); None when unobserved."""
    with _lock:
        h = _hists.get(_key(name, labels))
        if h is None or h.count == 0:
            return None
        target = q * h.count
        acc = 0
        lo = h.min
        for b, c in zip(h.buckets, h.counts):
            if acc + c >= target:
                if c == 0:
                    return min(lo, h.max)
                frac = (target - acc) / c
                return min(lo + (min(b, h.max) - lo) * max(0.0, frac),
                           h.max)
            acc += c
            lo = max(lo, b)
        return h.max



def hist_state(name, **labels):
    """Raw histogram state (bounds, per-bucket counts with the overflow
    bucket last, count, sum, min, max), or None when unobserved."""
    with _lock:
        h = _hists.get(_key(name, labels))
        if h is None:
            return None
        return {"buckets": tuple(h.buckets), "counts": list(h.counts),
                "count": h.count, "sum": h.sum, "min": h.min, "max": h.max}


def quantile_from_counts(buckets, counts, q, lo=None, hi=None):
    """:func:`hist_quantile`'s estimator over caller-supplied bucket counts
    (the delta of two :func:`hist_state` reads: the fleet controller's
    windowed TTFT p99).  ``lo`` / ``hi`` cap the first and the overflow
    bucket as the observed min/max do; they default to 0 and the last
    finite bound.  None when the counts are empty."""
    total = sum(counts)
    if total <= 0:
        return None
    lo = 0.0 if lo is None else float(lo)
    hi = float(buckets[-1]) if hi is None else float(hi)
    target = q * total
    acc = 0
    cur = lo
    for b, c in zip(buckets, counts):
        if acc + c >= target:
            if c == 0:
                return min(cur, hi)
            frac = (target - acc) / c
            return min(cur + (min(b, hi) - cur) * max(0.0, frac), hi)
        acc += c
        cur = max(cur, b)
    return hi  # the overflow bucket: capped at hi


def _label_str(labels):
    return ",".join("%s=%s" % kv for kv in labels)


def _hist_dict(h):
    cum, acc = {}, 0
    for b, c in zip(h.buckets, h.counts):
        acc += c
        cum["%g" % b] = acc
    cum["+Inf"] = acc + h.counts[-1]
    return {"count": h.count, "sum": h.sum, "min": h.min, "max": h.max,
            "mean": (h.sum / h.count) if h.count else 0.0, "buckets": cum}


def snapshot():
    """The whole registry as a nested dict: ``{enabled, counters: {name:
    {labels: v}}, gauges, histograms: {name: {labels: {count, sum, min,
    max, mean, buckets}}}, events: {count, recent}}``."""
    with _lock:
        counters, gauges, hists = {}, {}, {}
        for (n, labels), v in sorted(_counters.items()):
            counters.setdefault(n, {})[_label_str(labels)] = v
        for (n, labels), v in sorted(_gauges.items()):
            gauges.setdefault(n, {})[_label_str(labels)] = v
        for (n, labels), h in sorted(_hists.items()):
            hists.setdefault(n, {})[_label_str(labels)] = _hist_dict(h)
        return {"enabled": _enabled, "counters": counters, "gauges": gauges,
                "histograms": hists,
                "events": {"count": len(_events),
                           "recent": list(_events)[-100:]}}


def _prom_name(name):
    s = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    return s if s.startswith("mxnet_") else "mxnet_" + s


def _prom_esc(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _prom_labels(labels, extra=()):
    items = list(labels) + list(extra)
    if not items:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, _prom_esc(v))
                             for k, v in items)


def _prom_num(v):
    v = float(v)
    return "%d" % int(v) if v.is_integer() else repr(v)


def _parse_label_str(s):
    """Invert :func:`_label_str`: ``"a=1,b=x"`` -> ``[("a", "1"), ("b",
    "x")]``."""
    if not s:
        return []
    out = []
    for part in s.split(","):
        k, _, v = part.partition("=")
        out.append((k, v))
    return out


def _bucket_order(bound):
    return float("inf") if bound == "+Inf" else float(bound)


def prometheus_text(snap=None):
    """The registry (or a :func:`snapshot`-shaped dict) in Prometheus
    text-exposition format: counter, gauge and histogram types,
    cumulative ``le`` buckets, ``mxnet_``-prefixed names."""
    if snap is None:
        snap = snapshot()
    lines = []
    for kind, store in (("counter", snap.get("counters", {})),
                        ("gauge", snap.get("gauges", {}))):
        for name in sorted(store):
            pname = _prom_name(name)
            lines.append("# TYPE %s %s" % (pname, kind))
            for lstr in sorted(store[name]):
                lines.append("%s%s %s" % (
                    pname, _prom_labels(_parse_label_str(lstr)),
                    _prom_num(store[name][lstr])))
    for name in sorted(snap.get("histograms", {})):
        pname = _prom_name(name)
        lines.append("# TYPE %s histogram" % pname)
        for lstr in sorted(snap["histograms"][name]):
            h = snap["histograms"][name][lstr]
            labels = _parse_label_str(lstr)
            for b in sorted(h["buckets"], key=_bucket_order):
                lines.append("%s_bucket%s %d" % (
                    pname, _prom_labels(labels, [("le", b)]),
                    h["buckets"][b]))
            lines.append("%s_sum%s %s" % (pname, _prom_labels(labels),
                                          _prom_num(h["sum"])))
            lines.append("%s_count%s %d" % (pname, _prom_labels(labels),
                                            h["count"]))
    return "\n".join(lines) + "\n"
