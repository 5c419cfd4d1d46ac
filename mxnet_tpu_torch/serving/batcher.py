"""Dynamic micro-batcher — server-side request coalescing (counterpart of
``mxnet_tpu/serving/batcher.py``).

Concurrent requests queue into one worker that coalesces up to
``max(buckets)`` rows, or ``batch_timeout_us`` of waiting, into ONE padded
device dispatch; the coalesced batch pads up to the nearest declared
bucket, so the predictor's shape-keyed executor cache sees only
``len(buckets)`` shapes.  Load discipline: a request whose deadline passes
while it waits is shed with :class:`DeadlineExceeded`; a submit that would
push the queue past ``max_queue_depth`` rows fails fast with
:class:`Overloaded`.  A dispatch that raises (the ``serving.dispatch``
fault point included) fails its own batch; the worker serves on.

Telemetry (labels ``model=<name>``): ``serving.request.count``,
``serving.shed.count{reason=...}``, ``serving.queue.depth``,
``serving.batch.size``, ``serving.batch.latency_seconds``,
``serving.request.latency_seconds``, ``serving.dispatch.count``.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from .. import faults as _faults
from .. import telemetry as _telemetry
from ..base import MXNetError

__all__ = ["Overloaded", "DeadlineExceeded", "InvalidRequest", "Future",
           "DynamicBatcher", "LATENCY_BUCKETS", "BATCH_SIZE_BUCKETS"]

#: histogram bounds for serving latencies (seconds)
LATENCY_BUCKETS = (0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
#: histogram bounds for coalesced batch sizes (rows)
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class Overloaded(MXNetError):
    """Admission-control fast-fail: the queue is past its depth bound."""


class DeadlineExceeded(MXNetError):
    """The request's deadline expired before its batch dispatched, or a
    ``Future.result(timeout)`` wait ran out."""


class InvalidRequest(MXNetError):
    """The client's request is malformed (wrong feature dims, row count
    outside 1..max_batch_size, a scalar)."""


class Future:
    """Single-shot result holder for one queued request."""

    __slots__ = ("_ev", "_value", "_error", "_cancelled")

    def __init__(self):
        self._ev = threading.Event()
        self._value = None
        self._error = None
        self._cancelled = False

    def set_result(self, value):
        self._value = value
        self._ev.set()

    def set_error(self, exc):
        self._error = exc
        self._ev.set()

    def done(self):
        return self._ev.is_set()

    def cancel(self):
        """Mark the request abandoned: the worker drops it before dispatch.
        False when the result already landed."""
        if self._ev.is_set():
            return False
        self._cancelled = True
        return True

    def cancelled(self):
        return self._cancelled

    def result(self, timeout=None):
        if not self._ev.wait(timeout):
            raise DeadlineExceeded("no result within %ss" % timeout)
        if self._error is not None:
            raise self._error
        return self._value


class _Request:
    __slots__ = ("data", "n", "deadline", "future", "t_submit")

    def __init__(self, data, n, deadline):
        self.data = data
        self.n = n
        self.deadline = deadline
        self.future = Future()
        self.t_submit = time.monotonic()


class DynamicBatcher:
    """Coalesce concurrent requests into bucket-padded device dispatches.

    ``dispatch_fn(rows)`` runs one device dispatch on a ``(bucket,
    *feature)`` float32 batch (real rows first, zero padding after) and
    returns an array, or a tuple of arrays, whose leading axis is aligned
    with the rows.
    """

    def __init__(self, dispatch_fn, buckets=(1, 8, 32),
                 batch_timeout_us=2000, max_queue_depth=128, name="model",
                 feature_shape=None):
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets or buckets[0] < 1:
            raise MXNetError("batcher needs >=1 positive batch bucket, "
                             "got %r" % (buckets,))
        self._dispatch_fn = dispatch_fn
        self.feature_shape = None if feature_shape is None \
            else tuple(feature_shape)
        self.buckets = buckets
        self.max_batch_size = buckets[-1]
        self.batch_timeout = batch_timeout_us / 1e6
        self.max_queue_depth = int(max_queue_depth)
        self.name = name
        self._queue = deque()
        self._depth = 0  # queued rows (admission unit)
        self._inflight_rows = 0
        self._cond = threading.Condition(threading.Lock())
        self._thread = None
        self._running = False
        self._closed = False
        #: total device dispatches
        self.dispatches = 0
        _telemetry.inc("serving.request.count", 0, model=name)
        for reason in ("overload", "deadline", "abandoned"):
            _telemetry.inc("serving.shed.count", 0, model=name,
                           reason=reason)
        _telemetry.inc("serving.dispatch.count", 0, model=name)
        _telemetry.set_gauge("serving.queue.depth", 0, model=name)

    # -- client side -------------------------------------------------------
    def submit(self, data, deadline_ms=None):
        """Queue ``data`` (rows along axis 0); returns its :class:`Future`.
        Raises :class:`Overloaded` past the admission bound."""
        data = np.asarray(data, np.float32)
        if data.ndim == 0:
            raise InvalidRequest("batcher requests are row batches; got "
                                 "a scalar")
        n = int(data.shape[0])
        if not 1 <= n <= self.max_batch_size:
            raise InvalidRequest(
                "request of %d rows outside 1..max_batch_size=%d (split "
                "oversized requests client-side)" % (n, self.max_batch_size))
        if self.feature_shape is not None \
                and tuple(data.shape[1:]) != self.feature_shape:
            raise InvalidRequest("request rows shaped %s, model %r serves %s"
                                 % (tuple(data.shape[1:]), self.name,
                                    self.feature_shape))
        deadline = None if deadline_ms is None \
            else time.monotonic() + float(deadline_ms) / 1e3
        req = _Request(data, n, deadline)
        with self._cond:
            if self._closed:
                raise MXNetError("serving %r is closed" % self.name)
            _telemetry.inc("serving.request.count", model=self.name)
            if self._depth + n > self.max_queue_depth:
                _telemetry.inc("serving.shed.count", model=self.name,
                               reason="overload")
                raise Overloaded(
                    "serving %r overloaded: queue %d rows + %d > bound %d"
                    % (self.name, self._depth, n, self.max_queue_depth))
            self._queue.append(req)
            self._depth += n
            _telemetry.set_gauge("serving.queue.depth", self._depth,
                                 model=self.name)
            self._cond.notify()
        return req.future

    #: default bound on blocking waits, so a forgotten ``start`` surfaces
    #: as a typed timeout instead of a silent hang
    DEFAULT_TIMEOUT = 60.0

    def predict(self, data, deadline_ms=None, timeout=DEFAULT_TIMEOUT):
        """``submit`` + ``Future.result``; a wait that times out cancels
        the request."""
        fut = self.submit(data, deadline_ms=deadline_ms)
        try:
            return fut.result(timeout)
        except DeadlineExceeded:
            fut.cancel()
            raise

    # -- worker side -------------------------------------------------------
    def start(self):
        """Start the coalescing worker thread (idempotent)."""
        with self._cond:
            if self._thread is not None:
                return self
            self._running = True
            self._thread = threading.Thread(
                target=self._serve_loop, name="batcher-%s" % self.name,
                daemon=True)
            self._thread.start()
        return self

    def stop(self, drain=True):
        """Stop the worker; ``drain`` dispatches what is still queued,
        else pending futures fail with :class:`MXNetError`."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30)
        while True:
            batch = self._next_batch(block=False)
            if not batch:
                break
            try:
                if drain:
                    self._dispatch(batch)
                else:
                    err = MXNetError("serving %r stopped before dispatch"
                                     % self.name)
                    for r in batch:
                        r.future.set_error(err)
            finally:
                with self._cond:
                    self._inflight_rows = 0
                    self._cond.notify_all()

    def close(self, drain=True):
        """Permanent :meth:`stop`: further submits fail fast."""
        with self._cond:
            self._closed = True
        self.stop(drain=drain)

    def bucket_for(self, n):
        """Smallest declared bucket that fits ``n`` rows."""
        for b in self.buckets:
            if n <= b:
                return b
        raise MXNetError("batch of %d rows exceeds max bucket %d"
                         % (n, self.max_batch_size))

    def pending_rows(self):
        """Rows queued plus rows inside the current dispatch."""
        with self._cond:
            return self._depth + self._inflight_rows

    def _serve_loop(self):
        while True:
            with self._cond:
                if not self._running:
                    return
            batch = self._next_batch(block=True)
            if batch:
                try:
                    self._dispatch(batch)
                finally:
                    with self._cond:
                        self._inflight_rows = 0
                        self._cond.notify_all()

    def _next_batch(self, block):
        """Pop a coalesced run of requests: flush at ``max_batch_size``
        rows, else ``batch_timeout`` after the first one was picked up.
        Abandoned requests at the queue head are shed here."""
        with self._cond:
            while block and self._running and not self._queue:
                self._cond.wait(0.05)
            dropped = 0
            while self._queue and self._queue[0].future.cancelled():
                req = self._queue.popleft()
                self._depth -= req.n
                dropped += 1
                _telemetry.inc("serving.shed.count", model=self.name,
                               reason="abandoned")
            if dropped:
                _telemetry.set_gauge("serving.queue.depth", self._depth,
                                     model=self.name)
            if not self._queue:
                return []
            batch = [self._queue.popleft()]
            rows = batch[0].n
            flush_at = time.monotonic() + self.batch_timeout
            while rows < self.max_batch_size:
                if self._queue:
                    if rows + self._queue[0].n > self.max_batch_size:
                        break  # head-of-line: goes in the next batch
                    req = self._queue.popleft()
                    batch.append(req)
                    rows += req.n
                    continue
                remaining = flush_at - time.monotonic()
                if remaining <= 0 or not block or not self._running:
                    break
                self._cond.wait(min(remaining, 0.05))
            self._depth -= rows
            self._inflight_rows = rows
            _telemetry.set_gauge("serving.queue.depth", self._depth,
                                 model=self.name)
            return batch

    def _dispatch(self, batch):
        now = time.monotonic()
        live = []
        for r in batch:
            if r.future.cancelled():
                _telemetry.inc("serving.shed.count", model=self.name,
                               reason="abandoned")
            elif r.deadline is not None and now > r.deadline:
                _telemetry.inc("serving.shed.count", model=self.name,
                               reason="deadline")
                r.future.set_error(DeadlineExceeded(
                    "deadline expired %.1fms before dispatch"
                    % ((now - r.deadline) * 1e3)))
            else:
                live.append(r)
        if not live:
            return
        t0 = time.monotonic()
        try:
            # assembly is inside the guard: a poison request fails ITS
            # batch, never the worker thread
            n = sum(r.n for r in live)
            bucket = self.bucket_for(n)
            rows = live[0].data if len(live) == 1 \
                else np.concatenate([r.data for r in live], axis=0)
            if bucket > n:
                rows = np.concatenate(
                    [rows, np.zeros((bucket - n,) + rows.shape[1:],
                                    rows.dtype)], axis=0)
                _telemetry.inc("serving.batch.padded_rows", bucket - n,
                               model=self.name)
            _telemetry.observe("serving.batch.size", n,
                               buckets=BATCH_SIZE_BUCKETS, model=self.name)
            if _faults.should_fire("serving.dispatch"):
                raise _faults.FaultInjected(
                    "fault 'serving.dispatch': device dispatch of model "
                    "%r killed" % self.name)
            outs = self._dispatch_fn(rows)
            outs = [np.asarray(o) for o in
                    (outs if isinstance(outs, (list, tuple)) else [outs])]
            results = []
            off = 0
            for r in live:
                sl = [o[off:off + r.n] for o in outs]
                results.append(sl[0] if len(sl) == 1 else sl)
                off += r.n
        except Exception as e:  # noqa: BLE001 - fails this batch only
            _telemetry.inc("serving.error.count", model=self.name)
            for r in live:
                r.future.set_error(e)
            return
        self.dispatches += 1
        _telemetry.inc("serving.dispatch.count", model=self.name)
        _telemetry.observe("serving.batch.latency_seconds",
                           time.monotonic() - t0, buckets=LATENCY_BUCKETS,
                           model=self.name)
        done_t = time.monotonic()
        for r, res in zip(live, results):
            r.future.set_result(res)
            _telemetry.observe("serving.request.latency_seconds",
                               done_t - r.t_submit,
                               buckets=LATENCY_BUCKETS, model=self.name)
