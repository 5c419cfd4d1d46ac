"""Serving frontends: in-process handle + stdlib HTTP/JSON endpoint
(counterpart of ``mxnet_tpu/serving/frontend.py``).

:class:`ServingHandle` is the in-process surface (what an embedding
application calls).  :class:`ServingHTTPServer` exposes the same registry
over ``http.server`` with these routes:

* ``POST /predict`` — ``{"model": name, "data": nested-list,
  "deadline_ms": optional}`` → ``{"model", "version", "shape",
  "output"}``; typed failures map to HTTP: :class:`Overloaded` → 429,
  :class:`DeadlineExceeded` → 504, :class:`UnknownModel` → 404.
* ``POST /generate`` — autoregressive decode through a
  :class:`~mxnet_tpu_torch.serving.pool.ReplicaPool` /
  :class:`~mxnet_tpu_torch.serving.decode.DecodeEngine` servable:
  ``{"model", "prompt": [token ids], "max_new_tokens", "temperature",
  "stream", "tenant", "priority", "deadline_ms"}``.  With ``"stream":
  true`` the response is ``Transfer-Encoding: chunked`` ndjson — one
  ``{"token": id}`` line per generated token as it lands, an
  ``{"event": "failover", ...}`` line wherever the pool migrated the
  session to another replica mid-generation (the token stream itself
  is seamless: no token is repeated or lost across the boundary), then
  a ``{"done": true, "tokens": [...], "ttft_ms": ..., "migrations":
  n}`` summary line; without it, one JSON document after the sequence
  finishes.  Optional ``"seed"`` pins the sampling stream (temperature
  replays are identical for the same seed).
* ``GET /models`` — every loaded servable's card (name, version,
  buckets, replica states, warm-up status).
* ``GET /healthz`` — liveness + model/version table + per-model detail
  and the paged pools' KV occupancy.
* ``GET /fleet`` — the attached
  :class:`~mxnet_tpu_torch.serving.controller.FleetController`'s card
  (running, ticks, per-model quarantine/restart/shedding state, the
  device fleet's loads and placements, the last decisions); 404 only
  without a controller.  ``/healthz`` then carries a ``fleet`` summary
  block.
* ``GET /metrics`` — the process-wide telemetry registry in Prometheus
  text exposition (``telemetry.prometheus_text``).
* ``GET /trace/<id>`` — 404: request tracing is not ported yet.
"""

from __future__ import annotations

import json
import logging
import os
import queue as _queue
import signal as _signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import telemetry as _telemetry
from ..base import MXNetError
from .batcher import (DeadlineExceeded, DynamicBatcher, InvalidRequest,
                      Overloaded)
from .registry import UnknownModel

__all__ = ["ServingHandle", "ServingHTTPServer"]

_log = logging.getLogger("mxnet_tpu_torch.serving")


class ServingHandle:
    """In-process serving facade over a
    :class:`~mxnet_tpu_torch.serving.registry.ModelRegistry`."""

    def __init__(self, registry):
        self.registry = registry

    def predict(self, model, data, deadline_ms=None,
                timeout=DynamicBatcher.DEFAULT_TIMEOUT):
        return self.registry.get(model).predict(
            data, deadline_ms=deadline_ms, timeout=timeout)

    @staticmethod
    def start_session(servable, prompt, tenant=None, priority=5, **kw):
        """Start one generation on an already-resolved servable; the
        ONE pool-vs-engine dispatch point the HTTP handler and
        :meth:`generate` both use.  A pool's session surface is
        ``generate()`` and takes tenant/priority; a bare engine's is
        ``submit()`` (its ``generate()`` is the blocking convenience)
        and tenant/priority are dropped — there is no pool admission
        layer to enforce them."""
        if hasattr(servable, "replicas"):
            return servable.generate(prompt, tenant=tenant,
                                     priority=priority, **kw)
        gen = getattr(servable, "submit", None) \
            if hasattr(servable, "slots") else None
        if gen is None:
            raise InvalidRequest(
                "model %r serves /predict, not /generate"
                % getattr(servable, "name", "?"))
        return gen(prompt, **kw)

    def generate(self, model, prompt, **kw):
        """Route one generation request to ``model``; returns its
        session (see :meth:`start_session` for the dispatch rules)."""
        return self.start_session(self.registry.get(model), prompt, **kw)

    @staticmethod
    def _describe(m):
        desc = getattr(m, "describe", None)
        if desc is not None:
            return desc()
        return {"name": m.name, "version": m.version}

    def models_payload(self):
        """``GET /models``: every loaded servable's card."""
        return {"models": [self._describe(m)
                           for m in self.registry.models()]}

    def fleet_payload(self):
        """``GET /fleet``: the attached fleet controller's card, or
        None when the registry runs uncontrolled."""
        controller = getattr(self.registry, "controller", None)
        if controller is None:
            return None
        return controller.describe()

    def healthz(self):
        payload = {"status": "ok",
                   "models": {m.name: m.version
                              for m in self.registry.models()},
                   "detail": {m.name: self._describe(m)
                              for m in self.registry.models()}}
        # per-model KV-storage occupancy (paged decode tiers): the
        # capacity number an operator reads before anything else —
        # blocks_free hitting 0 is the "admissions will shed typed"
        # early warning
        kv = {}
        for mname, card in payload["detail"].items():
            k = card.get("kv") if isinstance(card, dict) else None
            if k:
                kv[mname] = k
        if kv:
            payload["kv"] = kv
        fleet = self.fleet_payload()
        if fleet is not None:
            # the summary an operator triages from before opening
            # /fleet: is the loop alive, who is shedding/quarantined,
            # and the last few decisions
            payload["fleet"] = {
                "running": fleet["running"], "ticks": fleet["ticks"],
                "models": fleet["models"],
                "decisions": fleet["decisions"][-5:]}
        return payload

    def pending_rows(self):
        """Rows queued or in a device dispatch across every loaded
        servable — the quiescence probe graceful drain polls.  Decode
        pools count one row per queued-or-active sequence, so drain
        waits for in-flight generations too."""
        total = 0
        for m in self.registry.models():
            fn = getattr(m, "pending_rows", None)
            if fn is not None:
                total += fn()
                continue
            batcher = getattr(m, "batcher", None)
            if batcher is not None:
                total += batcher.pending_rows()
        return total

    def metrics_text(self):
        return _telemetry.prometheus_text()


class _Handler(BaseHTTPRequestHandler):
    server_version = "mxnet-tpu-torch-serving/1.0"
    protocol_version = "HTTP/1.1"
    #: request-body cap: one request must not be able to OOM the server
    max_body_bytes = 32 << 20

    def log_message(self, fmt, *args):
        # route through logging (operators filter), never bare stdout
        _log.debug("%s %s", self.address_string(), fmt % args)

    def _send(self, code, payload, content_type="application/json"):
        body = payload if isinstance(payload, bytes) \
            else json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _count(self):
        # label cardinality stays bounded: scanner/bot paths must not
        # mint one permanent counter entry per distinct URL
        route = self.path if self.path in ("/predict", "/generate",
                                           "/models", "/healthz",
                                           "/fleet", "/metrics") \
            else ("/trace" if self.path.startswith("/trace/")
                  else "other")
        _telemetry.inc("serving.http.requests", route=route)

    def do_GET(self):
        handle = self.server.serving_handle
        self._count()
        if self.path == "/healthz":
            payload = handle.healthz()
            if getattr(self.server, "draining", False):
                # a draining replica must fail readiness so the load
                # balancer stops routing to it while in-flight work
                # finishes
                payload["status"] = "draining"
                return self._send(503, payload)
            self._send(200, payload)
        elif self.path == "/models":
            self._send(200, handle.models_payload())
        elif self.path == "/fleet":
            fleet = handle.fleet_payload()
            if fleet is None:
                self._send(404, {"error": "no fleet controller is "
                                 "attached to this registry"})
            else:
                self._send(200, fleet)
        elif self.path == "/metrics":
            self._send(200, handle.metrics_text().encode(),
                       content_type="text/plain; version=0.0.4")
        elif self.path.startswith("/trace/"):
            self._send(404, {"error": "request tracing is not ported yet "
                             "(trace %r)" % self.path[len("/trace/"):]})
        else:
            self._send(404, {"error": "unknown route %r" % self.path})

    def _admit_or_503(self, model):
        """Admission gate shared by /predict and /generate: lock-coupled
        with the draining flag — drain() flips the flag under the same
        lock, so a request can never slip between the check and the
        in-flight count and quiescence (pending_rows()==0 AND
        admitted==0) is race-free.  Returns True when admitted (the
        caller MUST decrement admitted_requests in a finally); when
        draining, sends the 503 and counts the shed — labeling with the
        model name only if it is actually loaded, so unauthenticated
        garbage cannot mint unbounded permanent telemetry label entries
        (the same bounded-cardinality rule as the route counter)."""
        srv = self.server
        with srv.admission_lock:
            draining = getattr(srv, "draining", False)
            if not draining:
                srv.admitted_requests += 1
                return True
        handle = srv.serving_handle
        known = handle.registry.get(model, default=None) is not None
        _telemetry.inc("serving.shed.count",
                       model=model if known else "other",
                       reason="drain")
        self._send(503, {"error": "server is draining (preemption); "
                         "retry elsewhere"})
        return False

    def _drain_body(self):
        """Consume an unread request body so the keep-alive connection
        stays in sync for the next request (oversized bodies close the
        connection instead of stalling on a slow sender)."""
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = 0
        if length > (1 << 20):
            self.close_connection = True
        elif length > 0:
            self.rfile.read(length)

    def do_POST(self):
        self._count()
        chunked = "chunked" in (self.headers.get("Transfer-Encoding")
                                or "").lower()
        if self.path not in ("/predict", "/generate"):
            # an undrained body would desync this keep-alive connection
            if chunked:
                self.close_connection = True
            else:
                self._drain_body()
            return self._send(404, {"error": "unknown route %r"
                                    % self.path})
        if chunked:
            # we only read Content-Length bodies
            self.close_connection = True
            return self._send(411, {"error": "chunked bodies are not "
                                    "supported; send Content-Length"})
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = -1
        if not 0 <= length <= self.max_body_bytes:
            # oversized/negative declarations must neither buffer the
            # body in RAM nor pin the handler thread on a read
            self.close_connection = True
            return self._send(413, {"error": "Content-Length must be in "
                                    "0..%d" % self.max_body_bytes})
        try:
            req = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, TypeError) as e:
            # the body may be partially read at this point; don't let the
            # next pipelined request parse the remainder as a request line
            self.close_connection = True
            return self._send(400, {"error": "bad %s request: %s"
                                    % (self.path, e)})
        if self.path == "/generate":
            return self._do_generate(req)
        return self._do_predict(req)

    def _do_predict(self, req):
        try:
            model = req["model"]
            if not isinstance(model, str):
                raise TypeError("\"model\" must be a string")
            data = np.asarray(req["data"], np.float32)
            deadline_ms = req.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
            timeout = float(req.get("timeout_s", 60.0))
        except (ValueError, KeyError, TypeError) as e:
            self.close_connection = True
            return self._send(400, {"error": "bad /predict request: %s"
                                    % e})
        if not self._admit_or_503(model):
            return
        srv = self.server
        try:
            handle = srv.serving_handle
            try:
                # resolve ONCE: the version reported is the version that
                # served, and a concurrent unload/reload can't turn a
                # completed prediction into a 404
                served = handle.registry.get(model)
                if not hasattr(served, "predict"):
                    # a decode servable: the client's routing error
                    # (400), not a server fault — mirroring /generate's
                    # mapping for a predict-only model
                    raise InvalidRequest(
                        "model %r serves /generate, not /predict"
                        % model)
                out = served.predict(data, deadline_ms=deadline_ms,
                                     timeout=timeout)
                version = served.version
            except InvalidRequest as e:
                return self._send(400, {"error": str(e)})
            except Overloaded as e:
                return self._send(429, {"error": str(e)})
            except DeadlineExceeded as e:
                return self._send(504, {"error": str(e)})
            except UnknownModel as e:
                return self._send(404, {"error": str(e)})
            except Exception as e:
                # a dispatch error re-raised from the batch (numpy shape
                # mismatch, injected fault, ...) must still produce an
                # HTTP response on this keep-alive connection, never a
                # handler crash with the client left hanging
                return self._send(500, {"error": str(e)})
            out = np.asarray(out)
            self._send(200, {"model": model, "version": version,
                             "shape": list(out.shape),
                             "output": out.tolist()})
        finally:
            with srv.admission_lock:
                srv.admitted_requests -= 1

    # -- /generate ---------------------------------------------------------
    def _do_generate(self, req):
        try:
            model = req["model"]
            if not isinstance(model, str):
                raise TypeError("\"model\" must be a string")
            prompt = [int(t) for t in req["prompt"]]
            max_new = int(req.get("max_new_tokens", 16))
            temperature = float(req.get("temperature", 0.0))
            stream = bool(req.get("stream", False))
            tenant = req.get("tenant")
            priority = int(req.get("priority", 5))
            seed = req.get("seed")
            if seed is not None:
                seed = int(seed)
            deadline_ms = req.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
            timeout = float(req.get("timeout_s", 60.0))
        except (ValueError, KeyError, TypeError) as e:
            self.close_connection = True
            return self._send(400, {"error": "bad /generate request: %s"
                                    % e})
        if not self._admit_or_503(model):
            return
        srv = self.server
        tok_q = _queue.Queue() if stream else None
        try:
            handle = srv.serving_handle
            kw = {"max_new_tokens": max_new, "temperature": temperature,
                  "deadline_ms": deadline_ms, "tenant": tenant,
                  "priority": priority, "seed": seed}
            if stream:
                # ONE ordered queue carries both tokens and failover
                # notifications: the {"event": "failover"} line lands
                # exactly at the migration boundary of the token stream
                kw["on_token"] = lambda t: tok_q.put(("token", t))
                kw["on_event"] = \
                    lambda kind, info: tok_q.put(("event", kind, info))
            try:
                # resolve ONCE (version-swap safety, as /predict) and
                # dispatch through the ONE routing point
                servable = handle.registry.get(model)
                sess = handle.start_session(servable, prompt, **kw)
            except InvalidRequest as e:
                return self._send(400, {"error": str(e)})
            except Overloaded as e:
                return self._send(429, {"error": str(e)})
            except UnknownModel as e:
                return self._send(404, {"error": str(e)})
            except Exception as e:
                # e.g. a closed pool hit mid version-swap: the straggler
                # gets a typed HTTP error, never a dropped connection
                return self._send(500, {"error": str(e)})
            version = servable.version
            if not stream:
                try:
                    tokens = sess.result(timeout)
                except DeadlineExceeded as e:
                    sess.cancel()
                    return self._send(504, {"error": str(e)})
                except Exception as e:
                    return self._send(500, {"error": str(e)})
                ttft = sess.ttft()
                return self._send(200, {
                    "model": model, "version": version,
                    "tokens": tokens, "n_tokens": len(tokens),
                    "trace_id": None,
                    "ttft_ms": None if ttft is None
                    else round(ttft * 1e3, 3)})
            self._stream_session(model, version, sess, tok_q, timeout)
        finally:
            with srv.admission_lock:
                srv.admitted_requests -= 1

    def _write_chunk(self, payload):
        line = (json.dumps(payload) + "\n").encode()
        self.wfile.write(b"%x\r\n%s\r\n" % (len(line), line))

    def _write_stream_item(self, item):
        """One queue entry -> one ndjson line: ``("token", id)`` or
        ``("event", kind, info)`` — a migration boundary becomes an
        explicit ``{"event": "failover", ...}`` line so a consumer can
        tell a mid-stream replica move from ordinary latency."""
        if item[0] == "event":
            _, kind, info = item
            self._write_chunk(dict({"event": kind}, **(info or {})))
        else:
            self._write_chunk({"token": int(item[1])})

    def _stream_session(self, model, version, sess, tok_q, timeout):
        """Chunked ndjson streaming: one ``{"token": id}`` line per
        generated token AS IT LANDS (the engine's ``on_token`` callback
        feeds the queue from its loop thread), interleaved with
        ``{"event": "failover"}`` lines at migration boundaries, then
        one summary line.  A vanished client cancels the session — the
        SAME session object rides every migration, so the cancel
        reaches whichever replica currently holds it (no orphaned slot
        on the new replica)."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        cutoff = time.monotonic() + timeout
        try:
            while True:
                try:
                    self._write_stream_item(tok_q.get(timeout=0.05))
                    continue
                except _queue.Empty:
                    pass
                if sess.done():
                    # drain stragglers enqueued between Empty and done()
                    while True:
                        try:
                            self._write_stream_item(tok_q.get_nowait())
                        except _queue.Empty:
                            break
                    break
                if time.monotonic() > cutoff:
                    sess.cancel()
                    self._write_chunk({"error": "stream timeout after "
                                       "%.1fs" % timeout})
                    break
            try:
                tokens = sess.result(timeout=5.0)
                ttft = sess.ttft()
                self._write_chunk({"done": True, "tokens": tokens,
                                   "n_tokens": len(tokens),
                                   "model": model, "version": version,
                                   "migrations": getattr(sess,
                                                         "migrations", 0),
                                   "trace_id": None,
                                   "ttft_ms": None if ttft is None
                                   else round(ttft * 1e3, 3)})
            except Exception as e:
                self._write_chunk({"error": str(e)})
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionError, OSError):
            # client went away mid-stream: free the slot, drop the
            # connection (it is desynced anyway)
            sess.cancel()
            self.close_connection = True


class _Server(ThreadingHTTPServer):
    #: listen backlog: ``socketserver``'s default of 5 resets connections
    #: when more clients than that connect at once
    request_queue_size = 128
    daemon_threads = True


class ServingHTTPServer:
    """Threaded HTTP server over a registry; ``port=0`` binds an
    ephemeral port (read ``.port`` after construction).

    ::

        server = ServingHTTPServer(registry, port=8080).start()
        ...
        server.stop()
    """

    def __init__(self, registry, host="127.0.0.1", port=8080):
        self._httpd = _Server((host, port), _Handler)
        self._httpd.serving_handle = ServingHandle(registry)
        self._httpd.draining = False
        # admission accounting for graceful drain: flag + count mutate
        # under ONE lock, so drain() cannot observe quiescence while an
        # admitted request is still on its way to the batcher
        self._httpd.admission_lock = threading.Lock()
        self._httpd.admitted_requests = 0
        self._thread = None

    @property
    def host(self):
        return self._httpd.server_address[0]

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def url(self):
        return "http://%s:%d" % (self.host, self.port)

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="serving-http",
                daemon=True)
            self._thread.start()
            _log.info("serving: HTTP endpoint up at %s", self.url)
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)

    @property
    def draining(self):
        return self._httpd.draining

    def drain(self, deadline=None):
        """Graceful preemption shutdown: stop
        admitting (``/predict`` → 503, ``/healthz`` → 503 "draining"),
        wait for every model batcher to go quiescent — queued plus
        in-flight dispatches — under ``deadline`` seconds
        (``MXNET_PREEMPT_DRAIN_DEADLINE``, default 30), then stop the
        listener.  Returns True when the drain completed before the
        deadline, False when work was still in flight at cutoff."""
        if deadline is None:
            deadline = float(os.environ.get(
                "MXNET_PREEMPT_DRAIN_DEADLINE", "30") or 30)
        with self._httpd.admission_lock:
            self._httpd.draining = True
        _telemetry.event("preemption", component="serving")
        _log.warning("serving: draining (deadline %.1fs)", deadline)
        handle = self._httpd.serving_handle
        cutoff = time.monotonic() + deadline

        def _busy():
            with self._httpd.admission_lock:
                admitted = self._httpd.admitted_requests
            return admitted + handle.pending_rows()

        clean = True
        while _busy() > 0:
            if time.monotonic() >= cutoff:
                clean = False
                _log.warning(
                    "serving: drain deadline hit with %d requests/rows "
                    "still in flight; stopping anyway", _busy())
                break
            time.sleep(0.01)
        self.stop()
        _log.info("serving: drained %s", "cleanly" if clean
                  else "with deadline overrun")
        return clean

    def run_forever(self, drain_deadline=None):
        """Serve until SIGTERM/SIGINT, then drain gracefully — the
        blocking entry point a container deployment calls.  Handlers are
        installed for the scope and restored on every exit path."""
        if threading.current_thread() is not threading.main_thread():
            raise MXNetError("run_forever installs signal handlers and "
                             "must run on the main thread")
        self.start()
        stop_ev = threading.Event()

        def _on_signal(signum, frame):
            _telemetry.event("preemption", component="serving",
                             signal=signum)
            stop_ev.set()

        prev_term = _signal.signal(_signal.SIGTERM, _on_signal)
        try:
            prev_int = _signal.signal(_signal.SIGINT, _on_signal)
            try:
                stop_ev.wait()
                return self.drain(deadline=drain_deadline)
            finally:
                _signal.signal(_signal.SIGINT, prev_int)
        finally:
            _signal.signal(_signal.SIGTERM, prev_term)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
