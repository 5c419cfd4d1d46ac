"""Routed multi-replica serving pool (counterpart of
``mxnet_tpu/serving/pool.py``).

One :class:`~mxnet_tpu_torch.serving.decode.DecodeEngine` serves one
device; traffic needs N of them behind ONE admission surface.
:class:`ReplicaPool` owns:

* **placement** — N replicas spread over the CUDA devices (round-robin
  when there are fewer devices than replicas, so two replicas share one
  card), each built by a caller factory;
* **routing** — weighted least-outstanding-rows: a request goes to the
  healthy replica with the lowest ``outstanding / weight``, accounted
  pool-side so routing never touches an engine lock;
* **load discipline on top of the engines' admission control** —
  pool-level ``Overloaded`` past ``max_outstanding``
  (``MXNET_POOL_MAX_OUTSTANDING``), priority-aware shedding (past the
  priority watermark only requests with ``priority >=
  priority_floor`` are admitted; under the fleet controller's shed
  pressure, :meth:`ReplicaPool.set_shed_pressure`, from the first
  outstanding request), and per-tenant quotas (:class:`QuotaExceeded`,
  shed reason ``quota``);
* **replica fault domains** — a per-replica CIRCUIT BREAKER over the
  step-outcome stream: ``quarantine_after`` consecutive failures OR an
  error rate past ``MXNET_POOL_CIRCUIT_THRESHOLD`` over the rolling
  outcome window opens the circuit (replica quarantined, routing skips
  it, telemetry event), recovery re-warms it and — after the
  ``MXNET_POOL_CIRCUIT_COOLDOWN_MS`` cooldown —
  returns it HALF-OPEN: one in-flight probe at a time until a clean
  step closes the circuit (a failed probe re-opens it instantly);
* **session failover** — an in-flight generation on a failing replica
  is NOT shed: its engine hands the held sessions back
  (:meth:`~mxnet_tpu_torch.serving.decode.DecodeEngine.set_health_hooks`
  ``on_migrate``) and the pool re-admits them on a healthy replica by
  re-prefilling ``prompt + generated-so-far`` — bit-identical
  continuation, greedy and temperature, because sampling keys are
  position-derived (see decode.py).  Failure-driven migration attempts
  are bounded by per-tenant RETRY BUDGETS (``MXNET_POOL_RETRY_BUDGET``
  / the ``retry_budgets`` map); past the budget the session sheds
  typed with reason ``retry_budget``;
* **version swaps** — a pool is a registry servable: build the new
  version off-registry, then
  :meth:`~mxnet_tpu_torch.serving.registry.ModelRegistry.register` pointer-
  flips it in; the OLD pool's in-flight stragglers MIGRATE onto the
  new servable (``close(successor=new)`` / :meth:`adopt`) instead of
  being errored out — bit-identical continuation when the successor
  serves the SAME params (a config/infra swap; position-derived keys
  guarantee identity only for identical weights — with new weights
  the continuation draws from the new version's logits, which is the
  point of the deploy).  Version swaps are free for the session: they
  never touch the retry budget.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

import torch

from .. import telemetry as _telemetry
from ..base import MXNetError
from ..base import env_float as _env_float
from ..base import env_int as _env_int
from ..models import transformer_lm as _tlm
from .batcher import DeadlineExceeded, Overloaded
from .decode import DecodeEngine, ReplicaKilled, resolve_device

__all__ = ["QuotaExceeded", "RetryBudgetExhausted", "Replica",
           "ReplicaPool", "lm_pool", "ACTIVE", "QUARANTINED", "WARMING",
           "RETIRING", "CIRCUIT_CLOSED", "CIRCUIT_OPEN",
           "CIRCUIT_HALF_OPEN"]

_log = logging.getLogger("mxnet_tpu_torch.serving")

ACTIVE = "active"
QUARANTINED = "quarantined"
WARMING = "warming"
#: being drained out of the pool by a controller decision (scale-down /
#: rebalance): unpublished from routing while its sessions migrate
RETIRING = "retiring"

_STATE_GAUGE = {ACTIVE: 0, QUARANTINED: 1, WARMING: 2, RETIRING: 3}

CIRCUIT_CLOSED = "closed"
CIRCUIT_OPEN = "open"
CIRCUIT_HALF_OPEN = "half_open"

_CIRCUIT_GAUGE = {CIRCUIT_CLOSED: 0, CIRCUIT_OPEN: 1,
                  CIRCUIT_HALF_OPEN: 2}


class QuotaExceeded(Overloaded):
    """The tenant's outstanding-request quota is exhausted (HTTP 429);
    other tenants are unaffected — that is the point of quotas."""


class RetryBudgetExhausted(MXNetError):
    """The session's failure-driven migration attempts exceeded its
    tenant's retry budget: shed typed with reason ``retry_budget``
    instead of bouncing between dying replicas forever."""


class Replica:
    """One pool member: the engine plus its health/routing bookkeeping
    (all mutable fields guarded by the POOL lock)."""

    __slots__ = ("rid", "device", "engine", "weight", "state", "failures",
                 "routed", "dead")

    def __init__(self, rid, device, engine, weight):
        self.rid = rid
        self.device = device
        self.engine = engine
        self.weight = float(weight)
        if self.weight <= 0:
            raise MXNetError("replica weight must be > 0")
        self.state = ACTIVE
        self.failures = 0
        self.routed = 0
        #: hard-killed (ReplicaKilled): the engine is permanently gone;
        #: the pool serves on the survivors and the FLEET CONTROLLER —
        #: not the pool — decides whether to replace it
        self.dead = False


class ReplicaPool:
    """N routed replicas behind one ``generate()`` surface.

    Parameters
    ----------
    factory : callable(device, replica_id) -> engine
        Builds one replica; the engine must expose ``submit(prompt,
        ..., on_done=)``, ``resume``, ``pending_rows``, ``describe``,
        ``stop``, ``rewarm``, ``start``, ``close`` and accept health
        hooks via ``set_health_hooks`` (what :class:`DecodeEngine`
        provides — see :func:`lm_pool`).
    n_replicas : int
        Pool size; devices are assigned round-robin from ``devices``
        (default: every CUDA device, raising without one; tests pass
        ``["cpu"]``).
    weights : sequence of float, optional
        Per-replica routing weights (default all 1.0): routing picks
        the ACTIVE replica minimizing ``outstanding / weight``.
    quotas : dict, optional
        ``tenant -> max outstanding sessions``; key ``"*"`` is the
        default for unlisted tenants (absent = unlimited).
    max_outstanding : int
        Pool-wide admission bound (``MXNET_POOL_MAX_OUTSTANDING``;
        default: the summed replica capacity).
    priority_floor / priority_watermark :
        Past ``priority_watermark * max_outstanding`` outstanding
        sessions, requests with ``priority < priority_floor`` are shed
        (reason ``priority``) so high-priority traffic keeps flowing
        under pressure.
    quarantine_after : int
        Consecutive step failures before a replica's circuit opens
        (``MXNET_POOL_QUARANTINE_AFTER``, default 3).
    retry_budgets : dict, optional
        ``tenant -> max failure-driven migration attempts per
        session``; key ``"*"`` is the default for unlisted tenants
        (``MXNET_POOL_RETRY_BUDGET``, default 3).  Version-swap
        migrations are free.
    circuit_window / circuit_threshold / circuit_min_events :
        Error-rate breaker: over the last ``circuit_window`` step
        outcomes (``MXNET_POOL_CIRCUIT_WINDOW``, 20), a failure
        fraction >= ``circuit_threshold``
        (``MXNET_POOL_CIRCUIT_THRESHOLD``, 0.5) with at least
        ``circuit_min_events`` outcomes recorded
        (``MXNET_POOL_CIRCUIT_MIN_EVENTS``, 4) opens the circuit even
        without ``quarantine_after`` consecutive failures.
    circuit_cooldown : float, seconds
        Minimum open time before the half-open probe
        (``MXNET_POOL_CIRCUIT_COOLDOWN_MS``, 250ms; re-warm time
        counts toward it).
    """

    def __init__(self, factory, n_replicas=2, devices=None, *, name="lm",
                 version=1, weights=None, quotas=None, max_outstanding=None,
                 priority_floor=5, priority_watermark=0.75,
                 quarantine_after=None, retry_budgets=None,
                 circuit_window=None, circuit_threshold=None,
                 circuit_min_events=None, circuit_cooldown=None):
        if n_replicas < 1:
            raise MXNetError("pool needs >= 1 replica")
        self.name = name
        self.version = int(version)
        devices = [resolve_device(d) for d in devices] \
            if devices is not None else _cuda_devices()
        if not devices:
            raise MXNetError("no devices for the replica pool")
        weights = list(weights) if weights is not None \
            else [1.0] * n_replicas
        if len(weights) != n_replicas:
            raise MXNetError("got %d weights for %d replicas"
                             % (len(weights), n_replicas))
        self._lock = threading.Lock()
        self._quotas = dict(quotas or {})
        self._priority_floor = int(priority_floor)
        self._quarantine_after = int(quarantine_after) \
            if quarantine_after is not None \
            else _env_int("MXNET_POOL_QUARANTINE_AFTER", 3)
        self._retry_budgets = dict(retry_budgets or {})
        self._retry_budgets.setdefault(
            "*", _env_int("MXNET_POOL_RETRY_BUDGET", 3))
        self._circuit_window = int(circuit_window) \
            if circuit_window is not None \
            else _env_int("MXNET_POOL_CIRCUIT_WINDOW", 20)
        self._circuit_threshold = float(circuit_threshold) \
            if circuit_threshold is not None \
            else _env_float("MXNET_POOL_CIRCUIT_THRESHOLD", 0.5)
        self._circuit_min_events = int(circuit_min_events) \
            if circuit_min_events is not None \
            else _env_int("MXNET_POOL_CIRCUIT_MIN_EVENTS", 4)
        self._circuit_cooldown = float(circuit_cooldown) \
            if circuit_cooldown is not None \
            else _env_float("MXNET_POOL_CIRCUIT_COOLDOWN_MS", 250) / 1e3
        self._outstanding = {}
        self._tenant_out = {}
        self._total_outstanding = 0
        self._closed = False
        # circuit-breaker state, all keyed by rid and guarded by the
        # pool lock
        self._circuit = {}
        self._cwindow = {}       # rid -> deque of step outcomes (bool)
        self._opened_at = {}
        self._migrations_out = {}
        self._migrations_in = {}
        self._failovers = 0
        #: the fleet controller's shed pressure (set_shed_pressure)
        self._pressure = False
        if any(float(w) <= 0 for w in weights):
            # validate BEFORE building engines: a bad weight must not
            # cost k warmed-and-leaked replicas
            raise MXNetError("replica weights must be > 0, got %r"
                             % (weights,))
        # replica membership is DYNAMIC (the fleet controller scales
        # it): keyed by rid in _replicas, every mutation under the pool
        # lock; the public .replicas property snapshots a rid-ordered
        # list.  The factory and device ring are kept so add_replica
        # can build new members.
        self._factory = factory
        self._devices = devices
        self._next_rid = n_replicas
        self._replicas = {}
        try:
            for i in range(n_replicas):
                dev = devices[i % len(devices)]
                engine = factory(dev, str(i))
                if hasattr(engine, "set_health_hooks"):
                    engine.set_health_hooks(
                        on_error=self._make_error_hook(i),
                        on_ok=self._make_ok_hook(i),
                        on_migrate=self._make_migrate_hook(i))
                self._replicas[i] = Replica(i, dev, engine, weights[i])
                self._outstanding[i] = 0
                self._circuit[i] = CIRCUIT_CLOSED
                self._cwindow[i] = deque(maxlen=self._circuit_window)
                self._opened_at[i] = 0.0
                self._migrations_out[i] = 0
                self._migrations_in[i] = 0
        except Exception:
            # a replica k>0 failing to build (device OOM, ...) must not
            # leak the already-running earlier replicas' worker threads
            # and device-resident caches
            for r in self._replicas.values():
                try:
                    r.engine.close(drain=False)
                except Exception:  # noqa: broad-except — best-effort
                    # cleanup on the failure path
                    pass
            raise
        self.replicas = [self._replicas[k] for k in sorted(self._replicas)]
        env_max = _env_int("MXNET_POOL_MAX_OUTSTANDING", 0)
        # a caller-pinned (or env-pinned) admission bound stays fixed as
        # the pool scales; a capacity-derived one is recomputed on every
        # add/remove so scaling actually moves the admission surface
        self._bound_fixed = max_outstanding is not None or bool(env_max)
        self._watermark_frac = float(priority_watermark)
        self._max_outstanding = int(max_outstanding) \
            if max_outstanding is not None \
            else (env_max or max(self._capacity_locked(), n_replicas))
        # never floor to 0: an idle tiny pool must not shed low-priority
        # traffic before a single request is outstanding
        self._watermark = max(1, int(priority_watermark
                                     * self._max_outstanding))
        for r in self.replicas:
            _telemetry.inc("serving.pool.routed.count", 0,
                           model=name, replica=str(r.rid))
            _telemetry.set_gauge("serving.pool.outstanding", 0,
                                 model=name, replica=str(r.rid))
            _telemetry.set_gauge("serving.pool.replica_state",
                                 _STATE_GAUGE[ACTIVE], model=name,
                                 replica=str(r.rid))
            _telemetry.set_gauge("serving.pool.circuit_state",
                                 _CIRCUIT_GAUGE[CIRCUIT_CLOSED],
                                 model=name, replica=str(r.rid))
            _telemetry.inc("serving.failover.migrations.count", 0,
                           model=name, replica=str(r.rid))
        _telemetry.inc("serving.pool.quarantines.count", 0, model=name)
        _telemetry.inc("serving.failover.count", 0, model=name)
        for reason in ("quota", "priority", "retry_budget", "failover"):
            _telemetry.inc("serving.shed.count", 0, model=name,
                           reason=reason)

    # -- membership --------------------------------------------------------
    def _publish_locked(self):
        """Rebind the public ``replicas`` snapshot (pool lock held).
        ``replicas`` is a rid-ordered IMMUTABLE-by-convention list that
        is REPLACED wholesale on every membership change — readers
        (routing hooks, describe callers, tests) grab the reference
        lock-free and iterate a stable snapshot, exactly the pre-PR-16
        fixed-list read behavior."""
        self.replicas = [self._replicas[k] for k in sorted(self._replicas)]

    def _capacity_locked(self):
        return sum(getattr(r.engine, "slots", 0)
                   + getattr(r.engine, "max_queue", 0)
                   for r in self._replicas.values())

    def _recompute_bounds_locked(self):
        """Re-derive the admission bound + priority watermark after a
        membership change (no-op when the bound was pinned by the
        caller or ``MXNET_POOL_MAX_OUTSTANDING``)."""
        if self._bound_fixed:
            return
        self._max_outstanding = max(self._capacity_locked(),
                                    len(self._replicas), 1)
        self._watermark = max(1, int(self._watermark_frac
                                     * self._max_outstanding))

    def add_replica(self, device=None, weight=1.0):
        """Grow the pool by one replica — the fleet controller's
        scale-up / replace actuator.  The engine is built and WARMED by
        the factory BEFORE the pool publishes it to routing, so the new
        replica's first request never pays a warm-up.  Returns the new
        rid."""
        with self._lock:
            if self._closed:
                raise MXNetError("replica pool %r is closed" % self.name)
            rid = self._next_rid
            self._next_rid += 1
            dev = resolve_device(device) if device is not None \
                else self._devices[rid % len(self._devices)]
        engine = self._factory(dev, str(rid))
        if hasattr(engine, "set_health_hooks"):
            engine.set_health_hooks(
                on_error=self._make_error_hook(rid),
                on_ok=self._make_ok_hook(rid),
                on_migrate=self._make_migrate_hook(rid))
        r = Replica(rid, dev, engine, weight)
        with self._lock:
            closed = self._closed
            if not closed:
                self._replicas[rid] = r
                self._outstanding[rid] = 0
                self._circuit[rid] = CIRCUIT_CLOSED
                self._cwindow[rid] = deque(maxlen=self._circuit_window)
                self._opened_at[rid] = 0.0
                self._migrations_out[rid] = 0
                self._migrations_in[rid] = 0
                self._recompute_bounds_locked()
                self._publish_locked()
        if closed:
            # the pool was swapped out while the engine warmed: a
            # replica nobody will ever route to must not leak a worker
            try:
                engine.close(drain=False)
            except Exception:  # noqa: broad-except — best-effort
                # cleanup on the lost-race path
                pass
            raise MXNetError("replica pool %r closed during add_replica"
                             % self.name)
        _telemetry.set_gauge("serving.pool.outstanding", 0,
                             model=self.name, replica=str(rid))
        _telemetry.set_gauge("serving.pool.replica_state",
                             _STATE_GAUGE[ACTIVE], model=self.name,
                             replica=str(rid))
        _telemetry.set_gauge("serving.pool.circuit_state",
                             _CIRCUIT_GAUGE[CIRCUIT_CLOSED],
                             model=self.name, replica=str(rid))
        _telemetry.event("serving.pool.replica_add", model=self.name,
                         replica=str(rid), device=str(dev))
        _log.info("pool %r: replica %d added on %s (warmed before "
                  "routing)", self.name, rid, dev)
        return rid

    def remove_replica(self, rid, migrate=True):
        """Shrink the pool by one replica — the scale-down / rebalance
        actuator.  The replica is unpublished from routing (RETIRING),
        its engine stopped with the live sessions HANDED OFF, and each
        handed session re-admitted on a survivor through the failover
        transport (``resume()``: re-prefill prompt + generated-so-far —
        bit-identical continuation) WITHOUT charging the tenant's retry
        budget: a controller decision is not a replica failure.
        Returns True when no session was lost (migrated sessions are
        not losses; shed sessions carry a typed error)."""
        with self._lock:
            r = self._replicas.get(rid)
            if r is None:
                raise MXNetError("pool %r has no replica %r"
                                 % (self.name, rid))
            if r.state == RETIRING:
                return True  # a concurrent remove already owns it
            was_dead = r.dead
            r.state = RETIRING
        _telemetry.set_gauge("serving.pool.replica_state",
                             _STATE_GAUGE[RETIRING], model=self.name,
                             replica=str(rid))
        clean = True
        orphans = []
        try:
            r.engine.stop(drain=False, hand_off=orphans.extend)
        except Exception:  # noqa: broad-except — a dead engine's stop
            # must not block the membership change
            clean = False
            _log.warning("pool %r: stop of replica %d failed during "
                         "removal", self.name, rid, exc_info=True)
        if orphans:
            if migrate:
                self._migrate_sessions(
                    rid, orphans,
                    MXNetError("replica %d retired by the fleet "
                               "controller" % rid),
                    charge_budget=False, reason="rebalance")
            else:
                for sess in orphans:
                    clean = False
                    self._shed_session(sess, "drain", MXNetError(
                        "replica %d removed from pool %r before this "
                        "session finished" % (rid, self.name)))
        try:
            r.engine.close(drain=False)
        except Exception:  # noqa: broad-except — closing one dead
            # replica must not block the membership change
            if not was_dead:
                clean = False
            _log.warning("pool %r: close of replica %d failed during "
                         "removal", self.name, rid, exc_info=True)
        with self._lock:
            self._replicas.pop(rid, None)
            self._outstanding.pop(rid, None)
            self._circuit.pop(rid, None)
            self._cwindow.pop(rid, None)
            self._opened_at.pop(rid, None)
            self._migrations_out.pop(rid, None)
            self._migrations_in.pop(rid, None)
            self._recompute_bounds_locked()
            self._publish_locked()
        _telemetry.set_gauge("serving.pool.outstanding", 0,
                             model=self.name, replica=str(rid))
        _telemetry.event("serving.pool.replica_remove", model=self.name,
                         replica=str(rid), migrated=len(orphans),
                         clean=clean)
        _log.info("pool %r: replica %d removed (%d live session(s) "
                  "migrated)", self.name, rid,
                  len(orphans) if migrate else 0)
        return clean

    def set_shed_pressure(self, on):
        """The fleet controller's priority-shedding lever, for a fleet at
        its capacity: while on, requests under the priority floor shed
        typed (reason ``priority``) from the FIRST outstanding request
        instead of from the watermark.  In-flight generations are never
        touched: this is admission control only.  Returns the previous
        setting."""
        on = bool(on)
        with self._lock:
            prev, self._pressure = self._pressure, on
        if prev != on:
            _telemetry.set_gauge("serving.pool.shed_pressure", int(on),
                                 model=self.name)
            _telemetry.event("serving.pool.shed_pressure",
                             model=self.name, on=on)
            _log.warning("pool %r: shed pressure %s", self.name,
                         "ON (priority floor applies from the first "
                         "request)" if on else "off")
        return prev

    def admission_state(self):
        """``(outstanding, max_outstanding, shed_pressure)``: the
        controller's per-tick load read (no engine lock taken)."""
        with self._lock:
            return (self._total_outstanding, self._max_outstanding,
                    self._pressure)

    def _make_error_hook(self, rid):
        return lambda exc: self._note_step_error(rid, exc)

    def _make_ok_hook(self, rid):
        return lambda: self._note_step_ok(rid)

    def _make_migrate_hook(self, rid):
        return lambda sessions, exc: self._migrate_sessions(
            rid, sessions, exc)

    # -- routing -----------------------------------------------------------
    def _pick_locked(self):
        """Weighted least-outstanding choice over routable replicas
        (pool lock held).  A HALF-OPEN replica is routable but admits
        ONE in-flight probe at a time — the breaker's probe, carried by
        real traffic — and NEVER outbids a CLOSED-circuit replica just
        by being idle: recovering capacity is unproven, so under
        degradation the proven replica is preferred even at a higher
        outstanding count.  The probe flows only when every closed-
        circuit replica is already slot-saturated (real pressure) or
        none is routable at all — prompt enough to close the breaker,
        never the first choice.  Returns None when nothing is
        routable.  Every caller holds the pool lock."""
        closed, probes = [], []
        for r in self._replicas.values():
            if r.state != ACTIVE:
                continue
            circuit = self._circuit[r.rid]
            busy = self._outstanding[r.rid]
            if circuit == CIRCUIT_HALF_OPEN:
                if busy >= 1:
                    continue  # the probe budget: one in flight
                probes.append(r)
            else:
                closed.append(r)
        key = lambda x: self._outstanding[x.rid] / x.weight  # noqa: E731
        if closed:
            if probes and all(
                    self._outstanding[r.rid]
                    >= max(1, getattr(r.engine, "slots", 1))
                    for r in closed):
                return min(probes, key=key)
            return min(closed, key=key)
        if probes:
            return min(probes, key=key)
        return None

    def generate(self, prompt, *, max_new_tokens=16, temperature=0.0,
                 deadline_ms=None, on_token=None, tenant=None, priority=5,
                 seed=None, on_event=None):
        """Admit + route one generation request; returns the replica
        engine's :class:`~mxnet_tpu.serving.decode.GenerateSession`.

        Shedding order (all typed, all counted under
        ``serving.shed.count{model=,reason=}``): pool ``Overloaded``
        past ``max_outstanding``; ``priority`` past the watermark (or
        under shed pressure, from the first request) for requests under
        the floor; ``quota`` for tenants at their bound;
        then the chosen replica's own engine admission applies.
        ``on_event`` (optional ``callable(kind, info)``) receives a
        ``"failover"`` notification at every migration boundary — the
        HTTP frontend turns it into the stream's failover line."""
        tenant_key = tenant if tenant is not None else "*"
        with self._lock:
            if self._closed:
                raise MXNetError("replica pool %r is closed" % self.name)
            if self._total_outstanding >= self._max_outstanding:
                _telemetry.inc("serving.shed.count", model=self.name,
                               reason="overload")
                raise Overloaded(
                    "pool %r overloaded: %d outstanding >= bound %d"
                    % (self.name, self._total_outstanding,
                       self._max_outstanding))
            if (self._pressure
                    or self._total_outstanding >= self._watermark) \
                    and int(priority) < self._priority_floor:
                _telemetry.inc("serving.shed.count", model=self.name,
                               reason="priority")
                raise Overloaded(
                    "pool %r past its priority watermark (%d/%d)%s: "
                    "priority %d < floor %d shed"
                    % (self.name, self._total_outstanding,
                       self._watermark,
                       " under fleet shed pressure" if self._pressure
                       else "", priority, self._priority_floor))
            quota = self._quotas.get(tenant_key, self._quotas.get("*"))
            if quota is not None \
                    and self._tenant_out.get(tenant_key, 0) >= int(quota):
                _telemetry.inc("serving.shed.count", model=self.name,
                               reason="quota")
                raise QuotaExceeded(
                    "tenant %r at its quota of %d outstanding requests"
                    % (tenant_key, int(quota)))
            r = self._pick_locked()
            if r is None:
                _telemetry.inc("serving.shed.count", model=self.name,
                               reason="overload")
                raise Overloaded("pool %r has no healthy replicas "
                                 "(all quarantined/warming)" % self.name)
            self._outstanding[r.rid] += 1
            self._tenant_out[tenant_key] = \
                self._tenant_out.get(tenant_key, 0) + 1
            self._total_outstanding += 1
            r.routed += 1
            _telemetry.inc("serving.pool.routed.count", model=self.name,
                           replica=str(r.rid))
            _telemetry.set_gauge("serving.pool.outstanding",
                                 self._outstanding[r.rid],
                                 model=self.name, replica=str(r.rid))
        try:
            sess = r.engine.submit(
                prompt, max_new_tokens=max_new_tokens,
                temperature=temperature, deadline_ms=deadline_ms,
                on_token=on_token, seed=seed, tenant=tenant_key,
                on_event=on_event,
                on_done=self._make_done_hook(r.rid, tenant_key))
        except Exception:
            self._settle(r.rid, tenant_key)
            raise
        return sess

    def _make_done_hook(self, rid, tenant_key):
        return lambda _sess: self._settle(rid, tenant_key)

    def _settle(self, rid, tenant_key):
        with self._lock:
            # the rid may have been removed by a controller scale-down
            # while this session was finishing: tenant/total accounting
            # still settles, the per-replica row is simply gone
            out = None
            if rid in self._outstanding:
                self._outstanding[rid] = \
                    max(0, self._outstanding[rid] - 1)
                out = self._outstanding[rid]
            self._tenant_out[tenant_key] = \
                max(0, self._tenant_out.get(tenant_key, 0) - 1)
            self._total_outstanding = max(0, self._total_outstanding - 1)
        if out is not None:
            _telemetry.set_gauge("serving.pool.outstanding", out,
                                 model=self.name, replica=str(rid))

    # -- replica health / circuit breaker ----------------------------------
    def _failure_rate_locked(self, rid):
        window = self._cwindow[rid]
        if not window:
            return 0.0
        return sum(1 for ok in window if not ok) / float(len(window))

    def _note_step_error(self, rid, exc):
        killed = isinstance(exc, ReplicaKilled)
        r = self._replicas.get(rid)
        if r is None:
            return  # removed by a controller scale-down mid-flight
        with self._lock:
            r.failures += 1
            self._cwindow[rid].append(False)
            rate = self._failure_rate_locked(rid)
            opened = r.state == ACTIVE and (
                killed
                or self._circuit[rid] == CIRCUIT_HALF_OPEN
                or r.failures >= self._quarantine_after
                or (len(self._cwindow[rid]) >= self._circuit_min_events
                    and rate >= self._circuit_threshold))
            if opened:
                r.state = QUARANTINED
                self._circuit[rid] = CIRCUIT_OPEN
                self._opened_at[rid] = time.monotonic()
            failures = r.failures
        if not opened:
            return
        _telemetry.inc("serving.pool.quarantines.count", model=self.name)
        _telemetry.set_gauge("serving.pool.replica_state",
                             _STATE_GAUGE[QUARANTINED],
                             model=self.name, replica=str(rid))
        _telemetry.set_gauge("serving.pool.circuit_state",
                             _CIRCUIT_GAUGE[CIRCUIT_OPEN],
                             model=self.name, replica=str(rid))
        _telemetry.event("serving.pool.quarantine", model=self.name,
                         replica=str(rid), failures=failures,
                         error=str(exc))
        _telemetry.event("serving.pool.circuit_open", model=self.name,
                         replica=str(rid),
                         failure_rate=round(rate, 3), killed=killed)
        _log.warning("pool %r: replica %d circuit OPEN after %d "
                     "consecutive failures / %.0f%% window error rate "
                     "(%s)%s", self.name, rid, failures, rate * 100, exc,
                     "; replica hard-killed, staying down" if killed
                     else "; recovering in the background")
        threading.Thread(target=self._recover, args=(rid, killed, exc),
                         name="pool-recover-%s-%d" % (self.name, rid),
                         daemon=True).start()

    def _note_step_ok(self, rid):
        r = self._replicas.get(rid)
        if r is None:
            return  # removed by a controller scale-down mid-flight
        with self._lock:
            r.failures = 0
            self._cwindow[rid].append(True)
            closed = self._circuit[rid] == CIRCUIT_HALF_OPEN \
                and r.state == ACTIVE
            if closed:
                self._circuit[rid] = CIRCUIT_CLOSED
        if closed:
            _telemetry.set_gauge("serving.pool.circuit_state",
                                 _CIRCUIT_GAUGE[CIRCUIT_CLOSED],
                                 model=self.name, replica=str(rid))
            _telemetry.event("serving.pool.circuit_close",
                             model=self.name, replica=str(rid))
            _log.info("pool %r: replica %d half-open probe succeeded; "
                      "circuit CLOSED", self.name, rid)

    def _recover(self, rid, killed, exc):
        """Background circuit recovery: take over everything the
        opened replica still holds (queued AND slot sessions migrate,
        they are not shed), then — unless the replica was hard-killed —
        re-warm it, sit out the cooldown, and return it HALF-OPEN."""
        with self._lock:
            if self._closed:
                # the pool was swapped out while recovery was pending;
                # the engine-level closed guard catches the narrower
                # race after this check
                return
            r = self._replicas.get(rid)
        if r is None:
            return  # removed by a controller scale-down mid-recovery
        orphans = []
        try:
            r.engine.stop(drain=False, hand_off=orphans.extend)
        except Exception:  # noqa: broad-except — a dead engine's stop
            # must not kill the recovery thread before migration
            _log.warning("pool %r: stop of replica %d failed during "
                         "recovery", self.name, rid, exc_info=True)
        if orphans:
            self._migrate_sessions(rid, orphans, exc)
        if killed:
            with self._lock:
                r.dead = True
            _telemetry.event("serving.pool.replica_dead",
                             model=self.name, replica=str(rid),
                             error=str(exc))
            _log.error("pool %r: replica %d is dead (hard kill); "
                       "serving continues on the survivors — replace/"
                       "quarantine is the fleet controller's call",
                       self.name, rid)
            return
        with self._lock:
            r.state = WARMING
        _telemetry.set_gauge("serving.pool.replica_state",
                             _STATE_GAUGE[WARMING], model=self.name,
                             replica=str(rid))
        try:
            r.engine.rewarm()
            r.engine.start()
        except Exception as e:  # noqa: broad-except — a failed re-warm
            # must leave the replica quarantined (and the pool serving on
            # the others), never kill the recovery thread with the
            # replica stuck WARMING
            with self._lock:
                r.state = QUARANTINED
            _telemetry.set_gauge("serving.pool.replica_state",
                                 _STATE_GAUGE[QUARANTINED],
                                 model=self.name, replica=str(rid))
            _telemetry.event("serving.pool.rewarm_failed",
                             model=self.name, replica=str(rid),
                             error=str(e))
            _log.error("pool %r: re-warm of replica %d failed: %s",
                       self.name, rid, e)
            return
        # re-warm time counts toward the cooldown; sit out any rest so
        # a fast re-warm cannot flap the breaker
        with self._lock:
            opened_at = self._opened_at[rid]
        remaining = opened_at + self._circuit_cooldown - time.monotonic()
        if remaining > 0:
            time.sleep(remaining)
        with self._lock:
            r.state = ACTIVE
            r.failures = 0
            self._cwindow[rid].clear()
            self._circuit[rid] = CIRCUIT_HALF_OPEN
        _telemetry.set_gauge("serving.pool.replica_state",
                             _STATE_GAUGE[ACTIVE], model=self.name,
                             replica=str(rid))
        _telemetry.set_gauge("serving.pool.circuit_state",
                             _CIRCUIT_GAUGE[CIRCUIT_HALF_OPEN],
                             model=self.name, replica=str(rid))
        _telemetry.event("serving.pool.rewarmed", model=self.name,
                         replica=str(rid))
        _telemetry.event("serving.pool.circuit_half_open",
                         model=self.name, replica=str(rid))
        _log.info("pool %r: replica %d re-warmed; circuit HALF-OPEN "
                  "(one probe at a time)", self.name, rid)

    # -- session failover ---------------------------------------------------
    def _retry_budget(self, tenant_key):
        budget = self._retry_budgets.get(
            tenant_key, self._retry_budgets.get("*", 3))
        return int(budget)

    def _shed_session(self, sess, reason, err):
        _telemetry.inc("serving.shed.count", model=self.name,
                       reason=reason)
        sess._resolve(error=err)

    def _fire_failover_event(self, sess, info):
        cb = sess.on_event
        if cb is None:
            return
        try:
            cb("failover", info)
        except Exception:  # noqa: broad-except — a client callback must
            # never kill the migration path
            _log.warning("pool %r: on_event callback failed", self.name,
                         exc_info=True)

    def _migrate_sessions(self, rid, sessions, exc, charge_budget=True,
                          reason="failover"):
        """Failure-driven migration (the engines' ``on_migrate`` hook
        and the recovery takeover): re-admit each session on a healthy
        replica — its accounting moves with it — or shed typed when it
        is cancelled/expired, over its retry budget, or nothing is
        routable.  Every session is resolved-or-readmitted; none is
        ever silently dropped.  ``charge_budget=False`` is the
        controller-drain variant (scale-down / rebalance): like a
        version swap, a planned migration is free for the session —
        the retry budget guards against bouncing between DYING
        replicas, not against operator decisions."""
        tenant_of = lambda s: s.tenant if s.tenant is not None else "*"  # noqa: E731
        for sess in sessions:
            if sess.finished():
                continue
            if sess.cancelled():
                self._shed_session(sess, "abandoned", MXNetError(
                    "session abandoned by the client during failover"))
                continue
            if sess.deadline is not None \
                    and time.monotonic() > sess.deadline:
                self._shed_session(sess, "deadline", DeadlineExceeded(
                    "session deadline expired during failover"))
                continue
            tenant_key = tenant_of(sess)
            if charge_budget:
                sess.migrations += 1
                budget = self._retry_budget(tenant_key)
                if sess.migrations > budget:
                    self._shed_session(sess, "retry_budget",
                                       RetryBudgetExhausted(
                        "session exceeded tenant %r retry budget of %d "
                        "migration attempts (reason=retry_budget); last "
                        "replica error: %s" % (tenant_key, budget, exc)))
                    continue
            t0 = time.monotonic()
            with self._lock:
                target = None if self._closed else self._pick_locked()
                if target is not None:
                    # the accounting moves with the session: the source
                    # replica sheds one outstanding row, the target
                    # gains it (tenant/total are unchanged)
                    self._outstanding[rid] = \
                        max(0, self._outstanding[rid] - 1)
                    self._outstanding[target.rid] += 1
                    target.routed += 1
                    self._migrations_out[rid] += 1
                    self._migrations_in[target.rid] += 1
                    self._failovers += 1
                    out_src = self._outstanding[rid]
                    out_dst = self._outstanding[target.rid]
            if target is None:
                self._shed_session(sess, reason, MXNetError(
                    "no healthy replica to migrate this session to; "
                    "replica error: %s" % (exc,)))
                continue
            _telemetry.set_gauge("serving.pool.outstanding", out_src,
                                 model=self.name, replica=str(rid))
            _telemetry.set_gauge("serving.pool.outstanding", out_dst,
                                 model=self.name, replica=str(target.rid))
            sess._on_done = self._make_done_hook(target.rid, tenant_key)
            # the stream's failover line goes out BEFORE resume(): the
            # target worker can emit the first resumed token the moment
            # the session is enqueued, and the event must precede it
            self._fire_failover_event(sess, {
                "from_replica": str(rid), "to_replica": str(target.rid),
                "attempt": sess.migrations})
            sess.migrate_t0 = t0
            try:
                target.engine.resume(sess)
            except Exception as e:  # noqa: broad-except — a refused
                # resume (a paged pool too small for the transcript,
                # target closing under a racing swap) sheds typed, never
                # drops
                sess.migrate_t0 = None
                self._shed_session(sess, reason, MXNetError(
                    "failover re-admission on replica %d failed: %s"
                    % (target.rid, e)))
                continue
            _telemetry.inc("serving.failover.count", model=self.name)
            _telemetry.inc("serving.failover.migrations.count",
                           model=self.name, replica=str(rid))
            _telemetry.event("serving.failover.migrate",
                             model=self.name, src=str(rid),
                             dst=str(target.rid), reason=reason,
                             attempt=sess.migrations,
                             tokens_generated=len(sess.tokens))

    def adopt(self, sess):
        """Admit an in-flight session migrated from OUTSIDE this pool —
        a version swap's straggler (``old.close(successor=new)``):
        fresh accounting, no admission bounds (it was already admitted
        once), no retry-budget charge (a version swap is not a
        failure).  Raises when nothing is routable; the caller sheds
        typed."""
        tenant_key = sess.tenant if sess.tenant is not None else "*"
        with self._lock:
            if self._closed:
                raise MXNetError("replica pool %r is closed" % self.name)
            target = self._pick_locked()
            if target is None:
                raise Overloaded("pool %r has no healthy replicas to "
                                 "adopt the migrated session"
                                 % self.name)
            self._outstanding[target.rid] += 1
            self._tenant_out[tenant_key] = \
                self._tenant_out.get(tenant_key, 0) + 1
            self._total_outstanding += 1
            target.routed += 1
            self._migrations_in[target.rid] += 1
            self._failovers += 1
        sess._on_done = self._make_done_hook(target.rid, tenant_key)
        # event before resume(), as in _migrate_sessions: the stream's
        # failover line must precede the first successor-side token
        self._fire_failover_event(sess, {
            "to_replica": str(target.rid), "version_swap": True})
        try:
            target.engine.resume(sess)
        except Exception:
            self._settle(target.rid, tenant_key)
            raise
        _telemetry.inc("serving.failover.count", model=self.name)
        _telemetry.event("serving.failover.adopt", model=self.name,
                         dst=str(target.rid),
                         tokens_generated=len(sess.tokens))
        return sess

    # -- registry servable surface ----------------------------------------
    def pending_rows(self):
        """Queued + active sequences across every replica — the
        graceful-drain quiescence probe."""
        return sum(r.engine.pending_rows() for r in self.replicas)

    def describe(self):
        with self._lock:
            reps = [dict(r.engine.describe(), state=r.state,
                         circuit=self._circuit[r.rid],
                         failure_rate=round(
                             self._failure_rate_locked(r.rid), 3),
                         failures=r.failures, routed=r.routed,
                         dead=r.dead,
                         migrations_out=self._migrations_out[r.rid],
                         migrations_in=self._migrations_in[r.rid],
                         outstanding=self._outstanding[r.rid],
                         weight=r.weight)
                    for k in sorted(self._replicas)
                    for r in (self._replicas[k],)]
            total = self._total_outstanding
            tenants = dict(self._tenant_out)
            failovers = self._failovers
            pressure = self._pressure
            max_out = self._max_outstanding
        # pool-level KV storage rollup (per-replica cards keep the
        # detail): /healthz reads occupancy from here without walking
        # replicas
        kv_cards = [r.get("kv") for r in reps if r.get("kv")]
        paged = [k for k in kv_cards if k.get("layout") == "paged"]
        if paged:
            kv = {"layout": "paged",
                  "block_size": paged[0]["block_size"],
                  "num_blocks": sum(k["num_blocks"] for k in paged),
                  "blocks_used": sum(k["blocks_used"] for k in paged),
                  "blocks_free": sum(k["blocks_free"] for k in paged),
                  "prefix_hits": sum(k["prefix_hits"] for k in paged),
                  "prefix_tokens_reused": sum(k["prefix_tokens_reused"]
                                              for k in paged),
                  "cow_copies": sum(k["cow_copies"] for k in paged),
                  "hbm_bytes": sum(k["hbm_bytes"] for k in paged)}
        elif kv_cards:
            kv = {"layout": "dense",
                  "hbm_bytes": sum(k["hbm_bytes"] for k in kv_cards)}
        else:
            kv = None
        return {"name": self.name, "version": self.version,
                "kind": "generate", "replicas": reps, "kv": kv,
                "outstanding": total,
                "max_outstanding": max_out,
                "priority_floor": self._priority_floor,
                "shed_pressure": pressure,
                "quotas": dict(self._quotas),
                "retry_budgets": dict(self._retry_budgets),
                "failovers": failovers,
                "tenants_outstanding": tenants}

    def close(self, drain=True, successor=None):
        """Drain (by default) and permanently stop every replica — what
        the registry calls on the OLD pool after a pointer-flip swap.
        With ``successor`` (the newly registered servable), in-flight
        stragglers are NOT errored: each one migrates onto the
        successor (``adopt``/``resume``) and finishes there —
        bit-identical to an uninterrupted run when the successor
        serves the same params (see the class docstring for the
        new-weights case).  Returns True when no session was lost
        (migrated sessions are not losses; shed sessions carry a typed
        error, they are never silently dropped)."""
        with self._lock:
            self._closed = True
        clean = True
        adopt = None
        if successor is not None:
            adopt = getattr(successor, "adopt", None) \
                or getattr(successor, "resume", None)
        for r in self.replicas:
            if adopt is not None:
                orphans = []
                try:
                    r.engine.stop(drain=False, hand_off=orphans.extend)
                except Exception:  # noqa: broad-except — one dead
                    # replica must not block the swap
                    clean = False
                    _log.warning("pool %r: stop of replica %d failed "
                                 "during version swap", self.name, r.rid,
                                 exc_info=True)
                for sess in orphans:
                    if sess.finished():
                        continue
                    if sess.cancelled():
                        self._shed_session(sess, "abandoned", MXNetError(
                            "session abandoned by the client during a "
                            "version swap"))
                        continue
                    # release THIS pool's accounting; the successor
                    # runs its own books from here on
                    tenant_key = sess.tenant if sess.tenant is not None \
                        else "*"
                    self._settle(r.rid, tenant_key)
                    sess._on_done = None
                    try:
                        adopt(sess)
                    except Exception as e:  # noqa: broad-except — an
                        # unadoptable straggler sheds typed, not lost
                        clean = False
                        self._shed_session(sess, "failover", MXNetError(
                            "version-swap migration failed: %s" % (e,)))
                        continue
                    _telemetry.event("serving.failover.version_swap",
                                     model=self.name, src=str(r.rid),
                                     tokens_generated=len(sess.tokens))
            try:
                if r.engine.close(drain=drain and adopt is None) is False:
                    clean = False
            except Exception:  # noqa: broad-except — closing one dead
                # replica must not leak the others
                clean = False
                _log.warning("pool %r: close of replica %d failed",
                             self.name, r.rid, exc_info=True)
        return clean


def _cuda_devices():
    """Every CUDA device; raises without one (nothing falls back to the
    CPU)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise MXNetError("the replica pool needs a CUDA device (none "
                         "present); pass devices=[\"cpu\"] to run on the "
                         "CPU")
    return [torch.device("cuda", i) for i in range(n)]


def lm_pool(cfg, params, n_replicas=2, devices=None, *, name="lm",
            version=1, engine_opts=None, **pool_opts):
    """Build a :class:`ReplicaPool` of
    :class:`~mxnet_tpu_torch.serving.decode.DecodeEngine` replicas over a
    :mod:`~mxnet_tpu_torch.models.transformer_lm` — the standard
    LM-serving stack.  Replicas on one device share one copy of the
    params."""
    opts = dict(engine_opts or {})
    placed = {}

    def factory(device, replica_id):
        if device not in placed:
            placed[device] = _tlm.params_to(params, device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        return DecodeEngine(cfg, placed[device], device=device, name=name,
                            replica=replica_id, autostart=True, **opts)

    return ReplicaPool(factory, n_replicas=n_replicas, devices=devices,
                       name=name, version=version, **pool_opts)
