"""Fleet control plane: SLO-driven autoscaling, placement and supervised
serving over the decode tier (counterpart of
``mxnet_tpu/serving/controller.py``).

A :class:`FleetController` ticks over every
:class:`~mxnet_tpu_torch.serving.pool.ReplicaPool` registered in a
:class:`~mxnet_tpu_torch.serving.registry.ModelRegistry` and closes four
loops per model:

* **autoscaling**: an :class:`AutoscalePolicy` compares the windowed
  TTFT p99 (``serving.decode.ttft_seconds`` bucket-count deltas, not the
  process's whole history) and the admission fill against
  ``MXNET_FLEET_SLO_TTFT_MS``; a sustained breach grows the pool
  (``ReplicaPool.add_replica``: the engine is warmed, every prefill
  bucket and the step, BEFORE it is published to routing), sustained
  slack shrinks it (``remove_replica``: live sessions migrate through
  ``resume()``, the same stream, budget-free).  Breach/slack streaks and
  a cooldown after each scale keep the loop from flapping.
* **placement**: a :class:`DeviceFleet` bin-packs every model's replicas
  onto the CUDA devices (``MXNET_FLEET_REPLICAS_PER_DEVICE`` a device)
  and periodically proposes a move from the most- to the least-loaded
  device: add on the target first, then drain the source by migration.
* **supervised serving**: per-replica liveness from the decode engine's
  heartbeat (``DecodeEngine.heartbeat_age``) and the pool's hard-kill
  flag (``Replica.dead``); a dead or wedged replica is replaced (same
  device, warmed before routing; the survivors adopted its sessions at
  kill time) under a backoff and ``MXNET_RESTART_BUDGET``; a model that
  spends its budget is QUARANTINED: the controller stops replacing and
  says so instead of thrashing.
* **priority shedding**: when the SLO is breached and the fleet cannot
  grow (device capacity or ``MXNET_FLEET_MAX_REPLICAS``), the controller
  turns on the pool's admission pressure (``set_shed_pressure``):
  requests below the priority floor shed typed from the first
  outstanding request.  In-flight generations are never dropped.

Every decision lands in the ``serving.fleet.*`` telemetry family and in a
bounded ring the frontend serves at ``GET /fleet`` (and a summary block
in ``/healthz``).  The settings and their defaults are the JAX
package's: ``MXNET_FLEET_SLO_TTFT_MS`` (500), ``MXNET_FLEET_BREACH_TICKS``
(3), ``MXNET_FLEET_SLACK_TICKS`` (10), ``MXNET_FLEET_COOLDOWN_MS`` (5000),
``MXNET_FLEET_MAX_REPLICAS`` (8), ``MXNET_FLEET_REPLICAS_PER_DEVICE`` (4),
``MXNET_FLEET_INTERVAL_MS`` (500), ``MXNET_FLEET_HEARTBEAT_S`` (0: liveness
by the hard-kill flag only) and ``MXNET_RESTART_BUDGET`` (5).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

from .. import telemetry as _telemetry
from ..base import MXNetError
from ..base import env_float as _env_float
from ..base import env_int as _env_int
from .pool import ACTIVE, _cuda_devices

__all__ = ["Observation", "AutoscalePolicy", "DeviceFleet",
           "FleetController", "HOLD", "SCALE_UP", "SCALE_DOWN", "SHED",
           "UNSHED"]

_log = logging.getLogger("mxnet_tpu_torch.serving")

#: policy decisions (``AutoscalePolicy.decide`` return values)
HOLD = "hold"
SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"
SHED = "shed"
UNSHED = "unshed"

#: the TTFT histogram the observation window diffs
_TTFT_HIST = "serving.decode.ttft_seconds"


class Observation:
    """One tick's per-model load read — what the policy decides from.

    Plain data so the decision logic is testable from synthetic
    snapshots (no devices, no HTTP): ``ttft_p99_ms`` is the windowed
    p99 (None before the first window closes or with telemetry off),
    ``queue_frac`` the pool admission fill (outstanding /
    max_outstanding), ``occupancy`` outstanding over live decode
    slots, ``replicas`` the ACTIVE replica count, and ``can_grow``
    whether the device fleet has headroom for one more."""

    __slots__ = ("ttft_p99_ms", "queue_frac", "occupancy", "replicas",
                 "can_grow")

    def __init__(self, ttft_p99_ms=None, queue_frac=0.0, occupancy=0.0,
                 replicas=1, can_grow=True):
        self.ttft_p99_ms = ttft_p99_ms
        self.queue_frac = float(queue_frac)
        self.occupancy = float(occupancy)
        self.replicas = int(replicas)
        self.can_grow = bool(can_grow)

    def __repr__(self):
        return ("Observation(ttft_p99_ms=%r, queue_frac=%.3f, "
                "occupancy=%.3f, replicas=%d, can_grow=%r)"
                % (self.ttft_p99_ms, self.queue_frac, self.occupancy,
                   self.replicas, self.can_grow))


class AutoscalePolicy:
    """Hysteresis + cooldown autoscaling decisions, one instance per
    model.  Pure decision logic over :class:`Observation` snapshots —
    no telemetry reads, no pool calls, no threads — so unit tests
    drive it tick by tick.

    A tick is a BREACH when the windowed TTFT p99 exceeds the SLO
    target or admission fill crosses ``queue_high``; ``breach_ticks``
    consecutive breaches scale up (or, when the fleet cannot grow,
    turn shedding on — shed-before-fail, never scale into capacity
    that is not there).  A tick is SLACK when TTFT sits under
    ``slack_frac`` of the SLO with low occupancy and a near-empty
    queue; ``slack_ticks`` consecutive slack ticks scale down, never
    below ``min_replicas``.  Any scale starts a ``cooldown_s`` window
    during which further scaling holds — the no-flap guarantee is the
    streaks + cooldown together.  Shedding turns off only after the
    breach fully clears for ``breach_ticks`` ticks."""

    def __init__(self, slo_ttft_ms=None, breach_ticks=None,
                 slack_ticks=None, cooldown_s=None, min_replicas=1,
                 max_replicas=None, slack_frac=0.5, queue_high=0.85,
                 occupancy_low=0.5):
        self.slo_ttft_ms = float(slo_ttft_ms) if slo_ttft_ms is not None \
            else _env_float("MXNET_FLEET_SLO_TTFT_MS", 500.0)
        self.breach_ticks = int(breach_ticks) if breach_ticks is not None \
            else _env_int("MXNET_FLEET_BREACH_TICKS", 3)
        self.slack_ticks = int(slack_ticks) if slack_ticks is not None \
            else _env_int("MXNET_FLEET_SLACK_TICKS", 10)
        self.cooldown_s = float(cooldown_s) if cooldown_s is not None \
            else _env_float("MXNET_FLEET_COOLDOWN_MS", 5000.0) / 1e3
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = int(max_replicas) if max_replicas is not None \
            else _env_int("MXNET_FLEET_MAX_REPLICAS", 8)
        self.slack_frac = float(slack_frac)
        self.queue_high = float(queue_high)
        self.occupancy_low = float(occupancy_low)
        self.breach_streak = 0
        self.slack_streak = 0
        self.clear_streak = 0
        self.last_scale = None
        self.shedding = False

    def decide(self, obs, now):
        """One control decision from one :class:`Observation`; returns
        ``(action, info)`` with ``action`` one of :data:`HOLD` /
        :data:`SCALE_UP` / :data:`SCALE_DOWN` / :data:`SHED` /
        :data:`UNSHED` and ``info`` the evidence (streaks, the breach
        signal, cooldown state) for the decision ring."""
        breach = (obs.ttft_p99_ms is not None
                  and obs.ttft_p99_ms > self.slo_ttft_ms) \
            or obs.queue_frac >= self.queue_high
        slack = (not breach
                 and obs.occupancy <= self.occupancy_low
                 and obs.queue_frac <= 0.25
                 and (obs.ttft_p99_ms is None
                      or obs.ttft_p99_ms
                      <= self.slack_frac * self.slo_ttft_ms))
        if breach:
            self.breach_streak += 1
            self.slack_streak = 0
            self.clear_streak = 0
        else:
            self.breach_streak = 0
            self.clear_streak += 1
            self.slack_streak = self.slack_streak + 1 if slack else 0
        cooling = self.last_scale is not None \
            and (now - self.last_scale) < self.cooldown_s
        info = {"ttft_p99_ms": obs.ttft_p99_ms,
                "queue_frac": round(obs.queue_frac, 3),
                "occupancy": round(obs.occupancy, 3),
                "replicas": obs.replicas, "breach": breach,
                "breach_streak": self.breach_streak,
                "slack_streak": self.slack_streak,
                "cooldown": cooling, "shedding": self.shedding}

        if self.breach_streak >= self.breach_ticks:
            grown = obs.replicas < self.max_replicas and obs.can_grow
            if grown and not cooling:
                self.last_scale = now
                self.breach_streak = 0
                return SCALE_UP, info
            if not grown and not self.shedding:
                # fleet exhausted: shed by priority instead of failing
                self.shedding = True
                info["shedding"] = True
                return SHED, info
            return HOLD, info  # cooling down, or already shedding
        if self.shedding and self.clear_streak >= self.breach_ticks:
            self.shedding = False
            info["shedding"] = False
            return UNSHED, info
        if self.slack_streak >= self.slack_ticks \
                and obs.replicas > self.min_replicas and not cooling \
                and not self.shedding:
            self.last_scale = now
            self.slack_streak = 0
            return SCALE_DOWN, info
        return HOLD, info


class DeviceFleet:
    """The shared placement book: which device hosts which (model,
    replica), with a per-device replica cap
    (``MXNET_FLEET_REPLICAS_PER_DEVICE``).  Pure bookkeeping (it never
    touches engines), so the bin-packing is unit-testable and the
    controller's actuators (``add_replica(device=...)``) stay the only
    side-effecting path.  ``devices`` defaults to every CUDA device
    (raising without one); they are ``torch.device`` objects, or any
    labels in bookkeeping-only use.  Devices match by identity or by
    ``str``, so ``"cuda:0"`` and ``torch.device("cuda", 0)`` are one
    device."""

    def __init__(self, devices=None, per_device=None):
        self._devices = list(devices) if devices is not None \
            else _cuda_devices()
        if not self._devices:
            raise MXNetError("DeviceFleet needs >= 1 device")
        self._per = int(per_device) if per_device is not None \
            else _env_int("MXNET_FLEET_REPLICAS_PER_DEVICE", 4)
        self._lock = threading.Lock()
        self._placements = {}  # (model, rid) -> device index

    def _loads_locked(self):
        loads = [0] * len(self._devices)
        for idx in self._placements.values():
            loads[idx] += 1
        return loads

    def _index_of_locked(self, device):
        for i, d in enumerate(self._devices):
            if d is device or str(d) == str(device):
                return i
        return None

    def least_loaded(self):
        """The device a new replica should land on, or None when every
        device is at its cap."""
        with self._lock:
            loads = self._loads_locked()
            idx = min(range(len(self._devices)), key=lambda i: loads[i])
            if loads[idx] >= self._per:
                return None
            return self._devices[idx]

    def assign(self, model, rid, device):
        """Record that ``(model, rid)`` runs on ``device`` (placements
        discovered at adoption time land here too — unknown devices
        count against device 0 rather than being lost)."""
        with self._lock:
            idx = self._index_of_locked(device)
            self._placements[(model, rid)] = 0 if idx is None else idx

    def release(self, model, rid):
        with self._lock:
            self._placements.pop((model, rid), None)

    def release_model(self, model):
        """Drop every placement of ``model`` (pointer-flip swap: the
        new pool's replicas re-seed)."""
        with self._lock:
            for key in [k for k in self._placements if k[0] == model]:
                del self._placements[key]

    def device_of(self, model, rid):
        with self._lock:
            idx = self._placements.get((model, rid))
            return None if idx is None else self._devices[idx]

    def capacity_left(self):
        with self._lock:
            return self._per * len(self._devices) - len(self._placements)

    def suggest_move(self):
        """One rebalancing move ``(model, rid, target_device)`` from
        the most- to the least-loaded device, or None when the packing
        is already within one replica of even."""
        with self._lock:
            if not self._placements:
                return None
            loads = self._loads_locked()
            hi = max(range(len(self._devices)), key=lambda i: loads[i])
            lo = min(range(len(self._devices)), key=lambda i: loads[i])
            if loads[hi] - loads[lo] <= 1 or loads[lo] >= self._per:
                return None
            for (model, rid), idx in sorted(self._placements.items(),
                                            key=lambda kv: str(kv[0])):
                if idx == hi:
                    return model, rid, self._devices[lo]
            return None

    def describe(self):
        with self._lock:
            loads = self._loads_locked()
            placements = {"%s/%s" % k: str(self._devices[v])
                          for k, v in sorted(self._placements.items(),
                                             key=lambda kv: str(kv[0]))}
        return {"devices": [str(d) for d in self._devices],
                "per_device": self._per, "loads": loads,
                "placements": placements}


class _ModelState:
    """Per-managed-pool controller bookkeeping (mutated only with the
    controller's lock held or from the controller thread; replaced
    wholesale on a version swap)."""

    def __init__(self, pool, policy, now, budget):
        self.pool = pool
        self.policy = policy
        self.ttft_counts = None   # last hist_state counts (the window)
        self.ttft_total = 0
        self.breach_since = None  # SLO-recovery stopwatch
        self.restarts_used = 0
        self.restart_budget = budget
        self.last_restart = None
        self.last_healthy = now
        self.backoff = 0.0
        self.quarantined = False


class FleetController:
    """The closed control loop: a monitor thread ticks every
    ``MXNET_FLEET_INTERVAL_MS`` over the registry's decode pools —
    supervise (replace dead/wedged replicas), observe (windowed TTFT
    p99 + admission pressure), decide (:class:`AutoscalePolicy`), act
    (scale / shed / rebalance through the pool's actuators).  All
    controller state lives behind ``self._lock``; pool and registry
    locks are only ever taken while it is NOT held by the same
    call-path's callee (the pool never calls back into the
    controller), so there is no lock-order cycle."""

    def __init__(self, registry, fleet=None, interval_ms=None,
                 heartbeat_timeout=None, restart_budget=None,
                 backoff_base=0.5, backoff_max=30.0, healthy_reset_s=60.0,
                 rebalance_every_s=10.0, policy_opts=None):
        self._registry = registry
        self._fleet = fleet if fleet is not None else DeviceFleet()
        self._interval = (float(interval_ms) if interval_ms is not None
                          else _env_float("MXNET_FLEET_INTERVAL_MS",
                                          500.0)) / 1e3
        hb = heartbeat_timeout if heartbeat_timeout is not None \
            else _env_float("MXNET_FLEET_HEARTBEAT_S", 0.0)
        self._hb_timeout = float(hb) or None  # 0 / None: liveness by
        # the pool's hard-kill flag only (CI machines stall arbitrarily)
        self._budget = int(restart_budget) if restart_budget is not None \
            else _env_int("MXNET_RESTART_BUDGET", 5)
        self._backoff_base = float(backoff_base)
        self._backoff_max = float(backoff_max)
        self._healthy_reset = float(healthy_reset_s)
        self._rebalance_every = float(rebalance_every_s)
        self._policy_opts = dict(policy_opts or {})
        self._lock = threading.Lock()
        self._models = {}         # name -> _ModelState
        self._decisions = deque(maxlen=64)
        self._ticks = 0
        self._last_rebalance = 0.0
        self._closed = False
        self._thread = None
        self._stop = threading.Event()
        attach = getattr(registry, "attach_controller", None)
        if attach is not None:
            attach(self)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        with self._lock:
            if self._closed:
                raise MXNetError("fleet controller is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="fleet-controller",
                    daemon=True)
                self._thread.start()
        return self

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            thread = self._thread
        self._stop.set()
        if thread is not None:
            thread.join(timeout=10)

    stop = close

    def _loop(self):
        while not self._stop.wait(self._interval):
            try:
                self.tick()
            except Exception:  # noqa: broad-except — the control loop
                # must outlive any single bad tick; the failure is
                # telemetry, not a dead fleet
                _log.exception("fleet controller: tick failed")
                _telemetry.inc("serving.fleet.tick_errors.count")

    # -- the loop body ------------------------------------------------------
    def tick(self, now=None):
        """One supervise→observe→decide→act pass over every managed
        pool (public so tests single-step the loop without the
        thread)."""
        now = time.monotonic() if now is None else now
        pools = [(m.name, m) for m in self._registry.models()
                 if hasattr(m, "add_replica")]
        with self._lock:
            if self._closed:
                return
            self._ticks += 1
            live = {name for name, _ in pools}
            for name in [n for n in self._models if n not in live]:
                del self._models[name]
                self._fleet.release_model(name)
            states = []
            for name, pool in pools:
                st = self._models.get(name)
                if st is None or st.pool is not pool:
                    st = self._new_state(name, pool, now)
                    self._models[name] = st
                states.append((name, st))
        for name, st in states:
            if st is None:
                continue
            self._supervise(name, st, now)
            obs = self._observe(name, st, now)
            action, info = st.policy.decide(obs, now)
            self._act(name, st, obs, action, info, now)
        self._maybe_rebalance(now)

    def _new_state(self, name, pool, now):
        """Start managing ``pool`` under ``name``: fresh policy +
        restart budget, placements seeded from the replicas' current
        devices.  Touches no controller state — the caller owns the
        ``self._models`` write (under the controller lock)."""
        self._fleet.release_model(name)
        policy = AutoscalePolicy(**self._policy_opts)
        st = _ModelState(pool, policy, now, self._budget)
        for r in list(pool.replicas):
            self._fleet.assign(name, r.rid, r.device)
        _telemetry.event("serving.fleet.adopt", model=name,
                         replicas=len(pool.replicas))
        _log.info("fleet: managing pool %r (%d replica(s))", name,
                  len(pool.replicas))
        return st

    def on_register(self, name, servable):
        """Registry hook, fired after a pointer-flip swap: drop the old
        pool's state so the next tick adopts the successor with fresh
        placements (a non-pool servable simply stops being managed)."""
        with self._lock:
            self._models.pop(name, None)
            self._fleet.release_model(name)

    # -- supervise ----------------------------------------------------------
    def _supervise(self, name, st, now):
        """Replace dead / wedged replicas under the restart-budget +
        backoff discipline; quarantine the model's replacement loop
        when the budget is spent (sessions were already adopted by the
        survivors at kill time — the pool did that)."""
        suspects = []
        for r in list(st.pool.replicas):
            if r.state != ACTIVE and not r.dead:
                continue
            stale = None
            if not r.dead and self._hb_timeout:
                age_fn = getattr(r.engine, "heartbeat_age", None)
                age = age_fn() if age_fn is not None else None
                if age is not None and age > self._hb_timeout:
                    stale = age
            if r.dead or stale is not None:
                suspects.append((r, stale))
        if not suspects:
            if st.last_restart is not None \
                    and now - st.last_restart >= self._healthy_reset \
                    and st.restarts_used:
                # a quiet stretch of healthy_reset_s pays the budget back
                st.restarts_used = 0
                st.backoff = 0.0
                _telemetry.event("serving.fleet.budget_reset", model=name)
            return
        for r, stale in suspects:
            if st.quarantined:
                return
            if st.restarts_used >= st.restart_budget:
                st.quarantined = True
                _telemetry.inc("serving.fleet.quarantines.count",
                               model=name)
                self._note(name, "quarantine", replica=r.rid,
                           restarts=st.restarts_used,
                           budget=st.restart_budget)
                _log.error(
                    "fleet: model %r exhausted its restart budget "
                    "(%d) — replica replacement QUARANTINED, serving "
                    "on the survivors", name, st.restart_budget)
                return
            if st.last_restart is not None \
                    and now - st.last_restart < st.backoff:
                return  # backing off; re-check next tick
            dev = self._fleet.device_of(name, r.rid)
            try:
                st.pool.remove_replica(r.rid, migrate=True)
            except MXNetError:
                pass  # already removed by a racing actor
            self._fleet.release(name, r.rid)
            st.restarts_used += 1
            st.last_restart = now
            st.backoff = min(self._backoff_max,
                             self._backoff_base * (2 ** (st.restarts_used
                                                         - 1)))
            try:
                new_rid = st.pool.add_replica(device=dev)
            except Exception as e:  # noqa: broad-except — a failed
                # rebuild (device gone, OOM) burns budget and backs
                # off; the pool keeps serving on the survivors
                _telemetry.inc("serving.fleet.restart_failures.count",
                               model=name)
                self._note(name, "restart_failed", replica=r.rid,
                           error=str(e))
                _log.warning("fleet: replacing replica %d of %r failed",
                             r.rid, name, exc_info=True)
                continue
            self._fleet.assign(name, new_rid, dev)
            _telemetry.inc("serving.fleet.restarts.count", model=name)
            self._note(name, "restart", replica=r.rid, new_replica=new_rid,
                       wedged_s=stale, restarts=st.restarts_used,
                       budget=st.restart_budget)
            _log.warning(
                "fleet: replica %d of %r %s — replaced by replica %d "
                "on %s (restart %d/%d)", r.rid, name,
                "heartbeat stale %.1fs" % stale if stale is not None
                else "dead", new_rid, dev, st.restarts_used,
                st.restart_budget)

    # -- observe ------------------------------------------------------------
    def _observe(self, name, st, now):
        out, max_out, _pressure = st.pool.admission_state()
        queue_frac = out / float(max(1, max_out))
        ttft_ms = None
        hs = _telemetry.hist_state(_TTFT_HIST, model=name)
        if hs is not None:
            if st.ttft_counts is not None and hs["count"] > st.ttft_total:
                delta = [a - b for a, b in zip(hs["counts"],
                                               st.ttft_counts)]
                q = _telemetry.quantile_from_counts(
                    hs["buckets"], delta, 0.99, lo=0.0, hi=hs["max"])
                if q is not None:
                    ttft_ms = q * 1e3
            st.ttft_counts = list(hs["counts"])
            st.ttft_total = hs["count"]
        live = [r for r in st.pool.replicas
                if r.state == ACTIVE and not r.dead]
        slots = sum(max(1, getattr(r.engine, "slots", 1)) for r in live)
        obs = Observation(
            ttft_p99_ms=ttft_ms, queue_frac=queue_frac,
            occupancy=out / float(max(1, slots)),
            replicas=len(live),
            can_grow=self._fleet.capacity_left() > 0)
        _telemetry.set_gauge("serving.fleet.replicas", obs.replicas,
                             model=name)
        if ttft_ms is not None:
            _telemetry.set_gauge("serving.fleet.ttft_p99_ms", ttft_ms,
                                 model=name)
        # SLO breach / recovery stopwatch
        # (serving.fleet.slo_recovery_seconds)
        slo = st.policy.slo_ttft_ms
        if ttft_ms is not None and ttft_ms > slo:
            if st.breach_since is None:
                st.breach_since = now
                _telemetry.inc("serving.fleet.slo_breaches.count",
                               model=name)
                self._note(name, "slo_breach", ttft_p99_ms=ttft_ms,
                           slo_ttft_ms=slo)
        elif ttft_ms is not None and st.breach_since is not None:
            recovery = now - st.breach_since
            st.breach_since = None
            _telemetry.observe("serving.fleet.slo_recovery_seconds",
                               recovery, model=name)
            self._note(name, "slo_recovery", ttft_p99_ms=ttft_ms,
                       recovery_ms=round(recovery * 1e3, 1))
        return obs

    # -- act ----------------------------------------------------------------
    def _act(self, name, st, obs, action, info, now):
        if action == HOLD:
            return
        if action == SCALE_UP:
            dev = self._fleet.least_loaded()
            if dev is None:  # raced to full between observe and act
                return
            try:
                rid = st.pool.add_replica(device=dev)
            except Exception as e:  # noqa: broad-except — a failed
                # grow must not kill the loop; the breach streak will
                # re-trigger
                self._note(name, "scale_up_failed", error=str(e))
                _log.warning("fleet: scale-up of %r failed", name,
                             exc_info=True)
                return
            self._fleet.assign(name, rid, dev)
            _telemetry.inc("serving.fleet.scale_ups.count", model=name)
            self._note(name, SCALE_UP, replica=rid, device=str(dev),
                       **info)
            _log.info("fleet: %r scaled UP to %d replicas (TTFT p99 "
                      "%s ms, queue %.0f%%)", name, obs.replicas + 1,
                      "%.1f" % obs.ttft_p99_ms
                      if obs.ttft_p99_ms is not None else "n/a",
                      100 * obs.queue_frac)
        elif action == SCALE_DOWN:
            live = [r for r in st.pool.replicas
                    if r.state == ACTIVE and not r.dead]
            if len(live) <= st.policy.min_replicas:
                return
            victim = max(live, key=lambda r: r.rid)  # youngest first
            try:
                st.pool.remove_replica(victim.rid, migrate=True)
            except MXNetError:
                return  # a racing actor already removed it
            self._fleet.release(name, victim.rid)
            _telemetry.inc("serving.fleet.scale_downs.count", model=name)
            self._note(name, SCALE_DOWN, replica=victim.rid, **info)
            _log.info("fleet: %r scaled DOWN to %d replicas (sustained "
                      "slack)", name, len(live) - 1)
        elif action == SHED:
            st.pool.set_shed_pressure(True)
            _telemetry.inc("serving.fleet.sheds.count", model=name)
            self._note(name, SHED, **info)
            _log.warning("fleet: %r exhausted the fleet at max scale — "
                         "priority shedding ON", name)
        elif action == UNSHED:
            st.pool.set_shed_pressure(False)
            self._note(name, UNSHED, **info)
            _log.info("fleet: %r breach cleared — priority shedding off",
                      name)

    # -- rebalance ----------------------------------------------------------
    def _maybe_rebalance(self, now):
        with self._lock:
            if now - self._last_rebalance < self._rebalance_every:
                return
            self._last_rebalance = now
            states = dict(self._models)
        move = self._fleet.suggest_move()
        if move is None:
            return
        model, rid, dst = move
        st = states.get(model)
        if st is None or st.quarantined:
            return
        # add on the target FIRST (warmed before routing), then drain
        # the source by migration — the move costs no request anything
        try:
            new_rid = st.pool.add_replica(device=dst)
        except Exception:  # noqa: broad-except — no capacity to stage
            # the move safely; try again next period
            _log.warning("fleet: rebalance add for %r failed", model,
                         exc_info=True)
            return
        self._fleet.assign(model, new_rid, dst)
        try:
            st.pool.remove_replica(rid, migrate=True)
        except MXNetError:
            pass  # already gone; the add still improved the packing
        self._fleet.release(model, rid)
        _telemetry.inc("serving.fleet.rebalances.count", model=model)
        self._note(model, "rebalance", replica=rid, new_replica=new_rid,
                   device=str(dst))
        _log.info("fleet: rebalanced %r replica %d -> %d on %s", model,
                  rid, new_rid, dst)

    # -- introspection ------------------------------------------------------
    def _note(self, model, action, **info):
        entry = {"t": time.time(), "model": model, "action": action}
        entry.update(info)
        with self._lock:
            self._decisions.append(entry)
        _telemetry.event("serving.fleet.decision", model=model,
                         action=action, **info)

    def decisions(self):
        """The bounded decision ring, oldest first (``GET /fleet``)."""
        with self._lock:
            return list(self._decisions)

    def describe(self):
        """Structured controller card for ``GET /fleet`` and the
        ``/healthz`` fleet block."""
        with self._lock:
            ticks = self._ticks
            running = self._thread is not None and not self._closed
            models = {
                name: {"quarantined": st.quarantined,
                       "restarts_used": st.restarts_used,
                       "restart_budget": st.restart_budget,
                       "breaching": st.breach_since is not None,
                       "shedding": st.policy.shedding,
                       "slo_ttft_ms": st.policy.slo_ttft_ms}
                for name, st in sorted(self._models.items())}
            decisions = list(self._decisions)
        return {"running": running, "ticks": ticks,
                "interval_ms": self._interval * 1e3,
                "models": models, "fleet": self._fleet.describe(),
                "decisions": decisions[-16:]}
