"""The port's fleet control plane (``mxnet_tpu_torch.serving.controller``)
on the CPU against the JAX package's: the same :class:`AutoscalePolicy`
decisions on the same seeded observation sequences, the same
:class:`DeviceFleet` bookkeeping under the same operations, the same
controller card and the same ``serving.fleet.*`` telemetry names; then
twins of the JAX package's ``tests/test_fleet.py`` controller tests over
the port's CPU decode stack (a tiny ``transformer_lm``): add and remove a
replica with migration, shed pressure, replace a dead replica, quarantine,
scale up on an observed breach, shed at fleet capacity and recover,
``/fleet`` and the ``/healthz`` block, 404 without a controller; greedy
streams through a kill and its replacement equal the JAX engine's token
for token."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.models import transformer_lm as jtlm
from mxnet_tpu.serving import AutoscalePolicy as JaxPolicy
from mxnet_tpu.serving import DecodeEngine as JaxEngine
from mxnet_tpu.serving import DeviceFleet as JaxFleet
from mxnet_tpu.serving import FleetController as JaxController
from mxnet_tpu.serving import ModelRegistry as JaxRegistry
from mxnet_tpu.serving import Observation as JaxObservation
from mxnet_tpu.serving import lm_pool as jax_lm_pool
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import faults, telemetry
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.serving import (HOLD, SCALE_DOWN, SCALE_UP, SHED,
                                     UNSHED, AutoscalePolicy, DeviceFleet,
                                     FleetController, ModelRegistry,
                                     Observation, Overloaded,
                                     ServingHTTPServer, lm_pool)
from torch_deadline import deadline  # noqa: F401 (autouse)

CFG = tlm.LMConfig(32, 16, 2, 2, 32, 32, eos_id=32)
PARAMS = tlm.init_params(CFG, seed=3)
PROMPT = [5, 7, 9, 2]
PROMPTS = [PROMPT, [1, 2, 3, 4, 5, 6], [9, 9, 9], [30, 1, 4, 1, 5, 9, 2, 6]]
OPTS = {"slots": 4, "prefill_buckets": (4, 8), "max_queue": 64}
CPU = ["cpu"]


@pytest.fixture(autouse=True)
def _clean():
    faults.disarm()
    telemetry.reset()
    telemetry.enable()
    yield
    faults.disarm()
    telemetry.disable()
    telemetry.reset()


def _wait(cond, what, timeout=60):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, what() if callable(what) else what
        time.sleep(0.01)


# -- AutoscalePolicy: the same decisions as the JAX package -----------------

def _random_policy_opts(rs):
    return dict(slo_ttft_ms=float(rs.choice([50.0, 200.0, 500.0])),
                breach_ticks=int(rs.randint(1, 5)),
                slack_ticks=int(rs.randint(1, 6)),
                cooldown_s=float(rs.choice([0.0, 0.5, 2.0, 5.0])),
                min_replicas=int(rs.randint(1, 3)),
                max_replicas=int(rs.randint(1, 6)),
                slack_frac=float(rs.choice([0.3, 0.5])),
                queue_high=float(rs.choice([0.7, 0.85])),
                occupancy_low=float(rs.choice([0.3, 0.5])))


def _random_observation(rs, slo, replicas, cap):
    ttft = None if rs.rand() < 0.2 else float(
        slo * np.exp(rs.normal(0.0, 0.8)))
    return dict(ttft_p99_ms=ttft, queue_frac=float(rs.rand() ** 2),
                occupancy=float(rs.rand()), replicas=replicas,
                can_grow=bool(replicas < cap and rs.rand() < 0.9))


@pytest.mark.parametrize("seed", range(6))
def test_policy_decisions_equal_the_jax_package(seed):
    """200 ticks of seeded observations (breaches, slack, blind ticks
    without TTFT, a fleet that stops growing) with replicas following the
    decisions: every ``(action, info)`` is the JAX policy's."""
    rs = np.random.RandomState(seed)
    opts = _random_policy_opts(rs)
    port, ref = AutoscalePolicy(**opts), JaxPolicy(**opts)
    replicas, now, cap = 1, 1000.0, int(rs.randint(1, 6))
    actions = set()
    for _ in range(200):
        obs = _random_observation(rs, opts["slo_ttft_ms"], replicas, cap)
        got = port.decide(Observation(**obs), now)
        want = ref.decide(JaxObservation(**obs), now)
        assert got == want, (obs, now)
        actions.add(got[0])
        replicas += {SCALE_UP: 1, SCALE_DOWN: -1}.get(got[0], 0)
        now += float(rs.choice([0.05, 0.25, 1.0, 3.0]))
    assert (port.breach_streak, port.slack_streak, port.clear_streak,
            port.last_scale, port.shedding) == \
        (ref.breach_streak, ref.slack_streak, ref.clear_streak,
         ref.last_scale, ref.shedding)
    assert HOLD in actions and len(actions) >= 2


def test_policy_defaults_and_settings_are_the_jax_package(monkeypatch):
    fields = ("slo_ttft_ms", "breach_ticks", "slack_ticks", "cooldown_s",
              "min_replicas", "max_replicas", "slack_frac", "queue_high",
              "occupancy_low")
    assert [getattr(AutoscalePolicy(), f) for f in fields] == \
        [getattr(JaxPolicy(), f) for f in fields]
    for k, v in (("MXNET_FLEET_SLO_TTFT_MS", "123.5"),
                 ("MXNET_FLEET_BREACH_TICKS", "7"),
                 ("MXNET_FLEET_SLACK_TICKS", "9"),
                 ("MXNET_FLEET_COOLDOWN_MS", "2500"),
                 ("MXNET_FLEET_MAX_REPLICAS", "3")):
        monkeypatch.setenv(k, v)
    got = AutoscalePolicy()
    assert [getattr(got, f) for f in fields] == \
        [getattr(JaxPolicy(), f) for f in fields]
    assert (got.slo_ttft_ms, got.breach_ticks, got.cooldown_s) \
        == (123.5, 7, 2.5)


def _policy(**kw):
    opts = dict(slo_ttft_ms=100.0, breach_ticks=3, slack_ticks=4,
                cooldown_s=10.0, max_replicas=4)
    opts.update(kw)
    return AutoscalePolicy(**opts)


def _breach(replicas=1, can_grow=True):
    return Observation(ttft_p99_ms=250.0, queue_frac=0.2, occupancy=0.9,
                       replicas=replicas, can_grow=can_grow)


def _slack(replicas=2):
    return Observation(ttft_p99_ms=20.0, queue_frac=0.0, occupancy=0.1,
                       replicas=replicas, can_grow=True)


def _calm(replicas=2):
    return Observation(ttft_p99_ms=80.0, queue_frac=0.4, occupancy=0.7,
                       replicas=replicas, can_grow=True)


def test_policy_hysteresis_cooldown_and_shed_before_fail():
    """The JAX package's scripted policy cases in one pass: a sustained
    breach scales up, one breach tick never does, slack scales down only
    when sustained and never below min_replicas, the cooldown holds both
    directions, and an exhausted fleet sheds, lifting the shed only after
    ``breach_ticks`` clear ticks."""
    p = _policy()
    assert [p.decide(_breach(), float(t))[0] for t in range(3)] \
        == [HOLD, HOLD, SCALE_UP]
    p = _policy(breach_ticks=2)
    blind = Observation(ttft_p99_ms=None, queue_frac=0.95, occupancy=0.9)
    assert [p.decide(blind, float(t))[0] for t in range(2)] \
        == [HOLD, SCALE_UP]
    p = _policy()
    assert all(p.decide(_breach() if t % 2 == 0 else _calm(),
                        float(t))[0] == HOLD for t in range(20))
    p = _policy(slack_ticks=4)
    assert [p.decide(_slack(), float(t))[0] for t in range(4)] \
        == [HOLD, HOLD, HOLD, SCALE_DOWN]
    p = _policy(slack_ticks=2)
    assert all(p.decide(_slack(replicas=1), float(t))[0] == HOLD
               for t in range(10))
    p = _policy(breach_ticks=2, cooldown_s=10.0)
    p.decide(_breach(), 0.0)
    assert p.decide(_breach(), 1.0)[0] == SCALE_UP
    assert [p.decide(_breach(), t)[0] for t in (2.0, 3.0)] == [HOLD, HOLD]
    assert p.decide(_breach(replicas=2), 12.0)[0] == SCALE_UP
    p = _policy(breach_ticks=2, max_replicas=2)
    at_max = _breach(replicas=2)
    seq = [p.decide(o, float(t))[0] for t, o in enumerate(
        [at_max, at_max, at_max, _calm(), at_max, _calm(), _calm()])]
    assert seq == [HOLD, SHED, HOLD, HOLD, HOLD, HOLD, UNSHED]
    assert p.shedding is False
    p = _policy(breach_ticks=2)
    assert [p.decide(_breach(can_grow=False), float(t))[0]
            for t in range(2)] == [HOLD, SHED]


# -- DeviceFleet: the same bookkeeping as the JAX package --------------------

def _fleet_ops(rs, n):
    ops = []
    for _ in range(n):
        k = rs.randint(8)
        model = str(rs.choice(["a", "b", "c"]))
        rid = int(rs.randint(4))
        if k < 3:
            ops.append(("assign", model, rid,
                        str(rs.choice(["d0", "d1", "d2", "dx"]))))
        elif k == 3:
            ops.append(("release", model, rid))
        elif k == 4 and rs.rand() < 0.3:
            ops.append(("release_model", model))
        else:
            ops.append(("device_of", model, rid))
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_device_fleet_bookkeeping_equals_the_jax_package(seed):
    rs = np.random.RandomState(seed)
    per = int(rs.randint(1, 4))
    port = DeviceFleet(devices=["d0", "d1", "d2"], per_device=per)
    ref = JaxFleet(devices=["d0", "d1", "d2"], per_device=per)
    for op in _fleet_ops(rs, 120):
        assert getattr(port, op[0])(*op[1:]) == getattr(ref, op[0])(*op[1:])
        assert port.least_loaded() == ref.least_loaded()
        assert port.capacity_left() == ref.capacity_left()
        assert port.suggest_move() == ref.suggest_move()
        assert port.describe() == ref.describe()


def test_device_fleet_binpacks_caps_and_suggests_moves():
    fleet = DeviceFleet(devices=["d0", "d1"], per_device=2)
    assert fleet.capacity_left() == 4 and fleet.least_loaded() == "d0"
    fleet.assign("a", 0, "d0")
    assert fleet.least_loaded() == "d1"
    fleet.assign("a", 1, "d1")
    fleet.assign("b", 0, "d0")
    fleet.assign("b", 1, "d1")
    assert fleet.capacity_left() == 0 and fleet.least_loaded() is None
    fleet.release("b", 1)
    assert fleet.least_loaded() == "d1" and fleet.device_of("a", 0) == "d0"
    assert fleet.describe()["loads"] == [2, 1]
    fleet = DeviceFleet(devices=["d0", "d1"], per_device=4)
    fleet.assign("a", 0, "d0")
    fleet.assign("a", 1, "d0")
    assert fleet.suggest_move() == ("a", 0, "d1")
    fleet.release("a", 0)
    fleet.assign("a", 2, "d1")
    assert fleet.suggest_move() is None
    fleet.release_model("a")
    assert fleet.describe()["placements"] == {}


def test_device_fleet_holds_torch_devices(monkeypatch):
    """Devices are ``torch.device``s; a replica's device given as a
    string names the same one.  Without a card the default fleet raises:
    nothing falls back to the CPU."""
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    fleet = DeviceFleet(devices=[d0, d1], per_device=2)
    fleet.assign("lm", 0, "cuda:1")
    fleet.assign("lm", 1, d1)
    assert fleet.device_of("lm", 0) is d1
    assert fleet.least_loaded() is d0
    assert fleet.suggest_move() == ("lm", 0, d0)
    assert fleet.describe()["devices"] == ["cuda:0", "cuda:1"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mx.MXNetError, match="CUDA"):
        DeviceFleet()
    with pytest.raises(mx.MXNetError, match="CUDA"):
        FleetController(ModelRegistry(ctx=mx.cpu()))


def test_controller_card_equals_the_jax_package():
    cards = []
    for reg, fleet, ctl in ((ModelRegistry(ctx=mx.cpu()), DeviceFleet,
                             FleetController),
                            (JaxRegistry(), JaxFleet, JaxController)):
        c = ctl(reg, fleet=fleet(devices=["d0", "d1"], per_device=3),
                interval_ms=125, restart_budget=2)
        assert reg.controller is c
        c.tick(now=5.0)
        c.tick(now=6.0)
        cards.append(c.describe())
        c.close()
    assert cards[0] == cards[1]
    assert cards[0]["ticks"] == 2 and cards[0]["running"] is False


# -- the pool's actuators ------------------------------------------------------

def _twin_streams(reqs):
    ref = lm_pool(CFG, PARAMS, n_replicas=1, devices=CPU, engine_opts=OPTS)
    try:
        return [ref.generate(p, **kw).result(60) for p, kw in reqs]
    finally:
        ref.close()


def test_pool_add_remove_replica_migrates_live_sessions():
    """Scale-down with a session mid-generation: the session migrates
    through ``resume()`` (budget-free, the same stream) and the pool
    serves on with the new membership."""
    req = (PROMPT, {"max_new_tokens": 16, "temperature": 0.7, "seed": 11})
    ref = _twin_streams([req])[0]
    pool = lm_pool(CFG, PARAMS, n_replicas=1, devices=CPU, engine_opts=OPTS)
    try:
        rid = pool.add_replica()
        assert rid == 1 and len(pool.replicas) == 2
        sess = pool.generate(req[0], on_token=lambda _t: time.sleep(0.005),
                             **req[1])
        _wait(lambda: len(sess.tokens) >= 3, "no tokens")
        src = [r.rid for r in pool.replicas if r.engine.pending_rows() > 0]
        victim = src[0] if src else 0
        assert pool.remove_replica(victim, migrate=True) is True
        assert sess.result(60) == ref
        assert len(pool.replicas) == 1 and pool.replicas[0].rid != victim
        assert telemetry.counter_total("serving.shed.count") == 0
        assert pool.generate(PROMPT, max_new_tokens=4, seed=11).result(60)
        events = [e for e in telemetry.events_recent(50)
                  if e["event"] == "serving.pool.replica_remove"]
        assert events and events[-1]["clean"] is True
    finally:
        pool.close(drain=False)


def test_pool_shed_pressure_sheds_low_priority_immediately():
    pool = lm_pool(CFG, PARAMS, n_replicas=1, devices=CPU, engine_opts=OPTS,
                   priority_floor=5)
    try:
        assert pool.generate(PROMPT, max_new_tokens=2,
                             priority=1).result(60)
        assert pool.set_shed_pressure(True) is False
        with pytest.raises(Overloaded, match="shed pressure"):
            pool.generate(PROMPT, max_new_tokens=2, priority=1)
        assert pool.generate(PROMPT, max_new_tokens=2,
                             priority=5).result(60)
        assert pool.set_shed_pressure(False) is True
        assert pool.generate(PROMPT, max_new_tokens=2,
                             priority=1).result(60)
    finally:
        pool.close(drain=False)


# -- FleetController over the CPU decode stack --------------------------------

def _stack(n_replicas=2, per_device=8, **ctl_kw):
    pool = lm_pool(CFG, PARAMS, n_replicas=n_replicas, devices=CPU,
                   engine_opts=OPTS)
    reg = ModelRegistry(ctx=mx.cpu())
    reg.register("lm", pool, version=1)
    ctl = FleetController(reg, fleet=DeviceFleet(devices=CPU,
                                                 per_device=per_device),
                          **ctl_kw)
    return pool, reg, ctl


def _live(pool):
    return [r for r in pool.replicas if r.state == "active" and not r.dead]


def _decided(ctl, action):
    return any(d["action"] == action for d in ctl.decisions())


def test_controller_replaces_dead_replica_and_serving_continues():
    pool, reg, ctl = _stack(interval_ms=30, backoff_base=0.01)
    ctl.start()
    try:
        _wait(lambda: ctl.describe()["models"], "never adopted the pool")
        faults.arm("serving.replica.kill", at=1)
        assert pool.generate(PROMPT, max_new_tokens=8, seed=7).result(60)
        faults.disarm()
        _wait(lambda: _decided(ctl, "restart"), ctl.describe)
        _wait(lambda: len(_live(pool)) == 2, pool.describe)
        assert telemetry.counter_total("serving.fleet.restarts.count") == 1
        assert [r.rid for r in pool.replicas] == [1, 2]
        assert pool.generate(PROMPT, max_new_tokens=4, seed=7).result(60)
        card = ctl.describe()["models"]["lm"]
        assert card["quarantined"] is False and card["restarts_used"] == 1
    finally:
        faults.disarm()
        ctl.close()
        reg.close()


def test_controller_quarantines_when_restart_budget_spent():
    pool, reg, ctl = _stack(interval_ms=30, restart_budget=0)
    ctl.start()
    try:
        faults.arm("serving.replica.kill", at=1)
        assert pool.generate(PROMPT, max_new_tokens=8, seed=7).result(60)
        faults.disarm()
        _wait(lambda: _decided(ctl, "quarantine"), ctl.describe)
        assert ctl.describe()["models"]["lm"]["quarantined"] is True
        assert telemetry.counter_total("serving.fleet.restarts.count") == 0
        assert telemetry.counter_total(
            "serving.fleet.quarantines.count") == 1
        # the dead replica stays in the pool, the survivor serves
        assert [r.dead for r in pool.replicas].count(True) == 1
        assert pool.generate(PROMPT, max_new_tokens=4, seed=7).result(60)
    finally:
        faults.disarm()
        ctl.close()
        reg.close()


def test_controller_scales_up_on_observed_breach():
    """``tick()`` by hand: real TTFT observations land between ticks; an
    impossible SLO makes them a sustained breach, and the controller grows
    the pool through the placement book."""
    pool, reg, ctl = _stack(interval_ms=10_000, policy_opts={
        "slo_ttft_ms": 0.0001, "breach_ticks": 2, "cooldown_s": 0.0})
    try:
        now = 1000.0
        ctl.tick(now)
        for t in range(1, 4):
            assert pool.generate(PROMPT, max_new_tokens=2,
                                 seed=t).result(60)
            ctl.tick(now + t)
        assert _decided(ctl, SCALE_UP), ctl.decisions()
        assert len(pool.replicas) >= 3
        assert telemetry.counter_total("serving.fleet.scale_ups.count") >= 1
        assert telemetry.counter_total(
            "serving.fleet.slo_breaches.count") >= 1
        assert ctl.describe()["fleet"]["loads"] == [len(pool.replicas)]
    finally:
        ctl.close()
        reg.close()


def test_controller_sheds_at_fleet_capacity_and_recovers():
    """Breach with no device headroom (2 replicas, 2 a device): the
    controller turns the pool's shed pressure on and lifts it once the
    breach clears."""
    pool, reg, ctl = _stack(interval_ms=10_000, per_device=2, policy_opts={
        "slo_ttft_ms": 0.0001, "breach_ticks": 2, "cooldown_s": 0.0})
    try:
        now = 1000.0
        ctl.tick(now)
        for t in range(1, 4):
            assert pool.generate(PROMPT, max_new_tokens=2,
                                 seed=t).result(60)
            ctl.tick(now + t)
        assert _decided(ctl, SHED)
        assert pool.admission_state()[2] is True
        assert pool.describe()["shed_pressure"] is True
        with pytest.raises(Overloaded):
            pool.generate(PROMPT, max_new_tokens=2, priority=1)
        for t in range(4, 10):
            ctl.tick(now + t)
            if _decided(ctl, UNSHED):
                break
        assert _decided(ctl, UNSHED)
        assert pool.generate(PROMPT, max_new_tokens=2,
                             priority=1).result(60)
        assert len(pool.replicas) == 2
    finally:
        ctl.close()
        reg.close()


def test_fleet_endpoint_and_healthz_block():
    pool, reg, ctl = _stack(interval_ms=30)
    ctl.start()
    srv = ServingHTTPServer(reg, port=0).start()
    try:
        _wait(lambda: ctl.describe()["models"], "never adopted the pool")
        fleet = json.load(urllib.request.urlopen(srv.url + "/fleet",
                                                 timeout=30))
        assert fleet["running"] is True
        assert fleet["models"]["lm"]["restart_budget"] >= 0
        assert fleet["fleet"]["per_device"] >= 1
        assert sum(fleet["fleet"]["loads"]) == 2
        health = json.load(urllib.request.urlopen(srv.url + "/healthz",
                                                  timeout=30))
        assert health["fleet"]["running"] is True
        assert "lm" in health["fleet"]["models"]
    finally:
        srv.stop()
        ctl.close()
        reg.close()


def test_fleet_endpoint_404_without_controller():
    reg = ModelRegistry(ctx=mx.cpu())
    srv = ServingHTTPServer(reg, port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/fleet", timeout=30)
        assert ei.value.code == 404
    finally:
        srv.stop()
        reg.close()


def test_greedy_streams_through_a_kill_and_its_replacement_equal_jax():
    """Four greedy sessions on two replicas; one replica is hard-killed
    at the pool's third step, its sessions finish on the survivor, the
    controller replaces it, and four more sessions run on the survivor and
    the replacement.  Every stream is the JAX engine's.  The policy keeps
    two replicas (an idle replacement is not scaled away on a slow host
    before the second batch reaches it), and the replacement's engine is
    taken as soon as two replicas are live."""
    jcfg = jtlm.LMConfig(*CFG)
    jeng = JaxEngine(jcfg, jtlm.init_params(jcfg, seed=3), name="lm",
                     **OPTS)
    try:
        want = [jeng.submit(p, max_new_tokens=12) for p in PROMPTS]
        want = [s.result(60) for s in want]
    finally:
        jeng.close()
    pool, reg, ctl = _stack(interval_ms=30, backoff_base=0.01,
                            policy_opts={"min_replicas": 2})
    ctl.start()
    try:
        _wait(lambda: ctl.describe()["models"], "never adopted the pool")
        sess = [pool.generate(p, max_new_tokens=12) for p in PROMPTS]
        # armed once all four are routed (two a replica)
        faults.arm("serving.replica.kill", at=3)
        assert [s.result(60) for s in sess] == want
        faults.disarm()
        assert sum(s.migrations for s in sess) == 2
        _wait(lambda: _decided(ctl, "restart")
              and len(_live(pool)) == 2, pool.describe)
        new = max(r.rid for r in pool.replicas)
        eng = {r.rid: r.engine for r in pool.replicas}[new]
        sess = [pool.generate(p, max_new_tokens=12) for p in PROMPTS]
        assert [s.result(60) for s in sess] == want
        assert eng.tokens_out > 0  # the replacement served
    finally:
        faults.disarm()
        ctl.close()
        reg.close()


def test_swap_hands_the_controller_the_successor():
    """A pointer-flip ``register`` drops the old pool's state; the next
    tick adopts the successor with fresh placements.  A controller whose
    hook raises does not fail the swap."""
    pool, reg, ctl = _stack(interval_ms=10_000)
    try:
        ctl.tick(1.0)
        assert ctl.describe()["fleet"]["placements"] == {"lm/0": "cpu",
                                                         "lm/1": "cpu"}
        new = lm_pool(CFG, PARAMS, n_replicas=1, devices=CPU,
                      engine_opts=OPTS)
        reg.register("lm", new)
        assert ctl.describe()["models"] == {}
        assert ctl.describe()["fleet"]["placements"] == {}
        ctl.tick(2.0)
        assert ctl.describe()["fleet"]["placements"] == {"lm/0": "cpu"}

        def broken(name, servable):
            raise RuntimeError("controller bug")

        ctl.on_register = broken
        third = lm_pool(CFG, PARAMS, n_replicas=1, devices=CPU,
                        engine_opts=OPTS)
        assert reg.register("lm", third) is third
        assert reg.get("lm") is third
        assert third.generate(PROMPT, max_new_tokens=2).result(60)
    finally:
        ctl.close()
        reg.close()


def _breach_run(pkg):
    """The hand-ticked scale-up and shed of the tests above, in either
    package; returns the ``serving.fleet.*`` names it leaves in the
    telemetry snapshot and event log."""
    if pkg == "jax":
        import jax

        tel = jtelemetry
        cfg = jtlm.LMConfig(*CFG)
        pool = jax_lm_pool(cfg, jtlm.init_params(cfg, seed=3), n_replicas=1,
                           engine_opts=OPTS, devices=jax.devices()[:1])
        reg, fleet, ctl_cls = JaxRegistry(), JaxFleet, JaxController
        devs = jax.devices()[:1]
    else:
        tel = telemetry
        pool = lm_pool(CFG, PARAMS, n_replicas=1, devices=CPU,
                       engine_opts=OPTS)
        reg, fleet, ctl_cls = ModelRegistry(ctx=mx.cpu()), DeviceFleet, \
            FleetController
        devs = CPU
    tel.reset()
    tel.enable()
    reg.register("lm", pool, version=1)
    ctl = ctl_cls(reg, fleet=fleet(devices=devs, per_device=2),
                  interval_ms=10_000, policy_opts={
                      "slo_ttft_ms": 0.0001, "breach_ticks": 2,
                      "cooldown_s": 0.0, "slack_ticks": 1})
    try:
        ctl.tick(1000.0)
        for t in range(1, 7):
            assert pool.generate(PROMPT, max_new_tokens=2,
                                 seed=t).result(60)
            ctl.tick(1000.0 + t)
        for t in range(7, 10):
            ctl.tick(1000.0 + t)
        snap = tel.snapshot()
        names = {(kind, k) for kind in ("counters", "gauges", "histograms")
                 for k in snap[kind] if k.startswith("serving.fleet.")}
        names |= {("event", e["event"]) for e in tel.events_recent(1000)
                  if e["event"].startswith("serving.fleet.")}
        actions = [d["action"] for d in ctl.decisions()]
        text = tel.prometheus_text()
    finally:
        ctl.close()
        reg.close()
        tel.disable()
        tel.reset()
    return names, actions, text


def test_fleet_telemetry_names_equal_the_jax_package():
    got, want = _breach_run("torch"), _breach_run("jax")
    assert got[1] == want[1]
    assert {SCALE_UP, SHED, UNSHED} <= set(got[1])
    assert got[0] == want[0]
    for kind, name in got[0]:
        if kind != "event":
            prom = "mxnet_" + name.replace(".", "_")
            assert prom in got[2] and prom in want[2], prom
