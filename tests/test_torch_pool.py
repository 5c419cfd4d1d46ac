"""The port's replica pool (``mxnet_tpu_torch.serving.pool``) and the
registry's ``register`` swap on the CPU: weighted least-outstanding
routing, tenant quotas and priority shedding with the JAX package's shed
reasons, the circuit breaker (open, re-warm, half-open, closed) and
session failover driven by a replica whose step function raises, retry
budgets, and a version swap whose stragglers finish on the new pool with
the streams an uninterrupted run gives.  Where the two packages part: the
JAX pool sheds a migrated transcript that outgrew the largest prefill
bucket, and the port resumes it (padded to ``max_len``)."""

import threading
import time

import numpy as np
import pytest

from mxnet_tpu import faults as jfaults
from mxnet_tpu.models import transformer_lm as jtlm
from mxnet_tpu.serving import lm_pool as jax_lm_pool
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.serving import (DecodeEngine, ModelRegistry,
                                     Overloaded, QuotaExceeded,
                                     ReplicaPool, RetryBudgetExhausted,
                                     lm_pool)
from torch_deadline import deadline  # noqa: F401 (autouse)

CFG = tlm.LMConfig(32, 16, 2, 2, 32, 32, eos_id=32)
PARAMS = tlm.init_params(CFG, seed=3)
PROMPT = [5, 7, 9, 2]
OPTS = {"slots": 4, "prefill_buckets": (4, 8), "max_queue": 64}
CPU = ["cpu"]


@pytest.fixture(autouse=True)
def _telemetry():
    telemetry.reset()
    telemetry.enable()
    yield
    telemetry.disable()
    telemetry.reset()


def _shed(reason):
    c = telemetry.snapshot()["counters"].get("serving.shed.count", {})
    return c.get("model=lm,reason=%s" % reason, 0)


def _held_pool(**pool_kw):
    """Never-started engines: submissions queue forever (deterministic
    outstanding counts)."""
    def factory(device, rid):
        return DecodeEngine(CFG, PARAMS, device=device, name="lm",
                            replica=rid, autostart=False, **OPTS)

    return ReplicaPool(factory, n_replicas=2, devices=CPU, name="lm",
                       **pool_kw)


def _raise_at(eng, steps):
    """``eng``'s step raises while ``eng.steps`` is in ``steps``."""
    base = eng._step_fn

    def wrapped(*a):
        if eng.steps in steps:
            raise RuntimeError("injected step failure")
        return base(*a)

    eng._step_fn = wrapped


def _twin_streams(reqs, opts=OPTS):
    ref = lm_pool(CFG, PARAMS, n_replicas=1, devices=CPU, engine_opts=opts)
    try:
        return [ref.generate(p, **kw).result(60) for p, kw in reqs]
    finally:
        ref.close()


def test_routes_by_weighted_least_outstanding():
    pool = _held_pool(weights=(1.0, 3.0))
    try:
        for _ in range(8):
            pool.generate(PROMPT, max_new_tokens=2)
        assert pool._outstanding[1] == 6 and pool._outstanding[0] == 2
        assert [r.routed for r in pool.replicas] == [2, 6]
    finally:
        pool.close(drain=False)


def test_tenant_quotas_and_priority_shedding():
    pool = _held_pool(quotas={"small": 2}, max_outstanding=10,
                      priority_watermark=0.5, priority_floor=5)
    try:
        pool.generate(PROMPT, max_new_tokens=2, tenant="small")
        pool.generate(PROMPT, max_new_tokens=2, tenant="small")
        with pytest.raises(QuotaExceeded):
            pool.generate(PROMPT, max_new_tokens=2, tenant="small")
        for _ in range(3):
            pool.generate(PROMPT, max_new_tokens=2, tenant="big")
        with pytest.raises(Overloaded):
            pool.generate(PROMPT, max_new_tokens=2, priority=0)
        for _ in range(5):
            pool.generate(PROMPT, max_new_tokens=2, priority=9)
        with pytest.raises(Overloaded):
            pool.generate(PROMPT, max_new_tokens=2, priority=9)
        assert (_shed("quota"), _shed("priority"), _shed("overload")) \
            == (1, 1, 1)
        desc = pool.describe()
        assert desc["outstanding"] == 10 and desc["kind"] == "generate"
        assert desc["tenants_outstanding"]["small"] == 2
    finally:
        pool.close(drain=False)


def test_failover_migrates_and_the_breaker_cycles():
    """Replica 1's step raises once: its sessions finish on replica 0
    with the streams an uninterrupted pool gives (greedy and sampled);
    its circuit opens, it re-warms, turns half-open and closes on a
    probe."""
    reqs = [([1, 2, 3, i], {"max_new_tokens": 14, "seed": i,
                            "temperature": 0.8 * (i % 2)})
            for i in range(6)]
    want = _twin_streams(reqs)
    pool = lm_pool(CFG, PARAMS, n_replicas=2, devices=CPU,
                   engine_opts=OPTS, quarantine_after=1,
                   circuit_cooldown=0.05)
    try:
        _raise_at(pool.replicas[1].engine, {3})
        sess = [pool.generate(p, **kw) for p, kw in reqs]
        assert [s.result(60) for s in sess] == want
        moved = [s for s in sess if s.migrations]
        assert len(moved) == 3
        deadline = time.monotonic() + 30
        while pool._circuit[1] != "half_open":
            assert time.monotonic() < deadline, pool._circuit
            time.sleep(0.01)
        # the probe flows once the closed replica is slot-saturated
        # (replica 0's sessions may finish before the last submit on a
        # busy host: then it takes another round)
        for _ in range(10):
            probes = [pool.generate(PROMPT, max_new_tokens=20)
                      for _ in range(OPTS["slots"] + 1)]
            for p in probes:
                p.result(60)
            if pool._circuit[1] == "closed":
                break
        assert pool._circuit[1] == "closed"
        kinds = [e["event"] for e in telemetry.events_recent(500)
                 if e.get("replica") == "1"]
        assert [k for k in kinds if k.startswith("serving.pool.circuit")] \
            == ["serving.pool.circuit_open", "serving.pool.circuit_half_open",
                "serving.pool.circuit_close"]
        assert "serving.pool.rewarmed" in kinds
        assert telemetry.counter_total("serving.failover.count") == 3
        assert pool.describe()["failovers"] == 3
    finally:
        pool.close()


def test_retry_budget_sheds_a_session_that_keeps_failing():
    pool = lm_pool(CFG, PARAMS, n_replicas=2, devices=CPU,
                   engine_opts=OPTS, quarantine_after=1,
                   retry_budgets={"*": 1})
    try:
        for r in pool.replicas:
            _raise_at(r.engine, set(range(100)))
        sess = pool.generate(PROMPT, max_new_tokens=6)
        with pytest.raises(RetryBudgetExhausted):
            sess.result(60)
        assert sess.migrations == 2 and _shed("retry_budget") == 1
    finally:
        pool.close(drain=False)


def test_migration_sheds_a_transcript_past_the_largest_bucket():
    """The reference: the JAX pool re-admits a failed-over session by
    re-prefilling its transcript, which must fit a prefill bucket: a
    7-token prompt with 4 tokens generated (11 > 8) is shed, not
    resumed.  The port resumes it (the next test)."""
    jcfg = jtlm.LMConfig(*CFG)
    pool = jax_lm_pool(jcfg, jtlm.init_params(jcfg, seed=3),
                       n_replicas=2, engine_opts=OPTS, quarantine_after=1)
    jfaults.arm("serving.decode", at=4)
    try:
        sess = pool.generate([1, 2, 3, 4, 5, 6, 7], max_new_tokens=12)
        with pytest.raises(Exception, match="re-admission .* failed"):
            sess.result(60)
        assert len(sess.tokens) == 4
    finally:
        jfaults.disarm()
        pool.close(drain=False)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_migration_resumes_a_transcript_past_the_largest_bucket(
        layout, temperature):
    """The port re-prefills a migrated transcript past the largest bucket
    at ``max_len``: the same 7-token prompt fails over with 4 tokens
    generated (11 > 8) and finishes with the uninterrupted stream."""
    opts = dict(OPTS, kv_layout=layout)
    if layout == "paged":
        opts["kv_block_size"] = 4
    reqs = [([1, 2, 3, 4, 5, 6, 7], {"max_new_tokens": 12, "seed": 5,
                                     "temperature": temperature})]
    want = _twin_streams(reqs, opts)
    pool = lm_pool(CFG, PARAMS, n_replicas=2, devices=CPU,
                   engine_opts=opts, quarantine_after=1)
    # the fourth step of whichever replica takes the session, once
    fired = []
    for r in pool.replicas:
        base = r.engine._step_fn

        def wrapped(*a, _eng=r.engine, _base=base):
            if _eng.steps == 3 and not fired:
                fired.append(_eng)
                raise RuntimeError("injected step failure")
            return _base(*a)

        r.engine._step_fn = wrapped
    try:
        sess = pool.generate(reqs[0][0], **reqs[0][1])
        assert sess.result(60) == want[0]
        assert sess.migrations == 1 and len(fired) == 1
        assert sum(r.engine.resumed for r in pool.replicas) == 1
        assert sum(r.engine.reprefilled_tokens
                   for r in pool.replicas) == 11
        assert telemetry.counter_total("serving.shed.count") == 0
    finally:
        pool.close(drain=False)


def test_register_is_a_pointer_flip_and_stragglers_migrate():
    """register() stamps versions, closes the old pool and moves its
    in-flight sessions, queued and decoding, onto the new one, where
    they finish with the streams an uninterrupted run gives."""
    reqs = [([2, 4, 6, i], {"max_new_tokens": 20, "seed": 7 + i,
                            "temperature": 0.6 * (i % 2)})
            for i in range(12)]
    # transcripts of up to 23 tokens re-prefill on the new pool
    opts = dict(OPTS, prefill_buckets=(4, 8, 32))
    want = _twin_streams(reqs, opts)
    reg = ModelRegistry(ctx=mx.cpu())
    v1 = lm_pool(CFG, PARAMS, n_replicas=2, devices=CPU, engine_opts=opts)
    assert reg.register("lm", v1) is v1 and v1.version == 1
    assert reg.models() == [v1]
    v2 = lm_pool(CFG, PARAMS, n_replicas=2, devices=CPU, engine_opts=opts)
    # v1's replicas hold at their third step until the swap begins, so
    # every session is in flight when register() flips the pointer
    gate = threading.Event()
    held = []
    for r in v1.replicas:
        eng, base = r.engine, r.engine._step_fn

        def gated(*a, eng=eng, base=base):
            if eng.steps == 3:
                held.append(eng)
                assert gate.wait(60)
            return base(*a)

        eng._step_fn = gated
    sess = [v1.generate(p, **kw) for p, kw in reqs]
    deadline = time.monotonic() + 30
    while len(held) < 2:
        assert time.monotonic() < deadline
        time.sleep(0.001)
    threading.Timer(0.2, gate.set).start()
    reg.register("lm", v2)
    try:
        assert reg.get("lm") is v2 and v2.version == 2
        assert [s.result(60) for s in sess] == want
        assert v2.describe()["failovers"] >= 1
        with pytest.raises(mx.MXNetError, match="closed"):
            v1.generate(PROMPT, max_new_tokens=2)
        # a bare engine registers too, and the registry stamps it
        eng = DecodeEngine(CFG, PARAMS, device="cpu", **OPTS)
        reg.register("bare", eng)
        assert eng.version == 1 and eng.name == "bare"
        assert [m.name for m in reg.models()] == ["bare", "lm"]
        with pytest.raises(mx.serving.UnknownModel):
            reg.get("nope")
    finally:
        reg.close()


def test_add_and_remove_replica_migrate_without_charging_budgets():
    reqs = [([3, 3, 1, i], {"max_new_tokens": 16, "seed": i})
            for i in range(4)]
    opts = dict(OPTS, prefill_buckets=(4, 8, 32))
    want = _twin_streams(reqs, opts)
    pool = lm_pool(CFG, PARAMS, n_replicas=1, devices=CPU,
                   engine_opts=opts, retry_budgets={"*": 0})
    try:
        rid = pool.add_replica()
        assert rid == 1 and len(pool.replicas) == 2
        sess = [pool.generate(p, **kw) for p, kw in reqs]
        while not all(s.tokens for s in sess):
            time.sleep(0.001)
        assert pool.remove_replica(0) is True
        assert [s.result(60) for s in sess] == want
        assert [r.rid for r in pool.replicas] == [1]
    finally:
        pool.close()


def test_pool_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mx.MXNetError, match="CUDA"):
        lm_pool(CFG, PARAMS, n_replicas=1, engine_opts=OPTS)
    with pytest.raises(mx.MXNetError, match="CUDA"):
        lm_pool(CFG, PARAMS, n_replicas=1, devices=["cuda:0"],
                engine_opts=OPTS)
    assert np.isfinite(PARAMS["embed"].numpy()).all()


def test_replica_kill_fault_marks_it_dead_and_survivors_adopt():
    """``serving.replica.kill`` hard-kills one replica mid-generation: its
    sessions finish on the survivor with the uninterrupted streams (greedy
    and sampled), the replica is marked dead and stays down (open circuit,
    quarantined, never re-warmed): replacing it is the fleet controller's
    call.  The JAX pool takes the same branch."""
    from mxnet_tpu_torch import faults

    reqs = [([1, 2, 3, i], {"max_new_tokens": 14, "seed": i,
                            "temperature": 0.8 * (i % 2)})
            for i in range(6)]
    want = _twin_streams(reqs)
    # its own model name: a recovery thread another test's pool left
    # behind may still log events for "lm"
    pool = lm_pool(CFG, PARAMS, n_replicas=2, devices=CPU, engine_opts=OPTS,
                   name="killed")
    try:
        sess = [pool.generate(p, **kw) for p, kw in reqs]
        # armed once every session is routed (three a replica): the fifth
        # step from here kills one replica with its three sessions
        faults.arm("serving.replica.kill", at=5)
        assert [s.result(60) for s in sess] == want
        faults.disarm()
        moved = [s for s in sess if s.migrations]
        assert len(moved) == 3 and all(s.migrations == 1 for s in moved)
        deadline = time.monotonic() + 30
        dead = []
        while not dead:
            assert time.monotonic() < deadline, pool.describe()
            dead = [r for r in pool.replicas if r.dead]
            time.sleep(0.01)
        (r,) = dead
        assert r.state == "quarantined" and pool._circuit[r.rid] == "open"
        assert r.engine._live is None and r.engine.heartbeat_age() is None
        kinds = [e["event"] for e in telemetry.events_recent(500)
                 if e.get("replica") == str(r.rid)
                 and e.get("model") == "killed"]
        assert "serving.pool.replica_dead" in kinds
        assert "serving.pool.rewarmed" not in kinds
        card = {c["replica"]: c for c in pool.describe()["replicas"]}
        assert card[str(r.rid)]["dead"] is True
        # the survivor serves new work; nothing was shed
        assert pool.generate(PROMPT, max_new_tokens=3).result(60)
        snap = telemetry.snapshot()["counters"]
        assert not any(v for k, v in snap["serving.shed.count"].items()
                       if k.startswith("model=killed,"))
        assert snap["serving.failover.count"]["model=killed"] == 3
    finally:
        faults.disarm()
        pool.close()


def test_replica_kill_matches_the_jax_pool():
    """The same kill in both pools (the JAX pool's own fault point):
    which sessions migrate, and the replica left dead and quarantined."""
    from mxnet_tpu_torch import faults

    reqs = [([1, 2, 3, i], {"max_new_tokens": 10, "seed": i})
            for i in range(4)]
    out = {}
    for name, make, f in (
            ("jax", lambda: jax_lm_pool(jtlm.LMConfig(*CFG),
                                        jtlm.init_params(
                                            jtlm.LMConfig(*CFG), seed=3),
                                        n_replicas=2, engine_opts=OPTS),
             jfaults),
            ("torch", lambda: lm_pool(CFG, PARAMS, n_replicas=2,
                                      devices=CPU, engine_opts=OPTS),
             faults)):
        pool = make()
        try:
            sess = [pool.generate(p, **kw) for p, kw in reqs]
            # armed once all four are routed (two a replica)
            f.arm("serving.replica.kill", at=3)
            toks = [s.result(120) for s in sess]
            f.disarm()
            deadline = time.monotonic() + 60
            while not any(r.dead for r in pool.replicas):
                assert time.monotonic() < deadline
                time.sleep(0.01)
            # which replica steps third is the threads' race, in both
            out[name] = (toks, sorted(s.migrations for s in sess),
                         sorted((r.state, r.dead) for r in pool.replicas))
        finally:
            f.disarm()
            pool.close()
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == [0, 0, 1, 1]


def test_shed_pressure_state_describe_and_telemetry():
    pool = _held_pool(priority_floor=5, max_outstanding=10)
    try:
        assert pool.admission_state() == (0, 10, False)
        assert pool.describe()["shed_pressure"] is False
        pool.generate(PROMPT, max_new_tokens=2, priority=1)
        assert pool.set_shed_pressure(True) is False
        assert pool.set_shed_pressure(True) is True  # no second event
        with pytest.raises(Overloaded, match="shed pressure"):
            pool.generate(PROMPT, max_new_tokens=2, priority=4)
        pool.generate(PROMPT, max_new_tokens=2, priority=5)
        assert pool.admission_state() == (2, 10, True)
        assert pool.describe()["shed_pressure"] is True
        assert _shed("priority") == 1
        assert telemetry.gauge_value("serving.pool.shed_pressure",
                                     model="lm") == 1
        pool.set_shed_pressure(False)
        assert telemetry.gauge_value("serving.pool.shed_pressure",
                                     model="lm") == 0
        ev = [e["on"] for e in telemetry.events_recent(50)
              if e["event"] == "serving.pool.shed_pressure"]
        assert ev == [True, False]
        pool.generate(PROMPT, max_new_tokens=2, priority=1)
        assert "mxnet_serving_pool_shed_pressure" in \
            telemetry.prometheus_text()
    finally:
        pool.close(drain=False)
