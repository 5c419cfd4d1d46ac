"""The port's fault injection (``mxnet_tpu_torch.faults``) against the JAX
package's on the CPU: the same specs parse alike, the same arming gives
the same hit sequences (programmatic, from the environment, re-armed,
counters reset, from many threads at once), and a point the port has no
site for is refused as "not ported yet" instead of armed and never fired.
Then the sites: ``serving.model.write`` leaves the previous published
version whole (and readable by both packages), ``serving.dispatch`` fails
its batch and the batcher serves on."""

import json
import os
import threading

import numpy as np
import pytest

from mxnet_tpu import faults as jfaults
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.base import MXNetError as JaxError
from mxnet_tpu.serving import ModelRegistry as JaxRegistry
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import faults, telemetry
from mxnet_tpu_torch.serving import DynamicBatcher
from torch_deadline import deadline  # noqa: F401 (autouse)

PKGS = {"jax": jfaults, "torch": faults}
ERRORS = {jfaults: JaxError, faults: mx.MXNetError}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MXNET_FAULT_SPEC", raising=False)
    for f in PKGS.values():
        f.disarm()
    telemetry.reset()
    telemetry.enable()
    jtelemetry.reset()
    jtelemetry.enable()
    yield
    for f in PKGS.values():
        f.disarm()
    telemetry.disable()
    telemetry.reset()
    jtelemetry.disable()
    jtelemetry.reset()


def test_points_are_the_jax_names_and_the_ported_ones_a_subset():
    assert faults.POINTS == jfaults.POINTS
    assert set(faults.PORTED) == {"serving.dispatch", "serving.model.write",
                                  "serving.decode", "serving.replica.kill"}
    assert set(faults.PORTED) <= set(faults.POINTS)


def _random_spec(rs):
    parts = []
    for point in rs.permutation(faults.PORTED)[:1 + rs.randint(4)]:
        keys = []
        if rs.rand() < 0.7:
            keys.append("at=%d" % (1 + rs.randint(6)))
        if rs.rand() < 0.6:
            keys.append("count=%d" % rs.choice([-1, 1, 2, 3]))
        parts.append(point + (":" + ",".join(keys) if keys else ""))
    return " ; ".join(parts) + (";" if rs.rand() < 0.3 else "")


@pytest.mark.parametrize("seed", range(4))
def test_specs_parse_alike(seed):
    rs = np.random.RandomState(seed)
    for _ in range(25):
        spec = _random_spec(rs)
        assert faults.parse_spec(spec) == jfaults.parse_spec(spec), spec


@pytest.mark.parametrize("spec,match", [
    ("serving.decode:when=3", "unknown fault spec key"),
    ("serving.decode:at=x", "must be an integer"),
    ("no.such.point", "unknown fault point"),
])
def test_malformed_specs_raise_in_both(spec, match):
    for f in PKGS.values():
        with pytest.raises(ERRORS[f], match=match):
            f.parse_spec(spec)


def _fires(f, point, n):
    return [f.should_fire(point) for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_hit_sequences_equal_the_jax_package(seed):
    """Arm, hit, re-arm, reset the counters, disarm one point: every
    should_fire answer and every hit count agrees."""
    got = {}
    for name, f in PKGS.items():
        rs_i = np.random.RandomState(100 + seed)
        seq = []
        for _round in range(6):
            point = str(rs_i.choice(faults.PORTED))
            op = rs_i.randint(4)
            if op == 0:
                f.arm(point, at=1 + int(rs_i.randint(5)),
                      count=int(rs_i.choice([-1, 1, 2])))
            elif op == 1:
                f.reset_counters()
            elif op == 2:
                f.disarm(point)
            seq.append([f.armed(p) for p in faults.PORTED])
            for p in faults.PORTED:
                seq.append(_fires(f, p, int(rs_i.randint(1, 8))))
            seq.append([f.hits(p) for p in faults.PORTED])
        f.disarm()
        got[name] = seq
    assert got["torch"] == got["jax"]


def test_environment_spec_arms_and_disarm_consumes_it(monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_SPEC",
                       "serving.decode:at=2,count=2;serving.dispatch")
    got = {}
    for name, f in PKGS.items():
        seq = [_fires(f, "serving.decode", 5),
               _fires(f, "serving.dispatch", 3),
               f.armed("serving.replica.kill")]
        f.disarm()  # consumes the env value: it does not re-arm
        seq.append(_fires(f, "serving.decode", 3))
        got[name] = seq
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [False, True, True, False, False]


def test_firing_counts_telemetry_as_the_jax_package():
    for f in PKGS.values():
        f.arm("serving.decode", at=2, count=3)
        _fires(f, "serving.decode", 6)
    assert telemetry.counter_total("resilience.fault_injected") \
        == jtelemetry.counter_total("resilience.fault_injected") == 3
    ev = [e for e in telemetry.events_recent(10)
          if e["event"] == "fault_injected"]
    assert len(ev) == 3 and ev[0]["point"] == "serving.decode"


def test_hits_from_many_threads_fire_exactly_the_window():
    """Hit counting is per process and thread-safe: 8 threads x 250 hits
    fire exactly ``count`` times, and the hit count is exact."""
    faults.arm("serving.dispatch", at=100, count=37)
    fired = []

    def worker():
        n = sum(faults.should_fire("serving.dispatch") for _ in range(250))
        fired.append(n)

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)
    assert sum(fired) == 37 and faults.hits("serving.dispatch") == 2000


@pytest.mark.parametrize("point", [p for p in faults.POINTS
                                   if p not in faults.PORTED])
def test_points_without_a_site_are_refused(point, monkeypatch):
    """The JAX package arms these; the port has no site that would
    consult them, so arming raises instead of never firing."""
    jfaults.arm(point, at=1)
    assert jfaults.armed(point)
    with pytest.raises(mx.MXNetError, match="not ported yet"):
        faults.arm(point)
    with pytest.raises(mx.MXNetError, match="not ported yet"):
        faults.parse_spec("serving.decode;%s:at=2" % point)
    monkeypatch.setenv("MXNET_FAULT_SPEC", point)
    with pytest.raises(mx.MXNetError, match="not ported yet"):
        faults.should_fire("serving.decode")


def test_unknown_point_and_bad_at_raise_in_both():
    for f in PKGS.values():
        with pytest.raises(ERRORS[f], match="unknown fault point"):
            f.arm("serving.decod")
        with pytest.raises(ValueError, match="1-based"):
            f.arm("serving.decode", at=0)
    assert not faults.armed("serving.decode")


def _publish(d, version):
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                name="fc")
    rs = np.random.RandomState(version)
    params = {"fc_weight": rs.rand(3, 4).astype(np.float32),
              "fc_bias": rs.rand(3).astype(np.float32)}
    return mx.serving.save_model(d, net, mx.nd.save_bytes(params), (4,),
                                 buckets=(1,), version=version)


def test_a_publisher_dying_mid_manifest_leaves_the_old_version(tmp_path):
    d = str(tmp_path)
    _publish(d, 1)
    with open(os.path.join(d, mx.serving.MANIFEST)) as f:
        before = f.read()
    faults.arm("serving.model.write", at=1)
    with pytest.raises(faults.FaultInjected, match="serving.model.write"):
        _publish(d, 2)
    with open(os.path.join(d, mx.serving.MANIFEST)) as f:
        assert f.read() == before
    # the half-written temp file is what a crash leaves
    tmps = [n for n in os.listdir(d) if n.startswith("manifest.json.tmp-")]
    assert len(tmps) == 1
    assert os.path.getsize(os.path.join(d, tmps[0])) < len(before) + 64
    reg = mx.serving.ModelRegistry(ctx=mx.cpu())
    jreg = JaxRegistry()
    try:
        assert reg.load_dir(d).version == 1
        assert jreg.load_dir(d).version == 1
        out = reg.get("%s" % os.path.basename(d)).predict(
            np.arange(4, dtype=np.float32))
        want = jreg.get(os.path.basename(d)).predict(
            np.arange(4, dtype=np.float32))
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-6)
    finally:
        reg.close()
        jreg.close()
    # the next publish goes through and supersedes version 1
    assert _publish(d, 3)["version"] == 3
    with open(os.path.join(d, mx.serving.MANIFEST)) as f:
        assert json.load(f)["version"] == 3


def test_dispatch_fault_fails_its_batch_and_the_worker_serves_on():
    calls = []

    def dispatch(rows):
        calls.append(rows.shape[0])
        return rows * 2.0

    b = DynamicBatcher(dispatch, buckets=(1, 4), batch_timeout_us=100,
                       name="m", feature_shape=(3,))
    b.start()
    try:
        faults.arm("serving.dispatch", at=2)
        x = np.ones((1, 3), np.float32)
        np.testing.assert_array_equal(b.predict(x), 2 * x)
        with pytest.raises(faults.FaultInjected, match="serving.dispatch"):
            b.predict(x)
        np.testing.assert_array_equal(b.predict(3 * x), 6 * x)
        assert calls == [1, 1]  # the faulted batch never reached the card
        assert telemetry.counter_total("serving.error.count") == 1
    finally:
        b.close()
