"""The port's HTTP frontend (``mxnet_tpu_torch.serving.frontend``) held
against the JAX package's over loopback: the same requests to both
servers give the same status codes, JSON keys and ndjson stream shape
(and the same greedy tokens), ``/metrics`` carries the decode tier's
Prometheus families, many clients may connect at once, and a drain or a
SIGTERM lets in-flight generations finish."""

import http.client
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

import mxnet_tpu.serving as jserving
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.models import transformer_lm as jtlm
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.serving import ModelRegistry, ServingHTTPServer, lm_pool
from torch_deadline import deadline  # noqa: F401 (autouse)

WIDTHS = (32, 16, 2, 2, 32, 32)
OPTS = {"slots": 4, "prefill_buckets": (4, 8), "max_queue": 64}
PROMPT = [5, 7, 9, 2]


class _Doubler:
    """A predict-only servable (what ``register`` takes besides pools)."""

    def __init__(self):
        self.name, self.version = "double", 1

    def predict(self, data, deadline_ms=None, timeout=None):
        return np.asarray(data, np.float32) * 2

    def describe(self):
        return {"name": self.name, "version": self.version,
                "kind": "predict"}

    def close(self, drain=True):
        pass


def _servers():
    """The same registry shape in both packages: a 2-replica LM pool, a
    pool that admits nothing (max_outstanding=0) and a predict model."""
    jcfg = jtlm.LMConfig(*WIDTHS, eos_id=32)
    jparams = jtlm.init_params(jcfg, seed=3)
    jreg = jserving.ModelRegistry()
    jreg.register("lm", jserving.lm_pool(jcfg, jparams, n_replicas=2,
                                         engine_opts=OPTS))
    jreg.register("full", jserving.lm_pool(jcfg, jparams, n_replicas=1,
                                           engine_opts=OPTS,
                                           max_outstanding=0))
    jreg.register("double", _Doubler())
    cfg = tlm.LMConfig(*WIDTHS, eos_id=32)
    params = tlm.init_params(cfg, seed=3)
    reg = ModelRegistry(ctx=mx.cpu())
    reg.register("lm", lm_pool(cfg, params, n_replicas=2, devices=["cpu"],
                               engine_opts=OPTS))
    reg.register("full", lm_pool(cfg, params, n_replicas=1, devices=["cpu"],
                                 engine_opts=OPTS, max_outstanding=0))
    reg.register("double", _Doubler())
    return ((jreg, jserving.ServingHTTPServer(jreg, port=0).start()),
            (reg, ServingHTTPServer(reg, port=0).start()))


@pytest.fixture(scope="module")
def servers():
    telemetry.enable()
    jtelemetry.enable()
    pair = _servers()
    yield {"jax": pair[0][1], "torch": pair[1][1]}
    for reg, srv in pair:
        srv.stop()
        reg.close()
    telemetry.disable()
    jtelemetry.disable()


def _request(srv, method, path, body=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
    try:
        data = raw if raw is not None else (
            None if body is None else json.dumps(body))
        conn.request(method, path, data,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), \
            resp.read().decode()
    finally:
        conn.close()


def _shape(status, ctype, text):
    """What must agree between the packages: the status, and the keys of
    the JSON document or of each ndjson line."""
    if ctype == "application/x-ndjson":
        return status, [sorted(json.loads(x)) for x in text.splitlines()
                        if x.strip()]
    if ctype.startswith("text/plain"):
        return status, "text"
    return status, sorted(json.loads(text))


CASES = [
    ("POST", "/generate", {"model": "lm", "prompt": PROMPT,
                           "max_new_tokens": 6}),
    ("POST", "/generate", {"model": "lm", "prompt": [1, 2, 3],
                           "max_new_tokens": 5, "stream": True,
                           "temperature": 0.7, "seed": 3,
                           "tenant": "a", "priority": 9}),
    ("POST", "/generate", {"model": "nope", "prompt": PROMPT}),
    ("POST", "/generate", {"model": "lm", "prompt": list(range(1, 12))}),
    ("POST", "/generate", {"model": "lm", "prompt": [99]}),
    ("POST", "/generate", {"prompt": PROMPT}),
    ("POST", "/generate", {"model": "double", "prompt": PROMPT}),
    ("POST", "/generate", {"model": "full", "prompt": PROMPT}),
    ("POST", "/generate", {"model": "lm", "prompt": PROMPT,
                           "max_new_tokens": 30, "deadline_ms": 0.001}),
    ("POST", "/predict", {"model": "double", "data": [[1.0, 2.0]]}),
    ("POST", "/predict", {"model": "lm", "data": [[1.0]]}),
    ("POST", "/predict", {"model": "nope", "data": [[1.0]]}),
    ("POST", "/nowhere", {}),
    ("GET", "/models", None),
    ("GET", "/healthz", None),
    ("GET", "/fleet", None),
    ("GET", "/nowhere", None),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_same_status_and_shape_as_the_jax_frontend(servers, case):
    method, path, body = CASES[case]
    got = {k: _request(s, method, path, body) for k, s in servers.items()}
    assert _shape(*got["torch"]) == _shape(*got["jax"]), got
    if case == 0:
        assert json.loads(got["torch"][2])["tokens"] \
            == json.loads(got["jax"][2])["tokens"]


def test_bad_json_is_a_400_in_both(servers):
    for srv in servers.values():
        status, _ctype, _text = _request(srv, "POST", "/generate",
                                         raw=b"{not json")
        assert status == 400


def test_stream_lines_are_the_tokens_then_the_summary(servers):
    _s, _c, text = _request(servers["torch"], "POST", "/generate", {
        "model": "lm", "prompt": PROMPT, "max_new_tokens": 7,
        "stream": True})
    lines = [json.loads(x) for x in text.splitlines()]
    toks = [x["token"] for x in lines[:-1]]
    assert len(toks) == 7 and lines[-1]["done"] is True
    assert lines[-1]["tokens"] == toks and lines[-1]["migrations"] == 0


def test_metrics_carry_the_decode_families(servers):
    for srv in servers.values():
        _request(srv, "POST", "/generate",
                 {"model": "lm", "prompt": PROMPT, "max_new_tokens": 3})
    status, ctype, text = _request(servers["torch"], "GET", "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    for fam in ("mxnet_serving_decode_tokens_count",
                "mxnet_serving_decode_steps_count",
                "mxnet_serving_decode_sessions_count",
                "mxnet_serving_decode_slot_occupancy",
                "mxnet_serving_decode_ttft_seconds_bucket",
                "mxnet_serving_pool_routed_count",
                "mxnet_serving_shed_count"):
        assert fam in text, fam
    assert '# TYPE mxnet_serving_decode_ttft_seconds histogram' in text
    _s, _c, jtext = _request(servers["jax"], "GET", "/metrics")
    fams = lambda t: {l.split()[2] for l in t.splitlines()  # noqa: E731
                      if l.startswith("# TYPE mxnet_serving_decode")}
    assert fams(text) == fams(jtext)


def test_trace_route_is_not_ported(servers):
    status, _c, text = _request(servers["torch"], "GET", "/trace/abc")
    assert status == 404 and "not ported" in text


def test_many_clients_connect_at_once(servers):
    """64 clients connect together; none is reset (``socketserver``'s
    default listen backlog of 5, which the JAX frontend keeps, would
    drop some)."""
    srv = servers["torch"]
    go = threading.Barrier(64)
    out = []

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        go.wait()
        try:
            conn.request("POST", "/generate", json.dumps(
                {"model": "lm", "prompt": PROMPT, "max_new_tokens": 1}),
                {"Content-Type": "application/json"})
            out.append(conn.getresponse().status)
        except OSError as e:
            out.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client) for _ in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert out == [200] * 64


def _tiny_server():
    """A one-replica server whose engine steps only while ``gate`` is
    set: a generation stays in flight until the test releases it."""
    cfg = tlm.LMConfig(*WIDTHS, eos_id=32)
    reg = ModelRegistry(ctx=mx.cpu())
    pool = lm_pool(cfg, tlm.init_params(cfg, seed=3), n_replicas=1,
                   devices=["cpu"], engine_opts=OPTS)
    reg.register("lm", pool)
    gate = threading.Event()
    eng = pool.replicas[0].engine
    base = eng._step_fn

    def gated(*a):
        assert gate.wait(60)
        return base(*a)

    eng._step_fn = gated
    return reg, ServingHTTPServer(reg, port=0), gate


def _stream_client(srv, out, first, n=20):
    """POST a streamed generation of ``n`` tokens; ``first`` is set once
    its first token line has arrived."""
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
    try:
        conn.request("POST", "/generate", json.dumps(
            {"model": "lm", "prompt": PROMPT, "max_new_tokens": n,
             "stream": True}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out["status"] = resp.status
        resp.readline()
        first.set()
        out["last"] = json.loads(resp.read().decode().strip()
                                 .splitlines()[-1])
    finally:
        conn.close()


def test_drain_finishes_inflight_and_refuses_new():
    reg, srv, gate = _tiny_server()
    srv.start()
    try:
        first, res = threading.Event(), {}
        t = threading.Thread(target=_stream_client, args=(srv, res, first))
        t.start()
        # the first token comes from the prefill; the steps wait on the
        # gate, so the generation is in flight throughout the drain
        assert first.wait(60)
        drained = {}
        d = threading.Thread(target=lambda: drained.setdefault(
            "clean", srv.drain(deadline=60)))
        d.start()
        while not srv.draining:
            time.sleep(0.001)
        status, _c, _t = _request(srv, "POST", "/generate",
                                  {"model": "lm", "prompt": PROMPT})
        assert status == 503
        status, _c, _t = _request(srv, "GET", "/healthz")
        assert status == 503
        gate.set()
        d.join(60)
        t.join(60)
        assert drained["clean"] is True
        assert res["status"] == 200
        assert res["last"]["done"] and res["last"]["n_tokens"] == 20
    finally:
        gate.set()
        reg.close()


def test_sigterm_drains_run_forever():
    reg, srv, gate = _tiny_server()
    try:
        before = signal.getsignal(signal.SIGTERM)
        first, res = threading.Event(), {}

        def client():
            # run_forever starts the server, then installs its handler
            while signal.getsignal(signal.SIGTERM) is before:
                time.sleep(0.001)
            _stream_client(srv, res, first)

        def kill():
            assert first.wait(60)
            os.kill(os.getpid(), signal.SIGTERM)
            while not srv.draining:
                time.sleep(0.001)
            gate.set()

        threads = [threading.Thread(target=client),
                   threading.Thread(target=kill)]
        for t in threads:
            t.start()
        assert srv.run_forever(drain_deadline=60) is True
        assert signal.getsignal(signal.SIGTERM) is before
        for t in threads:
            t.join(60)
        assert res["status"] == 200 and res["last"]["n_tokens"] == 20
    finally:
        gate.set()
        reg.close()
