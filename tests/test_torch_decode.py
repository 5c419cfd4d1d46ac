"""The port's continuous-batching decode engine
(``mxnet_tpu_torch.serving.decode``) on the CPU, at the JAX decode tests'
tiny size: greedy streams token for token with the JAX engine in both KV
layouts and with the argmax of the teacher-forced forward; the sampler's
invariants (its streams differ from the JAX package's threefry draws by
design): a pure function of (seed, transcript) — independent of slot and
co-residents, resumed bit for bit after a re-prefill — with the right
distribution, and bits equal to a pure-numpy copy of its hash; and the
engine lifecycle with the JAX package's shed-reason counters."""

import threading
import time

import numpy as np
import pytest
import torch

from mxnet_tpu.models import transformer_lm as jtlm
from mxnet_tpu.serving import DecodeEngine as JaxEngine
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.serving import (DeadlineExceeded, DecodeEngine,
                                     GenerateSession, InvalidRequest,
                                     KVBlocksExhausted, Overloaded)
from mxnet_tpu_torch.serving import decode as dmod
from torch_deadline import deadline  # noqa: F401 (autouse)

VOCAB, EMBED, HEADS, LAYERS, FFN, MAX_LEN = 32, 16, 2, 2, 32, 32
CFG = tlm.LMConfig(VOCAB, EMBED, HEADS, LAYERS, FFN, MAX_LEN, eos_id=VOCAB)
CFG_EOS = tlm.LMConfig(VOCAB, EMBED, HEADS, LAYERS, FFN, MAX_LEN, eos_id=2)
PARAMS = tlm.init_params(CFG, seed=3)
PROMPT = [5, 7, 9, 2]
OPTS = {"slots": 4, "prefill_buckets": (4, 8), "max_queue": 64,
        "device": "cpu"}
PROMPTS = [PROMPT, [1, 2, 3, 4, 5, 6], [9, 9, 9], [30, 1, 4, 1, 5, 9, 2, 6]]


@pytest.fixture(autouse=True)
def _telemetry():
    telemetry.reset()
    telemetry.enable()
    yield
    telemetry.disable()
    telemetry.reset()


def _engine(cfg=CFG, **kw):
    opts = dict(OPTS)
    opts.update(kw)
    return DecodeEngine(cfg, PARAMS, name="lm", **opts)


def _greedy_ref(cfg, prompt, n):
    toks = list(prompt)
    out = []
    for _ in range(n):
        nxt = int(tlm.forward_logits(cfg, PARAMS, np.array([toks]))[0, -1]
                  .argmax())
        out.append(nxt)
        toks.append(nxt)
        if nxt == cfg.eos_id:
            break
    return out


def _run(eng, prompts, **kw):
    sess = [eng.submit(p, **kw) for p in prompts]
    return [s.result(60) for s in sess]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_greedy_streams_equal_the_jax_engine(layout):
    kv = {"kv_layout": layout, "kv_block_size": 4}
    jopts = {k: v for k, v in OPTS.items() if k != "device"}
    jeng = JaxEngine(jtlm.LMConfig(*CFG), jtlm.init_params(
        jtlm.LMConfig(*CFG), seed=3), name="lm", **dict(jopts, **kv))
    try:
        want = _run(jeng, PROMPTS, max_new_tokens=12)
    finally:
        jeng.close()
    eng = _engine(**kv)
    try:
        got = _run(eng, PROMPTS, max_new_tokens=12)
    finally:
        eng.close()
    assert got == want
    assert got == [_greedy_ref(CFG, p, 12) for p in PROMPTS]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_eos_retires_early_and_matches_jax(layout):
    kv = {"kv_layout": layout, "kv_block_size": 4}
    ref = _greedy_ref(CFG_EOS, PROMPT, 20)
    eng = _engine(cfg=CFG_EOS, **kv)
    try:
        out = eng.generate(PROMPT, max_new_tokens=20, timeout=60)
    finally:
        eng.close()
    assert out == ref
    if CFG_EOS.eos_id in out:
        assert out[-1] == CFG_EOS.eos_id and len(out) < 20


def test_temperature_stream_is_independent_of_slot_and_co_residents():
    eng = _engine(slots=1)
    try:
        alone = eng.generate([3, 1, 4], max_new_tokens=14, temperature=0.9,
                             seed=1234, timeout=60)
    finally:
        eng.close()
    for layout in ("dense", "paged"):
        eng = _engine(kv_layout=layout, kv_block_size=4)
        try:
            # others take slots 0-2 first; the session lands in slot 3
            crowd = [eng.submit(p, max_new_tokens=20, temperature=0.7,
                                seed=i) for i, p in enumerate(PROMPTS[:3])]
            sess = eng.submit([3, 1, 4], max_new_tokens=14,
                              temperature=0.9, seed=1234)
            assert sess.result(60) == alone
            assert sess.slot == 3
            for c in crowd:
                c.result(60)
        finally:
            eng.close()


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_resume_after_reprefill_continues_bit_for_bit(layout, temperature):
    eng = _engine(kv_layout=layout, kv_block_size=4,
                  prefill_buckets=(4, 8, 16))
    try:
        full = eng.generate(PROMPT, max_new_tokens=16,
                            temperature=temperature, seed=99, timeout=60)
        for k in (1, 5, 11):
            sess = GenerateSession(np.asarray(PROMPT, np.int32), 16,
                                   temperature, None, None, seed=99)
            sess.tokens = list(full[:k])
            eng.resume(sess)
            assert sess.result(60) == full
        assert eng.resumed == 3
    finally:
        eng.close()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_resume_past_the_largest_bucket_pads_to_max_len(layout):
    """A resumed transcript longer than the largest bucket (5 + 6 > 8)
    re-prefills at ``max_len`` and continues bit for bit; a prompt of
    that length is still refused."""
    eng = _engine(kv_layout=layout, kv_block_size=4, prefill_buckets=(4, 8))
    try:
        prompt = [1, 2, 3, 4, 5]
        full = eng.generate(prompt, max_new_tokens=16, temperature=0.8,
                            seed=7, timeout=60)
        sess = GenerateSession(np.asarray(prompt, np.int32), 16, 0.8, None,
                               None, seed=7)
        sess.tokens = list(full[:6])
        eng.resume(sess)
        assert sess.result(60) == full
        assert eng.resumed == 1 and eng.reprefilled_tokens == 11
        with pytest.raises(InvalidRequest, match="largest prefill bucket"):
            eng.submit(list(range(11)), max_new_tokens=2)
    finally:
        eng.close()


def test_seed_defaults_come_from_mx_random():
    streams = []
    for _ in range(2):
        mx.random.seed(11)
        eng = _engine()
        try:
            streams.append(eng.generate(PROMPT, max_new_tokens=8,
                                        temperature=0.8, timeout=60))
        finally:
            eng.close()
    assert streams[0] == streams[1] and len(streams[0]) == 8


def _np_mul32(x, c):
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & 0xFFFFFFFF


def _np_fmix32(x):
    x = x ^ (x >> 16)
    x = _np_mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _np_mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _np_bits(seeds, positions, vocab):
    """The sampling hash in numpy uint64: the port's bits, computed
    independently of torch."""
    seeds = np.asarray(seeds, np.uint64)
    positions = np.asarray(positions, np.uint64) & np.uint64(0xFFFFFFFF)
    key = _np_fmix32(_np_fmix32(seeds ^ np.uint64(0x9E3779B9)) ^ positions)
    v = np.arange(vocab, dtype=np.uint64)
    return _np_fmix32(_np_fmix32(key[:, None] ^ v[None, :])
                      ^ np.uint64(0x2545F491))


def test_hash_bits_equal_a_numpy_copy():
    rs = np.random.RandomState(0)
    seeds = rs.randint(0, 1 << 32, 50, dtype=np.uint64)
    seeds[:3] = [0, 1, 0xFFFFFFFF]
    pos = rs.randint(0, 1 << 31, 50).astype(np.uint64)
    pos[:2] = [0, (1 << 32) + 5]          # positions are taken mod 2^32
    got = dmod.sample_bits(torch.from_numpy(seeds.astype(np.int64)),
                           torch.from_numpy(pos.astype(np.int64)),
                           torch.arange(1000))
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF
    assert np.array_equal(got.numpy().astype(np.uint64),
                          _np_bits(seeds, pos, 1000))


def test_draws_follow_softmax_of_logits_over_t():
    """A chi-square test of 20k draws at vocab 32 against
    ``softmax(logits / t)``: independent draws per (seed, position)."""
    rs = np.random.RandomState(1)
    logits = torch.from_numpy(rs.normal(0, 1.5, 32).astype(np.float32))
    n, t = 20000, 0.8
    draws = dmod.sample_tokens(
        logits[None].expand(n, 32), torch.full((n,), t),
        torch.from_numpy(rs.randint(0, 1 << 32, n, dtype=np.int64)),
        torch.from_numpy(rs.randint(0, 1024, n)), torch.arange(32))
    counts = np.bincount(draws.numpy(), minlength=32)
    p = torch.softmax(logits.double() / t, 0).numpy()
    expected = n * p
    chi2 = ((counts - expected) ** 2 / expected).sum()
    # 31 degrees of freedom: P(chi2 > 61.1) = 0.001
    assert chi2 < 61.1, (chi2, counts)
    # and the greedy rows take the argmax
    g = dmod.sample_tokens(logits[None].expand(3, 32), torch.zeros(3),
                           torch.arange(3), torch.arange(3),
                           torch.arange(32))
    assert g.tolist() == [int(logits.argmax())] * 3


def test_invalid_requests_fail_at_submit():
    eng = _engine()
    try:
        for bad, kw in (([], {}), (list(range(1, 10)), {}),
                        ([VOCAB + 3], {}), (PROMPT, {"max_new_tokens": 0}),
                        (PROMPT, {"temperature": -1.0})):
            kw.setdefault("max_new_tokens", 3)
            with pytest.raises(InvalidRequest):
                eng.submit(bad, **kw)
    finally:
        eng.close()


def test_mid_decode_admission_joins_running_batch():
    eng = _engine(slots=2)
    try:
        five = threading.Event()
        a_tok = []

        def on_a(t):
            a_tok.append(t)
            if len(a_tok) >= 5:
                five.set()

        a = eng.submit(PROMPT, max_new_tokens=25, on_token=on_a)
        assert five.wait(60)
        a_len_at_b_done = []
        b = eng.submit([3, 4], max_new_tokens=3,
                       on_done=lambda _s: a_len_at_b_done.append(
                           len(a.tokens)))
        assert len(b.result(60)) == 3
        assert a_len_at_b_done and a_len_at_b_done[0] < 25
        assert len(a.result(60)) == 25
        assert b.admit_step > a.admit_step
        assert b.done_step < a.done_step
    finally:
        eng.close()


def test_streaming_callback_receives_every_token_in_order():
    got = []
    eng = _engine()
    try:
        sess = eng.submit(PROMPT, max_new_tokens=6, on_token=got.append)
        out = sess.result(60)
        assert got == out and len(out) == 6 and sess.ttft() >= 0
    finally:
        eng.close()


def _shed(reason):
    c = telemetry.snapshot()["counters"].get("serving.shed.count", {})
    return c.get("model=lm,reason=%s" % reason, 0)


def test_cancel_mid_generation_frees_the_slot():
    eng = _engine(slots=1)
    try:
        mid, go = threading.Event(), threading.Event()
        seen = []

        def on_tok(t):
            # the engine thread waits here at the third token until the
            # client has cancelled: the session is mid-generation
            seen.append(t)
            if len(seen) == 3:
                mid.set()
                assert go.wait(60)

        a = eng.submit(PROMPT, max_new_tokens=25, on_token=on_tok)
        assert mid.wait(60)
        assert a.cancel() is True
        go.set()
        with pytest.raises(mx.MXNetError):
            a.result(30)
        assert len(eng.generate([3, 4], max_new_tokens=2, timeout=60)) == 2
        assert _shed("abandoned") == 1
    finally:
        eng.close()


def test_queue_overload_and_deadline_shed():
    eng = _engine(max_queue=2, autostart=False)
    try:
        eng.submit(PROMPT, max_new_tokens=2)
        eng.submit(PROMPT, max_new_tokens=2)
        with pytest.raises(Overloaded):
            eng.submit(PROMPT, max_new_tokens=2)
        assert _shed("overload") == 1
    finally:
        eng.close(drain=False)
    eng = _engine(slots=1, autostart=False)
    try:
        slow = eng.submit(PROMPT, max_new_tokens=8)
        doomed = eng.submit(PROMPT, max_new_tokens=8, deadline_ms=1.0)
        time.sleep(0.05)
        eng.start()
        slow.result(60)
        with pytest.raises(DeadlineExceeded):
            doomed.result(60)
        assert _shed("deadline") == 1
    finally:
        eng.close()


def test_kv_blocks_exhausted_sheds_typed():
    """A pool too small for two sessions' growth sheds one typed
    (KVBlocksExhausted, an Overloaded) and keeps serving the other."""
    eng = _engine(kv_layout="paged", kv_block_size=4, kv_blocks=10,
                  kv_prefix_cache=False)
    try:
        a = eng.submit([1, 2, 3, 4, 5, 6, 7], max_new_tokens=24)
        b = eng.submit([7, 6, 5, 4, 3, 2, 1], max_new_tokens=24)
        outcomes = []
        for s in (a, b):
            try:
                outcomes.append(len(s.result(60)))
            except KVBlocksExhausted:
                outcomes.append("shed")
        assert "shed" in outcomes and 24 in outcomes
        assert _shed("kv_blocks") == 1
        assert len(eng.generate([3, 4], max_new_tokens=3, timeout=60)) == 3
    finally:
        eng.close()


def test_failed_step_errors_the_batch_and_the_engine_survives():
    eng = _engine()
    try:
        base = eng._step_fn
        calls = []

        def boom(*a):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("injected step failure")
            return base(*a)

        eng._step_fn = boom
        with pytest.raises(RuntimeError, match="injected"):
            eng.generate(PROMPT, max_new_tokens=6, timeout=60)
        out = eng.generate(PROMPT, max_new_tokens=6, timeout=60)
        assert out == _greedy_ref(CFG, PROMPT, 6)
        assert telemetry.counter_total("serving.error.count") == 1
    finally:
        eng.close()


def test_stop_drains_active_and_sheds_queued():
    eng = _engine(slots=1)
    try:
        started, go = threading.Event(), threading.Event()

        def on_tok(t):
            # the engine thread holds at the first token until the queued
            # session has been shed by stop()
            started.set()
            assert go.wait(60)

        a = eng.submit(PROMPT, max_new_tokens=20, on_token=on_tok)
        assert started.wait(60)
        queued = eng.submit([3, 4], max_new_tokens=4)
        stopped = {}
        t = threading.Thread(target=lambda: stopped.setdefault(
            "clean", eng.stop(drain=True, deadline=60)))
        t.start()
        while not queued.done():
            time.sleep(0.001)
        go.set()
        t.join(60)
        assert stopped["clean"] is False
        assert len(a.result(5)) == 20
        with pytest.raises(mx.MXNetError, match="stopped"):
            queued.result(5)
        assert _shed("drain") == 1
        with pytest.raises(Overloaded, match="draining"):
            eng.submit(PROMPT, max_new_tokens=2)
        eng.start()
        assert len(eng.generate(PROMPT, max_new_tokens=3, timeout=60)) == 3
    finally:
        eng.close()
    with pytest.raises(mx.MXNetError, match="closed"):
        eng.submit(PROMPT, max_new_tokens=2)
    with pytest.raises(mx.MXNetError, match="closed"):
        eng.rewarm()


def test_telemetry_families_present_after_traffic():
    eng = _engine()
    try:
        eng.generate(PROMPT, max_new_tokens=5, timeout=60)
        snap = telemetry.snapshot()
        for fam in ("serving.decode.sessions.count",
                    "serving.decode.tokens.count",
                    "serving.decode.steps.count"):
            assert fam in snap["counters"], fam
        for fam in ("serving.decode.slot_occupancy",
                    "serving.decode.tokens_per_sec"):
            assert fam in snap["gauges"], fam
        for fam in ("serving.decode.ttft_seconds",
                    "serving.decode.token_latency_seconds"):
            assert fam in snap["histograms"], fam
        desc = eng.describe()
        assert desc["kind"] == "generate" and desc["kv"]["layout"] == "dense"
        assert desc["tokens"] >= 5 and desc["device"] == "cpu"
    finally:
        eng.close()


def test_engine_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opts = {k: v for k, v in OPTS.items() if k != "device"}
    with pytest.raises(mx.MXNetError, match="CUDA"):
        DecodeEngine(CFG, PARAMS, **opts)
    with pytest.raises(mx.MXNetError, match="CUDA"):
        DecodeEngine(CFG, PARAMS, device="cuda:0", **opts)
    with pytest.raises(mx.MXNetError, match="CUDA"):
        mx.serving.lm_pool(CFG, PARAMS, engine_opts=opts)


def test_heartbeat_goes_stale_only_for_a_wedged_or_dead_engine():
    """An idle engine keeps stamping its heartbeat (its loop waits 20 ms
    at a time); a step that hangs lets it age; a worker that is gone
    (hard kill) lets it age for good.  No worker: None."""
    from mxnet_tpu_torch import faults

    eng = _engine(autostart=False)
    assert eng.heartbeat_age() is None
    eng.start()
    try:
        # an idle loop stamps every 20 ms; 1 s leaves room for a starved
        # thread on a loaded host
        time.sleep(0.3)
        ages = [eng.heartbeat_age() for _ in range(5)]
        assert max(ages) < 1.0, ages
        gate, inside = threading.Event(), threading.Event()
        base = eng._step_fn

        def wedged(*a):
            inside.set()
            assert gate.wait(60)
            return base(*a)

        eng._step_fn = wedged
        sess = eng.submit(PROMPT, max_new_tokens=3)
        assert inside.wait(60)
        time.sleep(1.2)
        assert eng.heartbeat_age() >= 1.2
        eng._step_fn = base
        gate.set()
        assert sess.result(60) == _greedy_ref(CFG, PROMPT, 3)
        time.sleep(0.1)
        assert eng.heartbeat_age() < 1.0
        faults.arm("serving.replica.kill", at=1)
        with pytest.raises(dmod.ReplicaKilled):
            eng.generate(PROMPT, max_new_tokens=3, timeout=60)
        faults.disarm()
        eng._thread.join(60)
        time.sleep(1.2)
        assert eng.heartbeat_age() >= 1.2
    finally:
        faults.disarm()
        eng.close(drain=False)
    assert eng.heartbeat_age() is None


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_replica_kill_closes_the_engine_for_good(layout):
    """``serving.replica.kill`` at the third step: the held sessions get
    :class:`ReplicaKilled` (no pool above to migrate them), the worker
    exits, the device state is released, submits fail fast and ``rewarm``
    refuses."""
    from mxnet_tpu_torch import faults

    eng = _engine(kv_layout=layout, kv_block_size=4)
    try:
        faults.arm("serving.replica.kill", at=3)
        sess = [eng.submit(p, max_new_tokens=8) for p in PROMPTS[:2]]
        for s in sess:
            with pytest.raises(dmod.ReplicaKilled, match="hard-killed"):
                s.result(60)
            assert 1 <= len(s.tokens) <= 3
        eng._thread.join(60)
        assert not eng._thread.is_alive()
        assert eng._live is None and eng.state_tensors() == \
            [v for p in eng._params.values()
             for v in (p.values() if isinstance(p, dict) else [p])]
        assert eng.pending_rows() == 0
        with pytest.raises(mx.MXNetError, match="closed"):
            eng.submit(PROMPT, max_new_tokens=2)
        with pytest.raises(mx.MXNetError, match="closed"):
            eng.rewarm()
        with pytest.raises(mx.MXNetError, match="closed"):
            eng.start()
        assert faults.hits("serving.replica.kill") == 3
        assert telemetry.counter_total("serving.error.count") == 1
    finally:
        faults.disarm()
        eng.close(drain=False)


def test_a_closed_engine_hands_its_lane_on_and_is_freed(monkeypatch):
    """An engine warms and serves on its lane's one thread; once closed
    it gives the lane (stream and thread) to the next engine on its
    device, and the idle lane keeps nothing of it alive."""
    import gc
    import weakref

    seen = []
    warm = DecodeEngine._warm

    def traced_warm(self, state):
        seen.append(("warm", threading.current_thread()))
        return warm(self, state)

    monkeypatch.setattr(DecodeEngine, "_warm", traced_warm)
    eng = _engine()
    eng.submit(PROMPT, max_new_tokens=2, on_token=lambda *a: seen.append(
        ("token", threading.current_thread()))).result(60)
    lane = eng._lane
    assert {t for _what, t in seen} == {lane._thread}
    eng.close()
    ref = weakref.ref(eng)
    del eng
    gc.collect()
    assert ref() is None
    nxt = _engine()
    try:
        assert nxt._lane is lane and seen[-1] == ("warm", lane._thread)
        assert nxt.generate(PROMPT, max_new_tokens=3, timeout=60) \
            == _greedy_ref(CFG, PROMPT, 3)
    finally:
        nxt.close()


def test_decode_fault_fails_one_step_and_the_engine_serves_on():
    from mxnet_tpu_torch import faults

    eng = _engine()
    try:
        faults.arm("serving.decode", at=2)
        with pytest.raises(faults.FaultInjected, match="serving.decode"):
            eng.generate(PROMPT, max_new_tokens=6, timeout=60)
        assert eng.generate(PROMPT, max_new_tokens=6, timeout=60) \
            == _greedy_ref(CFG, PROMPT, 6)
        assert telemetry.counter_total("serving.error.count") == 1
        assert eng.heartbeat_age() is not None
    finally:
        faults.disarm()
        eng.close()
