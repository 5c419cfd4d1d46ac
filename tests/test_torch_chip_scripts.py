"""What the card scripts at the repository root compute without a card:
their source edits, their sums, the build reports they parse, and the
decode phase's traffic, token rule and byte bound.
``chip_smoke.py``, ``chip_bn_costs.py``, ``chip_lstm_costs.py`` and
``chip_k3b_costs.py`` run only on an NVIDIA card; these checks keep the
parts that do not need one from failing there first."""

import importlib.util
import os

import numpy as np
import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_ROOT, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _edits(name):
    mod = _script(name)
    src = {"chip_bn_costs": "batch_norm.cu", "chip_lstm_costs": "lstm.cu",
           "chip_k3b_costs": "flash_attention.cu",
           "chip_k8_costs": "roi_pooling.cu"}[name]
    edits = [(v, e) for v, es in mod.VARIANTS.items() for e in es]
    edits += [("every variant", e) for e in getattr(mod, "SMID", [])]
    return src, edits


@pytest.mark.parametrize("name", ["chip_bn_costs", "chip_lstm_costs",
                                  "chip_k3b_costs", "chip_k8_costs"])
def test_variant_edits_match_the_kernel_source_once(name):
    """Each variant is the committed source with edits that must each
    match exactly once, or the script stops before it times anything."""
    src, edits = _edits(name)
    with open(os.path.join(_ROOT, "mxnet_tpu_torch", "csrc", src)) as f:
        text = f.read()
    bad = [(variant, old) for variant, (old, _new) in edits
           if text.count(old) != 1]
    assert not bad


def test_bn_step_total_weights_rows_and_leaves_unmeasured_out():
    smoke = _script("chip_smoke")
    rows = [dict(shape=(128, 3, 224, 224), count=1, ms=2.0, parent_ms=None),
            dict(shape=(128, 64, 56, 56), count=7, ms=0.5, parent_ms=None)]
    assert smoke.bn_step_total(rows, "ms") == 2.0 + 7 * 0.5
    assert smoke.bn_step_total(rows, "ms", lambda r: r["shape"][1] != 3) \
        == 7 * 0.5
    assert smoke.bn_step_total(rows, "parent_ms") is None


def _event(name, start, end, device="CUDA"):
    from types import SimpleNamespace as NS

    return NS(name=name, device_type=NS(name=device),
              time_range=NS(start=start, end=end))


def test_device_timeline_merges_kernels_and_measures_copies_under_them():
    """Kernels at 0-100 and 50-150 us and 300-400 us: busy 250 of a 400 us
    span; a 1 ms-sized copy at 100-350 us runs under kernels for 100 us
    of its 250; small copies, memsets and host events do not count."""
    from types import SimpleNamespace as NS

    smoke = _script("chip_smoke")
    events = [_event("k1", 0, 100), _event("k2", 50, 150),
              _event("k3", 300, 400),
              _event("Memcpy HtoD (Pinned -> Device)", 100, 350),
              _event("Memcpy HtoD (Pinned -> Device)", 10, 12),
              _event("Memset (Device)", 150, 300),
              _event("aten::copy_", 0, 1000, device="CPU")]
    tl = smoke._device_timeline(NS(events=lambda: events))
    assert tl["span"] == 0.4 and tl["busy"] == 0.25
    assert tl["idle"] == 1 - 250 / 400
    assert tl["copies"] == 1 and tl["copy_ms"] == 0.25
    assert tl["covered"] == 100 / 250
    assert smoke._device_timeline(NS(events=lambda: events[3:])) is None


def test_environment_sets_and_restores(monkeypatch):
    import os

    smoke = _script("chip_smoke")
    monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "0")
    monkeypatch.delenv("MXNET_BULK_TRAIN_STEPS", raising=False)
    with pytest.raises(KeyError):
        with smoke.environment(smoke.SYNC_FREE_ENV):
            assert os.environ["MXNET_FUSE_TRAIN_STEP"] == "1"
            assert os.environ["MXNET_BULK_TRAIN_STEPS"] == "2"
            raise KeyError
    assert os.environ["MXNET_FUSE_TRAIN_STEP"] == "0"
    assert "MXNET_BULK_TRAIN_STEPS" not in os.environ


def test_ptxas_report_reads_registers_and_spills_per_kernel():
    from types import SimpleNamespace as NS

    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z3fwdv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3fwdv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 191 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z3bwdv' for 'sm_90a'",
        "    16 bytes stack frame, 12 bytes spill stores, 28 bytes spill "
        "loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 16 bytes smem"])
    kernels = NS(build_log=lambda lib: log if lib == "flash_attention"
                 else "")
    report = _script("chip_smoke").ptxas_report(kernels, "flash_attention")
    assert report == {"_Z3fwdv": (191, 0, 0), "_Z3bwdv": (255, 12, 28)}


def test_bn_configs_read_from_the_graphs():
    """Phase 4's inputs: ResNet-50's 51 BatchNorms at 13 shapes and
    Inception-v3's 94 at 18, each Inception one fix_gamma with its ReLU
    fused (the executor's peephole), at b128."""
    import mxnet_tpu_torch as mx

    smoke = _script("chip_smoke")
    resnet = smoke.resnet_bn_configs(mx, smoke.TRAIN_BATCH)
    assert (len(resnet), sum(resnet.values())) == (13, 51)
    inception = smoke.inception_bn_configs(mx, smoke.TRAIN_BATCH)
    assert (len(inception), sum(inception.values())) == \
        (18, smoke.INCEPTION_BNS)
    assert all(fix_gamma and relu for _s, fix_gamma, relu in inception)
    sides = {shape[2] for shape, _g, _r in inception}
    assert sides == {149, 147, 73, 71, 35, 17, 8}


def test_mnist_fit_helper_runs_on_the_cpu(tmp_path):
    """Phase 14's fit helper over the synthetic idx files, on the CPU: the
    MLP learns, a perturbed training set is still a valid one, and an
    optimizer of common/fit.py other than SGD runs through it."""
    import mxnet_tpu_torch as mx

    smoke = _script("chip_smoke")
    paths = mx.models.lenet.synth_mnist(str(tmp_path), num_train=256,
                                        num_val=128)
    _s, acc, metrics, _mod = smoke.mnist_fit(mx, "mlp", paths, mx.cpu(), 0)
    assert acc == 1.0 and metrics["accuracy"] > 0.5
    _s, acc2, _m, _mod = smoke.mnist_fit(mx, "mlp", paths, mx.cpu(), 0,
                                         perturb=(1e-7, 1))
    assert acc2 == 1.0
    name, params = smoke.MNIST_OPTIMIZERS[0]
    _s, _a, metrics, mod = smoke.mnist_fit(mx, "lenet", paths, mx.cpu(), 0,
                                           1, name, params)
    assert type(mod._optimizer).__name__ == "NAG"
    assert metrics["cross-entropy"] == metrics["cross-entropy"]  # not NaN


def _tiny_lstm(monkeypatch, smoke):
    """Phase 9's and phase 17's LSTM constants at a CPU size."""
    for name, value in (("LSTM_VOCAB", 30), ("LSTM_EMBED", 8),
                        ("LSTM_HIDDEN", 8), ("LSTM_BATCH", 4),
                        ("LSTM_BUCKETS", (5, 10)),
                        ("LSTM_TRAIN_SENTENCES", 24),
                        ("LSTM_VAL_SENTENCES", 12)):
        monkeypatch.setattr(smoke, name, value)


def test_rnn_toolkit_step_helpers_run_on_the_cpu(monkeypatch):
    """Phase 17's steps at a CPU size: the unfused stack's step and the
    fused cell's from the same weights (both TNC), carried with
    ``unpack_weights``, agree within its 1e-4 bound; a step with dropout
    repeats bit for bit from its seed and differs from the p=0 step; the
    NT and TN iterators of phase 9's corpus give the same batches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import lstm_lm

    smoke = _script("chip_smoke")
    _tiny_lstm(monkeypatch, smoke)
    ids = np.random.RandomState(0).randint(1, 30, (10, 4)).astype(np.float32)
    init = smoke._lstm_module(mx, lstm_lm, mx.cpu(), key=10)
    init.bind([("data", ids.shape)], [("softmax_label", ids.shape)])
    mx.init.seed(0)
    init.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34))
    fused = mx.convert.module_params_to_numpy(init)[0]
    cell = lstm_lm.build_cell(8, 2)
    unfused = {k: v.asnumpy() if hasattr(v, "asnumpy") else v
               for k, v in cell.unpack_weights(fused).items()}
    gu = smoke.lstm_step_updates(mx, lstm_lm, mx.cpu(), unfused, ids,
                                 cell=lstm_lm.build_stack(8, 2))
    fu = {k: v.asnumpy() if hasattr(v, "asnumpy") else v
          for k, v in cell.unpack_weights(smoke.lstm_step_updates(
              mx, lstm_lm, mx.cpu(), fused, ids)).items()}
    assert smoke._update_distances("t", "cpu", gu, fu, None, "u") <= 1.0
    drop = lstm_lm.build_cell(8, 2, dropout=0.5)
    a, b = (smoke.lstm_step_updates(mx, lstm_lm, mx.cpu(), fused, ids,
                                    cell=drop, draw_seed=3)
            for _ in range(2))
    plain = smoke.lstm_step_updates(mx, lstm_lm, mx.cpu(), fused, ids)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["lstm_parameters"], plain["lstm_parameters"])
    _t, tn = smoke._lstm_corpus_iters(mx, lstm_lm, 0, "TN")
    _t, nt = smoke._lstm_corpus_iters(mx, lstm_lm, 0, "NT")
    for x, y in zip(tn, nt):
        assert x.bucket_key == y.bucket_key
        np.testing.assert_array_equal(x.data[0].asnumpy().T,
                                      y.data[0].asnumpy())


def test_update_distances_bound_and_refusal():
    smoke = _script("chip_smoke")
    want = {"w": np.ones(4)}
    assert smoke._update_distances("t", "x", {"w": np.ones(4) * (1 + 5e-5)},
                                   want, None, "u") == pytest.approx(0.5)
    # a floor above 1e-4 widens the bound to 3x the floor
    floor = {"w": np.ones(4) * 1.001}
    assert smoke._update_distances("t", "x", {"w": np.ones(4) * 1.002},
                                   want, floor, "u") == pytest.approx(
                                       2 / 3, rel=1e-6)
    with pytest.raises(RuntimeError, match="of the norm"):
        smoke._update_distances("t", "x", {"w": np.ones(4) * 1.01}, want,
                                None, "u")


def test_lstm_checking_and_dropout_counting_on_the_cpu():
    """``lstm_checking`` holds what a route sends to the kernel against the
    plain version on the same inputs (here a plain version scaled by
    1 + 1e-3 stands in for the kernel); ``dropout_counted`` sums what the
    ``RNN`` op's dropout keeps."""
    import types

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import rnn as nn_rnn
    from mxnet_tpu_torch.ops import rnn_kernel

    smoke = _script("chip_smoke")

    def fake_kernel(*args):
        return [t * (1 + 1e-3) for t in rnn_kernel.lstm_infer_plain(*args)]

    rk = types.SimpleNamespace(
        _route=lambda x, cuda_fn, plain_fn: cuda_fn)
    rs = np.random.RandomState(0)
    args = [torch.from_numpy(rs.normal(0, 0.5, s).astype(np.float32))
            for s in ((5, 4, 2, 3), (4, 3, 3), (4, 3), (2, 3), (2, 3))]
    errs = {}
    with smoke.lstm_checking(rk, errs):
        rk._route(args[0], fake_kernel, rnn_kernel.lstm_infer_plain)(*args)
    assert list(errs) == ["fake_kernel"]
    assert errs["fake_kernel"][0] == pytest.approx([1e-3] * 3,
                                                   rel=1e-3)
    kept = []
    op = mx.ops.get("RNN")
    attrs = op.canonicalize_attrs(dict(state_size=50, num_layers=2,
                                       mode="lstm", p=0.5))
    x = torch.from_numpy(rs.normal(0, 1, (20, 10, 4)).astype(np.float32))
    params = torch.from_numpy(rs.normal(0, 0.3, mx.ops.rnn.rnn_param_size(
        4, 50, 2, "lstm")).astype(np.float32))
    zeros = torch.zeros(2, 10, 50)
    with smoke.dropout_counted(nn_rnn, kept), torch.no_grad():
        op.apply(attrs, [x, params, zeros, zeros], [], True)
    assert nn_rnn.dropout is mx.ops.nn.dropout
    assert len(kept) == 1 and kept[0][1] == 10000
    assert abs(int(kept[0][0]) / 10000 - 0.5) < 0.03


def test_sequential_fit_helper_runs_on_the_cpu(tmp_path):
    """Phase 17d's fit helper on the CPU: the first batches of
    ``MNISTIter`` through the MLP feature module and the Python loss head
    move every parameter; a perturbed run starts from the same weights."""
    import mxnet_tpu_torch as mx

    smoke = _script("chip_smoke")
    paths = mx.models.lenet.synth_mnist(str(tmp_path), num_train=256,
                                        num_val=128)
    before, after, acc = smoke.sequential_fit(mx, paths, mx.cpu(), 0)
    assert sorted(before) == ["fc1_bias", "fc1_weight", "fc2_bias",
                              "fc2_weight", "fc3_bias", "fc3_weight"]
    assert all(not np.array_equal(before[k], after[k]) for k in before)
    assert 0.0 <= acc <= 1.0
    p0, _p1, _acc = smoke.sequential_fit(mx, paths, mx.cpu(), 0,
                                         perturb=(1e-7, 0))
    assert all(np.array_equal(before[k], p0[k]) for k in before)


def test_decode_traffic_is_seeded_and_shaped():
    smoke = _script("chip_smoke")
    a = smoke.decode_traffic(0, 96, 50257)
    assert a == smoke.decode_traffic(0, 96, 50257)
    assert a != smoke.decode_traffic(1, 96, 50257)
    lens = [len(r["prompt"]) for r in a]
    assert min(lens) >= 16 and max(lens) <= 480
    shared = [r for r in a if r["shared"]]
    assert len(shared) == 48
    prefix = shared[0]["prompt"][:256]
    assert all(r["prompt"][:256] == prefix and len(r["prompt"]) > 256
               for r in shared)
    assert sum(r["temperature"] == 0 for r in a) == 48
    assert {r["temperature"] for r in a} == {0.0, 0.8}
    assert sum(r["stream"] for r in a) == 24
    assert all(r["max_new_tokens"] == 128 for r in a)
    assert len({r["seed"] for r in a}) == 96
    # every transcript fits max_len, every prompt the largest bucket
    assert max(lens) + 128 <= 1024 and max(lens) <= 512


def test_token_rule_stops_at_the_first_near_tie():
    smoke = _script("chip_smoke")
    gap = [1.0, 1.0, 1e-4, 1.0]
    scale = [10.0] * 4
    assert smoke.token_rule([1, 2, 3, 4], [1, 2, 3, 4], gap, scale) \
        == (True, 2)
    # a disagreement after the near tie is allowed
    assert smoke.token_rule([1, 2, 3, 9], [1, 2, 5, 4], gap, scale) \
        == (True, 2)
    # one before it is not
    assert smoke.token_rule([1, 7, 3], [1, 2, 3], gap, scale) == (False, 1)
    assert smoke.token_rule([1, 2], [1, 2], [1.0, 1.0], [1.0, 1.0]) \
        == (True, None)
    assert smoke.token_rule([1, 2], [1, 2, 3], [1.0] * 3, [1.0] * 3) \
        == (False, 2)


def test_step_byte_bound_counts_weights_logits_and_kv():
    smoke = _script("chip_smoke")
    from mxnet_tpu_torch.models import transformer_lm as tlm

    cfg = tlm.LMConfig(eos_id=50257, **smoke.DECODE_WIDTHS)
    fixed, live = smoke.step_bytes(cfg, 32, [99] * 32)
    params = tlm.init_params(tlm.LMConfig(64, 16, 2, 2, 32, 8, 64))
    n = sum(v.numel() for p in params.values()
            for v in (p.values() if isinstance(p, dict) else [p]))
    small = tlm.LMConfig(64, 16, 2, 2, 32, 8, 64)
    f1, l1 = smoke.step_bytes(small, 1, [0])
    # every parameter but the two embedding tables, once; one row of each
    # table, one logits row; the cache: 8 positions read and one written
    # (fixed), one read and one written (live)
    row = 2 * 2 * 16
    base = n - 64 * 16 - 8 * 16 + 2 * 16 + 64
    assert f1 == 4 * (base + 8 * row + row)
    assert l1 == 4 * (base + row + row)
    # at full width the fixed-shape KV read is 6.44 GB of the 7.87
    assert abs(fixed / 1e9 - 7.869) < 0.01
    assert abs((fixed - live) - 4 * 32 * (1024 - 100) * 2 * 24 * 1024) < 1
    assert smoke.step_bytes(cfg, 32)[1] is None


def test_fleet_arrivals_and_priorities():
    """Phase 16's traffic: run E's burst then a trickle; run G's priority
    split, half under the pool's floor, seeded."""
    smoke = _script("chip_smoke")
    off = smoke.fleet_arrivals(96, 64, 3.0, 30.0)
    assert len(off) == 96 and off[:64] == [0.0] * 64
    assert off[64] == 3.0 and max(off) < 33.0
    assert all(b > a for a, b in zip(off[64:], off[65:]))
    assert smoke.fleet_arrivals(8, 8, 1.0, 1.0) == [0.0] * 8
    pr = smoke.fleet_priorities(48, 0)
    assert pr == smoke.fleet_priorities(48, 0)
    assert pr != smoke.fleet_priorities(48, 1)
    assert pr.count(smoke.FLEET_LOW) == pr.count(smoke.FLEET_FLOOR) == 24
    assert smoke.FLEET_LOW < smoke.FLEET_FLOOR == 5
    # run F and G's clients: every other of the 96, both temperatures
    sub = smoke.decode_traffic(0, 96, 50257)[::smoke.FLEET_STRIDE]
    assert len(sub) == 48 and {r["temperature"] for r in sub} == {0.0, 0.8}


def _d(action, t, **kw):
    return dict(kw, action=action, t=t, model="lm")


def test_fleet_replica_timeline_and_its_check():
    smoke = _script("chip_smoke")
    tl = smoke.replica_timeline([(0.0, 1), (0.1, 1), (0.2, 2), (0.3, 3),
                                 (0.4, 3), (0.5, 2), (0.6, 1), (0.7, 1)])
    assert tl == [(0.0, 1), (0.2, 2), (0.3, 3), (0.5, 2), (0.6, 1)]
    smoke.check_timeline("E", tl, 1, 2, 1)
    for bad in ([(0.0, 1)], [(0.0, 1), (1.0, 2)], [(0.0, 2), (1.0, 1)],
                [(0.0, 1), (0.5, 4), (1.0, 1)]):
        with pytest.raises(RuntimeError, match="replica count"):
            smoke.check_timeline("E", bad, 1, 2, 1)


def test_fleet_autoscale_and_supervision_checks():
    smoke = _script("chip_smoke")
    ok = [_d("slo_breach", 1.0), _d("scale_up", 1.5, replica=1),
          _d("scale_up", 4.0, replica=2), _d("scale_down", 9.0, replica=2),
          _d("scale_down", 11.5, replica=1)]
    ups, downs = smoke.check_autoscale(ok, {2: 0, 1: 7}, burst_done=8.0)
    assert len(ups) == 2 and len(downs) == 2
    with pytest.raises(RuntimeError, match="no scale-up"):
        smoke.check_autoscale(ok[:1] + ok[3:], {1: 7}, 8.0)
    # the scale-up came after the burst; no scale-down moved anything
    with pytest.raises(RuntimeError, match="no scale-up"):
        smoke.check_autoscale(ok, {2: 0, 1: 7}, burst_done=1.2)
    with pytest.raises(RuntimeError, match="no scale-down"):
        smoke.check_autoscale(ok, {2: 0, 1: 0}, burst_done=8.0)
    # a scale-down that moved sessions but came before any scale-up
    early = [_d("scale_down", 0.5, replica=1)] + ok[1:3]
    with pytest.raises(RuntimeError, match="no scale-down"):
        smoke.check_autoscale(early, {1: 7}, burst_done=8.0)
    smoke.check_supervision([_d("restart", 1.0), _d("slo_breach", 1.5),
                             _d("quarantine", 2.0)])
    for acts in (["restart"], ["quarantine"], ["restart", "restart"],
                 ["restart", "restart_failed", "quarantine"]):
        with pytest.raises(RuntimeError, match="supervision"):
            smoke.check_supervision([_d(a, float(i))
                                     for i, a in enumerate(acts)])


def _client(status, sent, recv, error=""):
    r = {"status": status, "sent": sent, "recv": recv}
    if status == 200:
        r["tokens"] = [1]
    else:
        r["error"] = error
    return r


def test_fleet_shed_check_holds_refusals_to_the_pressure():
    smoke = _script("chip_smoke")
    ev = [{"on": True, "ts": 1.0}, {"on": False, "ts": 3.0},
          {"on": True, "ts": 4.0}, {"on": False, "ts": 5.0}]
    spans = smoke.pressure_windows(ev, 99.0)
    assert spans == [(1.0, 3.0), (4.0, 5.0)]
    assert smoke.pressure_windows(ev[:3], 9.0) == [(1.0, 3.0), (4.0, 9.0)]
    shed = ('{"error": "pool past its priority watermark under fleet shed '
            'pressure: priority 1 < floor 5 shed"}')
    low, high = smoke.FLEET_LOW, smoke.FLEET_FLOOR
    results = [_client(200, 0.5, 9.0), _client(429, 1.5, 1.51, shed),
               _client(200, 1.6, 9.0), _client(200, 3.5, 9.0),
               _client(429, 4.5, 4.51, shed), _client(200, 6.0, 9.0)]
    prio = [low, low, high, low, low, low]
    assert smoke.check_shed(results, prio, spans) == ([1, 4], [0, 3, 5])
    cases = [
        # a refusal of a client at the floor
        (dict(prio=[low, high, high, low, low, low]), "refused outside"),
        # a refusal while the pressure was off
        (dict(results=results[:3] + [_client(429, 3.5, 3.51, shed)]
              + results[4:]), "refused outside"),
        # a client under the floor admitted well inside a span
        (dict(results=results[:1] + [_client(200, 1.5, 9.0)] + results[2:]),
         "admitted"),
        # a failure of any other kind
        (dict(results=results[:2] + [_client(500, 1.6, 1.7, "boom")]
              + results[3:]), "failed"),
    ]
    for kw, match in cases:
        with pytest.raises(RuntimeError, match=match):
            smoke.check_shed(kw.get("results", results), kw.get("prio", prio),
                             spans)
    with pytest.raises(RuntimeError, match="nothing was shed"):
        smoke.check_shed([_client(200, 0.5, 9.0)], [low], [])


def test_ssd_phase_helpers_run_on_the_cpu():
    """Phase 18's SSD step helper at 96x96 b2 on the CPU (the parity
    phase's step), its constants against the graphs (SSD300's 7308
    anchors; the classic networks bind at their sides, VGG-16-BN with 13
    BatchNorms, Inception-BN with 69 and Inception-ResNet-v2 with 244),
    and its IoU count against the greedy loop counted by brute force."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import ssd_vgg16

    smoke = _script("chip_smoke")
    x, y = ssd_vgg16.synth_detection_set(2, 96, smoke.SSD_CLASSES)
    upd, aux, _ = smoke.ssd_step_updates(
        mx, lambda mx, ctx=None: smoke._ssd_module(mx, ssd_vgg16, ctx),
        mx.cpu(), x, y, 0)
    assert aux == {} and all(np.isfinite(v).all() for v in upd.values())
    assert np.abs(upd["multibox0_scale"]).max() > 0
    net = ssd_vgg16.get_symbol_train(num_classes=smoke.SSD_CLASSES)
    inner = net.get_internals()["multibox_anchors_output"]
    _a, out, _x = inner.infer_shape(data=(1, 3, smoke.SSD_IMAGE,
                                          smoke.SSD_IMAGE))
    assert out[0] == (1, smoke.SSD_ANCHORS, 4)
    bns = {}
    for network, kw, side in smoke.CLASSIC_NETS:
        mod = smoke._classic_module(network, kw)(mx, mx.cpu())
        bns[network + str(kw)] = sum(smoke.net_bn_configs(
            mx, mod.symbol, (2, 3, side, side)).values())
        assert mod.symbol.infer_shape(data=(2, 3, side, side))[1] == \
            [(2, 1000)]
    assert bns == {"vgg{}": 0, "vgg{'batch_norm': True}": 13,
                   "googlenet{}": 0, "inception-bn{}": 69, "alexnet{}": 0,
                   "inception-resnet-v2{}": 244}
    rs = np.random.RandomState(0)
    for force in (True, False):
        keep = rs.rand(3, 40) < 0.6
        cid = rs.randint(-1, 3, (3, 40)).astype(np.float32)
        want = sum(1 for b in range(3) for i in range(40) for p in
                   range(i + 1, 40) if keep[b, i] and cid[b, i] >= 0
                   and cid[b, p] >= 0 and (force or cid[b, p] == cid[b, i]))
        assert smoke.nms_ops(keep, cid, force) == want * smoke.NMS_IOU_OPS


def test_rcnn_phase_helpers_run_on_the_cpu():
    """Phase 19's helpers without a card: its batches (the example's
    anchor labels, a tenth ignored; weights on the positive anchors and
    foreground ROIs), its constants against the graphs at 600x1000 (a
    37x62 conv5 map, 20,646 anchors, 2000 and 300 ROIs), its iterator
    (bound by the end-to-end graph at 64x64; through ``Module.fit`` of
    the RPN graph), the RPN step of the parity phase, the anchor metric, and K8/K8b's
    bound against a count of the bytes ROI pooling needs and a brute-force
    count of the bins' pixels."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import rcnn
    from mxnet_tpu_torch.ops import roi_pool_kernel as rk

    smoke = _script("chip_smoke")
    assert smoke.rcnn_feature_map() == (37, 62)
    for build, outs in (("rpn", [(1, 2, 20646), (1, 36, 37, 62)]),
                        ("train", [(1, 2, 20646), (1, 36, 37, 62),
                                   (2000, 21), (2000, 84)]),
                        ("test", [(300, 5), (300, 21), (300, 84)])):
        b = smoke.rcnn_batches(0, 1, build)[0]
        net = smoke.rcnn_module(mx, rcnn, build, mx.cpu()).symbol
        data, labels = smoke.rcnn_names(build)
        assert sorted(b) == sorted(data + labels)
        assert set(b) <= set(net.list_arguments())
        assert net.infer_shape(**{k: v.shape for k, v in b.items()})[1] \
            == outs
    small = (64, 64)
    b = smoke.rcnn_batches(3, 2, "train", image=small, classes=4)
    lab = b[0]["label"]
    assert lab.shape == (1, 9 * 16) and (lab == -1).any() and \
        (lab == 1).any() and (lab == 0).any()
    w = b[0]["bbox_weight"].reshape(1, 9, 4, 4, 4)
    assert ((w > 0) == (lab.reshape(1, 9, 1, 4, 4) > 0)).all()
    assert ((b[0]["roi_bbox_weight"] > 0).any(1)
            == (b[0]["roi_label"] > 0)).all()
    it = smoke.rcnn_iter(mx, b, "train")
    mod = mx.mod.Module(rcnn.get_symbol_train(num_classes=4),
                        data_names=("data", "im_info"),
                        label_names=smoke.RPN_LABELS + smoke.ROI_LABELS,
                        context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    assert [tuple(d.shape) for d in next(it).label] == [
        tuple(d.shape) for d in it.provide_label]
    assert len(list(it)) == 1
    rpn_batches = smoke.rcnn_batches(5, 2, "rpn", image=small)
    mod = mx.mod.Module(rcnn.get_symbol_rpn(), label_names=smoke.RPN_LABELS,
                        context=mx.cpu())
    metric = smoke.anchor_ce_metric(mx)
    mod.fit(smoke.rcnn_iter(mx, rpn_batches, "rpn"), eval_metric=metric,
            optimizer_params=dict(smoke.RCNN_OPT),
            initializer=mx.init.Xavier(), num_epoch=1)
    assert len(metric.ces) == 2 and np.isfinite(metric.ces).all()
    rpn = smoke.rcnn_batches(4, 1, "rpn", image=small)[0]
    upd, aux, _ = smoke.rcnn_step_updates(
        mx, lambda mx, ctx=None: smoke.rcnn_module(mx, rcnn, "rpn", ctx),
        mx.cpu(), rpn.pop("data"), rpn, 0)
    assert aux == {} and all(np.isfinite(v).all() for v in upd.values())
    assert np.abs(upd["rpn_cls_score_weight"]).max() > 0
    # the metric: -log of each non-ignored anchor's label probability
    p = np.array([[[0.2, 0.6, 0.5], [0.8, 0.4, 0.5]]], np.float32)
    metric = smoke.anchor_ce_metric(mx)
    metric.update([mx.nd.array([[1.0, 0.0, -1.0]])], [mx.nd.array(p)])
    np.testing.assert_allclose(metric.ces[0],
                               -(np.log(0.8) + np.log(0.6)) / 2, rtol=1e-6)
    # the bound's pixel count
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.rand(1, 3, 9, 13).astype(np.float32))
    rois = torch.tensor([[0, 0, 0, 200, 140], [0, 30, 20, 90, 100],
                         [0, 500, 500, 600, 600]], dtype=torch.float32)
    bnd = rk.roi_bounds(rois, 1, 9, 13, smoke.ROI_POOLED, smoke.ROI_SCALE)
    pixels = sum(max(0, int(bnd[2][r, i] - bnd[1][r, i]))
                 * max(0, int(bnd[4][r, j] - bnd[3][r, j]))
                 for r in range(3) for i in range(7) for j in range(7)) * 3
    # K8b's reads of the gradient: each bin once for each tile (band of
    # rows by run of columns) it meets, when its ROI meets the tile
    plan = dict(rk.roi_bwd_plan(9, 13), band=2, width=5)
    reads = 0
    for lo in range(0, 9, 2):
        hi = min(lo + 2, 9)
        for wlo in range(0, 13, 5):
            whi = min(wlo + 5, 13)
            for r in range(3):
                if not (bnd[1][r, 0] < hi and bnd[2][r, -1] > lo
                        and bnd[3][r, 0] < whi and bnd[4][r, -1] > wlo):
                    continue
                reads += sum(int(bnd[1][r, i] < hi and bnd[2][r, i] > lo
                                 and bnd[3][r, j] < whi
                                 and bnd[4][r, j] > wlo)
                             for i in range(7) for j in range(7))
    assert 0 < smoke.roi_g_reads(rk, x, rois, plan) == reads
    for bwd, ops in ((False, 1), (True, 2)):
        ms, by = smoke.roi_bound_ms(rk, x, rois, bwd)
        # the map (and its gradient), the ROIs, the maxima (or their
        # gradient); K8 also writes and reads the channels-last map, K8b
        # reads the gradient once a tile its bin meets
        nbytes = x.numel() * 4 * (2 if bwd else 1) + 3 * 20 + 3 * 3 * 49 * 4
        assert smoke.roi_bytes(x, rois, bwd) == nbytes
        design = nbytes - 3 * 3 * 49 * 4 + reads * 3 * 4 if bwd \
            else nbytes + 2 * x.numel() * 4
        assert smoke.roi_bytes(x, rois, bwd, design=reads if bwd
                               else True) == design
        assert ms == max(nbytes / smoke.PEAK_BYTES,
                         pixels * ops / smoke.PEAK_F32_FLOPS) * 1e3
        assert by == ("bytes" if nbytes / smoke.PEAK_BYTES
                      >= pixels * ops / smoke.PEAK_F32_FLOPS
                      else "operations")


def test_k8_costs_script_plans_and_refuses_to_run_without_a_card():
    """``chip_k8_costs.py``'s variants are edits that each match the
    committed ``csrc/roi_pooling.cu`` once, and its K8b variants change
    K8b's tiling constants to other values; its ROI cover count matches a
    count by hand; without a card it prints no result and exits
    non-zero."""
    import subprocess
    import sys

    from mxnet_tpu_torch.ops import roi_pool_kernel as rk

    costs = _script("chip_k8_costs")
    smoke = _script("chip_smoke")
    sources = dict(costs.variant_sources())
    assert set(sources) == set(costs.VARIANTS) | set(costs.ABLATIONS)
    for name, edits in costs.VARIANTS.items():
        for old, new in edits:
            assert old != new and new in sources[name]
        if name.startswith("K8b "):
            assert all(old.startswith(("constexpr int ",
                                       "__launch_bounds__("))
                       for old, _new in edits)
    x = torch.zeros((1, 3, 9, 13))
    rois = torch.tensor([[0, 0, 0, 200, 140], [0, 30, 20, 90, 100],
                         [0, 500, 500, 600, 600]], dtype=torch.float32)
    # 9x13 and 6x5 pixels (rows 1-6, columns 2-6); the third ROI lies
    # past the map
    assert costs.coverage(rk, smoke, x, rois) == (9 * 13 + 6 * 5) / (9 * 13)
    res = subprocess.run([sys.executable, os.path.join(
        _ROOT, "chip_k8_costs.py")], capture_output=True, text=True,
        timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and "device:" not in res.stdout


def test_plain_refused_passes_cpu_calls_and_restores():
    """The plain versions keep working on CPU tensors inside the block
    (keyword arguments too) and are restored after it, also when the
    block raises."""
    from types import SimpleNamespace as NS

    smoke = _script("chip_smoke")

    def plain(x, y=1):
        return x + y

    mod = NS(plain=plain)
    with smoke.plain_refused((mod, "plain")):
        assert mod.plain is not plain
        assert torch.equal(mod.plain(torch.ones(2), y=2), torch.full((2,), 3.0))
    assert mod.plain is plain
    with pytest.raises(KeyError):
        with smoke.plain_refused((mod, "plain")):
            raise KeyError("x")
    assert mod.plain is plain
