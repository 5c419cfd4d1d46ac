"""The sync-free ``Module.fit`` of the PyTorch port against the JAX package.

Device metrics (``DeviceMetric``, ``as_device``, ``device_capable``), the
``Speedometer`` cadence, the fused step (``MXNET_FUSE_TRAIN_STEP=1``),
``run_bulk`` and the bulk ``fit`` (``MXNET_BULK_TRAIN_STEPS``), and the
prefetching iterators (``PrefetchingIter``, ``DevicePrefetchIter``,
``fit(prefetch_to_device=)``), each held against its JAX counterpart on
the CPU.  The model is the small ResNet of ``test_torch_module.py``
(2 stages, bottleneck units, widths 8-16-32, 40x40 images, 4 classes),
its weights the JAX package's initialization carried across through
``mxnet_tpu_torch.convert``.

Tolerances: within the port, the fused step and ``run_bulk`` equal the
two-phase step bit for bit (the same ops in the same order; lr and wd
read from a tensor hold the same float32 factors); against the JAX
package ``rtol=1e-4, atol=1e-5`` after three SGD steps (f32 sums in
another order through convolutions and BatchNorm).  Device metrics:
counts exact, cross-entropy ``rtol=1e-5`` (float32 sums in another
order).
"""

import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu_torch.models import resnet as tresnet

from torch_deadline import deadline  # noqa: F401 (autouse)

BATCH, CLASSES, IMAGE = 4, 4, (3, 40, 40)
RESNET = dict(units=[1, 1], num_stages=2, filter_list=[8, 16, 32],
              num_classes=CLASSES, image_shape=IMAGE, bottle_neck=True)
SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
_ENV = ("MXNET_FUSE_TRAIN_STEP", "MXNET_BULK_TRAIN_STEPS",
        "MXNET_DEVICE_METRIC", "MXNET_DEVICE_PREFETCH")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)


def _data(n, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.uniform(0, 255, (n,) + IMAGE).astype(np.float32)
    y = rs.randint(0, CLASSES, n).astype(np.float32)
    return x, y


def _batches(mx, n, seed):
    x, y = _data(n * BATCH, seed)
    return [mx.io.DataBatch(data=[mx.nd.array(x[i:i + BATCH])],
                            label=[mx.nd.array(y[i:i + BATCH])])
            for i in range(0, n * BATCH, BATCH)]


@pytest.fixture(scope="module")
def init_params():
    """The JAX package's Xavier initialization of the small ResNet, with
    BatchNorm affine terms that are not 1 and 0, as numpy."""
    mod = jmx.mod.Module(jresnet.resnet(**RESNET), context=jmx.cpu())
    mod.bind(data_shapes=[("data", (BATCH,) + IMAGE)],
             label_shapes=[("softmax_label", (BATCH,))])
    np.random.seed(7)
    mod.init_params(jmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    arg, aux = mod.get_params()
    rs = np.random.RandomState(8)
    arg = {k: v.asnumpy() for k, v in arg.items()}
    for k in arg:
        if k.endswith("_gamma"):
            arg[k] = rs.uniform(0.5, 1.5, arg[k].shape).astype(np.float32)
        elif k.endswith("_beta"):
            arg[k] = rs.normal(0, 0.2, arg[k].shape).astype(np.float32)
    return arg, {k: v.asnumpy() for k, v in aux.items()}


def _module(mx, params, sched=None, lr=None):
    """A bound small-ResNet Module with ``params``, SGD initialized."""
    build = tresnet.resnet if mx is tmx else jresnet.resnet
    mod = mx.mod.Module(build(**RESNET), context=mx.cpu())
    mod.bind(data_shapes=[("data", (BATCH,) + IMAGE)],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params()
    arg, aux = params
    if mx is tmx:
        tmx.convert.set_module_params(mod, arg, aux)
    else:
        mod.set_params({k: jmx.nd.array(v) for k, v in arg.items()},
                       {k: jmx.nd.array(v) for k, v in aux.items()})
    opt = dict(SGD)
    if lr is not None:
        opt["learning_rate"] = lr
    if sched is not None:
        opt["lr_scheduler"] = sched
    mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    return mod


def _state(mod):
    arg, aux = mod.get_params()
    out = {k: v.asnumpy() for k, v in arg.items()}
    out.update({"aux:" + k: v.asnumpy() for k, v in aux.items()})
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def _spy_fused(mod):
    """Counts the module's fused steps (``Executor.train_sgd`` calls)."""
    calls = []
    real = mod._exec.train_sgd
    mod._exec.train_sgd = lambda *a: (calls.append(1), real(*a))
    return calls


# -- device metrics -----------------------------------------------------------
def _metric_inputs(kind):
    rs = np.random.RandomState(3)
    labels = [rs.randint(0, 10, 32).astype(np.float32) for _ in range(3)]
    if kind == "ce":
        preds = [rs.dirichlet(np.ones(10), 32).astype(np.float32)
                 for _ in range(3)]
    else:
        # scores in {0, .., 3}: most rows hold ties at the top
        preds = [rs.randint(0, 4, (32, 10)).astype(np.float32)
                 for _ in range(3)]
    return labels, preds


@pytest.mark.parametrize("kind", ["acc", "top5", "ce", "composite"])
def test_device_metric_matches_jax_device_metric(kind):
    make = {"acc": lambda mx: mx.metric.Accuracy(),
            "top5": lambda mx: mx.metric.TopKAccuracy(top_k=5),
            "ce": lambda mx: mx.metric.CrossEntropy(),
            "composite": lambda mx: mx.metric.create(
                ["acc", mx.metric.TopKAccuracy(top_k=3)])}[kind]
    labels, preds = _metric_inputs(kind)
    jm = jmx.metric.DeviceMetric(make(jmx))
    tm = tmx.metric.DeviceMetric(make(tmx))
    for lab, p in zip(labels, preds):
        jm.update([jmx.nd.array(lab)], [jmx.nd.array(p)])
        tm.update([tmx.nd.array(lab)], [tmx.nd.array(p)])
    assert tm.sync_count == 0  # updates never read the accumulator
    jleaves = jmx.metric._leaves_of(jm.base)
    (jn, jv), (tn, tv) = jm.get(), tm.get()
    assert tn == jn and tm.sync_count == 1
    tleaves = tmx.metric._leaves_of(tm.base)
    for j, t in zip(jleaves, tleaves):
        assert t.num_inst == j.num_inst == 96
        if kind == "ce":
            np.testing.assert_allclose(t.sum_metric, j.sum_metric,
                                       rtol=1e-5)
        else:
            assert t.sum_metric == j.sum_metric
    np.testing.assert_allclose(tv, jv, rtol=1e-5)


def test_device_metric_reads_sync_and_fold_into_the_wrapped_metric():
    base = tmx.metric.Accuracy()
    m = tmx.metric.as_device(base)
    assert tmx.metric.as_device(base) is m  # cached on the metric
    assert m.num_inst == 0 and m.sum_metric == 0.0
    m.update([tmx.nd.array(np.array([0, 1, 1], np.float32))],
             [tmx.nd.array(np.eye(3, dtype=np.float32))])
    assert m.num_inst == 3 and base.sum_metric == 2.0
    m.reset()
    assert base.num_inst == 0 and m.get()[1] != m.get()[1]  # nan


def test_device_capable_refusals_match_jax():
    """A subclass that overrides ``update``, a metric of its own and
    ``Perplexity`` stay on the host, in both packages."""
    verdicts = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        class MaskedAccuracy(mx.metric.Accuracy):
            def update(self, labels, preds):
                pass

        class Own(mx.metric.EvalMetric):
            def __init__(self):
                super().__init__("own")

            def update(self, labels, preds):
                self.sum_metric += 1.0
                self.num_inst += 1

        cases = [MaskedAccuracy(), Own(), mx.metric.Perplexity(0),
                 mx.metric.create(["acc", Own()]), mx.metric.Accuracy(),
                 mx.metric.create(["acc", "ce"])]
        verdicts[name] = [mx.metric.device_capable(m) for m in cases]
        for m, ok in zip(cases, verdicts[name]):
            assert isinstance(mx.metric.as_device(m),
                              mx.metric.DeviceMetric) == ok
    assert verdicts["torch"] == verdicts["jax"] == [False] * 4 + [True] * 2


def _fit_seen(params, metric="acc", callbacks=(), batches=3, **kw):
    """A one-epoch fit of ``batches`` batches; the metric each batch-end
    callback saw."""
    x, y = _data(batches * BATCH, 1)
    it = tmx.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = tmx.mod.Module(tresnet.resnet(**RESNET), context=tmx.cpu())
    seen = []
    mod.fit(it, num_epoch=1, eval_metric=metric, optimizer_params=SGD,
            arg_params={k: tmx.nd.array(v) for k, v in params[0].items()},
            aux_params={k: tmx.nd.array(v) for k, v in params[1].items()},
            batch_end_callback=[lambda p: seen.append(p.eval_metric)]
            + list(callbacks), **kw)
    return seen, mod, it


@pytest.mark.parametrize("env,wrapped", [(None, True), ("1", True),
                                         ("0", False)])
def test_fit_wraps_the_metric_unless_the_switch_is_off(init_params,
                                                       monkeypatch, env,
                                                       wrapped):
    if env is not None:
        monkeypatch.setenv("MXNET_DEVICE_METRIC", env)
    seen, _mod, _it = _fit_seen(init_params)
    assert len(seen) == 3
    assert all(isinstance(m, tmx.metric.DeviceMetric) == wrapped
               for m in seen)


def test_fit_keeps_a_metric_without_device_path_on_the_host(init_params):
    seen, _mod, _it = _fit_seen(init_params, tmx.metric.Perplexity(None))
    assert seen and not any(isinstance(m, tmx.metric.DeviceMetric)
                            for m in seen)
    assert np.isfinite(seen[-1].get()[1])


def test_speedometer_reads_the_device_metric_only_at_its_cadence(
        init_params):
    """Four batches, ``frequent=2``: one log at batch 2 and the epoch-end
    read, so two syncs, none per batch."""
    speed = tmx.callback.Speedometer(BATCH, frequent=2)
    seen, _mod, _it = _fit_seen(init_params, callbacks=[speed], batches=4)
    assert isinstance(seen[-1], tmx.metric.DeviceMetric)
    assert seen[-1].sync_count == 2 and len(speed.speeds) == 1


def test_device_metric_fit_equals_the_host_metric(init_params, monkeypatch):
    metric = lambda: tmx.metric.create(  # noqa: E731
        ["acc", tmx.metric.TopKAccuracy(top_k=2), "ce"])
    dev = _fit_seen(init_params, metric())[0][-1]
    monkeypatch.setenv("MXNET_DEVICE_METRIC", "0")
    host = _fit_seen(init_params, metric())[0][-1]
    (dn, dv), (hn, hv) = dev.get(), host.get()
    assert dn == hn and dv[:2] == hv[:2]
    np.testing.assert_allclose(dv[2], hv[2], rtol=1e-5)


# -- the fused step -----------------------------------------------------------
def _steps(mx, params, batches, fused, monkeypatch, observe=False):
    monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "1" if fused else "0")
    mod = _module(mx, params)
    calls = _spy_fused(mod) if mx is tmx else []
    outs = []
    for b in batches:
        mod.forward_backward(b)
        if observe:
            outs.append(mod.get_outputs()[0].asnumpy())
        mod.update()
        if not observe:
            outs.append(mod.get_outputs()[0].asnumpy())
    return _state(mod), outs, len(calls)


def test_fused_step_equals_two_phase_and_jax(init_params, monkeypatch):
    batches = _batches(tmx, 3, 2)
    fused, f_out, n_fused = _steps(tmx, init_params, batches, True,
                                   monkeypatch)
    plain, p_out, n_plain = _steps(tmx, init_params, batches, False,
                                   monkeypatch)
    assert (n_fused, n_plain) == (3, 0)
    _assert_same(fused, plain)
    for a, b in zip(f_out, p_out):
        np.testing.assert_array_equal(a, b)
    jax_fused, j_out, _ = _steps(jmx, init_params, _batches(jmx, 3, 2),
                                 True, monkeypatch)
    _assert_close(fused, jax_fused)
    for a, b in zip(f_out, j_out):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("momentum,clip", [(0.9, None), (0.0, 0.5),
                                            (0.9, 0.5)])
def test_sgd_step_with_tensor_lr_wd_equals_the_float_step(momentum, clip):
    """The port's SGD step (lr and wd read from a tensor, in groups)
    against the JAX package's ``sgd_step_math`` (lr and wd as floats,
    one tensor at a time)."""
    import jax.numpy as jnp

    from mxnet_tpu.executor import sgd_step_math as jax_step

    rs = np.random.RandomState(0)
    shapes = [(3, 4), (5,), (7, 2), (9,)]
    draw = lambda: [rs.normal(0, 1, s).astype(np.float32)  # noqa: E731
                    for s in shapes]
    p, g, m = draw(), draw(), draw()
    lrs, wds = [0.1, 0.1, 0.2, 0.1], [1e-4, 0.0, 1e-4, 1e-4]
    tp, tm = [torch.from_numpy(a.copy()) for a in p], \
        [torch.from_numpy(a.copy()) for a in m]
    groups, values = tmx.optimizer.lr_wd_groups(lrs, wds)
    assert groups == ((0, 3), (1,), (2,))
    assert values == [[0.1, 0.1, 0.2], [1e-4, 0.0, 1e-4]]
    tmx.optimizer.sgd_step_math(
        tp, [torch.from_numpy(a) for a in g], tm if momentum else [],
        groups, tmx.optimizer.hyper_tensor(values, "cpu"), momentum,
        1 / 128, clip)
    for i in range(len(shapes)):
        jp, jm = jax_step(jnp.asarray(p[i]), jnp.asarray(g[i]),
                          jnp.asarray(m[i]), lrs[i], wds[i], momentum,
                          1 / 128, clip or 0.0)
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)
        if momentum:
            np.testing.assert_allclose(tm[i].numpy(), np.asarray(jm),
                                       rtol=1e-6, atol=1e-7)


def test_launches_recorded_in_a_capture_count_at_each_replay(monkeypatch):
    """A launch on a capturing stream, from the capturing thread or
    another (autograd's worker), is recorded and counts at each replay;
    one on a stream that is not capturing counts at once."""
    from mxnet_tpu_torch.ops import launches

    def wrapper():
        pass

    wrapper.launches = 0
    capturing = threading.local()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(capturing, "on", False))

    def launch(capture):
        capturing.on = capture
        launches.count(wrapper)

    launch(False)
    with launches.recording() as rec:
        launch(True)
        worker = threading.Thread(target=launch, args=(True,))
        worker.start()
        worker.join()
        side = threading.Thread(target=launch, args=(False,))
        side.start()
        side.join()
    assert wrapper.launches == 2 and rec == {wrapper: 2}
    launch(True)  # no recording open: counted
    launches.replayed(rec)
    launches.replayed(rec)
    assert wrapper.launches == 7


def test_fused_step_takes_each_parameters_lr_and_wd(init_params,
                                                    monkeypatch):
    """lr and wd multipliers split the parameters into groups of the
    fused update; it still equals the two-phase step and JAX's."""
    def run(mx, fused):
        monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "1" if fused else "0")
        mod = _module(mx, init_params)
        mod._optimizer.set_lr_mult({"fc1_weight": 0.5, "conv0_weight": 2.0})
        mod._optimizer.set_wd_mult({"fc1_bias": 3.0})
        for b in _batches(mx, 2, 8):
            mod.forward_backward(b)
            mod.update()
        return _state(mod)

    fused = run(tmx, True)
    _assert_same(fused, run(tmx, False))
    _assert_close(fused, run(jmx, True))


def test_reading_before_update_takes_the_two_phase_step(init_params,
                                                        monkeypatch):
    batches = _batches(tmx, 2, 3)
    seen, s_out, n_fused = _steps(tmx, init_params, batches, True,
                                  monkeypatch, observe=True)
    plain, p_out, _ = _steps(tmx, init_params, batches, False, monkeypatch,
                             observe=True)
    assert n_fused == 0
    _assert_same(seen, plain)
    for a, b in zip(s_out, p_out):
        np.testing.assert_array_equal(a, b)


def test_fused_step_eligibility_matches_jax(init_params, monkeypatch):
    """Eligible: plain SGD, every gradient ``write``, no input gradients,
    the switch on."""
    verdicts = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "1")
        mods = [_module(mx, init_params) for _ in range(4)]

        class MySGD(mx.optimizer.SGD):
            pass

        mods[1].init_optimizer(optimizer=MySGD(rescale_grad=1 / BATCH),
                               force_init=True)
        for i, kw in ((2, {"grad_req": "add"}),
                      (3, {"inputs_need_grad": True})):
            mods[i].bind(data_shapes=[("data", (BATCH,) + IMAGE)],
                         label_shapes=[("softmax_label", (BATCH,))],
                         force_rebind=True, **kw)
            mods[i].init_optimizer(optimizer="sgd", force_init=True)
        verdicts[name] = [m._full_step_eligible() for m in mods]
        monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "0")
        verdicts[name].append(mods[0]._full_step_eligible())
    assert verdicts["torch"] == verdicts["jax"] == [True] + [False] * 4


# -- run_bulk -----------------------------------------------------------------
def _chunk_sched(mx):
    return mx.lr_scheduler.MultiFactorScheduler(step=[1], factor=0.1)


@pytest.fixture(scope="module")
def bulk_references(init_params):
    """The references of the ``run_bulk`` tests, made once: the port's
    sequential fused steps at lr 0.005 (state, outputs) and with the
    scheduler (state), and JAX's ``run_bulk`` (state, output stacks)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_FUSE_TRAIN_STEP", "1")
        seq = _module(tmx, init_params, lr=0.005)
        sched_seq = _module(tmx, init_params, _chunk_sched(tmx))
        seq_outs = []
        for b in _batches(tmx, 3, 4):
            for mod in (seq, sched_seq):
                mod.forward_backward(b)
                mod.update()
            seq_outs.append(seq.get_outputs()[0].asnumpy())
        jbulk = _module(jmx, init_params, _chunk_sched(jmx))
        jouts = jbulk.run_bulk(_batches(jmx, 3, 4), return_outputs=True)
        return dict(seq=_state(seq), seq_outs=seq_outs,
                    sched_seq=_state(sched_seq), jax=_state(jbulk),
                    jax_outs=jouts)


@pytest.mark.parametrize("mode", [False, True, "device"])
def test_run_bulk_matches_sequential_steps_and_jax(init_params, monkeypatch,
                                                   bulk_references, mode):
    """Three steps in one chunk under ``MultiFactorScheduler(step=[1])``:
    the counts reach 3 before the lr is read, so all three steps take
    the decayed lr (0.005), also the first; sequential steps at a fixed
    lr of 0.005 are the same steps, bit for bit."""
    monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "1")
    ref = bulk_references
    bulk = _module(tmx, init_params, _chunk_sched(tmx))
    calls = _spy_fused(bulk)
    outs = bulk.run_bulk(_batches(tmx, 3, 4), return_outputs=mode)
    assert len(calls) == 3 and bulk._optimizer.num_update == 3
    _assert_same(_state(bulk), ref["seq"])
    assert not np.array_equal(ref["sched_seq"]["fc1_weight"],
                              _state(bulk)["fc1_weight"])
    _assert_close(_state(bulk), ref["jax"])
    seq_outs, jouts = ref["seq_outs"], ref["jax_outs"]
    if not mode:
        assert outs is None
        return
    if mode == "device":
        assert isinstance(outs[0], tmx.nd.NDArray)
        assert outs[0].context == tmx.cpu()
        outs = [o.asnumpy() for o in outs]
    assert isinstance(outs[0], np.ndarray)
    assert outs[0].shape == (3, BATCH, CLASSES)
    np.testing.assert_array_equal(outs[0], np.stack(seq_outs))
    np.testing.assert_allclose(outs[0], jouts[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(bulk.get_outputs()[0].asnumpy(),
                                  seq_outs[-1])


def test_outputs_and_gradients_after_bulk_without_outputs_raise(
        init_params, monkeypatch):
    monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "1")
    mod = _module(tmx, init_params)
    batches = _batches(tmx, 2, 5)
    assert mod.run_bulk(batches) is None
    with pytest.raises(tmx.MXNetError, match="not kept"):
        mod.get_outputs()
    with pytest.raises(tmx.MXNetError, match="not kept"):
        mod._exec.grad_dict
    mod.forward_backward(batches[0])  # the next step brings them back
    mod.update()
    assert mod.get_outputs()[0].shape == (BATCH, CLASSES)
    assert mod._exec.grad_dict["fc1_weight"].shape == (CLASSES, 32)


def test_run_bulk_without_the_fused_step_runs_per_batch(init_params):
    mod = _module(tmx, init_params)
    calls = _spy_fused(mod)
    outs = mod.run_bulk(_batches(tmx, 2, 6), return_outputs=True)
    assert not calls and outs[0].shape == (2, BATCH, CLASSES)
    assert mod._optimizer.num_update == 2


@pytest.fixture(scope="module")
def bulk_fits(init_params):
    """``get(mx, bulk, prefetch)``: final state and per-batch accuracies
    of a two-epoch fit from ``init_params`` under
    ``MXNET_FUSE_TRAIN_STEP=1`` (``MXNET_BULK_TRAIN_STEPS=bulk``), made
    once per setting."""
    made = {}

    def get(mx, bulk, prefetch=False):
        key = (mx.__name__, bulk, prefetch)
        if key not in made:
            with pytest.MonkeyPatch.context() as mp:
                made[key] = _bulk_fit(mx, init_params, bulk, mp, prefetch)
        return made[key]

    return get


def _bulk_fit(mx, params, bulk, monkeypatch, prefetch):
    monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "1")
    if bulk:
        monkeypatch.setenv("MXNET_BULK_TRAIN_STEPS", str(bulk))
    else:
        monkeypatch.delenv("MXNET_BULK_TRAIN_STEPS", raising=False)
    x, y = _data(5 * BATCH, 7)
    it = mx.io.NDArrayIter(x, y, batch_size=BATCH)
    build = tresnet.resnet if mx is tmx else jresnet.resnet
    mod = mx.mod.Module(build(**RESNET), context=mx.cpu())
    accs = []
    kw = {"prefetch_to_device": True} if prefetch else {}
    mod.fit(it, num_epoch=2, eval_metric="acc", optimizer_params=SGD,
            arg_params={k: mx.nd.array(v) for k, v in params[0].items()},
            aux_params={k: mx.nd.array(v) for k, v in params[1].items()},
            batch_end_callback=lambda p: accs.append(
                (p.nbatch, p.eval_metric.get()[1])), **kw)
    return _state(mod), accs


def test_bulk_fit_equals_classic_fit_and_jax(bulk_fits):
    """Two epochs of five batches in chunks of 2, 2 and 1, with the
    metric read at every batch end."""
    bulk, b_acc = bulk_fits(tmx, 2)
    classic, c_acc = bulk_fits(tmx, None)
    _assert_same(bulk, classic)
    assert b_acc == c_acc and [n for n, _ in b_acc] == list(range(5)) * 2
    jbulk, j_acc = bulk_fits(jmx, 2)
    _assert_close(bulk, jbulk)
    np.testing.assert_allclose([a for _, a in b_acc],
                               [a for _, a in j_acc], rtol=1e-6)


@pytest.mark.parametrize("bulk", [None, 2])
def test_batch_end_callbacks_see_their_batch(init_params, monkeypatch,
                                             bulk):
    """``BatchEndParam.locals["data_batch"]`` is the batch just trained,
    batch by batch also in chunks."""
    monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "1")
    if bulk:
        monkeypatch.setenv("MXNET_BULK_TRAIN_STEPS", str(bulk))
    x, _y = _data(3 * BATCH, 1)
    seen = []
    _fit_seen(init_params, callbacks=[lambda p: seen.append(
        (p.nbatch, p.locals["data_batch"].data[0].asnumpy()))])
    assert [n for n, _ in seen] == [0, 1, 2]
    for n, d in seen:
        np.testing.assert_array_equal(d, x[n * BATCH:(n + 1) * BATCH])


def test_bulk_fit_warns_when_the_step_is_not_fused(init_params, monkeypatch,
                                                   caplog):
    monkeypatch.setenv("MXNET_BULK_TRAIN_STEPS", "2")
    with caplog.at_level("WARNING"):
        _fit_seen(init_params)
    assert "has no effect" in caplog.text


# -- prefetch -----------------------------------------------------------------
def test_prefetch_to_device_changes_no_number_and_leaves_data_reset(
        init_params, bulk_fits):
    pre, p_acc = bulk_fits(tmx, 2, prefetch=True)
    plain, c_acc = bulk_fits(tmx, 2)
    _assert_same(pre, plain)
    assert p_acc == c_acc
    seen, _mod, it = _fit_seen(init_params, prefetch_to_device=True)
    assert len(seen) == 3
    assert len(list(it)) == 3  # the whole epoch, from its first batch


def test_prefetch_env_default(init_params, monkeypatch):
    made = []

    class Spy(tmx.io.DevicePrefetchIter):
        def __init__(self, *args, **kw):
            made.append(self)
            super().__init__(*args, **kw)

    monkeypatch.setattr(tmx.io, "DevicePrefetchIter", Spy)
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "1")
    _fit_seen(init_params)
    assert len(made) == 1
    assert not any(t.is_alive() for t in made[0].prefetch_threads)
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "0")
    _fit_seen(init_params)
    assert len(made) == 1


def _xy(n=16):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    return x, np.arange(n, dtype=np.float32)


@pytest.mark.parametrize("device", [False, True])
def test_prefetching_iters_yield_the_jax_batches(device):
    x, y = _xy()
    jit = jmx.io.PrefetchingIter(jmx.io.NDArrayIter(x, y, batch_size=4))
    inner = tmx.io.NDArrayIter(x, y, batch_size=4)
    tit = tmx.io.DevicePrefetchIter(inner, tmx.cpu()) if device \
        else tmx.io.PrefetchingIter(inner)
    with tit:
        for _epoch in range(2):
            want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in jit]
            got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                   for b in tit]
            assert len(got) == len(want) == 4
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[0], w[0])
                np.testing.assert_array_equal(g[1], w[1])
                assert g[2] == w[2]
            jit.reset()
            tit.reset()
        assert [d.name for d in tit.provide_data] == ["data"]
    jit.close()
    assert not any(t.is_alive() for t in tit.prefetch_threads)


def test_prefetching_iter_under_thread_switching_keeps_every_batch():
    """Twelve producers (more than this machine's cores) with the
    interpreter switching threads every microsecond: two epochs, every
    sub-batch whole and in order."""
    import sys

    x = np.arange(40 * 3, dtype=np.float32).reshape(40, 3)
    inners = [tmx.io.NDArrayIter(x + 1000 * j, None, batch_size=4,
                                 data_name="d%d" % j) for j in range(12)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tmx.io.PrefetchingIter(inners) as it:
            for _epoch in range(2):
                n = 0
                for b in it:
                    for j, d in enumerate(b.data):
                        np.testing.assert_array_equal(
                            d.asnumpy(), x[4 * n:4 * n + 4] + 1000 * j)
                    n += 1
                assert n == 10
                it.reset()
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in it.prefetch_threads)


class _Boom(tmx.io.DataIter):
    """Three two-row batches; the ``fail_at``-th ``next`` raises, after
    ``gate`` is set when there is one."""

    def __init__(self, fail_at=2, gate=None):
        super().__init__(batch_size=2)
        self.n = 0
        self.fail_at = fail_at
        self.gate = gate

    @property
    def provide_data(self):
        return [tmx.io.DataDesc("data", (2, 2))]

    @property
    def provide_label(self):
        return []

    def reset(self):
        self.n = 0

    def next(self):
        self.n += 1
        if self.n == self.fail_at:
            if self.gate is not None:
                self.gate.wait()
            raise RuntimeError("producer exploded")
        if self.n > 3:
            raise StopIteration
        return tmx.io.DataBatch(data=[tmx.nd.zeros((2, 2), tmx.cpu())])


def test_prefetching_iter_raises_producer_errors_and_resets_clean():
    with tmx.io.PrefetchingIter(_Boom()) as it:
        next(it)
        with pytest.raises(RuntimeError, match="producer exploded"):
            it.next()
        assert len(list(it)) == 1  # the producer went on after the error
        it.reset()
        it.iters[0].fail_at = 0
        assert len(list(it)) == 3


def test_prefetching_iter_close_joins_its_threads():
    x, _y = _xy()
    it = tmx.io.PrefetchingIter([tmx.io.NDArrayIter(x, None, batch_size=4),
                                 tmx.io.NDArrayIter(x, None, batch_size=4)],
                                rename_data=[{"data": "a"}, {"data": "b"}])
    assert [d.name for d in it.provide_data] == ["a", "b"]
    assert all(t.is_alive() for t in it.prefetch_threads)
    assert len(next(it).data) == 2
    it.close()
    assert not any(t.is_alive() for t in it.prefetch_threads)
    it.close()  # idempotent


def test_prefetching_iter_close_while_a_batch_is_made_joins():
    """``close`` while a producer is inside its sub-iterator's ``next``:
    the producer sees the stop once that batch is done, and exits."""
    gate = threading.Event()
    it = tmx.io.PrefetchingIter(_Boom(fail_at=2, gate=gate))
    next(it)  # the producer now waits at the gate inside batch 2
    opener = threading.Timer(0.2, gate.set)
    opener.start()
    it.close()
    opener.join()
    assert not any(t.is_alive() for t in it.prefetch_threads)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_dead_producer_raises_instead_of_hanging():
    """A producer thread that dies without handing over a batch (here the
    slot its error goes to breaks) makes ``next`` raise; so does ``next``
    after ``close``."""
    class Broken(list):
        def __setitem__(self, i, v):
            raise SystemExit  # ends the producer thread

    gate = threading.Event()
    it = tmx.io.PrefetchingIter(_Boom(fail_at=2, gate=gate))
    next(it)  # the producer now waits at the gate inside batch 2
    it._errors = Broken([None])
    gate.set()
    done = []

    def consume():
        try:
            it.next()
        except tmx.MXNetError as e:
            done.append(str(e))

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=10)
    assert done and "died" in done[0]
    it.close()
    closed = tmx.io.PrefetchingIter(_Boom(fail_at=0))
    next(closed)
    closed.close()
    with pytest.raises(tmx.MXNetError, match="closed"):
        closed.next()
        closed.next()


def test_device_prefetch_iter_places_batches_with_the_placer():
    x, y = _xy()
    names = []

    def placer(name, t):
        names.append(name)
        return t.double()

    with tmx.io.DevicePrefetchIter(tmx.io.NDArrayIter(x, y, batch_size=4),
                                   device="cpu", placer=placer) as it:
        batches = list(it)
    assert len(batches) == 4 and set(names) == {"data", "softmax_label"}
    assert batches[0].data[0]._t.dtype == torch.float64
    np.testing.assert_array_equal(batches[1].data[0].asnumpy(), x[4:8])
    with pytest.raises(tmx.MXNetError, match="device"):
        tmx.io.DevicePrefetchIter(tmx.io.NDArrayIter(x, y, batch_size=4))


def test_module_device_put_batch_takes_the_bound_dtype(init_params):
    mod = _module(tmx, init_params)
    t = mod._device_put_batch("data", torch.zeros((BATCH,) + IMAGE,
                                                  dtype=torch.float64))
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert mod._device_put_batch("other", t) is t
