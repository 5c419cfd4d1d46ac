"""Checkpoint files of the PyTorch port against the JAX package's.

The two packages write the same files: a ``.params`` file of the same
arrays byte for byte, a ``prefix-symbol.json`` + ``prefix-%04d.params``
checkpoint each reads from the other, a manifest of the same keys for the
same fit, optimizer states the port reads from a JAX-written ``.states``
pickle (without importing the JAX package: a mapped unpickler), the same
iterator and metric states, and the same unpacked RNN checkpoints.  The
model is the small ResNet of ``test_torch_module.py`` (2 stages,
bottleneck units, widths 8-16-32, 40x40 images, 4 classes), its weights
the JAX package's initialization carried across through numpy.

Tolerances: files, arrays, manifests and states exact; forward outputs
``rtol=atol=1e-5``; an epoch of training ``rtol=1e-4, atol=1e-5`` (f32
sums in another order through convolutions and BatchNorm).
"""

import json
import os
import pickle

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu_torch.models import lstm_lm
from mxnet_tpu_torch.models import resnet as tresnet

BATCH, CLASSES, IMAGE = 4, 4, (3, 40, 40)
RESNET = dict(units=[1, 1], num_stages=2, filter_list=[8, 16, 32],
              num_classes=CLASSES, image_shape=IMAGE, bottle_neck=True)
SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
_ENV = ("MXNET_CKPT_EVERY_N_BATCHES", "MXNET_CKPT_KEEP_LAST",
        "MXNET_CKPT_ASYNC", "MXNET_FUSE_TRAIN_STEP",
        "MXNET_BULK_TRAIN_STEPS", "MXNET_DEVICE_PREFETCH")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)


def _data(n, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.uniform(0, 255, (n,) + IMAGE).astype(np.float32),
            rs.randint(0, CLASSES, n).astype(np.float32))


def _net(mx):
    return (tresnet if mx is tmx else jresnet).resnet(**RESNET)


@pytest.fixture(scope="module")
def init_params():
    """The JAX package's Xavier initialization of the small ResNet, with
    BatchNorm terms and moving statistics that are not 1 and 0."""
    mod = jmx.mod.Module(_net(jmx), context=jmx.cpu())
    mod.bind(data_shapes=[("data", (BATCH,) + IMAGE)],
             label_shapes=[("softmax_label", (BATCH,))])
    np.random.seed(7)
    mod.init_params(jmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    arg, aux = mod.get_params()
    rs = np.random.RandomState(8)
    arg = {k: v.asnumpy() for k, v in arg.items()}
    aux = {k: v.asnumpy() for k, v in aux.items()}
    for d in (arg, aux):
        for k in d:
            if k.endswith(("_gamma", "_moving_var")):
                d[k] = rs.uniform(0.5, 1.5, d[k].shape).astype(np.float32)
            elif k.endswith(("_beta", "_moving_mean")):
                d[k] = rs.normal(0, 0.2, d[k].shape).astype(np.float32)
    return arg, aux


def _forward(mx, sym, arg, aux, x):
    """Eval-mode outputs of ``sym`` bound with ``arg``/``aux`` on ``x``."""
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", (x.shape[0],))],
             for_training=False)
    mod.set_params({k: mx.nd.array(np.asarray(
        v.asnumpy() if hasattr(v, "asnumpy") else v)) for k, v in arg.items()},
        {k: mx.nd.array(np.asarray(
            v.asnumpy() if hasattr(v, "asnumpy") else v))
         for k, v in aux.items()})
    mod.forward(mx.io.DataBatch([mx.nd.array(x)], []), is_train=False)
    return [o.asnumpy() for o in mod.get_outputs()]


def test_params_files_are_byte_identical(tmp_path):
    rs = np.random.RandomState(1)
    arrays = {"arg:w": rs.randn(3, 4, 5).astype(np.float32),
              "arg:b": rs.randn(7).astype(np.float32),
              "aux:count": rs.randint(0, 9, (2, 2)).astype(np.int32),
              "arg:h": rs.randn(6).astype(np.float16),
              "aux:scalar": np.float32(2.5).reshape(())}
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jmx.nd.save(jpath, {k: jmx.nd.array(v, dtype=v.dtype)
                        for k, v in arrays.items()})
    tmx.nd.save(tpath, {k: tmx.nd.array(v, dtype=v.dtype)
                        for k, v in arrays.items()})
    assert open(jpath, "rb").read() == open(tpath, "rb").read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_the_others_checkpoint(tmp_path, init_params,
                                                  writer):
    arg, aux = init_params
    prefix = str(tmp_path / "ck")
    src, dst = (jmx, tmx) if writer == "jax" else (tmx, jmx)
    src.model.save_checkpoint(prefix, 3, _net(src),
                              {k: src.nd.array(v) for k, v in arg.items()},
                              {k: src.nd.array(v) for k, v in aux.items()})
    sym, larg, laux = dst.model.load_checkpoint(prefix, 3)
    assert sym.list_arguments() == _net(dst).list_arguments()
    for want, got in ((arg, larg), (aux, laux)):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].asnumpy(), want[k])
    x, _ = _data(BATCH, 2)
    want = _forward(src, _net(src), arg, aux, x)
    got = _forward(dst, sym, larg, laux, x)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _fit(mx, prefix, params, num_epoch=1, **kw):
    x, y = _data(4 * BATCH, 3)
    mod = mx.mod.Module(_net(mx), context=mx.cpu())
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=num_epoch,
            optimizer="sgd", optimizer_params=SGD,
            arg_params={k: mx.nd.array(v) for k, v in params[0].items()},
            aux_params={k: mx.nd.array(v) for k, v in params[1].items()},
            force_init=True, checkpoint_prefix=prefix, **kw)
    return mod


def test_fit_manifest_matches_jax(tmp_path, init_params, monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "0")
    jprefix, tprefix = str(tmp_path / "j" / "ck"), str(tmp_path / "t" / "ck")
    for prefix in (jprefix, tprefix):
        os.makedirs(os.path.dirname(prefix))
    _fit(jmx, jprefix, init_params, checkpoint_every_n_batches=2)
    _fit(tmx, tprefix, init_params, checkpoint_every_n_batches=2)
    jm = jmx.model.checkpoint_manifest(jprefix)
    tm = tmx.model.checkpoint_manifest(tprefix)
    assert sorted(tm) == sorted(jm)
    for key in ("format", "prefix", "epochs", "latest"):
        assert tm[key] == jm[key], key
    assert sorted(tm["payload_sha256"]) == sorted(jm["payload_sha256"])
    assert len(tm["snapshots"]) == len(jm["snapshots"]) == 2
    for t, j in zip(tm["snapshots"], jm["snapshots"]):
        assert sorted(t) == sorted(j)
        for key in ("epoch", "nbatch", "params", "states", "iter_state"):
            assert t[key] == j[key], key
        assert sorted(t["metric_state"]) == sorted(j["metric_state"])
        assert t["opt_counts"] == j["opt_counts"]
    base = os.path.dirname(tprefix)
    for epoch, sha in tm["payload_sha256"].items():
        assert tmx.model._sha256_file(
            "%s-%04d.params" % (tprefix, int(epoch))) == sha
    for snap in tm["snapshots"]:
        assert tmx.model._sha256_file(
            os.path.join(base, snap["params"])) == snap["sha256"]
        assert tmx.model._sha256_file(
            os.path.join(base, snap["states"])) == snap["states_sha256"]


def test_port_resumes_a_jax_checkpoint_with_momenta(tmp_path, init_params):
    """``Module.load(..., load_optimizer_states=True)`` of a checkpoint the
    JAX package's ``fit`` wrote: the momenta come through the mapped
    unpickler, and the next epoch follows the JAX package's own."""
    prefix = str(tmp_path / "ck")
    _fit(jmx, prefix, init_params)
    with open("%s-0001.states" % prefix, "rb") as f:
        blob = f.read()
    assert b"mxnet_tpu.ndarray" in blob
    jstates = pickle.loads(blob)
    mod = tmx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                              context=tmx.cpu())
    x, y = _data(4 * BATCH, 3)
    it = tmx.io.NDArrayIter(x, y, batch_size=BATCH)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params()
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    assert sorted(mod._updater.states) == sorted(jstates)
    for i, s in jstates.items():
        np.testing.assert_array_equal(mod._updater.states[i].asnumpy(),
                                      s.asnumpy())
    assert any(np.abs(s.asnumpy()).max() > 0 for s in jstates.values())

    def cont(mx):
        m = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                               context=mx.cpu())
        m.fit(mx.io.NDArrayIter(x, y, batch_size=BATCH), begin_epoch=1,
              num_epoch=2, optimizer="sgd", optimizer_params=SGD)
        arg, aux = m.get_params()
        out = {k: v.asnumpy() for k, v in arg.items()}
        out.update({"aux:" + k: v.asnumpy() for k, v in aux.items()})
        return out

    want, got = cont(jmx), cont(tmx)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_states_unpickler_refuses_other_classes():
    blob = pickle.dumps({0: os.getcwd, 1: None})
    with pytest.raises(tmx.MXNetError, match="not allowed"):
        tmx.optimizer.load_states(blob)
    nd = tmx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    back = tmx.optimizer.load_states(pickle.dumps({0: nd, 1: None}))
    assert back[1] is None
    np.testing.assert_array_equal(back[0].asnumpy(), nd.asnumpy())
    assert nd.__getstate__().keys() == \
        jmx.nd.array(np.ones(2)).__getstate__().keys()


def test_ndarrayiter_state_matches_jax():
    x, y = _data(10, 1)
    states = []
    for mx in (jmx, tmx):
        it = mx.io.NDArrayIter(x, y, batch_size=3, shuffle=False)
        it.next()
        it.next()
        states.append(it.state_dict())
    assert states[0] == states[1]


def _metric_case(kind):
    rs = np.random.RandomState(3)
    labels = [rs.randint(0, 10, 16).astype(np.float32) for _ in range(3)]
    preds = []
    for _ in range(3):
        p = rs.rand(16, 10).astype(np.float32)
        preds.append(p / p.sum(1, keepdims=True))

    def make(mx):
        return {"acc": lambda: mx.metric.Accuracy(),
                "top3": lambda: mx.metric.TopKAccuracy(top_k=3),
                "ce": lambda: mx.metric.CrossEntropy(),
                "composite": lambda: mx.metric.CompositeEvalMetric(
                    [mx.metric.Accuracy(), mx.metric.TopKAccuracy(top_k=3),
                     mx.metric.CrossEntropy()])}[kind]()

    return labels, preds, make


def _assert_state_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_state_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_state_equal(a, b)
    else:
        assert type(got) is type(want) or \
            {type(got), type(want)} <= {int, float}
        assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("kind", ["acc", "top3", "ce", "composite"])
def test_metric_states_match_jax(kind):
    labels, preds, make = _metric_case(kind)
    states = []
    for mx in (jmx, tmx):
        host = make(mx)
        for lab, pr in zip(labels, preds):
            host.update([mx.nd.array(lab)], [mx.nd.array(pr)])
        states.append(host.get_state())
        json.dumps(states[-1])
    _assert_state_equal(states[1], states[0])
    # the device path: one sync, the same state; set_state resumes it
    dm = tmx.metric.DeviceMetric(make(tmx))
    for lab, pr in zip(labels, preds):
        dm.update([tmx.nd.array(lab)], [tmx.nd.array(pr)])
    _assert_state_equal(dm.get_state(), states[0])
    assert dm.sync_count == 1
    again = tmx.metric.DeviceMetric(make(tmx))
    again.set_state(states[1])
    assert again.get_name_value() == host.get_name_value()


def test_rnn_checkpoint_matches_jax(tmp_path):
    """``do_rnn_checkpoint`` writes the fused LSTM's weights unpacked per
    gate, as the JAX package's ``save_rnn_checkpoint`` does for the same
    weights; ``load_rnn_checkpoint`` packs them back."""
    hidden, layers, vocab, embed = 16, 2, 50, 16
    tsym = lstm_lm.make_sym_gen(lstm_lm.build_cell(hidden, layers), vocab,
                                embed, hidden)(10)[0]
    shapes, _, _ = tsym.infer_shape(data=(10, 4), softmax_label=(10, 4))
    rs = np.random.RandomState(6)
    arg = {n: rs.randn(*s).astype(np.float32)
           for n, s in zip(tsym.list_arguments(), shapes)
           if n not in ("data", "softmax_label")}
    tcell = lstm_lm.build_cell(hidden, layers)
    jcell = jmx.rnn.FusedRNNCell(hidden, num_layers=layers, mode="lstm",
                                 prefix="lstm_")
    tprefix, jprefix = str(tmp_path / "t"), str(tmp_path / "j")
    tmx.rnn.do_rnn_checkpoint(tcell, tprefix)(
        0, tsym, {k: tmx.nd.array(v) for k, v in arg.items()}, {})
    jmx.rnn.save_rnn_checkpoint(jcell, jprefix, 1, None,
                                {k: jmx.nd.array(v) for k, v in arg.items()},
                                {})
    tsaved = tmx.nd.load("%s-0001.params" % tprefix)
    jsaved = tmx.nd.load("%s-0001.params" % jprefix)
    assert sorted(tsaved) == sorted(jsaved)
    assert "arg:lstm_l1_h2h_weight" in tsaved
    assert "arg:lstm_parameters" not in tsaved
    for k in jsaved:
        np.testing.assert_array_equal(tsaved[k].asnumpy(),
                                      jsaved[k].asnumpy(), err_msg=k)
    _sym, loaded, _aux = tmx.rnn.load_rnn_checkpoint(tcell, tprefix, 1)
    assert sorted(loaded) == sorted(arg)
    for k in arg:
        np.testing.assert_array_equal(loaded[k].asnumpy(), arg[k],
                                      err_msg=k)
