"""``SequentialModule``, ``PythonModule`` and ``PythonLossModule`` of the
PyTorch port against the JAX package: the chain of
``tests/test_module.py::test_python_loss_module_chain`` (a
FullyConnected feature module, then a Python loss head whose gradient is
a numpy callback, ``take_labels`` and ``auto_wiring``) trained by
``fit`` from the same weights in both packages; parameters, outputs and
the metric at ``rtol=1e-4, atol=1e-5`` (f32 sums in another order through
the epochs).  Then the chain's wiring: names, shapes, input gradients,
the metric of the label-taking stage only, and the refusals."""

import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

N, D, K, BATCH = 64, 8, 3, 16


def _data():
    rs = np.random.RandomState(0)
    w = rs.randn(D, K)
    x = rs.randn(N, D).astype(np.float32)
    y = np.argmax(x @ w + 0.1 * rs.randn(N, K), axis=1).astype(np.float32)
    return x, y


def _ce_grad(scores, labels):
    s = scores.asnumpy()
    lab = labels.asnumpy().astype(int)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    p[np.arange(len(lab)), lab] -= 1.0
    return p / len(lab)


def _chain(mx, hidden=None):
    data = mx.sym.Variable("data")
    if hidden:
        data = mx.sym.Activation(mx.sym.FullyConnected(
            data, num_hidden=hidden, name="fc0"), act_type="relu")
    feat = mx.sym.FullyConnected(data, num_hidden=K, name="fc")
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(feat, data_names=("data",), label_names=(),
                          context=mx.cpu()))
    seq.add(mx.mod.PythonLossModule(grad_func=_ce_grad),
            take_labels=True, auto_wiring=True)
    return seq


def _fit(mx, init, epochs=5):
    x, y = _data()
    it = mx.io.NDArrayIter(data=x, label=y, batch_size=BATCH, shuffle=False,
                           label_name="softmax_label")
    seq = _chain(mx, hidden=5)
    seq.bind(it.provide_data, it.provide_label)
    seq.init_params(arg_params={k: mx.nd.array(v) for k, v in init.items()})
    metric = mx.metric.Accuracy()
    seq.fit(it, eval_metric=metric, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 2.0})
    it.reset()
    seq.forward(next(iter(it)), is_train=False)
    out = seq.get_outputs()[0].asnumpy()
    arg, _ = seq.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}, out, metric.get()[1]


def test_python_loss_chain_fit_matches_jax():
    rs = np.random.RandomState(3)
    init = {"fc0_weight": rs.randn(5, D).astype(np.float32) * 0.3,
            "fc0_bias": np.zeros(5, np.float32),
            "fc_weight": rs.randn(K, 5).astype(np.float32) * 0.3,
            "fc_bias": np.zeros(K, np.float32)}
    t_arg, t_out, t_acc = _fit(tmx, init)
    j_arg, j_out, j_acc = _fit(jmx, init)
    assert sorted(t_arg) == sorted(j_arg) == sorted(init)
    for k in init:
        assert not np.allclose(t_arg[k], init[k]), k
        np.testing.assert_allclose(t_arg[k], j_arg[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert t_out.shape == (BATCH, K)
    np.testing.assert_allclose(t_out, j_out, rtol=1e-4, atol=1e-5)
    assert t_acc == pytest.approx(j_acc, abs=1e-9)


def test_python_loss_chain_learns():
    """``tests/test_module.py``'s run on the port: 30 epochs from Xavier
    reach an accuracy above 0.9."""
    x, y = _data()
    it = tmx.io.NDArrayIter(data=x, label=y, batch_size=BATCH, shuffle=False,
                            label_name="softmax_label")
    metric = tmx.metric.Accuracy()
    tmx.random.seed(0)
    _chain(tmx).fit(it, eval_metric=metric, num_epoch=30, optimizer="sgd",
                    optimizer_params={"learning_rate": 2.0},
                    initializer=tmx.init.Xavier())
    assert metric.get()[1] > 0.9


def test_chain_wiring_shapes_and_input_gradients():
    """Names and shapes flow through the stages; the loss head binds with
    labels, the feature module without; the chain's input gradient is
    the feature module's, from the head's gradient; ``update_metric``
    reaches only the label-taking stage."""
    x, y = _data()
    seq = _chain(tmx)
    assert seq.data_names == ["data"]
    assert seq.output_names == ["pyloss_output"]
    seq.bind([("data", (BATCH, D))], [("softmax_label", (BATCH,))],
             inputs_need_grad=True)
    feat, head = seq._modules
    assert feat.label_shapes == [] and head.label_shapes == [
        ("softmax_label", (BATCH,))]
    assert head.data_shapes == [("data", (BATCH, K))]
    assert seq.output_shapes == [("pyloss_output", (BATCH, K))]
    assert seq.label_shapes == [("softmax_label", (BATCH,))]
    seq.init_params(tmx.init.Xavier())
    seq.init_optimizer(optimizer_params={"learning_rate": 0.1})
    batch = tmx.io.DataBatch([tmx.nd.array(x[:BATCH])],
                             [tmx.nd.array(y[:BATCH])])
    seq.forward(batch, is_train=True)
    seq.backward()
    w = feat.get_params()[0]["fc_weight"].asnumpy()
    g = _ce_grad(seq.get_outputs()[0], tmx.nd.array(y[:BATCH]))
    np.testing.assert_allclose(seq.get_input_grads()[0].asnumpy(), g @ w,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(head.get_input_grads()[0].asnumpy(), g,
                               rtol=1e-6, atol=1e-7)
    seen = []

    class _Metric(tmx.metric.Accuracy):
        def update(self, labels, preds):
            seen.append(preds[0].shape)
            super().update(labels, preds)

    seq.update_metric(_Metric(), batch.label)
    assert seen == [(BATCH, K)]


def test_chain_refusals_and_namespace():
    seq = tmx.mod.SequentialModule()
    with pytest.raises(ValueError, match="Unknown meta"):
        seq.add(tmx.mod.PythonLossModule(), take_label=True)
    with pytest.raises(AssertionError, match="empty"):
        seq.bind([("data", (2, 3))])
    head = tmx.mod.PythonLossModule()
    head.bind([("data", (2, 3))], [("softmax_label", (2,))])
    head.forward(tmx.io.DataBatch([tmx.nd.zeros((2, 3))],
                                  [tmx.nd.zeros((2,))]))
    with pytest.raises(NotImplementedError):
        head.backward()
    with pytest.raises(AssertionError, match="loss head"):
        head.backward(out_grads=[tmx.nd.zeros((2, 3))])
    assert head.get_params() == ({}, {})
    dup = tmx.mod.SequentialModule()
    for _ in range(2):
        dup.add(tmx.mod.Module(tmx.sym.FullyConnected(
            tmx.sym.Variable("data"), num_hidden=3, name="fc"),
            label_names=(), context=tmx.cpu()), auto_wiring=True)
    dup.bind([("data", (2, 3))], for_training=False)
    with pytest.raises(ValueError, match="Duplicated parameter name"):
        dup.init_params()
    assert issubclass(tmx.mod.PythonLossModule, tmx.mod.PythonModule)
    assert issubclass(tmx.mod.SequentialModule, tmx.mod.BaseModule)
    assert tmx.mod.SequentialModule.META_TAKE_LABELS == "take_labels"
    assert tmx.mod.PythonModule(["data"], None, ["out"],
                                logger=logging).label_names == []
