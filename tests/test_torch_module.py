"""The training slice of the PyTorch port against the JAX package.

A small ResNet (``models.resnet.resnet(units=[1, 1], num_stages=2,
filter_list=[8, 16, 32], num_classes=4, image_shape=(3, 40, 40))``: the
imagenet stem, max pooling with padding, bottleneck units, global
average pooling) goes through both packages' executors and through
``Module.fit``, from the same weights (the JAX package's initialization,
carried across through ``mxnet_tpu_torch.convert``) on the same numpy
data.  The pieces of the loop (SoftmaxOutput's gradient, the SGD update
with its multipliers, the schedulers, the metrics, ``NDArrayIter``, the
initializer) are held against the JAX package one by one.

Tolerances: executor outputs and gradients ``rtol=1e-4, atol=1e-5`` (f32
sums in another order through convolutions and BatchNorm), and the same
after three SGD steps with momentum (params, moving statistics and
metrics); the optimizer, schedulers, metrics and iterator exactly or at
``1e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.ops.registry import get as jget
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.ops import bn_kernel
from mxnet_tpu_torch.ops.registry import get as tget

BATCH, CLASSES, IMAGE = 4, 4, (3, 40, 40)
RESNET = dict(units=[1, 1], num_stages=2, filter_list=[8, 16, 32],
              num_classes=CLASSES, image_shape=IMAGE, bottle_neck=True)


def _data(n, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.uniform(0, 255, (n,) + IMAGE)).astype(np.float32)
    y = rs.randint(0, CLASSES, n).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def init_params():
    """The JAX package's Xavier initialization of the small ResNet, as
    numpy (its draws come from numpy's global generator)."""
    net = jresnet.resnet(**RESNET)
    mod = jmx.mod.Module(net, context=jmx.cpu())
    mod.bind(data_shapes=[("data", (BATCH,) + IMAGE)],
             label_shapes=[("softmax_label", (BATCH,))])
    np.random.seed(7)
    mod.init_params(jmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    arg, aux = mod.get_params()
    rs = np.random.RandomState(8)
    # non-trivial BN affine terms and running stats, so every term shows
    arg = {k: v.asnumpy() for k, v in arg.items()}
    for k in arg:
        if k.endswith("_gamma"):
            arg[k] = rs.uniform(0.5, 1.5, arg[k].shape).astype(np.float32)
        elif k.endswith("_beta"):
            arg[k] = rs.normal(0, 0.2, arg[k].shape).astype(np.float32)
    aux = {k: v.asnumpy() for k, v in aux.items()}
    return arg, aux


def test_graphs_agree(init_params):
    jnet, tnet = jresnet.resnet(**RESNET), tresnet.resnet(**RESNET)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_auxiliary_states() == jnet.list_auxiliary_states()
    shapes = {"data": (BATCH,) + IMAGE}
    assert tnet.infer_shape(**shapes) == jnet.infer_shape(**shapes)
    bns = [n for n in tnet.list_auxiliary_states()
           if n.endswith("moving_mean")]
    assert len(bns) == 1 + 1 + 3 * 2 + 1  # bn_data, bn0, 3/unit, bn1


def test_executor_forward_backward_matches_jax(init_params, monkeypatch):
    arg, aux = init_params
    x, y = _data(BATCH)
    res = {}
    relu_flags = []
    real = bn_kernel.bn_train

    def spy(x, gamma, beta, eps, fix_gamma, relu=False):
        relu_flags.append(relu)
        return real(x, gamma, beta, eps, fix_gamma, relu)

    monkeypatch.setattr(bn_kernel, "bn_train", spy)
    for name, mx, build in (("jax", jmx, jresnet.resnet),
                            ("torch", tmx, tresnet.resnet)):
        net = build(**RESNET)
        ex = net.simple_bind(mx.cpu(), grad_req="write",
                             data=(BATCH,) + IMAGE)
        for k, v in arg.items():
            ex.arg_dict[k][:] = v
        for k, v in aux.items():
            ex.aux_dict[k][:] = v
        ex.arg_dict["data"][:] = x
        ex.arg_dict["softmax_label"][:] = y
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        res[name] = dict(
            out=out, **{"g_" + k: ex.grad_dict[k].asnumpy() for k in arg},
            **{"a_" + k: ex.aux_dict[k].asnumpy() for k in aux})
    for k in res["jax"]:
        np.testing.assert_allclose(res["torch"][k], res["jax"][k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    # the peephole: every BN but bn_data has a relu as its only consumer
    assert relu_flags == [False] + [True] * 8


def _fit(mx, build, arg, aux, seed_data):
    x, y = _data(3 * BATCH, seed_data)
    it = mx.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=False)
    mod = mx.mod.Module(build(**RESNET), context=mx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    if mx is tmx:
        tmx.convert.set_module_params(mod, arg, aux)
    else:
        mod.set_params({k: jmx.nd.array(v) for k, v in arg.items()},
                       {k: jmx.nd.array(v) for k, v in aux.items()})
    metric = mx.metric.CompositeEvalMetric(
        [mx.metric.Accuracy(), mx.metric.TopKAccuracy(top_k=2),
         mx.metric.CrossEntropy()])
    sched = mx.lr_scheduler.MultiFactorScheduler(step=[2], factor=0.1)
    speed = mx.callback.Speedometer(BATCH, frequent=1)
    mod.fit(it, eval_metric=metric, num_epoch=1, batch_end_callback=speed,
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                              "wd": 1e-4, "lr_scheduler": sched})
    p_arg, p_aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in p_arg.items()},
            {k: v.asnumpy() for k, v in p_aux.items()},
            dict(metric.get_name_value()), mod)


def test_module_fit_matches_jax(init_params, monkeypatch):
    """One epoch of three batches: the scheduler steps the lr down after
    the second update, inside the epoch."""
    monkeypatch.setenv("MXNET_DEVICE_METRIC", "0")
    arg, aux = init_params
    j_arg, j_aux, j_metric, _ = _fit(jmx, jresnet.resnet, arg, aux, 1)
    t_arg, t_aux, t_metric, tmod = _fit(tmx, tresnet.resnet, arg, aux, 1)
    assert tmod._optimizer.num_update == 3
    assert tmod._optimizer._get_lr(0) == pytest.approx(0.005)
    for k in j_arg:
        if k != "bn_data_gamma":  # fix_gamma: only weight decay moves it
            assert not np.allclose(j_arg[k], arg[k]), k
        np.testing.assert_allclose(t_arg[k], j_arg[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for k in j_aux:
        np.testing.assert_allclose(t_aux[k], j_aux[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert t_metric.keys() == j_metric.keys()
    for k in j_metric:
        assert t_metric[k] == pytest.approx(j_metric[k], rel=1e-4), k


def test_module_entry_points(tmp_path, monkeypatch):
    """Module defaults to the card; fit raises on the options that are
    not ported; score, predict and the params file run on the CPU."""
    net = tresnet.resnet(**RESNET)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(tmx.MXNetError, match="CUDA"):
            tmx.mod.Module(net)
    x, y = _data(6, 3)
    it = tmx.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = tmx.mod.Module(net, context=tmx.cpu())
    for kw in ({"checkpoint_prefix": "x"}, {"nan_policy": "raise"},
               {"resume": "auto"}, {"monitor": object()},
               {"elastic": True}):
        with pytest.raises(tmx.MXNetError, match="not ported yet"):
            mod.fit(it, num_epoch=1, **kw)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(tmx.init.Xavier(magnitude=2))
    out = mod.predict(it)
    assert out.shape == (6, CLASSES)  # the padded rows are dropped
    np.testing.assert_allclose(out.asnumpy().sum(1), 1, rtol=1e-5)
    (name, acc), = mod.score(it, "acc")
    assert name == "accuracy" and 0 <= acc <= 1
    # save_params writes the dmlc file both packages read
    path = str(tmp_path / "small.params")
    mod.save_params(path)
    arg, aux = tmx.convert.module_params_to_numpy(mod)
    jsaved = jmx.nd.load(path)
    assert sorted(jsaved) == sorted(["arg:" + k for k in arg]
                                    + ["aux:" + k for k in aux])
    other = tmx.mod.Module(net, context=tmx.cpu())
    other.bind(it.provide_data, it.provide_label)
    other.init_params(tmx.init.Zero())
    other.load_params(path)
    arg2, aux2 = tmx.convert.module_params_to_numpy(other)
    for k in arg:
        np.testing.assert_array_equal(arg2[k], arg[k])
        np.testing.assert_array_equal(jsaved["arg:" + k].asnumpy(), arg[k])
    for k in aux:
        np.testing.assert_array_equal(aux2[k], aux[k])


# -- SoftmaxOutput's gradient ---------------------------------------------------
@pytest.mark.parametrize("kw,shape,label", [
    ({}, (5, 7), lambda rs: rs.randint(0, 7, 5)),
    ({"normalization": "batch", "grad_scale": 2.0}, (5, 7),
     lambda rs: rs.randint(0, 7, 5)),
    ({"normalization": "valid", "use_ignore": True, "ignore_label": 1},
     (6, 4), lambda rs: np.array([1, 0, 1, 3, 2, 1])),
    ({"use_ignore": True}, (4, 3), lambda rs: np.array([-1, 0, 2, -1])),
    ({"multi_output": True}, (2, 3, 4), lambda rs: rs.randint(0, 3, (2, 4))),
    ({"multi_output": True, "normalization": "valid", "use_ignore": True,
      "ignore_label": 0}, (2, 3, 4), lambda rs: rs.randint(0, 3, (2, 4))),
    ({"preserve_shape": True}, (2, 3, 4), lambda rs: rs.randint(0, 4,
                                                                (2, 3))),
    ({"out_grad": True}, (5, 7), lambda rs: rs.randint(0, 7, 5)),
])
def test_softmax_output_gradient_matches_jax(kw, shape, label):
    rs = np.random.RandomState(0)
    x = rs.normal(0, 1, shape).astype(np.float32)
    lab = label(rs).astype(np.float32)
    head = rs.normal(0, 1, shape).astype(np.float32)
    jop, top = jget("SoftmaxOutput"), tget("SoftmaxOutput")
    ja = jop.canonicalize_attrs(dict(kw))

    def jf(d):
        return jop.apply(ja, [d, jnp.asarray(lab)], [], True, None)[0][0]

    jout, vjp = jax.vjp(jf, jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_(True)
    (tout,) = top.apply(top.canonicalize_attrs(dict(kw)),
                        [tx, torch.from_numpy(lab)], [], True)
    (tg,) = torch.autograd.grad(tout, tx, torch.from_numpy(head))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)


# -- optimizer, schedulers, metrics, iterator, initializer -------------------
def test_sgd_update_and_multipliers_match_jax():
    rs = np.random.RandomState(0)
    names = ["fc_weight", "fc_bias", "bn_gamma", "bn_beta"]
    shapes = [(3, 4), (3,), (4,), (4,)]
    w0 = [rs.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rs.normal(0, 1, s).astype(np.float32) for s in shapes]
             for _ in range(4)]
    res = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        opt = mx.optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, wd=0.01,
            rescale_grad=0.5, clip_gradient=0.8, lr_scheduler=sched,
            param_idx2name=dict(enumerate(names)))
        opt.set_wd_mult({})
        opt.set_lr_mult({"fc_bias": 2.0})
        upd = mx.optimizer.get_updater(opt)
        ws = [mx.nd.array(w) for w in w0]
        for step in grads:
            for i, g in enumerate(step):
                upd(i, mx.nd.array(g), ws[i])
        res[name] = ([w.asnumpy() for w in ws], dict(opt.wd_mult),
                     opt.num_update)
    assert res["torch"][1] == res["jax"][1] == {"fc_bias": 0.0,
                                                "bn_beta": 0.0}
    assert res["torch"][2] == res["jax"][2] == 4
    for t, j in zip(res["torch"][0], res["jax"][0]):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)


def test_schedulers_match_jax():
    for args in ((3, 0.5), (1, 0.9)):
        js = jmx.lr_scheduler.FactorScheduler(*args)
        ts = tmx.lr_scheduler.FactorScheduler(*args)
        js.base_lr = ts.base_lr = 0.1
        assert [ts(t) for t in range(12)] == [js(t) for t in range(12)]
    js = jmx.lr_scheduler.MultiFactorScheduler([2, 5, 9], 0.1)
    ts = tmx.lr_scheduler.MultiFactorScheduler([2, 5, 9], 0.1)
    js.base_lr = ts.base_lr = 0.4
    assert [ts(t) for t in range(12)] == [js(t) for t in range(12)]


def test_metrics_match_jax():
    rs = np.random.RandomState(0)
    labels = [rs.randint(0, 5, 16).astype(np.float32) for _ in range(3)]
    preds = [rs.dirichlet(np.ones(5), 16).astype(np.float32)
             for _ in range(3)]
    for make in (lambda mx: mx.metric.Accuracy(),
                 lambda mx: mx.metric.TopKAccuracy(top_k=3),
                 lambda mx: mx.metric.CrossEntropy(),
                 lambda mx: mx.metric.create(["acc", "ce"])):
        jm, tm = make(jmx), make(tmx)
        for lab, p in zip(labels, preds):
            jm.update([jmx.nd.array(lab)], [jmx.nd.array(p)])
            tm.update([tmx.nd.array(lab)], [tmx.nd.array(p)])
        (jn, jv), (tn, tv) = jm.get(), tm.get()
        assert tn == jn
        np.testing.assert_allclose(tv, jv, rtol=1e-6)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches_jax(handle):
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    y = np.arange(10, dtype=np.float32)
    out = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        it = mx.io.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle)
        assert [tuple(d) for d in it.provide_data] == [("data", (4, 3))]
        seen = []
        for _epoch in range(2):
            for b in it:
                seen.append((b.data[0].asnumpy().tolist(),
                             b.label[0].asnumpy().tolist(), b.pad))
            it.reset()
        out[name] = seen
    assert out["torch"] == out["jax"]


def test_initializer_name_rules_and_xavier_scale():
    net = tresnet.resnet(**RESNET)
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.bind([("data", (BATCH,) + IMAGE)], [("softmax_label", (BATCH,))])
    tmx.init.seed(0)
    mod.init_params(tmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    arg, aux = tmx.convert.module_params_to_numpy(mod)
    for k, v in list(arg.items()) + list(aux.items()):
        if k.endswith(("_bias", "_beta", "moving_mean")):
            assert not v.any(), k
        elif k.endswith(("_gamma", "moving_var")):
            assert (v == 1).all(), k
    # the draws cannot match numpy's: hold the moments to the Xavier rule
    w = arg["stage2_unit1_conv2_weight"]          # (16, 4, 3, 3)
    want = np.sqrt(2.0 / (w.shape[1] * 9))
    assert abs(w.mean()) < 0.1 * want
    assert w.std() == pytest.approx(want, rel=0.1)
    u = tmx.init.Xavier(rnd_type="uniform", factor_type="avg", magnitude=3)
    t = tmx.nd.zeros((256, 128), tmx.cpu())
    u("fc_weight", t)
    bound = np.sqrt(3.0 / ((256 + 128) / 2))
    assert np.abs(t.asnumpy()).max() <= bound
    assert t.asnumpy().std() == pytest.approx(bound / np.sqrt(3), rel=0.05)
    # a generator makes the draw repeat
    a, b = (tmx.nd.zeros((8, 8), tmx.cpu()) for _ in range(2))
    tmx.init.Normal(0.1, generator=torch.Generator().manual_seed(3))(
        "w_weight", a)
    tmx.init.Normal(0.1, generator=torch.Generator().manual_seed(3))(
        "w_weight", b)
    assert (a.asnumpy() == b.asnumpy()).all()
