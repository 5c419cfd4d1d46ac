"""Inception-v3 in the PyTorch port against the JAX package: the
variadic ``Concat`` op, the five Inception blocks, the full network's
graph and parameter names, and a small Inception net through
``Module.fit``.

Tolerances: ``Concat`` forward and gradient ``rtol=atol=1e-5`` (a copy;
both exact in fact); the blocks' train-mode forward and gradients
``rtol=1e-4, atol=1e-5`` (f32 sums through convolutions and BatchNorm in
another order), as the small ResNet's, with ``atol`` taken relative to a
tensor's largest magnitude where that exceeds 1 (a weight's gradient
sums hundreds of positions to magnitudes of 10-20); the small net after
three SGD steps with momentum ``rtol=1e-4, atol=1e-5``.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import inception_v3 as jinc
from mxnet_tpu_torch.models import inception_v3 as tinc

PKGS = (("jax", jmx), ("torch", tmx))


def _bind(mx, net, grad_req="write", **shapes):
    return net.simple_bind(mx.cpu(), grad_req=grad_req, **shapes)


def _run(mx, net, values, shapes, out_grad, aux=None):
    """Train-mode forward and backward of ``net`` on ``values``: (outputs,
    {argument: gradient}, {aux state: value}) as numpy."""
    ex = _bind(mx, net, **shapes)
    for k, v in values.items():
        ex.arg_dict[k][:] = v
    for k, v in (aux or {}).items():
        ex.aux_dict[k][:] = v
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward(out_grads=[mx.nd.array(out_grad)])
    grads = {k: ex.grad_dict[k].asnumpy() for k in values}
    return outs, grads, {k: ex.aux_dict[k].asnumpy() for k in ex.aux_dict}


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("n", [2, 3, 6])
def test_concat_forward_and_gradient_match_jax(dim, n):
    rs = np.random.RandomState(n + 10 * dim)
    shapes = {"x%d" % i: tuple(2 + i if a == dim else (3, 4, 5)[a]
                               for a in range(3)) for i in range(n)}
    values = {k: rs.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    total = sum(s[dim] for s in shapes.values())
    out_shape = tuple(total if a == dim else (3, 4, 5)[a] for a in range(3))
    out_grad = rs.normal(0, 1, out_shape).astype(np.float32)
    res = {}
    for tag, mx in PKGS:
        # num_args comes from the positional inputs
        net = mx.sym.Concat(*[mx.sym.Variable(k) for k in shapes], dim=dim,
                            name="cat")
        assert net.list_arguments() == list(shapes)
        res[tag] = _run(mx, net, values, shapes, out_grad)
    (jo, jg, _), (to, tg, _) = res["jax"], res["torch"]
    np.testing.assert_allclose(to[0], jo[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        to[0], np.concatenate([values[k] for k in shapes], axis=dim))
    for k in shapes:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5, atol=1e-5)


def test_concat_counts_its_inputs_and_round_trips_json():
    a, b, c = (tmx.sym.Variable(n) for n in "abc")
    net = tmx.sym.Concat(a, b, c, dim=0, name="cat")
    node = net._nodes()[-1]
    assert node.attrs["num_args"] == 3
    assert tmx.sym.concat(a, b).list_arguments() == ["a", "b"]
    with pytest.raises(tmx.MXNetError, match="num_args"):
        tmx.ops.get("Concat").canonicalize_attrs({"dim": 1})
    # the graph JSON crosses both ways with num_args
    j = jmx.sym.load_json(net.tojson())
    assert j.list_arguments() == ["a", "b", "c"]
    assert j.infer_shape(a=(1, 2), b=(2, 2), c=(3, 2))[1] == [(6, 2)]
    back = tmx.sym.load_json(j.tojson())
    assert back._nodes()[-1].attrs == {"num_args": 3, "dim": 0}
    assert back.infer_shape(a=(1, 2), b=(2, 2), c=(3, 2))[1] == [(6, 2)]
    # imperative: nd.concat and nd.Concat count their inputs too
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = tmx.nd.concat(tmx.nd.array(x), tmx.nd.array(x + 1), dim=1)
    want = jmx.nd.concat(jmx.nd.array(x), jmx.nd.array(x + 1), dim=1)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert tmx.nd.Concat(tmx.nd.array(x), tmx.nd.array(x),
                         tmx.nd.array(x)).shape == (2, 9)


def test_concat_fills_one_unknown_input_from_its_output():
    """A consumer's rule fixes the Concat's output (elemwise_add of a
    known shape); the one unknown input takes the rest of ``dim``."""
    a, v, c = (tmx.sym.Variable(n) for n in "avc")
    net = tmx.sym.Concat(a, v, dim=1) + c
    args, outs, _ = net.infer_shape(a=(2, 3, 4), c=(2, 5, 4))
    assert args == [(2, 3, 4), (2, 2, 4), (2, 5, 4)] and outs == [(2, 5, 4)]
    # with two unknown inputs the rule cannot split the extent
    w = tmx.sym.Variable("w")
    with pytest.raises(tmx.MXNetError, match="cannot infer"):
        (tmx.sym.Concat(a, v, w, dim=1) + c).infer_shape(a=(2, 3, 4),
                                                         c=(2, 5, 4))


#: each block at 2-8 filters, with its pooling kind
BLOCKS = {
    "7A": ("Inception7A", (4, 3, 5, 6, 2, 3, "avg", 2)),
    "7B": ("Inception7B", (6, 2, 4, 5, "max")),
    "7C": ("Inception7C", (3, 2, 3, 4, 2, 3, 2, 3, 5, "avg", 2)),
    "7D": ("Inception7D", (2, 5, 3, 2, 4, 6, "max")),
    "7E": ("Inception7E", (3, 2, 4, 5, 3, 2, 4, 3, "max", 8)),
}
BLOCK_SHAPE = (2, 4, 17, 17)


def _block(mx, mod, key):
    fn, args = BLOCKS[key]
    with mx.name.NameManager():
        return getattr(mod, fn)(mx.sym.Variable("data"), *args,
                                name="mixed")


@pytest.mark.parametrize("key", sorted(BLOCKS))
def test_inception_block_matches_jax(key):
    """Train-mode forward, every gradient (convolution weights, BatchNorm
    betas, the input) and the moving statistics of one block."""
    jnet, tnet = _block(jmx, jinc, key), _block(tmx, tinc, key)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_auxiliary_states() == jnet.list_auxiliary_states()
    shapes = {"data": BLOCK_SHAPE}
    assert tnet.infer_shape(**shapes) == jnet.infer_shape(**shapes)
    arg_shapes, out_shapes, _ = tnet.infer_shape(**shapes)
    rs = np.random.RandomState(len(key) + ord(key[1]))
    values = {}
    for name, s in zip(tnet.list_arguments(), arg_shapes):
        if name.endswith("_gamma"):
            values[name] = rs.uniform(0.5, 1.5, s).astype(np.float32)
        elif name.endswith("_beta"):
            values[name] = rs.normal(0, 0.2, s).astype(np.float32)
        else:
            values[name] = rs.normal(0, 1, s).astype(np.float32)
    out_grad = rs.normal(0, 1, out_shapes[0]).astype(np.float32)
    (jo, jg, ja), (to, tg, ta) = (_run(mx, net, values, shapes, out_grad)
                                  for mx, net in ((jmx, jnet),
                                                  (tmx, tnet)))
    def close(got, want, name):
        # a weight's gradient sums 578 positions to magnitudes of 10-20,
        # where f32 sums in another order differ by ~4e-5: atol scales
        # with the tensor's largest magnitude above 1
        np.testing.assert_allclose(
            got, want, rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(want).max())), err_msg=name)

    close(to[0], jo[0], "output")
    for k in values:
        close(tg[k], jg[k], k)
    for k in ja:
        close(ta[k], ja[k], k)
    assert np.abs(tg["data"]).max() > 0


def test_inception_v3_graph_and_params_file_match_jax(tmp_path):
    """The same argument and auxiliary names, the same inferred shapes at
    (2, 3, 299, 299), 94 BatchNorms each with a ReLU the executor fuses,
    and a params file the JAX Module saved loads into the port's."""
    from mxnet_tpu_torch.executor import _bn_relu_peephole

    jnet = jmx.models.get_symbol("inception-v3", num_classes=1000)
    tnet = tmx.models.get_symbol("inception-v3", num_classes=1000)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_auxiliary_states() == jnet.list_auxiliary_states()
    shapes = {"data": (2, 3, 299, 299)}
    assert tnet.infer_shape(**shapes) == jnet.infer_shape(**shapes)
    nodes = tnet._nodes()
    bns = [n for n in nodes if not n.is_variable
           and n.op.name == "BatchNorm"]
    assert len(bns) == 94 and all(n.attrs["fix_gamma"] for n in bns)
    assert len(_bn_relu_peephole(tnet, nodes)[0]) == 94
    jmod = jmx.mod.Module(jnet, context=jmx.cpu())
    jmod.bind(data_shapes=[("data", (2, 3, 299, 299))],
              label_shapes=[("softmax_label", (2,))], for_training=False)
    np.random.seed(0)
    jmod.init_params(jmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                     magnitude=2))
    path = str(tmp_path / "inception-v3.params")
    jmod.save_params(path)
    tmod = tmx.mod.Module(tnet, context=tmx.cpu())
    tmod.bind(data_shapes=[("data", (2, 3, 299, 299))],
              label_shapes=[("softmax_label", (2,))], for_training=False)
    tmod.init_params(tmx.init.Zero())
    tmod.load_params(path)
    j_arg, j_aux = jmod.get_params()
    t_arg, t_aux = tmod.get_params()
    assert sorted(t_arg) == sorted(j_arg) and sorted(t_aux) == sorted(j_aux)
    for k in j_arg:
        np.testing.assert_array_equal(t_arg[k].asnumpy(), j_arg[k].asnumpy())
    for k in j_aux:
        np.testing.assert_array_equal(t_aux[k].asnumpy(), j_aux[k].asnumpy())


SMALL_BATCH, SMALL_IMAGE, SMALL_CLASSES = 4, (3, 33, 33), 4


def _small_net(mx, mod):
    """The stem convolution, Inception7A and 7B, global pooling and a
    classifier: 33x33 -> 16x16 -> 16x16 -> 7x7."""
    with mx.name.NameManager():
        x = mod.Conv(mx.sym.Variable("data"), 8, kernel=(3, 3),
                     stride=(2, 2), name="conv")
        x = mod.Inception7A(x, 4, 3, 5, 6, 2, 3, "avg", 2, "mixed")
        x = mod.Inception7B(x, 6, 2, 4, 5, "max", "mixed_3")
        x = mx.sym.Pooling(x, kernel=(7, 7), pool_type="avg",
                           global_pool=True, name="global_pool")
        x = mx.sym.FullyConnected(mx.sym.Flatten(x),
                                  num_hidden=SMALL_CLASSES, name="fc1")
        return mx.sym.SoftmaxOutput(x, name="softmax")


def _small_fit(mx, mod, arg, aux, x, y):
    it = mx.io.NDArrayIter(x, y, batch_size=SMALL_BATCH)
    m = mx.mod.Module(_small_net(mx, mod), context=mx.cpu())
    m.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    m.init_params()
    if mx is tmx:
        tmx.convert.set_module_params(m, arg, aux)
    else:
        m.set_params({k: jmx.nd.array(v) for k, v in arg.items()},
                     {k: jmx.nd.array(v) for k, v in aux.items()})
    m.fit(it, num_epoch=1, optimizer="sgd", force_init=False,
          optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                            "wd": 1e-4})
    p_arg, p_aux = m.get_params()
    return ({k: v.asnumpy() for k, v in p_arg.items()},
            {k: v.asnumpy() for k, v in p_aux.items()}, m)


def test_small_inception_fit_matches_jax(monkeypatch):
    """Three SGD steps (momentum 0.9, wd 1e-4) from the JAX package's
    Xavier weights on the same batches."""
    monkeypatch.setenv("MXNET_DEVICE_METRIC", "0")
    jm = jmx.mod.Module(_small_net(jmx, jinc), context=jmx.cpu())
    jm.bind(data_shapes=[("data", (SMALL_BATCH,) + SMALL_IMAGE)],
            label_shapes=[("softmax_label", (SMALL_BATCH,))])
    np.random.seed(4)
    jm.init_params(jmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    arg, aux = ({k: v.asnumpy() for k, v in d.items()}
                for d in jm.get_params())
    rs = np.random.RandomState(5)
    x = rs.uniform(-1, 1, (3 * SMALL_BATCH,) + SMALL_IMAGE).astype(
        np.float32)
    y = rs.randint(0, SMALL_CLASSES, 3 * SMALL_BATCH).astype(np.float32)
    j_arg, j_aux, _ = _small_fit(jmx, jinc, arg, aux, x, y)
    t_arg, t_aux, tm = _small_fit(tmx, tinc, arg, aux, x, y)
    assert tm._optimizer.num_update == 3
    for k in j_arg:
        if not k.endswith("_gamma"):  # fix_gamma: only wd moves a gamma
            assert not np.allclose(j_arg[k], arg[k]), k
        np.testing.assert_allclose(t_arg[k], j_arg[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for k in j_aux:
        np.testing.assert_allclose(t_aux[k], j_aux[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
