"""The spatial ops of ``ops/spatial.py`` other than ROIPooling
(``test_torch_rcnn.py``) in the PyTorch port against the JAX package:
``BilinearSampler``, ``GridGenerator`` (affine and warp),
``SpatialTransformer``, ``Correlation`` and ``Crop``, each forward and
gradient through a bound graph of the registered op.

Tolerance ``rtol=atol=1e-5`` everywhere: the ops are the JAX functions'
arithmetic as torch compositions (the grids' ``linspace`` formula, the
sampler's corner gather and zero padding), their sums (the affine map's
three products, Correlation's patches and channels) taken in another
order.  Sampling grids reach past [-1, 1], so corners outside the map
(read as 0) are exercised.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

PKGS = (("jax", jmx), ("torch", tmx))


def _run(mx, net, values, head):
    """Train-mode forward and backward of ``net`` with every argument in
    ``values``: (output, {argument: gradient})."""
    shapes = {k: v.shape for k, v in values.items()}
    ex = net.simple_bind(mx.cpu(), grad_req="write", **shapes)
    for k, v in values.items():
        ex.arg_dict[k][:] = v
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward(out_grads=[mx.nd.array(head)])
    return out, {k: ex.grad_dict[k].asnumpy() for k in values}


def _cases():
    """(id, build(mx) -> symbol, {input: array})."""
    rs = np.random.RandomState(0)

    def normal(*shape, scale=1.0):
        return rs.normal(0, scale, shape).astype(np.float32)

    def var(mx, name):
        return mx.sym.Variable(name)

    theta = np.tile(np.array([[1, 0, 0, 0, 1, 0]], np.float32), (2, 1))
    theta = theta * 0.9 + normal(2, 6, scale=0.2)
    cases = [
        ("bilinear", lambda mx: mx.sym.BilinearSampler(
            var(mx, "data"), var(mx, "grid")),
         {"data": normal(2, 3, 5, 7),
          "grid": rs.uniform(-1.3, 1.3, (2, 2, 4, 6)).astype(np.float32)}),
        ("bilinear-square", lambda mx: mx.sym.BilinearSampler(
            var(mx, "data"), var(mx, "grid")),
         {"data": normal(1, 2, 6, 6),
          "grid": rs.uniform(-1.0, 1.0, (1, 2, 6, 6)).astype(np.float32)}),
        ("grid-affine", lambda mx: mx.sym.GridGenerator(
            var(mx, "data"), transform_type="affine", target_shape=(5, 7)),
         {"data": theta}),
        ("grid-affine-1xn", lambda mx: mx.sym.GridGenerator(
            var(mx, "data"), transform_type="affine", target_shape=(1, 4)),
         {"data": theta}),
        ("grid-warp", lambda mx: mx.sym.GridGenerator(
            var(mx, "data"), transform_type="warp"),
         {"data": normal(2, 2, 5, 7, scale=1.5)}),
        ("spatial-transformer", lambda mx: mx.sym.SpatialTransformer(
            var(mx, "data"), var(mx, "loc"), target_shape=(5, 7),
            transform_type="affine", sampler_type="bilinear"),
         {"data": normal(2, 3, 6, 8), "loc": theta}),
    ]
    for k, md, s1, s2, pad, mult in [(1, 2, 1, 1, 2, True),
                                     (3, 2, 2, 2, 3, True),
                                     (1, 1, 1, 1, 1, False),
                                     (3, 1, 1, 1, 0, False)]:
        cases.append((
            "correlation-k%d-d%d-s%d%d-p%d-%s" % (
                k, md, s1, s2, pad, "mul" if mult else "abs"),
            lambda mx, k=k, md=md, s1=s1, s2=s2, pad=pad, mult=mult:
            mx.sym.Correlation(var(mx, "a"), var(mx, "b"), kernel_size=k,
                               max_displacement=md, stride1=s1, stride2=s2,
                               pad_size=pad, is_multiply=mult),
            {"a": normal(2, 3, 7, 9), "b": normal(2, 3, 7, 9)}))
    cases += [
        ("crop-offset", lambda mx: mx.sym.Crop(
            var(mx, "data"), h_w=(3, 4), offset=(1, 2)),
         {"data": normal(2, 3, 6, 8)}),
        ("crop-center", lambda mx: mx.sym.Crop(
            var(mx, "data"), h_w=(3, 5), center_crop=True),
         {"data": normal(2, 3, 6, 8)}),
        ("crop-like", lambda mx: mx.sym.Crop(
            var(mx, "data"), var(mx, "like"), num_args=2, offset=(2, 1)),
         {"data": normal(2, 3, 6, 8), "like": normal(2, 1, 4, 5)}),
    ]
    return cases


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_spatial_op_forward_and_gradient_match_jax(case):
    name, build, values = case
    shapes = {k: v.shape for k, v in values.items()}
    out_shapes = [build(mx).infer_shape(**shapes)[1][0] for _t, mx in PKGS]
    assert tuple(out_shapes[0]) == tuple(out_shapes[1])
    head = np.random.RandomState(len(name)).normal(
        0, 1, out_shapes[0]).astype(np.float32)
    (want, wgrad), (got, ggrad) = [_run(mx, build(mx), values, head)
                                   for _t, mx in PKGS]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for k in values:
        np.testing.assert_allclose(ggrad[k], wgrad[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    if name.startswith("bilinear") or name == "spatial-transformer":
        # some corners fall outside the map, and every input moves
        assert (np.abs(wgrad["data"]) > 0).any()
        assert (np.abs(ggrad.get("grid", ggrad.get("loc"))) > 0).all()


@pytest.mark.parametrize("op,attrs,match", [
    ("GridGenerator", {"transform_type": "affine"}, "target_shape"),
    ("GridGenerator", {"transform_type": "spline",
                       "target_shape": (2, 2)}, "transform_type"),
    ("SpatialTransformer", {"target_shape": (2, 2),
                            "sampler_type": "nearest"}, "bilinear"),
])
def test_spatial_op_refusals_match_jax(op, attrs, match):
    """The settings the JAX package refuses, the port refuses too."""
    for _tag, mx in PKGS:
        args = [mx.sym.Variable("data")]
        if op == "SpatialTransformer":
            args.append(mx.sym.Variable("loc"))
        net = getattr(mx.sym, op)(*args, **attrs)
        shapes = {"data": (1, 6)} if op == "GridGenerator" \
            else {"data": (1, 2, 3, 3), "loc": (1, 6)}
        with pytest.raises(mx.base.MXNetError, match=match):
            ex = net.simple_bind(mx.cpu(), grad_req="null", **shapes)
            ex.forward(is_train=False)
