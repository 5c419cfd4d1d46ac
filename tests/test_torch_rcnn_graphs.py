"""The three graphs of Faster R-CNN (``models/rcnn.py``, VGG16) in the
PyTorch port against the JAX package, at 64x64 and 96x128 images and 4
classes: node names, outputs and shapes at both sizes; one SGD step of
the RPN graph at both sizes; three steps of ``example/rcnn/train.py``'s
RPN loop; at 64x64, the detection graph's forward and one SGD step of the
end-to-end graph (Proposal and ROIPooling on its forward path,
ROIPooling's gradient on its backward path).  The two ROIPooling graphs
run at one size: their JAX side without jit compiles some 600 ops, which
both share at one size, and the tier-1 run's six workers share the
cores.

The graphs with ROIPooling run the JAX side without jit: under jit XLA
rewrites ROIPooling's bin division (a ROI 7 rows high over 7 bins gets
bins of 1.0000001 rows, and the last bin's ceil one more row; a 96x128
test graph met such a ROI), where the port and the reference
divide, and it could contract the decode's multiply-adds.  The RPN
graph, which has neither, runs jitted.

Tolerances: the detection graph's rois bit for bit (a mismatch reports
the smallest gap between the sorted RPN scores, the margin a near-tie
would flip); the other graph outputs ``rtol=atol=1e-5``; one SGD step's
updates ``rtol=1e-4, atol=1e-5``; the RPN fit's parameters after three
steps ``rtol=1e-4, atol=1e-5``.
"""

import contextlib
import json

import jax
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import rcnn as jrcnn
from mxnet_tpu_torch.models import rcnn as trcnn

PKGS = (("jax", jmx), ("torch", tmx))
ANCHORS = 9
RPN_LABELS = ("label", "bbox_target", "bbox_weight")
ROI_LABELS = ("roi_label", "roi_bbox_target", "roi_bbox_weight")
#: the post-NMS top-N of the training and test graphs (rcnn.py:57)
TRAIN_ROIS, TEST_ROIS = 2000, 300


# ---------------------------------------------------------------------------
# the three graphs
# ---------------------------------------------------------------------------
SIZES = [(64, 64), (96, 128)]
GRAPHS = ["get_symbol_rpn", "get_symbol_train", "get_symbol_test"]


def _shapes(build, size, num_classes=4):
    h, w = size
    fh, fw = h // 16, w // 16
    shapes = {"data": (1, 3, h, w)}
    if build != "get_symbol_test":
        shapes.update(label=(1, ANCHORS * fh * fw),
                      bbox_target=(1, 4 * ANCHORS, fh, fw),
                      bbox_weight=(1, 4 * ANCHORS, fh, fw))
    if build != "get_symbol_rpn":
        shapes["im_info"] = (1, 3)
    if build == "get_symbol_train":
        shapes.update(roi_label=(TRAIN_ROIS,),
                      roi_bbox_target=(TRAIN_ROIS, 4 * num_classes),
                      roi_bbox_weight=(TRAIN_ROIS, 4 * num_classes))
    return shapes


def _nodes(net):
    return [(n["op"], n["name"]) for n in json.loads(net.tojson())["nodes"]]


def _graph(mx, build):
    """The graph ``build`` of ``mx``'s rcnn, its unnamed nodes (the
    weights' products) counted from 0."""
    kw = {} if build == "get_symbol_rpn" else {"num_classes": 4}
    with mx.name.NameManager():
        return getattr(trcnn if mx is tmx else jrcnn, build)(**kw)


@pytest.mark.parametrize("build", GRAPHS)
def test_rcnn_graphs_match_jax(build):
    """Node names and ops, outputs, arguments and their shapes."""
    want, got = _graph(jmx, build), _graph(tmx, build)
    assert _nodes(got) == _nodes(want)
    assert got.list_outputs() == want.list_outputs()
    assert got.list_arguments() == want.list_arguments()
    for size in SIZES:
        shapes = _shapes(build, size)
        for g, w in zip(got.infer_shape(**shapes),
                        want.infer_shape(**shapes)):
            assert [tuple(s) for s in g] == [tuple(s) for s in w]


def _inputs(build, size, seed=0, num_classes=4):
    """Seeded inputs of every data and label argument: the example's
    brightness labels with a tenth of the anchors ignored (-1), box
    targets with weights on the positive anchors, ROI labels in [0,
    num_classes) and weights on the foreground ROIs."""
    rs = np.random.RandomState(seed)
    shapes = _shapes(build, size, num_classes)
    h, w = size
    img = rs.rand(1, 3, h, w).astype(np.float32)
    out = {"data": img}
    if "label" in shapes:
        lab = (img.mean(1)[:, ::16, ::16] > 0.5).astype(np.float32)
        lab = np.tile(lab.reshape(1, 1, -1), (1, ANCHORS, 1)).reshape(1, -1)
        lab[rs.rand(*lab.shape) < 0.1] = -1.0
        out["label"] = lab
        bt = rs.normal(0, 0.5, shapes["bbox_target"]).astype(np.float32)
        pos = (lab.reshape(1, ANCHORS, 1, *shapes["bbox_target"][2:]) > 0)
        bw = np.broadcast_to(pos, (1, ANCHORS, 4) + shapes["bbox_target"][2:])
        out["bbox_target"] = bt
        out["bbox_weight"] = bw.reshape(shapes["bbox_weight"]) \
            .astype(np.float32)
    if "im_info" in shapes:
        out["im_info"] = np.array([[h, w, 1.0]], np.float32)
    if "roi_label" in shapes:
        rl = rs.randint(0, num_classes, TRAIN_ROIS).astype(np.float32)
        out["roi_label"] = rl
        out["roi_bbox_target"] = rs.normal(
            0, 0.5, shapes["roi_bbox_target"]).astype(np.float32)
        out["roi_bbox_weight"] = np.repeat(
            (rl > 0)[:, None], 4 * num_classes, 1).astype(np.float32)
    return out


def _names(build):
    data = ("data",) if build == "get_symbol_rpn" else ("data", "im_info")
    labels = {"get_symbol_rpn": RPN_LABELS,
              "get_symbol_train": RPN_LABELS + ROI_LABELS,
              "get_symbol_test": ()}[build]
    return data, labels


def _module(mx, build, size, for_training):
    data_names, label_names = _names(build)
    shapes = _shapes(build, size)
    mod = mx.mod.Module(_graph(mx, build),
                        data_names=data_names, label_names=label_names,
                        context=mx.cpu())
    mod.bind(data_shapes=[(k, shapes[k]) for k in data_names],
             label_shapes=[(k, shapes[k]) for k in label_names] or None,
             for_training=for_training)
    return mod


_INIT = {}


def _jax_init(build, size):
    """The JAX package's Xavier weights of ``build`` at ``size`` (seeded),
    as numpy."""
    key = (build, size)
    if key not in _INIT:
        mod = _module(jmx, build, size, for_training=False)
        jmx.random.seed(3)
        mod.init_params(jmx.init.Xavier())
        arg, aux = mod.get_params()
        _INIT.clear()
        _INIT[key] = ({k: v.asnumpy() for k, v in arg.items()},
                      {k: v.asnumpy() for k, v in aux.items()})
    return _INIT[key]


def _batch(mx, build, inputs):
    data_names, label_names = _names(build)
    return mx.io.DataBatch(data=[mx.nd.array(inputs[k]) for k in data_names],
                           label=[mx.nd.array(inputs[k])
                                  for k in label_names])


def _set(mx, mod, init):
    arg, aux = init
    if mx is tmx:
        tmx.convert.set_module_params(mod, arg, aux)
    else:
        mod.set_params({k: jmx.nd.array(v) for k, v in arg.items()},
                       {k: jmx.nd.array(v) for k, v in aux.items()})


def _eager(mx, build):
    """The JAX package without jit for the graphs with ROIPooling (see the
    module's docstring)."""
    if mx is jmx and build != "get_symbol_rpn":
        return jax.disable_jit()
    return contextlib.nullcontext()


def _score_margin(mod, batch):
    """The smallest gap between the port's sorted foreground RPN scores:
    the margin below which the two packages' rounding could reorder them
    (reported when the rois differ)."""
    inner = mod.symbol.get_internals()["rpn_cls_act_reshape_output"]
    ex = inner.simple_bind(tmx.cpu(), grad_req="null",
                           data=batch.data[0].shape)
    arg, aux = mod.get_params()
    ex.copy_params_from(arg, aux, allow_extra_params=True)
    ex.arg_dict["data"][:] = batch.data[0]
    p = ex.forward(is_train=False)[0].asnumpy()
    fg = np.sort(p[0, ANCHORS:].ravel())[::-1]
    return float(np.diff(fg).__abs__().min())


def _assert_rois(got, want, margin_of):
    """The rois bit for bit; a mismatch reports the first row that differs
    and the margin a near-tie would have flipped."""
    if not np.array_equal(got, want):
        row = int(np.argmax((got != want).any(axis=1)))
        raise AssertionError(
            "rois differ first at row %d (%s vs %s, by %.3g); the smallest "
            "gap between sorted RPN scores is %.3g"
            % (row, got[row], want[row], np.abs(got[row] - want[row]).max(),
               margin_of()))


def test_rcnn_test_graph_matches_jax():
    """``get_symbol_test`` forward (rois, cls_prob, bbox_pred) at 64x64
    from the JAX package's weights: 300 rows, the kept proposals and then
    the first repeated."""
    size = SIZES[0]
    init = _jax_init("get_symbol_test", size)
    inputs = _inputs("get_symbol_test", size)
    outs = []
    for _tag, mx in PKGS:
        mod = _module(mx, "get_symbol_test", size, for_training=False)
        _set(mx, mod, init)
        batch = _batch(mx, "get_symbol_test", inputs)
        with _eager(mx, "get_symbol_test"):
            mod.forward(batch, is_train=False)
            outs.append([o.asnumpy() for o in mod.get_outputs()])
    want, got = outs
    tmod = mod
    assert got[0].shape == (TEST_ROIS, 5)
    _assert_rois(got[0], want[0], lambda: _score_margin(tmod, batch))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def _step(mx, build, size, init, inputs, steps=1):
    """``steps`` SGD steps (``example/rcnn/train.py``'s lr 0.001, momentum
    0.9): (outputs of the first forward, parameters after)."""
    mod = _module(mx, build, size, for_training=True)
    _set(mx, mod, init)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.001,
                                         "momentum": 0.9})
    batch = _batch(mx, build, inputs)
    first = None
    with _eager(mx, build):
        for _ in range(steps):
            mod.forward_backward(batch)
            if first is None:
                first = [o.asnumpy() for o in mod.get_outputs()]
            mod.update()
    arg, _aux = mod.get_params()
    return first, {k: v.asnumpy() for k, v in arg.items()}, mod, batch


@pytest.mark.parametrize("size", SIZES, ids=["64x64", "96x128"])
def test_rpn_training_step_matches_jax(size):
    """One SGD step of the RPN graph."""
    assert_step_matches_jax("get_symbol_rpn", size)


def test_end_to_end_training_step_matches_jax():
    """One SGD step of the end-to-end graph at 64x64."""
    assert_step_matches_jax("get_symbol_train", SIZES[0])


def assert_step_matches_jax(build, size):
    """One SGD step of graph ``build`` at ``size`` in both packages from
    the JAX package's weights: the outputs ``1e-5``, each parameter's
    update ``rtol=1e-4, atol=1e-5``; for the end-to-end graph, every
    update of its head and conv5_3 nonzero (ROIPooling's gradient reaches
    conv5_3)."""
    init = _jax_init(build, size)
    inputs = _inputs(build, size, seed=1)
    res = {tag: _step(mx, build, size, init, inputs) for tag, mx in PKGS}
    got, want = res["torch"], res["jax"]
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        du, dw = got[1][k] - init[0][k], want[1][k] - init[0][k]
        np.testing.assert_allclose(du, dw, rtol=1e-4, atol=1e-5, err_msg=k)
        if build == "get_symbol_train" and k.split("_")[0] in (
                "fc6", "fc7", "cls", "bbox", "conv5"):
            assert np.abs(dw).max() > 0, k


def test_rpn_fit_matches_jax():
    """Three steps of ``example/rcnn/train.py``'s RPN loop (SGD lr 0.001,
    momentum 0.9) on one seeded 64x64 scene: the parameters after them
    ``rtol=1e-4, atol=1e-5``, and the cross-entropy of the anchor labels
    falling alike."""
    size = (64, 64)
    init = _jax_init("get_symbol_rpn", size)
    inputs = _inputs("get_symbol_rpn", size, seed=2)
    res = {tag: _step(mx, "get_symbol_rpn", size, init, inputs, steps=3)
           for tag, mx in PKGS}
    for k, w in res["jax"][1].items():
        if k not in inputs:
            np.testing.assert_allclose(res["torch"][1][k], w, rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    lab = inputs["label"].reshape(-1)
    keep = lab >= 0
    ces = []
    for tag in ("jax", "torch"):
        mod = res[tag][2]
        mod.forward(res[tag][3], is_train=False)
        cls = mod.get_outputs()[0].asnumpy()[0].T
        p = cls[np.arange(lab.size)[keep], lab[keep].astype(int)]
        ces.append(float(-np.log(np.maximum(p, 1e-9)).mean()))
    np.testing.assert_allclose(ces[1], ces[0], rtol=1e-5)
