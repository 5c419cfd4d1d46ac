"""SSD-VGG16 (BASELINE #4) in the PyTorch port against the JAX package:
the ops the graph adds (``transpose``, ``broadcast_mul``, ``smooth_l1``,
``MakeLoss``, ``SoftmaxActivation``, ``L2Normalization``, ``LRN``, the
three ``_contrib_MultiBox*`` ops), greedy NMS's plain version (K7's on
the CPU) in both of the JAX function's regimes, ``Group`` graphs and
checkpoints crossing between the packages, the training and deploy
graphs, a fit through ``Module.fit`` with ``MultiBoxMetric``, and the
``Detector``/VOC evaluation round trip.

Tolerances: every op forward and gradient ``rtol=atol=1e-5``, the JAX
side without jit where XLA would contract a multiply-add (IoUs, encodings);
MultiBoxTarget's ``cls_target`` and mask and MultiBoxDetection's class ids
exact, their boxes and ``loc_target`` ``1e-5``; the fit after three SGD
steps with momentum ``rtol=1e-4, atol=1e-5`` (f32 sums through
convolutions in another order), its metric values ``1e-4``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import ssd_vgg16 as jssd
from mxnet_tpu.ops import contrib as jcontrib
from mxnet_tpu_torch.models import ssd_detect, ssd_vgg16 as tssd
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.ops import nms_kernel

PKGS = (("jax", jmx), ("torch", tmx))
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "example", "ssd")


def _run(mx, net, values, out_grads):
    """Train-mode forward and backward of ``net`` with every argument in
    ``values``: (outputs, {argument: gradient})."""
    shapes = {k: v.shape for k, v in values.items()}
    ex = net.simple_bind(mx.cpu(), grad_req="write", **shapes)
    for k, v in values.items():
        ex.arg_dict[k][:] = v
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward(out_grads=[mx.nd.array(g) for g in out_grads])
    return outs, {k: ex.grad_dict[k].asnumpy() for k in values}


def _op_cases():
    """(id, build(mx) -> symbol, input shapes)."""
    cases = [
        ("transpose", lambda mx: mx.sym.transpose(
            mx.sym.Variable("x"), axes=(0, 2, 3, 1)), {"x": (2, 3, 4, 5)}),
        ("transpose-default", lambda mx: mx.sym.transpose(
            mx.sym.Variable("x")), {"x": (2, 3, 4)}),
        ("broadcast_mul", lambda mx: mx.sym.broadcast_mul(
            mx.sym.Variable("s"), mx.sym.Variable("x")),
         {"s": (1, 3, 1, 1), "x": (2, 3, 4, 5)}),
        ("smooth_l1", lambda mx: mx.sym.smooth_l1(
            mx.sym.Variable("x"), scalar=1.0), {"x": (4, 30)}),
        ("smooth_l1-s2", lambda mx: mx.sym.smooth_l1(
            mx.sym.Variable("x"), scalar=2.0), {"x": (4, 30)}),
        ("softmax-instance", lambda mx: mx.sym.SoftmaxActivation(
            mx.sym.Variable("x")), {"x": (2, 3, 4, 5)}),
        ("softmax-channel", lambda mx: mx.sym.SoftmaxActivation(
            mx.sym.Variable("x"), mode="channel"), {"x": (2, 6, 7)}),
        ("lrn", lambda mx: mx.sym.LRN(
            mx.sym.Variable("x"), alpha=1e-2, beta=0.75, knorm=2,
            nsize=5), {"x": (2, 7, 4, 5)}),
        ("lrn-3", lambda mx: mx.sym.LRN(mx.sym.Variable("x"), nsize=3),
         {"x": (2, 4, 3, 3)}),
    ]
    for mode in ("instance", "channel", "spatial"):
        cases.append(("l2norm-" + mode, lambda mx, m=mode:
                      mx.sym.L2Normalization(mx.sym.Variable("x"), mode=m),
                      {"x": (2, 3, 4, 5)}))
    return cases


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_new_op_forward_and_gradient_match_jax(case):
    _name, build, shapes = case
    rs = np.random.RandomState(len(_name))
    values = {k: rs.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    out_shape = build(tmx).infer_shape(**shapes)[1][0]
    head = rs.normal(0, 1, out_shape).astype(np.float32)
    res = {tag: _run(mx, build(mx), values, [head]) for tag, mx in PKGS}
    np.testing.assert_allclose(res["torch"][0][0], res["jax"][0][0],
                               rtol=1e-5, atol=1e-5)
    for k in values:
        np.testing.assert_allclose(res["torch"][1][k], res["jax"][1][k],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
@pytest.mark.parametrize("grad_scale", [1.0, 0.0, 2.5])
def test_make_loss_matches_jax(normalization, grad_scale):
    """Identity forward; the gradient ignores the head gradient and is
    ``grad_scale`` over the batch or the count above ``valid_thresh``."""
    rs = np.random.RandomState(3)
    x = rs.normal(0, 1, (4, 6)).astype(np.float32)

    def build(mx):
        return mx.sym.MakeLoss(mx.sym.Variable("x") * 2.0,
                               grad_scale=grad_scale, valid_thresh=0.3,
                               normalization=normalization)

    head = rs.normal(0, 1, x.shape).astype(np.float32)
    res = {tag: _run(mx, build(mx), {"x": x}, [head]) for tag, mx in PKGS}
    np.testing.assert_allclose(res["torch"][0][0], res["jax"][0][0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res["torch"][1]["x"], res["jax"][1]["x"],
                               rtol=1e-5, atol=1e-5)


def test_variable_mults_reach_the_optimizer():
    """``Variable(lr_mult=, wd_mult=)`` are the ``__lr_mult__`` and
    ``__wd_mult__`` attrs in both packages, and each optimizer treats them
    alike: the constructor reads neither (so ``fit`` ignores them, as the
    JAX ``Optimizer`` does), ``set_lr_mult``/``set_wd_mult`` read both."""
    def build(mx):
        s = mx.sym.Variable("s", shape=(1, 3, 1, 1), wd_mult=0.1, lr_mult=2)
        return mx.sym.FullyConnected(mx.sym.broadcast_mul(
            s, mx.sym.Variable("data")), num_hidden=2, name="fc")

    names = {0: "s", 1: "fc_weight", 2: "fc_bias"}
    got = []
    for _tag, mx in PKGS:
        net = build(mx)
        assert net.attr_dict()["s"]["__wd_mult__"] == "0.1"
        o = mx.optimizer.create("sgd", learning_rate=0.1, wd=0.01, sym=net,
                                param_idx2name=names)
        got.append([(o._get_lr(i), o._get_wd(i)) for i in names])
        o.set_lr_mult({})
        o.set_wd_mult({})
        got.append([(o._get_lr(i), o._get_wd(i)) for i in names])
    assert got[0] == got[2] and got[1] == got[3]
    assert got[2][0] == (0.1, 0.01)
    assert got[3][0] == (0.2, 0.01 * 0.1)


def test_multibox_prior_matches_jax():
    for h, w, sizes, ratios, clip in [(5, 7, (0.2, 0.3), (1.0, 2.0, 0.5),
                                       True),
                                      (3, 3, (0.5,), (1.0, 3.0, 1 / 3.),
                                       False)]:
        attrs = {"sizes": sizes, "ratios": ratios, "clip": clip}
        data = np.zeros((2, 4, h, w), np.float32)
        want = np.asarray(jcontrib._multibox_prior(
            attrs, [jnp.asarray(data)], [], False, None)[0])
        got = tcontrib._multibox_prior(attrs, [torch.from_numpy(data)], [],
                                       False)[0].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _anchors(h=8, w=8):
    return tcontrib._anchors(h, w, (0.2, 0.35), (1.0, 2.0, 0.5), True,
                             "cpu").numpy()


def _labels(rs, B, G, C, empty=()):
    labels = -np.ones((B, G, 5), np.float32)
    for b in range(B):
        if b in empty:
            continue
        for g in range(rs.randint(1, G + 1)):
            x0, y0 = rs.rand(2) * 0.6
            labels[b, g] = [rs.randint(0, C - 1), x0, y0,
                            x0 + 0.1 + rs.rand() * 0.3,
                            y0 + 0.1 + rs.rand() * 0.3]
    return labels


TARGET_ATTRS = dict(overlap_threshold=0.5, ignore_label=-1.0,
                    negative_mining_ratio=3.0, negative_mining_thresh=0.5,
                    minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2))


@pytest.mark.parametrize("case", ["padded", "no-gt", "tied", "no-mining",
                                  "min-negatives"])
def test_multibox_target_matches_jax(case):
    """Padded labels, an image without ground truth, tied scores (equal
    raw scores: every mining candidate ties), no mining, a minimum of
    negatives: ``cls_target`` and the mask exact, ``loc_target`` 1e-5."""
    rs = np.random.RandomState(7)
    anchors = _anchors()
    B, G, C = 4, 4, 5
    A = anchors.shape[1]
    labels = _labels(rs, B, G, C, empty=(2,) if case == "no-gt" else ())
    preds = rs.normal(0, 1, (B, C, A)).astype(np.float32)
    attrs = dict(TARGET_ATTRS)
    if case == "tied":
        preds[:, :, :] = 0.5
    if case == "no-mining":
        attrs["negative_mining_ratio"] = -1.0
    if case == "min-negatives":
        attrs["minimum_negative_samples"] = 40
    with jax.disable_jit():
        want = jcontrib._multibox_target(
            attrs, [jnp.asarray(anchors), jnp.asarray(labels),
                    jnp.asarray(preds)], [], True, None)
    got = tcontrib._multibox_target(
        attrs, [torch.from_numpy(anchors), torch.from_numpy(labels),
                torch.from_numpy(preds)], [], True)
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in got]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert (want[2] > 0).any() and (want[2] == 0).any()
    if case == "no-gt":
        assert (got[2][2] == 0).all()


def _detection_inputs(seed, B=3, C=5, h=8, w=8, ties=False):
    rs = np.random.RandomState(seed)
    anchors = _anchors(h, w)
    A = anchors.shape[1]
    logits = rs.normal(0, 2, (B, C, A)).astype(np.float32)
    if ties:
        logits[:, :, ::3] = logits[:, :, :1]
    prob = np.array(jax.nn.softmax(jnp.asarray(logits), axis=1))
    loc = rs.normal(0, 1, (B, 4 * A)).astype(np.float32)
    return prob, loc, anchors


@pytest.mark.parametrize("regime", ["matrix", "streaming"])
@pytest.mark.parametrize("force,topk,thresh", [
    (False, -1, 0.5), (True, 100, 0.45), (False, 40, 0.3), (True, -1, 0.0)])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_multibox_detection_matches_jax(monkeypatch, regime, force, topk,
                                        thresh, ties):
    """Both regimes of the JAX function's NMS (the streaming one by
    ``NMS_MATRIX_MAX_BOXES`` below the box count): ids exact, scores and
    boxes 1e-5."""
    if regime == "streaming":
        monkeypatch.setattr(jcontrib, "NMS_MATRIX_MAX_BOXES", 16)
    prob, loc, anchors = _detection_inputs(11, ties=ties)
    attrs = dict(clip=True, threshold=0.01, nms_threshold=thresh,
                 force_suppress=force, variances=(0.1, 0.1, 0.2, 0.2),
                 nms_topk=topk, background_id=0)
    with jax.disable_jit():
        want = np.asarray(jcontrib._multibox_detection(
            attrs, [jnp.asarray(prob), jnp.asarray(loc),
                    jnp.asarray(anchors)], [], False, None)[0])
    got = tcontrib._multibox_detection(
        attrs, [torch.from_numpy(prob), torch.from_numpy(loc),
                torch.from_numpy(anchors)], [], False)[0].numpy()
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=1e-5,
                               atol=1e-5)
    kept = (got[..., 0] >= 0).sum()
    assert 0 < kept < got[..., 0].size


@pytest.mark.parametrize("regime", ["matrix", "streaming"])
@pytest.mark.parametrize("force", [False, True])
def test_greedy_nms_plain_matches_jax(monkeypatch, regime, force):
    """K7's plain version against ``_greedy_nms`` on one image at a time:
    random boxes in four classes with a tenth invalid, a visit order with
    ties broken by index, boxes repeated exactly (IoU 1)."""
    if regime == "streaming":
        monkeypatch.setattr(jcontrib, "NMS_MATRIX_MAX_BOXES", 8)
    rs = np.random.RandomState(2)
    B, A = 3, 120
    xy = rs.rand(B, A, 2).astype(np.float32) * 0.7
    wh = rs.rand(B, A, 2).astype(np.float32) * 0.3 + 0.02
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 60:70] = boxes[:, 50:60]
    cls = rs.randint(0, 4, (B, A)).astype(np.float32)
    cls[rs.rand(B, A) < 0.1] = -1.0
    score = np.round(rs.rand(B, A), 1).astype(np.float32)
    order = np.argsort(-score, axis=1, kind="stable").astype(np.int32)
    got = nms_kernel.greedy_nms_plain(
        torch.from_numpy(boxes), torch.from_numpy(cls),
        torch.from_numpy(order), 0.4, force).numpy()
    with jax.disable_jit():
        for b in range(B):
            want = np.asarray(jcontrib._greedy_nms(
                jnp.asarray(boxes[b]), jnp.asarray(cls[b]),
                jnp.asarray(order[b]), 0.4, force))
            np.testing.assert_array_equal(got[b], want)
    assert not got.all()


# -- the two passes of K7 (csrc/nms.cu), modelled on the CPU ----------------
CHUNK, TILE = 64, 8


def _mask_words(boxes, cls_id, order, thresh, force):
    """K7's mask pass on one image: ``(A, n)`` 64-bit words (n chunks of
    the visit order) whose bit t of word c says that the box at visit
    position i, if kept, suppresses position ``64c + t``; and the chunks'
    valid words.  Only words at or right of a row's own chunk are read."""
    A = cls_id.shape[0]
    n = -(-A // CHUNK)
    b = boxes[order.long()]
    c = cls_id[order.long()]
    valid = c >= 0
    nan = torch.full_like(c, float("nan"))
    key = torch.where(valid, torch.zeros_like(c) if force else c, nan)
    w = (torch.minimum(b[:, None, 2], b[None, :, 2])
         - torch.maximum(b[:, None, 0], b[None, :, 0]))
    h = (torch.minimum(b[:, None, 3], b[None, :, 3])
         - torch.maximum(b[:, None, 1], b[None, :, 1]))
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    # the kernel's shortcut: no positive width or height, no division
    touch = (w > 0) & (h > 0)
    inter = torch.where(touch, w * h, torch.zeros_like(w))
    union = area[:, None] + area[None, :] - inter
    iou = torch.where(union > 0, inter / union, torch.zeros_like(union))
    pos = torch.arange(A)
    hit = (touch & (key[:, None] == key[None, :]) & (iou >= thresh)
           & (pos[None, :] > pos[:, None]) & valid[:, None])
    pad = n * CHUNK - A
    bits = torch.nn.functional.pad(hit, (0, pad)).view(A, n, CHUNK).long()
    words = (bits << torch.arange(CHUNK)).sum(-1)  # distinct bits: an OR
    vbits = torch.nn.functional.pad(valid, (0, pad)).view(n, CHUNK).long()
    vwords = (vbits << torch.arange(CHUNK)).sum(-1)
    u = np.uint64
    return (words.numpy().view(u).astype(object),
            [int(v) for v in vwords.numpy().view(u)])


def _two_pass_nms(boxes, cls_id, order, thresh, force):
    """A torch-CPU model of K7 on one image: the mask words, then the
    scan: TILE chunks a step, each chunk's kept set the fixed point of
    "candidates no kept row of the chunk suppresses", iterated from the
    candidates (as the kernel's warp does), its rows' words for the
    tile's later chunks ORed in, then the tile's kept rows' words right
    of the tile ORed into "removed".  Returns keep (A,)."""
    A = cls_id.shape[0]
    words, valid = _mask_words(boxes, cls_id, order, thresh, force)
    nvc = max([c + 1 for c, v in enumerate(valid) if v], default=0)
    removed = [0] * len(valid)
    keep_pos = np.ones(A, bool)

    def rows_or(rows, c):
        out = 0
        for row in rows:
            out |= int(words[row, c])
        return out

    for c0 in range(0, nvc, TILE):
        nt = min(TILE, nvc - c0)
        rem = removed[c0:c0 + nt]
        kept_rows = []
        for j in range(nt):
            v = valid[c0 + j]
            cand = v & ~rem[j]
            kept, rounds = cand, 0
            while True:
                rows = [(c0 + j) * CHUNK + t for t in range(CHUNK)
                        if (kept >> t) & 1]
                nxt = cand & ~rows_or(rows, c0 + j)
                rounds += 1
                if nxt == kept:
                    break
                kept = nxt
            assert rounds <= CHUNK + 1
            for jj in range(j + 1, nt):
                rem[jj] |= rows_or(rows, c0 + jj)
            kept_rows += rows
            for t in range(CHUNK):
                p = (c0 + j) * CHUNK + t
                if p < A:
                    keep_pos[p] = bool(((kept | ~v) >> t) & 1)
        for c in range(c0 + nt, nvc):
            removed[c] |= rows_or(kept_rows, c)
    keep = np.ones(A, bool)
    keep[order.numpy()] = keep_pos
    return keep


def _nms_image_cases(a, seed, quantized=True):
    """Three images of ``a`` boxes in three classes: ties (boxes on a 1/8
    grid, scores in tenths), a box repeated exactly (IoU 1), invalid boxes
    scored -inf at the tail of the visit order; the second image's valid
    prefix ends mid-chunk, the third has no valid box."""
    rs = np.random.RandomState(seed)
    xy = rs.rand(3, a, 2) * 0.8
    wh = rs.rand(3, a, 2) * 0.3 + 0.02
    if quantized:
        xy, wh = np.round(xy * 8) / 8, np.round(wh * 8) / 8 + 0.125
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    cls = rs.randint(0, 3, (3, a)).astype(np.float32)
    cls[0, rs.rand(a) < 0.2] = -1.0
    if a > 1:
        boxes[:, 1] = boxes[:, 0]
        cls[:, 1] = cls[:, 0]
    score = rs.rand(3, a).astype(np.float32)
    if quantized:
        score = np.round(score, 1).astype(np.float32)
    score[1, :] = np.linspace(1, 0.5, a)
    cls[1, (a * 2) // 3:] = -1.0
    cls[2, :] = -1.0
    score[cls < 0] = -np.inf
    order = np.argsort(-score, axis=1, kind="stable").astype(np.int32)
    return boxes, cls, order


def _two_pass_against_jax(boxes, cls, order, force):
    got = [_two_pass_nms(torch.from_numpy(boxes[b]), torch.from_numpy(cls[b]),
                         torch.from_numpy(order[b]), 0.5, force)
           for b in range(len(cls))]
    with jax.disable_jit():
        for b in range(len(cls)):
            want = np.asarray(jcontrib._greedy_nms(
                jnp.asarray(boxes[b]), jnp.asarray(cls[b]),
                jnp.asarray(order[b]), 0.5, force))
            np.testing.assert_array_equal(got[b], want)
    return got


@pytest.mark.parametrize("a,regime", [(63, "matrix"), (64, "matrix"),
                                      (65, "matrix"), (129, "matrix"),
                                      (520, "streaming")])
@pytest.mark.parametrize("force", [False, True])
def test_two_pass_nms_matches_jax(monkeypatch, a, regime, force):
    """K7's scheme (mask words, then the tiled scan with its fixed-point
    resolve of each chunk) against ``_greedy_nms`` bit for bit: across chunk and tile
    edges, ties, IoU 1, invalid tails, an image with no valid box; in the
    JAX function's matrix regime and in its streaming regime (by a
    lowered ``NMS_MATRIX_MAX_BOXES``)."""
    if regime == "streaming":
        monkeypatch.setattr(jcontrib, "NMS_MATRIX_MAX_BOXES", 8)
    boxes, cls, order = _nms_image_cases(a, a)
    got = _two_pass_against_jax(boxes, cls, order, force)
    suppressed = [(~k & (c >= 0)).sum() for k, c in zip(got, cls)]
    assert suppressed[0] > 0 and suppressed[1] > 0 and got[2].all()


def test_two_pass_nms_matches_jax_above_its_matrix_regime():
    """The same above ``NMS_MATRIX_MAX_BOXES`` (2100 boxes, the JAX
    function streaming its IoU rows by itself): one image, a fifth of it
    invalid at the tail, per class."""
    boxes, cls, order = _nms_image_cases(2100, 7, quantized=False)
    assert 2100 > jcontrib.NMS_MATRIX_MAX_BOXES
    got = _two_pass_against_jax(boxes[:1], cls[:1], order[:1], False)
    assert 0 < (~got[0] & (cls[0] >= 0)).sum() < (cls[0] >= 0).sum()


def test_greedy_nms_routes_by_device():
    """CPU tensors take the plain version; K7 counts no launch."""
    before = nms_kernel.greedy_nms_cuda.launches
    boxes = torch.tensor([[[0, 0, 1, 1], [0, 0, 1, 0.9]]], dtype=torch.float32)
    keep = nms_kernel.greedy_nms(boxes, torch.zeros(1, 2),
                                 torch.tensor([[0, 1]]), 0.5, False)
    assert keep.tolist() == [[True, False]]
    assert nms_kernel.greedy_nms_cuda.launches == before
    with pytest.raises(tmx.MXNetError, match="CUDA"):
        nms_kernel.greedy_nms_cuda(boxes, torch.zeros(1, 2),
                                   torch.tensor([[0, 1]]), 0.5, False)


@pytest.mark.parametrize("thresh", [0.0, -0.5, float("nan")])
def test_k7_refuses_a_threshold_not_above_zero(thresh):
    """K7 decides a pair that does not intersect as below the threshold
    without dividing, which is exact only for a threshold > 0: its wrapper
    refuses any other on every device (the plain loop takes it)."""
    boxes = torch.tensor([[[0, 0, 1, 1], [2, 2, 3, 3]]], dtype=torch.float32)
    with pytest.raises(tmx.MXNetError, match="threshold > 0"):
        nms_kernel.greedy_nms_cuda(boxes, torch.zeros(1, 2),
                                   torch.tensor([[0, 1]]), thresh, False)
    keep = nms_kernel.greedy_nms(boxes, torch.zeros(1, 2),
                                 torch.tensor([[0, 1]]), thresh, False)
    assert keep.shape == (1, 2)


def _params_of(net):
    arg_shapes, _, aux_shapes = net.infer_shape(data=(2, 3, 96, 96),
                                                label=(2, 3, 5))
    return (dict(zip(net.list_arguments(), arg_shapes)),
            dict(zip(net.list_auxiliary_states(), aux_shapes)))


def _nodes(net):
    import json
    return [(n["op"], n["name"]) for n in json.loads(net.tojson())["nodes"]]


def test_ssd_graphs_match_jax():
    """The training and deploy graphs: node names and ops, outputs,
    argument names and shapes equal to the JAX package's."""
    for build in ("get_symbol_train", "get_symbol"):
        # unnamed ops (the broadcast_mul of the scale) count globally
        with jmx.name.NameManager():
            want = getattr(jssd, build)(num_classes=3)
        with tmx.name.NameManager():
            got = getattr(tssd, build)(num_classes=3)
        assert _nodes(got) == _nodes(want)
        assert got.list_outputs() == want.list_outputs()
        assert got.list_arguments() == want.list_arguments()
    g_args, _ = _params_of(tssd.get_symbol_train(num_classes=3))
    w_args, _ = _params_of(jssd.get_symbol_train(num_classes=3))
    assert g_args == w_args
    assert g_args["multibox0_scale"] == (1, 512, 1, 1)
    assert tssd.get_symbol_train().list_outputs() == \
        ["cls_prob_output", "loc_loss_output", "cls_label_output"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_group_graphs_and_checkpoints_cross(tmp_path, writer):
    """A ``Group`` of three heads saved by one package loads in the other
    with the same outputs, internals and attrs; an SSD checkpoint (symbol
    and params, ``multibox0_scale`` among them) too."""
    src, dst = (jmx, tmx) if writer == "jax" else (tmx, jmx)
    a = src.sym.Variable("a")
    g = src.sym.Group([src.sym.FullyConnected(a, num_hidden=3, name="fc"),
                       src.sym.MakeLoss(a, grad_scale=0, name="ml"),
                       a])
    back = dst.sym.load_json(g.tojson())
    assert back.list_outputs() == g.list_outputs() == \
        ["fc_output", "ml_output", "a"]
    assert back.get_internals()["fc_output"].list_outputs() == ["fc_output"]
    assert back.tojson() == g.tojson()
    net = (jssd if writer == "jax" else tssd).get_symbol_train(num_classes=2)
    args, _ = _params_of(net)
    rs = np.random.RandomState(0)
    params = {k: src.nd.array(rs.normal(0, 1, s).astype(np.float32))
              for k, s in args.items() if k not in ("data", "label")}
    prefix = str(tmp_path / "ssd")
    src.model.save_checkpoint(prefix, 1, net, params, {})
    sym, arg, aux = dst.model.load_checkpoint(prefix, 1)
    assert sym.list_outputs() == net.list_outputs()
    assert _nodes(sym) == _nodes(net)
    assert sorted(arg) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(arg[k].asnumpy(), v.asnumpy())


SIZE, BATCH, N = 96, 2, 6


@pytest.fixture(scope="module")
def ssd_init():
    """The JAX package's Xavier weights of the 3-class SSD at 96x96."""
    net = jssd.get_symbol_train(num_classes=3)
    mod = jmx.mod.Module(net, label_names=("label",), context=jmx.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 3, SIZE, SIZE))],
             label_shapes=[("label", (BATCH, 3, 5))])
    jmx.random.seed(3)
    mod.init_params(jmx.init.Xavier())
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _ssd_fit(mx, models, init, data, labels):
    it = mx.io.NDArrayIter({"data": data}, {"label": labels},
                           batch_size=BATCH, label_name="label")
    mod = mx.mod.Module(models.get_symbol_train(num_classes=3),
                        label_names=("label",), context=mx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    arg, aux = init
    if mx is tmx:
        tmx.convert.set_module_params(mod, arg, aux)
    else:
        mod.set_params({k: jmx.nd.array(v) for k, v in arg.items()},
                       {k: jmx.nd.array(v) for k, v in aux.items()})
    metric = models.MultiBoxMetric()
    mod.fit(it, eval_metric=metric, optimizer="sgd",
            optimizer_params={"learning_rate": 0.002, "momentum": 0.9,
                              "wd": 5e-4}, num_epoch=1)
    return ({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
            metric.get(), mod)


def test_synth_detection_set_is_the_examples():
    sys.path.insert(0, EXAMPLE)
    try:
        from train import synth_detection_set
    finally:
        sys.path.remove(EXAMPLE)
    for args in ((4, 96, 3), (3, 64, 20, 2, 9)):
        for got, want in zip(tssd.synth_detection_set(*args),
                             synth_detection_set(*args)):
            assert got.tobytes() == want.tobytes()


def test_ssd_fit_matches_jax(ssd_init, monkeypatch):
    """Three steps of ``train.py``'s fit (SGD lr 0.002, momentum 0.9, wd
    5e-4) at 96x96, b2, from the JAX package's Xavier weights: every
    parameter ``rtol=1e-4, atol=1e-5``, ``MultiBoxMetric``'s values 1e-4;
    ``multibox0_scale`` starts at 20 and takes the full weight decay in
    both (``fit`` does not read ``__wd_mult__``)."""
    monkeypatch.setenv("MXNET_DEVICE_METRIC", "0")
    data, labels = tssd.synth_detection_set(N, SIZE, 3)
    want, want_m, _ = _ssd_fit(jmx, jssd, ssd_init, data, labels)
    got, got_m, mod = _ssd_fit(tmx, tssd, ssd_init, data, labels)
    assert mod._optimizer.num_update == N // BATCH
    assert (ssd_init[0]["multibox0_scale"] == 20).all()
    assert mod._optimizer._get_wd(
        mod._param_names.index("multibox0_scale")) == pytest.approx(5e-4)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert got_m[0] == want_m[0]
    np.testing.assert_allclose(got_m[1], want_m[1], rtol=1e-4)


def _deploy_rows(mx, models, params, data):
    net = models.get_symbol(num_classes=3)
    ex = net.simple_bind(mx.cpu(), data=data.shape)
    for k, v in params.items():
        if k in ex.arg_dict:
            ex.arg_dict[k][:] = v
    ex.arg_dict["data"][:] = data
    return ex.forward(is_train=False)[0].asnumpy()


def test_deploy_rows_match_jax(ssd_init):
    """The deploy graph (SoftmaxActivation, MultiBoxDetection with NMS at
    0.5, force_suppress, top 400) from the same weights: class ids
    exact, scores and boxes 1e-5."""
    data, _ = tssd.synth_detection_set(BATCH, SIZE, 3, seed=99)
    params = dict(ssd_init[0])
    want = _deploy_rows(jmx, jssd, params, data)
    got = _deploy_rows(tmx, tssd, params, data)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=1e-5,
                               atol=1e-5)
    assert ((got[..., 0] >= 0).sum(axis=1) > 0).all()


def test_detector_and_voc_eval_match_the_examples(tmp_path, ssd_init):
    """A checkpoint of the JAX weights through the port's ``Detector``
    (``detect`` and ``im_detect``) and ``eval_detections`` against the
    example's copies over the JAX package: the same kept rows and the
    same APs; ``voc_ap`` in both variants."""
    sys.path.insert(0, EXAMPLE)
    try:
        from detect.detector import Detector as JDetector
        from evaluate.eval_metric import eval_detections as jeval, \
            voc_ap as jvoc_ap
    finally:
        sys.path.remove(EXAMPLE)
    prefix = str(tmp_path / "ssd")
    arg = {k: v for k, v in ssd_init[0].items()
           if k not in ("data", "label")}
    jmx.model.save_checkpoint(prefix, 1,
                              jssd.get_symbol_train(num_classes=3),
                              {k: jmx.nd.array(v) for k, v in arg.items()},
                              {})
    data, labels = tssd.synth_detection_set(4, SIZE, 3, seed=99)
    dets = {}
    for tag, mx, models, det_cls in (
            ("jax", jmx, jssd, JDetector),
            ("torch", tmx, tssd, ssd_detect.Detector)):
        det = det_cls(models.get_symbol(num_classes=3, nms_thresh=0.45),
                      prefix, 1, SIZE, mean_pixels=(0, 0, 0), batch_size=2,
                      ctx=mx.cpu())
        dets[tag] = det.detect(mx.io.NDArrayIter(data=data, batch_size=2))
        images = [d.transpose(1, 2, 0) for d in data[:3]]
        again = det.im_detect(images)
        assert len(again) == 3
        for a, b in zip(again, dets[tag][:3]):
            np.testing.assert_array_equal(a, b)
    for g, w in zip(dets["torch"], dets["jax"]):
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1:], w[:, 1:], rtol=1e-5, atol=1e-5)
    for use_07 in (False, True):
        got = ssd_detect.eval_detections(dets["torch"], list(labels), 3,
                                         use_07_metric=use_07)
        want = jeval(dets["jax"], list(labels), 3, use_07_metric=use_07)
        assert got[0].keys() == want[0].keys()
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    rec = np.array([0.1, 0.4, 0.4, 0.8])
    prec = np.array([1.0, 0.7, 0.5, 0.45])
    for use_07 in (False, True):
        assert ssd_detect.voc_ap(rec, prec, use_07) == jvoc_ap(rec, prec,
                                                               use_07)
