"""SSD-VGG16-reduced detector, BASELINE config 4 (counterpart of
``mxnet_tpu/models/ssd_vgg16.py``; reference
``example/ssd/symbol/symbol_vgg16_reduced.py``,
``example/ssd/symbol/common.py:164`` ``multibox_layer`` and
``example/ssd/train/metric.py:5`` ``MultiBoxMetric``), and
:func:`synth_detection_set`, the synthetic detection set that
``example/ssd/train.py`` trains on (byte for byte its arrays).

Topology: VGG16 with fc6/fc7 as convolutions (fc6 dilated 6), the extra
feature pyramid conv8-conv10 and a global pool; 6 prediction scales with
per-scale anchor sizes and ratios.  The training graph is
``MultiBoxTarget`` -> ``SoftmaxOutput`` (valid-normalized, hard negatives
mined, the rest ignored) + ``smooth_l1``/``MakeLoss`` (loc) + a zero-grad
``MakeLoss(cls_target)`` for the metric, as one ``Group``; the deploy
graph ends in ``MultiBoxDetection`` (greedy NMS through kernel K7 on the
card).  Node names and parameter shapes are the JAX package's.
"""

from __future__ import annotations

import numpy as np

from .. import symbol as sym
from ..initializer import Constant
from ..metric import EvalMetric as _EvalMetric

__all__ = ["get_symbol_train", "get_symbol", "multibox_layer",
           "MultiBoxMetric", "synth_detection_set"]


def _conv_act(data, name, num_filter, kernel=(3, 3), pad=(1, 1),
              stride=(1, 1), act_type="relu"):
    conv = sym.Convolution(data=data, kernel=kernel, pad=pad, stride=stride,
                           num_filter=num_filter, name="conv%s" % name)
    return sym.Activation(data=conv, act_type=act_type, name="relu%s" % name)


def _vgg_block(data, idx, n_convs, num_filter, pool_stride=(2, 2),
               pooling_convention="valid"):
    out = data
    for i in range(1, n_convs + 1):
        out = _conv_act(out, "%d_%d" % (idx, i), num_filter)
    pool = sym.Pooling(data=out, pool_type="max", kernel=(2, 2),
                       stride=pool_stride,
                       pooling_convention=pooling_convention,
                       name="pool%d" % idx)
    return out, pool


def multibox_layer(from_layers, num_classes, sizes, ratios, normalization,
                   num_channels, clip=True):
    """Per-scale cls/loc conv heads + anchors (reference
    ``example/ssd/symbol/common.py:164``)."""
    assert num_classes > 0
    num_channels = list(num_channels)
    loc_layers, cls_layers, anchor_layers = [], [], []
    num_label_classes = num_classes + 1  # background = 0
    for k, from_layer in enumerate(from_layers):
        name = "multibox%d" % k
        if normalization[k] > 0:
            from_layer = sym.L2Normalization(data=from_layer,
                                             mode="channel",
                                             name="%s_norm" % name)
            scale = sym.Variable(
                "%s_scale" % name, shape=(1, num_channels.pop(0), 1, 1),
                init=Constant(value=float(normalization[k])), wd_mult=0.1)
            from_layer = sym.broadcast_mul(scale, from_layer)
        num_anchors = len(sizes[k]) + len(ratios[k]) - 1

        loc_pred = sym.Convolution(data=from_layer, kernel=(3, 3),
                                   pad=(1, 1), num_filter=num_anchors * 4,
                                   name="%s_loc_pred_conv" % name)
        loc_pred = sym.transpose(loc_pred, axes=(0, 2, 3, 1))
        loc_layers.append(sym.Flatten(data=loc_pred))

        cls_pred = sym.Convolution(
            data=from_layer, kernel=(3, 3), pad=(1, 1),
            num_filter=num_anchors * num_label_classes,
            name="%s_cls_pred_conv" % name)
        cls_pred = sym.transpose(cls_pred, axes=(0, 2, 3, 1))
        cls_layers.append(sym.Flatten(data=cls_pred))

        anchors = getattr(sym, "_contrib_MultiBoxPrior")(
            from_layer, sizes=tuple(sizes[k]), ratios=tuple(ratios[k]),
            clip=clip, name="%s_anchors" % name)
        anchor_layers.append(sym.Reshape(data=anchors, shape=(0, -1, 4)))

    loc_preds = sym.Concat(*loc_layers, dim=1, name="multibox_loc_pred")
    cls_preds = sym.Concat(*cls_layers, dim=1)
    cls_preds = sym.Reshape(data=cls_preds, shape=(0, -1, num_label_classes))
    cls_preds = sym.transpose(cls_preds, axes=(0, 2, 1),
                              name="multibox_cls_pred")
    anchor_boxes = sym.Concat(*anchor_layers, dim=1,
                              name="multibox_anchors")
    return [loc_preds, cls_preds, anchor_boxes]


def _vgg16_reduced_features(data):
    """VGG16-reduced backbone; returns (relu4_3, relu7, feature pyramid)."""
    _, pool1 = _vgg_block(data, 1, 2, 64)
    _, pool2 = _vgg_block(pool1, 2, 2, 128)
    _, pool3 = _vgg_block(pool2, 3, 3, 256, pooling_convention="full")
    relu4_3, pool4 = _vgg_block(pool3, 4, 3, 512)
    relu5_3, _ = _vgg_block(pool4, 5, 3, 512)
    pool5 = sym.Pooling(data=relu5_3, pool_type="max", kernel=(3, 3),
                        stride=(1, 1), pad=(1, 1), name="pool5")
    # fc6/fc7 as convolutions (fc6 dilated 6 — the "reduced" trick)
    conv6 = sym.Convolution(data=pool5, kernel=(3, 3), pad=(6, 6),
                            dilate=(6, 6), num_filter=1024, name="fc6")
    relu6 = sym.Activation(data=conv6, act_type="relu", name="relu6")
    conv7 = sym.Convolution(data=relu6, kernel=(1, 1), num_filter=1024,
                            name="fc7")
    relu7 = sym.Activation(data=conv7, act_type="relu", name="relu7")

    relu8_1 = _conv_act(relu7, "8_1", 256, kernel=(1, 1), pad=(0, 0))
    relu8_2 = _conv_act(relu8_1, "8_2", 512, stride=(2, 2))
    relu9_1 = _conv_act(relu8_2, "9_1", 128, kernel=(1, 1), pad=(0, 0))
    relu9_2 = _conv_act(relu9_1, "9_2", 256, stride=(2, 2))
    relu10_1 = _conv_act(relu9_2, "10_1", 128, kernel=(1, 1), pad=(0, 0))
    relu10_2 = _conv_act(relu10_1, "10_2", 256, stride=(2, 2))
    pool10 = sym.Pooling(data=relu10_2, pool_type="avg", global_pool=True,
                         kernel=(1, 1), name="pool10")
    return [relu4_3, relu7, relu8_2, relu9_2, relu10_2, pool10]


# per-scale anchor config (reference symbol_vgg16_reduced.py:111-114)
_SIZES = [[.1], [.2, .276], [.38, .461], [.56, .644], [.74, .825],
          [.92, 1.01]]
_RATIOS = [[1, 2, .5]] + [[1, 2, .5, 3, 1. / 3]] * 5
_NORMALIZATIONS = [20, -1, -1, -1, -1, -1]
_NUM_CHANNELS = [512]


def get_symbol_train(num_classes=20, **kwargs):
    """Training graph (reference ``symbol_vgg16_reduced.py:13-144``)."""
    data = sym.Variable("data")
    label = sym.Variable("label")
    from_layers = _vgg16_reduced_features(data)
    loc_preds, cls_preds, anchor_boxes = multibox_layer(
        from_layers, num_classes, _SIZES, _RATIOS, _NORMALIZATIONS,
        _NUM_CHANNELS, clip=True)

    tmp = getattr(sym, "_contrib_MultiBoxTarget")(
        anchor_boxes, label, cls_preds, overlap_threshold=.5,
        ignore_label=-1, negative_mining_ratio=3,
        minimum_negative_samples=0, negative_mining_thresh=.5,
        variances=(0.1, 0.1, 0.2, 0.2), name="multibox_target")
    loc_target, loc_target_mask, cls_target = tmp[0], tmp[1], tmp[2]

    cls_prob = sym.SoftmaxOutput(data=cls_preds, label=cls_target,
                                 ignore_label=-1, use_ignore=True,
                                 grad_scale=3., multi_output=True,
                                 normalization="valid", name="cls_prob")
    loc_loss_ = sym.smooth_l1(data=loc_target_mask * (loc_preds - loc_target),
                              scalar=1.0, name="loc_loss_")
    loc_loss = sym.MakeLoss(loc_loss_, grad_scale=1.,
                            normalization="valid", name="loc_loss")
    cls_label = sym.MakeLoss(data=cls_target, grad_scale=0,
                             name="cls_label")
    return sym.Group([cls_prob, loc_loss, cls_label])


def get_symbol(num_classes=20, nms_thresh=0.5, force_suppress=True,
               nms_topk=400, **kwargs):
    """Deploy graph: shared features + MultiBoxDetection (reference
    ``symbol_vgg16_reduced.py:146-180``)."""
    net = get_symbol_train(num_classes)
    internals = net.get_internals()
    cls_preds = internals["multibox_cls_pred_output"]
    loc_preds = internals["multibox_loc_pred_output"]
    anchor_boxes = internals["multibox_anchors_output"]

    cls_prob = sym.SoftmaxActivation(data=cls_preds, mode="channel",
                                     name="cls_prob")
    return getattr(sym, "_contrib_MultiBoxDetection")(
        cls_prob, loc_preds, anchor_boxes, name="detection",
        nms_threshold=nms_thresh, force_suppress=force_suppress,
        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=nms_topk)


class MultiBoxMetric(_EvalMetric):
    """Cross-entropy + smooth-L1 training metric for the SSD loss group
    (reference ``example/ssd/train/metric.py:5`` — an ``EvalMetric``
    subclass so ``Module.fit(eval_metric=...)`` accepts it)."""

    def __init__(self, eps=1e-8):
        self.eps = eps
        self.name = ["CrossEntropy", "SmoothL1"]
        self.num = len(self.name)
        self.reset()

    def reset(self):
        self.num_inst = [0] * self.num
        self.sum_metric = [0.0] * self.num

    def update(self, labels, preds):
        cls_prob = preds[0].asnumpy()
        loc_loss = preds[1].asnumpy()
        cls_label = preds[2].asnumpy()
        valid_count = np.sum(cls_label >= 0)
        # overall accuracy & object accuracy
        label = cls_label.flatten().astype(np.int64)
        mask = np.where(label >= 0)[0]
        indices = np.int64(label[mask])
        prob = cls_prob.transpose((0, 2, 1)).reshape((-1, cls_prob.shape[1]))
        prob = prob[mask, indices]
        self.sum_metric[0] += (-np.log(prob + self.eps)).sum()
        self.num_inst[0] += valid_count
        # smoothl1loss
        self.sum_metric[1] += np.sum(loc_loss)
        self.num_inst[1] += valid_count

    def get(self):
        names = ["%s" % (self.name[i]) for i in range(self.num)]
        values = [s / max(1, n)
                  for s, n in zip(self.sum_metric, self.num_inst)]
        return names, values


def synth_detection_set(n, size, num_classes, max_gt=3, seed=5):
    """Rectangles of class-specific color on noise; label rows are
    ``(cls, xmin, ymin, xmax, ymax)`` normalized, -1-padded (the arrays of
    ``example/ssd/train.py``'s ``synth_detection_set``, byte for byte)."""
    rs = np.random.RandomState(seed)
    colors = rs.rand(num_classes, 3)
    data = np.empty((n, 3, size, size), np.float32)
    labels = -np.ones((n, max_gt, 5), np.float32)
    for i in range(n):
        img = rs.rand(size, size, 3) * 0.3
        for g in range(rs.randint(1, max_gt + 1)):
            c = rs.randint(0, num_classes)
            w, h = rs.randint(size // 4, size // 2, 2)
            x0 = rs.randint(0, size - w)
            y0 = rs.randint(0, size - h)
            img[y0:y0 + h, x0:x0 + w] = colors[c] * (0.7 + 0.3 * rs.rand())
            labels[i, g] = [c, x0 / size, y0 / size, (x0 + w) / size,
                            (y0 + h) / size]
        data[i] = img.transpose(2, 0, 1)
    return data, labels
