"""Faster R-CNN with the VGG16 backbone (counterpart of
``mxnet_tpu/models/rcnn.py``; reference ``example/rcnn/rcnn/symbol/
symbol_vgg.py``: ``get_vgg_rpn``/``get_vgg_train``/``get_vgg_test``),
built through this package's ``mx.sym`` with the JAX package's layer
names.

``Proposal`` turns the RPN's scores and box deltas into ROIs (greedy NMS
through kernel K7 on the card), ``ROIPooling`` pools conv5_3 over them
(kernels K8/K8b on the card) for the fc6/fc7 head.  ``get_symbol_rpn``
trains the RPN alone; ``get_symbol_train`` adds the per-ROI classification
and box losses on targets given as inputs, with no gradient through
Proposal's inputs (``BlockGrad``); ``get_symbol_test`` is the detection
graph.  The pre/post-NMS top-N are 12000/2000 in training and 6000/300 at
inference.
"""

from .. import symbol as sym


def _vgg_conv_body(data):
    """VGG16 conv1-conv5 (reference ``symbol_vgg.py:get_vgg_conv``)."""
    net = data
    for i, (blocks, filters) in enumerate(
            [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)], start=1):
        for j in range(blocks):
            net = sym.Convolution(net, kernel=(3, 3), pad=(1, 1),
                                  num_filter=filters,
                                  name="conv%d_%d" % (i, j + 1))
            net = sym.Activation(net, act_type="relu",
                                 name="relu%d_%d" % (i, j + 1))
        if i < 5:  # conv5 has no pool before RPN (stride 16 feature map)
            net = sym.Pooling(net, pool_type="max", kernel=(2, 2),
                              stride=(2, 2), name="pool%d" % i)
    return net


def _rpn(conv_feat, num_anchors):
    rpn_conv = sym.Convolution(conv_feat, kernel=(3, 3), pad=(1, 1),
                               num_filter=512, name="rpn_conv_3x3")
    rpn_relu = sym.Activation(rpn_conv, act_type="relu", name="rpn_relu")
    rpn_cls_score = sym.Convolution(rpn_relu, kernel=(1, 1), pad=(0, 0),
                                    num_filter=2 * num_anchors,
                                    name="rpn_cls_score")
    rpn_bbox_pred = sym.Convolution(rpn_relu, kernel=(1, 1), pad=(0, 0),
                                    num_filter=4 * num_anchors,
                                    name="rpn_bbox_pred")
    return rpn_cls_score, rpn_bbox_pred


def _proposal(rpn_cls_score, rpn_bbox_pred, im_info, num_anchors,
              feature_stride, scales, ratios, is_train):
    # softmax over {bg, fg} per anchor then Proposal decode + NMS
    rpn_cls_score_reshape = sym.Reshape(
        rpn_cls_score, shape=(0, 2, -1, 0), name="rpn_cls_score_reshape")
    rpn_cls_act = sym.SoftmaxActivation(
        rpn_cls_score_reshape, mode="channel", name="rpn_cls_act")
    rpn_cls_act_reshape = sym.Reshape(
        rpn_cls_act, shape=(0, 2 * num_anchors, -1, 0),
        name="rpn_cls_act_reshape")
    return sym.Proposal(
        rpn_cls_act_reshape, rpn_bbox_pred, im_info,
        feature_stride=feature_stride, scales=scales, ratios=ratios,
        rpn_pre_nms_top_n=12000 if is_train else 6000,
        rpn_post_nms_top_n=2000 if is_train else 300,
        threshold=0.7, rpn_min_size=16, name="rois")


def get_symbol_rpn(num_anchors=9, **kwargs):
    """RPN-only training graph (reference ``get_vgg_rpn``)."""
    data = sym.Variable("data")
    label = sym.Variable("label")
    bbox_target = sym.Variable("bbox_target")
    bbox_weight = sym.Variable("bbox_weight")
    conv_feat = _vgg_conv_body(data)
    rpn_cls_score, rpn_bbox_pred = _rpn(conv_feat, num_anchors)
    rpn_cls_score_reshape = sym.Reshape(
        rpn_cls_score, shape=(0, 2, -1), name="rpn_cls_score_reshape")
    cls_prob = sym.SoftmaxOutput(rpn_cls_score_reshape, label,
                                 multi_output=True, use_ignore=True,
                                 ignore_label=-1, name="cls_prob")
    bbox_loss_ = bbox_weight * sym.smooth_l1(rpn_bbox_pred - bbox_target,
                                             scalar=3.0,
                                             name="bbox_loss_smooth")
    bbox_loss = sym.MakeLoss(bbox_loss_, grad_scale=1.0 / 256,
                             name="bbox_loss")
    return sym.Group([cls_prob, bbox_loss])


def get_symbol_test(num_classes=21, num_anchors=9, feature_stride=16,
                    scales=(8, 16, 32), ratios=(0.5, 1, 2), **kwargs):
    """Detection inference graph (reference ``get_vgg_test``)."""
    data = sym.Variable("data")
    im_info = sym.Variable("im_info")
    conv_feat = _vgg_conv_body(data)
    rpn_cls_score, rpn_bbox_pred = _rpn(conv_feat, num_anchors)
    rois = _proposal(rpn_cls_score, rpn_bbox_pred, im_info, num_anchors,
                     feature_stride, scales, ratios, is_train=False)
    pool5 = sym.ROIPooling(conv_feat, rois, pooled_size=(7, 7),
                           spatial_scale=1.0 / feature_stride, name="roi_pool5")
    flat = sym.Flatten(pool5, name="flatten")
    fc6 = sym.FullyConnected(flat, num_hidden=4096, name="fc6")
    relu6 = sym.Activation(fc6, act_type="relu", name="relu6")
    fc7 = sym.FullyConnected(relu6, num_hidden=4096, name="fc7")
    relu7 = sym.Activation(fc7, act_type="relu", name="relu7")
    cls_score = sym.FullyConnected(relu7, num_hidden=num_classes,
                                   name="cls_score")
    cls_prob = sym.SoftmaxActivation(cls_score, name="cls_prob")
    bbox_pred = sym.FullyConnected(relu7, num_hidden=num_classes * 4,
                                   name="bbox_pred")
    return sym.Group([rois, cls_prob, bbox_pred])


def get_symbol_train(num_classes=21, num_anchors=9, feature_stride=16,
                     scales=(8, 16, 32), ratios=(0.5, 1, 2), **kwargs):
    """End-to-end training graph on precomputed ROI targets (reference
    ``get_vgg_train``): RPN losses + per-ROI head losses."""
    data = sym.Variable("data")
    im_info = sym.Variable("im_info")
    rpn_label = sym.Variable("label")
    rpn_bbox_target = sym.Variable("bbox_target")
    rpn_bbox_weight = sym.Variable("bbox_weight")
    roi_label = sym.Variable("roi_label")
    roi_bbox_target = sym.Variable("roi_bbox_target")
    roi_bbox_weight = sym.Variable("roi_bbox_weight")

    conv_feat = _vgg_conv_body(data)
    rpn_cls_score, rpn_bbox_pred = _rpn(conv_feat, num_anchors)

    # RPN losses
    rpn_cls_score_reshape = sym.Reshape(
        rpn_cls_score, shape=(0, 2, -1), name="rpn_cls_score_reshape")
    rpn_cls_prob = sym.SoftmaxOutput(
        rpn_cls_score_reshape, rpn_label, multi_output=True, use_ignore=True,
        ignore_label=-1, name="rpn_cls_prob")
    rpn_bbox_loss_ = rpn_bbox_weight * sym.smooth_l1(
        rpn_bbox_pred - rpn_bbox_target, scalar=3.0, name="rpn_loss_smooth")
    rpn_bbox_loss = sym.MakeLoss(rpn_bbox_loss_, grad_scale=1.0 / 256,
                                 name="rpn_bbox_loss")

    # region proposals (no gradient through the decode, like the reference)
    rois = _proposal(sym.BlockGrad(rpn_cls_score),
                     sym.BlockGrad(rpn_bbox_pred), im_info, num_anchors,
                     feature_stride, scales, ratios, is_train=True)

    # per-ROI head losses
    pool5 = sym.ROIPooling(conv_feat, rois, pooled_size=(7, 7),
                           spatial_scale=1.0 / feature_stride,
                           name="roi_pool5")
    flat = sym.Flatten(pool5, name="flatten")
    fc6 = sym.FullyConnected(flat, num_hidden=4096, name="fc6")
    relu6 = sym.Activation(fc6, act_type="relu", name="relu6")
    fc7 = sym.FullyConnected(relu6, num_hidden=4096, name="fc7")
    relu7 = sym.Activation(fc7, act_type="relu", name="relu7")
    cls_score = sym.FullyConnected(relu7, num_hidden=num_classes,
                                   name="cls_score")
    cls_prob = sym.SoftmaxOutput(cls_score, roi_label, name="cls_prob")
    bbox_pred = sym.FullyConnected(relu7, num_hidden=num_classes * 4,
                                   name="bbox_pred")
    bbox_loss_ = roi_bbox_weight * sym.smooth_l1(
        bbox_pred - roi_bbox_target, scalar=1.0, name="bbox_loss_smooth")
    bbox_loss = sym.MakeLoss(bbox_loss_, grad_scale=1.0 / 128,
                             name="bbox_loss")
    return sym.Group([rpn_cls_prob, rpn_bbox_loss, cls_prob, bbox_loss])
