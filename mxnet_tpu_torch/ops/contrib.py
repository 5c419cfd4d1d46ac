"""The detection ops (counterpart of ``mxnet_tpu/ops/contrib.py``): SSD's
``_contrib_MultiBoxPrior``, ``_contrib_MultiBoxTarget`` and
``_contrib_MultiBoxDetection``, and Faster R-CNN's ``_contrib_Proposal``.

Everything is static-shape and batched, as in the JAX package, and built
from torch ops as XLA lowers them there, apart from greedy NMS, which is
kernel K7 on the card (``ops/nms_kernel.py``).  MultiBoxTarget and
Proposal read nothing back to the host (no ``.item()``, ``nonzero`` or
boolean-mask indexing), so a training step through them can be captured
as a CUDA graph (``Executor.train_sgd``).  Every argsort is stable, as
``jnp.argsort`` is: ties (the ``-inf`` of non-candidates, equal
probabilities) keep index order.  The one-hot selection of the JAX
package (a matmul at HIGHEST precision, ``contrib.py:189-195``) is a
gather here: both pick the label's values exactly.

The JAX package's float semantics of the overlap threshold are kept
(``contrib.py:13-16``: an anchor joins a ground truth when its best IoU
exceeds the threshold, where the reference truncated IoUs to int).
"""

from __future__ import annotations

import ast
import math

import numpy as np
import torch

from .nms_kernel import greedy_nms, iou_matrix
from .registry import pbool, pfloat, pint, register


def _pftuple(v):
    """Tuple-of-floats attr parser."""
    if isinstance(v, str):
        v = ast.literal_eval(v.strip())
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


def _meta(x):
    return x.device.type == "meta"


# ---------------------------------------------------------------------------
# MultiBoxPrior: anchors over the feature-map grid.  They depend on the
# input's shape only, so each (shape, attrs, device) is computed once.
# ---------------------------------------------------------------------------
_anchor_cache = {}


def _anchors(h, w, sizes, ratios, clip, device):
    cy = (torch.arange(h, dtype=torch.float32) + 0.5) / h
    cx = (torch.arange(w, dtype=torch.float32) + 0.5) / w
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    half = [(s / 2.0, s / 2.0) for s in sizes]
    for r in ratios[1:]:
        sr = float(math.sqrt(r))
        half.append((sizes[0] * sr / 2.0, sizes[0] / sr / 2.0))
    hw = torch.tensor(half, dtype=torch.float32)  # (K, 2) = (w/2, h/2)
    boxes = torch.stack([gx[:, :, None] - hw[None, None, :, 0],
                         gy[:, :, None] - hw[None, None, :, 1],
                         gx[:, :, None] + hw[None, None, :, 0],
                         gy[:, :, None] + hw[None, None, :, 1]], dim=-1)
    out = boxes.reshape(1, -1, 4)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out.to(device)


def _multibox_prior(attrs, inputs, aux, is_train):
    data = inputs[0]
    h, w = data.shape[2], data.shape[3]
    sizes, ratios = attrs["sizes"], attrs["ratios"]
    n = h * w * (len(sizes) + len(ratios) - 1)
    if _meta(data):
        return [torch.empty((1, n, 4), dtype=torch.float32, device="meta")]
    key = (h, w, sizes, ratios, attrs["clip"], str(data.device))
    out = _anchor_cache.get(key)
    if out is None:
        out = _anchor_cache[key] = _anchors(h, w, sizes, ratios,
                                            attrs["clip"], data.device)
    return [out]


register("_contrib_MultiBoxPrior", _multibox_prior,
         params={"sizes": (_pftuple, (1.0,)), "ratios": (_pftuple, (1.0,)),
                 "clip": (pbool, False)},
         aliases=("MultiBoxPrior",), hint="multiboxprior")


# ---------------------------------------------------------------------------
# MultiBoxTarget: matching, target encoding and hard-negative mining.
# ---------------------------------------------------------------------------
def _encode_loc(anchors, gt):
    """anchors (A, 4), gt (B, A, 4) matched corner boxes -> (B, A, 4)."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    return torch.stack([(gx - ax) / aw, (gy - ay) / ah,
                        torch.log(torch.clamp(gw / aw, min=1e-12)),
                        torch.log(torch.clamp(gh / ah, min=1e-12))], dim=-1)


_var_cache = {}


def _variances(variances, device):
    """The variances as a tensor on ``device``, made once: dividing by a
    device tensor divides as the CPU does (a host scalar divides through
    its reciprocal on the card), and a captured step copies nothing from
    the host."""
    key = (tuple(variances), str(device))
    t = _var_cache.get(key)
    if t is None:
        t = _var_cache[key] = torch.tensor(variances, dtype=torch.float32,
                                           device=device)
    return t


def _inverse_permutation(order):
    """rank[b, order[b, i]] = i."""
    B, A = order.shape
    return torch.empty_like(order).scatter_(
        1, order, torch.arange(A, device=order.device).expand(B, A))


def multibox_target(anchors, labels, cls_preds, overlap_threshold,
                    ignore_label, negative_mining_ratio,
                    negative_mining_thresh, minimum_negative_samples,
                    variances):
    """``(loc_target (B, 4A), loc_mask (B, 4A), cls_target (B, A))`` of
    ``anchors (A, 4)``, ``labels (B, G, 5)`` rows ``[cls, x1, y1, x2,
    y2]`` padded with -1 and raw scores ``cls_preds (B, C, A)``."""
    B, G = labels.shape[:2]
    A = anchors.shape[0]
    dev = labels.device
    valid = labels[:, :, 0] >= 0  # (B, G)
    iou = iou_matrix(anchors, labels[:, :, 1:5])  # (B, A, G)
    iou = torch.where(valid[:, None, :], iou, torch.zeros((), device=dev))

    # greedy bipartite matching: G steps, each the best remaining
    # (anchor, GT) pair of every image (first in row-major order on ties)
    a_idx = torch.arange(A, device=dev)
    g_idx = torch.arange(G, device=dev)
    matched = torch.full((B, A), -1, dtype=torch.int64, device=dev)
    anchor_pos = torch.zeros((B, A), dtype=torch.bool, device=dev)
    gt_done = ~valid
    neg_one = torch.full((), -1.0, device=dev)
    for _ in range(G):
        m = torch.where(anchor_pos[:, :, None] | gt_done[:, None, :],
                        neg_one, iou)
        flat = torch.argmax(m.reshape(B, -1), dim=1)
        aj, gk = flat // G, flat % G
        ok = m.reshape(B, -1).gather(1, flat[:, None])[:, 0] > 1e-6
        hit_a = ok[:, None] & (a_idx[None, :] == aj[:, None])
        matched = torch.where(hit_a, gk[:, None], matched)
        anchor_pos = anchor_pos | hit_a
        gt_done = gt_done | (ok[:, None] & (g_idx[None, :] == gk[:, None]))

    # threshold matching for the rest (float semantics)
    best_iou, best_gt = torch.max(iou, dim=2)
    has_gt = valid.any(dim=1)[:, None]  # (B, 1)
    thr_pos = (~anchor_pos) & (best_iou > overlap_threshold) & has_gt \
        if overlap_threshold > 0 else torch.zeros_like(anchor_pos)
    matched = torch.where(anchor_pos, matched,
                          torch.where(thr_pos, best_gt,
                                      torch.full((), -1, device=dev)))
    pos = anchor_pos | thr_pos
    num_pos = pos.sum(dim=1)

    if negative_mining_ratio > 0:
        prob = torch.softmax(cls_preds.transpose(1, 2), dim=-1)  # (B, A, C)
        fg_score = prob[:, :, 1:].max(dim=-1).values
        cand = (~pos) & (best_iou < negative_mining_thresh) & has_gt
        want = torch.clamp(
            (num_pos.to(torch.float32) * negative_mining_ratio)
            .to(torch.int64), min=minimum_negative_samples)
        num_neg = torch.minimum(want, cand.sum(dim=1))
        score = torch.where(cand, fg_score,
                            torch.full((), -math.inf, device=dev))
        order = torch.argsort(-score, dim=1, stable=True)
        rank = _inverse_permutation(order)
        neg = cand & (rank < num_neg[:, None])
    else:
        neg = (~pos) & has_gt
    # an image without ground truth: every anchor is background
    neg = torch.where(has_gt, neg, torch.ones((), dtype=torch.bool,
                                              device=dev))

    safe = torch.clamp(matched, 0, G - 1)
    gt_rows = labels.gather(1, safe[:, :, None].expand(B, A, 5))
    cls_target = torch.where(
        pos, gt_rows[:, :, 0] + 1.0,
        torch.where(neg, torch.zeros((), device=dev),
                    torch.full((), float(ignore_label), device=dev)))
    loc = _encode_loc(anchors, gt_rows[:, :, 1:5]) / _variances(variances,
                                                                 dev)
    mask4 = pos[:, :, None].expand(B, A, 4).reshape(B, 4 * A).to(loc.dtype)
    return loc.reshape(B, -1) * mask4, mask4, cls_target


def _multibox_target(attrs, inputs, aux, is_train):
    anchors, labels, cls_preds = inputs
    B, A = labels.shape[0], anchors.shape[1]
    if _meta(labels) or _meta(cls_preds):
        return [torch.empty((B, 4 * A), device="meta"),
                torch.empty((B, 4 * A), device="meta"),
                torch.empty((B, A), device="meta")]
    # no gradient reaches a parameter through the targets (anchors and
    # labels are not parameters; cls_preds enter only through argsort)
    with torch.no_grad():
        return list(multibox_target(
            anchors.reshape(-1, 4).detach(), labels.detach(),
            cls_preds.detach(), attrs["overlap_threshold"],
            attrs["ignore_label"], attrs["negative_mining_ratio"],
            attrs["negative_mining_thresh"],
            attrs["minimum_negative_samples"], attrs["variances"]))


register("_contrib_MultiBoxTarget", _multibox_target,
         arguments=("anchor", "label", "cls_pred"),
         outputs=("loc_target", "loc_mask", "cls_target"),
         params={"overlap_threshold": (pfloat, 0.5),
                 "ignore_label": (pfloat, -1.0),
                 "negative_mining_ratio": (pfloat, -1.0),
                 "negative_mining_thresh": (pfloat, 0.5),
                 "minimum_negative_samples": (pint, 0),
                 "variances": (_pftuple, (0.1, 0.1, 0.2, 0.2))},
         aliases=("MultiBoxTarget",), hint="multiboxtarget")


# ---------------------------------------------------------------------------
# MultiBoxDetection: decode, threshold, greedy NMS (K7), top-k; rows
# [cls_id, score, x1, y1, x2, y2] sorted by score, cls_id -1 where
# suppressed or invalid.
# ---------------------------------------------------------------------------
def _decode_boxes(anchors, loc_pred, var, clip):
    """anchors (A, 4), loc_pred (B, 4A) -> (B, A, 4) corner boxes."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    p = loc_pred.reshape(loc_pred.shape[0], -1, 4)
    ox = p[..., 0] * var[0] * aw + ax
    oy = p[..., 1] * var[1] * ah + ay
    ow = torch.exp(p[..., 2] * var[2]) * aw * 0.5
    oh = torch.exp(p[..., 3] * var[3]) * ah * 0.5
    out = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def nms_inputs(cls_prob, loc_pred, anchors, clip, threshold, variances):
    """``(score, cid, boxes, order)`` of MultiBoxDetection before NMS:
    each anchor's best foreground probability and class (-1 below
    ``threshold``), its decoded box, and the stable visit order by
    score."""
    dev = cls_prob.device
    score, cid = torch.max(cls_prob[:, 1:], dim=1)
    keep = score >= threshold
    cid = torch.where(keep, cid.to(torch.float32),
                      torch.full((), -1.0, device=dev))
    boxes = _decode_boxes(anchors, loc_pred, variances, clip)
    order = torch.argsort(
        -torch.where(keep, score, torch.full((), -math.inf, device=dev)),
        dim=1, stable=True)
    return score, cid, boxes, order


def multibox_detection(cls_prob, loc_pred, anchors, clip, threshold,
                       nms_threshold, force_suppress, variances, nms_topk,
                       nms=greedy_nms):
    """``(B, A, 6)`` detection rows of class probabilities ``cls_prob (B,
    C, A)`` (class 0 the background), ``loc_pred (B, 4A)`` and ``anchors
    (A, 4)``; NMS through ``nms`` (:func:`~.nms_kernel.greedy_nms`)."""
    minus = torch.full((), -1.0, device=cls_prob.device)
    score, cid, boxes, order = nms_inputs(cls_prob, loc_pred, anchors, clip,
                                          threshold, variances)
    if 0 < nms_threshold <= 1:
        kmask = nms(boxes, cid, order, nms_threshold, force_suppress)
        cid = torch.where(kmask, cid, minus)
    rows = torch.cat([cid[..., None], score[..., None], boxes], dim=-1)
    rows = rows.gather(1, order[:, :, None].expand(rows.shape))
    if nms_topk > 0:
        # rank < topk: the first nms_topk rows of the sorted output
        ranks = torch.arange(rows.shape[1], device=rows.device)[None, :]
        rows[..., 0] = torch.where(ranks < nms_topk, rows[..., 0], minus)
    return rows


def _multibox_detection(attrs, inputs, aux, is_train):
    cls_prob, loc_pred, anchors = inputs
    if _meta(cls_prob):
        return [torch.empty((cls_prob.shape[0], cls_prob.shape[2], 6),
                            device="meta")]
    with torch.no_grad():
        return [multibox_detection(
            cls_prob, loc_pred, anchors.reshape(-1, 4), attrs["clip"],
            attrs["threshold"], attrs["nms_threshold"],
            attrs["force_suppress"], attrs["variances"], attrs["nms_topk"])]


register("_contrib_MultiBoxDetection", _multibox_detection,
         arguments=("cls_prob", "loc_pred", "anchor"),
         params={"clip": (pbool, True), "threshold": (pfloat, 0.01),
                 "background_id": (pint, 0),
                 "nms_threshold": (pfloat, 0.5),
                 "force_suppress": (pbool, False),
                 "variances": (_pftuple, (0.1, 0.1, 0.2, 0.2)),
                 "nms_topk": (pint, -1)},
         aliases=("MultiBoxDetection",), hint="multiboxdetection")


# ---------------------------------------------------------------------------
# Proposal: Faster R-CNN's RPN proposals (``proposal.cc``): anchors at
# feature_stride, box-delta decode, clip to the image, min-size filter,
# pre-NMS top-N, greedy NMS (K7), post-NMS top-N rois.
# ---------------------------------------------------------------------------
def gen_base_anchors(base_size, scales, ratios):
    """The RPN base anchors around (0, 0, base - 1, base - 1), in float64
    with Python's ``round`` and then cast, as
    ``mxnet_tpu/ops/contrib.py:317-331`` makes them."""
    out = []
    w = h = float(base_size)
    cx = (w - 1) * 0.5
    cy = (h - 1) * 0.5
    size = w * h
    for r in ratios:
        ws = round(np.sqrt(size / r))
        hs = round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            out.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                        cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return np.asarray(out, np.float32)


_base_cache = {}


def _rpn_anchors(h, w, stride, scales, ratios, device):
    """(H*W*K, 4) anchors of an h x w map, made once per shape and device."""
    key = (h, w, stride, scales, ratios, str(device))
    out = _base_cache.get(key)
    if out is None:
        base = torch.from_numpy(gen_base_anchors(stride, scales, ratios))
        sy = torch.arange(h, dtype=torch.float32) * stride
        sx = torch.arange(w, dtype=torch.float32) * stride
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        shift = torch.stack([gx, gy, gx, gy], dim=-1)  # (H, W, 4)
        out = _base_cache[key] = (shift[:, :, None, :] + base[None, None]) \
            .reshape(-1, 4).to(device)
    return out


def _decode_rpn(anchors, d, info):
    """Deltas ``d (B, A, 4)`` on ``anchors (A, 4)`` -> corner boxes ``(B, A,
    4)`` with the reference's +1 widths, clipped to each image of
    ``info (B, 3)`` = [height, width, scale]."""
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + aw * 0.5
    ay = anchors[:, 1] + ah * 0.5
    cx = d[..., 0] * aw + ax
    cy = d[..., 1] * ah + ay
    w = torch.exp(torch.clamp(d[..., 2], -10, 10)) * aw
    h = torch.exp(torch.clamp(d[..., 3], -10, 10)) * ah
    zero = torch.zeros((), device=d.device)
    imw = info[:, 1, None] - 1.0
    imh = info[:, 0, None] - 1.0
    return torch.stack([
        torch.minimum(torch.maximum(cx - 0.5 * w, zero), imw),
        torch.minimum(torch.maximum(cy - 0.5 * h, zero), imh),
        torch.minimum(torch.maximum(cx + 0.5 * w - 1.0, zero), imw),
        torch.minimum(torch.maximum(cy + 0.5 * h - 1.0, zero), imh)], dim=-1)


def proposal(cls_prob, bbox_pred, im_info, feature_stride, scales, ratios,
             pre_n, post_n, nms_thresh, min_size, nms=greedy_nms):
    """``(rois (B*post_n, 5), scores (B*post_n, 1))`` of the RPN's
    ``cls_prob (B, 2K, H, W)`` (background then foreground),
    ``bbox_pred (B, 4K, H, W)`` and ``im_info (B, 3)``; NMS through
    ``nms`` (:func:`~.nms_kernel.greedy_nms`).  Rows past the kept boxes
    repeat the first proposal.  Nothing is read back to the host."""
    B, _, H, W = cls_prob.shape
    dev = cls_prob.device
    anchors = _rpn_anchors(H, W, feature_stride, scales, ratios, dev)
    K = anchors.shape[0] // (H * W)
    A = anchors.shape[0]
    fg = cls_prob[:, K:].permute(0, 2, 3, 1).reshape(B, -1)  # (B, H*W*K)
    d = bbox_pred.reshape(B, K, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(B, -1, 4)
    boxes = _decode_rpn(anchors, d, im_info)
    ms = min_size * im_info[:, 2, None]
    ok = ((boxes[..., 2] - boxes[..., 0] + 1.0) >= ms) & \
        ((boxes[..., 3] - boxes[..., 1] + 1.0) >= ms)
    score = torch.where(ok, fg, torch.full((), -math.inf, device=dev))
    n_pre = min(pre_n, A) if pre_n > 0 else A
    # lax.top_k's order: descending, the lower index first among equals
    top_score, top_idx = torch.sort(score, dim=1, descending=True,
                                    stable=True)
    top_score, top_idx = top_score[:, :n_pre], top_idx[:, :n_pre]
    top_boxes = boxes.gather(1, top_idx[:, :, None].expand(B, n_pre, 4))
    finite = torch.isfinite(top_score)
    cls0 = torch.where(finite, torch.zeros((), device=dev),
                       torch.full((), -1.0, device=dev))
    pos = torch.arange(n_pre, device=dev).expand(B, n_pre)
    kmask = nms(top_boxes, cls0, pos, nms_thresh, True) & finite
    # the kept rows first, in visit order (a stable sort of a key)
    sel = torch.argsort(torch.where(kmask, pos, n_pre + pos), dim=1)
    if n_pre >= post_n:
        sel = sel[:, :post_n]
    else:
        sel = torch.cat([sel, torch.zeros((B, post_n - n_pre),
                                          dtype=sel.dtype, device=dev)], 1)
    out_boxes = top_boxes.gather(1, sel[:, :, None].expand(B, post_n, 4))
    s = top_score.gather(1, sel)
    out_score = torch.where(torch.isfinite(s), s, torch.zeros((), device=dev))
    filled = torch.arange(post_n, device=dev)[None, :] \
        < kmask.sum(dim=1, keepdim=True)
    out_boxes = torch.where(filled[..., None], out_boxes, out_boxes[:, :1])
    out_score = torch.where(filled, out_score, out_score[:, :1])
    bidx = torch.arange(B, dtype=out_boxes.dtype, device=dev)[:, None, None] \
        .expand(B, post_n, 1)
    rois = torch.cat([bidx, out_boxes], dim=-1).reshape(B * post_n, 5)
    return rois, out_score.reshape(B * post_n, 1)


def _proposal(attrs, inputs, aux, is_train):
    cls_prob, bbox_pred, im_info = inputs
    rows = cls_prob.shape[0] * attrs["rpn_post_nms_top_n"]
    if _meta(cls_prob):
        outs = [torch.empty((rows, 5), device="meta"),
                torch.empty((rows, 1), device="meta")]
    else:
        # the reference declares no backward: no gradient, as the JAX
        # package's stop_gradient; iou_loss is ignored there too
        with torch.no_grad():
            outs = list(proposal(
                cls_prob.detach(), bbox_pred.detach(), im_info.detach(),
                attrs["feature_stride"], attrs["scales"], attrs["ratios"],
                attrs["rpn_pre_nms_top_n"], attrs["rpn_post_nms_top_n"],
                attrs["threshold"], attrs["rpn_min_size"]))
    return outs if attrs["output_score"] else outs[:1]


register("_contrib_Proposal", _proposal,
         arguments=("cls_prob", "bbox_pred", "im_info"),
         outputs=lambda a: (["output", "score"] if a["output_score"]
                            else ["output"]),
         params={"rpn_pre_nms_top_n": (pint, 6000),
                 "rpn_post_nms_top_n": (pint, 300),
                 "threshold": (pfloat, 0.7), "rpn_min_size": (pint, 16),
                 "scales": (_pftuple, (4.0, 8.0, 16.0, 32.0)),
                 "ratios": (_pftuple, (0.5, 1.0, 2.0)),
                 "feature_stride": (pint, 16),
                 "output_score": (pbool, False),
                 "iou_loss": (pbool, False)},
         aliases=("Proposal",), hint="proposal")
