"""SSD detection and VOC evaluation (counterpart of
``example/ssd/detect/detector.py`` and
``example/ssd/evaluate/eval_metric.py``, which import the JAX package):
:class:`Detector` over ``Module.predict`` of the deploy graph
(``ssd_vgg16.get_symbol``), and ``voc_ap``/``eval_detections``, the VOC
matching loop and AP (reference ``example/ssd/evaluate/eval_voc.py``).

``Detector`` runs on the card (``gpu(0)``) unless ``ctx=`` says
otherwise.  Its output rows are ``[cls, score, xmin, ymin, xmax, ymax]``
with ``cls = -1`` where suppressed; ``detect`` keeps the rows with
``cls >= 0``.
"""

from timeit import default_timer as timer

import numpy as np

from ..context import gpu
from ..io import NDArrayIter
from ..model import load_checkpoint
from ..module import Module

__all__ = ["Detector", "voc_ap", "eval_detections"]


class Detector(object):
    """Holds a detection network and wraps the detection API
    (reference ``detect/detector.py:8``)."""

    def __init__(self, symbol, model_prefix, epoch, data_shape, mean_pixels,
                 batch_size=1, ctx=None):
        self.ctx = ctx if ctx is not None else gpu(0)
        _, args, auxs = load_checkpoint(model_prefix, epoch)
        self.mod = Module(symbol, data_names=("data",), label_names=(),
                          context=self.ctx)
        self.data_shape = data_shape
        self.batch_size = batch_size
        self.mod.bind(for_training=False, data_shapes=[
            ("data", (batch_size, 3, data_shape, data_shape))])
        # the deploy graph's params are a subset of the training
        # checkpoint's: any missing key is a real symbol/checkpoint
        # mismatch and should raise, not return garbage detections
        self.mod.set_params(args, auxs)
        self.mean_pixels = mean_pixels

    def detect(self, det_iter, show_timer=False):
        """Detect all images in an iterator; returns one
        ``(n_kept, 6)`` array per image (reference ``detector.py:41``)."""
        start = timer()
        detections = self.mod.predict(det_iter).asnumpy()
        time_elapsed = timer() - start
        if show_timer:
            print("Detection time for {} images: {:.4f} sec".format(
                detections.shape[0], time_elapsed))
        result = []
        for i in range(detections.shape[0]):
            det = detections[i, :, :]
            result.append(det[np.where(det[:, 0] >= 0)[0]])
        return result

    def _preprocess(self, img):
        """HWC uint8/float image -> mean-subtracted CHW float32."""
        img = np.asarray(img, dtype=np.float32)
        if img.shape[0] != self.data_shape or \
                img.shape[1] != self.data_shape:
            raise ValueError("image must be %dx%d (resize upstream)"
                             % (self.data_shape, self.data_shape))
        img = img - np.asarray(self.mean_pixels, np.float32).reshape(1, 1, 3)
        return img.transpose(2, 0, 1)

    def im_detect(self, im_list, show_timer=False):
        """Detect a list of in-memory HWC images (reference
        ``detector.py:73``; images are decoded upstream)."""
        data = np.stack([self._preprocess(im) for im in im_list])
        pad = (-len(data)) % self.batch_size
        if pad:
            data = np.concatenate(
                [data, np.zeros((pad,) + data.shape[1:], data.dtype)])
        it = NDArrayIter(data=data, batch_size=self.batch_size)
        return self.detect(it, show_timer=show_timer)[:len(im_list)]

    def visualize_detection(self, img, dets, classes=(), thresh=0.6):
        """Textual detection dump (the reference plots with matplotlib)."""
        lines = []
        for det in dets:
            cls, score = int(det[0]), float(det[1])
            if score < thresh:
                continue
            name = classes[cls] if classes else str(cls)
            lines.append("%s\t%.3f\t(%.3f, %.3f, %.3f, %.3f)"
                         % ((name, score) + tuple(det[2:6])))
        print("\n".join(lines) if lines else "(no detections >= %.2f)"
              % thresh)
        return lines


def voc_ap(rec, prec, use_07_metric=False):
    """AP from recall/precision points (reference ``eval_voc.py:40-72``)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou(box, boxes):
    """IoU of one box against (n, 4) boxes, all (xmin, ymin, xmax, ymax)."""
    ixmin = np.maximum(boxes[:, 0], box[0])
    iymin = np.maximum(boxes[:, 1], box[1])
    ixmax = np.minimum(boxes[:, 2], box[2])
    iymax = np.minimum(boxes[:, 3], box[3])
    iw = np.maximum(ixmax - ixmin, 0.0)
    ih = np.maximum(iymax - iymin, 0.0)
    inter = iw * ih
    union = ((box[2] - box[0]) * (box[3] - box[1]) +
             (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) -
             inter)
    return inter / np.maximum(union, np.finfo(np.float64).eps)


def eval_detections(detections, labels, num_classes, ovp_thresh=0.5,
                    use_07_metric=False):
    """Per-class AP + mAP.

    detections: list (per image) of (n, 6) arrays
        ``[cls, score, xmin, ymin, xmax, ymax]``.
    labels: list (per image) of (m, 5) arrays ``[cls, xmin, ymin, xmax,
        ymax]``; rows with cls < 0 are padding.
    Returns (aps: dict class->AP, mAP).
    """
    aps = {}
    for c in range(num_classes):
        gts = []
        npos = 0
        for lab in labels:
            lab = np.asarray(lab).reshape(-1, 5)
            boxes = lab[lab[:, 0] == c][:, 1:5]
            gts.append({"boxes": boxes,
                        "matched": np.zeros(len(boxes), bool)})
            npos += len(boxes)
        rows = []
        for img_id, det in enumerate(detections):
            det = np.asarray(det).reshape(-1, 6)
            for row in det[det[:, 0] == c]:
                rows.append((float(row[1]), img_id, row[2:6]))
        if npos == 0:
            aps[c] = float("nan") if not rows else 0.0
            continue
        rows.sort(key=lambda r: -r[0])
        tp = np.zeros(len(rows))
        fp = np.zeros(len(rows))
        for i, (_score, img_id, box) in enumerate(rows):
            gt = gts[img_id]
            if len(gt["boxes"]) == 0:
                fp[i] = 1.0
                continue
            overlaps = _iou(box, gt["boxes"])
            j = int(np.argmax(overlaps))
            if overlaps[j] >= ovp_thresh and not gt["matched"][j]:
                tp[i] = 1.0
                gt["matched"][j] = True
            else:
                fp[i] = 1.0
        tp, fp = np.cumsum(tp), np.cumsum(fp)
        rec = tp / npos
        prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        aps[c] = voc_ap(rec, prec, use_07_metric)
    valid = [v for v in aps.values() if not np.isnan(v)]
    return aps, float(np.mean(valid)) if valid else float("nan")
