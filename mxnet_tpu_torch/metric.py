"""Evaluation metrics (``mx.metric``), counterpart of
``mxnet_tpu/metric.py``: the host path of :class:`EvalMetric`,
:class:`CompositeEvalMetric`, :class:`Accuracy`, :class:`TopKAccuracy`,
:class:`CrossEntropy`, :class:`Perplexity` and :func:`create`.  Each
``update`` copies the batch's labels and predictions to the host (one
device-to-host copy per batch) and accumulates Python floats, as the JAX
package's host path does.
"""

from __future__ import annotations

import numpy as _np
import torch

from .base import Registry
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "CrossEntropy", "Perplexity", "create", "check_label_shapes"]

registry = Registry("metric")


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError("Shape of labels %s does not match shape of "
                         "predictions %s" % (label_shape, pred_shape))


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return _np.asarray(x)


class EvalMetric:
    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num

    def get(self):
        if self.num is None:
            value = self.sum_metric / self.num_inst if self.num_inst != 0 \
                else float("nan")
            return (self.name, value)
        names = ["%s_%d" % (self.name, i) for i in range(self.num)]
        values = [s / n if n != 0 else float("nan")
                  for s, n in zip(self.sum_metric, self.num_inst)]
        return (names, values)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


@registry.register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name)
        self.metrics = [create(m) if isinstance(m, str) else m
                        for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str)
                            else metric)

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, results = [], []
        for metric in self.metrics:
            name, result = metric.get()
            (names.extend if isinstance(name, list) else names.append)(name)
            (results.extend if isinstance(result, list)
             else results.append)(result)
        return (names, results)


@registry.register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, **kwargs):
        super().__init__("accuracy")
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            p = _as_np(pred_label)
            if p.ndim > 1 and p.shape[-1] > 1:
                p = _np.argmax(p, axis=self.axis if p.ndim > self.axis
                               else -1)
            lab = _as_np(label).astype("int32").flatten()
            p = p.astype("int32").flatten()
            check_label_shapes(lab, p, shape=1)
            self.sum_metric += float((p == lab).sum())
            self.num_inst += len(p)


@registry.register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, **kwargs):
        super().__init__("top_k_accuracy")
        self.top_k = top_k
        assert self.top_k > 1, "Use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            p = _np.argsort(_as_np(pred_label).astype("float32"), axis=1)
            lab = _as_np(label).astype("int32")
            num_samples, num_classes = p.shape[0], p.shape[1]
            for j in range(min(num_classes, self.top_k)):
                self.sum_metric += float(
                    (p[:, num_classes - 1 - j].flatten()
                     == lab.flatten()).sum())
            self.num_inst += num_samples


@registry.register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-8, **kwargs):
        super().__init__("cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_np(label).ravel()
            pred = _as_np(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[_np.arange(label.shape[0]), _np.int64(label)]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@registry.register
class Perplexity(EvalMetric):
    """exp of the mean negative log-likelihood of the labels, tokens equal
    to ``ignore_label`` left out.  Like the JAX package, ``get`` returns
    the token-weighted mean of the per-batch perplexities."""

    def __init__(self, ignore_label=None, axis=-1):
        super().__init__("Perplexity")
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_np(label)
            pred = _as_np(pred)
            assert label.size == pred.size / pred.shape[-1], \
                "shape mismatch: %s vs. %s" % (label.shape, pred.shape)
            label = label.reshape((label.size,)).astype("int32")
            probs = pred.reshape(-1, pred.shape[-1])[
                _np.arange(label.size), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(probs.dtype)
                num -= int(ignore.sum())
                probs = probs * (1 - ignore) + ignore
            loss -= float(_np.sum(_np.log(_np.maximum(1e-10, probs))))
            num += label.size
        self.sum_metric += float(_np.exp(loss / num)) * num
        self.num_inst += num


def create(metric, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, **kwargs))
        return composite
    metric = str(metric).lower()
    metric = {"acc": "accuracy", "ce": "crossentropy",
              "top_k_accuracy": "topkaccuracy",
              "cross-entropy": "crossentropy"}.get(metric, metric)
    return registry.create(metric, **kwargs)
