"""Evaluation metrics (``mx.metric``), counterpart of
``mxnet_tpu/metric.py``: :class:`EvalMetric`, :class:`CompositeEvalMetric`,
:class:`Accuracy`, :class:`TopKAccuracy`, :class:`CrossEntropy`,
:class:`Perplexity`, :func:`create`, and the device path of the sync-free
``Module.fit``: :class:`DeviceMetric`, :func:`as_device`,
:func:`device_capable` and :func:`device_enabled`.

The host path: each ``update`` copies the batch's labels and predictions
to the host (one device-to-host copy per batch) and accumulates Python
floats.  The device path: a :class:`DeviceMetric` queues each leaf
metric's ``_device_batch_stats`` (torch ops on the outputs' device and
stream) into a float32 ``(n_leaves, 2)`` accumulator and returns without
a host sync; reading the metric is the sync point.  Accuracy, top-k and
cross-entropy have a device path; ``Perplexity`` stays on the host, as in
the JAX package.  ``get_state``/``set_state`` carry a metric's sums
across a mid-epoch resume.
"""

from __future__ import annotations

import os as _os

import numpy as _np
import torch

from .base import MXNetError, Registry
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "CrossEntropy", "Perplexity", "DeviceMetric", "as_device",
           "device_capable", "device_enabled", "create",
           "check_label_shapes"]

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

    # -- state (exact mid-epoch resume) ------------------------------------
    def get_state(self):
        """JSON-able sums for a mid-epoch snapshot: :meth:`set_state` of
        them after a reset, then the rest of the epoch, gives the value of
        an uninterrupted epoch.  numpy scalars become Python numbers."""
        def _py(v):
            if isinstance(v, list):
                return [_py(x) for x in v]
            return v.item() if hasattr(v, "item") else v

        return {"sum_metric": _py(self.sum_metric),
                "num_inst": _py(self.num_inst)}

    def set_state(self, state):
        """Inverse of :meth:`get_state`."""
        self.sum_metric = state["sum_metric"]
        self.num_inst = state["num_inst"]

    def _device_batch_stats(self, labels, preds):
        """``(sum_metric delta, num_inst delta)`` of one batch as torch ops
        on the batch's device, for :class:`DeviceMetric`; the base class
        has no device path, and such a metric stays on the host."""
        raise NotImplementedError("%s has no device path" % self.name)


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

    def get_state(self):
        return {"children": [m.get_state() for m in self.metrics]}

    def set_state(self, state):
        children = state["children"]
        if len(children) != len(self.metrics):
            raise MXNetError(
                "composite metric state has %d children, metric has %d"
                % (len(children), len(self.metrics)))
        for metric, child in zip(self.metrics, children):
            metric.set_state(child)


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

    def _device_batch_stats(self, labels, preds):
        check_label_shapes(labels, preds)
        s, n = 0.0, 0
        for label, p in zip(labels, preds):
            if p.ndim > 1 and p.shape[-1] > 1:
                p = torch.argmax(p, dim=self.axis if p.ndim > self.axis
                                 else -1)
            lab = label.to(torch.int32).reshape(-1)
            p = p.to(torch.int32).reshape(-1)
            check_label_shapes(lab, p, shape=1)
            s = s + (p == lab).sum().to(torch.float32)
            n += p.numel()
        return s, n


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

    def _device_batch_stats(self, labels, preds):
        # a stable ascending sort, as the JAX device path takes it: among
        # tied scores the higher class index sorts later, so it is the one
        # counted in the top k (numpy's host sort is not stable)
        check_label_shapes(labels, preds)
        s, n = 0.0, 0
        for label, pred in zip(labels, preds):
            p = torch.argsort(pred.to(torch.float32), dim=1, stable=True)
            lab = label.to(torch.int32).reshape(-1)
            num_classes = p.shape[1]
            for j in range(min(num_classes, self.top_k)):
                s = s + (p[:, num_classes - 1 - j].reshape(-1) == lab) \
                    .sum().to(torch.float32)
            n += p.shape[0]
        return s, n


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

    def _device_batch_stats(self, labels, preds):
        check_label_shapes(labels, preds)
        s, n = 0.0, 0
        for label, pred in zip(labels, preds):
            lab = label.to(torch.int64).reshape(-1)
            assert lab.shape[0] == pred.shape[0]
            classes = pred.shape[-1]
            rows = torch.arange(lab.shape[0], device=pred.device)
            prob = pred[rows, lab.clamp(0, classes - 1)]
            # an out-of-range label reads as NaN, where the host path
            # raises: a device gather cannot raise without a sync
            prob = torch.where((lab >= 0) & (lab < classes), prob,
                               torch.full_like(prob, float("nan")))
            s = s + (-torch.log(prob + self.eps)).sum().to(torch.float32)
            n += lab.shape[0]
        return s, n


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


# -- the device path (the sync-free Module.fit) ------------------------------
def _leaves_of(metric):
    """The leaf metrics of a (possibly composite) metric, in ``get()``
    order."""
    if isinstance(metric, CompositeEvalMetric):
        return [leaf for child in metric.metrics
                for leaf in _leaves_of(child)]
    return [metric]


def _defining_class(cls, name):
    for c in cls.__mro__:
        if name in vars(c):
            return c
    return None


def device_capable(metric):
    """True when every leaf of ``metric`` has a device path and a scalar
    accumulator, so :class:`DeviceMetric` can wrap it.  A subclass that
    overrides ``update`` but inherits a builtin's ``_device_batch_stats``
    is not capable: the device path would compute the parent's
    statistics and bypass the override."""
    leaves = _leaves_of(metric)
    if not leaves:
        return False
    for leaf in leaves:
        if leaf.num is not None:
            return False
        c_stats = _defining_class(type(leaf), "_device_batch_stats")
        if c_stats is None or c_stats is EvalMetric:
            return False
        c_update = _defining_class(type(leaf), "update")
        if c_update is not None and not issubclass(c_stats, c_update):
            return False
    return True


def device_enabled():
    """``MXNET_DEVICE_METRIC`` (default on; ``0`` or ``false`` keeps every
    metric on the host path)."""
    return _os.environ.get("MXNET_DEVICE_METRIC", "1") \
        not in ("0", "false")


def as_device(metric):
    """``metric`` wrapped in a :class:`DeviceMetric` when it is capable
    and the device path is enabled, else ``metric`` itself.  The wrapper
    is cached on the metric, so every ``score`` pass reuses it."""
    if isinstance(metric, DeviceMetric):
        return metric
    if device_enabled() and device_capable(metric):
        wrapper = getattr(metric, "_device_wrapper", None)
        if wrapper is None:
            wrapper = DeviceMetric(metric)
            metric._device_wrapper = wrapper
        return wrapper
    return metric


def _tensor(x):
    if isinstance(x, NDArray):
        return x._t.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(_np.asarray(x))


def _to(t, dev):
    """``t`` on ``dev``; a host array bound for a card is pinned first, as
    a copy from pageable memory would wait for the card's stream."""
    if dev.type == "cuda" and not t.is_cuda:
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


class DeviceMetric(EvalMetric):
    """A device-resident accumulator around a host :class:`EvalMetric`.

    ``update`` queues each leaf's ``_device_batch_stats`` on the current
    stream of the outputs' device, summed into a float32 ``(n_leaves, 2)``
    tensor, and returns without a host sync.  Reading the metric
    (``get``, ``get_name_value``, ``num_inst``, ``sum_metric``) is the one
    sync: the accumulator is copied to the host once, folded into the
    wrapped leaves' ``sum_metric``/``num_inst`` and cleared, so a
    reference to the wrapped metric stays right.  ``sync_count`` counts
    those reads.  Accumulation is in float32: counts are exact below
    2**24, other sums agree with the host path to rounding."""

    def __init__(self, base):
        base = base if isinstance(base, EvalMetric) else create(base)
        if not device_capable(base):
            raise MXNetError("metric %r has no device path" % base.name)
        self._base = base
        self._leaves = _leaves_of(base)
        self._acc = None
        self.sync_count = 0
        super().__init__(base.name)

    @property
    def base(self):
        return self._base

    @property
    def num_inst(self):
        self._sync()
        return self._base.num_inst

    @property
    def sum_metric(self):
        self._sync()
        return self._base.sum_metric

    def reset(self):
        base = getattr(self, "_base", None)
        if base is None:  # EvalMetric.__init__ calls reset() first
            return
        base.reset()
        self._acc = None

    def update(self, labels, preds, skip=None):
        """Accumulate one batch; ``skip`` (an optional bool tensor on the
        device) zeroes the batch's statistics without a host read."""
        labels = [_tensor(x) for x in (labels or [])]
        preds = [_tensor(x) for x in (preds or [])]
        dev = next((t.device for t in preds + labels if t.is_cuda),
                   torch.device("cpu"))
        labels = [_to(t, dev) for t in labels]
        preds = [_to(t, dev) for t in preds]
        rows = []
        for leaf in self._leaves:
            s, n = leaf._device_batch_stats(labels, preds)
            if not isinstance(s, torch.Tensor):
                s = torch.full((), float(s), device=dev)
            # a fill, not a copy from the host: no sync
            rows.append(torch.stack([s.to(torch.float32),
                                     torch.full((), float(n), device=dev)]))
        stats = torch.stack(rows)
        if skip is not None:
            stats = torch.where(skip, torch.zeros_like(stats), stats)
        if self._acc is None:
            self._acc = stats
        else:
            self._acc = self._acc.to(dev) + stats

    def _sync(self):
        """The sync point: fold the accumulator into the host leaves."""
        if self._acc is None:
            return
        vals = self._acc.cpu().numpy()
        self._acc = None
        self.sync_count += 1
        for leaf, (s, n) in zip(self._leaves, vals):
            leaf.sum_metric += float(s)
            leaf.num_inst += int(n)

    def get(self):
        self._sync()
        return self._base.get()

    def get_name_value(self):
        self._sync()
        return self._base.get_name_value()

    def get_state(self):
        """The wrapped metric's state after a sync (one read of the
        accumulator, counted in ``sync_count``)."""
        self._sync()
        return self._base.get_state()

    def set_state(self, state):
        self._acc = None
        self._base.set_state(state)


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
