"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``): the
epoch-end :func:`do_checkpoint` and :func:`module_checkpoint`, the
batch-end :func:`log_train_metric` and :class:`Speedometer`.

Batch-end callbacks receive any object with ``epoch``, ``nbatch`` and
``eval_metric`` attributes (``model.BatchEndParam``).
"""

from __future__ import annotations

import logging
import time

from . import telemetry as _telemetry

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback: ``mod.save_checkpoint`` every ``period``
    epochs."""
    period = max(1, int(period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback: ``model.save_checkpoint`` of the symbol and
    parameters every ``period`` epochs."""
    from .model import save_checkpoint

    period = max(1, int(period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback: log the running training metric every
    ``period`` batches."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """Batch-end callback: log samples/sec every ``frequent`` batches.

    The rate is ``(batches since the last log) * batch_size / elapsed``
    on a monotonic clock, so a missed callback cannot skew it; a drop in
    ``nbatch`` (a new epoch) re-arms the mark without logging.  An
    exponentially smoothed rate (``smoothing`` of history kept per log)
    is logged beside it, and both land in the ``fit.samples_per_sec``
    gauges when telemetry is on.  ``speeds`` keeps every logged
    instantaneous rate.  The metric is read only when a line is logged,
    so a :class:`~mxnet_tpu_torch.metric.DeviceMetric` syncs only at that
    cadence."""

    def __init__(self, batch_size, frequent=50, smoothing=0.7,
                 auto_reset=False):
        self.batch_size = batch_size
        self.frequent = frequent
        self.smoothing = min(max(float(smoothing), 0.0), 1.0)
        self.auto_reset = auto_reset
        self._mark = None  # (nbatch, perf_counter) at the last log/reset
        self._ema = None
        self.speeds = []

    def __call__(self, param):
        now = time.perf_counter()
        count = param.nbatch
        if self._mark is None or count < self._mark[0]:
            self._mark = (count, now)  # fresh epoch: arm, don't log
            return
        if count == self._mark[0] or count % self.frequent != 0:
            return
        elapsed = now - self._mark[1]
        speed = (count - self._mark[0]) * self.batch_size / max(elapsed, 1e-9)
        self._mark = (count, now)
        self._ema = speed if self._ema is None else \
            self.smoothing * self._ema + (1.0 - self.smoothing) * speed
        self.speeds.append(speed)
        _telemetry.set_gauge("fit.samples_per_sec", speed, kind="instant")
        _telemetry.set_gauge("fit.samples_per_sec", self._ema,
                             kind="smoothed")
        if param.eval_metric is not None:
            metrics = "".join("\tTrain-%s=%f" % nv
                              for nv in param.eval_metric.get_name_value())
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec "
                         "(smoothed %.2f)%s", param.epoch, count, speed,
                         self._ema, metrics)
            if self.auto_reset:
                param.eval_metric.reset()
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec "
                         "(smoothed %.2f)", param.epoch, count, speed,
                         self._ema)
