"""The training loop (counterpart of ``mxnet_tpu/module/base_module.py``):
:meth:`BaseModule.fit` with its per-batch loop, :meth:`score`,
:meth:`predict` and :meth:`forward_backward`.

The sync-free loop of the JAX package: ``fit`` and ``score`` wrap an
eligible metric in a :class:`~mxnet_tpu_torch.metric.DeviceMetric`
(``MXNET_DEVICE_METRIC=0`` keeps it on the host);
``fit(prefetch_to_device=True)`` (default ``MXNET_DEVICE_PREFETCH``)
copies batches to the device from a ``DevicePrefetchIter``'s thread and
closes it when fit ends; ``MXNET_BULK_TRAIN_STEPS=K`` trains through
``run_bulk`` in chunks of K batches, the metric and the batch-end
callbacks still taken batch by batch.  The resilience options
(checkpointing and resume, NaN/anomaly policies, elastic membership,
integrity audits) and monitors are not ported yet: setting one raises.
"""

from __future__ import annotations

import logging
import os
import time

import torch

from .. import metric as _metric
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..initializer import Uniform
from ..model import BatchEndParam
from ..ndarray import NDArray

__all__ = ["BaseModule"]


def _as_metric(m):
    return m if isinstance(m, _metric.EvalMetric) else _metric.create(m)


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- high-level API ---------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        # wrapped before the reset: a cached wrapper may hold the sums of
        # an earlier pass, and its reset clears both
        eval_metric = _metric.as_device(_as_metric(eval_metric))
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric,
                                      locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(param)
            actual_num_batch += 1
        if score_end_callback:
            param = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                  eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(param)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Outputs over ``eval_data`` (padding rows dropped), as NDArrays
        on the module's device."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            output_list.append([out[0:out.shape[0] - pad].copy()
                                for out in self.get_outputs()])
        if not output_list or not merge_batches:
            return output_list
        num_outputs = len(output_list[0])
        merged = [NDArray(torch.cat([out[i]._t for out in output_list]))
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, checkpoint_prefix=None, checkpoint_period=1,
            resume=None, nan_policy=None, nan_check_period=None,
            prefetch_to_device=None, checkpoint_every_n_batches=None,
            elastic=None, anomaly_policy=None,
            audit_every_n_batches=None):
        """Train for ``num_epoch - begin_epoch`` epochs: per batch
        forward+backward, the optimizer update, the metric update and the
        batch-end callbacks (per chunk of K batches under
        ``MXNET_BULK_TRAIN_STEPS=K``); per epoch the metric log, the
        epoch-end callbacks and, with ``eval_data``, a :meth:`score`
        pass."""
        assert num_epoch is not None, "please specify number of epochs"
        unported = {"monitor": monitor,
                    "checkpoint_prefix": checkpoint_prefix,
                    "resume": resume, "nan_policy": nan_policy,
                    "nan_check_period": nan_check_period,
                    "checkpoint_every_n_batches": checkpoint_every_n_batches,
                    "elastic": elastic or None,
                    "anomaly_policy": anomaly_policy,
                    "audit_every_n_batches": audit_every_n_batches}
        for name, value in unported.items():
            if value is not None:
                raise MXNetError("fit(%s=%r) is not ported yet"
                                 % (name, value))
        if prefetch_to_device is None:
            prefetch_to_device = os.environ.get(
                "MXNET_DEVICE_PREFETCH", "0") not in ("0", "", "false")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        validation_metric = _metric.as_device(_as_metric(validation_metric))
        eval_metric = _metric.as_device(_as_metric(eval_metric))
        bulk_k = max(1, int(os.environ.get("MXNET_BULK_TRAIN_STEPS", "1")))
        use_bulk = bulk_k > 1 and hasattr(self, "run_bulk")
        if use_bulk and not self._full_step_eligible():
            self.logger.warning(
                "MXNET_BULK_TRAIN_STEPS=%d has no effect: the fused step "
                "is not eligible (requires MXNET_FUSE_TRAIN_STEP=1, plain "
                "SGD, local kvstore); training runs per batch", bulk_k)
        fit_data = train_data
        if prefetch_to_device and hasattr(self, "_device_put_batch"):
            from ..io import DevicePrefetchIter

            fit_data = DevicePrefetchIter(train_data, self._context[0],
                                          placer=self._device_put_batch)
        owns_iter = fit_data is not train_data
        try:
            for epoch in range(begin_epoch, num_epoch):
                self._fit_epoch(epoch, fit_data, eval_metric, bulk_k
                                if use_bulk else 1, batch_end_callback)
                if epoch_end_callback is not None:
                    arg_params_, aux_params_ = self.get_params()
                    for callback in _as_list(epoch_end_callback):
                        callback(epoch, self.symbol, arg_params_,
                                 aux_params_)
                if eval_data:
                    res = self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch)
                    for name, val in res:
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)
                # an owned prefetch wrapper skips the last reset: it would
                # re-arm the producer, which could take the caller's first
                # batch after fit
                if epoch + 1 < num_epoch or not owns_iter:
                    fit_data.reset()
            if owns_iter:
                fit_data.close()
                train_data.reset()
        finally:
            if owns_iter:
                fit_data.close()

    def _fit_epoch(self, epoch, fit_data, eval_metric, bulk_k,
                   batch_end_callback):
        tic = time.time()
        eval_metric.reset()
        nbatch = -1

        def batch_end(nbatch, data_batch):
            _telemetry.inc("fit.batches")
            if batch_end_callback is not None:
                param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric,
                                      locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(param)

        if bulk_k > 1:
            # the device metric takes the stacked outputs with no host copy
            mode = "device" if isinstance(eval_metric, _metric.DeviceMetric) \
                else True
            batches = iter(fit_data)
            while True:
                chunk = [b for b in (next(batches, None)
                                     for _ in range(bulk_k)) if b is not None]
                if not chunk:
                    break
                outs = self.run_bulk(chunk, return_outputs=mode)
                for i, b in enumerate(chunk):
                    nbatch += 1
                    eval_metric.update(b.label, [o[i] for o in outs])
                    batch_end(nbatch, b)
        else:
            for data_batch in fit_data:
                nbatch += 1
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                batch_end(nbatch, data_batch)
        for name, val in eval_metric.get_name_value():
            self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
        toc = time.time()
        self.logger.info("Epoch[%d] Time cost=%.3f", epoch, toc - tic)
        _telemetry.inc("fit.epochs")
        _telemetry.set_gauge("fit.epoch_seconds", toc - tic)

    # -- parameters -------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def save_params(self, fname):
        """``arg:``/``aux:``-prefixed dmlc params file."""
        from ..ndarray import save

        arg_params, aux_params = self.get_params()
        save_dict = {"arg:%s" % k: v for k, v in arg_params.items()}
        save_dict.update({"aux:%s" % k: v for k, v in aux_params.items()})
        save(fname, save_dict)

    def load_params(self, fname):
        from ..ndarray import load

        arg_params, aux_params = {}, {}
        for k, value in load(fname).items():
            kind, name = k.split(":", 1)
            if kind == "arg":
                arg_params[name] = value
            elif kind == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)
