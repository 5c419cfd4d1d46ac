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
callbacks still taken batch by batch.

Checkpoints and resume (the JAX package's): ``checkpoint_prefix`` writes
an epoch checkpoint every ``checkpoint_period`` epochs and installs
SIGTERM/SIGINT handlers for the call, which drain the batch in flight,
write a last snapshot and raise
:class:`~mxnet_tpu_torch.checkpoint.TrainingPreempted`;
``checkpoint_every_n_batches`` (default ``MXNET_CKPT_EVERY_N_BATCHES``)
adds mid-epoch snapshots written by a background thread
(``MXNET_CKPT_ASYNC=0`` writes them inline), at chunk boundaries only
under ``MXNET_BULK_TRAIN_STEPS``; ``resume="auto"`` restarts from the
newest verified epoch checkpoint or snapshot, a snapshot exactly
(parameters, optimizer states and update counts, random state, metric
sums, iterator position).  The other resilience options (NaN and
anomaly policies, elastic membership, integrity audits) and monitors are
not ported yet: setting one raises.
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal as _signal
import threading
import time

import torch

from .. import metric as _metric
from .. import random as _random
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


# -- graceful preemption ----------------------------------------------------

#: the one fit call that holds the process's SIGTERM/SIGINT handlers
_fit_signal_lock = threading.Lock()
_fit_signal_owner = [None]


class _PreemptGuard:
    """The handler only records the signal; the batch loop sees it at the
    next batch boundary, finishes, checkpoints and raises
    ``TrainingPreempted``.  A second signal while draining raises
    ``KeyboardInterrupt`` at once."""

    __slots__ = ("requested",)

    def __init__(self):
        self.requested = None

    def __call__(self, signum, frame):
        if self.requested is not None:
            raise KeyboardInterrupt(
                "second signal %s during preemption drain" % signum)
        self.requested = signum


@contextlib.contextmanager
def _preempt_signals(guard, logger, enable=True):
    """``guard`` as the SIGTERM and SIGINT handler within the block, the
    previous handlers restored on every way out.  ``enable=False`` (fit
    without ``checkpoint_prefix``) leaves the handlers alone, as does a
    fit off the main thread, where Python allows no handler."""
    if not enable:
        yield guard
        return
    if threading.current_thread() is not threading.main_thread():
        logger.debug("fit: not on the main thread; SIGTERM/SIGINT "
                     "graceful drain is unavailable here")
        yield guard
        return
    with _fit_signal_lock:
        if _fit_signal_owner[0] is not None:
            raise MXNetError(
                "a fit call already owns the process SIGTERM/SIGINT "
                "handlers (nested fit from a callback?): refusing to "
                "double-install; run the inner fit after the outer one, "
                "or in another process")
        _fit_signal_owner[0] = guard
    try:
        prev_term = _signal.signal(_signal.SIGTERM, guard)
        try:
            prev_int = _signal.signal(_signal.SIGINT, guard)
            try:
                yield guard
            finally:
                _signal.signal(_signal.SIGINT, prev_int)
        finally:
            _signal.signal(_signal.SIGTERM, prev_term)
    finally:
        with _fit_signal_lock:
            _fit_signal_owner[0] = None


def _adapt_iter_state(state, target):
    """An iterator state taken with or without a prefetch wrapper, made to
    fit ``target``: a wrapper's state of one sub-iterator unwraps onto a
    plain iterator, a plain state wraps for a wrapper."""
    from ..io import PrefetchingIter

    wrapped = isinstance(state, dict) and \
        state.get("type") in ("PrefetchingIter", "DevicePrefetchIter")
    if isinstance(target, PrefetchingIter):
        return state if wrapped else \
            {"type": type(target).__name__, "inner": [state]}
    if wrapped and len(state.get("inner", [])) == 1:
        return state["inner"][0]
    return state


class _FitRun:
    """One ``fit``'s snapshot cadence, writer and preemption drain."""

    def __init__(self, prefix, every_n, writer, guard, logger):
        self.prefix = prefix
        self.every_n = every_n
        self.writer = writer
        self.guard = guard
        self.logger = logger
        self._warned_iter = False

    def capture(self, module, epoch, nbatch, fit_data, eval_metric):
        """A :class:`~mxnet_tpu_torch.checkpoint.Snapshot`: device copies
        of the arrays with an event after them (no host sync), host dicts
        of the rest.  Reading a device metric's state is one sync; the
        iterator's waits for its prefetch threads."""
        from .. import checkpoint as _ckpt

        if hasattr(module, "_capture_state_arrays"):
            arg, aux, opt_states, opt_counts = \
                module._capture_state_arrays()
        else:
            arg_l, aux_l = module.get_params()
            arg = {k: v.copy() for k, v in arg_l.items()}
            aux = {k: v.copy() for k, v in aux_l.items()}
            opt_states = opt_counts = None
        ready = None
        t = next((a._t for a in arg.values() if a._t.is_cuda), None)
        if t is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(t.device))
        try:
            iter_state = fit_data.state_dict()
        except NotImplementedError:
            if not self._warned_iter:
                self.logger.warning(
                    "checkpoint snapshot: %s has no iterator-state "
                    "protocol; mid-epoch resume will degrade to the "
                    "epoch boundary", type(fit_data).__name__)
                self._warned_iter = True
            iter_state = None
        try:
            metric_state = eval_metric.get_state()
        except NotImplementedError:
            metric_state = None
        return _ckpt.Snapshot(epoch, nbatch, arg, aux,
                              opt_states=opt_states, opt_counts=opt_counts,
                              rng_state={"global": _random.get_state()},
                              metric_state=metric_state,
                              iter_state=iter_state, ready=ready)

    def after_batch(self, module, epoch, nbatch, fit_data, eval_metric):
        """After a batch (a chunk in bulk mode): the cadence snapshot,
        then a pending preemption, the batch being complete."""
        if self.every_n is not None and (nbatch + 1) % self.every_n == 0:
            self.writer.submit(
                self.capture(module, epoch, nbatch, fit_data, eval_metric))
        self.check_preempt(module, epoch, nbatch, fit_data, eval_metric)

    def epoch_end_preempt(self, module, epoch, already_saved):
        """A signal seen at the end of epoch ``epoch`` (after its
        checkpoint, callbacks and eval): the resume point is the
        checkpoint of epoch ``epoch + 1``, written here unless the period
        already wrote it."""
        from .. import checkpoint as _ckpt

        signum = self.guard.requested
        path = None
        if self.prefix is not None:
            if not already_saved:
                arg_params, aux_params = module.get_params()
                module._save_fit_checkpoint(self.prefix, epoch + 1,
                                            arg_params, aux_params)
            path = "%s-%04d.params" % (self.prefix, epoch + 1)
        _telemetry.inc("resilience.preemptions")
        _telemetry.event("preemption", epoch=epoch, nbatch=None,
                         signal=signum, checkpoint=path)
        self.logger.warning(
            "preempted (signal %s) during epoch %d wrap-up: epoch "
            "complete, checkpoint %s", signum, epoch,
            path if path else "skipped (no checkpoint_prefix)")
        raise _ckpt.TrainingPreempted(
            "training preempted by signal %s at the end of epoch %d "
            "(epoch complete; resume with resume='auto')"
            % (signum, epoch), checkpoint_path=path, epoch=epoch,
            nbatch=None, signum=signum)

    def check_preempt(self, module, epoch, nbatch, fit_data, eval_metric):
        from .. import checkpoint as _ckpt

        if self.guard is None or self.guard.requested is None:
            return
        signum = self.guard.requested
        path = None
        if self.prefix is not None:
            snap = self.capture(module, epoch, nbatch, fit_data,
                                eval_metric)
            if self.writer is not None:
                # the write in flight first; an earlier failed write must
                # not stop this last snapshot, which raises its own errors
                try:
                    self.writer.drain()
                except Exception as e:  # noqa: BLE001 - logged
                    self.logger.warning(
                        "preemption drain: earlier async snapshot write "
                        "had failed (%s); writing the final snapshot "
                        "anyway", e)
            path = _ckpt.write_snapshot(self.prefix, snap,
                                        logger=self.logger)
        _telemetry.inc("resilience.preemptions")
        _telemetry.event("preemption", epoch=epoch, nbatch=nbatch,
                         signal=signum, checkpoint=path)
        self.logger.warning(
            "preempted (signal %s) at epoch %d batch %d: batch in flight "
            "finished, checkpoint %s", signum, epoch, nbatch,
            path if path else "skipped (no checkpoint_prefix)")
        raise _ckpt.TrainingPreempted(
            "training preempted by signal %s at epoch %d batch %d "
            "(graceful drain complete; resume with resume='auto')"
            % (signum, epoch, nbatch), checkpoint_path=path, epoch=epoch,
            nbatch=nbatch, signum=signum)


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
        checkpoint, the epoch-end callbacks and, with ``eval_data``, a
        :meth:`score` pass.  The checkpoint options are those of the JAX
        package (see the module docstring)."""
        assert num_epoch is not None, "please specify number of epochs"
        unported = {"monitor": monitor, "nan_policy": nan_policy,
                    "nan_check_period": nan_check_period,
                    "elastic": elastic or None,
                    "anomaly_policy": anomaly_policy,
                    "audit_every_n_batches": audit_every_n_batches}
        for name, value in unported.items():
            if value is not None:
                raise MXNetError("fit(%s=%r) is not ported yet"
                                 % (name, value))
        if resume not in (None, "auto"):
            raise MXNetError("resume must be None or 'auto', got %r"
                             % (resume,))
        if checkpoint_prefix is not None and checkpoint_period < 1:
            raise MXNetError("checkpoint_period must be >= 1, got %r"
                             % (checkpoint_period,))
        if checkpoint_every_n_batches is None:
            env_cadence = int(os.environ.get(
                "MXNET_CKPT_EVERY_N_BATCHES", "0") or 0) or None
            if env_cadence is not None and checkpoint_prefix is None:
                # a job-wide cadence must not break a fit that asked for
                # no checkpoints; only the argument fails below
                self.logger.warning(
                    "MXNET_CKPT_EVERY_N_BATCHES=%d ignored: this fit has "
                    "no checkpoint_prefix", env_cadence)
            else:
                checkpoint_every_n_batches = env_cadence
        if checkpoint_every_n_batches is not None:
            if checkpoint_prefix is None:
                raise MXNetError(
                    "checkpoint_every_n_batches needs checkpoint_prefix")
            if checkpoint_every_n_batches < 1:
                raise MXNetError(
                    "checkpoint_every_n_batches must be >= 1, got %r"
                    % (checkpoint_every_n_batches,))
        if prefetch_to_device is None:
            prefetch_to_device = os.environ.get(
                "MXNET_DEVICE_PREFETCH", "0") not in ("0", "", "false")
        resume_states = None  # an epoch checkpoint's states file
        resume_state = None  # a mid-epoch snapshot (exact resume)
        if resume == "auto":
            if checkpoint_prefix is None:
                raise MXNetError("resume='auto' needs checkpoint_prefix")
            from ..checkpoint import load_latest_state

            found = load_latest_state(checkpoint_prefix, logger=self.logger)
            if found is None:
                self.logger.info(
                    "resume='auto': no loadable checkpoint under %r; "
                    "starting from scratch", checkpoint_prefix)
            else:
                _telemetry.inc("resilience.checkpoint.resumes")
                _telemetry.event("checkpoint.resume", epoch=found.epoch,
                                 nbatch=found.nbatch,
                                 prefix=checkpoint_prefix)
                begin_epoch = found.epoch
                arg_params, aux_params = found.arg_params, found.aux_params
                force_init = True
                if found.nbatch is None:
                    if found.states_path is not None and \
                            hasattr(self, "load_optimizer_states"):
                        resume_states = found.states_path
                    self.logger.info(
                        "resume='auto': restarting from checkpoint epoch "
                        "%d (%s)", found.epoch, checkpoint_prefix)
                else:
                    resume_state = found
                    self.logger.info(
                        "resume='auto': exact mid-epoch resume from "
                        "snapshot epoch %d batch %d (%s)", found.epoch,
                        found.nbatch, checkpoint_prefix)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if resume_states is not None:
            self.load_optimizer_states(resume_states)
        if resume_state is not None:
            # the iterator position is restored below, on the iterator
            # fit drives (the prefetch wrapper included)
            if hasattr(self, "_restore_opt_snapshot"):
                self._restore_opt_snapshot(resume_state.states_bytes,
                                           resume_state.opt_counts)
            rng = resume_state.rng_state or {}
            if rng.get("global"):
                _random.set_state(rng["global"])
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
        resume_nbatch = None
        resume_metric_state = None
        if resume_state is not None:
            if resume_state.iter_state is None:
                self.logger.warning(
                    "resume: snapshot carries no iterator state; "
                    "restarting epoch %d from batch 0: data from the "
                    "partial epoch will replay", resume_state.epoch)
            else:
                try:
                    fit_data.load_state_dict(_adapt_iter_state(
                        resume_state.iter_state, fit_data))
                    resume_nbatch = resume_state.nbatch
                    resume_metric_state = resume_state.metric_state
                except Exception as e:  # noqa: BLE001 - any failure to
                    # restore the position (another iterator type, other
                    # sizes) degrades to the epoch boundary: the params
                    # of the snapshot loaded
                    self.logger.warning(
                        "resume: could not restore the iterator position "
                        "(%s: %s); restarting epoch %d from batch 0: data "
                        "from the partial epoch will replay",
                        type(e).__name__, e, resume_state.epoch)
        writer = None
        if checkpoint_every_n_batches is not None:
            from ..checkpoint import AsyncSnapshotWriter

            writer = AsyncSnapshotWriter(
                checkpoint_prefix, logger=self.logger,
                sync=os.environ.get("MXNET_CKPT_ASYNC", "1")
                in ("0", "", "false"))
        guard = _PreemptGuard()
        run = _FitRun(checkpoint_prefix, checkpoint_every_n_batches, writer,
                      guard, self.logger)
        try:
            with _preempt_signals(guard, self.logger,
                                  enable=checkpoint_prefix is not None):
                for epoch in range(begin_epoch, num_epoch):
                    first = resume_nbatch is not None and \
                        epoch == begin_epoch
                    self._fit_epoch(
                        epoch, fit_data, eval_metric,
                        bulk_k if use_bulk else 1, batch_end_callback, run,
                        resume_nbatch if first else -1,
                        resume_metric_state if first else None)
                    arg_params_, aux_params_ = self.get_params()
                    saved = checkpoint_prefix is not None and \
                        ((epoch + 1) % checkpoint_period == 0
                         or epoch + 1 == num_epoch)
                    if saved:
                        self._save_fit_checkpoint(checkpoint_prefix,
                                                  epoch + 1, arg_params_,
                                                  aux_params_)
                    if epoch_end_callback is not None:
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
                    # an owned prefetch wrapper skips the last reset: it
                    # would re-arm the producer, which could take the
                    # caller's first batch after fit
                    if epoch + 1 < num_epoch or not owns_iter:
                        fit_data.reset()
                    if guard.requested is not None:
                        # a signal during the epoch's wrap-up: the drain
                        # point is the epoch boundary
                        run.epoch_end_preempt(self, epoch, saved)
            if writer is not None:
                # surfaces a failed background write
                writer.close()
            if owns_iter:
                fit_data.close()
                train_data.reset()
        finally:
            if writer is not None:
                try:
                    writer.close()
                except Exception as e:  # noqa: BLE001 - must not hide
                    # the exception in flight (a preemption, say)
                    self.logger.warning(
                        "async checkpoint writer close: %s", e)
            if owns_iter:
                fit_data.close()

    def _fit_epoch(self, epoch, fit_data, eval_metric, bulk_k,
                   batch_end_callback, run=None, start_nbatch=-1,
                   metric_state=None):
        """One epoch.  A resumed epoch starts after batch ``start_nbatch``
        (the iterator already restored) with the metric's sums
        ``metric_state``, so the batch numbers and the metric go on as in
        an uninterrupted run."""
        tic = time.time()
        eval_metric.reset()
        if metric_state is not None:
            eval_metric.set_state(metric_state)
        nbatch = start_nbatch

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
                # snapshots and preemption at chunk boundaries only: the
                # parameters inside a chunk are not those of a batch end
                if run is not None:
                    run.after_batch(self, epoch, nbatch, fit_data,
                                    eval_metric)
        else:
            for data_batch in fit_data:
                nbatch += 1
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                batch_end(nbatch, data_batch)
                if run is not None:
                    run.after_batch(self, epoch, nbatch, fit_data,
                                    eval_metric)
        for name, val in eval_metric.get_name_value():
            self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
        toc = time.time()
        self.logger.info("Epoch[%d] Time cost=%.3f", epoch, toc - tic)
        _telemetry.inc("fit.epochs")
        _telemetry.set_gauge("fit.epoch_seconds", toc - tic)

    def _save_fit_checkpoint(self, prefix, epoch, arg_params, aux_params):
        """The epoch checkpoint of ``fit``: the module's own
        ``save_checkpoint`` with optimizer states where it has one, else
        ``model.save_checkpoint``."""
        _telemetry.inc("resilience.checkpoint.saves")
        if hasattr(self, "save_checkpoint"):
            self.save_checkpoint(
                prefix, epoch,
                save_optimizer_states=self.optimizer_initialized)
        else:
            from ..model import save_checkpoint

            save_checkpoint(prefix, epoch, self.symbol, arg_params,
                            aux_params)

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
