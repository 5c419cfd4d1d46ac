"""``Module`` (counterpart of ``mxnet_tpu/module/module.py``): one symbol
bound on one device, trained two-phase (forward+backward, then the
update).

``Module(sym)`` defaults to ``context=gpu(0)`` and raises without a card;
tests pass ``context=mx.cpu()``.  ``init_optimizer`` sets
``rescale_grad = 1 / batch_size``.  With plain SGD the update is one
multi-tensor step over every parameter (the JAX package's fused update
path); other optimizers go through the per-parameter :class:`Updater`.
``bind(shared_module=...)`` shares the parameters and their gradient
arrays with another module by NDArray identity, and
``borrow_optimizer`` its optimizer, updater and update states, as
``BucketingModule`` needs.  Multi-device contexts and meshes are not
ported yet.

Checkpoints: :meth:`save_checkpoint`, :meth:`Module.load` and the
optimizer-state files (the JAX package's pickle, read from either
package and moved onto the module's device); ``fit``'s mid-epoch
snapshots take :meth:`_capture_state_arrays`.  A state may be a tuple of
arrays (Adam's ``(mean, var)``): every array of it is copied, moved and
restored like a single one.

The sync-free step (the JAX package's ``MXNET_FUSE_TRAIN_STEP=1``): when
:meth:`_full_step_eligible`, ``forward_backward`` only loads the batch
and ``update`` runs forward, backward and the SGD update as one
``Executor.train_sgd`` call, on a card one CUDA-graph replay.  Reading
the outputs or the input gradients in between runs the two-phase step
instead.  :meth:`run_bulk` runs K such steps with no host sync between
them.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from .. import metric as _metric
from .. import optimizer as opt
from ..base import MXNetError, atomic_write_bytes
from ..context import Context, gpu
from ..executor import Executor
from ..initializer import InitDesc, Uniform
from ..model import _create_kvstore, load_checkpoint, save_checkpoint
from ..ndarray import NDArray
from .base_module import BaseModule

__all__ = ["Module"]


def _parse_data_desc(data_shapes):
    out = []
    for d in data_shapes or []:
        if hasattr(d, "name"):
            out.append((d.name, tuple(d.shape)))
        else:
            out.append((d[0], tuple(d[1])))
    return out


def _flat_copy(arrays):
    """Copies of ``arrays`` (NDArrays), as views into one flat buffer per
    dtype: a few launches however many arrays, on the current stream."""
    out = [None] * len(arrays)
    by_dtype = {}
    for k, a in enumerate(arrays):
        by_dtype.setdefault(a._t.dtype, []).append(k)
    with torch.no_grad():
        for ks in by_dtype.values():
            ts = [arrays[k]._t.detach() for k in ks]
            flat = torch.cat([t.reshape(-1) for t in ts])
            for k, t, piece in zip(ks, ts,
                                   flat.split([t.numel() for t in ts])):
                out[k] = NDArray(piece.view(t.shape))
    return out


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = gpu(0)
        if isinstance(context, Context):
            context = [context]
        if len(context) != 1:
            raise MXNetError("Module over %d devices is not ported yet"
                             % len(context))
        context[0].torch_device()  # raises here when the card is missing
        self._context = list(context)
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        input_names = self._data_names + self._label_names
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._optimizer = None
        self._kvstore = None
        self._updater = None
        self._pending_full = False  # a staged fused step
        # a states file Module.load was asked for, read by init_optimizer
        self._preload_opt_states = None

    # -- properties -------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        outs = self._symbol.infer_shape(
            **dict(self._data_shapes + self._label_shapes))[1]
        return list(zip(self._output_names, outs))

    def get_params(self):
        """The bound arrays themselves: ``({name: NDArray}, {name:
        NDArray})``."""
        assert self.binded and self.params_initialized
        return ({n: self._exec.arg_dict[n] for n in self._param_names},
                dict(self._exec.aux_dict))

    # -- binding ----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        saved = None
        if force_rebind:
            if self._exec is not None and self.params_initialized:
                saved = self.get_params()
            self._exec = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        assert for_training or not inputs_need_grad
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = _parse_data_desc(data_shapes)
        self._label_shapes = _parse_data_desc(label_shapes)
        req = {}
        for n in self._symbol.list_arguments():
            if n in self._param_names and for_training \
                    and n not in self._fixed_param_names:
                req[n] = grad_req if isinstance(grad_req, str) \
                    else grad_req.get(n, "write")
            elif n in self._data_names and inputs_need_grad:
                req[n] = "write"
            else:
                req[n] = "null"
        self._exec = Executor.simple_bind(
            self._symbol, self._context[0], grad_req=req,
            shared_exec=shared_module._exec if shared_module is not None
            else None, **dict(self._data_shapes + self._label_shapes))
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self.params_initialized = True
        if saved is not None:
            self.set_params(*saved, force_init=True)

    # -- parameters -------------------------------------------------------
    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        assert self.binded, "call bind before initializing the parameters"
        if self.params_initialized and not force_init:
            return
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                arr[:] = cache[name]
            elif cache is not None and not allow_missing:
                raise RuntimeError("%s is not presented" % name)
            elif initializer is not None:
                initializer(InitDesc(name, attrs.get(name),
                                     global_init=initializer), arr)

        for name in self._param_names:
            _impl(name, self._exec.arg_dict[name], arg_params)
        for name in self._aux_names:
            _impl(name, self._exec.aux_dict[name], aux_params)
        self.params_initialized = True

    # -- optimizer --------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        arg_params = {n: self._exec.arg_dict[n] for n in self._param_names}
        kvstore, _update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), arg_params)
        rescale_grad = 1.0 / self._data_shapes[0][1][0]
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(
                optimizer, sym=self._symbol,
                param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise MXNetError("optimizer must be a name or an Optimizer")
        elif optimizer.rescale_grad != rescale_grad:
            self.logger.warning(
                "Optimizer created manually outside Module but "
                "rescale_grad != 1.0/batch_size (%s vs. %s).",
                optimizer.rescale_grad, rescale_grad)
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Use ``shared_module``'s optimizer, kvstore and updater (with its
        per-index states): the buckets of a ``BucketingModule`` take one
        update schedule."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # -- compute ----------------------------------------------------------
    def _load_io(self, names, arrays):
        """Copy a batch into the bound arrays: one copy on the current
        stream, device to device for a batch a ``DevicePrefetchIter``
        has already placed."""
        for name, src in zip(names, arrays or []):
            dst = self._exec.arg_dict.get(name)
            if dst is None:
                continue
            if tuple(src.shape) != dst.shape:
                raise MXNetError("input %r shape %s != bound shape %s"
                                 % (name, tuple(src.shape), dst.shape))
            t = src._t if isinstance(src, NDArray) else \
                torch.as_tensor(np.asarray(src))
            with torch.no_grad():
                dst._t.copy_(t)

    def forward(self, data_batch, is_train=None, _defer=False):
        assert self.binded and self.params_initialized
        if not _defer:
            # a staged fused step runs before its batch is overwritten
            self._materialize_pending()
        if is_train is None:
            is_train = self.for_training
        self._load_io([n for n, _ in self._data_shapes], data_batch.data)
        if self._label_shapes and data_batch.label:
            self._load_io([n for n, _ in self._label_shapes],
                          data_batch.label)
        if not _defer:
            self._exec.forward(is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    # -- the fused step ---------------------------------------------------
    def _update_names(self):
        return [n for n in self._param_names
                if self._exec._grad_dict.get(n) is not None]

    def _full_step_eligible(self):
        """Forward, backward and update as one step: ``MXNET_FUSE_TRAIN_STEP
        =1``, plain SGD, no kvstore past the local one, no
        ``inputs_need_grad``, and every parameter gradient ``write``, as
        in the JAX package (the port has no monitor)."""
        if os.environ.get("MXNET_FUSE_TRAIN_STEP", "0") != "1":
            return False
        if not (self.binded and self.params_initialized
                and self.optimizer_initialized):
            return False
        if type(self._optimizer) is not opt.SGD:
            return False
        if self._kvstore is not None or self.inputs_need_grad:
            return False
        diff = self._exec._diff_names()
        return set(diff) == set(self._update_names()) and \
            all(self._exec.grad_req[n] == "write" for n in diff)

    def forward_backward(self, data_batch):
        """Stages the batch for the fused step when eligible; ``update()``
        then runs the whole step."""
        if self._full_step_eligible():
            self.forward(data_batch, is_train=True, _defer=True)
            self._pending_full = True
            return
        self.forward(data_batch, is_train=True)
        self.backward()

    def _materialize_pending(self):
        """A staged batch is read before ``update()``: run the two-phase
        forward and backward, so outputs and gradients exist."""
        if self._pending_full:
            self._pending_full = False
            self._exec.forward(is_train=True)
            self._exec.backward()

    def _prepare_full_step(self, steps):
        """Momenta created and every update count advanced ``steps``
        times, then the lr/wd read once: all ``steps`` steps take the lr
        of the last, as the JAX package's ``run_bulk`` does.  Returns
        ``(names, moms, lrs, wds)``."""
        optimizer, updater = self._optimizer, self._updater
        names = self._update_names()
        for idx in range(len(names)):
            if idx not in updater.states:
                updater.states[idx] = optimizer.create_state(
                    idx, self._exec.arg_dict[names[idx]])
        for _ in range(steps):
            for idx in range(len(names)):
                optimizer._update_count(idx)
        moms = [updater.states[i] for i in range(len(names))] \
            if optimizer.momentum != 0.0 else []
        return (names, moms, [optimizer._get_lr(i) for i in range(len(names))],
                [optimizer._get_wd(i) for i in range(len(names))])

    def _train_sgd(self, names, moms, lrs, wds):
        optimizer = self._optimizer
        self._exec.train_sgd(names, moms, lrs, wds, optimizer.momentum,
                             optimizer.rescale_grad, optimizer.clip_gradient)

    def _run_full_step(self):
        self._pending_full = False
        if not self._update_names():
            self._exec.forward(is_train=True)
            return
        self._train_sgd(*self._prepare_full_step(1))

    def run_bulk(self, batches, return_outputs=False):
        """``len(batches)`` fused steps with no host sync between them: on
        a card, each step is a replay of the captured step after a device
        copy of its batch into the bound arrays (host batches are first
        stacked and copied once, from pinned memory).  The update counts
        advance for the whole chunk before the lr is read, so every step
        takes the lr of the chunk's last (the JAX package's rule).

        ``return_outputs``: ``False`` keeps no outputs or gradients
        (reading ``get_outputs()`` or the executor's ``grad_dict`` raises
        until the next step); ``True`` returns, per output, a numpy array
        stacked over the steps ``(K, ...)``; ``"device"`` the same stacks
        as NDArrays on the module's device, with no host copy.  Not
        eligible for the fused step: per-batch ``forward_backward`` and
        ``update``."""
        if not batches:
            return [] if return_outputs else None
        if not self._full_step_eligible() or not self._update_names():
            per_batch = []
            for b in batches:
                self.forward_backward(b)
                self.update()
                if return_outputs:
                    per_batch.append([o._t for o in self.get_outputs()])
            return self._stacked(per_batch, return_outputs)
        self._pending_full = False
        names, moms, lrs, wds = self._prepare_full_step(len(batches))
        inputs = [(n, "data", i) for i, (n, _) in
                  enumerate(self._data_shapes)]
        if self._label_shapes:
            inputs += [(n, "label", i) for i, (n, _) in
                       enumerate(self._label_shapes)]
        staged = {n: self._staged(n, [(b.data if kind == "data"
                                       else b.label)[i] for b in batches])
                  for n, kind, i in inputs}
        per_batch = []
        for k in range(len(batches)):
            with torch.no_grad():
                for n, stack in staged.items():
                    self._exec.arg_dict[n]._t.copy_(stack[k])
            self._train_sgd(names, moms, lrs, wds)
            if return_outputs:
                per_batch.append([o._t for o in self._exec.outputs])
        if not return_outputs:
            self._exec.drop_results()
        return self._stacked(per_batch, return_outputs)

    def _staged(self, name, arrays):
        """The batches' arrays for input ``name`` as one sequence of
        tensors on the bound device: device arrays as they are, host
        arrays stacked into one pinned buffer and copied at once."""
        dst = self._exec.arg_dict[name]._t
        ts = [a._t if isinstance(a, NDArray) else
              torch.as_tensor(np.asarray(a)) for a in arrays]
        if all(t.device == dst.device for t in ts):
            return ts
        stack = torch.stack([t.to(dst.dtype) for t in ts])
        if dst.is_cuda:
            stack = stack.pin_memory()
        return stack.to(dst.device, non_blocking=True)

    @staticmethod
    def _stacked(per_batch, return_outputs):
        if not return_outputs:
            return None
        stacks = [torch.stack([pb[i] for pb in per_batch])
                  for i in range(len(per_batch[0]))]
        if return_outputs == "device":
            return [NDArray(s) for s in stacks]
        return [s.cpu().numpy() for s in stacks]

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        if self._pending_full:
            self._run_full_step()
            return
        names = self._update_names()
        weights = [self._exec.arg_dict[n] for n in names]
        grads = [self._exec.grad_dict[n] for n in names]
        optimizer, updater = self._optimizer, self._updater
        if type(optimizer) is not opt.SGD:
            for idx, (w, g) in enumerate(zip(weights, grads)):
                updater(idx, g, w)
            return
        # fused: every index's count advances before any lr is read, so
        # all parameters of a step see the same scheduled lr
        for idx, w in enumerate(weights):
            if idx not in updater.states:
                updater.states[idx] = optimizer.create_state(idx, w)
            optimizer._update_count(idx)
        optimizer.update_multi(list(range(len(names))), weights, grads,
                               [updater.states[i] for i in range(len(names))])

    def get_outputs(self, merge_multi_context=True):
        assert self.binded
        self._materialize_pending()
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        self._materialize_pending()
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        if isinstance(eval_metric, _metric.DeviceMetric) and labels \
                and self._label_shapes:
            # the labels are already on the device, in the bound arrays
            bound = [self._exec.arg_dict[n] for n, _ in self._label_shapes
                     if n in self._exec.arg_dict]
            if len(bound) == len(labels):
                labels = bound
        eval_metric.update(labels, self.get_outputs())

    # -- checkpoints -------------------------------------------------------
    def _capture_state_arrays(self):
        """Copies of every parameter, auxiliary state and optimizer state
        for a snapshot, made on the training stream after any staged
        fused step: one flat buffer per dtype (a few launches, no host
        sync), the returned arrays views into it.  Returns ``(arg, aux,
        opt_states, opt_counts)``; ``opt_counts`` holds the update counts
        the lr schedule reads."""
        assert self.binded and self.params_initialized
        self._materialize_pending()
        ex = self._exec
        aux_names = list(ex.aux_dict)
        states = self._updater.states if self.optimizer_initialized \
            and self._updater is not None else None
        # an index's state may be a tuple of arrays (Adam's (mean, var))
        flat_states = [a for st in (states or {}).values()
                       for a in opt.state_arrays(st)]
        copies = _flat_copy([ex.arg_dict[n] for n in self._param_names]
                            + [ex.aux_dict[n] for n in aux_names]
                            + flat_states)
        arg = dict(zip(self._param_names, copies))
        copies = copies[len(arg):]
        aux = dict(zip(aux_names, copies))
        state_copies = iter(copies[len(aux):])
        opt_states = None if states is None else {
            i: opt.map_state(lambda _a: next(state_copies), st)
            for i, st in states.items()}
        opt_counts = None
        if self._optimizer is not None:
            opt_counts = {
                "num_update": int(self._optimizer.num_update),
                "index_update_count": {
                    str(k): int(v) for k, v in
                    self._optimizer._index_update_count.items()}}
        return arg, aux, opt_states, opt_counts

    def _place_opt_states(self):
        """Unpickled optimizer states onto the module's device: the fused
        step hands them to one multi-tensor step, and a capture would take
        a state left on the CPU as a new tensor of another device."""
        dev = self._context[0].torch_device()
        self._updater.states = {
            i: opt.map_state(lambda a: NDArray(a._t.to(dev)), s)
            for i, s in self._updater.states.items()}

    def _restore_opt_snapshot(self, states_bytes, opt_counts):
        """The resume half of :meth:`_capture_state_arrays`: the updater's
        states from their pickle, on the module's device, and the update
        counts, so the lr schedule goes on where it stopped."""
        if states_bytes is not None and self._updater is not None:
            self._updater.set_states(states_bytes)
            self._place_opt_states()
        if opt_counts and self._optimizer is not None:
            self._optimizer.num_update = int(
                opt_counts.get("num_update", self._optimizer.num_update))
            self._optimizer._index_update_count = {
                int(k): int(v) for k, v in
                (opt_counts.get("index_update_count") or {}).items()}

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states``."""
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self.symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of the checkpoint's symbol whose ``bind`` also sets
        the checkpoint's parameters; with ``load_optimizer_states`` its
        ``init_optimizer`` reads ``prefix-%04d.states``.  ``kwargs`` go
        to :class:`Module` (``context=`` among them)."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        orig_bind = mod.bind

        def bind_and_set(*a, **kw):
            orig_bind(*a, **kw)
            mod.set_params(args, auxs, allow_missing=False)

        mod.bind = bind_and_set
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        atomic_write_bytes(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())
        self._place_opt_states()

    def _device_put_batch(self, name, t):
        """``DevicePrefetchIter``'s placer: host tensor ``t`` of input
        ``name`` onto the bound array's device and dtype (a copy that does
        not block: ``t`` is pinned, the caller's stream is a side
        stream)."""
        dst = self._exec.arg_dict.get(name) if self._exec is not None \
            else None
        if dst is None:
            return t
        return t.to(dst._t.device, dst._t.dtype, non_blocking=True)
