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
``BucketingModule`` needs.  Multi-device contexts, meshes and the fused
single-step ``MXNET_FUSE_TRAIN_STEP``/``run_bulk`` paths are not ported
yet.
"""

from __future__ import annotations

import logging

from .. import optimizer as opt
from ..base import MXNetError
from ..context import Context, gpu
from ..executor import Executor
from ..initializer import InitDesc, Uniform
from ..model import _create_kvstore
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
        """Copy a host batch onto the bound arrays (the device copy)."""
        for name, src in zip(names, arrays or []):
            dst = self._exec.arg_dict.get(name)
            if dst is None:
                continue
            if tuple(src.shape) != dst.shape:
                raise MXNetError("input %r shape %s != bound shape %s"
                                 % (name, tuple(src.shape), dst.shape))
            dst[:] = src

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._load_io([n for n, _ in self._data_shapes], data_batch.data)
        if self._label_shapes and data_batch.label:
            self._load_io([n for n, _ in self._label_shapes],
                          data_batch.label)
        self._exec.forward(is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        names = [n for n in self._param_names
                 if self._exec.grad_dict.get(n) is not None]
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
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())
