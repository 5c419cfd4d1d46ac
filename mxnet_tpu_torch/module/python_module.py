"""Modules written in Python (counterpart of
``mxnet_tpu/module/python_module.py``): :class:`PythonModule`, the
module API as no-ops for a parameterless computation that takes part in
``SequentialModule`` chains and the ``fit`` loop, and
:class:`PythonLossModule`, a loss head whose forward passes the scores
through and whose backward is a user gradient function.

The gradient function gets the scores and labels as NDArrays on the
module's device and may return an NDArray or anything numpy takes; the
preceding module's ``backward`` moves it to its device.
"""

from __future__ import annotations

import logging

import numpy as np

from .. import ndarray as nd
from ..initializer import Uniform
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Most of the module API as no-ops: a Python step without
    parameters."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = None if label_names is None \
            else list(label_names)
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # -- names and shapes -------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names or []

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # -- parameters (none) -------------------------------------------------
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        """The outputs are scores, held against the labels."""
        if self._label_shapes is None:
            return
        eval_metric.update(labels, self.get_outputs())

    # -- setup ------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        assert grad_req == "write", \
            "Python module only supports write gradient"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        names = [x[0] for x in data_shapes]
        assert names == self._data_names, \
            "data_shapes names %s != %s" % (names, self._data_names)
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        if label_shapes is not None:
            assert self._label_names is not None
            assert [x[0] for x in label_shapes] == self._label_names
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        """Subclass hook: the output shapes from the data and label
        shapes."""
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """A loss head: forward passes the scores through, backward calls
    ``grad_func(scores, labels)``."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        assert len(self._data_names) == 1
        assert self._label_names is None or len(self._label_names) == 1
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None:
            assert callable(grad_func)
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train and data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "PythonLossModule is a loss head"
        assert self.for_training
        self._backward_impl()

    def _backward_impl(self):
        """The loss's gradient with respect to the scores, from
        ``grad_func``; without one it raises."""
        if self._grad_func is None:
            raise NotImplementedError()
        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, nd.NDArray):
            grad = nd.array(np.asarray(grad))
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores_grad]
