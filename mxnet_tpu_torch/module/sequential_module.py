"""``SequentialModule`` (counterpart of
``mxnet_tpu/module/sequential_module.py``): modules run back to back,
the data flowing from stage i to stage i+1 and the gradients back.

``add(module, take_labels=..., auto_wiring=...)``: a ``take_labels``
stage binds with the real label shapes and is the one ``update_metric``
asks (a loss head); the others bind without labels.  An ``auto_wiring``
stage takes the previous stage's outputs under its own ``data_names``,
in order.  Every stage after the first binds with ``inputs_need_grad``
in training, so the backward reaches the first.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

from ..initializer import Uniform
from ..io import DataBatch
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class _Stage(NamedTuple):
    module: object
    meta: dict  # the add() keywords as given

    @property
    def take_labels(self):
        return bool(self.meta.get(SequentialModule.META_TAKE_LABELS, False))

    @property
    def auto_wiring(self):
        return bool(self.meta.get(SequentialModule.META_AUTO_WIRING, False))


class SequentialModule(BaseModule):
    """A chain of modules."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._stages = []
        self._label_shapes = None

    @property
    def _modules(self):
        return [s.module for s in self._stages]

    @property
    def _metas(self):
        return [s.meta for s in self._stages]

    def add(self, module, **kwargs):
        """Append ``module`` as the next stage; returns ``self``.  Keywords
        are the ``META_*`` names of this class (a subclass may add some)."""
        known = {getattr(type(self), a) for a in dir(type(self))
                 if a.startswith("META_")}
        unknown = set(kwargs) - known
        if unknown:
            raise ValueError("Unknown meta %s (known: %s)"
                             % (sorted(unknown), sorted(known)))
        self._stages.append(_Stage(module=module, meta=dict(kwargs)))
        # a new stage: bind, init and the optimizer start again
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    # -- names and shapes -------------------------------------------------
    @property
    def data_names(self):
        return self._stages[0].module.data_names if self._stages else []

    @property
    def output_names(self):
        return self._stages[-1].module.output_names if self._stages else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._stages[0].module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._stages[-1].module.output_shapes

    # -- parameters -------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for stage in self._stages:
            arg, aux = stage.module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for stage in self._stages:
            stage.module.init_params(
                initializer=initializer, arg_params=arg_params,
                aux_params=aux_params, allow_missing=allow_missing,
                force_init=force_init)
        self._assert_unique_param_names()
        self.params_initialized = True

    def _assert_unique_param_names(self):
        """A parameter name in two stages would shadow one in
        ``get_params``: raise, naming both stages."""
        owner = {}
        for i, stage in enumerate(self._stages):
            arg, aux = stage.module.get_params()
            for name in list(arg) + list(aux):
                if name in owner:
                    raise ValueError(
                        "Duplicated parameter name %r: stage %d (%s) and "
                        "stage %d (%s)" % (
                            name, owner[name],
                            type(self._stages[owner[name]].module).__name__,
                            i, type(stage.module).__name__))
                owner[name] = i

    # -- bind and optimizer -------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if inputs_need_grad:
            assert for_training
        assert shared_module is None, "Shared module is not supported"
        assert self._stages, "Attempting to bind an empty Sequential"
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

        flowing_shapes = data_shapes
        for i, stage in enumerate(self._stages):
            if stage.auto_wiring:
                names = stage.module.data_names
                assert len(names) == len(flowing_shapes)
                flowing_shapes = [
                    (name, shape)
                    for name, (_, shape) in zip(names, flowing_shapes)]
            stage.module.bind(
                data_shapes=flowing_shapes,
                label_shapes=label_shapes if stage.take_labels else None,
                for_training=for_training,
                inputs_need_grad=bool(
                    for_training and (inputs_need_grad or i > 0)),
                force_rebind=force_rebind, shared_module=None,
                grad_req=grad_req)
            flowing_shapes = stage.module.output_shapes

        self._label_shapes = label_shapes \
            if any(s.take_labels for s in self._stages) else None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for stage in self._stages:
            stage.module.init_optimizer(
                kvstore=kvstore, optimizer=optimizer,
                optimizer_params=optimizer_params, force_init=force_init)
        self.optimizer_initialized = True

    # -- compute ----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = data_batch
        for i, stage in enumerate(self._stages):
            stage.module.forward(batch, is_train=is_train)
            if i + 1 == len(self._stages):
                break
            outputs = stage.module.get_outputs()
            names = [x.name if hasattr(x, "name") else x[0]
                     for x in stage.module.output_shapes]
            assert len(names) == len(outputs)
            # the outputs become the next stage's data; the labels ride
            # along for a take_labels stage
            batch = DataBatch(
                data=outputs, label=batch.label, pad=batch.pad,
                index=batch.index,
                provide_data=[(n, x.shape) for n, x in zip(names, outputs)],
                provide_label=batch.provide_label)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i in range(len(self._stages) - 1, -1, -1):
            self._stages[i].module.backward(out_grads=out_grads)
            if i > 0:
                out_grads = self._stages[i].module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        for stage in self._stages:
            stage.module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._stages[-1].module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._stages[0].module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for stage in self._stages:
            if stage.take_labels:
                stage.module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for stage in self._stages:
            stage.module.install_monitor(mon)
