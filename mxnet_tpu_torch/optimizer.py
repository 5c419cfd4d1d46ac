"""Optimizers (``mx.optimizer``), counterpart of ``mxnet_tpu/optimizer.py``:
the :class:`Optimizer` base with lr/wd multipliers and update-count driven
scheduling, :class:`SGD`, :func:`create`, :class:`Updater` and
:func:`get_updater`.

The SGD step is the JAX package's ``sgd_step_math``
(``mxnet_tpu/executor.py:414-429``), here over lists of tensors with
PyTorch's multi-tensor ``_foreach`` ops, in place:
``g = clip(rescale * grad) + wd * p``, ``m = momentum * m - lr * g``,
``p += m`` (without momentum ``p -= lr * g``).  ``torch.optim.SGD`` is not
used: its momentum buffer holds the un-scaled gradient sum, so the two
differ once the learning rate changes.
"""

from __future__ import annotations

import torch

from .base import Registry
from .ndarray import zeros

__all__ = ["Optimizer", "SGD", "create", "register", "Updater",
           "get_updater", "sgd_step_math"]

registry = Registry("optimizer")
register = registry.register


def sgd_step_math(params, grads, moms, lrs, wds, momentum, rescale, clip):
    """One SGD(-momentum) step over lists of tensors, in place on
    ``params`` and ``moms``; ``lrs``/``wds`` hold one float per tensor."""
    g = torch._foreach_mul(grads, rescale)
    if clip is not None and clip > 0:
        torch._foreach_clamp_min_(g, -clip)
        torch._foreach_clamp_max_(g, clip)
    torch._foreach_add_(g, torch._foreach_mul(params, wds))
    torch._foreach_mul_(g, lrs)
    if momentum != 0.0:
        torch._foreach_mul_(moms, momentum)
        torch._foreach_sub_(moms, g)
        torch._foreach_add_(params, moms)
    else:
        torch._foreach_sub_(params, g)


class Optimizer:
    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    # -- lr/wd multipliers ------------------------------------------------
    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """wd_mult 0 for every parameter whose name ends in neither
        ``_weight`` nor ``_gamma``, then the ``__wd_mult__`` attributes,
        then ``args_wd_mult``.  Like the JAX package, the constructor does
        not call this: weight decay applies to every parameter unless the
        caller does."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd


@register
class SGD(Optimizer):
    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self.update_multi([index], [weight], [grad], [state])

    def update_multi(self, indices, weights, grads, states):
        """One step for many parameters whose update counts were already
        advanced (the Module's fused path)."""
        with torch.no_grad():
            sgd_step_math(
                [w._t for w in weights], [g._t for g in grads],
                [s._t for s in states] if self.momentum != 0.0 else [],
                [self._get_lr(i) for i in indices],
                [self._get_wd(i) for i in indices], self.momentum,
                self.rescale_grad, self.clip_gradient)


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return registry.create(name, **kwargs)


class Updater:
    """Per-index optimizer states; ``updater(index, grad, weight)``."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
