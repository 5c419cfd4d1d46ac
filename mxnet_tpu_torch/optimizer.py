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
differ once the learning rate changes.  lr and wd are read from a tensor
on the parameters' device (:func:`hyper_tensor`), in both the eager
update and the captured fused step: a Python float would be baked into a
captured CUDA graph.  ``Updater.get_states``/``set_states`` pickle the
states in the JAX package's format, and read its files.
"""

from __future__ import annotations

import io
import pickle

import torch

from .base import MXNetError, Registry
from .ndarray import NDArray, zeros

__all__ = ["Optimizer", "SGD", "create", "register", "Updater",
           "get_updater", "sgd_step_math", "lr_wd_groups", "hyper_tensor",
           "load_states"]

registry = Registry("optimizer")
register = registry.register


def lr_wd_groups(lrs, wds):
    """``(groups, values)``: the indices of the tensors that share one
    ``(lr, wd)``, in order of first appearance, and ``values``, the
    ``[[lr, ...], [wd, ...]]`` of the groups."""
    first = {}
    for i, pair in enumerate(zip(lrs, wds)):
        first.setdefault(pair, []).append(i)
    return (tuple(tuple(v) for v in first.values()),
            [[p[0] for p in first], [p[1] for p in first]])


def hyper_tensor(values, device):
    """``values`` as a float32 tensor on ``device``; on a card one
    non-blocking copy from pinned memory (the caching host allocator does
    not hand the pinned block out again before the copy has run)."""
    host = torch.tensor(values, dtype=torch.float32)
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def sgd_step_math(params, grads, moms, groups, hyper, momentum, rescale,
                  clip):
    """One SGD(-momentum) step over lists of tensors, in place on
    ``params`` and ``moms`` (empty without momentum).  ``hyper`` is a
    float32 tensor of shape ``(2, len(groups))`` on the parameters'
    device: ``groups[j]`` lists the indices of the tensors whose lr is
    ``hyper[0, j]`` and wd ``hyper[1, j]``.  Nothing is read back to the
    host, so the step can be captured."""
    g = torch._foreach_mul(grads, rescale)
    if clip is not None and clip > 0:
        torch._foreach_clamp_min_(g, -clip)
        torch._foreach_clamp_max_(g, clip)
    for j, idx in enumerate(groups):
        gj = [g[i] for i in idx]
        torch._foreach_add_(gj, torch._foreach_mul([params[i] for i in idx],
                                                   hyper[1, j]))
        torch._foreach_mul_(gj, hyper[0, j])
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
        groups, values = lr_wd_groups([self._get_lr(i) for i in indices],
                                      [self._get_wd(i) for i in indices])
        params = [w._t for w in weights]
        with torch.no_grad():
            sgd_step_math(
                params, [g._t for g in grads],
                [s._t for s in states] if self.momentum != 0.0 else [],
                groups, hyper_tensor(values, params[0].device),
                self.momentum, self.rescale_grad, self.clip_gradient)


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return registry.create(name, **kwargs)


class _StatesUnpickler(pickle.Unpickler):
    """Reads an optimizer-state pickle of this package or of the JAX
    package (whose arrays name ``mxnet_tpu.ndarray.NDArray``) without
    importing the JAX package: both NDArray classes map to this package's,
    numpy's array reconstructors to themselves, and any other class is
    refused, so a state file runs no other code."""

    _NUMPY = {"_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"}

    def find_class(self, module, name):
        if name == "NDArray" and module in ("mxnet_tpu.ndarray",
                                            "mxnet_tpu_torch.ndarray"):
            return NDArray
        if name in self._NUMPY and module in (
                "numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                "numpy.core.numeric", "numpy._core.numeric"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            "optimizer states: class %s.%s is not allowed" % (module, name))


def load_states(blob):
    """``{index: NDArray or None}`` from the bytes of
    :meth:`Updater.get_states` (of either package), arrays on the CPU or
    on the device they were pickled from."""
    try:
        return _StatesUnpickler(io.BytesIO(blob)).load()
    except (pickle.UnpicklingError, EOFError, AttributeError,
            ValueError) as e:
        raise MXNetError("cannot read optimizer states: %s" % e) from e


class Updater:
    """Per-index optimizer states; ``updater(index, grad, weight)``."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def set_states(self, states):
        """Replace the states by a pickle of ``{index: state}`` (the bytes
        of :meth:`get_states`, of either package)."""
        self.states = load_states(states)

    def get_states(self):
        return pickle.dumps(self.states)


def get_updater(optimizer):
    return Updater(optimizer)
