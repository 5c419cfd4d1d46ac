"""Optimizers (``mx.optimizer``), counterpart of ``mxnet_tpu/optimizer.py``:
the :class:`Optimizer` base with lr/wd multipliers and update-count driven
scheduling, :class:`SGD`, :class:`Adam`, the rest of the JAX package's
(:class:`NAG`, :class:`DCASGD`, :class:`SGLD`, :class:`ccSGD`,
:class:`AdaGrad`, :class:`RMSProp`, :class:`AdaDelta`, :class:`Test`:
its arithmetic in its order, in place, on the weights' device),
:func:`create`, :class:`Updater` and :func:`get_updater`.

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
states in the JAX package's format (its NDArray class name included), so
each package reads the other's files.

:class:`Adam` is the JAX package's (``mxnet_tpu/optimizer.py:242-272``)
with the arithmetic of its ``adam_update`` op
(``mxnet_tpu/ops/optimizer_op.py:54-62``), in place, one parameter at a
time (the Module's per-index :class:`Updater` path): rescale, clip, then
``+ wd * w``; ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)``; epsilon
outside the square root.  Its state is the tuple ``(mean, var)``;
:func:`state_arrays` and :func:`map_state` walk such states (a state is
None, an NDArray, or a tuple or list of states), as the JAX package's
``_spec`` does.
"""

from __future__ import annotations

import io
import math
import pickle

import torch

from .base import MXNetError, Registry
from .ndarray import NDArray, zeros
from . import random as _random

__all__ = ["Optimizer", "SGD", "NAG", "DCASGD", "SGLD", "ccSGD", "Adam",
           "AdaGrad", "RMSProp", "AdaDelta", "Test", "create", "register",
           "Updater",
           "get_updater", "sgd_step_math", "lr_wd_groups",
           "hyper_tensor", "dumps_states", "load_states", "state_arrays",
           "map_state"]

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


@register
class Adam(Optimizer):
    """Adam with the bias-corrected effective lr of the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context, dtype=weight.dtype),
                zeros(weight.shape, weight.context, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = (s._t for s in state)
        b1, b2 = self.beta1, self.beta2
        with torch.no_grad():
            # adam_update's arithmetic, in its order
            g = grad._t * self.rescale_grad
            if self.clip_gradient is not None and self.clip_gradient > 0:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            g = g + wd * weight._t
            mean.copy_(b1 * mean + (1 - b1) * g)
            var.copy_(b2 * var + (1 - b2) * torch.square(g))
            weight._t.sub_(lr * mean / (torch.sqrt(var) + self.epsilon))


def _scaled_grad(opt, grad):
    """``grad * rescale_grad``, clipped to ``[-clip, clip]`` whenever
    ``clip_gradient`` is set (the NDArray-arithmetic optimizers of the JAX
    package clip at any value; its fused ops only above 0)."""
    g = grad._t * opt.rescale_grad
    if opt.clip_gradient is not None:
        g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
    return g


def _prep(opt, grad, weight, wd):
    """The JAX package's fused-op ``_prep``: rescale, clip above 0, then
    ``+ wd * weight``."""
    g = grad._t * opt.rescale_grad
    if opt.clip_gradient is not None and opt.clip_gradient > 0:
        g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
    return g + wd * weight._t


@register
class NAG(SGD):
    """Nesterov momentum (``mxnet_tpu/optimizer.py`` NAG): ``m = momentum
    * m + g + wd * w``, ``w -= lr * (g + wd * w + momentum * m)``."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._t
        with torch.no_grad():
            g = _scaled_grad(self, grad)
            if state is not None:
                mom = state._t
                mom.mul_(self.momentum)
                g += wd * w
                mom += g
                g += self.momentum * mom
                w += -lr * g
            else:
                w += -lr * (g + wd * w)


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD (``mxnet_tpu/optimizer.py`` DCASGD).  Its
    state is ``(momentum or None, the weight of the last update)``."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (zeros(weight.shape, weight.context), weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mon, previous = state
        w = weight._t
        with torch.no_grad():
            g = _scaled_grad(self, grad)
            delay = g + self.lamda * g * g * (w - previous._t)
            step = -lr * (delay + wd * w)
            if mon is not None:
                mon._t.mul_(self.momentum)
                mon._t += step
                step = mon._t
            previous._t.copy_(w)
            w += step


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (``mxnet_tpu/optimizer.py``
    SGLD): ``w += -lr / 2 * (g + wd * w) + N(0, lr)``.  The noise is drawn
    on the CPU from ``generator``, by default ``mx.random``'s run-time
    generator of the CPU (seeded by ``mx.random.seed``, carried by
    ``get_state``/``set_state``, so a resumed fit draws the uninterrupted
    noise), and copied to the weight's device, so a seed gives the same
    noise on every device; it never matches the JAX package's threefry
    draws."""

    def __init__(self, generator=None, **kwargs):
        super().__init__(**kwargs)
        self.generator = generator

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._t
        gen = self.generator if self.generator is not None \
            else _random.generator("cpu")
        noise = torch.empty(w.shape, dtype=w.dtype).normal_(
            0.0, math.sqrt(lr), generator=gen).to(w.device)
        with torch.no_grad():
            g = _scaled_grad(self, grad)
            w += (-lr / 2) * (g + wd * w) + noise


@register
class ccSGD(SGD):
    """The reference's C-side SGD: the same update as :class:`SGD`."""


@register
class AdaGrad(Optimizer):
    """``mxnet_tpu/optimizer.py`` AdaGrad: ``h += g^2``, ``w -= lr * (g /
    sqrt(h + eps) + wd * w)``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w, history = weight._t, state._t
        with torch.no_grad():
            g = _scaled_grad(self, grad)
            history += g * g
            w += -lr * (g / torch.sqrt(history + self.float_stable_eps)
                        + wd * w)


@register
class RMSProp(Optimizer):
    """``mxnet_tpu/optimizer.py`` RMSProp with the arithmetic of its
    ``rmsprop_update`` op (state ``(n,)``) or, with ``centered=True``,
    of ``rmspropalex_update`` (Graves 2013; state ``(n, g, delta)``)
    (``mxnet_tpu/ops/optimizer_op.py``); ``clip_weights`` above 0 clips
    the updated weight."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (zeros(weight.shape, weight.context),
                    zeros(weight.shape, weight.context),
                    zeros(weight.shape, weight.context))
        return (zeros(weight.shape, weight.context),)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g1, w = self.gamma1, weight._t
        with torch.no_grad():
            g = _prep(self, grad, weight, wd)
            n = state[0]._t
            n.copy_((1 - g1) * torch.square(g) + g1 * n)
            if not self.centered:
                new_w = w - lr * g / torch.sqrt(n + self.epsilon)
            else:
                gs, delta = state[1]._t, state[2]._t
                gs.copy_((1 - g1) * g + g1 * gs)
                delta.copy_(self.gamma2 * delta - lr * g / torch.sqrt(
                    n - torch.square(gs) + self.epsilon))
                new_w = w + delta
            cw = self.clip_weights
            if cw is not None and cw > 0:
                new_w = torch.clamp(new_w, -cw, cw)
            w.copy_(new_w)


@register
class AdaDelta(Optimizer):
    """``mxnet_tpu/optimizer.py`` AdaDelta (no learning rate):
    ``acc_g = rho * acc_g + (1 - rho) * g^2``, ``d = sqrt(acc_delta +
    eps) / sqrt(acc_g + eps) * g``, ``acc_delta = rho * acc_delta + (1 -
    rho) * d^2``, ``w -= d + wd * w``."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        acc_g, acc_delta = (s._t for s in state)
        w = weight._t
        with torch.no_grad():
            g = _scaled_grad(self, grad)
            acc_g *= self.rho
            acc_g += (1.0 - self.rho) * g * g
            delta = (torch.sqrt(acc_delta + self.epsilon)
                     / torch.sqrt(acc_g + self.epsilon)) * g
            acc_delta *= self.rho
            acc_delta += (1.0 - self.rho) * delta * delta
            w -= delta + wd * w


@register
class Test(Optimizer):
    """``mxnet_tpu/optimizer.py`` Test: ``w += rescale * g``, the state a
    copy of the new weight (no update count)."""

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight._t += grad._t * self.rescale_grad
            state._t.copy_(weight._t)


def state_arrays(state):
    """The NDArrays of an optimizer state (None, an NDArray, or a tuple or
    list of states), in order."""
    if isinstance(state, NDArray):
        return [state]
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in state_arrays(s)]
    return []


def map_state(fn, state):
    """``state`` with ``fn`` applied to each of its NDArrays, tuples and
    lists kept as they are."""
    if isinstance(state, NDArray):
        return fn(state)
    if isinstance(state, (tuple, list)):
        return type(state)(map_state(fn, s) for s in state)
    return state


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


class _StatesPickler(pickle._Pickler):
    """Pickles optimizer states with this package's NDArray written under
    the JAX package's class name, ``mxnet_tpu.ndarray.NDArray`` (the same
    state keys): the JAX package's plain ``pickle.loads`` then reads the
    file, and :class:`_StatesUnpickler` maps the name back.  The name is
    written as a ``GLOBAL`` opcode, so nothing of the JAX package is
    imported here."""

    def save_global(self, obj, name=None):
        if obj is NDArray:
            self.write(pickle.GLOBAL + b"mxnet_tpu.ndarray\nNDArray\n")
            self.memoize(obj)
            return
        super().save_global(obj, name)


def dumps_states(states):
    """The bytes of an optimizer-state dict ``{index: state}``, readable by
    either package."""
    buf = io.BytesIO()
    _StatesPickler(buf, protocol=pickle.DEFAULT_PROTOCOL).dump(states)
    return buf.getvalue()


def load_states(blob):
    """``{index: state}`` (None, an NDArray, or a tuple of them: Adam's
    ``(mean, var)``) from the bytes of :meth:`Updater.get_states` (of
    either package), arrays on the CPU or on the device they were pickled
    from."""
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
        return dumps_states(self.states)


def get_updater(optimizer):
    return Updater(optimizer)
