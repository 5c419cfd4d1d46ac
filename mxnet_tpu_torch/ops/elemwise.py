"""Elementwise ops (counterpart of ``mxnet_tpu/ops/elemwise.py``): the
binary ``elemwise_add/sub/mul/div`` that ``Symbol``'s arithmetic emits,
the scalar forms ``_plus/_minus/_rminus/_mul/_div/_rdiv_scalar``,
``smooth_l1`` and ``BlockGrad`` (``stop_gradient``).
Each is one torch op (cuBLAS-free elementwise kernels on the card), as
XLA lowers them in the JAX package."""

from __future__ import annotations

import torch

from .registry import REQUIRED, pfloat, simple

simple("elemwise_add", torch.add, arguments=("lhs", "rhs"),
       aliases=("_plus", "_add"))
simple("elemwise_sub", torch.sub, arguments=("lhs", "rhs"),
       aliases=("_minus", "_sub"))
simple("elemwise_mul", torch.mul, arguments=("lhs", "rhs"),
       aliases=("_mul",))
simple("elemwise_div", torch.div, arguments=("lhs", "rhs"),
       aliases=("_div",))


def _scalar_op(name, fn):
    simple(name, fn, params={"scalar": (pfloat, REQUIRED)})


_scalar_op("_plus_scalar", lambda data, scalar: data + scalar)
_scalar_op("_minus_scalar", lambda data, scalar: data - scalar)
_scalar_op("_rminus_scalar", lambda data, scalar: scalar - data)
_scalar_op("_mul_scalar", lambda data, scalar: data * scalar)
_scalar_op("_div_scalar", lambda data, scalar: data / scalar)
_scalar_op("_rdiv_scalar", lambda data, scalar: scalar / data)


def _smooth_l1(data, scalar):
    s2 = scalar * scalar
    return torch.where(torch.abs(data) < 1.0 / s2,
                       0.5 * torch.square(scalar * data),
                       torch.abs(data) - 0.5 / s2)


simple("smooth_l1", _smooth_l1, params={"scalar": (pfloat, 1.0)})
# the identity whose gradient is zero (``jax.lax.stop_gradient``)
simple("BlockGrad", torch.Tensor.detach, aliases=("stop_gradient",))
