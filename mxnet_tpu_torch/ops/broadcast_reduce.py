"""Broadcast binary ops on the served path (counterpart of
``mxnet_tpu/ops/broadcast_reduce.py``): ``broadcast_add`` and
``broadcast_mul``."""

from __future__ import annotations

import torch

from .registry import simple

simple("broadcast_add", torch.add, arguments=("lhs", "rhs"),
       aliases=("broadcast_plus",))
simple("broadcast_mul", torch.mul, arguments=("lhs", "rhs"))
