"""Indexing and init ops (counterpart of ``mxnet_tpu/ops/indexing.py``):
``Embedding``, ``ones_like``, ``zeros_like`` and ``_zeros``, the one op
with no input (its output lies on ``registry.scope_device()``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import (REQUIRED, pdtype, pint, ptuple, scope_device, simple,
                       torch_dtype)


def _embedding(data, weight, input_dim, output_dim, dtype):
    # ids arrive as float32 (Predictor.set_input casts every input)
    return F.embedding(data.long(), weight)


simple("Embedding", _embedding, arguments=("data", "weight"),
       params={"input_dim": (pint, REQUIRED), "output_dim": (pint, REQUIRED),
               "dtype": (pdtype, "float32")})

simple("_zeros", lambda shape, dtype: torch.zeros(
    shape, dtype=torch_dtype(dtype), device=scope_device()), arguments=(),
    params={"shape": (ptuple, REQUIRED), "dtype": (pdtype, "float32")})
simple("ones_like", torch.ones_like)
simple("zeros_like", torch.zeros_like)
