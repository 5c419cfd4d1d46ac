"""Weights carried across from the JAX package: numpy dicts and the params
blob ``mxnet_tpu.serving.save_model`` writes, as torch tensors, and a
``Module``'s or ``BucketingModule``'s parameters in and out as numpy (so
both packages can start a training run from the same weights).  A fused
RNN parameter blob (``lstm_parameters``) crosses as it is: its layout is
the same in both packages (``ops/rnn.py``)."""

from __future__ import annotations

import numpy as np
import torch

from .predict import load_ndarray_file

__all__ = ["params_from_numpy", "params_from_blob", "set_module_params",
           "module_params_to_numpy"]


def params_from_numpy(params, device):
    """``{name: np.ndarray}`` -> ``{name: torch.Tensor}`` on ``device``
    (contiguous copies; float64 stays float64)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v).copy()).to(device)
            for k, v in params.items()}


def params_from_blob(blob, device):
    """A dmlc or npz params blob (bytes or path) -> tensors on ``device``;
    ``arg:``/``aux:`` prefixes are dropped."""
    raw = load_ndarray_file(blob)
    return params_from_numpy(
        {k[4:] if k.startswith(("arg:", "aux:")) else k: v
         for k, v in raw.items()}, device)


def set_module_params(module, arg_params, aux_params):
    """Copy ``{name: np.ndarray}`` dicts (e.g. the JAX package's
    ``Module.get_params()`` as numpy) into a bound port ``Module`` or
    ``BucketingModule``; every parameter and auxiliary state must be
    present."""
    module.set_params({k: np.asarray(v) for k, v in arg_params.items()},
                      {k: np.asarray(v) for k, v in aux_params.items()})


def module_params_to_numpy(module):
    """A port module's ``(arg_params, aux_params)`` as numpy dicts."""
    arg, aux = module.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})
