"""Training-loop plumbing (counterpart of ``mxnet_tpu/model.py``):
:class:`BatchEndParam` and :func:`_create_kvstore`.  The key-value store
and distributed training are not ported yet."""

from __future__ import annotations

from .base import MXNetError

__all__ = ["BatchEndParam"]


class BatchEndParam:
    """What a batch-end callback receives."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)``: one device and a non-distributed
    store need none, as in the JAX package; anything else is not ported
    yet."""
    if kvstore is None:
        return None, False
    if isinstance(kvstore, str) and num_device == 1 \
            and "dist" not in kvstore and kvstore != "mesh":
        return None, False
    raise MXNetError("kvstore %r on %d device(s) is not ported yet"
                     % (kvstore, num_device))
