"""RNN checkpoint helpers (counterpart of ``mxnet_tpu/rnn/rnn.py``):
:func:`save_rnn_checkpoint`, :func:`load_rnn_checkpoint` and the epoch-end
:func:`do_rnn_checkpoint`.

A fused cell keeps its weights as one packed blob; a checkpoint holds them
unpacked into per-gate arrays (``unpack_weights``), the form an unfused
graph reads, and loading packs them again (``pack_weights``).
"""

from ..model import load_checkpoint, save_checkpoint
from .rnn_cell import BaseRNNCell

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]


def _as_cell_list(cells):
    if isinstance(cells, BaseRNNCell):
        return [cells]
    return list(cells)


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """``model.save_checkpoint`` with every cell's weights unpacked."""
    for cell in _as_cell_list(cells):
        arg_params = cell.unpack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint, every cell's
    weights packed again."""
    sym, arg, aux = load_checkpoint(prefix, epoch)
    for cell in _as_cell_list(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback: :func:`save_rnn_checkpoint` every ``period``
    epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
