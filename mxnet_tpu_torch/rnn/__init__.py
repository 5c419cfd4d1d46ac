"""RNN toolkit (``mx.rnn``), counterpart of ``mxnet_tpu/rnn/``: the fused
multi-layer cell backed by the ``RNN`` op, the unfused cells (RNN, LSTM,
GRU), the cells that stack, reverse, drop out or zone out, the bucketing
data iterator and the RNN checkpoint helpers."""

from .io import BucketSentenceIter, encode_sentences
from .rnn import do_rnn_checkpoint, load_rnn_checkpoint, save_rnn_checkpoint
from .rnn_cell import (BaseRNNCell, BidirectionalCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, ModifierCell,
                       RNNCell, RNNParams, SequentialRNNCell, ZoneoutCell)

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell", "FusedRNNCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ModifierCell", "ZoneoutCell", "RNNParams", "BucketSentenceIter",
           "encode_sentences", "save_rnn_checkpoint",
           "load_rnn_checkpoint", "do_rnn_checkpoint"]
