"""RNN toolkit (``mx.rnn``), counterpart of ``mxnet_tpu/rnn/``: the fused
multi-layer cell backed by the ``RNN`` op, the cells that stack it, the
bucketing data iterator and the RNN checkpoint helpers.  The unfused
cells are not ported yet."""

from .io import BucketSentenceIter, encode_sentences
from .rnn import do_rnn_checkpoint, load_rnn_checkpoint, save_rnn_checkpoint
from .rnn_cell import (BaseRNNCell, DropoutCell, FusedRNNCell, RNNParams,
                       SequentialRNNCell)

__all__ = ["BaseRNNCell", "FusedRNNCell", "SequentialRNNCell",
           "DropoutCell", "RNNParams", "BucketSentenceIter",
           "encode_sentences", "save_rnn_checkpoint",
           "load_rnn_checkpoint", "do_rnn_checkpoint"]
