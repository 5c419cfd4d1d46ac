"""RNN toolkit (``mx.rnn``), counterpart of ``mxnet_tpu/rnn/``: the fused
multi-layer cell backed by the ``RNN`` op, the cells that stack it, and
the bucketing data iterator.  The unfused cells and the RNN checkpoint
helpers (``rnn/rnn.py``) are not ported yet."""

from .io import BucketSentenceIter, encode_sentences
from .rnn_cell import (BaseRNNCell, DropoutCell, FusedRNNCell, RNNParams,
                       SequentialRNNCell)

__all__ = ["BaseRNNCell", "FusedRNNCell", "SequentialRNNCell",
           "DropoutCell", "RNNParams", "BucketSentenceIter",
           "encode_sentences"]
