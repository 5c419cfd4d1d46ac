"""The PTB-style fused-LSTM language model (BASELINE config #3), the
port's copy of ``example/rnn/fused_lstm_bucketing.py`` (``build_cell``,
``make_sym_gen``) and of the Markov-chain corpus of
``example/rnn/lstm_bucketing.py`` (``synth_corpus``), built through this
package's ``mx.sym`` and ``mx.rnn`` with the same argument names, so the
graphs and their parameters match the JAX package's.

The example's arguments become keywords with its defaults (2 layers, 200
hidden, 200 embedding, dropout 0), unidirectional and in the TNC layout,
the only forms this slice runs; ``vocab_size``
defaults to 10,000, the size of the PTB word vocabulary (the example's
``--vocab-size 100`` only sizes its synthetic stand-in corpus).
"""

from __future__ import annotations

import numpy as np

from .. import rnn
from .. import symbol as sym

__all__ = ["BUCKETS", "START_TOKEN", "PTB_VOCAB", "synth_corpus",
           "build_cell", "make_sym_gen"]

BUCKETS = (10, 20, 30, 40, 50, 60)
START_TOKEN = 2  # 0 = pad/invalid, 1 = unk
PTB_VOCAB = 10000


def synth_corpus(num_sentences, vocab, seed=3, buckets=BUCKETS):
    """Markov-chain sentences: each token strongly prefers a few
    successors, so a real LM beats the unigram baseline by a wide margin.
    One fixed transition table for every split; ``seed`` picks which
    sentences are sampled from it, ``buckets`` their lengths (each a
    bucket length less 0-4)."""
    succ = np.random.RandomState(42).randint(START_TOKEN, vocab,
                                             size=(vocab, 3))
    rs = np.random.RandomState(seed)
    sents = []
    for _ in range(num_sentences):
        n = int(rs.choice(list(buckets))) - rs.randint(0, 5)
        tok = int(rs.randint(START_TOKEN, vocab))
        sent = [tok]
        for _ in range(max(n, 2) - 1):
            tok = int(succ[tok, rs.randint(0, 3)]) \
                if rs.rand() < 0.9 else int(rs.randint(START_TOKEN, vocab))
            sent.append(tok)
        sents.append(sent)
    return sents


def build_cell(num_hidden=200, num_layers=2, stack_rnn=False, dropout=0.0):
    """One ``FusedRNNCell`` of ``num_layers`` LSTM layers, or with
    ``stack_rnn`` one per layer with a ``DropoutCell`` between them."""
    if stack_rnn:
        cell = rnn.SequentialRNNCell()
        for i in range(num_layers):
            cell.add(rnn.FusedRNNCell(num_hidden, num_layers=1, mode="lstm",
                                      prefix="lstm_l%d_" % i))
            if dropout > 0 and i < num_layers - 1:
                cell.add(rnn.DropoutCell(dropout, prefix="lstm_d%d_" % i))
        return cell
    return rnn.FusedRNNCell(num_hidden, num_layers=num_layers, mode="lstm",
                            dropout=dropout)


def make_sym_gen(cell, vocab_size=PTB_VOCAB, num_embed=200, num_hidden=200):
    """``sym_gen(seq_len) -> (symbol, ("data",), ("softmax_label",))``:
    Embedding, the cell unrolled over ``seq_len`` steps in the TNC
    layout, FullyConnected to
    the vocabulary and SoftmaxOutput, as ``BucketingModule`` takes it."""
    def sym_gen(seq_len):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(data=data, input_dim=vocab_size,
                              output_dim=num_embed, name="embed")
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True,
                                 layout="TNC")
        pred = sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = sym.FullyConnected(data=pred, num_hidden=vocab_size,
                                  name="pred")
        label = sym.Reshape(label, shape=(-1,))
        pred = sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen
