"""The PTB-style LSTM language model (BASELINE config #3): the port's copy
of ``example/rnn/fused_lstm_bucketing.py`` (``build_cell``,
``make_sym_gen``), of ``example/rnn/lstm_bucketing.py``'s unfused stack
(``build_stack``: ``LSTMCell``s, no kernel of the port) and of its
Markov-chain corpus (``synth_corpus``), built through this package's
``mx.sym`` and ``mx.rnn`` with the same argument and node names, so the
graphs and their parameters match the JAX package's.

The examples' arguments become keywords with their defaults (2 layers,
200 hidden, 200 embedding, dropout 0), unidirectional; the fused model
unrolls in the TNC layout (its iterator's ``layout="TN"``), the unfused
one in ``lstm_bucketing.py``'s NTC (the iterator's default ``"NT"``).
``vocab_size`` defaults to 10,000, the size of the PTB word vocabulary
(the examples' ``--vocab-size 100`` only sizes their synthetic stand-in
corpus).
"""

from __future__ import annotations

import numpy as np

from .. import rnn
from .. import symbol as sym

__all__ = ["BUCKETS", "START_TOKEN", "PTB_VOCAB", "synth_corpus",
           "build_cell", "build_stack", "make_sym_gen"]

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


def build_stack(num_hidden=200, num_layers=2):
    """``lstm_bucketing.py``'s stack: a ``SequentialRNNCell`` of
    ``LSTMCell(prefix="lstm_l%d_")``, whose weights are the names
    ``build_cell(...).unpack_weights`` gives."""
    stack = rnn.SequentialRNNCell()
    for i in range(num_layers):
        stack.add(rnn.LSTMCell(num_hidden=num_hidden,
                               prefix="lstm_l%d_" % i))
    return stack


def make_sym_gen(cell, vocab_size=PTB_VOCAB, num_embed=200, num_hidden=200,
                 layout="TNC"):
    """``sym_gen(seq_len) -> (symbol, ("data",), ("softmax_label",))``:
    Embedding, the cell unrolled over ``seq_len`` steps in ``layout``
    (``"TNC"`` for a ``layout="TN"`` iterator, ``"NTC"`` for ``"NT"``),
    FullyConnected to the vocabulary and SoftmaxOutput, as
    ``BucketingModule`` takes it."""
    def sym_gen(seq_len):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(data=data, input_dim=vocab_size,
                              output_dim=num_embed, name="embed")
        cell.reset()
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True,
                                 layout=layout)
        pred = sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = sym.FullyConnected(data=pred, num_hidden=vocab_size,
                                  name="pred")
        label = sym.Reshape(label, shape=(-1,))
        pred = sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen
