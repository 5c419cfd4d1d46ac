"""The causal transformer LM of ``example/long-context/train_lm.py``
(``build_lm``), built through this package's ``mx.sym`` with the same
argument names, so the graph and its params match the JAX package's, and
the example's data helper ``copy_task``."""

from __future__ import annotations

import numpy as np

from .. import symbol as sym

__all__ = ["build_lm", "copy_task"]


def build_lm(vocab, embed, heads, seq):
    """One causal transformer block + LM head; the output is
    SoftmaxOutput over (batch*seq, vocab)."""
    data = sym.Variable("data")                      # (B, L) token ids
    x = sym.Embedding(data, input_dim=vocab, output_dim=embed, name="embed")
    pos = sym.Variable("pos_weight", shape=(1, seq, embed))
    x = sym.broadcast_add(x, pos)
    qkv_w = sym.Variable("att_qkv_weight")
    out_w = sym.Variable("att_out_weight")
    att = sym.MultiHeadAttention(x, x, qkv_w, out_w, num_heads=heads,
                                 causal=True, no_bias=True, name="att")
    h = x + att                                      # residual
    h = sym.Activation(sym.FullyConnected(
        h, num_hidden=2 * embed, flatten=False, name="ffn1"),
        act_type="relu")
    h = sym.FullyConnected(h, num_hidden=embed, flatten=False, name="ffn2")
    pred = sym.Reshape(h, shape=(-1, embed))
    pred = sym.FullyConnected(pred, num_hidden=vocab, name="head")
    label = sym.Reshape(sym.Variable("softmax_label"), shape=(-1,))
    return sym.SoftmaxOutput(pred, label, name="softmax")


def copy_task(n, seq, vocab, rs):
    """``n`` sequences of the example's identity-shift task from the
    ``np.random.RandomState`` ``rs``: token ids in ``[1, vocab)``, label t
    the token at t-1 (the first label the first token), both f32; the
    example's draws in its order, so one seed gives both packages the same
    data."""
    x = rs.randint(1, vocab, (n, seq)).astype(np.float32)
    y = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    return x, y
