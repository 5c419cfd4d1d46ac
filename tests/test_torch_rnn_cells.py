"""The rest of the PyTorch port's RNN toolkit against the JAX package: the
unfused cells (``RNNCell`` tanh and relu, ``LSTMCell``, ``GRUCell``),
``FusedRNNCell.unfuse``, ``BidirectionalCell``, ``ZoneoutCell``,
``DropoutCell``, ``begin_state(batch_size=)``, merged step outputs, the
ops and ``Symbol`` arithmetic they need, and the unfused LSTM LM of
``example/rnn/lstm_bucketing.py`` through ``BucketingModule.fit``.

Inputs and weights are drawn with numpy from fixed seeds and set in both
packages by name; the JAX side runs on the CPU as ``tests/test_rnn.py``
runs it.  Tolerances: outputs and gradients of one graph ``rtol=atol=
1e-5``; the two-epoch fit ``rtol=1e-4, atol=1e-5``; the unfused stack
against the port's fused cell ``1e-5`` (outputs) and ``1e-4`` (gradients,
f32 sums in another order).

Dropout masks are the port's own draws (``mx.random``'s generator) and
never match the JAX package's threefry masks, so dropout in training is
held to invariants: the kept share, kept elements ``x / keep`` bit for
bit, zeros elsewhere, gradients 0 where dropped, the identity in
inference, repeats from a seed, and the draws of a resumed snapshot.
"""

import json
import random
import signal
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import checkpoint as tck
from mxnet_tpu_torch.models import lstm_lm
from mxnet_tpu_torch.module.base_module import _PreemptGuard
from mxnet_tpu_torch.ops import rnn_kernel

from torch_deadline import deadline  # noqa: F401 (autouse)

T, N, I, H = 4, 3, 5, 6


def _draw(rs, shape, scale):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def _cell(mx, mode, prefix):
    if mode.startswith("rnn_"):
        return mx.rnn.RNNCell(H, activation=mode[4:], prefix=prefix)
    if mode == "lstm":
        return mx.rnn.LSTMCell(H, prefix=prefix)
    return mx.rnn.GRUCell(H, prefix=prefix)


def _merged(mx, outputs, states, axis):
    """Outputs (one symbol or a step list) and the final states as one
    symbol: every state a step more on the time axis."""
    if isinstance(outputs, list):
        outputs = mx.sym.Concat(*[mx.sym.expand_dims(o, axis=axis)
                                  for o in outputs], dim=axis)
    return mx.sym.Concat(outputs, *[mx.sym.expand_dims(s, axis=axis)
                                    for s in states], dim=axis)


def _run(mx, net, shapes, seed, train=True, heads=True):
    """Bind ``net`` on the CPU, fill every argument from ``seed`` (by
    name, so both packages get the same values), run forward (and
    backward with seeded head gradients): (output, {arg: grad})."""
    ex = net.simple_bind(mx.cpu(), grad_req="write" if train else "null",
                         **shapes)
    for name in sorted(ex.arg_dict):
        rs = np.random.RandomState(seed + sum(map(ord, name)))
        arr = ex.arg_dict[name]
        arr[:] = _draw(rs, arr.shape, 0.5)
    out = ex.forward(is_train=train)[0].asnumpy()
    if not train:
        return out, {}
    g = _draw(np.random.RandomState(seed), out.shape, 1.0) if heads \
        else np.ones(out.shape, np.float32)
    ex.backward([mx.nd.array(g)])
    return out, {k: v.asnumpy() for k, v in ex.grad_dict.items()
                 if v is not None}


def _assert_close(got, want, rtol, atol):
    t_out, t_grads = got
    j_out, j_grads = want
    np.testing.assert_allclose(t_out, j_out, rtol=rtol, atol=atol)
    assert sorted(t_grads) == sorted(j_grads)
    for k in j_grads:
        np.testing.assert_allclose(t_grads[k], j_grads[k], rtol=rtol,
                                   atol=atol, err_msg=k)


def _unroll_net(mx, mode, layout, merged_inputs, zeros, merge_outputs):
    with mx.name.NameManager():
        cell = _cell(mx, mode, "c_")
        inputs = mx.sym.Variable("x") if merged_inputs \
            else [mx.sym.Variable("x%d" % t) for t in range(T)]
        begin = cell.begin_state(batch_size=N) if zeros else None
        outputs, states = cell.unroll(T, inputs, begin_state=begin,
                                      layout=layout,
                                      merge_outputs=merge_outputs)
        return _merged(mx, outputs, states, layout.find("T"))


@pytest.mark.parametrize("mode,layout,merged_inputs,zeros,merge_outputs", [
    ("rnn_tanh", "NTC", True, False, True),
    ("rnn_relu", "TNC", False, True, False),
    ("lstm", "NTC", False, True, True),
    ("lstm", "TNC", True, False, False),
    ("lstm", "NTC", True, False, None),
    ("gru", "NTC", True, True, False),
    ("gru", "TNC", False, False, True)])
def test_cell_unroll_matches_jax(mode, layout, merged_inputs, zeros,
                                 merge_outputs):
    """Outputs, final states and every gradient of one unrolled cell, from
    the same weights, inputs and head gradients."""
    if merged_inputs:
        shapes = {"x": (N, T, I) if layout == "NTC" else (T, N, I)}
    else:
        shapes = {"x%d" % t: (N, I) for t in range(T)}
    tnet = _unroll_net(tmx, mode, layout, merged_inputs, zeros,
                       merge_outputs)
    jnet = _unroll_net(jmx, mode, layout, merged_inputs, zeros,
                       merge_outputs)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert [n["name"] for n in json.loads(tnet.tojson())["nodes"]] == \
        [n["name"] for n in json.loads(jnet.tojson())["nodes"]]
    got = _run(tmx, tnet, shapes, 11)
    assert got[0].shape[layout.find("T")] == T + (2 if mode == "lstm"
                                                  else 1)
    _assert_close(got, _run(jmx, jnet, shapes, 11), 1e-5, 1e-5)


def test_begin_state_zeros_and_step_by_step():
    """``begin_state(batch_size=)`` gives ``_zeros`` symbols of the full
    shape, named as the JAX package names them; stepping the cell by hand
    from them equals ``unroll``."""
    for mx in (tmx, jmx):
        cell = mx.rnn.LSTMCell(H, prefix="s_")
        states = cell.begin_state(batch_size=N)
        assert [s.name for s in states] == ["s_begin_state_0",
                                            "s_begin_state_1"]
        assert [s.infer_shape()[1][0] for s in states] == [(N, H)] * 2
    outs = {}
    for mx in (tmx, jmx):
        cell = mx.rnn.LSTMCell(H, prefix="s_")
        states = cell.begin_state(batch_size=N)
        steps = []
        for t in range(T):
            out, states = cell(mx.sym.Variable("x%d" % t), states)
            steps.append(out)
        outs[mx] = _run(mx, _merged(mx, steps, states, 1),
                        {"x%d" % t: (N, I) for t in range(T)}, 5)
    _assert_close(outs[tmx], outs[jmx], 1e-5, 1e-5)


@pytest.mark.parametrize("mode,bidir", [("lstm", False), ("lstm", True),
                                        ("gru", True), ("rnn_tanh", False),
                                        ("rnn_relu", True)])
def test_unfuse_matches_jax_and_the_fused_cell(mode, bidir):
    """``unfuse()`` of a 2-layer fused cell: the JAX ``unfuse()``'s
    argument and node names; with the fused blob unpacked into its
    weights, the fused cell's outputs and, with the fused blob's gradient
    unpacked, its gradients; and the JAX unfused stack's outputs."""
    def nets(mx):
        with mx.name.NameManager():
            fused = mx.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                        bidirectional=bidir, prefix="f_")
            stack = fused.unfuse()
            out, _ = stack.unroll(T, mx.sym.Variable("x"), layout="TNC",
                                  merge_outputs=True)
        with mx.name.NameManager():
            fout, _ = fused.unroll(T, mx.sym.Variable("x"), layout="TNC",
                                   merge_outputs=True)
        return fused, out, fout

    tfused, tnet, tfnet = nets(tmx)
    _jfused, jnet, _ = nets(jmx)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert [n["name"] for n in json.loads(tnet.tojson())["nodes"]] == \
        [n["name"] for n in json.loads(jnet.tojson())["nodes"]]
    shapes = {"x": (T, N, I)}
    unfused = _run(tmx, tnet, shapes, 3)
    _assert_close(unfused, _run(jmx, jnet, shapes, 3), 1e-5, 1e-5)

    # the fused cell from the same weights: pack them into its blob
    ex = tfnet.simple_bind(tmx.cpu(), grad_req="write", **shapes)
    ex_u = tnet.simple_bind(tmx.cpu(), grad_req="write", **shapes)
    for name in sorted(ex_u.arg_dict):
        rs = np.random.RandomState(3 + sum(map(ord, name)))
        ex_u.arg_dict[name][:] = _draw(rs, ex_u.arg_dict[name].shape, 0.5)
    weights = {k: v for k, v in ex_u.arg_dict.items() if k != "x"}
    blob = tfused.pack_weights(weights)["f_parameters"]
    ex.arg_dict["f_parameters"][:] = blob
    ex.arg_dict["x"][:] = ex_u.arg_dict["x"]
    out = ex.forward(is_train=True)[0].asnumpy()
    np.testing.assert_allclose(out, unfused[0], rtol=1e-5, atol=1e-5)
    ex.backward([tmx.nd.array(_draw(np.random.RandomState(3), out.shape,
                                    1.0))])
    grads = tfused.unpack_weights(
        {"f_parameters": ex.grad_dict["f_parameters"]})
    assert sorted(grads) == sorted(weights)
    for k, g in grads.items():
        np.testing.assert_allclose(g.asnumpy(), unfused[1][k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(ex.grad_dict["x"].asnumpy(), unfused[1]["x"],
                               rtol=1e-4, atol=1e-4)


def test_unfuse_with_dropout_names_and_inference():
    """A fused cell with dropout unfuses with a ``DropoutCell`` between
    its layers (the JAX package's names); in inference both are the
    identity there, so the stack equals the fused cell."""
    def net(mx):
        with mx.name.NameManager():
            stack = mx.rnn.FusedRNNCell(H, num_layers=3, mode="lstm",
                                        dropout=0.4).unfuse()
            return stack.unroll(T, mx.sym.Variable("x"), layout="TNC",
                                merge_outputs=True)[0]

    tnet, jnet = net(tmx), net(jmx)
    names = [n["name"] for n in json.loads(tnet.tojson())["nodes"]]
    assert names == [n["name"] for n in json.loads(jnet.tojson())["nodes"]]
    assert sum(1 for n in names if n.startswith("dropout")) == 2 * T
    shapes = {"x": (T, N, I)}
    _assert_close(_run(tmx, tnet, shapes, 8, train=False),
                  _run(jmx, jnet, shapes, 8, train=False), 1e-5, 1e-5)


@pytest.mark.parametrize("mode,bidir", [("lstm", True), ("gru", False)])
def test_pack_unpack_round_trips(mode, bidir):
    """Fused blob -> ``unpack_weights`` -> the unfused stack's
    ``unpack_weights``/``pack_weights`` (identity copies) -> the fused
    ``pack_weights``: the blob bit for bit, and the same dicts as the JAX
    package at every stage."""
    size = tmx.ops.rnn.rnn_param_size(I, H, 2, mode, bidir)
    blob = _draw(np.random.RandomState(4), (size,), 1.0)
    out = {}
    for mx in (tmx, jmx):
        fused = mx.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                    bidirectional=bidir, prefix="f_")
        stack = fused.unfuse()
        w = fused.unpack_weights({"f_parameters": mx.nd.array(blob),
                                  "other": mx.nd.array(blob[:3])})
        w = stack.pack_weights(stack.unpack_weights(w))
        out[mx] = {k: v.asnumpy() for k, v in w.items()}
        np.testing.assert_array_equal(
            fused.pack_weights(w)["f_parameters"].asnumpy(), blob)
    assert sorted(out[tmx]) == sorted(out[jmx])
    for k in out[jmx]:
        np.testing.assert_array_equal(out[tmx][k], out[jmx][k], err_msg=k)


def _bi_sort_net(mx, seq, vocab, embed, hidden):
    """``example/bi-lstm-sort/lstm_sort.py``'s graph."""
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        emb = mx.sym.Embedding(data, input_dim=vocab, output_dim=embed,
                               name="embed")
        bi = mx.rnn.BidirectionalCell(
            mx.rnn.LSTMCell(num_hidden=hidden, prefix="l_"),
            mx.rnn.LSTMCell(num_hidden=hidden, prefix="r_"))
        outputs, _ = bi.unroll(seq, inputs=emb, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, 2 * hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
        label = mx.sym.Reshape(mx.sym.Variable("softmax_label"),
                               shape=(-1,))
        return mx.sym.SoftmaxOutput(pred, label=label, name="softmax")


def test_bidirectional_cell_matches_jax():
    """The bi-lstm-sort graph (seq 5, vocab 7, embed 4, 2 x 3 hidden):
    names, outputs and every gradient."""
    seq, vocab = 5, 7
    tnet = _bi_sort_net(tmx, seq, vocab, 4, 3)
    jnet = _bi_sort_net(jmx, seq, vocab, 4, 3)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert [n["name"] for n in json.loads(tnet.tojson())["nodes"]] == \
        [n["name"] for n in json.loads(jnet.tojson())["nodes"]]
    ids = np.random.RandomState(2).randint(0, vocab, (N, seq))
    res = {}
    for mx, net in ((tmx, tnet), (jmx, jnet)):
        ex = net.simple_bind(mx.cpu(), grad_req="write", data=(N, seq),
                             softmax_label=(N, seq))
        for name in sorted(ex.arg_dict):
            rs = np.random.RandomState(sum(map(ord, name)))
            ex.arg_dict[name][:] = _draw(rs, ex.arg_dict[name].shape, 0.5)
        ex.arg_dict["data"][:] = ids.astype(np.float32)
        ex.arg_dict["softmax_label"][:] = ids[:, ::-1].astype(np.float32)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        res[mx] = (out, {k: v.asnumpy() for k, v in ex.grad_dict.items()
                         if v is not None and k not in ("data",
                                                        "softmax_label")})
    _assert_close(res[tmx], res[jmx], 1e-5, 1e-5)


def _zoneout_net(mx, zo, zs):
    with mx.name.NameManager():
        cell = mx.rnn.ZoneoutCell(mx.rnn.LSTMCell(H, prefix="z_"),
                                  zoneout_outputs=zo, zoneout_states=zs)
        outputs, states = cell.unroll(T, mx.sym.Variable("x"),
                                      merge_outputs=True)
        out = _merged(mx, outputs, states, 1)
        return mx.rnn.DropoutCell(0.0).unroll(T, out, merge_outputs=True)[0]


@pytest.mark.parametrize("zo,zs,train", [(0.0, 0.0, True),
                                         (0.3, 0.2, False)])
def test_zoneout_and_dropout_cells_match_jax(zo, zs, train):
    """At p=0 the modifier and dropout cells change nothing (outputs and
    gradients as the JAX package's); in inference at p>0 the zoneout
    masks are ``Dropout(ones) * (1 - p)`` = ``1 - p`` in both, so the
    mixed outputs and states agree too."""
    shapes = {"x": (N, T, I)}
    tnet, jnet = _zoneout_net(tmx, zo, zs), _zoneout_net(jmx, zo, zs)
    assert tnet.list_arguments() == jnet.list_arguments()
    _assert_close(_run(tmx, tnet, shapes, 6, train=train),
                  _run(jmx, jnet, shapes, 6, train=train), 1e-5, 1e-5)


def test_zoneout_in_training_keeps_either_value():
    """In training each zoned-out unit is the new value or the previous
    one exactly: the output at step 0 is the LSTM's or 0."""
    net = tmx.rnn.ZoneoutCell(tmx.rnn.LSTMCell(H, prefix="z_"),
                              zoneout_outputs=0.5)
    out, _ = net.unroll(1, tmx.sym.Variable("x"), merge_outputs=True)
    plain, _ = tmx.rnn.LSTMCell(H, prefix="z_").unroll(
        1, tmx.sym.Variable("x"), merge_outputs=True)
    tmx.random.seed(3)
    got = _run(tmx, out, {"x": (200, 1, I)}, 2, train=True)[0]
    want = _run(tmx, plain, {"x": (200, 1, I)}, 2, train=False)[0]
    kept = got == want
    assert np.all(kept | (got == 0))
    assert 0.4 < kept.mean() < 0.6


def test_dropout_op_invariants():
    """``Dropout`` at p=0.5 over 120,000 elements: kept share within 0.5
    +- 0.01, kept elements ``x / keep`` bit for bit, dropped ones exactly
    0, the gradient ``1 / keep`` where kept and 0 where dropped, the
    identity in inference; p=0.25 keeps 0.75 +- 0.01."""
    rs = np.random.RandomState(0)
    x = _draw(rs, (300, 400), 1.0)
    x[x == 0] = 1.0
    for p in (0.5, 0.25):
        keep = 1.0 - p
        net = tmx.sym.Dropout(tmx.sym.Variable("x"), p=p)
        ex = net.simple_bind(tmx.cpu(), grad_req="write", x=x.shape)
        ex.arg_dict["x"][:] = x
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([tmx.nd.array(np.ones_like(x))])
        grad = ex.grad_dict["x"].asnumpy()
        mask = out != 0
        assert abs(mask.mean() - keep) < 0.01, mask.mean()
        np.testing.assert_array_equal(out[mask], x[mask] / np.float32(keep))
        assert np.all(out[~mask] == 0)
        assert np.all(grad[~mask] == 0)
        np.testing.assert_array_equal(grad[mask], np.float32(1 / keep))
        np.testing.assert_array_equal(ex.forward(is_train=False)[0]
                                      .asnumpy(), x)


def test_rnn_op_dropout_is_the_dropout_of_layer_outputs():
    """The ``RNN`` op's dropout in training (3 LSTM layers, p=0.5) equals
    the op's layers run one at a time with ``nn.dropout`` of each layer
    after the first's input, drawn in the same order from the same
    generator state; the 2 masks cover 2 x 100,000 elements and each
    keeps 0.5 +- 0.01.  In inference the op is the identity there (equal
    to the op at p=0)."""
    t_, n_, nin, nh, layers, p = 50, 40, 8, 50, 3, 0.5
    rs = np.random.RandomState(1)
    x = torch.from_numpy(_draw(rs, (t_, n_, nin), 0.5))
    size = tmx.ops.rnn.rnn_param_size(nin, nh, layers, "lstm")
    params = torch.from_numpy(_draw(rs, (size,), 0.1))
    zeros = torch.zeros(layers, n_, nh)
    op = tmx.ops.get("RNN")

    def attrs(p_, n_layers=layers):
        return op.canonicalize_attrs(dict(state_size=nh, num_layers=n_layers,
                                          mode="lstm", p=p_))

    gen = tmx.random.generator("cpu")
    state = gen.get_state()
    with torch.no_grad():
        got = op.apply(attrs(p), [x, params, zeros, zeros], [], True)[0]
    after = gen.get_state()
    gen.set_state(state)
    slices = tmx.ops.rnn._layer_param_slices(nin, nh, layers, "lstm", False)
    cur, shares = x, []
    with torch.no_grad():
        for layer, _d, sl in slices:
            if layer > 0:
                dropped = tmx.ops.nn.dropout(cur, p)
                shares.append(float((dropped != 0).float().mean()))
                cur = dropped
            blob = torch.cat([params[o:o + int(np.prod(s))]
                              for o, s in (sl[k] for k in ("wx", "wh", "bx",
                                                            "bh"))])
            cur = op.apply(attrs(0.0, 1), [cur, blob, zeros[:1], zeros[:1]],
                           [], True)[0]
    assert torch.equal(gen.get_state(), after)
    torch.testing.assert_close(got, cur, rtol=0, atol=0)
    assert len(shares) == 2 and all(abs(s - 0.5) < 0.01 for s in shares)
    with torch.no_grad():
        infer = op.apply(attrs(p), [x, params, zeros, zeros], [], False)[0]
        plain = op.apply(attrs(0.0), [x, params, zeros, zeros], [], True)[0]
    torch.testing.assert_close(infer, plain, rtol=0, atol=0)


def test_rnn_op_dropout_gradient_is_zero_where_dropped():
    """One step of a 2-layer LSTM op at p=0.5: the gradient of the second
    layer's input weights is 0 in the column of every first-layer unit
    the mask dropped, and nonzero in the others."""
    t_, n_, nh = 1, 1, 64
    rs = np.random.RandomState(2)
    x = torch.from_numpy(_draw(rs, (t_, n_, 4), 1.0))
    size = tmx.ops.rnn.rnn_param_size(4, nh, 2, "lstm")
    params = torch.from_numpy(_draw(rs, (size,), 0.3)).requires_grad_(True)
    zeros = torch.zeros(2, n_, nh)
    op = tmx.ops.get("RNN")
    attrs = op.canonicalize_attrs(dict(state_size=nh, num_layers=2,
                                       mode="lstm", p=0.5))
    gen = tmx.random.generator("cpu")
    state = gen.get_state()
    out = op.apply(attrs, [x, params, zeros, zeros], [], True)[0]
    out.sum().backward()
    gen.set_state(state)
    mask = (torch.rand((t_, n_, nh), generator=gen) < 0.5).reshape(-1)
    sl = tmx.ops.rnn._layer_param_slices(4, nh, 2, "lstm", False)[1][2]
    off, shape = sl["wx"]
    gwx = params.grad[off:off + shape[0] * shape[1]].reshape(shape)
    assert 10 < int(mask.sum()) < nh - 10
    assert torch.all(gwx[:, ~mask] == 0)
    assert torch.all(gwx[:, mask].abs().sum(0) > 0)


# -- the unfused lstm_bucketing LM -------------------------------------------
VOCAB, EMBED, HIDDEN, BATCH, BUCKETS = 20, 8, 8, 4, [5, 10]
OPT = {"learning_rate": 0.02, "momentum": 0.0, "wd": 1e-5}
TRAIN = lstm_lm.synth_corpus(24, VOCAB, seed=4, buckets=BUCKETS)
VAL = lstm_lm.synth_corpus(12, VOCAB, seed=17, buckets=BUCKETS)


def _jax_stack_sym_gen(vocab=VOCAB, embed=EMBED, hidden=HIDDEN, layers=2):
    """``example/rnn/lstm_bucketing.py``'s stack and ``sym_gen`` (its
    lines 84-103), on the JAX package."""
    stack = jmx.rnn.SequentialRNNCell()
    for i in range(layers):
        stack.add(jmx.rnn.LSTMCell(num_hidden=hidden, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = jmx.sym.Variable("data")
        label = jmx.sym.Variable("softmax_label")
        emb = jmx.sym.Embedding(data=data, input_dim=vocab, output_dim=embed,
                                name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=emb, merge_outputs=True)
        pred = jmx.sym.Reshape(outputs, shape=(-1, hidden))
        pred = jmx.sym.FullyConnected(data=pred, num_hidden=vocab,
                                      name="pred")
        label = jmx.sym.Reshape(label, shape=(-1,))
        pred = jmx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def _sym_gen(mx):
    if mx is jmx:
        return _jax_stack_sym_gen()
    return lstm_lm.make_sym_gen(lstm_lm.build_stack(HIDDEN, 2), VOCAB, EMBED,
                                HIDDEN, layout="NTC")


def _iters(mx):
    random.seed(1)
    np.random.seed(1)
    return [mx.rnn.BucketSentenceIter(s, BATCH, buckets=BUCKETS,
                                      invalid_label=0)
            for s in (TRAIN, VAL)]


def _unfused_fit(mx, arg):
    train, val = _iters(mx)
    mod = mx.mod.BucketingModule(_sym_gen(mx), default_bucket_key=10,
                                 context=mx.cpu())
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params(arg_params={k: mx.nd.array(v) for k, v in arg.items()})
    seen = []
    mod.fit(train, eval_data=val, eval_metric=mx.metric.Perplexity(0),
            optimizer="sgd", optimizer_params=OPT, num_epoch=2,
            batch_end_callback=lambda p: seen.append(
                p.locals["data_batch"].bucket_key))
    random.seed(3)
    np.random.seed(3)
    (_, ppl), = mod.score(val, mx.metric.Perplexity(0))
    arg_after, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in arg_after.items()}, ppl, seen, mod


def test_unfused_lstm_bucketing_fit_matches_jax(monkeypatch):
    """``lstm_bucketing.py``'s unfused stack (2 LSTMCells of 8, vocab 20,
    embed 8, batch 4, buckets (5, 10), NT batches and NTC unroll) through
    two epochs of ``BucketingModule.fit`` with eval, from the JAX
    package's Xavier initialization: the parameters and the perplexity
    at ``rtol=1e-4, atol=1e-5``; the buckets share their weights; no
    kernel is launched (there is none on this path)."""
    monkeypatch.setenv("MXNET_DEVICE_METRIC", "0")
    jmod = jmx.mod.BucketingModule(_sym_gen(jmx), default_bucket_key=10,
                                   context=jmx.cpu())
    train, _ = _iters(jmx)
    jmod.bind(train.provide_data, train.provide_label)
    np.random.seed(7)
    jmod.init_params(jmx.init.Xavier(factor_type="in", magnitude=2.34))
    init = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    assert sorted(init) == sorted(
        ["embed_weight", "pred_weight", "pred_bias"]
        + ["lstm_l%d_%s" % (i, w) for i in range(2)
           for w in ("i2h_weight", "i2h_bias", "h2h_weight", "h2h_bias")])
    counts = (rnn_kernel.lstm_infer_cuda.launches,
              rnn_kernel.lstm_fwd_cuda.launches,
              rnn_kernel.lstm_bwd_cuda.launches)
    t_arg, t_ppl, t_seen, tmod = _unfused_fit(tmx, init)
    assert counts == (rnn_kernel.lstm_infer_cuda.launches,
                      rnn_kernel.lstm_fwd_cuda.launches,
                      rnn_kernel.lstm_bwd_cuda.launches)
    j_arg, j_ppl, j_seen, _ = _unfused_fit(jmx, init)
    assert t_seen == j_seen and set(t_seen) == set(BUCKETS)
    for k in j_arg:
        assert not np.allclose(j_arg[k], init[k]), k
        np.testing.assert_allclose(t_arg[k], j_arg[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert np.isfinite(t_ppl) and t_ppl == pytest.approx(j_ppl, rel=1e-4)
    a, b = (tmod._buckets[k] for k in BUCKETS)
    for name in init:
        assert a._exec.arg_dict[name] is b._exec.arg_dict[name]
        assert a._exec.grad_dict[name] is b._exec.grad_dict[name]


def test_unfused_graphs_and_checkpoints_cross_between_packages(tmp_path):
    """``sym_gen(T)`` of the unfused LM: equal arguments and node names in
    both packages; each package loads the other's checkpoint (graph and
    parameters) and computes the same outputs from it."""
    with tmx.name.NameManager():
        tnet = _sym_gen(tmx)(6)[0]
    with jmx.name.NameManager():
        jnet = _sym_gen(jmx)(6)[0]
    assert tnet.list_arguments() == jnet.list_arguments()
    assert [n["name"] for n in json.loads(tnet.tojson())["nodes"]] == \
        [n["name"] for n in json.loads(jnet.tojson())["nodes"]]
    shapes = {"data": (BATCH, 6), "softmax_label": (BATCH, 6)}
    arg_shapes = dict(zip(tnet.list_arguments(),
                          tnet.infer_shape(**shapes)[0]))
    rs = np.random.RandomState(9)
    params = {k: _draw(rs, s, 0.3) for k, s in arg_shapes.items()
              if k not in shapes}
    ids = rs.randint(0, VOCAB, shapes["data"]).astype(np.float32)
    jmx.model.save_checkpoint(str(tmp_path / "j"), 1, jnet,
                              {k: jmx.nd.array(v) for k, v in params.items()},
                              {})
    tmx.model.save_checkpoint(str(tmp_path / "t"), 1, tnet,
                              {k: tmx.nd.array(v) for k, v in params.items()},
                              {})
    outs = []
    for mx, src in ((tmx, "j"), (jmx, "t")):
        sym, arg, _aux = mx.model.load_checkpoint(str(tmp_path / src), 1)
        assert sym.list_arguments() == jnet.list_arguments()
        ex = sym.simple_bind(mx.cpu(), **shapes)
        for k, v in arg.items():
            np.testing.assert_array_equal(v.asnumpy(), params[k])
            ex.arg_dict[k][:] = v
        ex.arg_dict["data"][:] = ids
        outs.append(ex.forward(is_train=False)[0].asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-5)


def test_fused_checkpoint_scores_alike_through_unfuse(tmp_path):
    """``fused_lstm_bucketing.py --test`` on the port: a fused model's
    epoch checkpoint (``do_rnn_checkpoint``), loaded into ``unfuse()``
    through ``load_rnn_checkpoint`` and scored on NT batches unrolled
    NTC, scores the fused model's perplexity on the same batches
    (``rtol=1e-5``)."""
    def val_iter(layout):
        random.seed(5)
        np.random.seed(5)
        return tmx.rnn.BucketSentenceIter(VAL, BATCH, buckets=BUCKETS,
                                          invalid_label=0, layout=layout)

    train = tmx.rnn.BucketSentenceIter(TRAIN, BATCH, buckets=BUCKETS,
                                       invalid_label=0, layout="TN")
    cell = lstm_lm.build_cell(HIDDEN, 2)
    fused = tmx.mod.BucketingModule(
        lstm_lm.make_sym_gen(cell, VOCAB, EMBED, HIDDEN),
        default_bucket_key=10, context=tmx.cpu())
    prefix = str(tmp_path / "lm")
    tmx.random.seed(4)
    fused.fit(train, eval_metric=tmx.metric.Perplexity(0), num_epoch=1,
              optimizer_params=OPT,
              initializer=tmx.init.Xavier(factor_type="in", magnitude=2.34),
              epoch_end_callback=tmx.rnn.do_rnn_checkpoint(cell, prefix))
    (_, want), = fused.score(val_iter("TN"), tmx.metric.Perplexity(0))

    stack = lstm_lm.build_cell(HIDDEN, 2).unfuse()
    val = val_iter("NT")
    mod = tmx.mod.BucketingModule(
        lstm_lm.make_sym_gen(stack, VOCAB, EMBED, HIDDEN, layout="NTC"),
        default_bucket_key=val.default_bucket_key, context=tmx.cpu())
    mod.bind(val.provide_data, val.provide_label, for_training=False)
    _, arg, aux = tmx.rnn.load_rnn_checkpoint(stack, prefix, 1)
    assert "lstm_parameters" not in arg and "lstm_l1_h2h_weight" in arg
    mod.set_params(arg, aux)
    (_, got), = mod.score(val, tmx.metric.Perplexity(0))
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-5)


# -- randomness: seeds, resume -------------------------------------------------
def _dropout_fit(seed, num_epoch=1):
    """The fused LM with dropout 0.5 between its layers, from fixed
    weights: only the masks depend on ``seed``."""
    random.seed(1)
    np.random.seed(1)
    train = tmx.rnn.BucketSentenceIter(TRAIN, BATCH, buckets=BUCKETS,
                                       invalid_label=0, layout="TN")
    mod = tmx.mod.BucketingModule(lstm_lm.make_sym_gen(
        lstm_lm.build_cell(HIDDEN, 2, dropout=0.5), VOCAB, EMBED, HIDDEN),
        default_bucket_key=10, context=tmx.cpu())
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params(tmx.init.Zero())
    arg_shapes = {k: v.shape for k, v in mod.get_params()[0].items()}
    rs = np.random.RandomState(0)
    tmx.convert.set_module_params(
        mod, {k: _draw(rs, s, 0.3) for k, s in sorted(arg_shapes.items())},
        {})
    tmx.random.seed(seed)
    mod.fit(train, eval_metric=tmx.metric.Perplexity(0), num_epoch=num_epoch,
            optimizer_params=OPT)
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_dropout_fit_repeats_from_its_seed():
    """The same seed repeats the fit bit for bit; another seed draws other
    masks and ends elsewhere."""
    a, b, c = _dropout_fit(7), _dropout_fit(7), _dropout_fit(8)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not np.array_equal(a["lstm_parameters"], c["lstm_parameters"])


def _mlp_dropout_fit(prefix, callbacks=None, resume=None):
    rs = np.random.RandomState(7)
    x = rs.rand(64, 8).astype(np.float32)
    y = rs.randint(0, 3, 64).astype(np.float32)
    data = tmx.sym.Variable("data")
    h = tmx.sym.Dropout(tmx.sym.Activation(tmx.sym.FullyConnected(
        data, num_hidden=16, name="fc1"), act_type="relu"), p=0.5)
    mod = tmx.mod.Module(tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        h, num_hidden=3, name="fc2"), name="softmax"), context=tmx.cpu())
    tmx.random.seed(11)
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
            optimizer="sgd", optimizer_params={"learning_rate": 0.1},
            initializer=tmx.init.Xavier(), checkpoint_prefix=prefix,
            checkpoint_every_n_batches=1, batch_end_callback=callbacks,
            resume=resume)
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_resumed_snapshot_draws_the_uninterrupted_masks(tmp_path,
                                                        monkeypatch):
    """An MLP with ``Dropout`` preempted (SIGTERM) at its third batch
    (``nbatch`` 2) and resumed
    from its snapshot with ``resume="auto"`` ends bit for bit where the
    uninterrupted fit does: the snapshot carries the run-time generator.
    A resume that drew fresh masks would not."""
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "0")
    whole = _mlp_dropout_fit(str(tmp_path / "a"))
    seen = [0]

    def kill(_param):
        seen[0] += 1
        if seen[0] == 3:
            assert threading.current_thread() is threading.main_thread()
            assert isinstance(signal.getsignal(signal.SIGTERM),
                              _PreemptGuard)
            signal.raise_signal(signal.SIGTERM)

    prefix = str(tmp_path / "b")
    with pytest.raises(tck.TrainingPreempted):
        _mlp_dropout_fit(prefix, callbacks=kill)
    st = tck.load_latest_state(prefix)
    assert (st.epoch, st.nbatch) == (0, 2)
    assert "cpu" in st.rng_state["global"]["op_generators"]
    resumed = _mlp_dropout_fit(prefix, resume="auto")
    for k in whole:
        np.testing.assert_array_equal(resumed[k], whole[k], err_msg=k)


def test_random_state_carries_and_reseeds_the_run_time_generator():
    """``get_state``/``set_state`` replay the generator's draws; ``seed``
    restarts them; a generator the state never drew from is reseeded."""
    tmx.random.seed(3)
    gen = tmx.random.generator("cpu")
    st = json.loads(json.dumps(tmx.random.get_state()))
    a = torch.rand(5, generator=gen)
    tmx.random.set_state(st)
    np.testing.assert_array_equal(torch.rand(5, generator=gen).numpy(),
                                  a.numpy())
    tmx.random.seed(3)
    np.testing.assert_array_equal(torch.rand(5, generator=gen).numpy(),
                                  a.numpy())
    del st["op_generators"]["cpu"]
    torch.rand(7, generator=gen)
    tmx.random.set_state(st)
    np.testing.assert_array_equal(torch.rand(5, generator=gen).numpy(),
                                  a.numpy())
    tmx.random.seed(4)
    assert not torch.equal(torch.rand(5, generator=gen), a)
    assert tmx.random.generator(torch.device("cpu")) is gen


# -- the ops and Symbol arithmetic --------------------------------------------
def test_arithmetic_and_new_ops_match_jax():
    """``-``, ``*``, ``/``, their reflected and scalar forms, ``neg``,
    ``ones_like``, ``zeros_like``, ``expand_dims`` and ``_zeros`` (no
    input): outputs, shapes and gradients as the JAX package's."""
    def net(mx):
        with mx.name.NameManager():
            a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
            z = mx.sym._zeros(shape=(2, 3))
            c = (a - b) * a / (b * b + 1.0) + 2.0 - (1.0 - a) * 3 \
                + (-a) + 1.0 / (a * a + 2.0) + a / 4.0 - b * 0.5 \
                + mx.sym.ones_like(a) + mx.sym.zeros_like(b) + z
            return mx.sym.Concat(mx.sym.expand_dims(c, axis=0),
                                 mx.sym.expand_dims(a, axis=0), dim=0)

    tnet, jnet = net(tmx), net(jmx)
    assert tnet.list_arguments() == jnet.list_arguments() == ["a", "b"]
    assert [n["op"] for n in json.loads(tnet.tojson())["nodes"]] == \
        [n["op"] for n in json.loads(jnet.tojson())["nodes"]]
    assert tnet.infer_shape(a=(2, 3)) == jnet.infer_shape(a=(2, 3))
    assert tnet.infer_shape(a=(2, 3))[1] == [(2, 2, 3)]
    shapes = {"a": (2, 3), "b": (2, 3)}
    _assert_close(_run(tmx, tnet, shapes, 1), _run(jmx, jnet, shapes, 1),
                  1e-5, 1e-5)


def test_zeros_lies_on_the_bound_device():
    """``_zeros`` makes its output on the executor's device (here the
    CPU), on ``meta`` in shape inference, and on the CPU imperatively."""
    z = tmx.sym._zeros(shape=(2, 3), name="z")
    ex = (z + tmx.sym.Variable("a")).simple_bind(tmx.cpu(), a=(2, 3))
    assert ex.forward()[0].asnumpy().tolist() == [[0.0] * 3] * 2
    assert tmx.nd._zeros(shape=(1, 2)).asnumpy().shape == (1, 2)
    assert z.infer_shape() == ([], [(2, 3)], [])
    assert tmx.ops.registry.scope_device() == torch.device("cpu")
    with tmx.ops.registry.device_scope("meta"):
        assert tmx.ops.get("_zeros").apply(
            {"shape": (4,), "dtype": "float32"}, [], [], False)[0].is_meta


def test_step_list_merge_and_split_shapes():
    """``_normalize_sequence`` merges a step list (``expand_dims`` +
    ``Concat``) on the layout's time axis and splits a merged input
    (``SliceChannel(squeeze_axis=1)``) on the TNC time axis, as the JAX
    package does."""
    from mxnet_tpu.rnn.rnn_cell import _normalize_sequence as jnorm
    from mxnet_tpu_torch.rnn.rnn_cell import _normalize_sequence as tnorm

    for mx, norm in ((tmx, tnorm), (jmx, jnorm)):
        steps = [mx.sym.Variable("s%d" % t) for t in range(3)]
        merged, axis = norm(3, steps, "TNC", True)
        assert axis == 0
        assert merged.infer_shape(**{"s%d" % t: (2, 5) for t in range(3)}
                                  )[1] == [(3, 2, 5)]
        split, _ = norm(3, mx.sym.Variable("x"), "TNC", False)
        assert [s.infer_shape(x=(3, 2, 5))[1][0] for s in split] == \
            [(2, 5)] * 3
