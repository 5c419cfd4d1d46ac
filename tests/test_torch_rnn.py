"""The LSTM kernels' plain versions, the ``RNN`` op and the ``mx.rnn``
pieces of the PyTorch port against the JAX package.

* K4, K5 and K6's plain versions (``ops/rnn_kernel.py``) against the
  Pallas kernels ``mxnet_tpu.ops.rnn_pallas._run_infer/_run_fwd/_run_bwd``
  in interpret mode, as the JAX package's own tests run them: outputs
  ``rtol=atol=1e-5``, gradients ``1e-4`` (f32 sums in another order).
* The kernel wrappers' refusals (dtype, contiguity, shape, device), which
  run before any launch and so hold on CPU tensors.
* The ``RNN`` op through ``simple_bind`` (outputs and every argument
  gradient) against the JAX executor with its Pallas kernels on
  (``MXNET_RNN_PALLAS=1``) and off: the same tolerances.
* ``FusedRNNCell``'s blob layout, ``unpack_weights``/``pack_weights``,
  the ``FusedRNN`` initializer, ``BucketSentenceIter``,
  ``encode_sentences``, ``Perplexity`` and the corpus of
  ``models.lstm_lm``: exactly, or at ``1e-6`` for float results.

Every shape is tiny (T <= 7, N <= 4, H <= 8): interpret-mode Pallas is
slow.
"""

import importlib.util
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import rnn_pallas
from mxnet_tpu.ops.rnn import _layer_param_slices as j_slices
from mxnet_tpu.ops.rnn import rnn_param_size as j_size
from mxnet_tpu_torch.models import lstm_lm
from mxnet_tpu_torch.ops import rnn_kernel
from mxnet_tpu_torch.ops.rnn import _layer_param_slices as t_slices
from mxnet_tpu_torch.ops.rnn import rnn_param_size as t_size

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    """``example/rnn/<name>.py`` as a module (its ``main`` does not run)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_ROOT, "example", "rnn", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _draw(rs, shape, scale):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("T,N,H,state", [(6, 3, 8, 0.5), (1, 2, 5, 0.7),
                                         (4, 2, 3, 0.0)])
def test_plain_kernels_match_pallas_interpret(T, N, H, state):
    """Nonzero h0 and c0 make the t = 0 boundary count (K6 takes c_prev
    and h_prev from them there)."""
    rs = np.random.RandomState(T + N + H)
    inputs = (_draw(rs, (T, 4, N, H), 0.5), _draw(rs, (4, H, H), 0.4),
              _draw(rs, (4, H), 0.1), _draw(rs, (N, H), state),
              _draw(rs, (N, H), state))
    tin = [torch.from_numpy(a) for a in inputs]
    jin = [jnp.asarray(a) for a in inputs]

    want = rnn_pallas._run_infer(*jin, True)
    got = rnn_kernel.lstm_infer_plain(*tin)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    want = rnn_pallas._run_fwd(*jin, True)
    got = rnn_kernel.lstm_fwd_plain(*tin)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    ys, gates, cs = (np.asarray(a) for a in want[:3])
    grads = (_draw(rs, (T, N, H), 1.0), _draw(rs, (N, H), 1.0),
             _draw(rs, (N, H), 1.0))
    want = rnn_pallas._run_bwd(jnp.asarray(gates), jnp.asarray(cs),
                               jnp.asarray(ys), jin[1], jin[3], jin[4],
                               *[jnp.asarray(a) for a in grads], True)
    got = rnn_kernel.lstm_bwd_plain(
        *[torch.from_numpy(np.array(a)) for a in (gates, cs, ys)], tin[1],
        tin[3], tin[4], *[torch.from_numpy(a) for a in grads])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_lstm_seq_routes_by_grad_and_device():
    """No gradient: K4's function; under autograd: K5's, with K6's as the
    backward (the plain versions here, on the CPU); the kernel counts
    stay 0."""
    rs = np.random.RandomState(0)
    xp, w4, bh, h0, c0 = [torch.from_numpy(_draw(rs, s, 0.5)) for s in (
        (5, 4, 2, 3), (4, 3, 3), (4, 3), (2, 3), (2, 3))]
    counts = (rnn_kernel.lstm_infer_cuda.launches,
              rnn_kernel.lstm_fwd_cuda.launches,
              rnn_kernel.lstm_bwd_cuda.launches)
    with torch.inference_mode():
        ys0, _, _ = rnn_kernel.lstm_seq(xp, w4, bh, h0, c0)
    xp.requires_grad_(True)
    w4.requires_grad_(True)
    ys, hT, cT = rnn_kernel.lstm_seq(xp, w4, bh, h0, c0)
    assert ys.grad_fn is not None
    torch.testing.assert_close(ys.detach(), ys0, rtol=0, atol=0)
    (ys.sum() + 2 * hT.sum() - cT.sum()).backward()

    def ref(xp_, w4_):
        return rnn_kernel.lstm_infer_plain(xp_, w4_, bh, h0, c0)

    gx, gw = torch.autograd.grad(
        [t.sum() * k for t, k in zip(ref(xp, w4), (1, 2, -1))], [xp, w4])
    torch.testing.assert_close(xp.grad, gx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(w4.grad, gw, rtol=1e-5, atol=1e-6)
    meta = rnn_kernel.lstm_seq(*[t.detach().to("meta") for t in (
        xp, w4, bh, h0, c0)])
    assert [tuple(t.shape) for t in meta] == [(5, 2, 3), (2, 3), (2, 3)]
    assert counts == (rnn_kernel.lstm_infer_cuda.launches,
                      rnn_kernel.lstm_fwd_cuda.launches,
                      rnn_kernel.lstm_bwd_cuda.launches)


@pytest.mark.parametrize("change,match", [
    (lambda a: [a[0].to(torch.bfloat16)] + a[1:], "float32"),
    (lambda a: [a[0], a[1].transpose(1, 2)] + a[2:], "contiguous"),
    (lambda a: a[:2] + [a[2][:3]] + a[3:], "shape"),
    (lambda a: [a[0][:, :3]] + a[1:], r"\(T, 4, N, H\)"),
    (lambda a: a[:3] + [a[3].to("meta")] + a[4:], "meta"),
])
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(change, match):
    """The checks run before any launch, so they hold on CPU tensors."""
    args = [torch.zeros(s) for s in ((3, 4, 2, 5), (4, 5, 5), (4, 5),
                                     (2, 5), (2, 5))]
    with pytest.raises(tmx.MXNetError, match=match):
        rnn_kernel._check_fwd(*change(args))


def _rnn_case(mx, mode, bidir, seq=5, batch=3, nin=4, nh=6, layers=2):
    """A 2-layer RNN op with state_outputs through simple_bind: outputs
    and every argument gradient (head gradients of ones), as numpy."""
    lstm = mode == "lstm"
    d = 2 if bidir else 1
    psize = (j_size if mx is jmx else t_size)(nin, nh, layers, mode, bidir)
    args = [mx.sym.Variable("x"), mx.sym.Variable("p"),
            mx.sym.Variable("hs")] + ([mx.sym.Variable("cs")] if lstm
                                      else [])
    net = mx.sym.RNN(*args, state_size=nh, num_layers=layers, mode=mode,
                     bidirectional=bidir, state_outputs=True, name="rnn")
    shapes = dict(x=(seq, batch, nin), hs=(layers * d, batch, nh))
    if lstm:
        shapes["cs"] = shapes["hs"]
    ex = net.simple_bind(mx.cpu(), grad_req="write", **shapes)
    assert ex.arg_dict["p"].shape == (psize,)
    rs = np.random.RandomState(3)
    ex.arg_dict["x"][:] = _draw(rs, (seq, batch, nin), 0.5)
    ex.arg_dict["p"][:] = _draw(rs, (psize,), 0.2)
    ex.arg_dict["hs"][:] = _draw(rs, shapes["hs"], 0.1)
    if lstm:
        ex.arg_dict["cs"][:] = _draw(rs, shapes["hs"], 0.1)
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward([mx.nd.array(np.ones(o.shape, np.float32)) for o in outs])
    return outs, {k: g.asnumpy() for k, g in ex.grad_dict.items()
                  if g is not None}


@pytest.mark.parametrize("mode,bidir,pallas", [
    ("lstm", False, "1"), ("lstm", False, "0"), ("lstm", True, "1"),
    ("gru", False, "0"), ("rnn_tanh", True, "0")])
def test_rnn_op_matches_jax(mode, bidir, pallas, monkeypatch):
    monkeypatch.setenv("MXNET_RNN_PALLAS", pallas)
    j_outs, j_grads = _rnn_case(jmx, mode, bidir)
    t_outs, t_grads = _rnn_case(tmx, mode, bidir)
    assert len(t_outs) == len(j_outs) == (3 if mode == "lstm" else 2)
    for a, b in zip(t_outs, j_outs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert sorted(t_grads) == sorted(j_grads)
    for k in j_grads:
        np.testing.assert_allclose(t_grads[k], j_grads[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_rnn_op_above_512_columns_matches_jax(monkeypatch):
    """The ``RNN`` op at ``state_size`` 520, wider than one 512-thread
    block of the forward kernels, against the JAX package's scan path:
    the plain versions that the card tests hold K4/K5 to, at that width."""
    monkeypatch.setenv("MXNET_RNN_PALLAS", "0")
    case = dict(seq=3, batch=2, nin=4, nh=520, layers=1)
    j_outs, j_grads = _rnn_case(jmx, "lstm", False, **case)
    t_outs, t_grads = _rnn_case(tmx, "lstm", False, **case)
    assert [o.shape for o in t_outs] == [(3, 2, 520), (1, 2, 520),
                                         (1, 2, 520)]
    for a, b in zip(t_outs, j_outs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert sorted(t_grads) == sorted(j_grads)
    for k in j_grads:
        np.testing.assert_allclose(t_grads[k], j_grads[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_rnn_op_refuses_training_dropout_between_layers():
    """The refusal is gone: dropout between layers runs in training (and
    draws), and inference is unchanged (the identity there)."""
    net = tmx.sym.RNN(tmx.sym.Variable("x"), state_size=4, num_layers=2,
                      mode="lstm", p=0.3, name="rnn")
    ex = net.simple_bind(tmx.cpu(), grad_req="write", x=(3, 2, 4))
    ex.arg_dict["x"][:] = np.ones((3, 2, 4), np.float32)
    ex.arg_dict["rnn_parameters"][:] = np.full(
        ex.arg_dict["rnn_parameters"].shape, 0.1, np.float32)
    state = tmx.random.get_state()
    train = ex.forward(is_train=True)[0].asnumpy()
    assert tmx.random.get_state()["op_generators"]["cpu"] != \
        state["op_generators"].get("cpu")
    ex.backward()
    assert train.shape == (3, 2, 4) and np.isfinite(train).all()
    assert ex.forward(is_train=False)[0].shape == (3, 2, 4)


@pytest.mark.parametrize("mode,bidir", [("lstm", False), ("lstm", True),
                                        ("gru", True), ("rnn_relu", False)])
def test_fused_cell_blob_layout_and_weights_match_jax(mode, bidir):
    assert t_slices(7, 5, 3, mode, bidir) == j_slices(7, 5, 3, mode, bidir)
    size = t_size(7, 5, 3, mode, bidir)
    assert size == j_size(7, 5, 3, mode, bidir)
    blob = np.random.RandomState(1).standard_normal(size).astype(np.float32)
    tcell = tmx.rnn.FusedRNNCell(5, num_layers=3, mode=mode,
                                 bidirectional=bidir, prefix="lstm_")
    jcell = jmx.rnn.FusedRNNCell(5, num_layers=3, mode=mode,
                                 bidirectional=bidir, prefix="lstm_")
    tw = tcell.unpack_weights({"lstm_parameters": tmx.nd.array(blob)})
    jw = jcell.unpack_weights({"lstm_parameters": jmx.nd.array(blob)})
    assert sorted(tw) == sorted(jw)
    assert "lstm_l0_i2h_weight" in tw and "lstm_l2_h2h_bias" in tw
    assert ("lstm_r0_i2h_weight" in tw) == bidir
    for k in jw:
        np.testing.assert_array_equal(tw[k].asnumpy(), jw[k].asnumpy())
    packed = tcell.pack_weights(tw)["lstm_parameters"].asnumpy()
    np.testing.assert_array_equal(packed, blob)


def test_fused_rnn_initializer_and_graph_match_jax():
    """The same ``__init__`` attr on the blob variable, the same graph
    arguments and shapes, and the initializer's biases: forget gates at
    ``forget_bias``, the rest zero; each weight piece Xavier-scaled by
    its own fan-in."""
    h, embed, vocab = 6, 5, 11
    tcell = tmx.rnn.FusedRNNCell(h, num_layers=2, mode="lstm",
                                 forget_bias=1.5)
    jcell = jmx.rnn.FusedRNNCell(h, num_layers=2, mode="lstm",
                                 forget_bias=1.5)
    tnet = lstm_lm.make_sym_gen(tcell, vocab, embed, h)(7)[0]
    example = _example("fused_lstm_bucketing")
    args = example.parser.parse_args(["--num-hidden", str(h), "--num-embed",
                                      str(embed), "--vocab-size",
                                      str(vocab)])
    jnet = example.make_sym_gen(args, jcell, "TNC")(7)[0]
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_outputs() == jnet.list_outputs()
    shapes = {"data": (7, 3), "softmax_label": (7, 3)}
    assert tnet.infer_shape(**shapes) == jnet.infer_shape(**shapes)
    t_attr = tnet.attr_dict()["lstm_parameters"]["__init__"]
    assert t_attr == jnet.attr_dict()["lstm_parameters"]["__init__"]

    size = t_size(embed, h, 2, "lstm")
    arr = tmx.nd.zeros((size,))
    init = tmx.init.Xavier(factor_type="in", magnitude=2.34)
    init(tmx.init.InitDesc("lstm_parameters", {"__init__": t_attr},
                           global_init=init), arr)
    w = tcell.unpack_weights({"lstm_parameters": arr})
    for k, v in w.items():
        v = v.asnumpy()
        if k.endswith("bias"):
            want = np.zeros(4 * h, np.float32)
            want[h:2 * h] = 1.5
            np.testing.assert_array_equal(v, want, err_msg=k)
        else:
            bound = np.sqrt(2.34 / v.shape[1])
            assert 0.5 * bound < np.abs(v).max() <= bound, k


def test_stacked_cells_match_jax():
    """``--stack-rnn``: one fused cell per layer with a DropoutCell between
    (the begin states derived from the first step, a SliceChannel); the
    same graph arguments, and the same inference output from the same
    weights (dropout is the identity there)."""
    h, embed, vocab, seq, batch = 5, 4, 9, 4, 2
    tnet = lstm_lm.make_sym_gen(lstm_lm.build_cell(
        h, 2, stack_rnn=True, dropout=0.5), vocab, embed, h)(seq)[0]
    example = _example("fused_lstm_bucketing")
    args = example.parser.parse_args(
        ["--num-hidden", str(h), "--num-embed", str(embed), "--vocab-size",
         str(vocab), "--stack-rnn", "--dropout", "0.5"])
    jnet = example.make_sym_gen(args, example.build_cell(args), "TNC")(
        seq)[0]
    assert tnet.list_arguments() == jnet.list_arguments()
    shapes = {"data": (seq, batch), "softmax_label": (seq, batch)}
    assert tnet.infer_shape(**shapes) == jnet.infer_shape(**shapes)
    outs = []
    for mx, net in ((jmx, jnet), (tmx, tnet)):
        ex = net.simple_bind(mx.cpu(), **shapes)
        for name, arr in ex.arg_dict.items():
            if name == "data":
                arr[:] = np.random.RandomState(1).randint(0, vocab, shapes[
                    "data"]).astype(np.float32)
            elif name != "softmax_label":
                arr[:] = np.random.RandomState(len(name)).standard_normal(
                    arr.shape).astype(np.float32) * 0.3
        outs.append(ex.forward(is_train=False)[0].asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)


def test_bucket_sentence_iter_matches_jax():
    """Same sentences and seeds: the same batches in the same order, in
    both layouts, over two epochs."""
    sents = lstm_lm.synth_corpus(40, 30, seed=5, buckets=(4, 8))
    for layout in ("NT", "TN"):
        batches = {}
        for mx in (jmx, tmx):
            random.seed(11)
            np.random.seed(11)
            it = mx.rnn.BucketSentenceIter(sents, 3, buckets=[4, 8],
                                           invalid_label=0, layout=layout)
            out = []
            for _epoch in range(2):
                for b in it:
                    out.append((b.bucket_key, b.data[0].asnumpy(),
                                b.label[0].asnumpy(),
                                tuple(b.provide_data[0].shape)))
                it.reset()
            batches[mx] = (out, it.default_bucket_key,
                           tuple(it.provide_data[0].shape))
        (t_out, t_key, t_shape), (j_out, j_key, j_shape) = \
            batches[tmx], batches[jmx]
        assert (t_key, t_shape) == (j_key, j_shape)
        assert len(t_out) == len(j_out) > 4
        for t, j in zip(t_out, j_out):
            assert t[0] == j[0] and t[3] == j[3]
            np.testing.assert_array_equal(t[1], j[1])
            np.testing.assert_array_equal(t[2], j[2])
    words = [["a", "b", "c"], ["b", "d"]]
    assert tmx.rnn.encode_sentences(words, invalid_label=0, start_label=1) \
        == jmx.rnn.encode_sentences(words, invalid_label=0, start_label=1)


def test_corpus_matches_the_example():
    example = _example("lstm_bucketing")
    assert lstm_lm.synth_corpus(30, 100) == example.synth_corpus(30, 100)
    assert lstm_lm.synth_corpus(10, 100, seed=17) == \
        example.synth_corpus(10, 100, seed=17)


def test_perplexity_matches_jax():
    rs = np.random.RandomState(2)
    preds = rs.uniform(0.01, 1, (12, 9)).astype(np.float32)
    preds /= preds.sum(1, keepdims=True)
    labels = rs.randint(0, 9, (4, 3)).astype(np.float32)
    labels[0, :2] = 0
    values = []
    for mx in (jmx, tmx):
        m = mx.metric.create("perplexity", ignore_label=0)
        m.update([mx.nd.array(labels)], [mx.nd.array(preds)])
        m.update([mx.nd.array(labels[:2])], [mx.nd.array(preds[:6])])
        values.append(m.get())
    assert values[0][0] == values[1][0] == "Perplexity"
    assert values[1][1] == pytest.approx(values[0][1], rel=1e-6)
