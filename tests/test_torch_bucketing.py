"""The fused-LSTM language-model slice of the PyTorch port against the JAX
package: ``BucketingModule.fit`` over ``BucketSentenceIter`` batches of
two bucket lengths, with ``Perplexity`` on ``eval_data``.

The model is ``example/rnn/fused_lstm_bucketing.py``'s at a small size
(vocab 50, embed 16, 2 LSTM layers of 16, batch 4, buckets (5, 10)), its
``make_sym_gen`` on the JAX side and the port's copy in
``models.lstm_lm`` on the other; the SGD settings are the example's (lr
0.02, momentum 0, wd 1e-5).  Both start from the JAX package's Xavier
initialization, carried across through numpy, and see the same batches
(the iterators shuffle with the global ``random`` and numpy generators,
seeded alike).  The JAX side runs its Pallas LSTM kernels in interpret
mode (``MXNET_RNN_PALLAS=1``) and once more with its scan; the port runs
the plain versions of K4-K6 on the CPU.

Tolerances: parameters after the epoch, outputs of each bucket and
perplexities ``rtol=1e-4, atol=1e-5`` (f32 sums in another order through
five steps).
"""

import importlib.util
import os
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import lstm_lm
from mxnet_tpu_torch.ops import rnn_kernel

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, EMBED, HIDDEN, BATCH, BUCKETS = 50, 16, 16, 4, [5, 10]
OPT = {"learning_rate": 0.02, "momentum": 0.0, "wd": 1e-5}
TRAIN = lstm_lm.synth_corpus(26, VOCAB, seed=4, buckets=BUCKETS)
VAL = lstm_lm.synth_corpus(12, VOCAB, seed=17, buckets=BUCKETS)


def _example():
    spec = importlib.util.spec_from_file_location(
        "fused_lstm_bucketing",
        os.path.join(_ROOT, "example", "rnn", "fused_lstm_bucketing.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


def _sym_gen(mx):
    if mx is tmx:
        return lstm_lm.make_sym_gen(lstm_lm.build_cell(HIDDEN, 2), VOCAB,
                                    EMBED, HIDDEN)
    example = _example()
    args = example.parser.parse_args(
        ["--num-hidden", str(HIDDEN), "--num-embed", str(EMBED),
         "--vocab-size", str(VOCAB)])
    return example.make_sym_gen(args, example.build_cell(args), "TNC")


def _iters(mx):
    random.seed(1)
    np.random.seed(1)
    return [mx.rnn.BucketSentenceIter(s, BATCH, buckets=BUCKETS,
                                      invalid_label=0, layout="TN")
            for s in (TRAIN, VAL)]


@pytest.fixture(scope="module")
def init_params():
    """The JAX package's initialization (Xavier in, 2.34; the blob
    through its FusedRNN initializer), as numpy."""
    mod = jmx.mod.BucketingModule(_sym_gen(jmx), default_bucket_key=10,
                                  context=jmx.cpu())
    train, _ = _iters(jmx)
    mod.bind(train.provide_data, train.provide_label)
    np.random.seed(7)
    mod.init_params(jmx.init.Xavier(factor_type="in", magnitude=2.34))
    arg, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}


def _fit(mx, arg):
    """One epoch of fit with eval, then each bucket's outputs on a fixed
    batch and a second score: (params, {bucket: output}, perplexity,
    the train batches' bucket keys, module)."""
    train, val = _iters(mx)
    mod = mx.mod.BucketingModule(_sym_gen(mx), default_bucket_key=10,
                                 context=mx.cpu())
    mod.bind(train.provide_data, train.provide_label)
    if mx is tmx:
        # the blob and the other weights through numpy, as they are
        mod.init_params(tmx.init.Zero())
        tmx.convert.set_module_params(mod, arg, {})
    else:
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in arg.items()})
    seen = []
    mod.fit(train, eval_data=val, eval_metric=mx.metric.Perplexity(0),
            optimizer="sgd", optimizer_params=OPT, num_epoch=1,
            batch_end_callback=lambda p: seen.append(
                p.locals["data_batch"].bucket_key))
    outs = {}
    rs = np.random.RandomState(2)
    for b in BUCKETS:
        ids = rs.randint(1, VOCAB, (b, BATCH)).astype(np.float32)
        batch = mx.io.DataBatch(
            [mx.nd.array(ids)], [mx.nd.array(ids)], bucket_key=b,
            provide_data=[mx.io.DataDesc("data", ids.shape)],
            provide_label=[mx.io.DataDesc("softmax_label", ids.shape)])
        mod.forward(batch, is_train=False)
        outs[b] = mod.get_outputs()[0].asnumpy()
    random.seed(3)
    np.random.seed(3)
    (_, ppl), = mod.score(val, mx.metric.Perplexity(0))
    arg_after, _ = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg_after.items()}, outs, ppl,
            seen, mod)


@pytest.fixture(scope="module")
def port_fit(init_params):
    counts = (rnn_kernel.lstm_infer_cuda.launches,
              rnn_kernel.lstm_fwd_cuda.launches,
              rnn_kernel.lstm_bwd_cuda.launches)
    res = _fit(tmx, init_params)
    assert counts == (rnn_kernel.lstm_infer_cuda.launches,
                      rnn_kernel.lstm_fwd_cuda.launches,
                      rnn_kernel.lstm_bwd_cuda.launches)
    return res


@pytest.mark.parametrize("pallas", ["1", "0"])
def test_bucketing_fit_matches_jax(init_params, port_fit, pallas,
                                   monkeypatch):
    monkeypatch.setenv("MXNET_RNN_PALLAS", pallas)
    monkeypatch.setenv("MXNET_DEVICE_METRIC", "0")
    j_arg, j_outs, j_ppl, j_seen, _ = _fit(jmx, init_params)
    t_arg, t_outs, t_ppl, t_seen, tmod = port_fit
    assert t_seen == j_seen and set(t_seen) == set(BUCKETS)
    assert sorted(t_arg) == sorted(j_arg) == sorted(init_params)
    for k in j_arg:
        assert not np.allclose(j_arg[k], init_params[k]), k
        np.testing.assert_allclose(t_arg[k], j_arg[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for b in BUCKETS:
        assert t_outs[b].shape == (b * BATCH, VOCAB)
        np.testing.assert_allclose(t_outs[b], j_outs[b], rtol=1e-4,
                                   atol=1e-5, err_msg=str(b))
    assert np.isfinite(t_ppl)
    assert t_ppl == pytest.approx(j_ppl, rel=1e-4)
    assert tmod._curr_module._optimizer.num_update == len(t_seen)


def test_buckets_share_parameters_gradients_and_optimizer(port_fit):
    mod = port_fit[-1]
    a, b = (mod._buckets[k] for k in BUCKETS)
    for name in ("embed_weight", "lstm_parameters", "pred_weight",
                 "pred_bias"):
        assert a._exec.arg_dict[name] is b._exec.arg_dict[name]
        assert a._exec.grad_dict[name] is b._exec.grad_dict[name]
    assert a._exec.arg_dict["data"] is not b._exec.arg_dict["data"]
    assert a._updater is b._updater and a._optimizer is b._optimizer
    assert mod.symbol is mod._curr_module.symbol


def test_bucketing_module_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tmx.MXNetError, match="CUDA"):
        tmx.mod.BucketingModule(_sym_gen(tmx), default_bucket_key=10)
