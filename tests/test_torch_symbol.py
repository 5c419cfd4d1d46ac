"""Graph JSON and shape inference of the PyTorch port against the JAX
package, on ``build_lm`` (``example/long-context/train_lm.py``) and its
port (``mxnet_tpu_torch/models/long_context_lm.py``)."""

import importlib.util
import os

import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import build_lm as t_build_lm

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_build_lm():
    spec = importlib.util.spec_from_file_location(
        "long_context_train_lm",
        os.path.join(_ROOT, "example", "long-context", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_lm


def _pair(vocab=50, embed=32, heads=2, seq=16):
    """The same LM built by both packages, each under a fresh name scope
    so auto-generated node names agree."""
    with jmx.name.NameManager():
        jnet = _jax_build_lm()(vocab, embed, heads, seq)
    with tmx.name.NameManager():
        tnet = t_build_lm(vocab, embed, heads, seq)
    return jnet, tnet


def test_build_lm_json_is_identical():
    jnet, tnet = _pair()
    assert tnet.tojson() == jnet.tojson()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_json_round_trip(direction):
    jnet, tnet = _pair()
    if direction == "jax_to_port":
        text = jnet.tojson()
        back = tmx.sym.load_json(text)
    else:
        text = tnet.tojson()
        back = jmx.sym.load_json(text)
    assert back.tojson() == text
    assert back.list_arguments() == jnet.list_arguments()
    assert back.list_outputs() == jnet.list_outputs()
    assert back.get_internals().list_outputs() \
        == jnet.get_internals().list_outputs()


@pytest.mark.parametrize("batch", [1, 4])
def test_infer_shape_agrees(batch):
    jnet, tnet = _pair()
    shapes = {"data": (batch, 16), "softmax_label": (batch, 16)}
    assert tnet.infer_shape(**shapes) == jnet.infer_shape(**shapes)


def test_label_shape_inferred_from_data_alone():
    """The port sizes ``softmax_label`` (behind ``Reshape((-1,))``) from
    the data shape; the JAX package cannot (ROADMAP Queue C)."""
    jnet, tnet = _pair()
    args, outs, _ = tnet.infer_shape(data=(4, 16))
    label = dict(zip(tnet.list_arguments(), args))["softmax_label"]
    assert label == (64,) and outs == [(64, 50)]
    with pytest.raises(jmx.MXNetError, match="softmax_label"):
        jnet.infer_shape(data=(4, 16))
    jargs, jouts, _ = jnet.infer_shape(data=(4, 16), softmax_label=(64,))
    assert (jargs, jouts) == (args, outs)


def test_simple_bind_defaults_to_the_card_and_binds_cpu():
    _jnet, tnet = _pair()
    ex = tnet.simple_bind(tmx.cpu(), data=(2, 16))
    assert ex.arg_dict["att_qkv_weight"].shape == (96, 32)
    assert ex.arg_dict["softmax_label"].shape == (32,)
    # a training bind allocates a gradient beside every argument
    ex = tnet.simple_bind(tmx.cpu(), grad_req="write", data=(2, 16))
    assert ex.grad_dict["att_qkv_weight"].shape == (96, 32)
    assert sorted(ex.grad_dict) == sorted(tnet.list_arguments())
