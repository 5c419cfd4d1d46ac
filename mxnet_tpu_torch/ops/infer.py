"""Backward (argument) shape inference rules, the part of
``mxnet_tpu/ops/infer.py`` the served and training paths need:
``simple_bind`` sizes weights, BatchNorm's gamma/beta/moving stats, the
RNN op's parameter blob and states, and ``softmax_label`` from the data
shape alone through them; the elementwise ops give a missing operand the
other's shape, and the unary ones (scalar arithmetic, ``*_like``,
``expand_dims``) their input the shape a consumer fixed for their output.  Pooling has no
parameters, so its output shape comes from the ``meta`` run alone.

Each rule: ``(attrs, in_shapes, in_dtypes, aux_shapes) -> (in_shapes,
aux_shapes)`` filling ``None`` entries; shapes are tuples or None.
"""

from __future__ import annotations

import math

from ..base import MXNetError
from .matrix import _infer_reshape
from .registry import get


def rule(name):
    def _do(fn):
        get(name).infer_inputs = fn
        return fn

    return _do


@rule("FullyConnected")
def _fc(attrs, ins, dts, auxs):
    data = ins[0]
    if data is not None:
        in_dim = math.prod(data[1:]) if attrs["flatten"] else data[-1]
        if ins[1] is None:
            ins[1] = (attrs["num_hidden"], in_dim)
        if not attrs["no_bias"] and ins[2] is None:
            ins[2] = (attrs["num_hidden"],)
    return ins, auxs


@rule("Convolution")
def _conv(attrs, ins, dts, auxs):
    data = ins[0]
    if data is not None:
        if ins[1] is None:
            ins[1] = (attrs["num_filter"], data[1] // attrs["num_group"]) \
                + tuple(attrs["kernel"])
        if not attrs["no_bias"] and ins[2] is None:
            ins[2] = (attrs["num_filter"],)
    return ins, auxs


@rule("BatchNorm")
def _bn(attrs, ins, dts, auxs):
    data = ins[0]
    if data is not None:
        c = (data[1],)
        ins = [data] + [c if s is None else s for s in ins[1:]]
        auxs = [c if s is None else s for s in auxs]
    return ins, auxs


@rule("Embedding")
def _emb(attrs, ins, dts, auxs):
    if ins[1] is None:
        ins[1] = (attrs["input_dim"], attrs["output_dim"])
    return ins, auxs


@rule("RNN")
def _rnn_infer(attrs, ins, dts, auxs):
    """The ``parameters`` blob's length from the data's feature width
    (like FullyConnected's weight); ``state`` and ``state_cell`` are
    (layers x directions, N, H) for time-major (T, N, C) data.
    ``_rnn_begin_state`` needs no rule: its one input is the data, and its
    output shape comes from the ``meta`` run."""
    from .rnn import rnn_param_size

    data = ins[0]
    if data is not None:
        h = attrs["state_size"]
        d = 2 if attrs["bidirectional"] else 1
        n_states = attrs["num_layers"] * d
        if ins[1] is None:
            ins[1] = (rnn_param_size(data[2], h, attrs["num_layers"],
                                     attrs["mode"], attrs["bidirectional"]),)
        for i in range(2, len(ins)):
            if ins[i] is None:
                ins[i] = (n_states, data[1], h)
    return ins, auxs


@rule("SoftmaxOutput")
def _softmax_out(attrs, ins, dts, auxs):
    data = ins[0]
    if data is not None and ins[1] is None:
        if attrs["multi_output"]:
            ins[1] = (data[0],) + tuple(data[2:])
        else:
            ins[1] = (data[0],)
    return ins, auxs


@rule("_contrib_MultiHeadAttention")
def _mha(attrs, ins, dts, auxs):
    data = ins[0]
    if data is not None:
        e = data[-1]
        if ins[2] is None:
            ins[2] = (3 * e, e)
        if ins[3] is None:
            ins[3] = (e, e)
        if not attrs["no_bias"]:
            if len(ins) > 4 and ins[4] is None:
                ins[4] = (3 * e,)
            if len(ins) > 5 and ins[5] is None:
                ins[5] = (e,)
    return ins, auxs


def _reshape_from_output(attrs, out_shape, in_shapes):
    """A Reshape whose output shape is fixed but whose input is unknown
    takes the output shape as its input shape, when the codes map that
    shape onto itself.  This is how ``softmax_label`` behind
    ``Reshape(shape=(-1,))`` gets a shape from the data shape alone (the
    JAX package has no such rule and cannot bind ``build_lm`` from the
    data shape)."""
    if not attrs["shape"] or attrs["reverse"]:
        return None
    try:
        got = _infer_reshape(attrs["shape"], out_shape)
    except (IndexError, MXNetError):
        return None
    known = math.prod(d for d in got if d != -1)
    if -1 in got:
        got = tuple(math.prod(out_shape) // known if d == -1 else d
                    for d in got)
    return [tuple(out_shape)] if got == tuple(out_shape) else None


get("Reshape").infer_from_output = _reshape_from_output


def _concat_from_output(attrs, out_shape, in_shapes):
    """A Concat whose output shape is fixed and whose inputs are all known
    but one: that one takes the output's shape with the rest of the
    ``dim`` extent (the reference's ConcatShape fills it the same way)."""
    unknown = [i for i, s in enumerate(in_shapes) if s is None]
    if len(unknown) != 1:
        return None
    dim = attrs["dim"] % len(out_shape)
    rest = out_shape[dim] - sum(s[dim] for s in in_shapes if s is not None)
    if rest <= 0:
        return None
    shapes = list(in_shapes)
    shapes[unknown[0]] = tuple(out_shape[:dim]) + (rest,) \
        + tuple(out_shape[dim + 1:])
    return shapes


get("Concat").infer_from_output = _concat_from_output


def _same_shape(attrs, ins, dts, auxs):
    known = next((s for s in ins if s is not None), None)
    if known is not None:
        ins = [known if s is None else s for s in ins]
    return ins, auxs


for _name in ("elemwise_add", "elemwise_sub", "elemwise_mul",
              "elemwise_div"):
    get(_name).infer_inputs = _same_shape


def _like_output(attrs, out_shape, in_shapes):
    """An elementwise unary op's input has its output's shape."""
    return [tuple(out_shape)]


for _name in ("_plus_scalar", "_minus_scalar", "_rminus_scalar",
              "_mul_scalar", "_div_scalar", "_rdiv_scalar", "ones_like",
              "zeros_like", "smooth_l1", "MakeLoss"):
    get(_name).infer_from_output = _like_output


def _expand_dims_from_output(attrs, out_shape, in_shapes):
    axis = attrs["axis"] % len(out_shape)
    return [tuple(out_shape[:axis]) + tuple(out_shape[axis + 1:])]


get("expand_dims").infer_from_output = _expand_dims_from_output
# ``_zeros`` takes no input: its (meta) output comes from its ``shape``
# attr under shape inference's ``device_scope("meta")``
