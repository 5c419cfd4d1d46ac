"""Layer ops (counterpart of ``mxnet_tpu/ops/nn.py``): ``FullyConnected``,
``Activation``, ``Convolution``, ``Pooling``, ``BatchNorm``, ``Dropout``,
``Concat``, ``SliceChannel``, ``SoftmaxActivation``, ``L2Normalization``
and ``LRN``.

FullyConnected, Activation, Convolution and Pooling are plain ``torch``
calls in f32: the JAX package leaves them to XLA, outside any Pallas
kernel, so they have no hand-written kernel here.  Train-mode BatchNorm
goes to kernels K1/K2 (``ops/bn_kernel.py``) on the card; its other modes
are plain tensor code, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import bn_kernel
from .registry import REQUIRED, pbool, pfloat, pint, pstr, ptuple, register


def _fully_connected(attrs, inputs, aux, is_train):
    data, weight = inputs[0], inputs[1]
    if data.dtype != weight.dtype:
        # the parameter dtype defines the net's compute precision
        data = data.to(weight.dtype)
    if attrs["flatten"] and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    out = torch.matmul(data, weight.t())
    if not attrs["no_bias"]:
        out = out + inputs[2]
    return [out]


register("FullyConnected", _fully_connected,
         arguments=lambda a: ["data", "weight"]
         + ([] if a["no_bias"] else ["bias"]),
         params={"num_hidden": (pint, REQUIRED), "no_bias": (pbool, False),
                 "flatten": (pbool, True)},
         hint="fullyconnected")


_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
}


def _activation(attrs, inputs, aux, is_train):
    return [_ACTS[attrs["act_type"]](inputs[0])]


register("Activation", _activation,
         params={"act_type": (pstr, REQUIRED)}, hint="activation")


# -- Convolution --------------------------------------------------------------
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _norm_stp(kernel, stride, dilate, pad):
    nd = len(kernel)
    return (tuple(stride) if stride else (1,) * nd,
            tuple(dilate) if dilate else (1,) * nd,
            tuple(pad) if pad else (0,) * nd)


def _convolution(attrs, inputs, aux, is_train):
    data, weight = inputs[0], inputs[1]
    if data.dtype != weight.dtype:
        data = data.to(weight.dtype)
    kernel = attrs["kernel"]
    nd = len(kernel)
    if nd not in _CONV:
        raise MXNetError("Convolution: %d-d kernels are not supported" % nd)
    # "None": an unset layout as a graph JSON of either package writes it
    if attrs["layout"] not in (None, "None", "NCW", "NCHW", "NCDHW"):
        raise MXNetError("Convolution: layout %r not ported yet"
                         % attrs["layout"])
    stride, dilate, pad = _norm_stp(kernel, attrs["stride"], attrs["dilate"],
                                    attrs["pad"])
    bias = None if attrs["no_bias"] else inputs[2]
    return [_CONV[nd](data, weight, bias, stride=stride, padding=pad,
                      dilation=dilate, groups=attrs["num_group"])]


# workspace / cudnn_tune / cudnn_off are the reference's cuDNN hints: kept
# so graph JSON round-trips, and without effect, as in the JAX package
_CONV_PARAMS = {
    "kernel": (ptuple, REQUIRED), "stride": (ptuple, ()),
    "dilate": (ptuple, ()), "pad": (ptuple, ()),
    "num_filter": (pint, REQUIRED), "num_group": (pint, 1),
    "workspace": (pint, 1024), "no_bias": (pbool, False),
    "cudnn_tune": (pstr, None), "cudnn_off": (pbool, False),
    "layout": (pstr, None),
}

register("Convolution", _convolution,
         arguments=lambda a: ["data", "weight"]
         + ([] if a["no_bias"] else ["bias"]),
         params=_CONV_PARAMS, hint="convolution")


# -- Pooling ------------------------------------------------------------------
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_out_dim(x, k, p, s, convention):
    if convention == "full":
        return int(math.ceil(float(x + 2 * p - k) / s)) + 1
    return int(math.floor(float(x + 2 * p - k) / s)) + 1


def _pooling(attrs, inputs, aux, is_train):
    data = inputs[0]
    nd = data.ndim - 2
    if nd not in _MAX_POOL:
        raise MXNetError("Pooling: %d-d inputs are not supported" % nd)
    if attrs["global_pool"]:
        kernel, stride, pad = tuple(data.shape[2:]), (1,) * nd, (0,) * nd
        convention = "valid"
    else:
        kernel = attrs["kernel"]
        stride, _, pad = _norm_stp(kernel, attrs["stride"], (), attrs["pad"])
        convention = attrs["pooling_convention"]
    # explicit padding: `pad` before, and after as much as the output size
    # needs ('full' rounds up) but never less than `pad`
    widths = []
    for i in reversed(range(nd)):
        o = _pool_out_dim(data.shape[2 + i], kernel[i], pad[i], stride[i],
                          convention)
        need = (o - 1) * stride[i] + kernel[i] - data.shape[2 + i] - pad[i]
        widths += [pad[i], max(need, pad[i])]
    pt = attrs["pool_type"]
    if pt == "max":
        # implicit -inf padding
        x = F.pad(data, widths, value=float("-inf")) if any(widths) else data
        return [_MAX_POOL[nd](x, kernel, stride)]
    if pt in ("avg", "sum"):
        # the window counts its padding (the reference's mshadow pool)
        x = F.pad(data, widths) if any(widths) else data
        out = _AVG_POOL[nd](x, kernel, stride)
        return [out * float(math.prod(kernel)) if pt == "sum" else out]
    raise MXNetError("Pooling: bad pool_type %r" % pt)


register("Pooling", _pooling,
         params={"kernel": (ptuple, ()), "pool_type": (pstr, "max"),
                 "global_pool": (pbool, False), "stride": (ptuple, ()),
                 "pad": (ptuple, ()), "pooling_convention": (pstr, "valid")},
         aliases=("Pooling_v1",), hint="pooling")


# -- BatchNorm ----------------------------------------------------------------
def _moving(moving, batch, momentum):
    with torch.no_grad():
        return moving * momentum + batch.detach() * (1 - momentum)


def _batch_norm(attrs, inputs, aux, is_train, act_type=None):
    """Returns ``(outputs, new_aux)``.  ``act_type="relu"`` fuses the
    activation into the kernel; only the executor's BN->ReLU peephole sets
    it (the registered op always passes None)."""
    x, gamma, beta = inputs
    moving_mean, moving_var = aux
    eps, fix_gamma, mom = attrs["eps"], attrs["fix_gamma"], attrs["momentum"]
    relu = act_type == "relu"
    use_batch = is_train and not attrs["use_global_stats"]
    if use_batch and not attrs["output_mean_var"]:
        out, mean, var = bn_kernel.bn_train(x, gamma, beta, eps, fix_gamma,
                                            relu)
        return [out], [_moving(moving_mean, mean, mom),
                       _moving(moving_var, var, mom)]
    bshape = (1, -1) + (1,) * (x.ndim - 2)
    if use_batch:
        # output_mean_var: mean and var are outputs that carry gradients,
        # so this mode stays plain tensor code (f32, biased)
        mean, var = bn_kernel.batch_stats(x.float())
    else:
        mean, var = moving_mean, moving_var
    g = torch.ones_like(gamma) if fix_gamma else gamma
    scale = (g.float() * torch.rsqrt(var + eps)).to(x.dtype)
    shift = (beta.float() - mean * scale.float()).to(x.dtype)
    out = x * scale.reshape(bshape) + shift.reshape(bshape)
    if relu:
        out = torch.relu(out)
    outs = [out, mean, var] if attrs["output_mean_var"] else [out]
    if use_batch:
        return outs, [_moving(moving_mean, mean, mom),
                      _moving(moving_var, var, mom)]
    return outs, None


register("BatchNorm", _batch_norm,
         arguments=("data", "gamma", "beta"),
         aux_states=("moving_mean", "moving_var"),
         outputs=lambda a: ["output", "mean", "var"] if a["output_mean_var"]
         else ["output"],
         params={"eps": (pfloat, 1e-3), "momentum": (pfloat, 0.9),
                 "fix_gamma": (pbool, True),
                 "use_global_stats": (pbool, False),
                 "output_mean_var": (pbool, False)},
         aliases=("CuDNNBatchNorm",), hint="batchnorm", updates_aux=True)


def dropout(x, p):
    """Inverted dropout of ``x``: each element kept with probability
    ``1 - p`` as ``x / keep``, else 0 (the JAX package's ``where(mask, x /
    keep, 0)``; the divisor is a tensor, so the card divides as the CPU
    does rather than multiplying by a reciprocal).  The mask is drawn
    from ``mx.random.generator(x.device)``; it never matches the JAX
    package's threefry mask."""
    from .. import random as _random

    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=_random.generator(x.device),
                      device=x.device) < keep
    return torch.where(mask, x / torch.full((), keep, dtype=x.dtype,
                                            device=x.device),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _dropout(attrs, inputs, aux, is_train):
    """:func:`dropout` in training; the identity otherwise."""
    x = inputs[0]
    if not is_train or attrs["p"] <= 0.0:
        return [x]
    return [dropout(x, attrs["p"])]


register("Dropout", _dropout, params={"p": (pfloat, 0.5)}, hint="dropout",
         draws=True)


def _concat(attrs, inputs, aux, is_train):
    return [torch.cat(inputs, dim=attrs["dim"])]


# variadic: num_args counts the inputs arg0..argN-1 (filled from the
# positional inputs by sym.Concat and nd.concat when omitted)
register("Concat", _concat,
         arguments=lambda a: ["arg%d" % i for i in range(a["num_args"])],
         params={"num_args": (pint, REQUIRED), "dim": (pint, 1)},
         key_var_num_args="num_args", aliases=("concat",), hint="concat")


def _slice_channel(attrs, inputs, aux, is_train):
    parts = torch.chunk(inputs[0], attrs["num_outputs"], dim=attrs["axis"])
    if attrs["squeeze_axis"]:
        parts = [p.squeeze(attrs["axis"]) for p in parts]
    return list(parts)


register("SliceChannel", _slice_channel,
         outputs=lambda a: ["output%d" % i for i in range(a["num_outputs"])],
         params={"num_outputs": (pint, REQUIRED), "axis": (pint, 1),
                 "squeeze_axis": (pbool, False)},
         aliases=("split",), hint="slicechannel")


def _softmax_activation(attrs, inputs, aux, is_train):
    x = inputs[0]
    if attrs["mode"] == "channel":
        return [torch.softmax(x, dim=1)]
    return [torch.softmax(x.reshape(x.shape[0], -1), dim=-1)
            .reshape(x.shape)]


register("SoftmaxActivation", _softmax_activation,
         params={"mode": (pstr, "instance")}, hint="softmaxactivation")


def _l2_normalization(attrs, inputs, aux, is_train):
    x = inputs[0]
    mode = attrs["mode"]
    if mode == "instance":
        red = tuple(range(1, x.ndim))
    elif mode == "channel":
        red = (1,)
    elif mode == "spatial":
        red = tuple(range(2, x.ndim))
    else:
        raise MXNetError("L2Normalization: bad mode %r" % mode)
    norm = torch.sqrt(torch.sum(torch.square(x), dim=red, keepdim=True)
                      + attrs["eps"])
    return [x / norm]


register("L2Normalization", _l2_normalization,
         params={"eps": (pfloat, 1e-10), "mode": (pstr, "instance")},
         hint="l2normalization")


def _lrn(attrs, inputs, aux, is_train):
    """Across-channel LRN: the window of ``nsize`` channels around each
    (``nsize // 2`` before), summed in window order."""
    x = inputs[0]
    n = attrs["nsize"]
    half = n // 2
    sq = torch.square(x)
    pad = [0, 0] * (x.ndim - 2) + [half, n - 1 - half]
    sqp = F.pad(sq, pad)
    c = x.shape[1]
    ssum = sqp[:, 0:c]
    for k in range(1, n):
        ssum = ssum + sqp[:, k:k + c]
    scale = attrs["knorm"] + (attrs["alpha"] / n) * ssum
    return [x * torch.pow(scale, -attrs["beta"])]


register("LRN", _lrn,
         params={"alpha": (pfloat, 1e-4), "beta": (pfloat, 0.75),
                 "knorm": (pfloat, 2.0), "nsize": (pint, REQUIRED)},
         hint="lrn")
