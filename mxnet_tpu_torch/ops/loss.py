"""Output ops (counterpart of ``mxnet_tpu/ops/loss.py``): ``SoftmaxOutput``
and ``MakeLoss``.

Their backward is the reference's bespoke rule, not the autograd of the
forward, and ignores the head gradient: for SoftmaxOutput ``grad = (p -
onehot(label)) * grad_scale`` with the ``normalization``/``use_ignore``
rules (the head gradient read only with ``out_grad``), for MakeLoss
``grad = grad_scale`` normalized by the batch or by the count of elements
above ``valid_thresh`` — each a :class:`torch.autograd.Function`, as the
JAX package wires them in with ``jax.custom_vjp``
(``mxnet_tpu/ops/loss.py:54-100``, ``:166-195``).  The valid count stays
on the device.
"""

from __future__ import annotations

import torch

from .registry import pbool, pfloat, pstr, register


def _softmax(data, multi_output, preserve_shape):
    if multi_output:
        return torch.softmax(data, dim=1)
    if preserve_shape:
        return torch.softmax(data, dim=-1)
    flat = data.reshape(data.shape[0], -1)
    return torch.softmax(flat, dim=-1).reshape(data.shape)


def softmax_output_grad(p, label, g, grad_scale, ignore_label, multi_output,
                        use_ignore, normalization, out_grad):
    """The SoftmaxOutput gradient w.r.t. its data input."""
    lab = label.to(torch.int64)  # truncates toward zero, as astype(int32)
    axis = 1 if multi_output else p.ndim - 1
    if multi_output:
        # data (n, k, x...) with label (n, x...), or flattened (n, prod(x))
        lab = lab.reshape((p.shape[0],) + tuple(p.shape[2:]))
    cls_shape = [1] * p.ndim
    cls_shape[axis] = p.shape[axis]
    classes = torch.arange(p.shape[axis], device=p.device).reshape(cls_shape)
    # an out-of-range label (ignore_label -1) one-hots to all zeros
    onehot = (lab.unsqueeze(axis) == classes).to(p.dtype)
    grad = p - onehot
    valid = torch.ones_like(lab, dtype=p.dtype)
    if use_ignore:
        valid = (lab != ignore_label).to(p.dtype)
        grad = grad * valid.unsqueeze(axis)
    scale = grad_scale
    if normalization == "batch":
        scale = scale / p.shape[0]
    elif normalization == "valid":
        scale = scale / torch.clamp(valid.sum(), min=1.0)
    grad = grad * scale
    if out_grad:
        grad = grad * g
    return grad.to(p.dtype)


class SoftmaxOutputFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, attrs):
        p = _softmax(data, attrs["multi_output"], attrs["preserve_shape"])
        ctx.save_for_backward(p, label)
        ctx.attrs = attrs
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        a = ctx.attrs
        grad = softmax_output_grad(
            p, label, g, a["grad_scale"], a["ignore_label"],
            a["multi_output"], a["use_ignore"], a["normalization"],
            a["out_grad"])
        return grad, None, None


def _softmax_output(attrs, inputs, aux, is_train):
    data, label = inputs
    if torch.is_grad_enabled() and data.requires_grad:
        return [SoftmaxOutputFn.apply(data, label, attrs)]
    return [_softmax(data, attrs["multi_output"], attrs["preserve_shape"])]


register("SoftmaxOutput", _softmax_output, arguments=("data", "label"),
         params={"grad_scale": (pfloat, 1.0), "ignore_label": (pfloat, -1.0),
                 "multi_output": (pbool, False), "use_ignore": (pbool, False),
                 "preserve_shape": (pbool, False),
                 "normalization": (pstr, "null"), "out_grad": (pbool, False)},
         aliases=("Softmax",), hint="softmaxoutput")


class MakeLossFn(torch.autograd.Function):
    """Identity forward; the gradient ``grad_scale`` everywhere, divided
    by the batch size (``normalization="batch"``) or by the count of
    elements above ``valid_thresh`` (``"valid"``, at least 1)."""

    @staticmethod
    def forward(ctx, data, attrs):
        ctx.save_for_backward(data)
        ctx.attrs = attrs
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        (data,) = ctx.saved_tensors
        a = ctx.attrs
        scale = a["grad_scale"]
        if a["normalization"] == "batch":
            scale = scale / data.shape[0]
        elif a["normalization"] == "valid":
            valid = (data > a["valid_thresh"]).to(data.dtype).sum()
            scale = scale / torch.clamp(valid, min=1.0)
        return torch.ones_like(data) * scale, None


def _make_loss(attrs, inputs, aux, is_train):
    data = inputs[0]
    if torch.is_grad_enabled() and data.requires_grad:
        return [MakeLossFn.apply(data, attrs)]
    return [data]


register("MakeLoss", _make_loss,
         params={"grad_scale": (pfloat, 1.0), "valid_thresh": (pfloat, 0.0),
                 "normalization": (pstr, "null")}, hint="makeloss")
