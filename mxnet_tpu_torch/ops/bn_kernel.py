"""Train-mode BatchNorm: hand-written Hopper kernels K1 (forward) and K2
(backward) with their plain PyTorch versions, counterpart of
``mxnet_tpu/ops/bn_pallas.py``.

* :func:`bn_fwd_plain` / :func:`bn_bwd_plain` — the same math in torch
  (exact statistics, summed in f64 by :func:`batch_stats`).  Taken for
  CPU tensors.
* :func:`bn_fwd_cuda` / :func:`bn_bwd_cuda` — the wrappers of kernels K1
  and K2 (``csrc/batch_norm.cu``), which replace the TPU kernels
  ``bn_pallas.py::_bn_fwd_kernel`` and ``::_bn_bwd_kernel``; the source
  says what bounds them and how the design meets that.  Taken for CUDA
  tensors: they launch the kernel or raise.  ``.launches`` on each counts
  its launches (:mod:`.launches`; one launch = one call: one CUDA kernel where a channel
  fits a thread-block cluster's shared memory, three on the chunked path
  of larger channels).
* :func:`bn_plan` — which of the two layouts a shape gets on a card.
* :func:`bn_train` — the public entry, a :class:`torch.autograd.Function`
  whose forward returns ``(y, mean, var)`` and whose backward ignores the
  cotangents of mean and var (they feed only the moving-stat update, made
  outside under ``no_grad``), as ``bn_pallas.py:263-275`` does.

Both kernels take x in the layout PyTorch's convolutions produce:
NCHW-contiguous, any rank (N, C, spatial...).  The scale and shift are
rounded as ``rstd = 1 / sqrt(var + eps)``, ``scale = gamma * rstd``,
``shift = beta - mean * scale``, ``pre = x * scale + shift`` in both the
kernels and the plain versions, so a ReLU mask recomputed from the same
statistics agrees bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels
from ..base import MXNetError
from . import launches

__all__ = ["batch_stats", "bn_fwd_plain", "bn_bwd_plain", "bn_fwd_cuda",
           "bn_bwd_cuda", "bn_plan", "bn_train", "BatchNormTrain"]

def _view(t, ndim):
    """(C,) -> (1, C, 1, ...) for broadcasting against NC[spatial]."""
    return t.reshape((1, -1) + (1,) * (ndim - 2))


def _scale_shift(mean, var, gamma, beta, eps, fix_gamma):
    """(rstd, scale, shift) in f32, rounded as the kernels round them."""
    rstd = 1.0 / torch.sqrt(var + eps)
    scale = rstd if fix_gamma else gamma.float() * rstd
    return rstd, scale, beta.float() - mean * scale


def batch_stats(xf):
    """Biased ``(mean, var)`` over all axes but 1 of the f32 ``xf``,
    summed in f64 and rounded to f32: exact statistics, which K1 matches
    to within its f32 partial sums (it merges them in f64).  Two-pass f32
    sums in torch moved one ReLU input of a small ResNet across zero at
    its fourth SGD step on raw 0-255 pixels, against the JAX package's
    fit (``tests/test_torch_preemption.py``).  Autograd flows through
    the casts (``output_mean_var``)."""
    red = (0,) + tuple(range(2, xf.ndim))
    x = xf.double()
    mean = x.mean(dim=red)
    var = torch.square(x - _view(mean, xf.ndim)).mean(dim=red)
    return mean.float(), var.float()


def bn_fwd_plain(x, gamma, beta, eps, fix_gamma, relu=False):
    """K1's function in torch: ``(y, mean, var)``, stats f32 ``(C,)``."""
    xf = x.float()
    mean, var = batch_stats(xf)
    _rstd, scale, shift = _scale_shift(mean, var, gamma, beta, eps,
                                       fix_gamma)
    y = xf * _view(scale, x.ndim) + _view(shift, x.ndim)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype), mean, var


def bn_bwd_plain(x, g, mean, var, gamma, beta, eps, fix_gamma, relu=False):
    """K2's function in torch: ``(dx, dgamma, dbeta)``; dgamma is the raw
    ``sum g * xhat`` (zeroed under fix_gamma by the caller)."""
    red = (0,) + tuple(range(2, x.ndim))
    xf, gf = x.float(), g.float()
    m = x.numel() // x.shape[1]
    rstd, scale, shift = _scale_shift(mean, var, gamma, beta, eps,
                                      fix_gamma)
    if relu:
        pre = xf * _view(scale, x.ndim) + _view(shift, x.ndim)
        gf = torch.where(pre > 0, gf, torch.zeros_like(gf))
    xhat = (xf - _view(mean, x.ndim)) * _view(rstd, x.ndim)
    dbeta = gf.sum(dim=red)
    dgamma = (gf * xhat).sum(dim=red)
    k = rstd if fix_gamma else gamma.float() * rstd
    dx = _view(k, x.ndim) * (gf - _view(dbeta / m, x.ndim)
                             - xhat * _view(dgamma / m, x.ndim))
    return dx.to(x.dtype), dgamma, dbeta


# -- the kernels --------------------------------------------------------------
def _dims(x):
    if x.dim() < 2:
        raise MXNetError("batch norm kernel: x must be (N, C, ...), got "
                         "shape %s" % (tuple(x.shape),))
    n, c = x.shape[0], x.shape[1]
    s = x.numel() // max(n * c, 1)
    return n, c, s


def _check(name, t, x, shape):
    if t.dtype != torch.float32:
        raise MXNetError("batch norm kernel takes float32 (bfloat16 is not "
                         "ported yet), got %s %s" % (name, t.dtype))
    if t.device != x.device:
        raise MXNetError("batch norm kernel: %s on %s, x on %s"
                         % (name, t.device, x.device))
    if tuple(t.shape) != tuple(shape):
        raise MXNetError("batch norm kernel: %s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise MXNetError("batch norm kernel: %s must be contiguous (NCHW "
                         "layout), got strides %s" % (name, t.stride()))


def _check_inputs(x, vectors, grads=()):
    """Raise on what the kernels do not take; returns (N, C, S)."""
    n, c, s = _dims(x)
    _check("x", x, x, x.shape)
    for name, t in grads:
        _check(name, t, x, x.shape)
    for name, t in vectors:
        _check(name, t, x, (c,))
    if n * c * s == 0:
        raise MXNetError("batch norm kernel: empty input %s"
                         % (tuple(x.shape),))
    return n, c, s


def _fn(lib, name, n_ptr):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _work(lib, x, n, c, s, bwd):
    """The kernels' work space, sized by the kernel source itself."""
    fn = lib.mxtt_bn_work_floats
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_longlong] * 3 + [ctypes.c_int]
        fn.restype = ctypes.c_longlong
    floats = fn(n, c, s, int(bwd))
    if floats < 0:
        raise MXNetError("batch norm kernel does not take shape %s (it "
                         "takes C <= 65535 and N*spatial below about 2^31)"
                         % (tuple(x.shape),))
    return torch.empty((floats,), dtype=torch.float32, device=x.device)


def bn_fwd_cuda(x, gamma, beta, eps, fix_gamma, relu=False):
    """Launch kernel K1 on x's card, on the current stream.  Returns
    ``(y, mean, var)``; raises on inputs the kernel does not take."""
    n, c, s = _check_inputs(x, (("gamma", gamma), ("beta", beta)))
    y = torch.empty_like(x)
    mean = torch.empty((c,), dtype=torch.float32, device=x.device)
    var = torch.empty((c,), dtype=torch.float32, device=x.device)
    lib = _kernels.load("batch_norm")
    work = _work(lib, x, n, c, s, bwd=False)
    fn = _fn(lib, "mxtt_bn_fwd", 7)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 y.data_ptr(), mean.data_ptr(), var.data_ptr(),
                 work.data_ptr(), n, c, s, float(eps), int(bool(fix_gamma)),
                 int(bool(relu)), stream)
    if err != 0:
        raise MXNetError("batch norm forward kernel launch failed: CUDA "
                         "error %d" % err)
    launches.count(bn_fwd_cuda)
    return y, mean, var


def bn_bwd_cuda(x, g, mean, var, gamma, beta, eps, fix_gamma, relu=False):
    """Launch kernel K2 on x's card, on the current stream.  Returns
    ``(dx, dgamma, dbeta)``; raises on inputs the kernel does not take."""
    n, c, s = _check_inputs(
        x, (("mean", mean), ("var", var), ("gamma", gamma), ("beta", beta)),
        grads=(("g", g),))
    dx = torch.empty_like(x)
    dgamma = torch.empty((c,), dtype=torch.float32, device=x.device)
    dbeta = torch.empty((c,), dtype=torch.float32, device=x.device)
    lib = _kernels.load("batch_norm")
    work = _work(lib, x, n, c, s, bwd=True)
    fn = _fn(lib, "mxtt_bn_bwd", 10)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), mean.data_ptr(), var.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr(), dx.data_ptr(),
                 dgamma.data_ptr(), dbeta.data_ptr(), work.data_ptr(), n, c,
                 s, float(eps), int(bool(fix_gamma)), int(bool(relu)),
                 stream)
    if err != 0:
        raise MXNetError("batch norm backward kernel launch failed: CUDA "
                         "error %d" % err)
    launches.count(bn_bwd_cuda)
    return dx, dgamma, dbeta


def bn_plan(N, C, S, bwd, device):
    """How K1 (``bwd=False``) or K2 lays out input ``(N, C, S)`` (S the
    spatial dims flattened) on ``device``: ``path`` ("resident": one
    channel per thread-block cluster, held in shared memory; "chunked":
    three kernels over (chunk, channel) blocks), CTAs per cluster,
    channels per CTA, strips of S per CTA, clusters launched, clusters
    the card holds at once, shared memory per CTA.  On the chunked path
    a "cluster" is one block of its first kernel."""
    device = torch.device(device)
    if device.type != "cuda":
        raise MXNetError("bn_plan reports the kernels' layout on a CUDA "
                         "device, got %s" % device)
    fn = _kernels.load("batch_norm").mxtt_bn_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_longlong] * 3 + [
            ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 7)()
    with torch.cuda.device(device):
        err = fn(N, C, S, int(bool(bwd)), out)
    if err != 0:
        raise MXNetError("batch norm plan failed for (%d, %d, %d): CUDA "
                         "error %d" % (N, C, S, err))
    plan = dict(zip(("resident", "ctas_per_cluster", "channels_per_cta",
                     "strips_per_cta", "clusters", "active_clusters",
                     "smem_bytes"), out))
    plan["path"] = "resident" if plan.pop("resident") else "chunked"
    return plan


#: launches of kernels K1 and K2 in this process (reset freely)
bn_fwd_cuda.launches = 0
bn_bwd_cuda.launches = 0


#: the kernel for CUDA tensors, the plain version for CPU tensors
_route = functools.partial(launches.route, what="batch norm")


class BatchNormTrain(torch.autograd.Function):
    """``(x, gamma, beta) -> (y, mean, var)`` through K1, backward through
    K2 (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, fix_gamma, relu):
        fwd = _route(x, bn_fwd_cuda, bn_fwd_plain)
        y, mean, var = fwd(x, gamma, beta, eps, fix_gamma, relu)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.hyper = (eps, fix_gamma, relu)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        eps, fix_gamma, relu = ctx.hyper
        # the kernel reads g in x's layout; autograd hands a strided
        # gradient only behind a view op, and then this is the one copy
        gy = gy.contiguous()
        bwd = _route(x, bn_bwd_cuda, bn_bwd_plain)
        dx, dgamma, dbeta = bwd(x, gy, mean, var, gamma, beta, eps,
                                fix_gamma, relu)
        if fix_gamma:
            dgamma = torch.zeros_like(dgamma)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None,
                None, None)


def bn_train(x, gamma, beta, eps, fix_gamma, relu=False):
    """Train-mode BatchNorm over NC[spatial] ``x``: ``(y, mean, var)``
    with the biased batch variance; optional fused ReLU."""
    return BatchNormTrain.apply(x, gamma, beta, float(eps), bool(fix_gamma),
                                bool(relu))
