"""ROI max pooling: hand-written Hopper kernels K8 (forward) and K8b
(backward) with their plain PyTorch versions, for ``ROIPooling``
(``ops/spatial.py``).

K8 and K8b replace no Pallas kernel: the JAX package runs ROIPooling as
plain JAX (``mxnet_tpu/ops/spatial.py:28`` ``_roi_pooling``), a vmap of
masked maxima over a ``(ph, pw, H, W)`` membership mask per ROI that XLA
fuses away.  As eager torch ops that mask is ``R x C x ph*pw x H*W``
elements (1.15e11 at Faster R-CNN's training size).

* :func:`roi_bounds` — each ROI's batch index and bin extents, in the JAX
  function's f32 arithmetic.
* :func:`roi_pool_fwd_plain` / :func:`roi_pool_bwd_plain` — a loop over
  the bins, each a masked maximum over a window gathered for every ROI at
  once (the backward adds ``g / count`` where a pixel equals its bin's
  maximum, by ``index_put_``).  Taken for CPU tensors.
* :func:`roi_pool_fwd_cuda` / :func:`roi_pool_bwd_cuda` — the wrappers of
  K8 and K8b (``csrc/roi_pooling.cu``; the source says what bounds them).
  Taken for CUDA tensors: they launch the kernels or raise.  ``.launches``
  on each counts its calls (:mod:`.launches`): one a call, which for K8
  is a bounds kernel and the pooling kernel.
* :func:`roi_pool` — the entry, a :class:`torch.autograd.Function`
  routed by device: ``(data, rois) -> out``; no gradient reaches the
  ROIs (they enter through floor and an integer cast in the JAX function).

Both forwards return the maximum, the count of the pixels equal to it and
the ROIs' bounds, which their backward reads in place of the ROIs; the
backward splits a bin's gradient equally among the tied pixels, the rule
of ``jnp.max``'s gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels
from ..base import MXNetError
from . import launches

__all__ = ["roi_bounds", "roi_pool_fwd_plain", "roi_pool_bwd_plain",
           "roi_pool_fwd_cuda", "roi_pool_bwd_cuda", "roi_pool",
           "ROIPoolFn", "MAX_POOL"]

#: the largest pooled side the kernels take (``csrc/roi_pooling.cu``)
MAX_POOL = 64


def _f32(v, device):
    """``v`` rounded to f32, as a tensor on ``device``: a host scalar
    divides through its reciprocal on the card."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def roi_bounds(rois, B, H, W, pooled_size, spatial_scale):
    """``(b (R,), hs (R, ph), he (R, ph), ws (R, pw), we (R, pw))`` int64:
    each ROI's image and the half-open row and column extents of its
    bins, as ``mxnet_tpu/ops/spatial.py:36-58`` computes them in f32."""
    ph, pw = pooled_size
    dev = rois.device
    rois = rois.to(torch.float32)
    b = rois[:, 0].to(torch.int32).to(torch.int64)  # truncates
    b = torch.where(b < 0, b + B, b).clamp(0, B - 1)
    scale = _f32(spatial_scale, dev)
    x1, y1, x2, y2 = [torch.floor(rois[:, k] * scale + 0.5)
                      for k in (1, 2, 3, 4)]
    one = _f32(1.0, dev)
    bin_h = torch.maximum(y2 - y1 + 1.0, one) / _f32(ph, dev)
    bin_w = torch.maximum(x2 - x1 + 1.0, one) / _f32(pw, dev)

    def extents(n, bin_, start, size):
        k = torch.arange(n, dtype=torch.float32, device=dev)
        lo = torch.floor(k * bin_[:, None]) + start[:, None]
        hi = torch.ceil((k + 1.0) * bin_[:, None]) + start[:, None]
        return (lo.clamp(0, size).to(torch.int64),
                hi.clamp(0, size).to(torch.int64))

    hs, he = extents(ph, bin_h, y1, H)
    ws, we = extents(pw, bin_w, x1, W)
    return b, hs, he, ws, we


def _windows(data, bounds, pooled_size):
    """Yields ``(i, j, bidx, rows, cols, inside)`` per bin of ``bounds``
    (:func:`roi_bounds`): ``(R, kh, kw)`` gather indices (clamped) into
    ``data`` and the mask of the bin's pixels, ``kh x kw`` the largest
    bin."""
    _B, _C, H, W = data.shape
    b, hs, he, ws, we = bounds
    kh = max(int((he - hs).max()), 1)
    kw = max(int((we - ws).max()), 1)
    dy = torch.arange(kh, device=data.device)
    dx = torch.arange(kw, device=data.device)
    for i in range(pooled_size[0]):
        rows = hs[:, i, None] + dy
        rin = rows < he[:, i, None]
        for j in range(pooled_size[1]):
            cols = ws[:, j, None] + dx
            inside = rin[:, :, None] & (cols < we[:, j, None])[:, None, :]
            yield (i, j, b[:, None, None].expand(inside.shape),
                   rows.clamp(max=H - 1)[:, :, None].expand(inside.shape),
                   cols.clamp(max=W - 1)[:, None, :].expand(inside.shape),
                   inside)


def roi_pool_fwd_plain(data, rois, pooled_size, spatial_scale):
    """``(out (R, C, ph, pw), count (R, C, ph, pw) int32, bounds)``: each
    bin's maximum and the pixels equal to it, 0 and 0 for an empty bin or
    a maximum that is not finite; ``bounds`` is :func:`roi_bounds`'s."""
    R, (B, C, H, W) = rois.shape[0], data.shape
    bounds = roi_bounds(rois, B, H, W, pooled_size, spatial_scale)
    out = data.new_zeros((R, C) + tuple(pooled_size))
    count = torch.zeros((R, C) + tuple(pooled_size), dtype=torch.int32,
                        device=data.device)
    img = data.permute(0, 2, 3, 1)  # (B, H, W, C)
    for i, j, bidx, rows, cols, inside in _windows(data, bounds,
                                                   pooled_size):
        vals = torch.where(inside[..., None], img[bidx, rows, cols],
                           -torch.inf)  # (R, kh, kw, C)
        m = vals.amax(dim=(1, 2))
        n = ((vals == m[:, None, None, :]) & inside[..., None]).sum((1, 2))
        ok = torch.isfinite(m)
        out[:, :, i, j] = torch.where(ok, m, 0.0)
        count[:, :, i, j] = torch.where(ok, n, 0).to(torch.int32)
    return out, count, bounds


def roi_pool_bwd_plain(data, bounds, out, count, g, pooled_size):
    """``dx (B, C, H, W)``: each bin's gradient split equally among its
    pixels equal to its maximum; ``bounds`` as the forward gave them."""
    B, C, H, W = data.shape
    img = data.permute(0, 2, 3, 1)
    dxp = data.new_zeros((B, H, W, C))
    share = torch.where(count > 0, g / count.clamp(min=1).to(g.dtype), 0.0)
    for i, j, bidx, rows, cols, inside in _windows(data, bounds,
                                                   pooled_size):
        hit = inside[..., None] & (img[bidx, rows, cols]
                                   == out[:, None, None, :, i, j])
        val = torch.where(hit, share[:, None, None, :, i, j], 0.0)
        dxp.index_put_((bidx, rows, cols), val, accumulate=True)
    return dxp.permute(0, 3, 1, 2).contiguous()


def _check_inputs(data, R, pooled_size):
    """``(B, C, H, W, R, ph, pw)`` for ``data`` and ``R`` ROIs; raises on
    what the kernels do not take (the checks hold on any device)."""
    if data.dtype != torch.float32 or data.ndim != 4:
        raise MXNetError("ROIPooling kernels: data must be float32 (B, C, "
                         "H, W), got %s %s" % (data.dtype, tuple(data.shape)))
    ph, pw = pooled_size
    if not (0 < ph <= MAX_POOL and 0 < pw <= MAX_POOL):
        raise MXNetError("ROIPooling kernels take pooled sizes in [1, %d], "
                         "got %s" % (MAX_POOL, tuple(pooled_size)))
    if data.numel() == 0 or R == 0:
        raise MXNetError("ROIPooling kernels: empty input %s, %d ROIs"
                         % (tuple(data.shape), R))
    return tuple(data.shape) + (R, ph, pw)


def _check_rois(data, rois):
    if rois.dtype != torch.float32 or rois.ndim != 2 or rois.shape[1] != 5:
        raise MXNetError("ROIPooling kernels: rois must be float32 (R, 5), "
                         "got %s %s" % (rois.dtype, tuple(rois.shape)))
    if rois.device != data.device:
        raise MXNetError("ROIPooling kernels: inputs on more than one device")


def _bounds_ints(lib, R, ph, pw):
    """Length of the int32 bounds array K8 writes for ``R`` ROIs."""
    fn = lib.mxtt_roi_pool_bounds_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_size_t
    return fn(R, ph, pw) // 4


def _fn(lib, name, n_ptr, scale):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                       + [ctypes.c_float] * scale + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _cuda_only(data, what):
    if data.device.type != "cuda":
        raise MXNetError("%s takes CUDA tensors, got %s" % (what, data.device))


def roi_pool_fwd_cuda(data, rois, pooled_size, spatial_scale):
    """Launch kernel K8 on the data's card, on the current stream.  Returns
    ``(out, count, bounds)``, ``bounds`` an int32 array for K8b; raises on
    inputs the kernel does not take."""
    _check_rois(data, rois)
    B, C, H, W, R, ph, pw = _check_inputs(data, rois.shape[0], pooled_size)
    _cuda_only(data, "K8")
    data, rois = data.contiguous(), rois.contiguous()
    out = torch.empty((R, C, ph, pw), dtype=torch.float32, device=data.device)
    count = torch.empty((R, C, ph, pw), dtype=torch.int32,
                        device=data.device)
    lib = _kernels.load("roi_pooling")
    bounds = torch.empty(_bounds_ints(lib, R, ph, pw), dtype=torch.int32,
                         device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = _fn(lib, "mxtt_roi_pool_fwd", 5, 1)(
            data.data_ptr(), rois.data_ptr(), out.data_ptr(),
            count.data_ptr(), bounds.data_ptr(), B, C, H, W, R, ph, pw,
            float(spatial_scale), stream)
    if err != 0:
        raise MXNetError("ROI pooling forward kernel launch failed: CUDA "
                         "error %d" % err)
    launches.count(roi_pool_fwd_cuda)
    return out, count, bounds


def roi_pool_bwd_cuda(data, bounds, out, count, g, pooled_size):
    """Launch kernel K8b on the data's card, on the current stream, with
    K8's ``bounds``, ``out`` and ``count``.  Returns ``dx``; raises on
    inputs the kernel does not take."""
    B, C, H, W, R, ph, pw = _check_inputs(
        data, out.shape[0] if out.ndim == 4 else 0, pooled_size)
    _cuda_only(data, "K8b")
    lib = _kernels.load("roi_pooling")
    want = (R, C, ph, pw)
    for name, t, dtype, shape in (
            ("out", out, torch.float32, want),
            ("count", count, torch.int32, want),
            ("g", g, torch.float32, want),
            ("bounds", bounds, torch.int32, (_bounds_ints(lib, R, ph, pw),))):
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != data.device:
            raise MXNetError("K8b: %s must be %s %s on %s, got %s %s on %s"
                             % (name, dtype, shape, data.device, t.dtype,
                                tuple(t.shape), t.device))
    data, bounds = data.contiguous(), bounds.contiguous()
    out, count, g = out.contiguous(), count.contiguous(), g.contiguous()
    dx = torch.empty_like(data)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = _fn(lib, "mxtt_roi_pool_bwd", 6, 0)(
            data.data_ptr(), bounds.data_ptr(), out.data_ptr(),
            count.data_ptr(), g.data_ptr(), dx.data_ptr(),
            B, C, H, W, R, ph, pw, stream)
    if err != 0:
        raise MXNetError("ROI pooling backward kernel launch failed: CUDA "
                         "error %d" % err)
    launches.count(roi_pool_bwd_cuda)
    return dx


#: launches of kernels K8 and K8b in this process (reset freely)
roi_pool_fwd_cuda.launches = 0
roi_pool_bwd_cuda.launches = 0


#: the kernel for CUDA tensors, the plain version for CPU tensors
_route = functools.partial(launches.route, what="ROI pooling")


class ROIPoolFn(torch.autograd.Function):
    """``(data, rois) -> out`` through K8, the data's gradient through K8b
    (their plain versions on the CPU); the ROIs get a zero gradient."""

    @staticmethod
    def forward(ctx, data, rois, pooled_size, spatial_scale):
        fwd = _route(data, roi_pool_fwd_cuda, roi_pool_fwd_plain)
        out, count, ctx.bounds = fwd(data, rois, pooled_size, spatial_scale)
        ctx.save_for_backward(data, out, count)
        ctx.hyper = (pooled_size, rois.shape, rois.dtype, rois.device)
        return out

    @staticmethod
    def backward(ctx, g):
        data, out, count = ctx.saved_tensors
        pooled_size, *rois_like = ctx.hyper
        bwd = _route(data, roi_pool_bwd_cuda, roi_pool_bwd_plain)
        dx = bwd(data, ctx.bounds, out, count, g.contiguous(), pooled_size)
        drois = None
        if ctx.needs_input_grad[1]:
            shape, dtype, device = rois_like
            drois = torch.zeros(shape, dtype=dtype, device=device)
        return dx, drois, None, None


def roi_pool(data, rois, pooled_size, spatial_scale):
    """ROI max pooling of ``data (B, C, H, W)`` over ``rois (R, 5)`` rows
    ``[batch, x1, y1, x2, y2]`` in image coordinates: ``(R, C, ph, pw)``."""
    return ROIPoolFn.apply(data, rois, tuple(pooled_size),
                           float(spatial_scale))
