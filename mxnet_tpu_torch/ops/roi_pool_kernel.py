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
* :func:`roi_bin_stats` — each bin's maximum and the pixels equal to it,
  over a channels-last map: what K8 writes (the maxima) and what K8b
  rebuilds (maxima and counts) instead of reading them back.
* :func:`roi_pool_fwd_plain` / :func:`roi_pool_bwd_plain` — a loop over
  the bins, each a masked maximum over a window gathered for every ROI at
  once (the backward adds ``g / count`` where a pixel equals its bin's
  maximum, by ``index_put_``).  Taken for CPU tensors.
* :func:`roi_pool_fwd_cuda` / :func:`roi_pool_bwd_cuda` — the wrappers of
  K8 and K8b (``csrc/roi_pooling.cu``; the source says what bounds them).
  Taken for CUDA tensors: they launch the kernels or raise.  ``.launches``
  on each counts its calls (:mod:`.launches`): one a call, which for K8
  is the channels-last copy, a bounds kernel and the pooling kernel.
  :func:`fwd_parts` / :func:`bwd_parts` launch parts of either, uncounted,
  for the scripts that time them; :func:`roi_bwd_plan` is K8b's tiling
  (:func:`kernel_bwd_plan` reads it from a build of the source).
* :func:`roi_pool` — the entry, a :class:`torch.autograd.Function`
  routed by device: ``(data, rois) -> out``; no gradient reaches the
  ROIs (they enter through floor and an integer cast in the JAX function).

Both forwards return the maxima, the ROIs' bounds and the channels-last
map ``xt (B, H, W, C)``, which their backward reads in place of the ROIs
and the map; the backward rebuilds each bin's maximum and tie count from
``xt`` and splits the bin's gradient equally among the tied pixels, the
rule of ``jnp.max``'s gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels
from ..base import MXNetError
from . import launches

__all__ = ["roi_bounds", "roi_bin_stats", "roi_pool_fwd_plain",
           "roi_pool_bwd_plain", "roi_pool_fwd_cuda", "roi_pool_bwd_cuda",
           "roi_bwd_plan", "kernel_bwd_plan", "fwd_parts", "bwd_parts",
           "roi_pool", "ROIPoolFn", "MAX_POOL", "FWD_COPY", "FWD_BOUNDS", "FWD_POOL",
           "BWD_LIST", "BWD_STEPS", "BWD_WRITE"]

#: the largest pooled side the kernels take (``csrc/roi_pooling.cu``)
MAX_POOL = 64
#: K8's parts: the channels-last copy, the bounds, the pooling
FWD_COPY, FWD_BOUNDS, FWD_POOL = 1, 2, 4
#: K8b's parts: the ROI lists, the steps over them, the write of dx
BWD_LIST, BWD_STEPS, BWD_WRITE = 1, 2, 4
#: K8b's tiling constants (``csrc/roi_pooling.cu``): channels a block
#: takes (a warp's lanes), threads a block, tile pixels a thread sums
#: (``PMAX``), ROIs and bins a step
CHANNEL_TILE, BWD_THREADS, PIXELS_A_THREAD = 32, 512, 8
BWD_GROUP, BWD_CAP = 8, 128


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


def _windows(H, W, bounds, pooled_size):
    """Yields ``(i, j, bidx, rows, cols, inside)`` per bin of ``bounds``
    (:func:`roi_bounds`) on an ``H x W`` map: ``(R, kh, kw)`` gather
    indices (clamped) and the mask of the bin's pixels, ``kh x kw`` the
    largest bin."""
    b, hs, he, ws, we = bounds
    kh = max(int((he - hs).max()), 1)
    kw = max(int((we - ws).max()), 1)
    dy = torch.arange(kh, device=b.device)
    dx = torch.arange(kw, device=b.device)
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


def roi_bin_stats(xt, bounds, pooled_size):
    """``(m, n)``, each ``(R, C, ph, pw)``: every bin's maximum over the
    channels-last map ``xt (B, H, W, C)`` and the number of its pixels
    equal to it (int32); 0 and 0 for an empty bin or a maximum that is
    not finite (the JAX function's ``where(isfinite(out), out, 0)``)."""
    _B, H, W, C = xt.shape
    R = bounds[0].shape[0]
    m = xt.new_zeros((R, C) + tuple(pooled_size))
    n = torch.zeros((R, C) + tuple(pooled_size), dtype=torch.int32,
                    device=xt.device)
    for i, j, bidx, rows, cols, inside in _windows(H, W, bounds,
                                                   pooled_size):
        vals = torch.where(inside[..., None], xt[bidx, rows, cols],
                           -torch.inf)  # (R, kh, kw, C)
        mx = vals.amax(dim=(1, 2))
        cnt = ((vals == mx[:, None, None, :]) & inside[..., None]).sum((1, 2))
        ok = torch.isfinite(mx)
        m[:, :, i, j] = torch.where(ok, mx, 0.0)
        n[:, :, i, j] = torch.where(ok, cnt, 0).to(torch.int32)
    return m, n


def roi_pool_fwd_plain(data, rois, pooled_size, spatial_scale):
    """``(out (R, C, ph, pw), bounds, xt (B, H, W, C))``: each bin's
    maximum (:func:`roi_bin_stats`), :func:`roi_bounds`'s bounds and the
    channels-last map the backward reads."""
    B, _C, H, W = data.shape
    bounds = roi_bounds(rois, B, H, W, pooled_size, spatial_scale)
    xt = data.permute(0, 2, 3, 1).contiguous()
    out, _n = roi_bin_stats(xt, bounds, pooled_size)
    return out, bounds, xt


def roi_pool_bwd_plain(xt, bounds, g, pooled_size):
    """``dx (B, C, H, W)``: each bin's gradient split equally among its
    pixels equal to its maximum, maximum and count rebuilt from the
    channels-last map ``xt``; ``bounds`` as the forward gave them."""
    B, H, W, C = xt.shape
    m, n = roi_bin_stats(xt, bounds, pooled_size)
    dxp = xt.new_zeros((B, H, W, C))
    share = torch.where(n > 0, g / n.clamp(min=1).to(g.dtype), 0.0)
    for i, j, bidx, rows, cols, inside in _windows(H, W, bounds,
                                                   pooled_size):
        hit = inside[..., None] & (xt[bidx, rows, cols]
                                   == m[:, None, None, :, i, j])
        val = torch.where(hit, share[:, None, None, :, i, j], 0.0)
        dxp.index_put_((bidx, rows, cols), val, accumulate=True)
    return dxp.permute(0, 3, 1, 2).contiguous()


def roi_bwd_plan(H, W):
    """K8b's tiling of an ``H x W`` map, as ``mxtt_roi_pool_bwd_plan``
    derives it: ``{"band": rows a tile, "width": columns a tile,
    "channels": channels a tile, "threads", "group": ROIs a step, "cap":
    bins a step}``.  A tile holds up to ``BWD_THREADS / 32 *
    PIXELS_A_THREAD`` pixels: the full width when it fits (else runs of
    that many columns), and as many rows as fit; two rows of Faster
    R-CNN's 62-column map, 37 rows in 19 bands."""
    pixels = BWD_THREADS // 32 * PIXELS_A_THREAD
    width = min(W, pixels)
    return {"band": min(H, pixels // width), "width": width,
            "channels": CHANNEL_TILE, "threads": BWD_THREADS,
            "group": BWD_GROUP, "cap": BWD_CAP}


def kernel_bwd_plan(H, W, pooled_size, lib=None):
    """``(plan, smem)``: K8b's tiling of an ``H x W`` map as a build of
    ``csrc/roi_pooling.cu`` (``lib``, the port's own when None) derives
    it, keyed as :func:`roi_bwd_plan`'s, and its block's shared memory in
    bytes."""
    lib = _kernels.load("roi_pooling") if lib is None else lib
    fn = lib.mxtt_roi_pool_bwd_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_size_t
    plan = (ctypes.c_int * 6)()
    smem = fn(H, W, pooled_size[0], pooled_size[1], plan)
    keys = ("band", "width", "channels", "threads", "group", "cap")
    return dict(zip(keys, plan)), int(smem)


def _check_map(shape, dtype, ndim, R, pooled_size, what):
    """Raises on what the kernels do not take (the checks hold on any
    device); returns ``(ph, pw)``."""
    if dtype != torch.float32 or ndim != 4:
        raise MXNetError("ROIPooling kernels: %s must be float32 4-d, got "
                         "%s %s" % (what, dtype, tuple(shape)))
    ph, pw = pooled_size
    if not (0 < ph <= MAX_POOL and 0 < pw <= MAX_POOL):
        raise MXNetError("ROIPooling kernels take pooled sizes in [1, %d], "
                         "got %s" % (MAX_POOL, tuple(pooled_size)))
    if 0 in tuple(shape) or R == 0:
        raise MXNetError("ROIPooling kernels: empty input %s, %d ROIs"
                         % (tuple(shape), R))
    return ph, pw


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


def _fn(lib, name, n_ptr, n_int, scale):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                       + [ctypes.c_float] * scale
                       + [ctypes.c_int] * n_int + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _cuda_only(data, what):
    if data.device.type != "cuda":
        raise MXNetError("%s takes CUDA tensors, got %s" % (what, data.device))


def fwd_parts(data, rois, pooled_size, spatial_scale, parts, outs=None,
              lib=None):
    """Launch ``parts`` of K8 (``FWD_COPY | FWD_BOUNDS | FWD_POOL``) on the
    data's card, on the current stream, uncounted, into ``outs = (out,
    bounds, xt)`` (made when None) and return them.  ``lib`` a build of
    ``csrc/roi_pooling.cu`` (the port's own when None)."""
    _check_rois(data, rois)
    R = rois.shape[0]
    ph, pw = _check_map(data.shape, data.dtype, data.ndim, R, pooled_size,
                        "data (B, C, H, W)")
    _cuda_only(data, "K8")
    B, C, H, W = data.shape
    data, rois = data.contiguous(), rois.contiguous()
    lib = _kernels.load("roi_pooling") if lib is None else lib
    if outs is None:
        dev = data.device
        outs = (torch.empty((R, C, ph, pw), dtype=torch.float32, device=dev),
                torch.empty(_bounds_ints(lib, R, ph, pw), dtype=torch.int32,
                            device=dev),
                torch.empty((B, H, W, C), dtype=torch.float32, device=dev))
    out, bounds, xt = outs
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = _fn(lib, "mxtt_roi_pool_fwd", 5, 1, 1)(
            data.data_ptr(), rois.data_ptr(), xt.data_ptr(),
            bounds.data_ptr(), out.data_ptr(), B, C, H, W, R, ph, pw,
            float(spatial_scale), int(parts), stream)
    if err != 0:
        raise MXNetError("ROI pooling forward kernel launch failed: CUDA "
                         "error %d" % err)
    return outs


def roi_pool_fwd_cuda(data, rois, pooled_size, spatial_scale):
    """Launch kernel K8 on the data's card, on the current stream.  Returns
    ``(out, bounds, xt)``: the maxima, an int32 bounds array and the
    channels-last map for K8b; raises on inputs the kernel does not
    take."""
    outs = fwd_parts(data, rois, pooled_size, spatial_scale,
                     FWD_COPY | FWD_BOUNDS | FWD_POOL)
    launches.count(roi_pool_fwd_cuda)
    return outs


def bwd_parts(xt, bounds, g, pooled_size, parts, dx=None, lib=None):
    """Launch ``parts`` of K8b (``BWD_LIST | BWD_STEPS | BWD_WRITE``) on
    the map's card, on the current stream, uncounted, into ``dx`` (made
    when None), and return it.  ``lib`` as :func:`fwd_parts`'s."""
    R = g.shape[0] if g.ndim == 4 else 0
    ph, pw = _check_map(xt.shape, xt.dtype, xt.ndim, R, pooled_size,
                        "xt (B, H, W, C)")
    _cuda_only(xt, "K8b")
    B, H, W, C = xt.shape
    lib = _kernels.load("roi_pooling") if lib is None else lib
    for name, t, dtype, shape in (
            ("xt", xt, torch.float32, (B, H, W, C)),
            ("g", g, torch.float32, (R, C, ph, pw)),
            ("bounds", bounds, torch.int32, (_bounds_ints(lib, R, ph, pw),))):
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != xt.device:
            raise MXNetError("K8b: %s must be %s %s on %s, got %s %s on %s"
                             % (name, dtype, shape, xt.device, t.dtype,
                                tuple(t.shape), t.device))
    xt, bounds, g = xt.contiguous(), bounds.contiguous(), g.contiguous()
    if dx is None:
        dx = torch.empty((B, C, H, W), dtype=torch.float32, device=xt.device)
    with torch.cuda.device(xt.device):
        stream = torch.cuda.current_stream(xt.device).cuda_stream
        err = _fn(lib, "mxtt_roi_pool_bwd", 4, 1, 0)(
            xt.data_ptr(), bounds.data_ptr(), g.data_ptr(), dx.data_ptr(),
            B, C, H, W, R, ph, pw, int(parts), stream)
    if err != 0:
        raise MXNetError("ROI pooling backward kernel launch failed: CUDA "
                         "error %d" % err)
    return dx


def roi_pool_bwd_cuda(xt, bounds, g, pooled_size):
    """Launch kernel K8b on the map's card, on the current stream, with
    K8's ``xt`` and ``bounds``.  Returns ``dx (B, C, H, W)``; raises on
    inputs the kernel does not take."""
    dx = bwd_parts(xt, bounds, g, pooled_size,
                   BWD_LIST | BWD_STEPS | BWD_WRITE)
    launches.count(roi_pool_bwd_cuda)
    return dx


#: launches of kernels K8 and K8b in this process (reset freely)
roi_pool_fwd_cuda.launches = 0
roi_pool_bwd_cuda.launches = 0


#: the kernel for CUDA tensors, the plain version for CPU tensors
_route = functools.partial(launches.route, what="ROI pooling")


class ROIPoolFn(torch.autograd.Function):
    """``(data, rois) -> out`` through K8, the data's gradient through K8b
    (their plain versions on the CPU); the ROIs get a zero gradient.  The
    context keeps K8's bounds and channels-last map, not the data."""

    @staticmethod
    def forward(ctx, data, rois, pooled_size, spatial_scale):
        fwd = _route(data, roi_pool_fwd_cuda, roi_pool_fwd_plain)
        out, ctx.bounds, ctx.xt = fwd(data, rois, pooled_size,
                                      spatial_scale)
        ctx.hyper = (pooled_size, rois.shape, rois.dtype, rois.device)
        return out

    @staticmethod
    def backward(ctx, g):
        pooled_size, *rois_like = ctx.hyper
        bwd = _route(ctx.xt, roi_pool_bwd_cuda, roi_pool_bwd_plain)
        dx = bwd(ctx.xt, ctx.bounds, g.contiguous(), pooled_size)
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
