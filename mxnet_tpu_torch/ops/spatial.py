"""Spatial and warping ops (counterpart of ``mxnet_tpu/ops/spatial.py``):
``ROIPooling``, ``BilinearSampler``, ``GridGenerator``,
``SpatialTransformer``, ``Correlation`` and ``Crop``.

ROIPooling runs hand kernels K8/K8b on the card (``ops/roi_pool_kernel.py``).
The others are torch compositions, as XLA lowers them in the JAX package:
the bilinear sampler transcribes ``_bilinear_sample``'s gather (corners
outside the map read 0; a corner's index is clamped before the gather and
its weight kept), the grids are the JAX function's arithmetic (its
``linspace`` formula, the affine map as three products summed, which no
TF32 setting can round), Correlation enumerates its static displacement
grid as rolled products summed over the patch, and Crop slices.  Their
gradients are autograd's of these compositions.
"""

from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .registry import REQUIRED, pbool, pfloat, pint, pstr, ptuple, register
from .roi_pool_kernel import roi_pool


def _meta(x):
    return x.device.type == "meta"


# ---------------------------------------------------------------------------
# ROIPooling: Fast R-CNN max pooling over regions; rois (R, 5) = [batch_idx,
# x1, y1, x2, y2] in image coordinates.
# ---------------------------------------------------------------------------
def _roi_pooling(attrs, inputs, aux, is_train):
    data, rois = inputs
    ph, pw = attrs["pooled_size"]
    if _meta(data) or _meta(rois):
        return [torch.empty((rois.shape[0], data.shape[1], ph, pw),
                            dtype=data.dtype, device="meta")]
    return [roi_pool(data, rois, (ph, pw), attrs["spatial_scale"])]


register("ROIPooling", _roi_pooling, arguments=("data", "rois"),
         params={"pooled_size": (ptuple, REQUIRED),
                 "spatial_scale": (pfloat, REQUIRED)},
         hint="roipooling")


# ---------------------------------------------------------------------------
# BilinearSampler: grid (B, 2, Ho, Wo) in [-1, 1], channel 0 = x, 1 = y.
# ---------------------------------------------------------------------------
def _bilinear_sample(img, gx, gy):
    """img (B, C, H, W); gx, gy (B, Ho, Wo) in [-1, 1] -> (B, C, Ho, Wo).
    Corners outside the map contribute 0."""
    B, C, H, W = img.shape
    x = (gx + 1.0) * (W - 1) / 2.0
    y = (gy + 1.0) * (H - 1) / 2.0
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    flat = img.reshape(B, C, H * W)

    def gather(yy, xx):
        inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        yc = yy.clamp(0, H - 1).to(torch.int64)
        xc = xx.clamp(0, W - 1).to(torch.int64)
        idx = (yc * W + xc).reshape(B, 1, -1).expand(B, C, -1)
        v = flat.gather(2, idx).reshape((B, C) + tuple(yy.shape[1:]))
        return torch.where(inb[:, None], v, torch.zeros((), dtype=img.dtype,
                                                         device=img.device))

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    w00 = ((1 - dy) * (1 - dx))[:, None]
    w01 = ((1 - dy) * dx)[:, None]
    w10 = (dy * (1 - dx))[:, None]
    w11 = (dy * dx)[:, None]
    return v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11


def _bilinear_sampler(attrs, inputs, aux, is_train):
    data, grid = inputs
    return [_bilinear_sample(data, grid[:, 0], grid[:, 1])]


register("BilinearSampler", _bilinear_sampler, arguments=("data", "grid"),
         params={}, hint="bilinearsampler")


# ---------------------------------------------------------------------------
# GridGenerator: 'affine' (6-parameter theta -> sampling grid) or 'warp'
# (optical flow in pixels -> grid).
# ---------------------------------------------------------------------------
def _linspace(n, dtype, device):
    """``jnp.linspace(-1.0, 1.0, n)``'s formula: start * (1 - s) + stop *
    s with s = i / (n - 1), the last point the stop itself."""
    if n == 1:
        return torch.full((1,), -1.0, dtype=dtype, device=device)
    div = n - 1
    s = torch.arange(div, dtype=dtype, device=device) / torch.tensor(
        float(div), dtype=dtype, device=device)
    out = -1.0 * (1 - s) + 1.0 * s
    return torch.cat([out, torch.ones((1,), dtype=dtype, device=device)])


def _identity_grid(h, w, dtype, device):
    """(gx, gy), each (h, w): normalized target coordinates in [-1, 1]."""
    gy, gx = torch.meshgrid(_linspace(h, dtype, device),
                            _linspace(w, dtype, device), indexing="ij")
    return gx, gy


def _affine_grid(theta, h, w):
    """theta (B, 6) -> grid (B, 2, h, w): theta (2, 3) times the target
    coordinates (x, y, 1), as three f32 products summed."""
    t = theta.reshape(theta.shape[0], 2, 3, 1, 1)
    gx, gy = _identity_grid(h, w, theta.dtype, theta.device)
    return t[:, :, 0] * gx + t[:, :, 1] * gy + t[:, :, 2]


def _target(attrs, op):
    h, w = attrs["target_shape"]
    if h <= 0 or w <= 0:
        raise MXNetError("%s: target_shape must be set%s (got %r)"
                         % (op, " for affine mode" if op == "GridGenerator"
                            else "", attrs["target_shape"]))
    return h, w


def _grid_generator(attrs, inputs, aux, is_train):
    data = inputs[0]
    tt = attrs["transform_type"]
    if tt == "affine":
        h, w = _target(attrs, "GridGenerator")
        return [_affine_grid(data, h, w)]
    if tt == "warp":
        B, _, H, W = data.shape
        gx, gy = _identity_grid(H, W, data.dtype, data.device)
        fx = data[:, 0] * 2.0 / max(W - 1, 1)
        fy = data[:, 1] * 2.0 / max(H - 1, 1)
        return [torch.stack([gx[None] + fx, gy[None] + fy], dim=1)]
    raise MXNetError("GridGenerator: bad transform_type %r" % tt)


register("GridGenerator", _grid_generator,
         params={"transform_type": (pstr, REQUIRED),
                 "target_shape": (ptuple, (0, 0))},
         hint="gridgenerator")


# ---------------------------------------------------------------------------
# SpatialTransformer: localization output -> affine grid -> bilinear
# sampling, in one op.
# ---------------------------------------------------------------------------
def _spatial_transformer(attrs, inputs, aux, is_train):
    data, loc = inputs
    if attrs["transform_type"] != "affine":
        raise MXNetError("SpatialTransformer: only 'affine' supported")
    if attrs["sampler_type"] != "bilinear":
        raise MXNetError("SpatialTransformer: only 'bilinear' supported")
    h, w = _target(attrs, "SpatialTransformer")
    grid = _affine_grid(loc, h, w)
    return [_bilinear_sample(data, grid[:, 0], grid[:, 1])]


register("SpatialTransformer", _spatial_transformer,
         arguments=("data", "loc"),
         params={"target_shape": (ptuple, (0, 0)),
                 "transform_type": (pstr, "affine"),
                 "sampler_type": (pstr, "bilinear")},
         hint="spatialtransformer")


# ---------------------------------------------------------------------------
# Correlation (FlowNet): each displacement of the static grid is a rolled
# product (or absolute difference) summed over the kernel patch and the
# channels.
# ---------------------------------------------------------------------------
def _box_sum(x, k):
    """Sum over each k x k patch, zero-padded by (k - 1) // 2: the JAX
    function's ``reduce_window`` add with stride 1."""
    if k == 1:
        return x
    kr = (k - 1) // 2
    p = torch.nn.functional.pad(x, (kr, kr, kr, kr))
    H, W = x.shape[2] + 2 * kr - k + 1, x.shape[3] + 2 * kr - k + 1
    out = None
    for u in range(k):
        for v in range(k):
            s = p[:, :, u:u + H, v:v + W]
            out = s if out is None else out + s
    return out


def _correlation(attrs, inputs, aux, is_train):
    d1, d2 = inputs
    k = attrs["kernel_size"]
    md = attrs["max_displacement"]
    s1, s2 = attrs["stride1"], attrs["stride2"]
    pad = attrs["pad_size"]
    C = d1.shape[1]
    pd1 = torch.nn.functional.pad(d1, (pad, pad, pad, pad))
    pd2 = torch.nn.functional.pad(d2, (pad, pad, pad, pad))
    Hp, Wp = pd1.shape[2], pd1.shape[3]
    border = md + (k - 1) // 2
    out_h = int(math.ceil((Hp - 2 * border) / float(s1)))
    out_w = int(math.ceil((Wp - 2 * border) / float(s1)))
    rows = border + torch.arange(out_h, device=d1.device) * s1
    cols = border + torch.arange(out_w, device=d1.device) * s1
    maps = []
    for dy in range(-md, md + 1, s2):
        for dx in range(-md, md + 1, s2):
            shifted = torch.roll(pd2, (-dy, -dx), dims=(2, 3))
            prod = pd1 * shifted if attrs["is_multiply"] \
                else torch.abs(pd1 - shifted)
            m = _box_sum(prod, k).sum(dim=1)  # (B, Hp, Wp)
            maps.append(m[:, rows[:, None], cols[None, :]])
    return [torch.stack(maps, dim=1) / float(k * k * C)]


register("Correlation", _correlation, arguments=("data1", "data2"),
         params={"kernel_size": (pint, 1), "max_displacement": (pint, 1),
                 "stride1": (pint, 1), "stride2": (pint, 1),
                 "pad_size": (pint, 0), "is_multiply": (pbool, True)},
         hint="correlation")


# ---------------------------------------------------------------------------
# Crop: the spatial dims cut to h_w (or to the second input's), at offset
# or centred.
# ---------------------------------------------------------------------------
def _crop(attrs, inputs, aux, is_train):
    data = inputs[0]
    if attrs["num_args"] == 2:
        ch, cw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        ch, cw = attrs["h_w"]
    if attrs["center_crop"]:
        oy = (data.shape[2] - ch) // 2
        ox = (data.shape[3] - cw) // 2
    else:
        oy, ox = attrs["offset"]
    return [data[:, :, oy:oy + ch, ox:ox + cw]]


register("Crop", _crop,
         arguments=lambda a: ["data", "crop_like"] if a["num_args"] == 2
         else ["data"],
         params={"num_args": (pint, 1), "offset": (ptuple, (0, 0)),
                 "h_w": (ptuple, (0, 0)), "center_crop": (pbool, False)},
         key_var_num_args="num_args", hint="crop_op")
