"""Greedy non-maximum suppression: hand-written Hopper kernel K7 with its
plain PyTorch version, for ``_contrib_MultiBoxDetection``
(``ops/contrib.py``).

K7 replaces no Pallas kernel: the JAX package runs greedy NMS as plain
JAX, a ``lax.fori_loop`` over the boxes of an image
(``mxnet_tpu/ops/contrib.py:243`` ``_greedy_nms``).  As eager torch ops
that loop would launch ~10 kernels per box, ~70,000 a batch at SSD300's
7308 anchors.

* :func:`greedy_nms_plain` — the JAX loop transcribed, batched over
  images.  Taken for CPU tensors.
* :func:`greedy_nms_cuda` — the wrapper of K7 (``csrc/nms.cu``: a mask
  pass, a gather of the boxes into visit order and then 64-bit
  suppression words over (image, row chunk, column chunks) blocks, and a
  scan of one block an image; the source says what bounds it).  Taken
  for CUDA tensors: it launches the kernels or raises.  ``.launches``
  counts its calls (:mod:`.launches`), one a call of the kernels for the
  whole batch.  The workspace (:func:`workspace_bytes`) comes from
  torch's caching allocator; any box count whose workspace fits on the
  card is taken.
* :func:`launch_parts` — the mask pass or the scan alone, uncounted, for
  timing.
* :func:`greedy_nms` — the entry, routed by device.

The IoU is rounded in ``_iou_matrix``'s order in both versions (the
kernel without FMA contraction), so ``iou >= threshold`` decides alike.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels
from ..base import MXNetError
from . import launches

__all__ = ["iou_matrix", "greedy_nms", "greedy_nms_plain",
           "greedy_nms_cuda", "launch_parts", "workspace_bytes", "MASK",
           "SCAN"]

#: :func:`launch_parts`'s parts: the mask pass, the scan
MASK, SCAN = 1, 2


def iou_matrix(a, b):
    """``a (..., M, 4)``, ``b (..., N, 4)`` corner boxes -> ``(..., M, N)``
    IoU, in ``mxnet_tpu/ops/contrib.py:39-54``'s order."""
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def greedy_nms_plain(boxes, cls_id, order, nms_thresh, force):
    """Keep mask ``(B, A)`` bool of greedy NMS over ``boxes (B, A, 4)``
    visited in ``order (B, A)``: the loop of ``_greedy_nms``, each step
    one IoU row (its streaming regime; the matrix regime's rows hold the
    same values), batched over the images."""
    B, A = cls_id.shape
    order = order.long()
    rows = torch.arange(B, device=boxes.device)
    # the inverse permutation: the visit position of each box
    pos = torch.empty_like(order).scatter_(
        1, order, torch.arange(A, device=order.device).expand(B, A))
    keep = torch.ones((B, A), dtype=torch.bool, device=boxes.device)
    valid = cls_id >= 0
    for i in range(A):
        j = order[:, i]
        row = iou_matrix(boxes[rows, j][:, None, :], boxes)[:, 0]
        cj = cls_id[rows, j]
        alive = keep[rows, j] & (cj >= 0)
        sup = (row >= nms_thresh) & (pos > i) & valid
        if not force:
            sup = sup & (cls_id == cj[:, None])
        keep = keep & ~(alive[:, None] & sup)
    return keep


def _fn(lib):
    fn = lib.mxtt_nms
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_size_t]
                       + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(boxes, cls_id, order):
    """``(B, A)`` of K7's inputs; raises on what the kernel does not
    take (the checks hold on any device)."""
    if boxes.dtype != torch.float32 or boxes.ndim != 3 \
            or boxes.shape[2] != 4:
        raise MXNetError("K7: boxes must be float32 (B, A, 4), got %s %s"
                         % (boxes.dtype, tuple(boxes.shape)))
    B, A = boxes.shape[:2]
    if tuple(cls_id.shape) != (B, A) or tuple(order.shape) != (B, A):
        raise MXNetError("K7: cls_id and order must be (%d, %d), got %s "
                         "and %s" % (B, A, tuple(cls_id.shape),
                                     tuple(order.shape)))
    if B * A == 0:
        raise MXNetError("K7: no boxes")
    if cls_id.device != boxes.device or order.device != boxes.device:
        raise MXNetError("K7: inputs on more than one device")
    return B, A


def workspace_bytes(B, A):
    """Bytes of K7's workspace for ``B`` images of ``A`` boxes (``Work``
    in ``csrc/nms.cu``: the boxes in visit order, each image's triangle of
    mask words, the valid words); builds the kernels if needed."""
    fn = _kernels.load("nms").mxtt_nms_workspace_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_size_t
    return fn(B, A)


def launch_parts(boxes, cls_id, order, nms_thresh, force, parts=MASK | SCAN,
                 work=None):
    """Launches the kernels of K7 that ``parts`` names (:data:`MASK`, the
    mask pass; :data:`SCAN`, the scan over the mask a mask pass left in
    ``work``; both by default) on the boxes' card, on the current stream,
    and counts nothing: :func:`greedy_nms_cuda` is the entry.  Returns the
    keep flags ``(B, A)`` uint8 (written by the scan) and the workspace
    (an int64 tensor; pass it back with ``work`` to time one part alone).
    Raises on inputs the kernels do not take and on a workspace larger
    than the card."""
    B, A = _check_inputs(boxes, cls_id, order)
    if not nms_thresh > 0:
        # a pair that does not intersect is decided as below the
        # threshold without the division: exact only above an IoU of 0
        raise MXNetError("K7 takes an IoU threshold > 0, got %r"
                         % (nms_thresh,))
    if boxes.device.type != "cuda":
        raise MXNetError("K7 takes CUDA tensors, got %s" % boxes.device)
    boxes = boxes.contiguous()
    cls_id = cls_id.to(torch.float32).contiguous()
    order = order.to(torch.int32).contiguous()
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()
    need = workspace_bytes(B, A)
    if work is None:
        total = torch.cuda.get_device_properties(boxes.device).total_memory
        if need > total:
            raise MXNetError("K7 needs a workspace of %.2f GB for %d images "
                             "of %d boxes, more than the card's %.2f GB"
                             % (need / 1e9, B, A, total / 1e9))
        work = torch.empty(need // 8, dtype=torch.int64, device=boxes.device)
    elif work.device != boxes.device or work.numel() * 8 < need:
        raise MXNetError("K7: the workspace must hold %d bytes on %s"
                         % (need, boxes.device))
    keep = torch.empty((B, A), dtype=torch.uint8, device=boxes.device)
    lib = _kernels.load("nms")
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = _fn(lib)(boxes.data_ptr(), cls_id.data_ptr(), order.data_ptr(),
                       keep.data_ptr(), work.data_ptr(), work.numel() * 8,
                       B, A, float(nms_thresh), int(bool(force)), int(parts),
                       stream)
    if err != 0:
        raise MXNetError("NMS kernel launch failed: CUDA error %d" % err)
    return keep, work


def greedy_nms_cuda(boxes, cls_id, order, nms_thresh, force):
    """Launch kernel K7 on the boxes' card, on the current stream: the
    mask pass and the scan.  Returns the keep mask ``(B, A)`` bool;
    raises on inputs the kernel does not take."""
    keep, _work = launch_parts(boxes, cls_id, order, nms_thresh, force)
    launches.count(greedy_nms_cuda)
    return keep.bool()


#: launches of kernel K7 in this process (reset freely)
greedy_nms_cuda.launches = 0


def greedy_nms(boxes, cls_id, order, nms_thresh, force):
    """K7 for CUDA tensors, :func:`greedy_nms_plain` for CPU tensors."""
    fn = launches.route(boxes, greedy_nms_cuda, greedy_nms_plain,
                        "greedy NMS")
    return fn(boxes, cls_id, order, nms_thresh, force)
