#!/usr/bin/env python3
"""Where greedy NMS (K7) spends its time on one NVIDIA card, and what its
variants cost.

    python3 chip_k7_costs.py [--parent PATH] [--seed N]

Inputs, all made on the card from ``--seed``:

* ``ssd300``: phase 18b's (``chip_smoke.py``): phase 18a's SSD300 fits
  (its lines printed as the smoke prints them), then the deploy graph's
  boxes, class ids and visit order for phase 18b's b32 batch (A = 7308,
  ``force``, IoU 0.5);
* ``proposal6000``, ``proposal12000``: rcnn's ``_contrib_Proposal`` sizes
  (B=1, ``force``, IoU 0.7, visit order ``arange``) over random boxes;
* ``dense``: random boxes at SSD300's b32 shape, 21 classes, a tenth
  invalid, per class, IoU 0.45 (far more overlap than SSD's anchors).

Kernels: ``mxnet_tpu_torch/csrc/nms.cu`` as committed; variants of it made
by text edits, each one change:

- ``tile 4``: the scan resolves 4 chunks a step (8 as committed);
- ``group 1``, ``group 4``: a mask block tests 1 or 4 column chunks (2
  as committed);
- ``32 blocks``: the mask kernel asks for 32 resident blocks an SM (at
  most 32 registers a thread);
- ``division``: the mask pass divides for every pair of equal classes
  (no fused multiply-add sign test);

and, when ``--parent`` names one (default ``build/nms_parent/nms.cu``),
an older copy of the source with one block an image (``mxtt_nms(boxes,
cls, order, keep, B, A, thresh, force, stream)``).  Every kernel's keep
mask is held against the plain version's, bit for bit.  Times are CUDA
events over 10 calls, the kernels in turns and then in reverse; the
committed source and its variants also time the mask pass (gather and
mask) and the scan apart, over one workspace.

Prints the card's name and power limit first.  Exits non-zero without a
card.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "nms.cu")

#: (old, new) edits, each of which must match the source exactly once
VARIANTS = {
    "as built": [],
    "tile 4": [("constexpr int TILE = 8;", "constexpr int TILE = 4;")],
    "group 1": [("constexpr int GROUP = 2;", "constexpr int GROUP = 1;")],
    "group 4": [("constexpr int GROUP = 2;", "constexpr int GROUP = 4;")],
    "32 blocks": [("__global__ void __launch_bounds__(CHUNK)\n"
                   "    nms_mask_kernel(",
                   "__global__ void __launch_bounds__(CHUNK, 32)\n"
                   "    nms_mask_kernel(")],
    "division": [("        if (same && above > 0.f) bits |= 1ull << j;\n"
                  "        if (same && !(above > 0.f) && !(below < 0.f)) "
                  "unsure |= 1ull << j;\n",
                  "        (void)above;\n        (void)below;\n"
                  "        if (same && iou_rn(a, bj) >= thresh) "
                  "bits |= 1ull << j;\n")],
}


def variant_sources():
    with open(SOURCE) as f:
        text = f.read()
    out = []
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError("variant %r: edit does not match once"
                                   % name)
            src = src.replace(old, new)
        out.append((name, src))
    return out


def bind(lib):
    lib.mxtt_nms.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_size_t]
                             + [ctypes.c_int] * 2
                             + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p])
    lib.mxtt_nms.restype = ctypes.c_int
    return lib


def run(nms, lib, case, parts=3, work=None):
    """One call of ``lib``'s K7 on ``case``; (keep bool, workspace)."""
    boxes, cid, order, thresh, force = case
    b, a = cid.shape
    if work is None:
        work = torch.empty(nms.workspace_bytes(b, a) // 8, dtype=torch.int64,
                           device=boxes.device)
    keep = torch.empty((b, a), dtype=torch.uint8, device=boxes.device)
    err = lib.mxtt_nms(boxes.data_ptr(), cid.data_ptr(), order.data_ptr(),
                       keep.data_ptr(), work.data_ptr(), work.numel() * 8, b,
                       a, thresh, int(force), parts,
                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("K7 variant: CUDA error %d" % err)
    return keep.bool(), work


def random_case(b, a, seed, classes, invalid, thresh, force, arange=False):
    rs = np.random.RandomState(seed)
    xy = rs.rand(b, a, 2) * 0.8
    wh = rs.rand(b, a, 2) * 0.3 + 0.02
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    cls = rs.randint(0, classes, (b, a)).astype(np.float32)
    cls[rs.rand(b, a) < invalid] = -1.0
    score = rs.rand(b, a).astype(np.float32)
    score[cls < 0] = -np.inf
    order = np.argsort(-score, axis=1, kind="stable").astype(np.int32)
    if arange:
        order = np.tile(np.arange(a, dtype=np.int32), (b, 1))
    dev = torch.device("cuda", 0)
    return (torch.from_numpy(boxes).to(dev), torch.from_numpy(cls).to(dev),
            torch.from_numpy(order).to(dev), thresh, force)


def parent_library(path):
    """K7 as an older copy of ``csrc/nms.cu`` at ``path`` had it (one
    block an image), built into ``build/nms_parent/``; None when there is
    no such copy."""
    if not path or not os.path.exists(path):
        print("parent K7: no source at %s, not measured" % path, flush=True)
        return None
    from mxnet_tpu_torch import _kernels

    with open(path) as f:
        text = f.read()
    lib = _kernels.build_variants("nms_parent", [("parent", text)])["parent"]
    lib.mxtt_nms.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                             + [ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p])
    lib.mxtt_nms.restype = ctypes.c_int
    return lib


def run_parent(lib, case):
    """The parent K7's keep mask (B, A) bool on the current stream."""
    boxes, cid, order, thresh, force = case
    b, a = cid.shape
    keep = torch.empty((b, a), dtype=torch.uint8, device=boxes.device)
    err = lib.mxtt_nms(boxes.data_ptr(), cid.data_ptr(), order.data_ptr(),
                       keep.data_ptr(), b, a, thresh, int(force),
                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("parent K7: CUDA error %d" % err)
    return keep.bool()


def ssd_case(cs, mx, seed, smi):
    """Phase 18b's K7 inputs: phase 18a's training (``chip_smoke.py``,
    which prints its own lines), then the deploy graph on phase 18b's
    batch."""
    from mxnet_tpu_torch.models import ssd_vgg16 as ssd
    from mxnet_tpu_torch.ops import bn_kernel, contrib, nms_kernel

    mod = cs.ssd_training_phase(mx, bn_kernel, ssd, nms_kernel, seed, smi)
    arg, aux = mod.get_params()
    x, _labels = ssd.synth_detection_set(cs.SSD_BATCH, cs.SSD_IMAGE,
                                         cs.SSD_CLASSES, seed=99 + seed)
    deploy = ssd.get_symbol(num_classes=cs.SSD_CLASSES)
    _p, _l, _a, cid, boxes, order = cs.ssd_k7_inputs(mx, contrib, deploy,
                                                     arg, aux, x)
    return (boxes.contiguous(), cid.contiguous(),
            order.to(torch.int32).contiguous(), cs.SSD_NMS, cs.SSD_FORCE)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=os.path.join(
        ROOT, "build", "nms_parent", "nms.cu"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_k7_costs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.ops import nms_kernel as nms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("device: %s" % smi, flush=True)
    libs = {k: bind(v) for k, v in _kernels.build_variants(
        "nms_variants", variant_sources()).items()}
    parent = parent_library(args.parent)
    for i, (name, _src) in enumerate(variant_sources()):
        log = os.path.join(ROOT, "build", "nms_variants", "v%d.log" % i)
        with open(log) as f:
            regs = [line.strip() for line in f if "registers" in line]
        print("%s: %s" % (name, "; ".join(regs)), flush=True)

    cases = {"ssd300": ssd_case(cs, mx, args.seed, smi),
             "proposal6000": random_case(1, 6000, 1, 1, 0.0, 0.7, True,
                                         arange=True),
             "proposal12000": random_case(1, 12000, 2, 1, 0.0, 0.7, True,
                                          arange=True),
             "dense": random_case(32, 7308, 3, 21, 0.1, 0.45, False)}
    for label, case in cases.items():
        boxes, cid, order, thresh, force = case
        b, a = cid.shape
        with torch.no_grad():
            want = nms.greedy_nms_plain(boxes, cid, order, thresh, force)
        valid = (cid >= 0).sum(1).cpu().numpy()
        print("%s: B=%d A=%d force=%s IoU %.2f; valid boxes an image %d-%d; "
              "the plain loop keeps %d valid; workspace %.1f MB"
              % (label, b, a, force, thresh, valid.min(), valid.max(),
                 int((want & (cid >= 0)).sum()),
                 nms.workspace_bytes(b, a) / 1e6), flush=True)
        fns = {name: (lambda lib=lib: run(nms, lib, case)[0])
               for name, lib in libs.items()}
        if parent is not None:
            fns["parent"] = lambda: run_parent(parent, case)
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError("%s on %s: %d of %d flags differ from the "
                                   "plain version" % (
                                       name, label, int((got != want).sum()),
                                       got.numel()))
        order_names = list(fns)
        times = {n: [] for n in order_names}
        for name in order_names + order_names[::-1]:
            times[name].append(cs._time_ms(fns[name], 10))
        for name in order_names:
            line = "  %-9s %s ms" % (name, " / ".join(
                "%.4f" % t for t in times[name]))
            if name in libs:
                _keep, work = run(nms, libs[name], case)
                parts = [cs._time_ms(
                    lambda p=p: run(nms, libs[name], case, p, work), 10)
                    for p in (1, 2)]
                line += " (mask pass %.4f, scan %.4f)" % tuple(parts)
            print(line, flush=True)
    print("nvidia-smi: %s" % smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
