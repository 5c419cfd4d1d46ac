#!/usr/bin/env python3
"""Where ROI pooling (K8, K8b) spends its time on one NVIDIA card, against
the kernels it replaced.

    python3 chip_k8_costs.py [--parent PATH] [--seed N] [--synthetic]

Inputs:

* ``19b``: phase 19b's own conv5_3 map, ROIs and pool5 gradient
  (``chip_smoke.py``: the end-to-end fits, classic and captured, whose
  lines print as the smoke prints them, then ``e2e_roi_tensors``): R =
  2000, C = 512, a 37x62 map, 7x7 bins;
* ``19c``: phase 19c's conv5_3 map and 300 ROIs (``detection_test_phase``
  on 19b's weights, then ``rcnn_internals``), the forward only;

or, with ``--synthetic``, maps and ROIs of the same sizes made from
``--seed`` (ROIs uniform over the 600x1000 image, a ReLU map), without the
fits.

Kernels: ``mxnet_tpu_torch/csrc/roi_pooling.cu`` as committed (K8: a
channels-last copy, a bounds kernel and a block per (ROI, 32 channels);
K8b: a block per (band of rows, 32 channels) over the ROIs meeting its
band), variants of it made by text edits (``VARIANTS``: K8's warps a
ROI and its unrolling; K8b's loads in flight, threads a block, pixels a
thread, which set its band height, and ROIs and bins a step; each with
K8b's registers and spills) and, when ``--parent`` names one (default
``build/roi_parent/roi_pooling.cu``, from ``git show
542c265:mxnet_tpu_torch/csrc/roi_pooling.cu``), the older source's K8 (a
thread a bin, maxima and tie counts) and K8b (a thread a pixel walking
every ROI, reading the maxima and the counts).  Checks: the new K8's
maxima equal the old K8's bit for bit, the new K8b's dx equals the old
K8b's bit for bit, and each variant equals the committed kernel bit for
bit.  Times: CUDA events over 10 calls, old, new and variants in turns
and then in reverse; the parts of each new kernel apart (K8: the copy,
the bounds, the pooling; K8b: the ROI lists alone, the lists and the
steps without the write, the whole, and the steps without the bins'
maxima, the pixels' sums or both: ``ABLATIONS``); then, from 19b's
weights, 19c's detection forward with the committed K8 and with the
older K8 in its place (host clock, as phase 19c reads it).  Prints the
average number of ROIs covering a pixel of each map, the bound and the
bytes each design moves.

Prints the card's name and power limit first.  Exits non-zero without a
card.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "roi_pooling.cu")

#: (old, new) edits of the committed source, each of which must match it
#: exactly once: K8's warps a ROI and the unrolling of its loop over a bin
#: row; K8b's loads in flight a lane, its blocks an SM (one lifts its
#: 64-register cap), its threads a block and tile pixels a thread (which
#: set its band height: one, four, three and five rows of a 62-column
#: map) and its ROIs and bins a step.  Each variant's dx is
#: held to the committed kernel's bit for bit.
_ONE_BLOCK = ("__launch_bounds__(BWD_THREADS, 2)",
              "__launch_bounds__(BWD_THREADS)")
VARIANTS = {
    "K8 4 warps": [("constexpr int FWD_WARPS = 8;",
                    "constexpr int FWD_WARPS = 4;")],
    "K8 unroll 4": [("#pragma unroll 8  // K8: a bin row's",
                     "#pragma unroll 4  // K8: a bin row's")],
    "K8b 4 loads": [("constexpr int SCAN = 8;", "constexpr int SCAN = 4;")],
    "K8b one block an SM": [_ONE_BLOCK],
    "K8b one block an SM, 4 loads": [
        _ONE_BLOCK, ("constexpr int SCAN = 8;", "constexpr int SCAN = 4;")],
    "K8b 256 threads": [("constexpr int BWD_WARPS = 16;",
                         "constexpr int BWD_WARPS = 8;")],
    "K8b 1024 threads": [_ONE_BLOCK, ("constexpr int BWD_WARPS = 16;",
                                      "constexpr int BWD_WARPS = 32;")],
    "K8b 12 pixels a thread": [("constexpr int PMAX = 8;",
                                "constexpr int PMAX = 12;")],
    "K8b 20 pixels a thread": [("constexpr int PMAX = 8;",
                                "constexpr int PMAX = 20;")],
    "K8b steps of 16 ROIs / 256 bins": [
        ("constexpr int GROUP = 8;", "constexpr int GROUP = 16;"),
        ("constexpr int CAP = 128;", "constexpr int CAP = 256;")],
}

#: K8b with a part of each step left out, timed to split the step's cost
#: (their dx is not K8b's, so it is not checked): the bins' maxima and
#: shares, the pixels' sums, or both
_NO_BINS = ("      for (int k = warp; k < nbins; k += nw) {",
            "      for (int k = nbins; k < nbins; k += nw) {")
_NO_SUMS = ("      for (int q = 0; q < ni; ++q) {",
            "      for (int q = 0; q < 0; ++q) {")
ABLATIONS = {
    "K8b steps without the bins' maxima": [_NO_BINS],
    "K8b steps without the pixels' sums": [_NO_SUMS],
    "K8b steps without either": [_NO_BINS, _NO_SUMS],
}


def variant_sources():
    """[(name, source text)] of ``VARIANTS`` and ``ABLATIONS``; raises
    when an edit does not match the committed source exactly once."""
    with open(SOURCE) as f:
        text = f.read()
    out = []
    for name, edits in list(VARIANTS.items()) + list(ABLATIONS.items()):
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError("variant %r: edit does not match once"
                                   % name)
            src = src.replace(old, new)
        out.append((name, src))
    return out


def variant_libraries():
    """{name: library} of :func:`variant_sources`, built into
    ``build/roi_variants/``; prints K8b's registers and spills in each."""
    from mxnet_tpu_torch import _kernels

    sources = variant_sources()
    libs = _kernels.build_variants("roi_variants", sources)
    for i, (name, _src) in enumerate(sources):
        with open(os.path.join(ROOT, "build", "roi_variants",
                               "v%d.log" % i)) as f:
            print("%s: %s" % (name, ptxas_report(f.read(), "bwd")),
                  flush=True)
    return libs


def ptxas_report(log, kernel):
    """ptxas's register and spill lines for the kernel whose mangled name
    holds ``roi_pool_<kernel>_kernel``."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "roi_pool_%s_kernel" % kernel in line
        elif keep and ("registers" in line or "spill" in line):
            lines.append(line.split("info    :")[-1].strip())
    return "; ".join(lines)


def parent_library(path):
    """The older source's K8 and K8b built into ``build/roi_parent/``;
    None when there is no such copy."""
    if not path or not os.path.exists(path):
        print("parent K8/K8b: no source at %s, not measured" % path,
              flush=True)
        return None
    from mxnet_tpu_torch import _kernels

    with open(path) as f:
        text = f.read()
    lib = _kernels.build_variants("roi_parent", [("parent", text)])["parent"]
    lib.mxtt_roi_pool_fwd.argtypes = ([ctypes.c_void_p] * 5
                                      + [ctypes.c_int] * 7
                                      + [ctypes.c_float, ctypes.c_void_p])
    lib.mxtt_roi_pool_fwd.restype = ctypes.c_int
    lib.mxtt_roi_pool_bwd.argtypes = ([ctypes.c_void_p] * 6
                                      + [ctypes.c_int] * 7
                                      + [ctypes.c_void_p])
    lib.mxtt_roi_pool_bwd.restype = ctypes.c_int
    lib.mxtt_roi_pool_bounds_bytes.argtypes = [ctypes.c_int] * 3
    lib.mxtt_roi_pool_bounds_bytes.restype = ctypes.c_size_t
    return lib


def parent_fwd(lib, x, rois, pooled, scale):
    """The older K8: (out, count, bounds)."""
    B, C, H, W = x.shape
    R, (ph, pw) = rois.shape[0], pooled
    out = torch.empty((R, C, ph, pw), dtype=torch.float32, device=x.device)
    count = torch.empty((R, C, ph, pw), dtype=torch.int32, device=x.device)
    bounds = torch.empty(lib.mxtt_roi_pool_bounds_bytes(R, ph, pw) // 4,
                         dtype=torch.int32, device=x.device)
    err = lib.mxtt_roi_pool_fwd(
        x.data_ptr(), rois.data_ptr(), out.data_ptr(), count.data_ptr(),
        bounds.data_ptr(), B, C, H, W, R, ph, pw, scale,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("parent K8: CUDA error %d" % err)
    return out, count, bounds


def parent_bwd(lib, x, bounds, out, count, g, pooled):
    """The older K8b: dx."""
    B, C, H, W = x.shape
    R, (ph, pw) = g.shape[0], pooled
    dx = torch.empty_like(x)
    err = lib.mxtt_roi_pool_bwd(
        x.data_ptr(), bounds.data_ptr(), out.data_ptr(), count.data_ptr(),
        g.data_ptr(), dx.data_ptr(), B, C, H, W, R, ph, pw,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("parent K8b: CUDA error %d" % err)
    return dx


def bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def synthetic(seed, r, c=512, hw=(37, 62), image=(600, 1000)):
    """A ReLU map with a block of zeros, ``r`` ROIs uniform over the image
    and a gradient, on the card."""
    rs = np.random.RandomState(seed)
    x = np.maximum(rs.normal(0, 1, (1, c) + hw), 0).astype(np.float32)
    x[:, :, 5:15, 10:30] = 0.0
    xy = rs.uniform(0, 1, (r, 4))
    rois = np.zeros((r, 5), np.float32)
    xs = np.sort(xy[:, :2] * (image[1] - 1), 1)
    ys = np.sort(xy[:, 2:] * (image[0] - 1), 1)
    rois[:, 1], rois[:, 3], rois[:, 2], rois[:, 4] = xs[:, 0], xs[:, 1], \
        ys[:, 0], ys[:, 1]
    g = rs.normal(0, 1, (r, c, 7, 7)).astype(np.float32)
    dev = torch.device("cuda", 0)
    return [torch.from_numpy(a).to(dev) for a in (x, rois, g)]


def phase19_tensors(cs, mx, seed, smi):
    """(19b's map, ROIs, gradient), (19c's map, ROIs), (19c's module, its
    batch)."""
    from mxnet_tpu_torch.models import rcnn
    from mxnet_tpu_torch.ops import nms_kernel
    from mxnet_tpu_torch.ops import roi_pool_kernel as rk

    mod, batches, _counts, _times = cs.e2e_fit_phase(mx, rcnn, nms_kernel,
                                                     rk, seed, smi)
    x, rois, g = cs.e2e_roi_tensors(rk, mod, batches[0], mx)
    tmod, tbatch, _c, _ms = cs.detection_test_phase(mx, rcnn, nms_kernel,
                                                    rk, mod, seed, smi)
    x3, r3 = cs.rcnn_internals(mx, tmod, ["relu5_3_output", "rois_output"],
                               tbatch)
    return (x.contiguous(), rois.contiguous(), g.contiguous()), \
        (x3.contiguous(), r3.contiguous()), (tmod, tbatch)


def coverage(rk, cs, x, rois):
    """The average number of ROIs covering a pixel of the map."""
    B, _C, H, W = x.shape
    _b, hs, he, ws, we = rk.roi_bounds(rois, B, H, W, cs.ROI_POOLED,
                                       cs.ROI_SCALE)
    area = (he[:, -1] - hs[:, 0]).clamp(min=0) \
        * (we[:, -1] - ws[:, 0]).clamp(min=0)
    return float(area.sum()) / (B * H * W)


def in_turns(cs, fns):
    """{name: [ms, ms]}: each of ``fns`` timed in turns and then in
    reverse, 10 calls each."""
    names = list(fns)
    times = {n: [] for n in names}
    for name in names + names[::-1]:
        times[name].append(cs._time_ms(fns[name], 10))
    return times


def show(times):
    for name, ts in times.items():
        print("  %-50s %s ms" % (name, " / ".join("%.4f" % t for t in ts)),
              flush=True)


def forward_costs(cs, rk, parent, variants, label, x, rois):
    P, S = cs.ROI_POOLED, cs.ROI_SCALE
    with torch.no_grad():
        out, bounds, xt = rk.roi_pool_fwd_cuda(x, rois, P, S)
        torch.cuda.synchronize()
        fns = {"new K8": lambda: rk.fwd_parts(x, rois, P, S, 7)}
        for name, lib in variants.items():
            if name.startswith("K8b "):
                continue  # K8b's own and the ablations
            got = rk.fwd_parts(x, rois, P, S, 7, lib=lib)[0]
            torch.cuda.synchronize()
            if not bits_equal(got, out):
                raise RuntimeError("K8 variant %s on %s differs" % (name,
                                                                    label))
            fns["new K8, " + name] = (lambda lib=lib: rk.fwd_parts(
                x, rois, P, S, 7, lib=lib))
        if parent is not None:
            old, _count, _b = parent_fwd(parent, x, rois, P, S)
            torch.cuda.synchronize()
            if not bits_equal(out, old):
                raise RuntimeError("K8 on %s: %d maxima differ from the "
                                   "older K8's" % (label,
                                                   int((out != old).sum())))
            print("K8 on %s: the maxima equal the older K8's bit for bit"
                  % label, flush=True)
            fns["older K8"] = lambda: parent_fwd(parent, x, rois, P, S)
        bound = cs.roi_bound_ms(rk, x, rois, False)
        print("K8 on %s: map %s, %d ROIs, %.1f ROIs cover a pixel; bound "
              "%.4f ms (%s); the new design's bytes %.4f ms"
              % (label, tuple(x.shape), rois.shape[0],
                 coverage(rk, cs, x, rois), bound[0], bound[1],
                 cs.roi_bytes(x, rois, False, design=True)
                 / cs.PEAK_BYTES * 1e3), flush=True)
        show(in_turns(cs, fns))
        outs = (out, bounds, xt)
        parts = {"copy": rk.FWD_COPY, "bounds": rk.FWD_BOUNDS,
                 "pooling": rk.FWD_POOL}
        show(in_turns(cs, {"new K8 " + k: (lambda p=p: rk.fwd_parts(
            x, rois, P, S, p, outs)) for k, p in parts.items()}))
    return outs


def backward_costs(cs, rk, parent, variants, label, x, rois, g, fwd):
    P, S = cs.ROI_POOLED, cs.ROI_SCALE
    out, bounds, xt = fwd
    B, C, H, W = x.shape
    with torch.no_grad():
        dx = rk.roi_pool_bwd_cuda(xt, bounds, g, P)
        again = rk.roi_pool_bwd_cuda(xt, bounds, g, P)
        torch.cuda.synchronize()
        if not bits_equal(dx, again):
            raise RuntimeError("K8b on %s: two launches differ" % label)
        plan, smem = rk.kernel_bwd_plan(H, W, P)
        if plan != rk.roi_bwd_plan(H, W):
            raise RuntimeError("K8b's tiling %s is not roi_bwd_plan's %s"
                               % (plan, rk.roi_bwd_plan(H, W)))
        fns = {"new K8b": lambda: rk.bwd_parts(xt, bounds, g, P, 7)}
        for name, lib in variants.items():
            if not name.startswith("K8b ") or name in ABLATIONS:
                continue  # K8's own, or not K8b's function
            got = rk.bwd_parts(xt, bounds, g, P, 7, lib=lib)
            torch.cuda.synchronize()
            if not bits_equal(got, dx):
                raise RuntimeError("K8b variant %s on %s differs" % (name,
                                                                     label))
            vp, vsmem = rk.kernel_bwd_plan(H, W, P, lib=lib)
            key = "new K8b, %s (band %d, %d B shared)" % (name, vp["band"],
                                                           vsmem)
            fns[key] = (lambda lib=lib: rk.bwd_parts(xt, bounds, g, P, 7,
                                                     lib=lib))
        if parent is not None:
            pout, pcount, pbounds = parent_fwd(parent, x, rois, P, S)
            old = parent_bwd(parent, x, pbounds, pout, pcount, g, P)
            torch.cuda.synchronize()
            if not bits_equal(dx, old):
                raise RuntimeError(
                    "K8b on %s: %d of %d values differ from the older "
                    "K8b's (largest by %.3g)" % (
                        label, int((dx != old).sum()), dx.numel(),
                        float((dx - old).abs().max())))
            print("K8b on %s: dx equals the older K8b's bit for bit" % label,
                  flush=True)
            fns["older K8b"] = lambda: parent_bwd(parent, x, pbounds, pout,
                                                  pcount, g, P)
        reads = cs.roi_g_reads(rk, x, rois, plan)
        bound = cs.roi_bound_ms(rk, x, rois, True)
        print("K8b on %s: tiles %s, %d B shared a block; %.4f reads of each "
              "bin's gradient; bound %.4f ms (%s); the new design's bytes "
              "%.4f ms"
              % (label, plan, smem, reads / (rois.shape[0] * P[0] * P[1]),
                 bound[0], bound[1],
                 cs.roi_bytes(x, rois, True, design=reads)
                 / cs.PEAK_BYTES * 1e3), flush=True)
        print("K8b variants on %s (each dx bit for bit the committed "
              "kernel's):" % label, flush=True)
        show(in_turns(cs, fns))
        work = torch.empty_like(dx)
        fns = {"new K8b " + k: (lambda p=p: rk.bwd_parts(
            xt, bounds, g, P, p, dx=work)) for k, p in (
                ("lists", rk.BWD_LIST),
                ("lists and steps", rk.BWD_LIST | rk.BWD_STEPS),
                ("whole", rk.BWD_LIST | rk.BWD_STEPS | rk.BWD_WRITE))}
        for name in ABLATIONS:
            fns[name + ", no write"] = (
                lambda lib=variants[name]: rk.bwd_parts(
                    xt, bounds, g, P, rk.BWD_LIST | rk.BWD_STEPS, dx=work,
                    lib=lib))
        print("K8b's parts on %s:" % label, flush=True)
        show(in_turns(cs, fns))


def detection_costs(cs, mx, rk, parent, tmod, tbatch, passes=10):
    """19c's detection forward (``Module.forward(is_train=False)`` at b1,
    host clock to the outputs' host copy, as phase 19c reads it) with the
    committed K8 and with the older K8 in its place, ``passes`` warm
    passes each, in turns and then in reverse."""
    if parent is None:
        return
    db = mx.io.DataBatch(data=[mx.nd.array(tbatch[k])
                               for k in ("data", "im_info")], label=[])
    new = rk.roi_pool_fwd_cuda

    def older(data, rois, pooled, scale):
        out, _count, bounds = parent_fwd(parent, data.contiguous(),
                                         rois.contiguous(), pooled, scale)
        return out, bounds, None

    def passes_ms(fwd):
        rk.roi_pool_fwd_cuda = fwd
        try:
            ms = []
            for _ in range(passes + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tmod.forward(db, is_train=False)
                _outs = [o.asnumpy() for o in tmod.get_outputs()]
                ms.append((time.perf_counter() - t0) * 1e3)
            return ms[1:]
        finally:
            rk.roi_pool_fwd_cuda = new

    times = {"committed K8": [], "older K8": []}
    for name in ["committed K8", "older K8", "older K8", "committed K8"]:
        times[name] += passes_ms(new if name == "committed K8" else older)
    for name, ms in times.items():
        print("19c detection forward with the %s: median %.3f ms, min %.3f, "
              "max %.3f over %d warm passes (host clock to the outputs' "
              "host copy)" % (name, float(np.median(ms)), min(ms), max(ms),
                              len(ms)), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=os.path.join(
        ROOT, "build", "roi_parent", "roi_pooling.cu"))
    ap.add_argument("--synthetic", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_k8_costs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.ops import roi_pool_kernel as rk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("device: %s" % smi, flush=True)
    _kernels.build_all(["roi_pooling"])
    print("new K8/K8b: %s" % "; ".join(
        line.strip() for line in _kernels.build_log("roi_pooling")
        .splitlines() if "registers" in line or "spill" in line), flush=True)
    parent = parent_library(args.parent)
    variants = variant_libraries()
    detection = None
    if args.synthetic:
        train = synthetic(args.seed + 1, 2000)
        test = synthetic(args.seed + 2, 300)[:2]
    else:
        train, test, detection = phase19_tensors(cs, mx, args.seed, smi)
    fwd = forward_costs(cs, rk, parent, variants, "19b", *train[:2])
    backward_costs(cs, rk, parent, variants, "19b", *train, fwd)
    forward_costs(cs, rk, parent, variants, "19c", *test)
    if detection is not None:
        detection_costs(cs, mx, rk, parent, *detection)
    print("nvidia-smi: %s" % smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
