#!/usr/bin/env python3
"""Layouts of the resident BatchNorm kernels (K1 forward, K2 backward)
against each other, on one NVIDIA card.

    python3 chip_bn_costs.py

Builds ``mxnet_tpu_torch/csrc/batch_norm.cu`` as committed and variants
of it that each change one choice of the plan, holds each variant's K1
and K2 against the plain versions (``1e-4`` of each output's largest
magnitude, as ``chip_smoke.py`` does), then times them in turns on the
device with the L2 cold (``chip_smoke._cold_time_ms``: the calls rotate
over copies of the inputs, replayed from a CUDA graph) at ResNet-50 b128
BatchNorm inputs, printing each shape's plan beside its times:

* ``as built``: a 56x56 channel on 8 CTAs (K1) and on 16 CTAs holding x
  and g (K2), at most 200 KiB of shared memory a CTA;
* ``CTAs of 100 KiB``: every resident CTA holds at most 100 KiB, so two
  share an SM (K1 at 56x56 on 16 CTAs; K2 at 56x56 no longer fits 16 and
  takes the chunked path);
* ``K1 on 512 threads``, ``K2 on 256 threads``: the other thread count
  (as built K1 runs 256 threads a CTA, K2 512);
* ``K2 without its 7x7 bound``: K2's 4-byte-copy kernel (7x7 strips)
  without the launch bound of three CTAs an SM, so nvcc picks its
  registers freely.

Prints the card's name and power limit first.  Exits non-zero without a
card.
"""

import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(128, 256, 56, 56), (128, 64, 56, 56), (128, 512, 28, 28),
          (128, 1024, 14, 14), (128, 256, 14, 14), (128, 2048, 7, 7),
          (128, 512, 7, 7)]
ROUNDS = 2

#: (old, new) edits, each of which must match the source exactly once
VARIANTS = {
    "as built": [],
    "CTAs of 100 KiB": [("constexpr long long CTA_BYTES = 200 * 1024;",
                         "constexpr long long CTA_BYTES = 100 * 1024;")],
    "K1 on 512 threads": [("constexpr int RT_FWD = 256;",
                           "constexpr int RT_FWD = 512;")],
    "K2 on 256 threads": [("constexpr int RT_BWD = 512;",
                           "constexpr int RT_BWD = 256;")],
    "K2 without its 7x7 bound": [(
        "__launch_bounds__(RT_BWD, VEC == 1 ? 3 : 1)",
        "__launch_bounds__(RT_BWD)")],
}


def sources():
    """(variant, source text) for each variant of the committed source."""
    with open(os.path.join(ROOT, "mxnet_tpu_torch", "csrc",
                           "batch_norm.cu")) as f:
        src = f.read()
    out = []
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError("variant %r: %r matches %d times"
                                   % (name, old, text.count(old)))
            text = text.replace(old, new)
        out.append((name, text))
    return out


def registers(i):
    """Registers of each resident kernel in the i-th variant's build, from
    its ptxas report, as ``{"K1<4>": n, ...}`` (<4>: 16-byte copies)."""
    out, kernel = {}, None
    with open(os.path.join(ROOT, "build", "bn_costs", "v%d.log" % i)) as f:
        for line in f:
            m = re.search(r"Compiling entry function '\S*bn_(fwd|bwd)_"
                          r"residentILi(\d)", line)
            if m:
                kernel = "%s<%s>" % ("K1" if m.group(1) == "fwd" else "K2",
                                     m.group(2))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                out[kernel] = int(m.group(1))
                kernel = None
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_bn_costs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.ops import bn_kernel as bnk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("nvidia-smi: %s" % smi, flush=True)
    libs = _kernels.build_variants("bn_costs", sources())
    for i, name in enumerate(libs):
        print("registers %s: %s" % (name, ", ".join(
            "%s %d" % kv for kv in sorted(registers(i).items()))), flush=True)
    dev = torch.device("cuda", 0)
    eps = 2e-5
    for shape in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        n, c = shape[0], shape[1]
        s = shape[2] * shape[3]
        x = torch.randn(shape, generator=gen, device=dev)
        g = torch.randn(shape, generator=gen, device=dev)
        gamma = torch.rand(c, generator=gen, device=dev) + 0.5
        beta = torch.randn(c, generator=gen, device=dev)
        want_fwd = bnk.bn_fwd_plain(x, gamma, beta, eps, False, True)
        mean, var = want_fwd[1], want_fwd[2]
        want_bwd = bnk.bn_bwd_plain(x, g, mean, var, gamma, beta, eps,
                                    False, True)
        copies = [(x, g)] + [(x.clone(), g.clone()) for _ in range(
            -(-int(cs.COLD_BYTES) // x.nbytes) - 1)]
        iters = max(2 * len(copies), 30)

        def k1(xc):
            return bnk.bn_fwd_cuda(xc, gamma, beta, eps, False, True)

        def k2(xc, gc):
            return bnk.bn_bwd_cuda(xc, gc, mean, var, gamma, beta, eps,
                                   False, True)

        plans, times = {}, {}
        names = list(libs)
        for rnd in range(ROUNDS):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                with cs.bn_library(bnk, libs[name]):
                    if rnd == 0:
                        got = k1(x)
                        errs = [cs._scaled_err(a, b)[1]
                                for a, b in zip(got, want_fwd)]
                        got = k2(x, g)
                        errs += [cs._scaled_err(a, b)[1]
                                 for a, b in zip(got, want_bwd)]
                        if max(errs) > 1e-4:
                            raise RuntimeError("%r disagrees with the plain "
                                               "versions at %s: %s"
                                               % (name, shape, errs))
                        plans[name] = [cs._plan_text(bnk.bn_plan(
                            n, c, s, bwd, dev)) for bwd in (0, 1)]
                    for kind, fn, args in (
                            ("K1", k1, [(xc,) for xc, _ in copies]),
                            ("K2", k2, copies)):
                        times.setdefault((name, kind), []).append(
                            cs._cold_time_ms(fn, args, iters))
        for name in names:
            print("layout %s at %s (L2 cold, %d copies): K1 %s ms [%s]; K2 "
                  "%s ms [%s]" % (
                      name, shape, len(copies),
                      " / ".join("%.4f" % t for t in times[(name, "K1")]),
                      plans[name][0],
                      " / ".join("%.4f" % t for t in times[(name, "K2")]),
                      plans[name][1]), flush=True)
        del x, g, copies
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
