#!/usr/bin/env python3
"""Where the flash-attention backward (K3b) spends its time, on one NVIDIA
card.

    python3 chip_k3b_costs.py [--parent PATH]

* The rate of ``mma.sync.m16n8k8.tf32`` alone: warps issuing independent
  products from registers, 8 and 16 warps an SM, 4 to 16 accumulators a
  warp (the ceiling of K3b's products, which are all on ``mma.sync``).
* K3b at the LM's shape (H=8, L=2048, D=128, f32, causal, B in {1, 4})
  built from ``mxnet_tpu_torch/csrc/flash_attention.cu`` as committed and
  from variants of it that each drop one part of the dq sum (results
  wrong, timing only):

  - ``no turn waits``: a key tile adds its dq part without waiting for the
    previous key tile's (the order of the sum is lost);
  - ``no dq loads``: every key tile stores its part instead of adding it
    to the sum so far (no copy of the old dq, no add);

  and, when ``--parent`` names an older copy of the source whose K3b takes
  no work array (the three-launch K3b of commit c2eb37b; default
  ``build/k3b_parent/flash_attention.cu``, e.g. from ``git show
  c2eb37b:mxnet_tpu_torch/csrc/flash_attention.cu``), that copy.  The
  committed kernel and the parent are held against the plain version
  (``1e-4`` of each output's largest magnitude).  Times are CUDA events
  over 10 calls, the variants in turns, twice.

Prints the card's name and power limit first.  Exits non-zero without a
card.
"""

import argparse
import ctypes
import math
import os
import subprocess
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 2
HEADS, SEQ, HEAD_DIM = 8, 2048, 128

#: (old, new) edits, each of which must match the source exactly once
VARIANTS = {
    "as built": [],
    "no turn waits": [("      if (threadIdx.x == 0 && j > 0) {\n"
                       "        int ns = 32;",
                       "      if (false) {\n        int ns = 32;")],
    "no dq loads": [("      if (j > 0 && p.vec)\n", "      if (false)\n"),
                    ("              if (j > 0) {\n                const float2 o",
                     "              if (false) {\n                const float2 o")],
}

MMA_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int NACC>
__global__ void peak(float* out, int iters) {
  float c[NACC][4];
  for (int i = 0; i < NACC; ++i)
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
  uint32_t a[4], b0 = threadIdx.x, b1 = threadIdx.x * 3;
  for (int e = 0; e < 4; ++e) a[e] = threadIdx.x + e;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int i = 0; i < NACC; ++i)
    for (int e = 0; e < 4; ++e) s += c[i][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(void* out, int blocks, int threads, int iters, int nacc,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nacc == 4) peak<4><<<blocks, threads, 0, st>>>((float*)out, iters);
  else if (nacc == 8) peak<8><<<blocks, threads, 0, st>>>((float*)out, iters);
  else peak<16><<<blocks, threads, 0, st>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
"""


def sources():
    """(variant, source text) for each variant of the committed source."""
    with open(os.path.join(ROOT, "mxnet_tpu_torch", "csrc",
                           "flash_attention.cu")) as f:
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


def mma_rate(kernels, time_ms):
    """TF32 TFLOP/s of mma.sync.m16n8k8 at 8 and 16 warps an SM."""
    lib = kernels.build_variants("k3b_costs_mma", [("mma", MMA_SOURCE)])["mma"]
    lib.run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(nsm * 2 * 512, device="cuda")
    iters = 4096
    for threads in (128, 256):
        for nacc in (4, 8, 16):
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                err = lib.run(out.data_ptr(), 2 * nsm, threads, iters, nacc,
                              stream)
                if err:
                    raise RuntimeError("CUDA error %d" % err)

            ms = time_ms(run, 1)
            flops = 2 * nsm * threads // 32 * iters * nacc * 2048
            print("mma.sync tf32, %d warps an SM, %d accumulators a warp: "
                  "%.1f TFLOP/s" % (2 * threads // 32, nacc,
                                    flops / ms / 1e9), flush=True)


def parent_bwd(lib):
    """The three-launch entry point (no work array) as a K3b call."""
    from mxnet_tpu_torch.ops import attention as att
    fn = lib.mxtt_flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 24
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, k, v, out, lse, do, dlse, causal, scale):
        b, h, lq, d = q.shape
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        dd = torch.empty((b, h, lq), device=q.device)
        vec = int(d % 4 == 0 and all(att._vector_ok(t)
                                     for t in (q, k, v, do)))
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 do.data_ptr(), lse.data_ptr(),
                 None if dlse is None else dlse.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), dd.data_ptr(), b, h, lq,
                 k.shape[2], d, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *out.stride()[:3], *do.stride()[:3],
                 *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
                 float(scale), int(causal), vec,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError("CUDA error %d" % err)
        return dq, dk, dv
    return call


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=os.path.join(
        ROOT, "build", "k3b_parent", "flash_attention.cu"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_k3b_costs.py needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.ops import attention as att
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    mma_rate(_kernels, cs._time_ms)

    named = sources()
    if os.path.exists(args.parent):
        with open(args.parent) as f:
            named.append(("three-launch K3b", f.read()))
    libs = _kernels.build_variants("k3b_costs", named)
    real = att._kernels

    def call_with(name, lib, *a):
        if name == "three-launch K3b":
            return parent_bwd(lib)(*a)
        att._kernels = types.SimpleNamespace(load=lambda _name: lib)
        try:
            return att.flash_attention_bwd_cuda(*a)
        finally:
            att._kernels = real

    dev = torch.device("cuda", 0)
    scale = 1.0 / math.sqrt(HEAD_DIM)
    for b in (1, 4):
        rs = np.random.RandomState(b)

        def heads():
            t = rs.standard_normal((b, SEQ, HEADS * HEAD_DIM)).astype(
                np.float32)
            return torch.from_numpy(t).to(dev).reshape(
                b, SEQ, HEADS, HEAD_DIM).transpose(1, 2)

        q, k, v, do = heads(), heads(), heads(), heads()
        out, lse = att.flash_attention_cuda(q, k, v, True, scale)
        args_ = (q, k, v, out, lse, do, None, True, scale)
        want = att.flash_attention_bwd_plain(*args_)
        for name, lib in libs.items():
            if name in ("as built", "three-launch K3b"):
                got = call_with(name, lib, *args_)
                rel = max(((g - w).abs().max() / max(1.0, w.abs().max()))
                          .item() for g, w in zip(got, want))
                if not rel <= 1e-4:
                    raise RuntimeError("%s disagrees with the plain version "
                                       "at B=%d: %.3g" % (name, b, rel))
        times = {name: [] for name in libs}
        for _ in range(ROUNDS):
            for name, lib in libs.items():
                times[name].append(cs._time_ms(
                    lambda: call_with(name, lib, *args_), 10))
        print("K3b B=%d H=%d L=%d D=%d causal: %s" % (
            b, HEADS, SEQ, HEAD_DIM, ", ".join(
                "%s %s ms" % (name, " / ".join("%.4f" % t for t in ts))
                for name, ts in times.items())), flush=True)
        del q, k, v, do, out, lse, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
