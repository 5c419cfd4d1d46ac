#!/usr/bin/env python3
"""Where the time of one step of the clustered LSTM forward goes, on one
NVIDIA card.

    python3 chip_lstm_costs.py

Builds ``mxnet_tpu_torch/csrc/lstm.cu`` as committed and variants of it
that each drop or change one part of the forward kernel (K4/K5), then
times K5 at T = 10 and T = 60 (N = 32, H = 200: the LSTM LM's shape) with
CUDA events, the variants in turns; the slope (T=60 - T=10) / 50 is the
cost of one step without the launch.  The variants' outputs are not
checked: they exist only to be timed.

* ``as built``: the committed kernel;
* ``one CTA per SM``: shared memory padded past half an SM's, so that no
  two CTAs share an SM;
* ``w4 in registers``: each lane holds its 25 rows of its column of w4
  (100 floats) in registers for the whole sequence, and reads only h from
  shared memory in a step (valid at this shape only);
* ``no product``: the dot products skipped (z = 0);
* ``no product, no exchange``: also no DSMEM stores of h, and a CTA
  barrier in place of the cluster barrier.

Every variant records each CTA's SM (``%smid``), so the placement of the
launch's CTAs is printed beside its times.  Prints the card's name and
power limit first.  Exits non-zero without a card.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N, H, TS, ROUNDS, ITERS = 32, 200, (10, 60), 3, 50

#: (old, new) edits, each of which must match the source exactly once
SMID = [
    ("namespace cg = cooperative_groups;",
     "namespace cg = cooperative_groups;\n__device__ unsigned mxtt_smid[4096];"),
    ("  float* w4f = reinterpret_cast<float*>(w4s);",
     "  if (threadIdx.x == 0) {\n    unsigned id;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(id));\n"
     "    mxtt_smid[blockIdx.x] = id;\n  }\n"
     "  float* w4f = reinterpret_cast<float*>(w4s);"),
]
SMID_EXPORT = """
extern "C" int mxtt_smids(unsigned* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, mxtt_smid, n * sizeof(unsigned));
}
"""
PAD = [("    p->smem = bytes(R);\n    p->P = P;",
        "    p->smem = std::max(bytes(R), (size_t)118000);\n    p->P = P;")]
NO_PRODUCT = [(
    "const int i0 = s * chunk, i1 = min(H, i0 + chunk), im = min(i1, Sw);",
    "const int i0 = s * chunk, i1 = i0, im = i0;")]
NO_EXCHANGE = [
    ("cluster.sync();  // h of step t from every CTA is here",
     "__syncthreads();"),
    ("if (r < nrow) peer[ho + r * H] = v;",
     "if (r < nrow && s == rank) peer[ho + r * H] = v;")]
#: each lane keeps its chunk of its column of w4 in registers for the whole
#: sequence (at this shape one column per lane group and chunk = 25)
IN_REGISTERS = [
    ("    const int ntask = sz * ((rows + FR - 1) / FR);\n",
     "    const int ntask = sz * ((rows + FR - 1) / FR);\n"
     "    float4 wreg[25];\n"
     "#pragma unroll\n"
     "    for (int q = 0; q < 25; ++q)\n"
     "      wreg[q] = i0 + q < im\n"
     "                    ? w4s[(i0 + q) * P + (threadIdx.x / FG) % max(sz, 1)]\n"
     "                    : make_float4(0.f, 0.f, 0.f, 0.f);\n"),
    ("#pragma unroll 4\n        for (int i = i0; i < im; ++i) {\n"
     "          const float4 w = w4s[i * P + jl];",
     "#pragma unroll\n        for (int q = 0; q < 25; ++q) {\n"
     "          const int i = i0 + q;\n"
     "          if (i >= im) break;\n"
     "          const float4 w = wreg[q];")]
VARIANTS = {"as built": [], "one CTA per SM": PAD,
            "w4 in registers": IN_REGISTERS, "no product": NO_PRODUCT,
            "no product, no exchange": NO_PRODUCT + NO_EXCHANGE}


def sources():
    """(variant, source text) for each variant of the committed source,
    every one with the %smid record."""
    with open(os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "lstm.cu")) as f:
        src = f.read()
    out = []
    for name, edits in VARIANTS.items():
        text = src
        for old, new in SMID + edits:
            if text.count(old) != 1:
                raise RuntimeError("variant %r: %r matches %d times"
                                   % (name, old, text.count(old)))
            text = text.replace(old, new)
        out.append((name, text + SMID_EXPORT))
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_lstm_costs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.ops import rnn_kernel as rk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("nvidia-smi: %s" % smi, flush=True)
    libs = _kernels.build_variants("lstm_costs", sources())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = {}
    for T in TS:
        args = (torch.randn(T, 4, N, H, device=dev, generator=gen) * 0.5,
                torch.randn(4, H, H, device=dev, generator=gen) * H ** -0.5,
                torch.randn(4, H, device=dev, generator=gen) * 0.1,
                torch.randn(N, H, device=dev, generator=gen) * 0.5,
                torch.randn(N, H, device=dev, generator=gen) * 0.5)
        outs = (torch.empty(T, N, H, device=dev),
                torch.empty(T, 4, N, H, device=dev),
                torch.empty(T, N, H, device=dev),
                torch.empty(N, H, device=dev), torch.empty(N, H, device=dev))
        inputs[T] = [t.data_ptr() for t in args + outs]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib, T):
        err = rk._fn(lib, "mxtt_lstm_fwd", 10)(*inputs[T], T, N, H, stream)
        if err != 0:
            raise RuntimeError("launch failed: CUDA error %d" % err)

    times = {}
    names = list(libs)
    for rnd in range(ROUNDS):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            for T in TS:
                for _ in range(3):
                    launch(libs[name], T)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(ITERS):
                    launch(libs[name], T)
                b.record()
                torch.cuda.synchronize()
                times.setdefault((name, T), []).append(
                    a.elapsed_time(b) / ITERS)
    for name in names:
        launch(libs[name], TS[0])
        torch.cuda.synchronize()
        plan = (ctypes.c_longlong * 5)()
        fn = libs[name].mxtt_lstm_fwd_plan
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_longlong)]
        if fn(N, H, plan) != 0:
            raise RuntimeError("the forward plan failed")
        ctas = plan[3] * 8  # clusters of 8 CTAs
        ids = (ctypes.c_uint * ctas)()
        if libs[name].mxtt_smids(ids, ctypes.c_int(ctas)) != 0:
            raise RuntimeError("reading the SM ids failed")
        per_sm = np.bincount(np.asarray(ids, dtype=np.int64))
        lo, hi = (float(np.median(times[(name, T)])) for T in TS)
        print("step cost %s (N=%d H=%d, %d CTAs on %d SMs, at most %d per "
              "SM): median ms T=%d %.4f, T=%d %.4f; per step %.3f us; runs "
              "%s" % (name, N, H, ctas, int((per_sm > 0).sum()),
                      int(per_sm.max()), TS[0], lo, TS[1], hi,
                      (hi - lo) / (TS[1] - TS[0]) * 1e3,
                      {T: ["%.4f" % x for x in times[(name, T)]]
                       for T in TS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
