#!/usr/bin/env python3
"""Classic and sync-free ``Module.fit`` of ResNet-50 b128 on one NVIDIA
card, in turns, for their spread within one process: ``chip_smoke.py``'s
training phase (C, phase 7) and sync-free phase (S, phase 7b).

    python3 chip_sync_free_runs.py [--order CSSCCS] [--seed N]

Each S prints its numbers beside those of the last C, so the order starts
with C.  Prints the card's name and power limit first.  Exits non-zero,
printing no result, without a card.
"""

import argparse
import os
import subprocess
import sys

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--order", default="CSSCCS")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not args.order or args.order[0] != "C" or set(args.order) - {"C",
                                                                    "S"}:
        ap.error("--order is a string of C and S that starts with C")
    if not torch.cuda.is_available():
        print("chip_sync_free_runs: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import bn_kernel as bnk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    # the kernel-phase sums the training phase prints its share against
    totals = {"fwd": {"ms": 0.0}, "bwd": {"ms": 0.0}}
    classic = None
    for i, kind in enumerate(args.order):
        print("=== run %d: %s" % (i + 1, "classic" if kind == "C"
                                   else "sync-free"), flush=True)
        if kind == "C":
            _launches, classic = cs.training_phase(
                mx, bnk, args.seed, cs.TRAIN_STEPS, totals)
        else:
            cs.sync_free_phase(mx, bnk, args.seed, cs.TRAIN_STEPS, classic)
    return 0


if __name__ == "__main__":
    sys.exit(main())
