#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--parent-bn PATH]

1. Prints the card's name and power limit.
2. Builds every CUDA kernel of the port from ``mxnet_tpu_torch/csrc/``
   (one ``nvcc`` per source, all started together).
3. Kernel phase: flash attention (K3) at B in {1, 4}, H=8, L=2048, D=128,
   f32, causal and not, held against its plain PyTorch version on the card
   (TF32 off for the plain version; the kernel's 3xTF32 products keep
   f32 accuracy; ``atol=rtol=1e-4`` on out and lse, the sums run in
   another order) and timed with CUDA events beside the plain version,
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls)
   and the least time the card could take (the larger of three times the
   operations over the 495 TFLOP/s TF32 peak, since 3xTF32 takes three
   products per product, and the bytes over 3.35 TB/s; the f32
   CUDA-core figure is printed beside it).
3b. K3b phase: the flash-attention backward (K3b) at B in {1, 4}, H=8,
   L=2048, D=128, f32, causal and not, then a ragged shape (B=2, Lq=1337,
   Lk=1901, causal) and the full causal shape with a nonzero dlse, on
   (B, L, H*D) -> (B, H, L, D) views as MultiHeadAttention passes them:
   dq, dk, dv held against the plain backward on the card (TF32 off)
   within ``1e-4`` of each output's largest magnitude, in the strides of
   q, k, v, bit for bit across two launches; timed beside the plain
   version, the backward of ``F.scaled_dot_product_attention`` (a
   yardstick the port never calls) and the bound (five products, 10*D
   operations per attended pair, at the 3xTF32 rate).
4. BatchNorm kernel phase: at every distinct BatchNorm input of the
   ResNet-50 b128 training step (shape, fix_gamma, fused ReLU), K1 and K2
   held against their plain versions (max error within ``1e-4`` of each
   output's largest magnitude; K2 takes K1's saved statistics in both, so
   the ReLU masks agree), each shape's layout printed (``bn_plan``), and
   timed on the device with the L2 cold (the calls rotate over copies of
   the inputs, at least 100 MB of them, captured in a CUDA graph and
   replayed) beside ``F.batch_norm(training=True)`` (K1,
   without the ReLU) and ``aten.native_batch_norm_backward`` (K2) as
   yardsticks the port never calls, the kernels before the resident path
   (``--parent-bn``: a copy of that ``csrc/batch_norm.cu``, built beside
   the port's under ``build/bn_parent/``; not measured when absent), the
   plain versions and the bound (bytes over 3.35 TB/s: K1 reads x and
   writes y, K2 reads x and g and writes dx); summed over the step and
   over the 50 BatchNorms outside bn_data.
5. LSTM kernel phase: at each bucket length T in {10, ..., 60}, N=32,
   H=200, f32, K4 (inference forward), K5 (training forward) and K6
   (backward) held against their plain versions (forward outputs within
   ``1e-5``, backward within ``1e-4`` of each output's largest magnitude;
   K6 is fed K5's saved tensors in both), dw4 and dbh repeating bit for
   bit across two K6 launches; timed beside the plain versions, cuDNN's
   LSTM (``torch.nn.LSTM``, one layer, a yardstick the port never calls;
   it includes the input projection, whose matmuls are printed beside
   the kernel) and the bound (the larger of the products over 67 TFLOP/s
   and the bytes over 3.35 TB/s); K4/K5 and K6 repeat bit for bit across
   two launches (K6: dw4 and dbh); the cluster layouts of K4/K5 and K6
   are printed.  Then K4 and K5 at T=8, N=8, H=1024 (the widest H, where
   the slices of w4 stream from L2) and K6 on K5's outputs, against the
   plain versions with the same limits.
6. Serving phase: ``build_lm`` at vocab 32000, embed 1024, 8 heads of 128,
   seq 2048, FFN 2048, f32, buckets (1, 4), weights drawn from ``--seed``,
   published with ``save_model`` and loaded with ``ModelRegistry().load_dir``
   on the default context (the card).  Six concurrent requests (one of 1
   row, five of 4 rows, so no two can share a dispatch and both buckets
   run) go through ``ServedModel.predict``; outputs are checked for shape,
   finiteness and rows that sum to 1, and the 1-row answer is held against
   the same model computed in plain PyTorch with the plain attention.  The
   K3 launch count must equal the dispatches (warm-up included).
6b. LM training phase: ``Module(build_lm(32000, 1024, 8, 2048)).fit`` on
   the default context (the card), batch 4, one epoch of 8 batches of the
   copy task of ``example/long-context/train_lm.py`` from ``--seed``, Adam
   at the example's lr 1e-2, ``Perplexity(ignore_label=None)``, the
   initializer ``fit`` defaults to (seeded), then ``score``.  It requires
   one K3 and one K3b launch per training batch, one K3 per score batch,
   and no plain attention called on the card; the Adam moments stay on
   the card.  Prints the ms per step (CUDA events between batch ends, the
   first step apart; the host copy ``Perplexity`` takes is inside it),
   tokens/s, the host copy and the metric update apart, a
   ``torch.profiler`` split of one step (K3, K3b, cuBLAS, ...), peak
   memory and the finite perplexities; then the same fit with the plain
   attention rerouted on the card, its perplexities printed beside.
6c. LM step parity: one full-width step's gradients (b4, Xavier from
   ``--seed``) through K3 and K3b against the same step with the plain
   attention rerouted on the card: the FFN pre-activations of the two
   forwards within ``1e-4`` of their magnitude (units on opposite sides
   of 0 counted and printed; the K3 step takes the plain step's ReLU
   mask), then each parameter's gradient within ``1e-4`` of its norm,
   and K3b alone (after the same K3 forward, against the plain
   backward) within ``1e-4`` of each norm.
7. Training phase: ``Module(resnet50).fit`` on the default context (the
   card) at full width (224x224x3, 1000 classes, f32, batch 128) over
   6 batches of synthetic data from ``--seed``: SGD with
   momentum 0.9, wd 1e-4, lr 0.1 with a ``MultiFactorScheduler``, Xavier
   (gaussian, in, 2) seeded from ``--seed``, accuracy + top-5 metrics, a
   ``Speedometer``.  K1 and
   K2 must each launch 51 times per step.  Prints the step time (CUDA
   events between batch ends, the first step apart), images/s, the K1/K2
   share of the step, a ``torch.profiler`` breakdown of one more step, the
   host-to-device batch copy and ``torch.cuda.max_memory_allocated``.
   Then one more step in which every K1 and K2 call is held against
   references on its own inputs (y, mean, var, dx against the plain
   version, within ``1e-5`` of the output's largest magnitude; dgamma and
   dbeta against f64 sums, within ``1e-5`` of the sum of their terms'
   magnitudes, as they cancel).
7b. Sync-free training phase: the same ``fit`` over the same batches and
   settings with ``MXNET_FUSE_TRAIN_STEP=1`` (the step captured as a CUDA
   graph after one eager warm-up step, then replayed),
   ``MXNET_BULK_TRAIN_STEPS=2`` (``run_bulk`` chunks),
   ``prefetch_to_device=True`` and the metric on the card
   (``DeviceMetric``, read by a Speedometer every 3 batches), set only
   within the phase.  Requires 5 replays in 6 steps, 51 K1 and 51 K2
   launches per step by the counters (a replay adds what its capture
   recorded), as many K1/K2 kernel executions in a replayed step as in
   an eager one by ``torch.profiler`` (110: 49 resident calls of one
   kernel and 2 chunked of three, each direction), no plain BatchNorm on
   the card, the device metric equal to the host metric on the same
   outputs, and the parameters within 3x the f32 floor of a classic fit
   from the same seeded init (the floor: the same fit on an input
   perturbed by 1e-7; both classic fits take the lr of each chunk's last
   update, the rule ``run_bulk`` keeps).  Prints the chunk times, the
   first step, the step and images/s beside the classic phase's, the
   syncs per epoch, peak memory, and a second epoch of the same ``fit``
   (every step a replay) profiled from an idle card: the device's idle
   share and the share of the batch copies' time under kernels.
7c. Checkpoint phase: the sync-free ``fit`` of 7b (same switches, batches
   and seed) over two epochs with ``checkpoint_prefix`` in a temporary
   directory and a snapshot every 2 batches by the async writer.  Fits A
   and A' run through; fit B takes a SIGTERM (``signal.raise_signal``
   from its batch-end callback) at batch 3, the end of its second chunk,
   and must raise ``TrainingPreempted`` leaving a generation at batch 3
   whose parameters and momenta, read back from the files, equal B's
   arrays bit for bit; fit C, a new Module, resumes it with
   ``resume="auto"`` and must replay its captured step in every step
   after its first, launch K1 and K2 51 times a step and call no plain
   BatchNorm on the card; fit D is ``Module.load`` of A's epoch-1
   checkpoint with its optimizer states, trained one more epoch.  Each
   tensor of C and D must lie within 3x (its distance between A and A'
   plus 7b's floor) of A, and equal A bit for bit where A and A' do.
   Prints the host ms ``_FitRun.after_batch`` takes per snapshot, the
   writer's seconds and MB per generation, the step with and without
   snapshots, the resumed fit's first step and peak memory.
8. Step parity: the same ResNet-50 weights and batch (b4), one fit step on
   ``gpu(0)`` and on ``cpu()`` (the plain versions).  The first step of a
   random ResNet-50 is ill-conditioned (a 1e-7 input perturbation moves
   the updates by 1-2% on the CPU alone), so each parameter's update on
   the card must stay within 3x the largest distance of the CPU's updates
   on three perturbed inputs, measured in the run; the moving statistics
   within ``rtol=1e-4, atol=1e-5``.  The card step with the plain
   BatchNorm in place of K1/K2 is printed beside it as a second witness.
9. LSTM training phase: the fused-LSTM LM of
   ``example/rnn/fused_lstm_bucketing.py`` (``models.lstm_lm``: vocab
   10000, embed 200, 2 LSTM layers of 200, f32) through
   ``BucketingModule.fit`` on the card, batch 32, buckets 10-60, one
   epoch over a Markov corpus from ``--seed`` (every bucket, at least two
   batches each) with ``score`` on ``eval_data``, SGD lr 0.02, wd 1e-5,
   Xavier (in, 2.34) with ``FusedRNN``, ``Perplexity(0)``.  It requires 2
   K5 and 2 K6 launches per training batch, 2 K4 per eval batch, and no
   plain version called on the card.  Prints the ms per batch per bucket
   (CUDA events), the host copy of the outputs ``Perplexity`` takes,
   peak memory, the (finite) validation perplexity and a profile of one
   T=60 batch.  The fit's ``epoch_end_callback`` is ``do_rnn_checkpoint``;
   a second ``BucketingModule`` built from ``load_rnn_checkpoint`` scores
   the eval data to the trained module's perplexity (``rtol=1e-6``, both
   on iterators shuffled alike) with 2 K4 launches per eval batch.
10. LSTM step parity: one T=60 training step on the card and on the CPU
   (plain versions) from the same weights; each parameter's update
   within 1e-4 of its norm (3x the floor if an embedding perturbed by
   1e-7 moves the CPU's own update by more).
11. Prints the kernel table (K1-K6 and K3b) as one JSON line, the card's
   name and power limit, then the result line.

Exits non-zero, printing no result, without a card or outside the repo.
"""

import argparse
import concurrent.futures
import contextlib
import json
import math
import os
import random
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

#: published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

VOCAB, EMBED, HEADS, SEQ = 32000, 1024, 8, 2048
TRAIN_BATCH, TRAIN_STEPS, PARITY_BATCH = 128, 6, 4
#: the checked step's bound on each K1/K2 output error (see bn_checking)
BN_STEP_TOL = 1e-5
#: bytes of input copies the BatchNorm timings rotate over (twice L2)
COLD_BYTES = 100e6
ROOT = os.path.dirname(os.path.abspath(__file__))
#: CPU steps on perturbed inputs that set the parity floor
PARITY_PERTURBATIONS = 3
BUCKETS = (1, 4)
REQUEST_ROWS = (1, 4, 4, 4, 4, 4)
#: the LM training phase: train_lm.py's Adam lr, batches of the copy task
LM_BATCH, LM_BATCHES, LM_LR = 4, 8, 1e-2
#: the fused-LSTM LM of example/rnn/fused_lstm_bucketing.py at full width
LSTM_VOCAB, LSTM_EMBED, LSTM_HIDDEN, LSTM_LAYERS = 10000, 200, 200, 2
LSTM_BATCH, LSTM_BUCKETS = 32, (10, 20, 30, 40, 50, 60)
LSTM_TRAIN_SENTENCES, LSTM_VAL_SENTENCES = 1200, 400


def _time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _attention_bound(b, h, lq, lk, d, causal):
    """(bound_ms, bound_by, flops): the two products need 4*D operations
    per (query, key) pair this data attends; q, k, v read once, out and
    lse written once.  K3 keeps f32 accuracy on the tensor cores with
    three TF32 products per product (3xTF32), so the operations count
    three times over the 495 TFLOP/s TF32 peak."""
    pairs = lq * (lq + 1) // 2 if causal else lq * lk
    flops = 4.0 * b * h * d * pairs
    nbytes = 4.0 * b * h * (lq * d + 2 * lk * d + lq * d + lq)
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations", flops
    return t_bytes * 1e3, "bytes", flops


def kernel_phase(att, dev, seed):
    rows = {}
    for b in (1, 4):
        for causal in (True, False):
            rs = np.random.RandomState(seed + b)
            q, k, v = [torch.from_numpy(
                rs.standard_normal((b, HEADS, SEQ, 128)).astype(np.float32))
                .to(dev) for _ in range(3)]
            scale = 1.0 / math.sqrt(128)
            out, lse = att.flash_attention_cuda(q, k, v, causal, scale)
            torch.cuda.synchronize()
            pout, plse = att.flash_attention_plain(q, k, v, causal, scale)
            torch.testing.assert_close(out, pout, rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
            err = max((out - pout).abs().max().item(),
                      (lse - plse).abs().max().item())
            ms = _time_ms(lambda: att.flash_attention_cuda(
                q, k, v, causal, scale), 20)
            plain_ms = _time_ms(lambda: att.flash_attention_plain(
                q, k, v, causal, scale), 5, warmup=1)
            # the yardstick: one PyTorch call computing the same out (the
            # port never calls it)
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale), 20)
            bound_ms, bound_by, flops = _attention_bound(
                b, HEADS, SEQ, SEQ, 128, causal)
            rows[(b, causal)] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, library_ms=lib_ms,
                                     bound_ms=bound_ms, bound_by=bound_by)
            print("kernel flash_attention B=%d H=%d L=%d D=128 causal=%s: "
                  "max_abs_err %.3g, kernel %.4f ms (%.1f TFLOP/s of f32 "
                  "work, %.0f%% of the bound), plain %.4f ms, sdpa %.4f "
                  "ms, bound %.4f ms (%s, 3xTF32 at 495 TFLOP/s; on the "
                  "CUDA cores at 67 TFLOP/s f32 it would be %.4f ms)"
                  % (b, HEADS, SEQ, causal, err, ms, flops / ms / 1e9,
                     100 * bound_ms / ms, plain_ms, lib_ms, bound_ms,
                     bound_by, flops / PEAK_F32_FLOPS * 1e3), flush=True)
            del q, k, v, out, lse, pout, plse
    return rows


def _pairs(lq, lk, causal):
    """(query, key) pairs attended: all of them, or under the top-left
    causal mask those with qi >= ki."""
    if not causal:
        return lq * lk
    n = min(lq, lk)
    return n * (n + 1) // 2 + max(0, lq - lk) * lk


def _attention_bwd_bound(b, h, lq, lk, d, causal, with_dlse):
    """(bound_ms, bound_by, flops) of K3b: the five products (S = Q K^T,
    dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K) need 10*D
    operations per (query, key) pair this data attends, at the 3xTF32
    rate as K3 (three TF32 products per product); q, k, v, out, do, lse
    (and dlse) read once, dq, dk, dv written once."""
    flops = 10.0 * b * h * d * _pairs(lq, lk, causal)
    words = b * h * (4 * lq * d + 4 * lk * d + lq * (2 if with_dlse else 1))
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, 4.0 * words / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations", flops
    return t_bytes * 1e3, "bytes", flops


def k3b_kernel_phase(att, dev, seed):
    """K3b against its plain version on the card (TF32 off for the plain
    version), each of dq, dk, dv within ``1e-4`` of its largest
    magnitude, on (B, L, H*D) -> (B, H, L, D) views as MultiHeadAttention
    passes them, repeating bit for bit across two launches; at B in {1, 4},
    L = 2048, causal and not, then a ragged shape and the full shape with
    a nonzero dlse.  Timed beside the plain version, the backward of
    ``F.scaled_dot_product_attention`` (a yardstick the port never calls)
    and the bound."""
    rows = {}
    cases = [(b, SEQ, SEQ, causal, False) for b in (1, 4)
             for causal in (True, False)]
    cases += [(2, 1337, 1901, True, True), (4, SEQ, SEQ, True, True)]
    scale = 1.0 / math.sqrt(128)
    for b, lq, lk, causal, with_dlse in cases:
        rs = np.random.RandomState(seed + 31 * b + lq)

        def heads(n):
            t = rs.standard_normal((b, n, EMBED)).astype(np.float32)
            return torch.from_numpy(t).to(dev).reshape(
                b, n, HEADS, EMBED // HEADS).transpose(1, 2)

        q, k, v, do = heads(lq), heads(lk), heads(lk), heads(lq)
        dlse = torch.from_numpy(rs.standard_normal((b, HEADS, lq)).astype(
            np.float32)).to(dev) if with_dlse else None
        out, lse = att.flash_attention_cuda(q, k, v, causal, scale)

        def kernel():
            return att.flash_attention_bwd_cuda(q, k, v, out, lse, do, dlse,
                                                causal, scale)

        def plain():
            return att.flash_attention_bwd_plain(q, k, v, out, lse, do, dlse,
                                                 causal, scale)

        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise RuntimeError("K3b's gradients differ between two launches "
                               "at B=%d Lq=%d Lk=%d causal=%s"
                               % (b, lq, lk, causal))
        want = plain()
        rel = max(_rel_err(g, w) for g, w in zip(got, want))
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        if not rel <= 1e-4:
            raise RuntimeError("K3b disagrees with its plain version at B=%d "
                               "Lq=%d Lk=%d causal=%s dlse=%s: %.3g of the "
                               "output's magnitude (limit 1e-4)"
                               % (b, lq, lk, causal, with_dlse, rel))
        if any(g.stride() != t.stride() for g, t in zip(got, (q, k, v))):
            raise RuntimeError("K3b's gradients do not take the strides of "
                               "q, k and v")
        del again, want
        ms = _time_ms(kernel, 10)
        plain_ms = _time_ms(plain, 3, warmup=1)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            ref = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                 scale=scale)
        lib_ms = _time_ms(lambda: torch.autograd.grad(
            ref, leaves, do, retain_graph=True), 10)
        bound_ms, bound_by, flops = _attention_bwd_bound(
            b, HEADS, lq, lk, 128, causal, with_dlse)
        rows[(b, lq, lk, causal, with_dlse)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=bound_by)
        print("kernel flash_attention_bwd (K3b) B=%d H=%d Lq=%d Lk=%d D=128 "
              "causal=%s dlse=%s: max_abs_err %.3g (%.2g of the magnitude), "
              "bit for bit across launches, kernel %.4f ms (%.1f TFLOP/s of "
              "f32 work, %.0f%% of the bound), plain %.4f ms, sdpa backward "
              "%.4f ms, bound %.4f ms (%s, 3xTF32 at 495 TFLOP/s; on the "
              "CUDA cores at 67 TFLOP/s f32 it would be %.4f ms)"
              % (b, HEADS, lq, lk, causal, with_dlse, err, rel, ms,
                 flops / ms / 1e9, 100 * bound_ms / ms, plain_ms, lib_ms,
                 bound_ms, bound_by, flops / PEAK_F32_FLOPS * 1e3),
              flush=True)
        del q, k, v, do, dlse, out, lse, got, leaves, ref
        torch.cuda.empty_cache()
    return rows


def reference_forward(p, tokens, att):
    """build_lm in plain PyTorch with the plain attention."""
    x = F.embedding(tokens.long(), p["embed_weight"]) + p["pos_weight"]
    b, seq, e = x.shape
    hd = e // HEADS
    wq, wk, wv = torch.chunk(p["att_qkv_weight"], 3, dim=0)

    def heads(t):
        return t.reshape(b, seq, HEADS, hd).transpose(1, 2)

    o, _ = att.flash_attention_plain(heads(x @ wq.t()), heads(x @ wk.t()),
                                     heads(x @ wv.t()), True,
                                     1.0 / math.sqrt(hd))
    h = x + o.transpose(1, 2).reshape(b, seq, e) @ p["att_out_weight"].t()
    h = torch.relu(h @ p["ffn1_weight"].t() + p["ffn1_bias"])
    h = h @ p["ffn2_weight"].t() + p["ffn2_bias"]
    logits = h.reshape(-1, e) @ p["head_weight"].t() + p["head_bias"]
    return torch.softmax(logits, dim=-1).reshape(b, seq, -1)


def serving_phase(mx, att, dev, seed):
    from mxnet_tpu_torch.models import build_lm

    net = build_lm(VOCAB, EMBED, HEADS, SEQ)
    shapes, _, _ = net.infer_shape(data=(1, SEQ))
    rng = np.random.default_rng(seed)
    params = {n: (rng.standard_normal(s, dtype=np.float32) * 0.02)
              for n, s in zip(net.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    n_params = sum(v.size for v in params.values())
    print("serving model build_lm vocab %d embed %d heads %d seq %d: %d "
          "params (%.3f GB f32)" % (VOCAB, EMBED, HEADS, SEQ, n_params,
                                    n_params * 4 / 1e9), flush=True)
    requests = [rng.integers(0, VOCAB, (n, SEQ)).astype(np.float32)
                for n in REQUEST_ROWS]
    requests[0] = requests[0][0]  # the 1-row request: a single sample
    with tempfile.TemporaryDirectory() as tmp:
        mx.serving.save_model(tmp, net, mx.nd.save_bytes(params), (SEQ,),
                              buckets=BUCKETS, name="lm")
        # -- the main path: counts from 0, load + warm-up + 6 requests --
        att.flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        reg = mx.serving.ModelRegistry()
        model = reg.load_dir(tmp)
        load_s = time.perf_counter() - t0
        warm_launches = att.flash_attention_cuda.launches
        d0 = model.batcher.dispatches
        results = [None] * len(requests)
        latency = [None] * len(requests)
        errors = []

        def client(i):
            try:
                t = time.perf_counter()
                results[i] = model.predict(requests[i], timeout=600)
                latency[i] = time.perf_counter() - t
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a request did not finish")
        dispatches = model.batcher.dispatches - d0
        launches = att.flash_attention_cuda.launches
        # -- end of the main path --
        print("serving load+warm-up %.3f s; K3 launches: %d in warm-up "
              "(%d buckets), %d for %d dispatches"
              % (load_s, warm_launches, len(BUCKETS),
                 launches - warm_launches, dispatches), flush=True)
        if warm_launches != len(BUCKETS):
            raise RuntimeError("warm-up launched K3 %d times for %d buckets"
                               % (warm_launches, len(BUCKETS)))
        if launches - warm_launches != dispatches \
                or dispatches != len(REQUEST_ROWS):
            raise RuntimeError("K3 launches %d != dispatches %d (expected "
                               "%d)" % (launches - warm_launches, dispatches,
                                        len(REQUEST_ROWS)))
        for req, res in zip(requests, results):
            want = req.shape + (VOCAB,)
            if res.shape != want:
                raise RuntimeError("output shape %s, expected %s"
                                   % (res.shape, want))
            if not np.isfinite(res).all():
                raise RuntimeError("non-finite probabilities")
            worst = np.abs(res.sum(-1, dtype=np.float64) - 1).max()
            if worst > 1e-4:
                raise RuntimeError("rows sum to 1 +- %.3g" % worst)
        with torch.inference_mode():
            p = mx.convert.params_from_numpy(params, dev)
            ref = reference_forward(
                p, torch.from_numpy(requests[0][None]).to(dev), att)[0]
            ref = ref.cpu().numpy()
            del p
        err = np.abs(results[0] - ref).max()
        agree = (results[0].argmax(-1) == ref.argmax(-1)).mean()
        print("serving 1-row request vs plain PyTorch forward: max abs err "
              "%.3g, argmax agreement %.6f" % (err, agree), flush=True)
        np.testing.assert_allclose(results[0], ref, rtol=1e-4, atol=1e-6)
        p50 = mx.telemetry.hist_quantile("serving.request.latency_seconds",
                                         0.5, model="lm")
        print("serving p50 request latency: %.4f s (client clocks, %d "
              "concurrent requests of %s rows; max %.4f s; the "
              "serving.request.latency_seconds bucket estimate %.4f s)"
              % (np.median(latency), len(latency), list(REQUEST_ROWS),
                 max(latency), p50), flush=True)
        # per-dispatch device time and host copy, per bucket, outside the
        # counted run
        pred = model._pred
        for b in BUCKETS:
            pred.reshape({"data": (b, SEQ)})
            pred.set_input("data", requests[1][:b])
            dev_ms = _time_ms(pred.forward, 3, warmup=1)
            t0 = time.perf_counter()
            out = pred.get_output(0)
            copy_s = time.perf_counter() - t0
            print("serving bucket %d: device time per dispatch %.3f ms"
                  % (b, dev_ms), flush=True)
            print("serving bucket %d: host copy of the output %.4f s "
                  "(%.3f GB)" % (b, copy_s, out.nbytes / 1e9), flush=True)
            del out
        reg.close()
    return launches


# -- LM training through K3 and K3b (phases 6b and 6c) -----------------------
@contextlib.contextmanager
def attention_plain_refused(att):
    """Within the block the plain attention versions raise on CUDA
    tensors: the card's path must take K3 and K3b."""
    names = ("flash_attention_plain", "flash_attention_bwd_plain")
    saved = {k: getattr(att, k) for k in names}

    def refuse(name):
        def plain(q, *args, **kw):
            if q.is_cuda:
                raise RuntimeError("%s called on the card" % name)
            return saved[name](q, *args, **kw)
        return plain

    for k in names:
        setattr(att, k, refuse(k))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(att, k, v)


@contextlib.contextmanager
def attention_rerouted(att):
    """Within the block the attention autograd function takes the plain
    versions on the card where it would launch K3 and K3b."""
    saved = {k: getattr(att, k) for k in ("flash_attention_cuda",
                                          "flash_attention_bwd_cuda")}
    att.flash_attention_cuda = lambda *a: att.flash_attention_plain(*a)
    att.flash_attention_bwd_cuda = \
        lambda *a: att.flash_attention_bwd_plain(*a)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(att, k, v)


def lm_training_phase(mx, att, seed):
    """``Module(build_lm).fit`` at full width on the card with Adam, then
    ``score``: one K3 and one K3b launch per training batch, one K3 per
    score batch, no plain attention on the card."""
    from mxnet_tpu_torch.models import build_lm, copy_task

    x, y = copy_task(LM_BATCH * LM_BATCHES, SEQ, VOCAB,
                     np.random.RandomState(seed))
    it = mx.io.NDArrayIter(x, y, batch_size=LM_BATCH,
                           label_name="softmax_label")
    mod = mx.mod.Module(build_lm(VOCAB, EMBED, HEADS, SEQ))
    events, seen, running = [], [], []

    def mark(param):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        running.append(param.eval_metric.get_name_value()[0][1])

    train_metric = mx.metric.Perplexity(ignore_label=None)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    with attention_plain_refused(att):
        # -- the main path: counts from 0, fit of 8 batches, then score --
        att.flash_attention_cuda.launches = 0
        att.flash_attention_bwd_cuda.launches = 0
        mx.init.seed(seed)
        start.record()
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, optimizer="adam",
                optimizer_params={"learning_rate": LM_LR},
                eval_metric=train_metric, batch_end_callback=mark)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = (att.flash_attention_cuda.launches,
                        att.flash_attention_bwd_cuda.launches)
        t0 = time.perf_counter()
        (_, ppl), = mod.score(it, mx.metric.Perplexity(ignore_label=None),
                              batch_end_callback=lambda p: seen.append(1))
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        launches = (att.flash_attention_cuda.launches,
                    att.flash_attention_bwd_cuda.launches)
        # -- end of the main path --
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_train, n_score = len(events), len(seen)
    want_fit = (n_train, n_train)
    want = (n_train + n_score, n_train)
    n_params = sum(a._t.numel() for a in mod.get_params()[0].values())
    print("lm training Module(build_lm vocab %d embed %d heads %d seq %d, "
          "%d params).fit on the card, batch %d, Adam lr %g: %d training "
          "batches in %.2f s (bind and init included), score of %d batches "
          "%.2f s; K3/K3b launches %s in fit (expected %s), %s after score "
          "(expected %s); peak memory allocated %.3f GB"
          % (VOCAB, EMBED, HEADS, SEQ, n_params, LM_BATCH, LM_LR, n_train,
             fit_s, n_score, score_s, fit_launches, want_fit, launches, want,
             peak_gb), flush=True)
    if n_train != LM_BATCHES or fit_launches != want_fit \
            or launches != want:
        raise RuntimeError("LM training launched K3/K3b %s times in fit and "
                           "%s after score, expected %s and %s"
                           % (fit_launches, launches, want_fit, want))
    step_ms = [start.elapsed_time(events[0])] + [
        a.elapsed_time(b) for a, b in zip(events, events[1:])]
    steady = float(np.median(step_ms[1:]))
    (_, train_ppl), = train_metric.get_name_value()
    print("lm training step ms (CUDA events between batch ends, the host "
          "copy for Perplexity included) %s; median after the first %.2f "
          "ms = %.0f tokens/s; train perplexity %.4f, score perplexity %.4f "
          "(vocab %d: a uniform guess scores %d)"
          % (["%.2f" % t for t in step_ms], steady,
             LM_BATCH * SEQ / steady * 1e3, train_ppl, ppl, VOCAB, VOCAB),
          flush=True)
    arg, _ = mod.get_params()
    bad = [k for k, v in arg.items() if not torch.isfinite(v._t).all()]
    dev = mod._context[0].torch_device()
    off_card = [i for i, st in mod._updater.states.items()
                if any(a._t.device != dev for a in st)]
    if bad or off_card or not (np.isfinite(ppl) and np.isfinite(train_ppl)):
        raise RuntimeError("LM training gave non-finite params %s, states "
                           "off the card %s or perplexities %s, %s"
                           % (bad, off_card, train_ppl, ppl))
    it.reset()
    batch = next(it)
    lm_host_copy(mx, mod, batch)
    lm_profile(mx, mod, batch, steady)
    del mod
    torch.cuda.empty_cache()
    lm_plain_witness(mx, att, seed, it, running, ppl)
    return launches


def lm_plain_witness(mx, att, seed, it, running, ppl):
    """The same fit (seed, data, Adam, lr) with the plain attention
    rerouted on the card, its running train perplexity batch by batch
    and its score printed beside those of the K3/K3b fit: whether a
    trajectory at this lr comes from the kernels or from the model."""
    from mxnet_tpu_torch.models import build_lm

    mod = mx.mod.Module(build_lm(VOCAB, EMBED, HEADS, SEQ))
    plain = []
    it.reset()
    with attention_rerouted(att):
        mx.init.seed(seed)
        mod.fit(it, num_epoch=1, optimizer="adam",
                optimizer_params={"learning_rate": LM_LR},
                eval_metric=mx.metric.Perplexity(ignore_label=None),
                batch_end_callback=lambda p: plain.append(
                    p.eval_metric.get_name_value()[0][1]))
        (_, plain_ppl), = mod.score(
            it, mx.metric.Perplexity(ignore_label=None))
    print("lm witness: running train perplexity by batch through K3/K3b "
          "%s, through the plain attention on the card %s; score %.6g "
          "against %.6g" % (["%.6g" % v for v in running],
                            ["%.6g" % v for v in plain], ppl, plain_ppl),
          flush=True)
    del mod
    torch.cuda.empty_cache()


def lm_host_copy(mx, mod, batch):
    """The device forward of one batch, then the host copy of its
    (B*L, 32000) output and the host ``Perplexity`` update on it, as the
    metric takes them on every batch."""
    mod.forward(batch, is_train=False)
    out = mod.get_outputs()[0]
    dev_ms = _time_ms(lambda: mod.forward(batch, is_train=False), 3,
                      warmup=1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    host = out.asnumpy()
    copy_s = time.perf_counter() - t
    metric = mx.metric.Perplexity(ignore_label=None)
    t = time.perf_counter()
    metric.update(batch.label, [host])
    metric_s = time.perf_counter() - t
    print("lm eval forward %.3f ms on the device; host copy of the output "
          "%.4f s (%.3f GB, %.2f GB/s); Perplexity update on the host copy "
          "%.4f s" % (dev_ms, copy_s, host.nbytes / 1e9,
                      host.nbytes / copy_s / 1e9, metric_s), flush=True)


def lm_profile(mx, mod, batch, steady_ms):
    """One training step (forward_backward, update, the host metric) under
    torch.profiler: device time by group (K3, K3b, cuBLAS, ...) and the
    device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    metric = mx.metric.Perplexity(ignore_label=None)

    def step():
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric, batch.label)
        torch.cuda.synchronize()

    step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        wall = (time.perf_counter() - t) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages() if dev_us(e) > 0
               and e.device_type.name == "CUDA"]
    total = sum(dev_us(e) for e in kernels) / 1e3
    if total <= 0:
        print("lm profile: the profiler recorded no device time (not "
              "measured)", flush=True)
        return
    rules = (("K3 (flash_fwd)", lambda k: "flash_fwd" in k),
             ("K3b (flash_bwd)", lambda k: "flash_bwd" in k),
             ("memcpy", lambda k: "memcpy" in k),
             ("cuBLAS gemm", lambda k: "gemm" in k or "cutlass" in k
              or "xmma" in k),
             ("softmax", lambda k: "softmax" in k),
             ("embedding", lambda k: "embedding" in k or "index" in k),
             ("reduce", lambda k: "reduce" in k),
             ("elementwise (Adam, SoftmaxOutput's gradient, ...)",
              lambda k: "elementwise" in k or "vectorized" in k))
    groups = {}
    for e in kernels:
        k = e.key.lower()
        name = next((n for n, test in rules if test(k)), "other")
        groups[name] = groups.get(name, 0.0) + dev_us(e) / 1e3
    busy = total - groups.get("memcpy", 0.0)
    print("lm profile of one training step with its metric update: wall "
          "%.2f ms (steady step %.2f ms), device busy %.3f ms with the "
          "copies (idle share %.1f%%), kernels alone %.3f ms (idle share "
          "%.1f%% without the copies); by group: %s" % (
              wall, steady_ms, total, 100 * max(0.0, 1 - total / wall),
              busy, 100 * max(0.0, 1 - busy / wall),
              ", ".join("%s %.3f ms" % kv for kv in sorted(
                  groups.items(), key=lambda kv: -kv[1]))), flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        print("lm profile  %8.3f ms  x%-4d %s" % (
            dev_us(e) / 1e3, e.count, e.key[:100]), flush=True)


@contextlib.contextmanager
def attention_bwd_rerouted(att):
    """Within the block the attention autograd function takes the plain
    backward on the card where it would launch K3b (K3 still runs)."""
    saved = att.flash_attention_bwd_cuda
    att.flash_attention_bwd_cuda = \
        lambda *a: att.flash_attention_bwd_plain(*a)
    try:
        yield
    finally:
        att.flash_attention_bwd_cuda = saved


@contextlib.contextmanager
def relu_mask_of(nn_ops, pre):
    """Within the block the ReLU on the card appends its input to the
    list ``pre``; from the second input on it takes the mask of the
    first, ``pre[0] > 0``, in place of its own, so that two forwards
    whose pre-activations lie within their tolerance of each other pass
    their gradients through the same units."""
    relu = nn_ops._ACTS["relu"]

    def masked(x):
        if not x.is_cuda:  # the shape inference of the bind
            return relu(x)
        pre.append(x.detach().clone())
        return relu(x) if len(pre) == 1 else torch.where(pre[0] > 0, x, 0.0)

    nn_ops._ACTS["relu"] = masked
    try:
        yield
    finally:
        nn_ops._ACTS["relu"] = relu


def lm_parity_phase(mx, att, seed):
    """One full-width training step's gradients (b4, Xavier from
    ``--seed``) through K3 and K3b against the same step with the plain
    attention rerouted on the card, from the same weights and batch:
    each parameter's gradient within ``1e-4`` of its norm.

    The FFN ReLU of the K3 step takes the mask of the plain step's
    pre-activation.  A unit whose pre-activation lies within rounding of
    0 (PR 10 saw one of 16,777,216 at 1.86e-10) may take either side in
    either forward, and the whole gradient term that flows through it
    then moves every gradient below the FFN by ~4e-4 of its norm, which
    no tolerance of the attention decides.  So the check is that the two
    pre-activations agree within ``1e-4`` of their magnitude (units on
    opposite sides counted and printed), and then the gradients, through
    the same units, within ``1e-4``.  K3b alone (the same K3 forward,
    then K3b against the plain backward) is held within ``1e-4`` too."""
    from mxnet_tpu_torch.models import build_lm, copy_task
    from mxnet_tpu_torch.ops import nn as nn_ops

    x, y = copy_task(LM_BATCH, SEQ, VOCAB, np.random.RandomState(seed + 7))
    mod = mx.mod.Module(build_lm(VOCAB, EMBED, HEADS, SEQ))
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mx.init.seed(seed)
    mod.init_params(mx.init.Xavier())
    batch = mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)])
    pre = []

    def grads():
        del pre[1:]
        with relu_mask_of(nn_ops, pre):
            mod.forward_backward(batch)
        torch.cuda.synchronize()
        return {n: mod._exec.grad_dict[n]._t.clone()
                for n in mod._param_names}

    with attention_rerouted(att):
        want = grads()
    f0 = att.flash_attention_cuda.launches
    b0 = att.flash_attention_bwd_cuda.launches
    got = grads()
    used = (att.flash_attention_cuda.launches - f0,
            att.flash_attention_bwd_cuda.launches - b0)
    if used != (1, 1) or len(pre) != 2:
        raise RuntimeError("the parity step launched K3/K3b %s times and "
                           "ran %d ReLUs, expected (1, 1) and 2"
                           % (used, len(pre)))
    rel = _rel_err(pre[1], pre[0])
    flipped = (pre[1] > 0) != (pre[0] > 0)
    flips = int(flipped.sum().item())
    near = pre[0].abs()[flipped].max().item() if flips else 0.0
    print("lm parity forward: the FFN pre-activation through K3 against "
          "the plain attention %.3g of its magnitude (limit 1e-4); units "
          "on opposite sides of 0: %d of %d (largest |plain pre-activation| "
          "among them %.3g); the K3 step takes the plain step's mask"
          % (rel, flips, pre[0].numel(), near), flush=True)
    if not rel <= 1e-4:
        raise RuntimeError("the FFN pre-activations of the K3 and plain "
                           "steps disagree: %.3g" % rel)
    with attention_bwd_rerouted(att):
        fwd_only = grads()
    worst = 0.0
    for k in sorted(want):
        norm = max(want[k].norm().item(), 1e-30)
        dist = (got[k] - want[k]).norm().item() / norm
        bwd = (got[k] - fwd_only[k]).norm().item() / norm
        worst = max(worst, dist / 1e-4, bwd / 1e-4)
        print("lm parity %s (gradient norm %.4g): K3/K3b step vs the plain "
              "attention %.3g of the norm; K3b alone after the same K3 "
              "forward %.3g (limits 1e-4)" % (k, norm, dist, bwd),
              flush=True)
        if not (dist <= 1e-4 and bwd <= 1e-4):
            raise RuntimeError("the gradients of %s disagree: %.3g of the "
                               "norm, K3b alone %.3g (limits 1e-4)"
                               % (k, dist, bwd))
    print("lm parity one step b%d L=%d: worst distance over its limit %.3g"
          % (LM_BATCH, SEQ, worst), flush=True)
    del mod, got, want, fwd_only, pre[:]
    torch.cuda.empty_cache()


def _scaled_err(got, want):
    """(max abs error, that error over max(1, the largest |want|))."""
    err = (got - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def _rel_err(got, want):
    """max |got - want| over the largest |want| (over 1 if want is 0)."""
    top = want.abs().max().item()
    return (got - want).abs().max().item() / (top if top > 0 else 1.0)


@contextlib.contextmanager
def bn_rerouted(bnk, reroute):
    """Within the block, where the BatchNorm autograd function would call
    kernel K1 or K2 (``kernel``) it calls ``reroute(kernel, plain)``."""
    route = bnk._route

    def rerouted(x, kernel, plain):
        fn = route(x, kernel, plain)
        return reroute(kernel, plain) if fn is kernel else fn

    bnk._route = rerouted
    try:
        yield
    finally:
        bnk._route = route


def _bwd_sums_f64(bnk, x, g, mean, var, gamma, beta, eps, fix_gamma, relu):
    """K2's two sums from its own inputs in f64, each with the sum of the
    magnitudes of its terms: ((dgamma, scale), (dbeta, scale)).  The ReLU
    mask is taken in f32 with the plain version's expression, as both
    kernels take it.  A sum of terms of both signs can be far smaller than
    its terms (dgamma of the stem's BatchNorm cancels to ~1% of them at
    initialization), so its rounding error is measured on that scale."""
    red = (0,) + tuple(range(2, x.ndim))
    if relu:
        _rstd, scale, shift = bnk._scale_shift(mean, var, gamma, beta, eps,
                                               fix_gamma)
        pre = x * bnk._view(scale, x.ndim) + bnk._view(shift, x.ndim)
        g = torch.where(pre > 0, g, torch.zeros_like(g))
    g = g.double()
    rstd = 1.0 / torch.sqrt(var.double() + eps)
    t = g * ((x.double() - bnk._view(mean.double(), x.ndim))
             * bnk._view(rstd, x.ndim))
    return ((t.sum(red), t.abs().sum(red)), (g.sum(red), g.abs().sum(red)))


def _sum_err(got, ref):
    """Largest error of a per-channel sum over its channel's scale."""
    total, scale = ref
    return ((got.double() - total).abs() / scale.clamp_min(1e-300)).max() \
        .item()


def bn_checking(bnk, errs):
    """A ``reroute`` for :func:`bn_rerouted`: the kernel launches (and
    counts) as usual and is then held against a computation on its own
    inputs; ``errs[kernel name]`` collects (x shape, {output: error}).
    y, mean, var and dx: the error over the largest magnitude of the plain
    version's output.  dgamma and dbeta: the error against the f64 sums
    over the sums of magnitudes (:func:`_bwd_sums_f64`), for the kernel
    and, as ``plain_*``, for the plain version."""
    def reroute(kernel, plain):
        def checked(*args):
            out = kernel(*args)
            want = plain(*args)
            if kernel is bnk.bn_fwd_cuda:
                err = dict(zip(("y", "mean", "var"), (
                    _rel_err(a, b) for a, b in zip(out, want))))
            else:
                dg, db = _bwd_sums_f64(bnk, *args)
                err = dict(dx=_rel_err(out[0], want[0]),
                           dgamma=_sum_err(out[1], dg),
                           dbeta=_sum_err(out[2], db),
                           plain_dgamma=_sum_err(want[1], dg),
                           plain_dbeta=_sum_err(want[2], db))
            errs.setdefault(kernel.__name__, []).append(
                (tuple(args[0].shape), err))
            return out
        return checked
    return reroute


def checked_step(mod, batch, bnk):
    """One more training step in which every K1 and K2 call is held, on
    the main path's own tensors, against :func:`bn_checking`'s references;
    each error of a kernel's output must stay within ``BN_STEP_TOL``."""
    errs = {}
    with bn_rerouted(bnk, bn_checking(bnk, errs)):
        mod.forward_backward(batch)
        torch.cuda.synchronize()
    for kernel in ("bn_fwd_cuda", "bn_bwd_cuda"):
        calls = errs.get(kernel, [])
        worst = {}
        for shape, err in calls:
            for out, e in err.items():
                if e >= worst.get(out, (-1.0,))[0]:
                    worst[out] = (e, shape)
        print("training checked step: %d %s calls on the step's own "
              "tensors, worst error by output %s" % (
                  len(calls), kernel, ", ".join(
                      "%s %.3g at %s" % (k, v[0], v[1])
                      for k, v in worst.items())), flush=True)
        if len(calls) != 51:
            raise RuntimeError("%s ran %d times in the checked step, "
                               "expected 51" % (kernel, len(calls)))
        bad = {k: v for k, v in worst.items()
               if not k.startswith("plain_") and not v[0] <= BN_STEP_TOL}
        if bad:
            raise RuntimeError("%s disagrees on the step's own tensors "
                               "beyond %g: %s" % (kernel, BN_STEP_TOL, bad))


def resnet_bn_configs(mx, batch):
    """{(input shape, fix_gamma, relu fused): count} over the BatchNorm
    nodes of the ResNet-50 training step at ``batch``, read from the graph
    the way the executor's peephole reads it."""
    from mxnet_tpu_torch.executor import _bn_relu_peephole

    net = mx.models.get_symbol("resnet", num_classes=1000, num_layers=50,
                               image_shape="3,224,224")
    var_shape, _, entry = net._infer_shapes_full(
        {"data": (batch, 3, 224, 224)})
    nodes = net._nodes()
    fused = set(_bn_relu_peephole(net, nodes)[0])
    configs = {}
    for node in nodes:
        if node.is_variable or node.op.name != "BatchNorm":
            continue
        child, ci = node.inputs[0]
        shape = tuple(var_shape[child.name]) if child.is_variable \
            else tuple(entry[(id(child), ci)].shape)
        key = (shape, bool(node.attrs["fix_gamma"]), id(node) in fused)
        configs[key] = configs.get(key, 0) + 1
    return configs


def _cold_time_ms(fn, inputs, iters, warmup=2):
    """Device ms per call of ``fn(*inputs[i % len(inputs)])``.  The calls
    rotate over copies of the inputs (at least ``COLD_BYTES`` of them), so
    that no call finds its inputs in the 50 MB L2 cache left by the last,
    and are captured in one CUDA graph and replayed, so that the host's
    time to launch them (some 50 us a call through a Python wrapper, more
    than a small BatchNorm takes on the card) does not hide the card's."""
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / iters


def parent_bn_library(path):
    """The BatchNorm kernels of the port before the resident path (a copy
    of that ``csrc/batch_norm.cu`` at ``path``), built into
    ``build/bn_parent/``; None when there is no such copy."""
    if not path or not os.path.exists(path):
        print("parent BatchNorm kernels: no source at %s, not measured"
              % path, flush=True)
        return None
    from mxnet_tpu_torch import _kernels

    with open(path) as f:
        text = f.read()
    return _kernels.build_variants("bn_parent", [("parent", text)])["parent"]


@contextlib.contextmanager
def bn_library(bnk, lib):
    """Within the block the K1/K2 wrappers launch from ``lib``, a library
    with the same C interface."""
    kernels = bnk._kernels
    bnk._kernels = types.SimpleNamespace(load=lambda name: lib)
    try:
        yield
    finally:
        bnk._kernels = kernels


def _plan_text(plan):
    if plan["path"] == "chunked":
        return "chunked (%d blocks)" % plan["clusters"]
    return ("resident: %d clusters of %d CTA(s) (%d at once), %d "
            "channel(s) of %d strips and %d KB of shared memory a CTA"
            % (plan["clusters"], plan["ctas_per_cluster"],
               plan["active_clusters"], plan["channels_per_cta"],
               plan["strips_per_cta"], plan["smem_bytes"] // 1024))


def bn_step_total(rows, key, keep=lambda r: True):
    """``row[key]`` times the row's BatchNorms per step, summed over the
    rows ``keep`` admits; None when one of them was not measured."""
    vals = [(r[key], r["count"]) for r in rows if keep(r)]
    if any(v is None for v, _ in vals):
        return None
    return sum(v * n for v, n in vals)


def bn_kernel_phase(bnk, dev, seed, configs, parent_lib=None):
    """K1 and K2 against their plain versions at every BatchNorm input of
    the step, timed with the L2 cold beside the library calls and, when
    ``parent_lib`` is given, the kernels before the resident path under
    the same timer; returns one row per config and the step totals."""
    rows = []
    eps = 2e-5
    for (shape, fix_gamma, relu), count in sorted(
            configs.items(), key=lambda kv: -math.prod(kv[0][0])):
        gen = torch.Generator(device=dev).manual_seed(seed)
        c = shape[1]
        if shape[1] == 3:  # bn_data sees raw pixels: mean >> std
            x = torch.rand(shape, generator=gen, device=dev) * 255
        else:
            x = torch.randn(shape, generator=gen, device=dev)
        g = torch.randn(shape, generator=gen, device=dev)
        gamma = torch.rand(c, generator=gen, device=dev) + 0.5
        beta = torch.randn(c, generator=gen, device=dev)
        y, mean, var = bnk.bn_fwd_cuda(x, gamma, beta, eps, fix_gamma, relu)
        torch.cuda.synchronize()
        plain = bnk.bn_fwd_plain(x, gamma, beta, eps, fix_gamma, relu)
        fwd_errs = [_scaled_err(a, b) for a, b in zip((y, mean, var), plain)]
        dx, dg, db = bnk.bn_bwd_cuda(x, g, mean, var, gamma, beta, eps,
                                     fix_gamma, relu)
        torch.cuda.synchronize()
        plain = bnk.bn_bwd_plain(x, g, mean, var, gamma, beta, eps,
                                 fix_gamma, relu)
        bwd_errs = [_scaled_err(a, b) for a, b in zip((dx, dg, db), plain)]
        for name, errs in (("K1", fwd_errs), ("K2", bwd_errs)):
            if max(e[1] for e in errs) > 1e-4:
                raise RuntimeError("%s disagrees with its plain version at "
                                   "%s: %s" % (name, shape, errs))
        del y, dx, plain
        n = x.numel()
        s = n // (shape[0] * c)
        plans = [bnk.bn_plan(shape[0], c, s, bwd, dev) for bwd in (0, 1)]
        # copies of x and g (clones: the saved statistics hold for each)
        copies = [(x, g)] + [(x.clone(), g.clone()) for _ in range(
            math.ceil(COLD_BYTES / x.nbytes) - 1)]
        iters = max(2 * len(copies), 10 if n > 20e6 else 30)
        invstd = 1.0 / torch.sqrt(var + eps)
        fwd_args = [(xc,) for xc, _ in copies]
        bwd_args = copies

        def k1(xc):
            return bnk.bn_fwd_cuda(xc, gamma, beta, eps, fix_gamma, relu)

        def k2(xc, gc):
            return bnk.bn_bwd_cuda(xc, gc, mean, var, gamma, beta, eps,
                                   fix_gamma, relu)

        def fwd_lib(xc):
            return F.batch_norm(xc, None, None, gamma, beta, training=True,
                                eps=eps)

        def bwd_lib(xc, gc):
            return torch.ops.aten.native_batch_norm_backward(
                gc, xc, gamma, None, None, mean, invstd, True, eps,
                [True, True, True])

        # kernel, parent, library, library, parent, kernel: the mean of
        # each pair, so a drift of the clock falls on all three alike
        times = {}
        order = ["new", "parent", "lib"] if parent_lib is not None \
            else ["new", "lib"]
        for who in order + order[::-1]:
            for kind, kernel, lib, args in (("fwd", k1, fwd_lib, fwd_args),
                                            ("bwd", k2, bwd_lib, bwd_args)):
                if who == "lib":
                    t = _cold_time_ms(lib, args, iters)
                elif who == "parent":
                    with bn_library(bnk, parent_lib):
                        t = _cold_time_ms(kernel, args, iters)
                else:
                    t = _cold_time_ms(kernel, args, iters)
                times.setdefault((kind, who), []).append(t)
        times = {k: sum(v) / len(v) for k, v in times.items()}
        fwd_plain = _time_ms(lambda: bnk.bn_fwd_plain(
            x, gamma, beta, eps, fix_gamma, relu), 3, warmup=1)
        bwd_plain = _time_ms(lambda: bnk.bn_bwd_plain(
            x, g, mean, var, gamma, beta, eps, fix_gamma, relu), 3, warmup=1)
        # bytes: K1 reads x once and writes y once, K2 reads x and g once
        # and writes dx once (the (C,) vectors are noise); operations:
        # about 8 per element in each, far below the 67 TFLOP/s f32 peak
        fwd_bound = max(8.0 * n / PEAK_BYTES, 8.0 * n / PEAK_F32_FLOPS) * 1e3
        bwd_bound = max(12.0 * n / PEAK_BYTES, 12.0 * n / PEAK_F32_FLOPS) \
            * 1e3
        row = dict(shape=shape, fix_gamma=fix_gamma, relu=relu, count=count,
                   fwd_err=max(e[0] for e in fwd_errs),
                   bwd_err=max(e[0] for e in bwd_errs),
                   fwd_ms=times[("fwd", "new")], fwd_plain_ms=fwd_plain,
                   fwd_library_ms=times[("fwd", "lib")],
                   fwd_parent_ms=times.get(("fwd", "parent")),
                   fwd_bound_ms=fwd_bound,
                   bwd_ms=times[("bwd", "new")], bwd_plain_ms=bwd_plain,
                   bwd_library_ms=times[("bwd", "lib")],
                   bwd_parent_ms=times.get(("bwd", "parent")),
                   bwd_bound_ms=bwd_bound)
        rows.append(row)

        def parent(kind):
            t = row[kind + "_parent_ms"]
            return "not measured" if t is None else "%.4f" % t

        print("kernel batch_norm %s fix_gamma=%s relu=%s (x%d per step; "
              "L2 cold: %d copies of the inputs): K1 %.4f ms (bound %.4f, "
              "%.0f%% of 3.35 TB/s), parent %s, plain %.4f, F.batch_norm "
              "%.4f; K2 %.4f ms (bound %.4f, %.0f%%), parent %s, plain "
              "%.4f, native_batch_norm_backward %.4f; max_abs_err K1 %.3g "
              "K2 %.3g (scaled %.2g / %.2g); plan K1 %s; K2 %s"
              % (shape, fix_gamma, relu, count, len(copies), row["fwd_ms"],
                 fwd_bound, 100 * fwd_bound / row["fwd_ms"], parent("fwd"),
                 fwd_plain, row["fwd_library_ms"], row["bwd_ms"], bwd_bound,
                 100 * bwd_bound / row["bwd_ms"], parent("bwd"), bwd_plain,
                 row["bwd_library_ms"], row["fwd_err"], row["bwd_err"],
                 max(e[1] for e in fwd_errs), max(e[1] for e in bwd_errs),
                 _plan_text(plans[0]), _plan_text(plans[1])), flush=True)
        del x, g, copies, fwd_args, bwd_args
    torch.cuda.empty_cache()

    def step_total(key, keep=lambda r: True):
        return bn_step_total(rows, key, keep)

    def not_data(r):
        return r["shape"][1] != 3

    totals = {}
    for kind in ("fwd", "bwd"):
        totals[kind] = dict(
            max_abs_err=max(r[kind + "_err"] for r in rows),
            ms=step_total(kind + "_ms"),
            plain_ms=step_total(kind + "_plain_ms"),
            bound_ms=step_total(kind + "_bound_ms"), bound_by="bytes",
            library_ms=step_total(kind + "_library_ms"))
        for keep, what in ((lambda r: True, "the %d BatchNorms of one b%d "
                            "step" % (sum(r["count"] for r in rows),
                                      TRAIN_BATCH)),
                           (not_data, "the %d BatchNorms outside bn_data"
                            % sum(r["count"] for r in rows if not_data(r)))):
            parent = step_total(kind + "_parent_ms", keep)
            print("kernel batch_norm %s, summed over %s: kernel %.3f ms, "
                  "bound %.3f ms, parent %s, plain %.3f ms, library %.3f ms"
                  % ("K1" if kind == "fwd" else "K2", what,
                     step_total(kind + "_ms", keep),
                     step_total(kind + "_bound_ms", keep),
                     "not measured" if parent is None else "%.3f ms" % parent,
                     step_total(kind + "_plain_ms", keep),
                     step_total(kind + "_library_ms", keep)), flush=True)
    return rows, totals


def _resnet50_module(mx, ctx=None):
    net = mx.models.get_symbol("resnet", num_classes=1000, num_layers=50,
                               image_shape="3,224,224")
    return mx.mod.Module(net) if ctx is None \
        else mx.mod.Module(net, context=ctx)


def resnet50_data(seed, steps):
    """The training phases' ``steps`` synthetic b128 batches, as numpy."""
    rng = np.random.default_rng(seed)
    n = steps * TRAIN_BATCH
    x = rng.standard_normal((n, 3, 224, 224), dtype=np.float32)
    y = rng.integers(0, 1000, n).astype(np.float32)
    return x, y


def training_phase(mx, bnk, seed, steps, bn_totals):
    """Module.fit on full-width ResNet-50 at b128 on the card."""
    x, y = resnet50_data(seed, steps)
    it = mx.io.NDArrayIter(x, y, batch_size=TRAIN_BATCH)
    mod = _resnet50_module(mx)
    metric = mx.metric.CompositeEvalMetric(
        [mx.metric.Accuracy(), mx.metric.TopKAccuracy(top_k=5)])
    sched = mx.lr_scheduler.MultiFactorScheduler(step=[steps // 2],
                                                 factor=0.1)
    speed = mx.callback.Speedometer(TRAIN_BATCH, frequent=1)
    events = []

    def mark(_param):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    # -- the main path: counts from 0, fit over `steps` batches --
    mx.init.seed(seed)
    bnk.bn_fwd_cuda.launches = 0
    bnk.bn_bwd_cuda.launches = 0
    start.record()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, eval_metric=metric, kvstore="local",
            batch_end_callback=[speed, mark], optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-4, "lr_scheduler": sched},
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = (bnk.bn_fwd_cuda.launches, bnk.bn_bwd_cuda.launches)
    # -- end of the main path --
    params = mx.convert.module_params_to_numpy(mod)[0]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [start.elapsed_time(events[0])] + [
        a.elapsed_time(b) for a, b in zip(events, events[1:])]
    steady = float(np.median(step_ms[1:]))
    names_vals = dict(metric.get_name_value())
    print("training ResNet-50 b%d f32 on the card: fit of %d steps %.2f s "
          "(init and bind included); step ms (CUDA events between batch "
          "ends) %s; median after the first %.2f ms = %.1f images/s; "
          "Speedometer %s images/s; metrics %s; lr after %d updates %.4g; "
          "peak memory allocated %.2f GB"
          % (TRAIN_BATCH, steps, fit_s, ["%.2f" % t for t in step_ms],
             steady, TRAIN_BATCH / steady * 1e3,
             ["%.1f" % v for v in speed.speeds], names_vals,
             mod._optimizer.num_update, mod._optimizer._get_lr(0), peak_gb),
          flush=True)
    if launches != (51 * steps, 51 * steps):
        raise RuntimeError("K1/K2 launched %s times in %d steps, expected "
                           "51 each per step" % (launches, steps))
    print("training K1 launches %d, K2 launches %d: %d and %d per step"
          % (launches + (launches[0] // steps, launches[1] // steps)),
          flush=True)
    share = (bn_totals["fwd"]["ms"] + bn_totals["bwd"]["ms"]) / steady
    print("training K1+K2 share of the step from the kernel-phase times: "
          "%.3f ms of %.2f ms = %.1f%%" % (
              bn_totals["fwd"]["ms"] + bn_totals["bwd"]["ms"], steady,
              100 * share), flush=True)
    arg, aux = mod.get_params()
    bad = [k for k, v in list(arg.items()) + list(aux.items())
           if not torch.isfinite(v._t).all()]
    if bad or not all(0 <= v <= 1 for v in names_vals.values()):
        raise RuntimeError("training produced non-finite params %s or "
                           "metrics %s" % (bad[:5], names_vals))
    # host-to-device copy of one b128 batch, as Module._load_io makes it
    it.reset()
    batch = next(it)
    src, dst = batch.data[0], mod._exec.arg_dict["data"]
    copy_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mod._load_io(["data"], [src])
        torch.cuda.synchronize()
        copy_s.append(time.perf_counter() - t)
    pinned = src._t.pin_memory()
    pin_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        dst._t.copy_(pinned, non_blocking=True)
        torch.cuda.synchronize()
        pin_s.append(time.perf_counter() - t)
    nbytes = src._t.numel() * 4
    print("training host-to-device batch copy (%.1f MB): %.2f ms from "
          "pageable memory (%.2f GB/s, median of 5; the port's path), "
          "%.2f ms from pinned memory (%.2f GB/s, not used by the port)"
          % (nbytes / 1e6, np.median(copy_s) * 1e3,
             nbytes / np.median(copy_s) / 1e9, np.median(pin_s) * 1e3,
             nbytes / np.median(pin_s) / 1e9), flush=True)
    idle = profile_step(mod, batch, steady)
    checked_step(mod, batch, bnk)
    del mod, it, x
    torch.cuda.empty_cache()
    return launches, dict(step_ms=steady, peak_gb=peak_gb, idle=idle,
                          copy_ms=float(np.median(copy_s) * 1e3),
                          params=params)


def profile_step(mod, batch, steady_ms):
    """One more step under torch.profiler: device time by kernel.  A step
    that fails fails the phase; a profiler that records no device time is
    reported as not measured."""
    from torch.profiler import ProfilerActivity, profile

    mod.forward_backward(batch)
    mod.update()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages() if dev_us(e) > 0
               and e.device_type.name == "CUDA"]
    total = sum(dev_us(e) for e in kernels) / 1e3
    if total <= 0:
        print("profile: the profiler recorded no device time (not "
              "measured)", flush=True)
        return None

    def is_bn(k):
        return "bn_fwd_" in k or "bn_bwd_" in k

    bn = sum(dev_us(e) for e in kernels if is_bn(e.key)) / 1e3
    print("profile of one step (wall %.2f ms under the profiler, "
          "steady step %.2f ms): device busy %.2f ms (idle share %.1f%% "
          "of the profiled wall time), K1+K2 kernels %.2f ms (%.1f%% of "
          "device time)" % (wall, steady_ms, total,
                            100 * max(0.0, 1 - total / wall), bn,
                            100 * bn / total), flush=True)
    groups = {}
    rules = (("bn_* (K1/K2)", is_bn),
             ("convolution (cuDNN)", lambda k: any(w in k for w in (
                 "conv", "cudnn", "implicit_gemm", "wgrad", "dgrad",
                 "fprop", "winograd", "fft", "gemm_cf32"))),
             ("memcpy", lambda k: "memcpy" in k),
             ("optimizer (foreach)", lambda k: "multi_tensor" in k
              or "foreach" in k),
             ("pooling", lambda k: "pool" in k),
             ("gemm", lambda k: "gemm" in k),
             ("add", lambda k: "add" in k))
    for e in kernels:
        k = e.key.lower()
        name = next((n for n, test in rules if test(k)), "other")
        groups[name] = groups.get(name, 0.0) + dev_us(e) / 1e3
    print("profile device time by group: %s" % ", ".join(
        "%s %.2f ms (%.1f%%)" % (k, v, 100 * v / total)
        for k, v in sorted(groups.items(), key=lambda kv: -kv[1])),
        flush=True)
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    for e in top:
        print("profile  %8.3f ms  x%-4d %s" % (dev_us(e) / 1e3, e.count,
                                               e.key[:110]), flush=True)
    return max(0.0, 1 - total / wall)


# -- the sync-free training loop (phase 7b) -----------------------------------
SYNC_FREE_ENV = {"MXNET_FUSE_TRAIN_STEP": "1", "MXNET_BULK_TRAIN_STEPS": "2"}
BULK_K = 2


@contextlib.contextmanager
def environment(values):
    """``os.environ`` with ``values`` set (``None``: removed) within the
    block, as it was afterwards."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def bn_plain_refused(bnk):
    """Within the block the plain BatchNorm versions raise on CUDA
    tensors: the card's path must take K1 and K2."""
    saved = {k: getattr(bnk, k) for k in ("bn_fwd_plain", "bn_bwd_plain")}

    def refuse(name):
        def plain(x, *args, **kw):
            if x.is_cuda:
                raise RuntimeError("%s called on the card" % name)
            return saved[name](x, *args, **kw)
        return plain

    for k in saved:
        setattr(bnk, k, refuse(k))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(bnk, k, v)


def _bn_kernel_runs(prof):
    """Executions of K1/K2's CUDA kernels in a profile."""
    return sum(e.count for e in prof.key_averages()
               if "bn_fwd_" in e.key or "bn_bwd_" in e.key)


def _profile_pad(dev):
    """A few tiny kernels, synchronized, at the start of a profile, to
    keep the start of the window away from the step: in one run both
    profiles of a step counted 108 of the plan's 110 K1/K2 kernels
    (unexplained)."""
    pad = torch.zeros(1, device=dev)
    for _ in range(20):
        pad.add_(1)
    torch.cuda.synchronize()


def _recording_metric(mx, base):
    """A DeviceMetric that also keeps a device copy of every batch's
    labels and outputs (no host copy), to hold its values against the
    host metric's on the same outputs afterwards."""
    class Recording(mx.metric.DeviceMetric):
        def __init__(self, metric):
            super().__init__(metric)
            self.seen = []

        def update(self, labels, preds, skip=None):
            super().update(labels, preds, skip)
            self.seen.append(([mx.metric._tensor(t).clone() for t in labels],
                              [mx.metric._tensor(t).clone() for t in preds]))

    return Recording(base)


def _resnet50_params(mx, seed, x, y, steps, lr_chunk):
    """Final (arg, aux) of a classic fit of ResNet-50 b128 over ``x``,
    ``y`` from the training phase's seeded init and settings, except
    that each step takes the lr of the last update of its chunk of
    ``lr_chunk`` (the rule ``run_bulk`` follows)."""
    class ChunkLastLR(mx.lr_scheduler.MultiFactorScheduler):
        def __call__(self, num_update):
            return super().__call__(-(-num_update // lr_chunk) * lr_chunk)

    mod = _resnet50_module(mx)
    mx.init.seed(seed)
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=TRAIN_BATCH), num_epoch=1,
            optimizer="sgd", optimizer_params={
                "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
                "lr_scheduler": ChunkLastLR(step=[steps // 2], factor=0.1)},
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2))
    out = mx.convert.module_params_to_numpy(mod)
    del mod
    torch.cuda.empty_cache()
    return out


def _device_timeline(prof):
    """From the device events of a profile: ``span`` (ms from the first
    kernel's start to the last kernel's end), ``busy`` (ms in which a
    kernel ran), ``idle`` (1 - busy / span), and for the host-to-device
    copies of more than 1 MB: their number, ``copy_ms`` and ``covered``,
    the share of their time during which a kernel ran.  None without
    device events.  Kernels launched before the profile opened are not
    recorded, so the window should open on an idle card."""
    copies, kernels = [], []
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        span = (e.time_range.start, e.time_range.end)
        if "Memcpy" in e.name or "Memset" in e.name:
            if "HtoD" in e.name and span[1] - span[0] > 100:
                copies.append(span)
        else:
            kernels.append(span)
    if not kernels:
        return None
    kernels.sort()
    merged = []
    for a, b in kernels:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    span = merged[-1][1] - merged[0][0]
    copy_us = sum(b - a for a, b in copies)
    covered = sum(max(0.0, min(b, kb) - max(a, ka))
                  for a, b in copies for ka, kb in merged)
    return dict(span=span / 1e3, busy=busy / 1e3,
                idle=max(0.0, 1 - busy / span), copies=len(copies),
                copy_ms=copy_us / 1e3,
                covered=covered / copy_us if copy_us else 0.0)


def sync_free_phase(mx, bnk, seed, steps, classic):
    """``Module.fit`` of the same ResNet-50 b128 over the same batches,
    with the sync-free loop: the fused step captured as a CUDA graph
    (``MXNET_FUSE_TRAIN_STEP=1``), chunks of two steps (``run_bulk``,
    ``MXNET_BULK_TRAIN_STEPS=2``), batches copied by a
    ``DevicePrefetchIter`` (``prefetch_to_device=True``) and the metric
    kept on the card (``DeviceMetric``, read by a ``Speedometer`` every 3
    batches).  Checks: replays are the steps after the first; K1 and K2
    launch 51 times a step by counter, and a replayed step runs as many
    of their kernels as an eager step by the profiler; no plain version
    runs; the parameters match a classic fit from the same init within 3x
    the floor of the same fit on an input perturbed by 1e-7 (the classic
    fits take the lr of each chunk's last update, the ``run_bulk`` rule;
    the training phase's own fit, with the per-step lr, is printed
    beside them); the device metric equals the host metric on the same
    outputs.  Returns the step time and the per-tensor floor."""
    x, y = resnet50_data(seed, steps)
    rng = np.random.default_rng(seed + 7)
    xp = (x * (1 + 1e-7 * rng.standard_normal(x.shape, dtype=np.float32))
          ).astype(np.float32)
    twin = _resnet50_params(mx, seed, x, y, steps, BULK_K)
    floor_run = _resnet50_params(mx, seed, xp, y, steps, BULK_K)
    del xp

    it = mx.io.NDArrayIter(x, y, batch_size=TRAIN_BATCH)
    mod = _resnet50_module(mx)
    metric = _recording_metric(mx, mx.metric.CompositeEvalMetric(
        [mx.metric.Accuracy(), mx.metric.TopKAccuracy(top_k=5)]))
    sched = mx.lr_scheduler.MultiFactorScheduler(step=[steps // 2],
                                                 factor=0.1)
    speed = mx.callback.Speedometer(TRAIN_BATCH, frequent=3)
    events = []

    def mark(_param):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    with environment(SYNC_FREE_ENV), bn_plain_refused(bnk):
        mx.init.seed(seed)
        # -- the main path: counts from 0, fit over `steps` batches --
        bnk.bn_fwd_cuda.launches = 0
        bnk.bn_bwd_cuda.launches = 0
        start.record()
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, eval_metric=metric, kvstore="local",
                batch_end_callback=[speed, mark], optimizer="sgd",
                prefetch_to_device=True,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 1e-4, "lr_scheduler": sched},
                initializer=mx.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = (bnk.bn_fwd_cuda.launches, bnk.bn_bwd_cuda.launches)
        # -- end of the main path --
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    ex = mod._exec
    chunk_ms = [start.elapsed_time(events[BULK_K - 1])] + [
        events[i - BULK_K].elapsed_time(events[i])
        for i in range(2 * BULK_K - 1, len(events), BULK_K)]
    steady = float(np.median(chunk_ms[1:])) / BULK_K
    syncs = metric.sync_count
    names_vals = dict(metric.get_name_value())
    print("sync-free ResNet-50 b%d f32 on the card (fused step as a CUDA "
          "graph, run_bulk chunks of %d, device prefetch, device metric): "
          "fit of %d steps %.2f s (init and bind included); chunk ms (CUDA "
          "events between chunk ends) %s, the first with the warm-up step, "
          "the capture (%.1f ms of host time) and one replay, so the first "
          "step took %.2f ms; step %.2f ms after the "
          "first chunk = %.1f images/s (classic %.2f ms = %.1f images/s); "
          "graph replays %d; DeviceMetric syncs in the epoch %d; metrics "
          "%s; peak memory allocated %.2f GB (classic %.2f GB), reserved "
          "%.2f GB"
          % (TRAIN_BATCH, BULK_K, steps, fit_s, ["%.2f" % t for t in chunk_ms],
             ex.capture_seconds * 1e3, chunk_ms[0] - steady, steady,
             TRAIN_BATCH / steady * 1e3,
             classic["step_ms"], TRAIN_BATCH / classic["step_ms"] * 1e3,
             ex.graph_replays, syncs, names_vals, peak_gb,
             classic["peak_gb"], reserved_gb), flush=True)
    if ex.graph_replays != steps - 1:
        raise RuntimeError("the captured step replayed %d times in %d "
                           "steps, expected %d" % (ex.graph_replays, steps,
                                                   steps - 1))
    if launches != (51 * steps, 51 * steps):
        raise RuntimeError("sync-free K1/K2 launched %s times in %d steps, "
                           "expected 51 each per step" % (launches, steps))
    print("sync-free K1 launches %d, K2 launches %d: %d and %d per step "
          "(the warm-up step's and %d replays of the 51 the capture "
          "recorded)" % (launches + (launches[0] // steps,
                                     launches[1] // steps, ex.graph_replays)),
          flush=True)

    # the device metric against the host metric on the same outputs
    host = mx.metric.CompositeEvalMetric(
        [mx.metric.Accuracy(), mx.metric.TopKAccuracy(top_k=5)])
    for labels, preds in metric.seen:
        host.update([mx.nd.NDArray(t) for t in labels],
                    [mx.nd.NDArray(t) for t in preds])
    host_vals = dict(host.get_name_value())
    print("sync-free DeviceMetric %s, host metric on the same %d batches "
          "of outputs %s" % (names_vals, len(metric.seen), host_vals),
          flush=True)
    if names_vals != host_vals:
        raise RuntimeError("DeviceMetric %s != host metric %s"
                           % (names_vals, host_vals))

    # parameters against the classic twin, within 3x its perturbed floor
    arg, aux = mx.convert.module_params_to_numpy(mod)
    got = dict(arg, **{"aux:" + k: v for k, v in aux.items()})
    want = dict(twin[0], **{"aux:" + k: v for k, v in twin[1].items()})
    pert = dict(floor_run[0],
                **{"aux:" + k: v for k, v in floor_run[1].items()})
    names = sorted(want)
    dist = np.array([np.linalg.norm(got[k] - want[k]) for k in names])
    floor = np.array([np.linalg.norm(pert[k] - want[k]) for k in names])
    ratio = dist / np.maximum(floor, 1e-30)
    worst = int(np.argmax(ratio))
    identical = all(np.array_equal(got[k], want[k]) for k in names)
    phase7 = classic.get("params")
    vs7 = "not measured" if phase7 is None else "%.3g" % (
        math.sqrt(sum(float(np.sum((got[k] - phase7[k]) ** 2))
                      for k in phase7))
        / math.sqrt(sum(float(np.sum(v ** 2)) for v in phase7.values())))
    print("sync-free parameters against the classic fit from the same init "
          "with the run_bulk lr: bit-identical %s; per tensor, distance "
          "over the floor (the classic fit on an input perturbed by 1e-7): "
          "median %.3g, worst %.3g at %s (limit 3); against the training "
          "phase's fit (lr per step, so step 3 takes 0.1 there and 0.01 "
          "here): relative distance %s (not bounded)"
          % (identical, float(np.median(ratio)), ratio[worst], names[worst],
             vs7), flush=True)
    if not identical and not ratio[worst] <= 3:
        raise RuntimeError("sync-free and classic parameters of %s differ "
                           "beyond 3x the f32 floor: %.3g vs %.3g" % (
                               names[worst], dist[worst], floor[worst]))
    bad = [k for k, v in got.items() if not np.isfinite(v).all()]
    if bad or not all(0 <= v <= 1 for v in names_vals.values()):
        raise RuntimeError("sync-free training produced non-finite params "
                           "%s or metrics %s" % (bad[:5], names_vals))
    del twin, floor_run, want, pert, got, arg, aux
    sync_free_profiles(mx, bnk, mod, x, y)
    del mod, it, x
    torch.cuda.empty_cache()
    return dict(step_ms=steady, floor=dict(zip(names, floor)))


def sync_free_profiles(mx, bnk, mod, x, y):
    """After the main path: (1) one eager and one replayed step on the
    same module, each under torch.profiler: the replay must run as many
    K1/K2 kernels as the eager step (51 calls: 49 resident, one kernel
    each, and 2 chunked, three each, a direction); (2) one more epoch of
    the main path's ``fit`` (the same switches, prefetch, device metric
    and Speedometer; the graph is captured, so every step replays),
    profiled from an idle card: the device's idle share between its
    first and last kernel, and how much of the host-to-device copies of
    the batches ran while kernels of the steps ran."""
    from torch.profiler import ProfilerActivity, profile

    it = mx.io.NDArrayIter(x, y, batch_size=TRAIN_BATCH)
    batch = next(it)
    dev_batch = mx.io.DataBatch(
        data=[mx.nd.NDArray(batch.data[0]._t.cuda())],
        label=[mx.nd.NDArray(batch.label[0]._t.cuda())])
    runs = {}
    for name, fused in (("eager", "0"), ("replayed", "1")):
        with environment({"MXNET_FUSE_TRAIN_STEP": fused}):
            before = mod._exec.graph_replays
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _profile_pad(dev_batch.data[0]._t.device)
                mod.forward_backward(dev_batch)
                mod.update()
                torch.cuda.synchronize()
            runs[name] = (_bn_kernel_runs(prof),
                          mod._exec.graph_replays - before)
    print("sync-free profile: K1/K2 kernel executions in one eager step %d, "
          "in one replayed step %d (replays in that step %d; the plan "
          "gives 110: 49 resident calls of one kernel and 2 chunked of "
          "three, each direction)" % (runs["eager"][0], runs["replayed"][0],
                                      runs["replayed"][1]), flush=True)
    if runs["replayed"][1] != 1 or runs["replayed"][0] != runs["eager"][0] \
            or runs["eager"][0] == 0:
        raise RuntimeError("the replayed step ran %s K1/K2 kernels, the "
                           "eager step %s" % (runs["replayed"],
                                              runs["eager"]))

    it.reset()
    metric = mx.metric.CompositeEvalMetric(
        [mx.metric.Accuracy(), mx.metric.TopKAccuracy(top_k=5)])
    speed = mx.callback.Speedometer(TRAIN_BATCH, frequent=3)
    events = []

    def mark(_param):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    start = torch.cuda.Event(enable_timing=True)
    before = mod._exec.graph_replays
    with environment(SYNC_FREE_ENV), bn_plain_refused(bnk):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            t = time.perf_counter()
            # bound, initialized and with its optimizer: fit goes on
            # training the same module, as a second epoch
            mod.fit(it, num_epoch=1, eval_metric=metric, kvstore="local",
                    batch_end_callback=[speed, mark],
                    prefetch_to_device=True)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
    replays = mod._exec.graph_replays - before
    steps = len(events)
    chunk_ms = [start.elapsed_time(events[BULK_K - 1])] + [
        events[i - BULK_K].elapsed_time(events[i])
        for i in range(2 * BULK_K - 1, steps, BULK_K)]
    # a batch pinned, then copied on a side stream
    t_host = time.perf_counter()
    host = batch.data[0]._t.pin_memory()
    pin_ms = (time.perf_counter() - t_host) * 1e3
    stream = torch.cuda.Stream()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.cuda.stream(stream):
        ev[0].record(stream)
        host.to("cuda", non_blocking=True)
        ev[1].record(stream)
    torch.cuda.synchronize()
    copy_ms = ev[0].elapsed_time(ev[1])
    if replays != steps:
        raise RuntimeError("the profiled fit replayed %d times in %d steps"
                           % (replays, steps))
    timeline = _device_timeline(prof)
    if timeline is None:
        print("sync-free profile: the profiler recorded no device time "
              "(not measured)", flush=True)
        return
    print("sync-free profile of a second fit epoch (%d steps, all replays, "
          "chunks of %d, device prefetch, device metric read by the "
          "Speedometer every 3 batches; from an idle card): wall %.2f ms "
          "under the profiler (fit's set-up and end of epoch included); "
          "chunk ms (CUDA events between chunk ends, the first from the "
          "fit's start) %s; from the first kernel to the last %.2f ms, "
          "kernels busy %.2f ms (%.2f ms a step), idle share %.1f%%; %d "
          "host-to-device batch copies on the prefetch's side stream, "
          "%.2f ms in all, %.1f%% of the copy time under kernels of the "
          "steps (the first batch's copy comes before any kernel); one b%d "
          "batch pinned in %.2f ms (host clock) and copied from pinned "
          "memory in %.2f ms (CUDA events)"
          % (steps, BULK_K, wall, ["%.2f" % c for c in chunk_ms],
             timeline["span"], timeline["busy"], timeline["busy"] / steps,
             100 * timeline["idle"], timeline["copies"],
             timeline["copy_ms"], 100 * timeline["covered"], TRAIN_BATCH,
             pin_ms, copy_ms), flush=True)


# -- checkpoint and resume (phase 7c) -----------------------------------------
#: snapshot cadence of the checkpointed fits, and the batch of the SIGTERM
#: (the end of the second chunk of two)
CKPT_EVERY, CKPT_KILL_AT, CKPT_EPOCHS = 2, 3, 2


@contextlib.contextmanager
def _patched(obj, name, wrap):
    """``obj.name`` replaced by ``wrap(original)`` within the block."""
    real = getattr(obj, name)
    setattr(obj, name, wrap(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def _module_state(mx, mod):
    """Parameters, auxiliary states and momenta of a module, as numpy."""
    arg, aux = mx.convert.module_params_to_numpy(mod)
    out = dict(arg, **{"aux:" + k: v for k, v in aux.items()})
    out.update({"mom:%d" % i: s.asnumpy()
                for i, s in mod._updater.states.items() if s is not None})
    return out


def _chunk_ms(start, events):
    """ms between chunk ends (CUDA events at batch ends), the first chunk
    from ``start``."""
    ends = [events[i] for i in range(BULK_K - 1, len(events), BULK_K)]
    return [start.elapsed_time(ends[0])] + [
        a.elapsed_time(b) for a, b in zip(ends, ends[1:])]


def checkpoint_phase(mx, bnk, seed, steps, sync_free):
    """Checkpoints and resume of the sync-free ResNet-50 b128 ``fit``
    (phase 7b's settings: captured step, chunks of two, device prefetch,
    device metric) over two epochs of the same ``steps`` batches, with a
    snapshot every ``CKPT_EVERY`` batches written by the async writer:
    fits A and A' run through; fit B is stopped by a SIGTERM at batch
    ``CKPT_KILL_AT`` and leaves a generation equal to its arrays; fit C,
    a new Module, resumes it with ``resume="auto"`` (its captured step
    replayed in every step after its first, 51 K1 and 51 K2 launches a
    step, no plain BatchNorm on the card); fit D is ``Module.load`` of
    A's epoch-1 checkpoint with its optimizer states, trained one more
    epoch.  C and D must end within 3x (the distance between A and A'
    plus phase 7b's floor) of A, per tensor, and equal A bit for bit
    where A and A' agree bit for bit."""
    import shutil
    import signal

    from mxnet_tpu_torch import checkpoint as ck
    from mxnet_tpu_torch.module import base_module as bm

    x, y = resnet50_data(seed, steps)
    loop_ms, writes = [], []
    parts = {"copies": [], "metric": [], "iterator": [], "epoch_save": []}

    def timed(sink):
        def wrap(real):
            def call(*a, **kw):
                t = time.perf_counter()
                try:
                    return real(*a, **kw)
                finally:
                    sink.append((time.perf_counter() - t) * 1e3)
            return call
        return wrap

    def timed_after_batch(real):
        def after_batch(run, module, epoch, nbatch, *a, **kw):
            t = time.perf_counter()
            try:
                return real(run, module, epoch, nbatch, *a, **kw)
            finally:
                if (nbatch + 1) % run.every_n == 0:
                    loop_ms.append((time.perf_counter() - t) * 1e3)
        return after_batch

    def timed_write(real):
        def write_snapshot(prefix, snap, *a, **kw):
            t = time.perf_counter()
            path = real(prefix, snap, *a, **kw)
            secs = time.perf_counter() - t
            size = sum(os.path.getsize(path[:-len("params")] + kind)
                       for kind in ("params", "states"))
            writes.append((secs, size / 1e6))
            return path
        return write_snapshot

    def fit(prefix, mod=None, kill_at=None, resume=None, begin_epoch=0,
            every_n=CKPT_EVERY, opt_extra=None):
        mod = mod or _resnet50_module(mx)
        metric = mx.metric.CompositeEvalMetric(
            [mx.metric.Accuracy(), mx.metric.TopKAccuracy(top_k=5)])
        events = []

        def mark(param):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            if param.nbatch == kill_at and param.epoch == 0:
                if not isinstance(signal.getsignal(signal.SIGTERM),
                                  bm._PreemptGuard):
                    raise RuntimeError("fit holds no SIGTERM handler")
                signal.raise_signal(signal.SIGTERM)

        opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
               "lr_scheduler": mx.lr_scheduler.MultiFactorScheduler(
                   step=[steps // 2], factor=0.1)}
        opt.update(opt_extra or {})
        start = torch.cuda.Event(enable_timing=True)
        preempted = None
        with environment(SYNC_FREE_ENV), bn_plain_refused(bnk):
            mx.init.seed(seed)
            # -- the main path: counts from 0, the fit --
            bnk.bn_fwd_cuda.launches = 0
            bnk.bn_bwd_cuda.launches = 0
            start.record()
            try:
                mod.fit(mx.io.NDArrayIter(x, y, batch_size=TRAIN_BATCH),
                        num_epoch=CKPT_EPOCHS, begin_epoch=begin_epoch,
                        eval_metric=metric, batch_end_callback=mark,
                        optimizer="sgd", optimizer_params=opt,
                        prefetch_to_device=True,
                        initializer=mx.init.Xavier(
                            rnd_type="gaussian", factor_type="in",
                            magnitude=2),
                        checkpoint_prefix=prefix, resume=resume,
                        checkpoint_every_n_batches=every_n)
            except ck.TrainingPreempted as e:
                preempted = e
            torch.cuda.synchronize()
            launches = (bnk.bn_fwd_cuda.launches, bnk.bn_bwd_cuda.launches)
            # -- end of the main path --
        return dict(mod=mod, state=_module_state(mx, mod), events=events,
                    start=start, launches=launches, preempted=preempted,
                    replays=mod._exec.graph_replays,
                    names=dict(metric.get_name_value()))

    root = tempfile.mkdtemp(prefix="mxtt-ckpt-")
    try:
        prefix = {k: os.path.join(root, k, "resnet50")
                  for k in ("A", "A2", "B")}
        for p in prefix.values():
            os.makedirs(os.path.dirname(p))
        torch.cuda.reset_peak_memory_stats()
        with _patched(bm._FitRun, "after_batch", timed_after_batch), \
                _patched(ck, "write_snapshot", timed_write):
            with _patched(mx.mod.Module, "_capture_state_arrays",
                          timed(parts["copies"])), \
                    _patched(mx.metric.DeviceMetric, "get_state",
                             timed(parts["metric"])), \
                    _patched(mx.io.PrefetchingIter, "state_dict",
                             timed(parts["iterator"])), \
                    _patched(bm.BaseModule, "_save_fit_checkpoint",
                             timed(parts["epoch_save"])):
                a = fit(prefix["A"])
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            a_loop, a_writes = list(loop_ms), list(writes)
            del a["mod"]
            torch.cuda.empty_cache()
            a2 = fit(prefix["A2"])
            del a2["mod"]
            shutil.rmtree(os.path.dirname(prefix["A2"]))
            b = fit(prefix["B"], kill_at=CKPT_KILL_AT)
        if b["preempted"] is None or b["preempted"].nbatch != CKPT_KILL_AT:
            raise RuntimeError("fit B was not preempted at batch %d: %r"
                               % (CKPT_KILL_AT, b["preempted"]))
        # B's generation, read back from its files, against B's arrays
        gen = ck.load_latest_state(prefix["B"])
        if gen is None or (gen.epoch, gen.nbatch) != (0, CKPT_KILL_AT):
            raise RuntimeError("no generation at batch %d: %s"
                               % (CKPT_KILL_AT, gen and (gen.epoch,
                                                         gen.nbatch)))
        on_disk = {k: v.asnumpy() for k, v in gen.arg_params.items()}
        on_disk.update({"aux:" + k: v.asnumpy()
                        for k, v in gen.aux_params.items()})
        on_disk.update({"mom:%d" % i: s.asnumpy() for i, s in
                        mx.optimizer.load_states(gen.states_bytes).items()
                        if s is not None})
        mismatch = [k for k in b["state"] if k not in on_disk
                    or not np.array_equal(on_disk[k], b["state"][k])]
        print("checkpoint: fit B preempted by SIGTERM at batch %d; the "
              "generation on disk (%s) holds %d arrays, %d of them "
              "momenta; bit-identical to B's arrays: %s; update count %s"
              % (CKPT_KILL_AT, os.path.basename(gen.path), len(on_disk),
                 sum(k.startswith("mom:") for k in on_disk), not mismatch,
                 gen.opt_counts["num_update"]), flush=True)
        if mismatch or len(on_disk) != len(b["state"]):
            raise RuntimeError("generation differs from fit B's arrays: %s"
                               % mismatch[:5])
        del b
        torch.cuda.empty_cache()
        c = fit(prefix["B"], resume="auto")
        steps_c = CKPT_EPOCHS * steps - (CKPT_KILL_AT + 1)
        if c["replays"] != steps_c - 1:
            raise RuntimeError("resumed fit replayed %d times in %d steps"
                               % (c["replays"], steps_c))
        if c["launches"] != (51 * steps_c, 51 * steps_c):
            raise RuntimeError("resumed fit: K1/K2 launched %s times in %d "
                               "steps, expected 51 each a step"
                               % (c["launches"], steps_c))
        c_chunks = _chunk_ms(c["start"], c["events"])
        del c["mod"]
        torch.cuda.empty_cache()
        d = fit(None, mod=mx.mod.Module.load(prefix["A"], 1,
                                             load_optimizer_states=True),
                begin_epoch=1, every_n=None,
                opt_extra={"begin_num_update": steps})
        del d["mod"]
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    floor = sync_free["floor"]
    names = sorted(floor)
    spread = np.array([np.linalg.norm(a["state"][k] - a2["state"][k])
                       for k in names])
    same = {k: np.array_equal(a["state"][k], a2["state"][k]) for k in names}
    bound = 3 * (spread + np.array([floor[k] for k in names]))
    for label, run in (("C (resume='auto' from the batch-%d snapshot)"
                        % CKPT_KILL_AT, c),
                       ("D (Module.load of the epoch-1 checkpoint)", d)):
        dist = np.array([np.linalg.norm(run["state"][k] - a["state"][k])
                         for k in names])
        exact = [np.array_equal(run["state"][k], a["state"][k])
                 for k in names]
        ratio = dist / np.maximum(bound, 1e-30)
        worst = int(np.argmax(ratio))
        print("checkpoint: fit %s against fit A: bit-identical in %d of %d "
              "tensors (A and A' in %d); distance over 3x (A-A' distance + "
              "phase 7b floor): median %.3g, worst %.3g at %s (limit 1); "
              "metrics %s (A %s)" % (label, sum(exact), len(names),
                                     sum(same.values()),
                                     float(np.median(ratio)), ratio[worst],
                                     names[worst], run["names"], a["names"]),
              flush=True)
        broken = [k for k, e in zip(names, exact) if same[k] and not e]
        if broken or not ratio[worst] <= 1:
            raise RuntimeError("fit %s differs from A: %s not bit-identical "
                               "where A and A' are; worst %s at %.3g of the "
                               "bound" % (label, broken[:5], names[worst],
                                          ratio[worst]))
    a_chunks = _chunk_ms(a["start"], a["events"])
    steady = float(np.median(a_chunks[1:])) / BULK_K
    c_steady = float(np.median(c_chunks[1:])) / BULK_K
    gens = len(a_writes)
    print("checkpoint: A, %d snapshots requested in %d steps (every %d "
          "batches, async writer), %d written: host ms on the loop per "
          "snapshot (_FitRun.after_batch) %s, of which the device copies "
          "%s, the device-metric read (a sync) %s, the iterator state %s; "
          "writer s per generation %s, MB per generation %s; epoch "
          "checkpoint (params and optimizer states, fsync'd) ms %s; step "
          "%.2f ms with snapshots (chunk ms %s) against %.2f ms without "
          "(phase 7b); peak memory allocated %.2f GB"
          % (len(a_loop), CKPT_EPOCHS * steps, CKPT_EVERY, gens,
             ["%.2f" % t for t in a_loop],
             ["%.2f" % t for t in parts["copies"]],
             ["%.2f" % t for t in parts["metric"]],
             ["%.2f" % t for t in parts["iterator"]],
             ["%.3f" % w[0] for w in a_writes],
             ["%.1f" % w[1] for w in a_writes],
             ["%.1f" % t for t in parts["epoch_save"]], steady,
             ["%.2f" % t for t in a_chunks], sync_free["step_ms"], peak_gb),
          flush=True)
    print("checkpoint: resumed fit C, %d steps, %d replays: first chunk "
          "%.2f ms (warm-up, capture and one replay), so its first step "
          "took %.2f ms; chunk ms %s"
          % (steps_c, c["replays"], c_chunks[0], c_chunks[0] - c_steady,
             ["%.2f" % t for t in c_chunks]), flush=True)
    if gens == 0:
        raise RuntimeError("the async writer wrote no generation")


def resnet50_step_updates(mx, ctx, x, y, seed):
    """One fit step of ResNet-50 from seeded Xavier weights on ``ctx``:
    ({name: update}, {aux name: value}) as numpy."""
    it = mx.io.NDArrayIter(x, y, batch_size=x.shape[0])
    mod = _resnet50_module(mx, ctx)
    mod.bind(it.provide_data, it.provide_label)
    mx.init.seed(seed)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    before = mx.convert.module_params_to_numpy(mod)[0]
    mod.fit(it, num_epoch=1, optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    arg, aux = mx.convert.module_params_to_numpy(mod)
    return {k: arg[k] - before[k] for k in arg}, aux


def parity_phase(mx, bnk, seed):
    """One fit step of the same ResNet-50 on the card and on the CPU.

    The first step of a randomly initialized ResNet-50 is ill-conditioned:
    on the CPU alone, an input perturbed by 1e-7 relative moves the
    updates by 1-2% (BatchNorm networks at initialization amplify
    perturbations with depth, and some per-channel sums of the backward
    cancel to ~1% of their terms).  So the card's updates are held to that
    floor, measured in this run, tensor by tensor: for every parameter,
    the distance of the card's update from the CPU's must stay within 3x
    the largest distance of the CPU's updates on ``PARITY_PERTURBATIONS``
    perturbed inputs.  A second witness, printed and not bounded: the card
    step with the plain versions in place of K1/K2 (the same convolutions),
    against the card step through the kernels.  The moving statistics, a
    forward quantity, are held to ``rtol=1e-4, atol=1e-5``."""
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(0, 255, (PARITY_BATCH, 3, 224, 224)).astype(np.float32)
    y = rng.integers(0, 1000, PARITY_BATCH).astype(np.float32)
    xps = [(x * (1 + 1e-7 * rng.standard_normal(x.shape))).astype(np.float32)
           for _ in range(PARITY_PERTURBATIONS)]
    t = time.perf_counter()
    gu, gaux = resnet50_step_updates(mx, mx.gpu(0), x, y, seed)
    gs = time.perf_counter() - t
    with bn_rerouted(bnk, lambda kernel, plain: plain):
        qu, _ = resnet50_step_updates(mx, mx.gpu(0), x, y, seed)
    t = time.perf_counter()
    cu, caux = resnet50_step_updates(mx, mx.cpu(), x, y, seed)
    cs = time.perf_counter() - t
    pus = [resnet50_step_updates(mx, mx.cpu(), xp, y, seed)[0] for xp in xps]

    names = sorted(cu)
    norm = math.sqrt(sum(float(np.sum(cu[k] ** 2)) for k in names))

    def dists(a, b):
        return np.array([float(np.linalg.norm(a[k] - b[k])) for k in names])

    floor = np.max([dists(p, cu) for p in pus], axis=0)
    card, plain_bn = dists(gu, cu), dists(gu, qu)
    ratio = card / np.maximum(floor, 1e-30)
    worst = int(np.argmax(ratio))
    wq = int(np.argmax(plain_bn / np.maximum(floor, 1e-30)))
    gb = [i for i, k in enumerate(names) if k.endswith(("_gamma", "_beta"))]
    gbw = gb[int(np.argmax(ratio[gb]))]

    def glob(d):
        return math.sqrt(float(np.sum(d ** 2))) / norm

    aux_err = max(np.abs(gaux[k] - caux[k]).max() / (1e-5 + 1e-4 * np.abs(
        caux[k]).max()) for k in caux)
    print("parity one fit step b%d ResNet-50, card (%.2f s) vs CPU plain "
          "versions (%.2f s): updates differ by %.3g of their norm, the CPU "
          "on %d perturbed inputs by %s; per tensor, card distance over the "
          "largest perturbed distance: median %.3g, worst %.3g at %s "
          "(limit 3), worst gamma/beta %.3g at %s; witness with the plain "
          "BatchNorm on the card: it differs from the card's kernel step by "
          "%.3g of the norm, worst %.3g of the floor at %s (not bounded); "
          "moving-stat error %.3g of its limit"
          % (PARITY_BATCH, gs, cs, glob(card), PARITY_PERTURBATIONS,
             ["%.3g" % glob(dists(p, cu)) for p in pus], np.median(ratio),
             ratio[worst], names[worst], ratio[gbw], names[gbw],
             glob(plain_bn), plain_bn[wq] / max(floor[wq], 1e-30),
             names[wq], aux_err), flush=True)
    if not ratio[worst] <= 3:
        raise RuntimeError("card and CPU updates of %s disagree beyond 3x "
                           "the f32 floor: %.3g vs %.3g" % (
                               names[worst], card[worst], floor[worst]))
    for k in caux:
        np.testing.assert_allclose(gaux[k], caux[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    return ratio[worst]


# -- the fused-LSTM language model (K4, K5, K6) -------------------------------
def _lstm_bound(T, N, H, kernel):
    """(bound_ms, bound_by): bytes each input read once and each output
    written once over 3.35 TB/s, against the products over the 67 TFLOP/s
    f32 peak (K4/K5: h @ w4, 2*4*N*H^2 per step; K6: the dh product and
    dw4, twice that), the larger of the two."""
    seq, state, w = T * N * H, N * H, 4 * H * H
    words = {"K4": 4 * seq + w + 4 * H + 2 * state + seq + 2 * state,
             "K5": 4 * seq + w + 4 * H + 2 * state + 6 * seq + 2 * state,
             "K6": 4 * seq + 2 * seq + w + 2 * state + seq + 2 * state
             + 4 * seq + w + 4 * H + 2 * state}[kernel]
    flops = 2.0 * 4 * N * H * H * T * (2 if kernel == "K6" else 1)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, 4.0 * words / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def lstm_kernel_phase(rk, dev, seed):
    """K4, K5 and K6 against their plain versions at every bucket length,
    N=32, H=200: the forward outputs within ``1e-5`` and the backward's
    within ``1e-4`` of each output's largest magnitude, K4's and K5's
    outputs and K6's dw4 and dbh bit for bit across two launches.  Timed beside the plain versions and,
    as a yardstick the port never calls, cuDNN's LSTM (``torch.nn.LSTM``,
    one layer at the same shape; it includes the input projection, so the
    kernel is printed with that projection's matmuls beside it)."""
    n, h = LSTM_BATCH, LSTM_HIDDEN
    rows = {}
    for T in LSTM_BUCKETS:
        gen = torch.Generator(device=dev).manual_seed(seed + T)

        def draw(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale

        x, wx, bx = draw(T, n, h), draw(4 * h, h, scale=h ** -0.5), draw(
            4 * h, scale=0.1)
        xp = (x @ wx.t() + bx).reshape(T, n, 4, h).permute(0, 2, 1, 3) \
            .contiguous()
        w4, bh = draw(4, h, h, scale=h ** -0.5), draw(4, h, scale=0.1)
        h0, c0 = draw(n, h, scale=0.5), draw(n, h, scale=0.5)
        dys, dhT, dcT = draw(T, n, h), draw(n, h), draw(n, h)
        args = (xp, w4, bh, h0, c0)
        got4 = rk.lstm_infer_cuda(*args)
        got5 = rk.lstm_fwd_cuda(*args)
        torch.cuda.synchronize()
        want5 = rk.lstm_fwd_plain(*args)
        want4 = (want5[0], want5[3], want5[4])
        saved = (got5[1], got5[2], got5[0], w4, h0, c0, dys, dhT, dcT)
        got6 = rk.lstm_bwd_cuda(*saved)
        torch.cuda.synchronize()
        want6 = rk.lstm_bwd_plain(*saved)
        again = rk.lstm_bwd_cuda(*saved)
        again4, again5 = rk.lstm_infer_cuda(*args), rk.lstm_fwd_cuda(*args)
        torch.cuda.synchronize()
        if not (torch.equal(got6[1], again[1])
                and torch.equal(got6[2], again[2])):
            raise RuntimeError("K6's dw4/dbh differ between two launches "
                               "at T=%d" % T)
        if not all(torch.equal(a, b) for a, b in zip(got4 + got5,
                                                     again4 + again5)):
            raise RuntimeError("K4/K5's outputs differ between two launches "
                               "at T=%d" % T)
        errs = {}
        for name, got, want, tol in (("K4", got4, want4, 1e-5),
                                     ("K5", got5, want5, 1e-5),
                                     ("K6", got6, want6, 1e-4)):
            rel = max(_rel_err(g, w) for g, w in zip(got, want))
            if not rel <= tol:
                raise RuntimeError("%s disagrees with its plain version at "
                                   "T=%d: %.3g of the output's magnitude "
                                   "(limit %g)" % (name, T, rel, tol))
            errs[name] = (max((g - w).abs().max().item()
                              for g, w in zip(got, want)), rel)
        # the yardstick: cuDNN, one layer, the same weights
        lstm = torch.nn.LSTM(h, h).to(dev)
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(wx)
            lstm.bias_ih_l0.copy_(bx)
            lstm.weight_hh_l0.copy_(w4.permute(1, 0, 2).reshape(h, 4 * h)
                                    .t())
            lstm.bias_hh_l0.copy_(bh.reshape(-1))
        st = (h0[None], c0[None])
        xg = x.clone().requires_grad_(True)
        with torch.enable_grad():
            out, (hn, cn) = lstm(xg, st)
        leaves = [xg] + list(lstm.parameters())

        def cudnn_bwd():
            torch.autograd.grad((out, hn, cn), leaves,
                                (dys, dhT[None], dcT[None]),
                                retain_graph=True)

        def cudnn_fwd_train():
            with torch.enable_grad():
                lstm(xg, st)

        with torch.no_grad():
            lib = {"K4": _time_ms(lambda: lstm(x, st), 20)}
        lib["K5"] = _time_ms(cudnn_fwd_train, 20)
        lib["K6"] = _time_ms(cudnn_bwd, 20)
        dxp2 = got6[0].permute(0, 2, 1, 3).reshape(T * n, 4 * h)
        x2 = x.reshape(T * n, h)
        proj = {"K4": _time_ms(lambda: x @ wx.t() + bx, 20)}
        proj["K5"] = proj["K4"]
        proj["K6"] = _time_ms(lambda: (dxp2 @ wx, dxp2.t() @ x2,
                                       dxp2.sum(0)), 20)
        calls = {"K4": lambda: rk.lstm_infer_cuda(*args),
                 "K5": lambda: rk.lstm_fwd_cuda(*args),
                 "K6": lambda: rk.lstm_bwd_cuda(*saved)}
        plains = {"K4": lambda: rk.lstm_infer_plain(*args),
                  "K5": lambda: rk.lstm_fwd_plain(*args),
                  "K6": lambda: rk.lstm_bwd_plain(*saved)}
        for name in ("K4", "K5", "K6"):
            ms = _time_ms(calls[name], 20)
            plain_ms = _time_ms(plains[name], 3, warmup=1)
            bound_ms, bound_by = _lstm_bound(T, n, h, name)
            rows[(name, T)] = dict(max_abs_err=errs[name][0], ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=lib[name])
            print("kernel lstm %s T=%d N=%d H=%d: max_abs_err %.3g (%.2g of "
                  "the magnitude), kernel %.4f ms (+ input-projection "
                  "matmuls %.4f = %.4f), plain %.4f ms, cuDNN %.4f ms, "
                  "bound %.4f ms (%s; %.1f us per step against the serial "
                  "chain)" % (name, T, n, h, errs[name][0], errs[name][1],
                              ms, proj[name], ms + proj[name], plain_ms,
                              lib[name], bound_ms, bound_by,
                              ms * 1e3 / T), flush=True)
        del lstm, out, hn, cn, xg, leaves
    print("kernel lstm K4/K5 layout at N=%d H=%d: %s; K6 layout: %s" % (
        n, h, rk.lstm_fwd_plan(n, h, dev), rk.lstm_bwd_plan(n, h, dev)),
        flush=True)
    lstm_wide_check(rk, dev, seed)
    torch.cuda.empty_cache()
    return rows


def lstm_wide_check(rk, dev, seed, T=8, n=8, h=1024):
    """K4 and K5 at the widest H the kernels take, where a CTA's slice of
    w4 streams from L2, then K6 on K5's own outputs: against the plain
    versions (forward within ``1e-5``, backward within ``1e-4`` of each
    output's largest magnitude), timed beside them."""
    gen = torch.Generator(device=dev).manual_seed(seed + h)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    args = (draw(T, 4, n, h, scale=0.5), draw(4, h, h, scale=h ** -0.5),
            draw(4, h, scale=0.1), draw(n, h, scale=0.5),
            draw(n, h, scale=0.5))
    got4 = rk.lstm_infer_cuda(*args)
    got5 = rk.lstm_fwd_cuda(*args)
    torch.cuda.synchronize()
    want5 = rk.lstm_fwd_plain(*args)
    saved = (got5[1], got5[2], got5[0], args[1], args[3], args[4],
             draw(T, n, h), draw(n, h), draw(n, h))
    got6 = rk.lstm_bwd_cuda(*saved)
    torch.cuda.synchronize()
    want6 = rk.lstm_bwd_plain(*saved)
    report = []
    for name, got, want, tol, call, plain in (
            ("K4", got4, (want5[0], want5[3], want5[4]), 1e-5,
             lambda: rk.lstm_infer_cuda(*args),
             lambda: rk.lstm_infer_plain(*args)),
            ("K5", got5, want5, 1e-5, lambda: rk.lstm_fwd_cuda(*args),
             lambda: rk.lstm_fwd_plain(*args)),
            ("K6", got6, want6, 1e-4, lambda: rk.lstm_bwd_cuda(*saved),
             lambda: rk.lstm_bwd_plain(*saved))):
        rel = max(_rel_err(g, w) for g, w in zip(got, want))
        if not rel <= tol:
            raise RuntimeError("%s disagrees with its plain version at T=%d "
                               "N=%d H=%d: %.3g of the output's magnitude "
                               "(limit %g)" % (name, T, n, h, rel, tol))
        report.append("%s %.2g of the magnitude, %.4f ms (plain %.4f)" % (
            name, rel, _time_ms(call, 10), _time_ms(plain, 3, warmup=1)))
    print("kernel lstm T=%d N=%d H=%d (K6 on K5's outputs): %s; K4/K5 "
          "layout %s" % (T, n, h, "; ".join(report),
                         rk.lstm_fwd_plan(n, h, dev)), flush=True)


@contextlib.contextmanager
def lstm_plain_refused(rk):
    """Within the block a plain version called on a CUDA tensor raises:
    the main path must launch the kernels."""
    names = ("lstm_infer_plain", "lstm_fwd_plain", "lstm_bwd_plain")
    saved = {k: getattr(rk, k) for k in names}

    def refuse(name):
        def plain(*args):
            if any(a.is_cuda for a in args):
                raise RuntimeError("%s called on the card" % name)
            return saved[name](*args)
        return plain

    for k in names:
        setattr(rk, k, refuse(k))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(rk, k, v)


def _lstm_module(mx, lstm_lm, ctx=None, key=max(LSTM_BUCKETS), cell=None):
    sym_gen = lstm_lm.make_sym_gen(
        cell or lstm_lm.build_cell(LSTM_HIDDEN, LSTM_LAYERS), LSTM_VOCAB,
        LSTM_EMBED, LSTM_HIDDEN)
    return mx.mod.BucketingModule(sym_gen, default_bucket_key=key) \
        if ctx is None else mx.mod.BucketingModule(
            sym_gen, default_bucket_key=key, context=ctx)


def lstm_training_phase(mx, rk, seed):
    """``BucketingModule.fit`` of the fused-LSTM LM at full width on the
    card: every bucket, then one ``score`` pass on ``eval_data``; 2 K5 +
    2 K6 launches per training batch, 2 K4 per eval batch, no plain
    version on the card."""
    from mxnet_tpu_torch.models import lstm_lm

    random.seed(seed)
    np.random.seed(seed)
    its = [mx.rnn.BucketSentenceIter(
        lstm_lm.synth_corpus(count, LSTM_VOCAB, seed=seed + s,
                             buckets=LSTM_BUCKETS), LSTM_BATCH,
        buckets=list(LSTM_BUCKETS), invalid_label=0, layout="TN")
        for count, s in ((LSTM_TRAIN_SENTENCES, 3), (LSTM_VAL_SENTENCES, 17))]
    train, val = its
    per_bucket = {b: sum(1 for i, _ in train.idx if train.buckets[i] == b)
                  for b in LSTM_BUCKETS}
    if min(per_bucket.values()) < 2:
        raise RuntimeError("a bucket has fewer than 2 training batches: %s"
                           % per_bucket)
    cell = lstm_lm.build_cell(LSTM_HIDDEN, LSTM_LAYERS)
    mod = _lstm_module(mx, lstm_lm, cell=cell)
    marks, evals = [], []
    ckpt_dir = tempfile.mkdtemp(prefix="mxtt-lm-")
    prefix = os.path.join(ckpt_dir, "lstm_lm")

    def mark(param):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((param.locals["data_batch"].bucket_key, ev))

    val_metric = mx.metric.Perplexity(0)
    mx.init.seed(seed)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    with lstm_plain_refused(rk):
        # -- the main path: counts from 0, one epoch with eval --
        rk.lstm_infer_cuda.launches = 0
        rk.lstm_fwd_cuda.launches = 0
        rk.lstm_bwd_cuda.launches = 0
        start.record()
        t0 = time.perf_counter()
        mod.fit(train, eval_data=val, eval_metric=mx.metric.Perplexity(0),
                validation_metric=val_metric, num_epoch=1,
                batch_end_callback=mark,
                epoch_end_callback=mx.rnn.do_rnn_checkpoint(cell, prefix),
                eval_batch_end_callback=lambda p: evals.append(p.nbatch),
                optimizer="sgd", optimizer_params={
                    "learning_rate": 0.02, "momentum": 0.0, "wd": 1e-5},
                initializer=mx.init.Xavier(factor_type="in", magnitude=2.34))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = (rk.lstm_infer_cuda.launches, rk.lstm_fwd_cuda.launches,
                    rk.lstm_bwd_cuda.launches)
        # -- end of the main path --
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_train, n_eval = len(marks), len(evals)
    want = (LSTM_LAYERS * n_eval, LSTM_LAYERS * n_train,
            LSTM_LAYERS * n_train)
    print("lstm training BucketingModule.fit vocab %d embed %d %dx%d LSTM "
          "batch %d buckets %s on the card: %d training batches %s, %d eval "
          "batches, fit %.2f s (bind and init included); K4/K5/K6 launches "
          "%s (expected %s); peak memory allocated %.3f GB"
          % (LSTM_VOCAB, LSTM_EMBED, LSTM_LAYERS, LSTM_HIDDEN, LSTM_BATCH,
             list(LSTM_BUCKETS), n_train, per_bucket, n_eval, fit_s,
             launches, want, peak_gb), flush=True)
    if launches != want or n_eval == 0:
        raise RuntimeError("LSTM kernels launched %s times, expected %s "
                           "(2 K5 + 2 K6 per training batch, 2 K4 per eval "
                           "batch)" % (launches, want))
    times = {}
    prev = start
    for key, ev in marks:
        times.setdefault(key, []).append(prev.elapsed_time(ev))
        prev = ev
    for key in LSTM_BUCKETS:
        ms = times[key]
        print("lstm training bucket %d: ms per batch (CUDA events between "
              "batch ends, the first binds the bucket) %s; median after the "
              "first %.3f ms = %.0f tokens/s" % (
                  key, ["%.2f" % t for t in ms], np.median(ms[1:]),
                  key * LSTM_BATCH / np.median(ms[1:]) * 1e3), flush=True)
    (_, ppl), = val_metric.get_name_value()
    arg, _ = mod.get_params()
    bad = [k for k, v in arg.items() if not torch.isfinite(v._t).all()]
    print("lstm training validation perplexity %.4f (vocab %d: a uniform "
          "guess scores %d)" % (ppl, LSTM_VOCAB, LSTM_VOCAB), flush=True)
    if bad or not np.isfinite(ppl):
        raise RuntimeError("LSTM training gave non-finite params %s or "
                           "perplexity %s" % (bad, ppl))
    try:
        lstm_reloaded(mx, rk, lstm_lm, prefix, mod, seed)
    finally:
        import shutil
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    lstm_host_copy(mx, mod, val)
    lstm_profile(mx, mod, train)
    del mod
    torch.cuda.empty_cache()
    return launches


def lstm_reloaded(mx, rk, lstm_lm, prefix, trained, seed):
    """A second ``BucketingModule`` from the epoch checkpoint that
    ``do_rnn_checkpoint`` wrote (``load_rnn_checkpoint`` packs the
    per-gate arrays back into the fused blob) scores the eval data: its
    perplexity equals the trained module's score of the same batches
    (each pass on a new iterator, its shuffles seeded alike:
    ``Perplexity`` is a mean over batches) within ``rtol=1e-6``, with 2
    K4 launches per eval batch."""
    def val_iter():
        random.seed(seed)
        np.random.seed(seed)
        return mx.rnn.BucketSentenceIter(
            lstm_lm.synth_corpus(LSTM_VAL_SENTENCES, LSTM_VOCAB,
                                 seed=seed + 17, buckets=LSTM_BUCKETS),
            LSTM_BATCH, buckets=list(LSTM_BUCKETS), invalid_label=0,
            layout="TN")

    (_, ppl), = trained.score(val_iter(), mx.metric.Perplexity(0))
    val = val_iter()
    cell = lstm_lm.build_cell(LSTM_HIDDEN, LSTM_LAYERS)
    _sym, arg, aux = mx.rnn.load_rnn_checkpoint(cell, prefix, 1)
    saved = mx.nd.load("%s-0001.params" % prefix)
    mod = _lstm_module(mx, lstm_lm, cell=cell)
    mod.bind(val.provide_data, val.provide_label, for_training=False)
    mod.set_params(arg, aux)
    metric = mx.metric.Perplexity(0)
    with lstm_plain_refused(rk):
        # -- the main path: counts from 0, the score pass --
        rk.lstm_infer_cuda.launches = 0
        seen = []
        (_, got), = mod.score(val, metric,
                              batch_end_callback=lambda p: seen.append(1))
        torch.cuda.synchronize()
        launches = rk.lstm_infer_cuda.launches
        # -- end of the main path --
    n_eval = len(seen)
    print("lstm checkpoint: do_rnn_checkpoint wrote %d arrays (the fused "
          "blob unpacked per gate: %s); the reloaded module's perplexity "
          "%.6f against the trained module's %.6f (rtol 1e-6); K4 launches "
          "%d over %d eval batches" % (
              len(saved), "arg:lstm_l1_h2h_weight" in saved, got, ppl,
              launches, n_eval), flush=True)
    if not np.isclose(got, ppl, rtol=1e-6, atol=0):
        raise RuntimeError("reloaded LM scores %r, trained %r" % (got, ppl))
    if launches != LSTM_LAYERS * n_eval:
        raise RuntimeError("reloaded LM: %d K4 launches over %d eval "
                           "batches, expected %d a batch"
                           % (launches, n_eval, LSTM_LAYERS))
    del mod
    torch.cuda.empty_cache()


def lstm_host_copy(mx, mod, it):
    """Per bucket: the device forward of one eval batch, then the host copy
    of its (T*32, 10000) output and the host metric update, as
    ``Perplexity`` takes them on every batch."""
    it.reset()
    seen = set()
    for batch in it:
        if batch.bucket_key in seen:
            continue
        seen.add(batch.bucket_key)
        mod.forward(batch, is_train=False)
        out = mod.get_outputs()[0]
        dev_ms = _time_ms(lambda: mod.forward(batch, is_train=False), 3,
                          warmup=1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        host = out.asnumpy()
        copy_s = time.perf_counter() - t
        metric = mx.metric.Perplexity(0)
        t = time.perf_counter()
        metric.update(batch.label, [host])
        metric_s = time.perf_counter() - t
        print("lstm eval bucket %d: device forward %.3f ms; host copy of "
              "the output %.4f s (%.1f MB, %.2f GB/s); Perplexity update on "
              "the host copy %.4f s" % (
                  batch.bucket_key, dev_ms, copy_s, host.nbytes / 1e6,
                  host.nbytes / copy_s / 1e9, metric_s), flush=True)


def lstm_profile(mx, mod, it):
    """One training batch of the longest bucket under torch.profiler,
    forward+backward, update and the host metric: device time by group
    and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    it.reset()
    batch = next(b for b in it if b.bucket_key == max(LSTM_BUCKETS))
    metric = mx.metric.Perplexity(0)

    def step():
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric, batch.label)
        torch.cuda.synchronize()

    step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        wall = (time.perf_counter() - t) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages() if dev_us(e) > 0
               and e.device_type.name == "CUDA"]
    total = sum(dev_us(e) for e in kernels) / 1e3
    if total <= 0:
        print("lstm profile: the profiler recorded no device time (not "
              "measured)", flush=True)
        return
    rules = (("lstm kernels (K5/K6)", lambda k: "lstm_" in k),
             ("memcpy", lambda k: "memcpy" in k),
             ("gemm (projections, pred)", lambda k: "gemm" in k
              or "sgemm" in k or "cutlass" in k),
             ("softmax", lambda k: "softmax" in k),
             ("optimizer (foreach)", lambda k: "multi_tensor" in k
              or "foreach" in k),
             ("embedding", lambda k: "embedding" in k or "index" in k))
    groups = {}
    for e in kernels:
        k = e.key.lower()
        name = next((n for n, test in rules if test(k)), "other")
        groups[name] = groups.get(name, 0.0) + dev_us(e) / 1e3
    print("lstm profile of one T=%d training batch with its metric update: "
          "wall %.2f ms, device busy %.3f ms (idle share %.1f%%); by group: "
          "%s" % (max(LSTM_BUCKETS), wall, total,
                  100 * max(0.0, 1 - total / wall), ", ".join(
                      "%s %.3f ms" % kv for kv in sorted(
                          groups.items(), key=lambda kv: -kv[1]))),
          flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        print("lstm profile  %8.3f ms  x%-4d %s" % (
            dev_us(e) / 1e3, e.count, e.key[:100]), flush=True)


def lstm_step_updates(mx, lstm_lm, ctx, params, ids):
    """One training step of the full-width LM from ``params`` on ``ctx``:
    {name: update} as numpy."""
    T = ids.shape[0]
    mod = _lstm_module(mx, lstm_lm, ctx, key=T)
    mod.bind([("data", ids.shape)], [("softmax_label", ids.shape)])
    mod.init_params(mx.init.Zero())
    mx.convert.set_module_params(mod, params, {})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.02, "momentum": 0.0, "wd": 1e-5})
    label = np.concatenate([ids[1:], np.zeros_like(ids[:1])])
    batch = mx.io.DataBatch(
        [mx.nd.array(ids)], [mx.nd.array(label)], bucket_key=T,
        provide_data=[mx.io.DataDesc("data", ids.shape)],
        provide_label=[mx.io.DataDesc("softmax_label", ids.shape)])
    mod.forward_backward(batch)
    mod.update()
    after = mx.convert.module_params_to_numpy(mod)[0]
    return {k: after[k] - params[k] for k in params}


def lstm_parity_phase(mx, seed):
    """One training step at T=60 on the card (K5/K6) against the same step
    on the CPU (the plain versions), from the same weights.  Each
    parameter's update must agree within 1e-4 of its norm, unless an
    embedding perturbed by 1e-7 relative moves the CPU's own update by
    more than that (the floor): then within 3x the floor."""
    from mxnet_tpu_torch.models import lstm_lm

    T = max(LSTM_BUCKETS)
    rs = np.random.RandomState(seed + 5)
    ids = rs.randint(1, LSTM_VOCAB, (T, LSTM_BATCH)).astype(np.float32)
    init = _lstm_module(mx, lstm_lm, mx.cpu(), key=T)
    init.bind([("data", ids.shape)], [("softmax_label", ids.shape)])
    mx.init.seed(seed)
    init.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34))
    params = mx.convert.module_params_to_numpy(init)[0]
    del init
    t = time.perf_counter()
    gu = lstm_step_updates(mx, lstm_lm, mx.gpu(0), params, ids)
    gs = time.perf_counter() - t
    t = time.perf_counter()
    cu = lstm_step_updates(mx, lstm_lm, mx.cpu(), params, ids)
    cs = time.perf_counter() - t
    perturbed = dict(params)
    perturbed["embed_weight"] = (params["embed_weight"] * (
        1 + 1e-7 * rs.standard_normal(params["embed_weight"].shape))) \
        .astype(np.float32)
    pu = lstm_step_updates(mx, lstm_lm, mx.cpu(), perturbed, ids)
    worst = 0.0
    for k in sorted(cu):
        norm = max(float(np.linalg.norm(cu[k])), 1e-30)
        dist = float(np.linalg.norm(gu[k] - cu[k])) / norm
        floor = float(np.linalg.norm(pu[k] - cu[k])) / norm
        bound = 3 * floor if floor > 1e-4 else 1e-4
        worst = max(worst, dist / bound)
        print("lstm parity T=%d %s: card vs CPU update %.3g of its norm, "
              "perturbed-embedding floor %.3g, bound %.3g"
              % (T, k, dist, floor, bound), flush=True)
        if not dist <= bound:
            raise RuntimeError("card and CPU updates of %s disagree: %.3g "
                               "of the norm (bound %.3g)" % (k, dist, bound))
    print("lstm parity one step b%d T=%d: card %.2f s, CPU %.2f s; worst "
          "distance over its bound %.3g" % (LSTM_BATCH, T, gs, cs, worst),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent-bn", default=os.path.join(
        ROOT, "build", "bn_parent", "batch_norm.cu"),
        help="a copy of csrc/batch_norm.cu before the resident path, "
        "timed beside the kernels (not measured when absent)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops import bn_kernel as bnk
    from mxnet_tpu_torch.ops import rnn_kernel as rk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mx.telemetry.enable()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print("device: %s (torch: %s, %d device(s))"
          % (smi, kind, torch.cuda.device_count()), flush=True)
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        parent = pool.submit(parent_bn_library, args.parent_bn)
        _kernels.build_all()
        parent_bn = parent.result()
    print("kernels built in %.2f s" % (time.perf_counter() - t0), flush=True)
    for lib in _kernels.SOURCES:
        for line in _kernels.build_log(lib).splitlines():
            if "registers" in line or "spill" in line:
                print("  %s: %s" % (lib, line.strip()), flush=True)

    rows = kernel_phase(att, dev, args.seed)
    k3b_rows = k3b_kernel_phase(att, dev, args.seed)
    configs = resnet_bn_configs(mx, TRAIN_BATCH)
    if sum(configs.values()) != 51:
        raise RuntimeError("ResNet-50 has %d BatchNorms, expected 51"
                           % sum(configs.values()))
    _bn_rows, bn_totals = bn_kernel_phase(bnk, dev, args.seed, configs,
                                          parent_bn)
    lstm_rows = lstm_kernel_phase(rk, dev, args.seed)
    launches = serving_phase(mx, att, dev, args.seed)
    lm_k3, lm_k3b = lm_training_phase(mx, att, args.seed)
    lm_parity_phase(mx, att, args.seed)
    (k1_launches, k2_launches), classic = training_phase(
        mx, bnk, args.seed, TRAIN_STEPS, bn_totals)
    sync_free = sync_free_phase(mx, bnk, args.seed, TRAIN_STEPS, classic)
    checkpoint_phase(mx, bnk, args.seed, TRAIN_STEPS, sync_free)
    parity_phase(mx, bnk, args.seed)
    lstm_launches = lstm_training_phase(mx, rk, args.seed)
    lstm_parity_phase(mx, args.seed)

    main_row = rows[(4, True)]  # the bucket-4 dispatch's shape
    source = "mxnet_tpu_torch/csrc/batch_norm.cu"
    # K3's launches: serving's dispatches and the LM fit and score; K3b's:
    # the LM fit (its time at the training step's shape, B=4 causal)
    # the BatchNorm rows: times summed over the 51 BatchNorms of one b128
    # step; launches over the whole training run (51 per step)
    kernels = [dict(name="flash_attention_fwd", route="cuda",
                    source="mxnet_tpu_torch/csrc/flash_attention.cu",
                    replaces="mxnet_tpu/ops/attention.py:116",
                    launches=launches + lm_k3, **main_row),
               dict(name="flash_attention_bwd", route="cuda",
                    source="mxnet_tpu_torch/csrc/flash_attention.cu",
                    replaces="mxnet_tpu/ops/attention.py:253",
                    launches=lm_k3b,
                    **k3b_rows[(4, SEQ, SEQ, True, False)]),
               dict(name="batch_norm_fwd", route="cuda", source=source,
                    replaces="mxnet_tpu/ops/bn_pallas.py:87",
                    launches=k1_launches, **bn_totals["fwd"]),
               dict(name="batch_norm_bwd", route="cuda", source=source,
                    replaces="mxnet_tpu/ops/bn_pallas.py:110",
                    launches=k2_launches, **bn_totals["bwd"])]
    # the LSTM rows: times at T=60, N=32, H=200 (the default bucket);
    # launches over the whole fit (K4 in its score pass)
    t_max = max(LSTM_BUCKETS)
    for (kid, kname, line), n in zip(
            (("K4", "lstm_infer", 126), ("K5", "lstm_fwd", 56),
             ("K6", "lstm_bwd", 82)), lstm_launches):
        kernels.append(dict(
            name=kname, route="cuda", source="mxnet_tpu_torch/csrc/lstm.cu",
            replaces="mxnet_tpu/ops/rnn_pallas.py:%d" % line, launches=n,
            **lstm_rows[(kid, t_max)]))
    print(json.dumps({"kernels": kernels}))
    print("nvidia-smi: %s" % smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
