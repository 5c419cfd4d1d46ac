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
   operations per attended pair, at the 3xTF32 rate); prints the
   registers and spill bytes of K3b's kernels from nvcc's report.
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
   over the 50 BatchNorms outside bn_data.  Then the same at every
   distinct BatchNorm input of the Inception-v3 b128 step (eps 1e-3,
   fix_gamma, ReLU fused; 149x149 down to 8x8, all but 8x8 odd, so the
   4-byte copies on clusters of up to 15 CTAs and the chunked path),
   summed over its 94 BatchNorms.  Every shape's K1 and K2 must repeat
   bit for bit across two launches.
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
12. Inception-v3 training phase: ``Module(inception-v3).fit`` on the card
   at full width (3x299x299, 1000 classes, f32, batch 128) over 6 seeded
   batches as ``common/data.py``'s ``SyntheticDataIter`` makes them, with
   ``common/fit.py``'s settings (SGD momentum 0.9, wd 1e-4, lr 0.1 with
   the ``MultiFactorScheduler`` of ``lr_step_epochs="30,60"``, Xavier
   gaussian in 2, accuracy), classic and then sync-free (the switches of
   phase 7b).  Each run must launch K1 and K2 94 times a step (a replay
   adds what its capture recorded), call no plain BatchNorm on the card
   and end finite; a replayed step must run as many K1/K2 kernels as an
   eager one.  Prints step ms, images/s, peak memory and a profile of
   one step of each (cuDNN convolutions, K1+K2, the rest).
13. Inception-v3 step parity: phase 8's check on one b4 Inception-v3 step
   (inputs uniform in [-1, 1)), each parameter within 3x the f32 floor.
14. MNIST phase (BASELINE #1): ``train_mnist.py``'s synthetic MNIST
   written as idx files by ``models.lenet.synth_mnist``, read through
   ``io.MNISTIter``; LeNet and the MLP (``flat``) fit two epochs on the
   card and on the CPU from the same seeded weights and batches (b64, SGD
   lr 0.05 momentum 0.9 wd 1e-4, Xavier gaussian in 2): the card's
   validation accuracy finite and within 0.02 of the CPU's, or within 3x
   the CPU's own spread on three 1e-7-perturbed training sets where that
   is larger (at this lr LeNet diverges from some seeds, as in the JAX
   package, and a diverged fit is chaotic).  Then one
   epoch of LeNet on the card with each other optimizer of
   ``common/fit.py`` (NAG, DCASGD, SGLD, ccSGD, AdaGrad, RMSProp plain
   and centered, AdaDelta, Test): a finite loss and finite parameters.
15. Decode phase (the LM-serving stack of
   ``example/serving/serve_lm.py``): ``models.transformer_lm`` at GPT-2
   medium's published widths (vocab 50257, embed 1024, 16 heads of 64, 24
   layers, ffn 4096, max_len 1024; Radford et al. 2019, Table 2, the 345M
   row), f32, weights from ``init_params(seed=--seed)``, eos unreachable.
   ``lm_pool`` of two ``DecodeEngine`` replicas on the card (32 slots,
   prefill buckets 64-512) -> ``ModelRegistry.register`` ->
   ``ServingHTTPServer``, and 96 concurrent HTTP clients drawn from
   ``--seed`` (prompts of 16-480 tokens, half sharing one 256-token
   prefix, 128 new tokens each, half greedy and half at temperature 0.8,
   a quarter streamed).  Runs: A dense; B paged (blocks of 16, prefix
   cache; then one shared prompt twice in a row, whose second admission
   copies a partial block on write); C dense with one replica's step
   raising midway, at its step 112 (the pool migrates its sessions, the
   longest past the largest prefill bucket, which re-prefill at max_len;
   the breaker opens, the replica re-warms, goes half-open and closes on
   a probe); D dense with ``register`` of a second pool on the same
   params at step 112 (stragglers finish there).  C and D must each have
   migrated a transcript past the largest bucket.  Every request must
   end with its 128 tokens, none shed.  The token rule (streams equal up
   to the first position where the reference's top-2 margin is under
   2e-5 of its largest magnitude, ten times the step's measured error)
   holds each stream of A to the argmax of its teacher-forced forward
   (greedy: the logits; at a temperature: the logits over t plus the
   session's own Gumbel noise), and B, C and D to A; B must also equal A
   in full.  Then one step of 32 slots dense against paged and against
   the forward, one prefill and three steps on the card against the CPU
   (1e-4 of the largest logit), and per layout a dedicated engine with
   every slot busy: the step's device ms (the kernels' busy time in a
   profile of 20 steps, which must hold exactly 20 device-to-host copies,
   the packed buffers, and no other sync), its wall time on the stream
   (CUDA events) and host ms, the step's byte bound, the step by kernel
   group, and the prefill ms per bucket (device and wall).  Every state
   tensor of every replica must lie on the card.  The phase prints its
   time by part.
16. Fleet phase (the fleet control plane over phase 15's stack): the same
   model, weights and traffic, dense, 32 slots a replica, ``lm_pool`` ->
   ``register`` -> ``FleetController`` (a tick every 200 ms, replicas
   placed by a ``DeviceFleet`` of cuda:0) -> ``ServingHTTPServer``.  Run
   E, autoscale: one replica, a TTFT-p99 SLO of 1000 ms, two breach ticks,
   five slack ticks, 2 s of cooldown, at most three replicas (three to the
   card); 64 clients at once, then the other 32 one at a time over 30 s
   from 3 s on.  The controller must scale up while the burst is served
   and, once the breach has cleared, scale down a replica whose live
   sessions migrate; the fleet ends at one replica.  Run F, supervision: every other client (48)
   on two replicas, restart budget 1; ``serving.replica.kill`` fires at the
   pool's step 128 (each replica's 64th); the controller replaces the dead
   replica on cuda:0 (warmed before routing), the survivor is killed 8
   steps later and the model is quarantined.  Run G, shedding at capacity:
   48 clients every 100 ms on a full fleet (two replicas, two to the card,
   at most two), half at priority 1 (under the pool's floor of 5), an SLO
   of 10 ms that any first token breaches: clients under the floor are
   refused (429, reason ``priority``) only while the pressure is on, every
   client at the floor is served, the pressure lifts after the burst and a
   priority-1 probe is served.  Every served stream must equal run A's in
   full, nothing may fail or (E, F) be shed.  Prints per run tokens/s,
   TTFT p50/p99, peak memory (allocated and reserved), each decision with
   its time, the replica count over time and, for each added replica, the
   time from the SLO breach (and from the decision) to its first token;
   and its GETs of ``/fleet`` and ``/healthz``.
17. The rest of the RNN toolkit, every line with the card's name and
   power limit.  17a: ``example/rnn/lstm_bucketing.py``'s unfused stack
   (``models.lstm_lm.build_stack``: two ``LSTMCell`` of 200, NT batches
   unrolled NTC, phase 9's widths, corpus, SGD and initializer) through
   ``BucketingModule.fit`` on the card for one epoch with ``score``: no
   K4-K6 launch and no plain LSTM on the card; the ms per batch per
   bucket beside phase 9's fused step, peak memory; one T=60 step on the
   card against the CPU, and (in TNC, the fused model's layout) against
   the fused model's step through K5/K6 from the same weights carried by
   ``unpack_weights``: each update within 1e-4 of its norm (3x the CPU's
   perturbed-embedding floor where larger).  17b,
   ``fused_lstm_bucketing.py --test``: phase 9's fused checkpoint scored
   through K4 and, loaded into ``cell.unfuse()`` by
   ``load_rnn_checkpoint``, through the unfused stack on the same
   batches: perplexities within 1e-5 (relative), each batch's outputs
   within 1e-4 of their largest magnitude.  17c, ``--dropout 0.5``: the
   fused fit with dropout between its layers for one epoch, 2 K5 + 2 K6
   launches a batch, the kept share within 0.5 +- 0.01; the first
   batch's update from one seed bit for bit twice and apart from the
   p=0 update; one T=60 step with every K5/K6 call held against its
   plain version on its own tensors (1e-5 forward, 1e-4 backward of each
   output's largest magnitude).  17d: BASELINE #1's MLP feature layers
   as a ``Module`` and a ``PythonLossModule`` softmax head in a
   ``SequentialModule``, 8 ``MNISTIter`` batches on the card and on the
   CPU from one seed: updates within 1e-4 of their norms (3x the CPU's
   perturbed floor), training accuracy within 0.02.
18. SSD-VGG16 (BASELINE #4) and the classic classifiers, every line with
   the card's name and power limit.  18a: ``example/ssd/train.py``'s fit
   of SSD300 (``get_symbol_train(num_classes=20)``, 300x300, b32, f32)
   over 4 batches of ``synth_detection_set`` through ``NDArrayIter`` and
   ``Module.fit`` with ``MultiBoxMetric`` (SGD lr 0.002, momentum 0.9, wd
   5e-4), classic and with ``MXNET_FUSE_TRAIN_STEP=1`` (MultiBoxTarget
   inside the captured step; 3 replays in 4 steps): step ms, images/s,
   the metric's host read, peak memory allocated and reserved, a profile
   of one classic step; one b4 step on the card against the CPU within
   3x the floor of three CPU steps on inputs perturbed by 1e-6.  18b: the
   trained weights through the deploy graph and the port's ``Detector``
   at b32, two passes, one K7 launch each and no plain NMS on the card;
   the synthetic VOC mAP printed, not judged; K7 on that batch's own
   inputs (7308 boxes an image) against its plain version run on the
   card: equal class ids, scores and boxes within 1e-6; timed beside the
   plain version and the bound.  18c: VGG-16 with and without
   ``batch_norm``, GoogLeNet (256x256), Inception-BN and AlexNet, b32
   (224x224), and Inception-ResNet-v2 (299x299, the paper's repeats
   10/20/9), 3 steps each through ``Module.fit``: step ms, peak memory,
   one K1 and one K2 launch per BatchNorm a step (13, 69 and 244), every
   K1/K2 call of one more step held on its own tensors; one Inception-BN
   b4 step against the CPU, all updates within 3x the perturbed distance.
19. Faster R-CNN with VGG16 (``models.rcnn``; the paper's single-scale
   setting: one 600x1000 image a batch, 21 classes, 9 anchors, a 37x62
   conv5 map, pre/post-NMS top-N 12000/2000 in training and 6000/300 at
   inference), f32, seeded data and weights, every line with the card's
   name and power limit.  19a: ``get_symbol_rpn`` through ``Module.fit``
   for 4 steps (``example/rcnn/train.py``'s SGD, lr 0.001, momentum 0.9;
   its brightness labels, a tenth of the anchors -1): step ms and the
   anchor cross-entropy of each step.  19b: ``get_symbol_train`` through
   ``Module.fit`` for 4 steps, classic and captured
   (``MXNET_FUSE_TRAIN_STEP=1``): step ms, one K7, K8 and K8b launch a
   step, no plain NMS or ROI pooling on the card, peak memory, a profile
   of one classic step by group (cuDNN convolutions, gemm, K7, K8, K8b,
   ...).  19c: 19b's weights through ``get_symbol_test`` and
   ``Module.forward(is_train=False)``, two passes: forward ms, one K7 and
   one K8 launch a pass, well-formed outputs.  19d: K7 against the plain
   loop on Proposal's own inputs of 19b and 19c (keep masks equal),
   timed; K8's maxima and channels-last map bit for bit and K8b within
   1e-5 of the largest |dx| (and bit for bit across two launches) on
   19b's own conv5_3 map, ROIs and pool5 gradient, timed beside the plain
   versions and the bound, with K8b's band height, channel tile and the
   bytes the two kernels move; K8 on 19c's 300 ROIs; one RPN step on the card
   against the CPU within 3x the f32 floor of each parameter (inputs
   perturbed by 1e-6, and the CPU step summed in another order, on one
   thread, as one more witness of the floor).
20. Prints the kernel table (K1-K6, K3b, K7, K8 and K8b) as one JSON line,
   the card's name and power limit, then the result line.

Exits non-zero, printing no result, without a card or outside the repo.
"""

import argparse
import concurrent.futures
import contextlib
import json
import math
import os
import random
import re
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


def _dev_us(e):
    """A profiler event's own device time in us (the attribute's name
    changed between torch versions)."""
    return getattr(e, "self_device_time_total", None) \
        or getattr(e, "self_cuda_time_total", 0)


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


def ptxas_report(kernels, lib):
    """``{kernel: (registers, spill store bytes, spill load bytes)}`` of
    kernel library ``lib``, from the ``-Xptxas -v`` lines of its build
    log (``kernels``: the port's ``_kernels``; names as compiled,
    mangled)."""
    out, name, spills = {}, None, (0, 0)
    for line in kernels.build_log(lib).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)),) + spills
    return out


def k3b_kernel_phase(att, dev, seed):
    """K3b against its plain version on the card (TF32 off for the plain
    version), each of dq, dk, dv within ``1e-4`` of its largest
    magnitude, on (B, L, H*D) -> (B, H, L, D) views as MultiHeadAttention
    passes them, repeating bit for bit across two launches; at B in {1, 4},
    L = 2048, causal and not, then a ragged shape and the full shape with
    a nonzero dlse.  Timed beside the plain version, the backward of
    ``F.scaled_dot_product_attention`` (a yardstick the port never calls)
    and the bound."""
    for name, (regs, st, ld) in sorted(ptxas_report(
            att._kernels, "flash_attention").items()):
        if "flash_bwd" in name:
            print("kernel flash_attention_bwd (K3b) %s: %d registers, %d "
                  "bytes spill stores, %d bytes spill loads"
                  % (name, regs, st, ld), flush=True)
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
def plain_refused(*targets):
    """Within the block each plain version ``(module, name)`` of
    ``targets`` raises when a CUDA tensor is among its positional
    arguments: the card's path must launch the kernels."""
    saved = [(m, k, getattr(m, k)) for m, k in targets]

    def refuse(name, fn):
        def plain(*args, **kw):
            if any(torch.is_tensor(a) and a.is_cuda for a in args):
                raise RuntimeError("%s called on the card" % name)
            return fn(*args, **kw)
        return plain

    for m, k, fn in saved:
        setattr(m, k, refuse(k, fn))
    try:
        yield
    finally:
        for m, k, fn in saved:
            setattr(m, k, fn)


def attention_plain_refused(att):
    """The plain attention versions refused on the card: the path must
    take K3 and K3b."""
    return plain_refused((att, "flash_attention_plain"),
                         (att, "flash_attention_bwd_plain"))


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

    kernels = [e for e in prof.key_averages() if _dev_us(e) > 0
               and e.device_type.name == "CUDA"]
    total = sum(_dev_us(e) for e in kernels) / 1e3
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
        groups[name] = groups.get(name, 0.0) + _dev_us(e) / 1e3
    busy = total - groups.get("memcpy", 0.0)
    print("lm profile of one training step with its metric update: wall "
          "%.2f ms (steady step %.2f ms), device busy %.3f ms with the "
          "copies (idle share %.1f%%), kernels alone %.3f ms (idle share "
          "%.1f%% without the copies); by group: %s" % (
              wall, steady_ms, total, 100 * max(0.0, 1 - total / wall),
              busy, 100 * max(0.0, 1 - busy / wall),
              ", ".join("%s %.3f ms" % kv for kv in sorted(
                  groups.items(), key=lambda kv: -kv[1]))), flush=True)
    for e in sorted(kernels, key=_dev_us, reverse=True)[:10]:
        print("lm profile  %8.3f ms  x%-4d %s" % (
            _dev_us(e) / 1e3, e.count, e.key[:100]), flush=True)


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


def checked_step(mod, batch, bnk, n_bn=51, net="training"):
    """One more training step in which every K1 and K2 call (``n_bn`` of
    each) is held, on the main path's own tensors, against
    :func:`bn_checking`'s references; each error of a kernel's output must
    stay within ``BN_STEP_TOL``."""
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
        print("%s checked step: %d %s calls on the step's own "
              "tensors, worst error by output %s" % (
                  net, len(calls), kernel, ", ".join(
                      "%s %.3g at %s" % (k, v[0], v[1])
                      for k, v in worst.items())), flush=True)
        if len(calls) != n_bn:
            raise RuntimeError("%s ran %d times in the checked step, "
                               "expected %d" % (kernel, len(calls), n_bn))
        bad = {k: v for k, v in worst.items()
               if not k.startswith("plain_") and not v[0] <= BN_STEP_TOL}
        if bad:
            raise RuntimeError("%s disagrees on the step's own tensors "
                               "beyond %g: %s" % (kernel, BN_STEP_TOL, bad))


def net_bn_configs(mx, net, data_shape):
    """{(input shape, fix_gamma, relu fused): count} over the BatchNorm
    nodes of ``net``'s training step at ``data_shape``, read from the
    graph the way the executor's peephole reads it."""
    from mxnet_tpu_torch.executor import _bn_relu_peephole

    var_shape, _, entry = net._infer_shapes_full({"data": data_shape})
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


def resnet_bn_configs(mx, batch):
    """The BatchNorm configs of the ResNet-50 training step at ``batch``."""
    net = mx.models.get_symbol("resnet", num_classes=1000, num_layers=50,
                               image_shape="3,224,224")
    return net_bn_configs(mx, net, (batch, 3, 224, 224))


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


def _plan_text(plan, s):
    """A ``bn_plan`` in words, with the copies a strip of ``s`` floats
    takes on the resident path (the kernels launch VEC = 4 when S % 4 ==
    0, torch's allocations being 16-byte aligned)."""
    if plan["path"] == "chunked":
        return "chunked (%d blocks)" % plan["clusters"]
    return ("resident: %d clusters of %d CTA(s) (%d at once), %d "
            "channel(s) of %d strips and %d KB of shared memory a CTA, %s"
            % (plan["clusters"], plan["ctas_per_cluster"],
               plan["active_clusters"], plan["channels_per_cta"],
               plan["strips_per_cta"], plan["smem_bytes"] // 1024,
               "VEC 4 (bulk copies)" if s % 4 == 0
               else "VEC 1 (4-byte cp.async)"))


def bn_step_total(rows, key, keep=lambda r: True):
    """``row[key]`` times the row's BatchNorms per step, summed over the
    rows ``keep`` admits; None when one of them was not measured."""
    vals = [(r[key], r["count"]) for r in rows if keep(r)]
    if any(v is None for v, _ in vals):
        return None
    return sum(v * n for v, n in vals)


def bn_kernel_phase(bnk, dev, seed, configs, parent_lib=None, eps=2e-5,
                    net="ResNet-50"):
    """K1 and K2 against their plain versions at every BatchNorm input of
    ``net``'s step (its BatchNorms' ``eps``), and each against a second
    launch of itself bit for bit, timed with the L2 cold beside the
    library calls and, when ``parent_lib`` is given, the kernels before
    the resident path under the same timer; returns one row per config
    and the step totals."""
    rows = []
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
        again = (bnk.bn_fwd_cuda(x, gamma, beta, eps, fix_gamma, relu),
                 bnk.bn_bwd_cuda(x, g, mean, var, gamma, beta, eps,
                                 fix_gamma, relu))
        torch.cuda.synchronize()
        for name, first, second in (("K1", (y, mean, var), again[0]),
                                    ("K2", (dx, dg, db), again[1])):
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                raise RuntimeError("%s is not bit for bit across two "
                                   "launches at %s" % (name, shape))
        del y, dx, plain, again
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

        print("kernel batch_norm %s %s fix_gamma=%s relu=%s (x%d per step; "
              "bit for bit across two launches; "
              "L2 cold: %d copies of the inputs): K1 %.4f ms (bound %.4f, "
              "%.0f%% of 3.35 TB/s), parent %s, plain %.4f, F.batch_norm "
              "%.4f; K2 %.4f ms (bound %.4f, %.0f%%), parent %s, plain "
              "%.4f, native_batch_norm_backward %.4f; max_abs_err K1 %.3g "
              "K2 %.3g (scaled %.2g / %.2g); plan K1 %s; K2 %s"
              % (net, shape, fix_gamma, relu, count, len(copies),
                 row["fwd_ms"],
                 fwd_bound, 100 * fwd_bound / row["fwd_ms"], parent("fwd"),
                 fwd_plain, row["fwd_library_ms"], row["bwd_ms"], bwd_bound,
                 100 * bwd_bound / row["bwd_ms"], parent("bwd"), bwd_plain,
                 row["bwd_library_ms"], row["fwd_err"], row["bwd_err"],
                 max(e[1] for e in fwd_errs), max(e[1] for e in bwd_errs),
                 _plan_text(plans[0], s), _plan_text(plans[1], s)),
              flush=True)
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
        sums = [(lambda r: True, "the %d BatchNorms of one %s b%d step"
                 % (sum(r["count"] for r in rows), net, TRAIN_BATCH))]
        if not all(not_data(r) for r in rows):
            sums.append((not_data, "the %d BatchNorms outside bn_data"
                         % sum(r["count"] for r in rows if not_data(r))))
        for keep, what in sums:
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


def _is_bn_kernel(name):
    return "bn_fwd_" in name or "bn_bwd_" in name


def profile_step(mod, batch, steady_ms, groups=()):
    """One more step under torch.profiler: device time by kernel (by
    :func:`print_kernel_groups`, with ``groups`` first).  A step that
    fails fails the phase; a profiler that records no device time is
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

    kernels = [e for e in prof.key_averages() if _dev_us(e) > 0
               and e.device_type.name == "CUDA"]
    total = sum(_dev_us(e) for e in kernels) / 1e3
    if total <= 0:
        print("profile: the profiler recorded no device time (not "
              "measured)", flush=True)
        return None
    bn = sum(_dev_us(e) for e in kernels if _is_bn_kernel(e.key)) / 1e3
    print("profile of one step (wall %.2f ms under the profiler, "
          "steady step %.2f ms): device busy %.2f ms (idle share %.1f%% "
          "of the profiled wall time), K1+K2 kernels %.2f ms (%.1f%% of "
          "device time)" % (wall, steady_ms, total,
                            100 * max(0.0, 1 - total / wall), bn,
                            100 * bn / total), flush=True)
    print_kernel_groups(kernels, total, groups=groups)
    return max(0.0, 1 - total / wall)


def print_kernel_groups(kernels, total, label="profile", groups=()):
    """Prints the device time of profiled ``kernels`` by group (``groups``,
    ``(name, test of the lowercase kernel name)`` pairs, then cuDNN
    convolutions, K1/K2, ...) and the twelve longest."""
    rules = tuple(groups) + (("bn_* (K1/K2)", _is_bn_kernel),
             ("convolution (cuDNN)", lambda k: any(w in k for w in (
                 "conv", "cudnn", "implicit_gemm", "wgrad", "dgrad",
                 "fprop", "winograd", "fft", "gemm_cf32"))),
             ("memcpy", lambda k: "memcpy" in k),
             ("optimizer (foreach)", lambda k: "multi_tensor" in k
              or "foreach" in k),
             ("pooling", lambda k: "pool" in k),
             ("concat (torch.cat)", lambda k: "catarray" in k),
             ("gemm", lambda k: "gemm" in k),
             ("add", lambda k: "add" in k))
    groups = {}
    for e in kernels:
        k = e.key.lower()
        name = next((n for n, test in rules if test(k)), "other")
        groups[name] = groups.get(name, 0.0) + _dev_us(e) / 1e3
    print("%s device time by group: %s" % (label, ", ".join(
        "%s %.2f ms (%.1f%%)" % (k, v, 100 * v / total)
        for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))),
        flush=True)
    top = sorted(kernels, key=_dev_us, reverse=True)[:12]
    for e in top:
        print("%s  %8.3f ms  x%-4d %s" % (label, _dev_us(e) / 1e3, e.count,
                                          e.key[:110]), flush=True)


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


def bn_plain_refused(bnk):
    """The plain BatchNorm versions refused on the card: the path must
    take K1 and K2."""
    return plain_refused((bnk, "bn_fwd_plain"), (bnk, "bn_bwd_plain"))


def _bn_kernel_runs(prof):
    """Executions of K1/K2's CUDA kernels in a profile."""
    return sum(e.count for e in prof.key_averages()
               if _is_bn_kernel(e.key))


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
    return dict(step_ms=steady, floor=dict(zip(names, floor)),
                launches=launches)


PROFILE_ROUNDS = 3


def eager_and_replayed_bn_runs(mx, mod, batch):
    """Eager and replayed steps of the sync-free ``mod`` on ``batch``
    (copied to the card first), in turns, each under torch.profiler:
    ``{"eager": (K1/K2 kernel executions, replays), "replayed": (...,
    ...), "rounds": [(eager count, replayed count, eager device events,
    replayed device events), ...], "profile": the last replayed step's
    profile}``.  The profiler can lose a kernel's record but never adds
    one (runs on the card have counted 107 or 108 of a step's 110 K1/K2
    kernels, eager or replayed, while the next step counted 110), and a
    replay runs one fixed graph, so a kernel missing from the graph is
    missing from every replayed round: each count is the largest over
    the rounds, and the rounds stop once these agree (at most
    ``PROFILE_ROUNDS``).  Raises unless the replay ran as many K1/K2
    kernels as the eager step, and every replayed step one replay."""
    from torch.profiler import ProfilerActivity, profile

    dev_batch = mx.io.DataBatch(
        data=[mx.nd.NDArray(batch.data[0]._t.cuda())],
        label=[mx.nd.NDArray(batch.label[0]._t.cuda())])
    rounds, replays = [], {"eager": [], "replayed": []}
    for _ in range(PROFILE_ROUNDS):
        got = {}
        for name, fused in (("eager", "0"), ("replayed", "1")):
            with environment({"MXNET_FUSE_TRAIN_STEP": fused}):
                before = mod._exec.graph_replays
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    _profile_pad(dev_batch.data[0]._t.device)
                    mod.forward_backward(dev_batch)
                    mod.update()
                    torch.cuda.synchronize()
                events = sum(e.count for e in prof.key_averages()
                             if e.device_type.name == "CUDA")
                got[name] = (_bn_kernel_runs(prof), events)
                replays[name].append(mod._exec.graph_replays - before)
        rounds.append((got["eager"][0], got["replayed"][0],
                       got["eager"][1], got["replayed"][1]))
        eager = max(r[0] for r in rounds)
        replayed = max(r[1] for r in rounds)
        if eager == replayed:
            break
    runs = {"eager": (eager, max(replays["eager"])),
            "replayed": (replayed, max(replays["replayed"])),
            "rounds": rounds, "profile": prof}
    print("profiled rounds (eager K1/K2, replayed K1/K2, eager device "
          "events, replayed device events): %s; replays a step %s"
          % (rounds, replays), flush=True)
    if set(replays["replayed"]) != {1} or replayed != eager or eager == 0:
        raise RuntimeError("the replayed step ran %s K1/K2 kernels, the "
                           "eager step %s (rounds %s, replays %s)"
                           % (replayed, eager, rounds, replays))
    return runs


def sync_free_profiles(mx, bnk, mod, x, y):
    """After the main path: (1) eager and replayed steps on the same
    module in turns (:func:`eager_and_replayed_bn_runs`), each under
    torch.profiler: the replay must run as many K1/K2 kernels as the
    eager step (51 calls: 49 resident, one kernel each, and 2 chunked,
    three each, a direction); (2) one more epoch of
    the main path's ``fit`` (the same switches, prefetch, device metric
    and Speedometer; the graph is captured, so every step replays),
    profiled from an idle card: the device's idle share between its
    first and last kernel, and how much of the host-to-device copies of
    the batches ran while kernels of the steps ran."""
    from torch.profiler import ProfilerActivity, profile

    it = mx.io.NDArrayIter(x, y, batch_size=TRAIN_BATCH)
    batch = next(it)
    runs = eager_and_replayed_bn_runs(mx, mod, batch)
    print("sync-free profile: K1/K2 kernel executions in one eager step %d, "
          "in one replayed step %d (replays in that step %d; the plan "
          "gives 110: 49 resident calls of one kernel and 2 chunked of "
          "three, each direction)" % (runs["eager"][0], runs["replayed"][0],
                                      runs["replayed"][1]), flush=True)

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


def step_updates(mx, make_module, ctx, x, y, seed):
    """One fit step of ``make_module(mx, ctx)`` from seeded Xavier weights
    on ``ctx``: ({name: update}, {aux name: value}, {name: value after the
    step}) as numpy."""
    it = mx.io.NDArrayIter(x, y, batch_size=x.shape[0])
    mod = make_module(mx, ctx)
    mod.bind(it.provide_data, it.provide_label)
    mx.init.seed(seed)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    before = mx.convert.module_params_to_numpy(mod)[0]
    mod.fit(it, num_epoch=1, optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    arg, aux = mx.convert.module_params_to_numpy(mod)
    return {k: arg[k] - before[k] for k in arg}, aux, arg


def parity_phase(mx, bnk, seed, make_module=_resnet50_module,
                 net="ResNet-50", image=(3, 224, 224), pixels=(0, 255),
                 step=step_updates, data=None, perturb=1e-7,
                 bound="tensor", reorder=False):
    """One fit step of the same network (``make_module``'s, named ``net``)
    on the card and on the CPU, on a
    ``PARITY_BATCH`` of ``image``-shaped inputs uniform in ``pixels``
    (or on ``data``, an ``(x, y)`` pair), through ``step`` (by default
    :func:`step_updates`; SSD's takes its detection labels); the floor's
    inputs are perturbed by ``perturb`` relative.  With ``bound="global"``
    the distance over all updates is held within 3x the largest perturbed
    one, and the per-tensor ratios are printed, not bounded.  With
    ``reorder`` the floor also takes the distance of the CPU step taken
    on one thread, which sums the same f32 terms in another order: a sum
    whose terms cancel (a bias gradient over thousands of positions)
    rounds by ~1 ulp of the sum of its terms' magnitudes whatever the
    input, so no input perturbation measures its floor.

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
    if data is None:
        x = rng.uniform(*pixels, (PARITY_BATCH,) + tuple(image)).astype(
            np.float32)
        y = rng.integers(0, 1000, PARITY_BATCH).astype(np.float32)
    else:
        x, y = data
    xps = [(x * (1 + perturb * rng.standard_normal(x.shape))).astype(
        np.float32) for _ in range(PARITY_PERTURBATIONS)]
    t = time.perf_counter()
    gu, gaux, _ = step(mx, make_module, mx.gpu(0), x, y, seed)
    gs = time.perf_counter() - t
    with bn_rerouted(bnk, lambda kernel, plain: plain):
        qu = step(mx, make_module, mx.gpu(0), x, y, seed)[0]
    t = time.perf_counter()
    cu, caux, cvals = step(mx, make_module, mx.cpu(), x, y, seed)
    cs = time.perf_counter() - t
    pus = [step(mx, make_module, mx.cpu(), xp, y, seed)[0] for xp in xps]
    witnesses = list(pus)
    if reorder:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            witnesses.append(step(mx, make_module, mx.cpu(), x, y, seed)[0])
        finally:
            torch.set_num_threads(threads)

    names = sorted(cu)
    norm = math.sqrt(sum(float(np.sum(cu[k] ** 2)) for k in names))

    def dists(a, b):
        return np.array([float(np.linalg.norm(a[k] - b[k])) for k in names])

    # no tensor is held below f32 rounding: one ulp of each of its values,
    # or f32's epsilon of the whole update's norm
    ulp = np.array([float(np.linalg.norm(np.spacing(cvals[k])))
                    for k in names])
    least = np.maximum(ulp, np.finfo(np.float32).eps * norm)
    perturbed = np.maximum(np.max([dists(p, cu) for p in pus], axis=0),
                           least)
    floor = np.maximum(np.max([dists(p, cu) for p in witnesses], axis=0),
                       least)
    card, plain_bn = dists(gu, cu), dists(gu, qu)
    ratio = card / np.maximum(floor, 1e-30)
    worst = int(np.argmax(ratio))
    wq = int(np.argmax(plain_bn / np.maximum(floor, 1e-30)))
    gb = [i for i, k in enumerate(names) if k.endswith(("_gamma", "_beta"))]
    gbw = gb[int(np.argmax(ratio[gb]))] if gb else worst

    def glob(d):
        return math.sqrt(float(np.sum(d ** 2))) / norm

    aux_err = max([np.abs(gaux[k] - caux[k]).max() / (1e-5 + 1e-4 * np.abs(
        caux[k]).max()) for k in caux], default=0.0)
    print("parity one fit step b%d %s, card (%.2f s) vs CPU plain "
          "versions (%.2f s): updates differ by %.3g of their norm, the CPU "
          "on %d inputs perturbed by %.0e relative by %s; per tensor, card distance over the "
          "largest witness distance: median %.3g, worst %.3g at %s "
          "(limit 3), worst gamma/beta %.3g at %s; witness with the plain "
          "BatchNorm on the card: it differs from the card's kernel step by "
          "%.3g of the norm, worst %.3g of the floor at %s (not bounded); "
          "moving-stat error %.3g of its limit"
          % (x.shape[0], net, gs, cs, glob(card), PARITY_PERTURBATIONS, perturb,
             ["%.3g" % glob(dists(p, cu)) for p in pus], np.median(ratio),
             ratio[worst], names[worst], ratio[gbw], names[gbw],
             glob(plain_bn), plain_bn[wq] / max(floor[wq], 1e-30),
             names[wq], aux_err), flush=True)
    if reorder:
        alone = card / np.maximum(perturbed, 1e-30)
        wp = int(np.argmax(alone))
        print("parity %s: the CPU step on one thread differs from it by "
              "%.3g of the norm; against the perturbed floor alone the "
              "worst tensor stands at %.3g (%s: card distance %.3g, one "
              "thread %.3g, perturbed %.3g)"
              % (net, glob(dists(witnesses[-1], cu)), alone[wp], names[wp],
                 card[wp], dists(witnesses[-1], cu)[wp], perturbed[wp]),
              flush=True)
    if bound == "global":
        limit = max(glob(dists(p, cu)) for p in pus)
        if not glob(card) <= 3 * limit:
            raise RuntimeError("card and CPU updates of %s disagree by %.3g "
                               "of their norm, beyond 3x the perturbed %.3g"
                               % (net, glob(card), limit))
    elif not ratio[worst] <= 3:
        raise RuntimeError("card and CPU updates of %s disagree beyond 3x "
                           "the f32 floor: %.3g vs %.3g" % (
                               names[worst], card[worst], floor[worst]))
    for k in caux:
        np.testing.assert_allclose(gaux[k], caux[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    return ratio[worst]


# -- Inception-v3 of train_imagenet.py (phases 12 and 13) ---------------------
INCEPTION_IMAGE = (3, 299, 299)
#: BatchNorms of the network, each fix_gamma with a ReLU fused
INCEPTION_BNS = 94
#: train_imagenet.py's defaults: lr_step_epochs "30,60" over epochs of
#: num_examples 1024 / b128 = 8 batches
INCEPTION_LR_STEPS = (30 * 8, 60 * 8)
#: its BatchNorms' eps (the op's default)
INCEPTION_EPS = 1e-3


def _inception_module(mx, ctx=None):
    net = mx.models.get_symbol("inception-v3", num_classes=1000)
    return mx.mod.Module(net) if ctx is None \
        else mx.mod.Module(net, context=ctx)


def inception_bn_configs(mx, batch):
    """The BatchNorm configs of the Inception-v3 training step at
    ``batch``."""
    net = mx.models.get_symbol("inception-v3", num_classes=1000)
    return net_bn_configs(mx, net, (batch,) + INCEPTION_IMAGE)


def inception_data(seed, steps):
    """``steps`` seeded b128 batches as ``common/data.py``'s
    ``SyntheticDataIter`` makes them: data uniform in [-1, 1), labels
    uniform over the 1000 classes."""
    rng = np.random.default_rng(seed + 12)
    n = steps * TRAIN_BATCH
    x = rng.random((n,) + INCEPTION_IMAGE, dtype=np.float32) * 2 - 1
    y = rng.integers(0, 1000, n).astype(np.float32)
    return x, y


def inception_fit(mx, bnk, mod, it, seed, sync_free):
    """The main path of phase 12: ``mod.fit`` over ``it`` with
    ``common/fit.py``'s settings, the plain BatchNorm refused on the card,
    the K1/K2 counts set to 0 just before and read just after.  Returns
    (K1 launches, K2 launches, step ms from CUDA events between batch
    ends, fit seconds, metric values)."""
    metric = mx.metric.create("acc")
    sched = mx.lr_scheduler.MultiFactorScheduler(
        step=list(INCEPTION_LR_STEPS), factor=0.1)
    events = []

    def mark(_param):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    env = SYNC_FREE_ENV if sync_free else {
        k: None for k in SYNC_FREE_ENV}
    start = torch.cuda.Event(enable_timing=True)
    with environment(env), bn_plain_refused(bnk):
        mx.init.seed(seed)
        bnk.bn_fwd_cuda.launches = 0
        bnk.bn_bwd_cuda.launches = 0
        start.record()
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, eval_metric=metric, kvstore="local",
                batch_end_callback=[mark], optimizer="sgd",
                prefetch_to_device=sync_free,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 1e-4, "lr_scheduler": sched},
                initializer=mx.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = (bnk.bn_fwd_cuda.launches, bnk.bn_bwd_cuda.launches)
    if sync_free:
        # chunk ends, spread over the chunk's steps
        chunk_ms = [start.elapsed_time(events[BULK_K - 1])] + [
            events[i - BULK_K].elapsed_time(events[i])
            for i in range(2 * BULK_K - 1, len(events), BULK_K)]
        step_ms = [t / BULK_K for t in chunk_ms]
    else:
        step_ms = [start.elapsed_time(events[0])] + [
            a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return launches, step_ms, fit_s, dict(metric.get_name_value())


def inception_phase(mx, bnk, seed, steps):
    """Phase 12: ``Module.fit`` of full-width Inception-v3 (b128,
    3x299x299, f32) on the card, classic and then sync-free, over the same
    seeded batches.  Each run must launch K1 and K2 94 times a step (the
    sync-free run by the counters a replay adds), call no plain BatchNorm
    on the card and end with finite parameters; the sync-free run must
    replay its captured step in every step after the first, and a
    replayed step must run as many K1/K2 kernels as an eager one.  Prints
    step ms, images/s, peak memory and a profile of one step of each.
    Returns {"classic": ..., "sync_free": ...} with the launches."""
    x, y = inception_data(seed, steps)
    out = {}
    for sync_free in (False, True):
        name = "sync-free" if sync_free else "classic"
        it = mx.io.NDArrayIter(x, y, batch_size=TRAIN_BATCH)
        mod = _inception_module(mx)
        torch.cuda.reset_peak_memory_stats()
        launches, step_ms, fit_s, vals = inception_fit(
            mx, bnk, mod, it, seed, sync_free)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steady = float(np.median(step_ms[1:]))
        replays = mod._exec.graph_replays
        print("inception-v3 %s b%d f32 on the card: fit of %d steps %.2f s "
              "(init and bind included); step ms %s (%s); median after "
              "the first %.2f ms = %.1f images/s; graph replays %d; "
              "metrics %s; K1 launches %d, K2 launches %d; peak memory "
              "allocated %.2f GB"
              % (name, TRAIN_BATCH, steps, fit_s,
                 ["%.2f" % t for t in step_ms],
                 "CUDA events between chunk ends over the chunk's %d steps, "
                 "the first chunk with the warm-up and the capture" % BULK_K
                 if sync_free else "CUDA events between batch ends",
                 steady, TRAIN_BATCH / steady * 1e3, replays, vals,
                 launches[0], launches[1], peak_gb), flush=True)
        want = INCEPTION_BNS * steps
        if launches != (want, want):
            raise RuntimeError("inception-v3 %s: K1/K2 launched %s times in "
                               "%d steps, expected %d each per step"
                               % (name, launches, steps, INCEPTION_BNS))
        if sync_free and replays != steps - 1:
            raise RuntimeError("inception-v3 sync-free: the captured step "
                               "replayed %d times in %d steps"
                               % (replays, steps))
        arg, aux = mod.get_params()
        bad = [k for k, v in list(arg.items()) + list(aux.items())
               if not torch.isfinite(v._t).all()]
        if bad or not all(0 <= v <= 1 for v in vals.values()):
            raise RuntimeError("inception-v3 %s produced non-finite params "
                               "%s or metrics %s" % (name, bad[:5], vals))
        it.reset()
        batch = next(it)
        if sync_free:
            runs = eager_and_replayed_bn_runs(mx, mod, batch)
            prof = runs.pop("profile")
            print("inception-v3 sync-free profile: K1/K2 kernel executions "
                  "in one eager step %d, in one replayed step %d (replays "
                  "in that step %d)" % (runs["eager"][0],
                                        runs["replayed"][0],
                                        runs["replayed"][1]), flush=True)
            kernels = [e for e in prof.key_averages()
                       if _dev_us(e) > 0 and e.device_type.name == "CUDA"]
            total = sum(_dev_us(e) for e in kernels) / 1e3
            if total > 0:
                print("inception-v3 sync-free profile of one replayed "
                      "step: device busy %.2f ms" % total, flush=True)
                print_kernel_groups(kernels, total,
                                    "inception-v3 replayed step")
        else:
            with bn_plain_refused(bnk):
                profile_step(mod, batch, steady)
        out["sync_free" if sync_free else "classic"] = dict(
            launches=launches, step_ms=steady, peak_gb=peak_gb)
        del mod, it, arg, aux
        torch.cuda.empty_cache()
    return out


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


def lstm_plain_refused(rk):
    """The plain LSTM versions refused on the card: the path must take
    K4-K6."""
    return plain_refused(*((rk, k) for k in (
        "lstm_infer_plain", "lstm_fwd_plain", "lstm_bwd_plain")))


def _lstm_module(mx, lstm_lm, ctx=None, key=max(LSTM_BUCKETS), cell=None,
                 layout="TNC"):
    sym_gen = lstm_lm.make_sym_gen(
        cell or lstm_lm.build_cell(LSTM_HIDDEN, LSTM_LAYERS), LSTM_VOCAB,
        LSTM_EMBED, LSTM_HIDDEN, layout=layout)
    return mx.mod.BucketingModule(sym_gen, default_bucket_key=key) \
        if ctx is None else mx.mod.BucketingModule(
            sym_gen, default_bucket_key=key, context=ctx)


def lstm_training_phase(mx, rk, seed, keep=None):
    """``BucketingModule.fit`` of the fused-LSTM LM at full width on the
    card: every bucket, then one ``score`` pass on ``eval_data``; 2 K5 +
    2 K6 launches per training batch, 2 K4 per eval batch, no plain
    version on the card.  With a dict ``keep``, its ``"ms"`` gets the
    median step ms per bucket and ``"prefix"`` the epoch checkpoint,
    whose directory the caller then removes."""
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
        if keep is not None:
            keep.setdefault("ms", {})[key] = float(np.median(ms[1:]))
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
        if keep is None:
            import shutil
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        else:
            keep["prefix"] = prefix
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

    kernels = [e for e in prof.key_averages() if _dev_us(e) > 0
               and e.device_type.name == "CUDA"]
    total = sum(_dev_us(e) for e in kernels) / 1e3
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
        groups[name] = groups.get(name, 0.0) + _dev_us(e) / 1e3
    print("lstm profile of one T=%d training batch with its metric update: "
          "wall %.2f ms, device busy %.3f ms (idle share %.1f%%); by group: "
          "%s" % (max(LSTM_BUCKETS), wall, total,
                  100 * max(0.0, 1 - total / wall), ", ".join(
                      "%s %.3f ms" % kv for kv in sorted(
                          groups.items(), key=lambda kv: -kv[1]))),
          flush=True)
    for e in sorted(kernels, key=_dev_us, reverse=True)[:8]:
        print("lstm profile  %8.3f ms  x%-4d %s" % (
            _dev_us(e) / 1e3, e.count, e.key[:100]), flush=True)


def lstm_step_updates(mx, lstm_lm, ctx, params, ids, cell=None,
                      layout="TNC", draw_seed=None):
    """One training step of the full-width LM (``cell``, the fused one by
    default) from ``params`` on ``ctx``, the time-major ``ids`` fed in
    ``layout``: {name: update} as numpy.  With ``draw_seed``, the
    run-time generators are seeded from it before the step."""
    T = ids.shape[0]
    mod = _lstm_module(mx, lstm_lm, ctx, key=T, cell=cell, layout=layout)
    label = np.concatenate([ids[1:], np.zeros_like(ids[:1])])
    data = ids
    if layout == "NTC":
        data, label = np.ascontiguousarray(ids.T), \
            np.ascontiguousarray(label.T)
    mod.bind([("data", data.shape)], [("softmax_label", data.shape)])
    mod.init_params(mx.init.Zero())
    mx.convert.set_module_params(mod, params, {})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.02, "momentum": 0.0, "wd": 1e-5})
    batch = mx.io.DataBatch(
        [mx.nd.array(data)], [mx.nd.array(label)], bucket_key=T,
        provide_data=[mx.io.DataDesc("data", data.shape)],
        provide_label=[mx.io.DataDesc("softmax_label", data.shape)])
    if draw_seed is not None:
        mx.random.seed(draw_seed)
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


# -- BASELINE #1: train_mnist.py's LeNet and MLP (phase 14) -------------------
MNIST_BATCH, MNIST_EPOCHS = 64, 2
#: train_mnist.py's lr and lr_step_epochs "10" over synth_mnist's 2048
#: training examples (32 batches of 64 an epoch)
MNIST_LR, MNIST_LR_STEP = 0.05, 10 * (2048 // 64)
#: the optimizers common/fit.py's --optimizer can name besides sgd and
#: adam, each at a learning rate LeNet trains at (fit.py passes momentum
#: to sgd and nag only)
MNIST_OPTIMIZERS = (
    ("nag", {"learning_rate": 0.05, "momentum": 0.9}),
    ("dcasgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("sgld", {"learning_rate": 1e-3}),
    ("ccsgd", {"learning_rate": 0.05}),
    ("adagrad", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 1e-3}),
    ("rmsprop", {"learning_rate": 1e-3, "centered": True,
                 "clip_weights": 1.0}),
    ("adadelta", {}),
    ("test", {}),
)


def mnist_fit(mx, network, paths, ctx, seed, num_epoch=MNIST_EPOCHS,
              optimizer="sgd", params=None, perturb=None):
    """``train_mnist.py``'s fit of ``network`` on ``ctx`` over
    ``MNISTIter`` batches of the idx files at ``paths`` (flat for the
    MLP), Xavier weights from ``seed``; with ``perturb`` = (relative
    size, seed) the training images are scaled by 1 + that size times a
    seeded normal draw.  Returns (seconds, validation accuracy, training
    metrics, module)."""
    flat = network == "mlp"
    train = mx.io.MNISTIter(image=paths["train_img"],
                            label=paths["train_lab"],
                            batch_size=MNIST_BATCH, shuffle=True, flat=flat)
    if perturb is not None:
        rng = np.random.default_rng(perturb[1])
        inner = train._inner
        inner.data = [(k, (v * (1 + perturb[0] * rng.standard_normal(
            v.shape))).astype(np.float32)) for k, v in inner.data]
    val = mx.io.MNISTIter(image=paths["val_img"], label=paths["val_lab"],
                          batch_size=MNIST_BATCH, shuffle=False, flat=flat)
    with mx.name.NameManager():
        net = mx.models.get_symbol(network, num_classes=10)
    mod = mx.mod.Module(net, context=ctx)
    metric = mx.metric.CompositeEvalMetric(
        [mx.metric.Accuracy(), mx.metric.CrossEntropy()])
    if params is None:
        params = {"learning_rate": MNIST_LR, "momentum": 0.9,
                  "lr_scheduler": mx.lr_scheduler.MultiFactorScheduler(
                      step=[MNIST_LR_STEP], factor=0.1)}
    mx.init.seed(seed)
    t = time.perf_counter()
    mod.fit(train, num_epoch=num_epoch, eval_metric=metric,
            optimizer=optimizer, optimizer_params=dict(params, wd=1e-4),
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2))
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    (_, acc), = mod.score(val, "acc")
    return seconds, acc, dict(metric.get_name_value()), mod


def mnist_phase(mx, seed):
    """Phase 14: the synthetic MNIST of ``train_mnist.py`` written as idx
    files by the port's ``synth_mnist``, read through ``MNISTIter``;
    LeNet (4-D batches) and the MLP (``flat``) fit for two epochs on the
    card and, from the same seeded weights and batches, on the CPU: the
    card's validation accuracy must be finite and within 0.02 of the
    CPU's, or, where the fit is chaotic (at train_mnist.py's lr LeNet
    diverges from some seeds, in the JAX package too), within 3x the
    largest distance of the CPU's own accuracy on
    ``PARITY_PERTURBATIONS`` training sets perturbed by 1e-7, measured in
    the run.  Then one epoch of LeNet on the card with each other
    optimizer ``common/fit.py`` can name: its training loss
    (cross-entropy) and parameters must be finite."""
    with tempfile.TemporaryDirectory() as d:
        paths = mx.models.lenet.synth_mnist(d)
        for network in ("lenet", "mlp"):
            gs, gacc, gm, _ = mnist_fit(mx, network, paths, mx.gpu(0), seed)
            cs, cacc, cm, _ = mnist_fit(mx, network, paths, mx.cpu(), seed)
            spread = [abs(mnist_fit(mx, network, paths, mx.cpu(), seed,
                                    perturb=(1e-7, seed + i))[1] - cacc)
                      for i in range(PARITY_PERTURBATIONS)]
            limit = max(0.02, 3 * max(spread))
            print("mnist %s b%d, %d epochs of MNISTIter batches: validation "
                  "accuracy card %.4f (fit %.2f s), CPU %.4f (fit %.2f s), "
                  "difference %.4f (limit %.4f: 0.02, or 3x the CPU's own "
                  "spread on perturbed inputs %s); training metrics card "
                  "%s, CPU %s" % (network, MNIST_BATCH, MNIST_EPOCHS, gacc,
                                  gs, cacc, cs, abs(gacc - cacc), limit,
                                  ["%.4f" % v for v in spread], gm, cm),
                  flush=True)
            if not math.isfinite(gacc) or not abs(gacc - cacc) <= limit:
                raise RuntimeError("mnist %s: card accuracy %s against the "
                                   "CPU's %s" % (network, gacc, cacc))
        for name, params in MNIST_OPTIMIZERS:
            s, acc, m, mod = mnist_fit(mx, "lenet", paths, mx.gpu(0), seed,
                                       1, name, params)
            arg, _ = mod.get_params()
            finite = all(torch.isfinite(v._t).all() for v in arg.values())
            print("mnist lenet optimizer %s %s: one epoch %.2f s, training "
                  "metrics %s, validation accuracy %.4f, parameters finite "
                  "%s" % (name, params, s, m, acc, finite), flush=True)
            if not (finite and math.isfinite(m["cross-entropy"])):
                raise RuntimeError("mnist lenet with %s: loss %s, finite "
                                   "parameters %s" % (name, m, finite))


# -- the decode tier: LM serving over HTTP (phase 15) -------------------------
#: transformer_lm at GPT-2 medium's published widths (Radford et al. 2019,
#: Table 2, the 345M row; n_embd/n_head/n_layer/n_ctx of OpenAI's released
#: hparams.json); eos_id = vocab is unreachable, so lengths are exact
DECODE_WIDTHS = dict(vocab=50257, embed=1024, heads=16, layers=24, ffn=4096,
                     max_len=1024)
DECODE_SLOTS, DECODE_BUCKETS, DECODE_QUEUE = 32, (64, 128, 256, 512), 512
DECODE_REPLICAS, DECODE_BLOCK = 2, 16
DECODE_CLIENTS, DECODE_NEW, DECODE_PREFIX = 96, 128, 256
DECODE_PROMPT, DECODE_TEMP = (16, 480), 0.8
#: the step of one replica at which the failover run's step raises and
#: the swap run re-registers: midway through a replica's ~255 steps, when
#: its first 32 sessions hold ~113 of their 128 tokens, so the longest
#: migrated transcripts (prompts reach 480 tokens) outgrow the largest
#: prefill bucket (512) and re-prefill at max_len
DECODE_EVENT_STEP = 112
#: the token rule's near-tie margin, relative to the largest |score|: ten
#: times the step's measured distance from the teacher-forced forward and
#: from the CPU (2.0e-6 and 2.05e-6 of the largest |logit| on the H100)
TOKEN_RULE_MARGIN = 2e-5
#: decode steps in the profiled window
DECODE_PROFILE_STEPS = 20


def decode_traffic(seed, clients, vocab):
    """The phase's requests, drawn from ``seed`` before any client
    starts: prompt lengths uniform in ``DECODE_PROMPT``; half the clients
    share one ``DECODE_PREFIX``-token prefix (a system prompt) and draw
    their length above it; half greedy, half at ``DECODE_TEMP``; a
    quarter streamed; a sampling seed each."""
    rs = np.random.RandomState(seed + 15)
    lo, hi = DECODE_PROMPT
    prefix_len = DECODE_PREFIX
    prefix = rs.randint(0, vocab, prefix_len)
    roles = rs.permutation(clients)
    out = []
    for i in range(clients):
        r = int(roles[i])
        shared = r < clients // 2
        n = rs.randint(max(lo, prefix_len + 1) if shared else lo, hi + 1)
        tail = rs.randint(0, vocab, n - (prefix_len if shared else 0))
        prompt = np.concatenate([prefix, tail]) if shared else tail
        out.append({"prompt": [int(t) for t in prompt],
                    "max_new_tokens": DECODE_NEW,
                    "temperature": 0.0 if r % 2 == 0 else DECODE_TEMP,
                    "stream": (r // 2) % 4 == 0,
                    "seed": int(rs.randint(0, 1 << 31)),
                    "shared": bool(shared)})
    return out


def token_rule(got, want, gap, scale, margin=TOKEN_RULE_MARGIN):
    """``got`` and ``want`` agree token for token up to the first
    position where the reference's top-2 margin ``gap`` is under
    ``margin`` of its largest magnitude ``scale``.  Returns ``(ok,
    stop)``: ``stop`` is that near-tie position (None when there is
    none), or the first disagreeing one when ``ok`` is False."""
    n = min(len(got), len(want), len(gap))
    for i in range(n):
        if gap[i] < margin * scale[i]:
            return True, i
        if int(got[i]) != int(want[i]):
            return False, i
    if len(got) != len(want):
        return False, n
    return True, None


def step_bytes(cfg, slots, lengths=None):
    """Bytes one decode step must move: every weight but the embedding
    tables (their ``slots`` rows only), the logits written, and the K/V:
    at the step's fixed shape (each slot's ``max_len`` rows read, one row
    written) or, given ``lengths``, the rows this data attends (``length
    + 1`` per slot).  Returns ``(fixed, live)``; ``live`` is None without
    ``lengths``."""
    e, f, v, m, l = cfg.embed, cfg.ffn, cfg.vocab, cfg.max_len, cfg.layers
    weights = l * (2 * e + 3 * e * e + e * e + 2 * e * f) + e * v + e
    act = 2 * slots * e + slots * v
    row = 2 * l * e            # one position's K and V over all layers
    fixed = 4 * (weights + act + slots * m * row + slots * row)
    live = None if lengths is None else 4 * (
        weights + act + sum(int(n) + 1 for n in lengths) * row
        + slots * row)
    return fixed, live


def _decision_rows(tlm_mod, decode_mod, cfg, params, req, tokens):
    """The reference for one session's ``tokens``: the forward of its
    transcript, as the decision scores its sampler maximised (logits for
    greedy; ``logits / t + g`` at a temperature, ``g`` the session's own
    noise), reduced to ``(argmax, top-2 gap, largest |score|)`` per
    generated position, plus the forward's logits' largest magnitude."""
    p0 = len(req["prompt"])
    n = len(tokens)
    dev = params["embed"].device
    ids = np.asarray(req["prompt"] + list(tokens[:-1]), np.int64)[None]
    with torch.no_grad():
        lg = tlm_mod.forward_logits(cfg, params, ids)[0, p0 - 1:p0 - 1 + n]
        t = req["temperature"]
        if t > 0:
            g = decode_mod.gumbel_noise(
                torch.full((n,), req["seed"], dtype=torch.int64,
                           device=dev),
                torch.arange(p0, p0 + n, device=dev),
                torch.arange(cfg.vocab, device=dev))
            sc = lg / max(t, 1e-6) + g
        else:
            sc = lg
        top = sc.topk(2, dim=-1).values
        rows = (sc.argmax(-1).cpu().numpy(),
                (top[:, 0] - top[:, 1]).cpu().numpy(),
                sc.abs().amax(-1).cpu().numpy())
    return rows


def _http_generate(url, req, timeout=600):
    """One client: POST /generate (streamed or not) over its own
    connection; returns the tokens, the server's TTFT, the migrations the
    summary line reports and the failover lines of a stream."""
    import http.client
    from urllib.parse import urlparse

    u = urlparse(url)
    body = {k: req[k] for k in ("prompt", "max_new_tokens", "temperature",
                                "stream", "seed", "priority") if k in req}
    body["model"] = "lm"
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        conn.request("POST", "/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read().decode()
    finally:
        conn.close()
    if resp.status != 200:
        return {"status": resp.status, "error": data}
    if not req["stream"]:
        doc = json.loads(data)
        return {"status": 200, "tokens": doc["tokens"],
                "ttft_ms": doc["ttft_ms"], "migrations": None, "events": []}
    lines = [json.loads(x) for x in data.splitlines() if x.strip()]
    streamed = [x["token"] for x in lines if "token" in x]
    events = [x for x in lines if "event" in x]
    done = lines[-1]
    if not done.get("done") or done["tokens"] != streamed:
        return {"status": 200, "error": "stream and summary disagree: %r"
                % (done,)}
    return {"status": 200, "tokens": streamed, "ttft_ms": done["ttft_ms"],
            "migrations": done["migrations"], "events": events}


def _shed_total(mx):
    return mx.telemetry.counter_total("serving.shed.count")


def decode_run(mx, url, traffic, label, hook=None):
    """All clients at once (threads released together); ``hook`` runs in
    the caller's thread meanwhile.  Fails unless every request ends with
    its tokens and nothing was shed.  Returns the results in traffic order
    and the wall seconds."""
    results = [None] * len(traffic)
    go = threading.Event()

    def client(i):
        go.wait()
        try:
            results[i] = _http_generate(url, traffic[i])
        except Exception as e:  # noqa: broad-except — reported below
            results[i] = {"status": None, "error": repr(e)}

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(traffic))]
    for t in threads:
        t.start()
    shed0 = _shed_total(mx)
    t0 = time.perf_counter()
    go.set()
    if hook is not None:
        hook()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    bad = [(i, r) for i, r in enumerate(results)
           if r is None or r.get("error") or len(r["tokens"])
           != traffic[i]["max_new_tokens"]]
    if bad:
        raise RuntimeError("decode %s: %d of %d requests failed, first %r"
                           % (label, len(bad), len(traffic), bad[0]))
    shed = _shed_total(mx) - shed0
    if shed:
        raise RuntimeError("decode %s: %d sessions shed" % (label, shed))
    return results, wall


def _pool_stats(pool):
    """Totals over a pool's engines: steps, tokens, admissions."""
    reps = [r.engine for r in pool.replicas]
    steps = sum(e.steps for e in reps)
    tokens = sum(e.tokens_out for e in reps)
    resumed = sum(e.resumed for e in reps)
    return steps, tokens, resumed


def _gauge_max(mx, name, stop, out):
    """Samples gauge ``name`` of each replica until ``stop`` is set."""
    while not stop.wait(0.05):
        for r in range(DECODE_REPLICAS):
            v = mx.telemetry.gauge_value(name, model="lm", replica=str(r))
            if v is not None:
                out[0] = max(out[0], v)


def decode_serving_run(mx, tlm_mod, cfg, params, dev, traffic, layout,
                       engine_opts, label, hook_factory=None,
                       pool_opts=None):
    """One run of the traffic through ``lm_pool`` -> ``register`` ->
    ``ServingHTTPServer``; prints the run's metrics and returns its
    results, the registry, server and pool (left open for the caller)."""
    opts = dict(engine_opts, kv_layout=layout)
    if layout == "paged":
        opts["kv_block_size"] = DECODE_BLOCK
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    pool = mx.serving.lm_pool(cfg, params, n_replicas=DECODE_REPLICAS,
                              devices=[dev] * DECODE_REPLICAS,
                              engine_opts=opts, **(pool_opts or {}))
    t_build = time.perf_counter() - t_build
    reg = mx.serving.ModelRegistry(ctx=mx.cpu())
    reg.register("lm", pool)
    server = mx.serving.ServingHTTPServer(reg, port=0).start()
    stop, peak_spg = threading.Event(), [0.0]
    sampler = threading.Thread(target=_gauge_max, daemon=True, args=(
        mx, "serving.kv.sessions_per_hbm_gb", stop, peak_spg))
    sampler.start()
    hook = hook_factory(pool, reg) if hook_factory else None
    try:
        results, wall = decode_run(mx, server.url, traffic, label, hook)
    finally:
        stop.set()
        sampler.join(timeout=5)
    served = reg.get("lm")
    steps, tokens, resumed = _pool_stats(pool)
    if served is not pool:
        s2, t2, r2 = _pool_stats(served)
        steps, tokens, resumed = steps + s2, tokens + t2, resumed + r2
    gen = sum(len(r["tokens"]) for r in results)
    admissions = len(traffic) + resumed
    decoded = tokens - admissions
    ttft = np.array([r["ttft_ms"] for r in results], np.float64)
    desc = served.describe()
    kv = desc["kv"] or {}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if layout == "dense":
        # a dense replica holds its slots' worth of sessions per GiB of
        # cache at most (the gauge is the paged engines')
        peak_spg[0] = DECODE_SLOTS / (kv["hbm_bytes"] / DECODE_REPLICAS
                                      / float(1 << 30))
    stats = {"wall_s": wall, "tokens_per_s": gen / wall,
             "ttft_p50_ms": float(np.percentile(ttft, 50)),
             "ttft_p99_ms": float(np.percentile(ttft, 99)),
             "steps": steps, "decoded": decoded,
             "occupancy": decoded / float(max(steps, 1) * DECODE_SLOTS),
             "seqs_per_step": decoded / float(max(steps, 1)),
             "peak_gb": peak, "build_s": t_build,
             "sessions_per_hbm_gb": peak_spg[0],
             "prefix_hits": kv.get("prefix_hits"),
             "cow_copies": kv.get("cow_copies"),
             "failovers": desc.get("failovers")}
    print("decode %s (%s, %d replicas of %d slots on %s): %d requests x "
          "%d tokens in %.3f s = %.1f tokens/s; TTFT p50 %.2f ms, p99 %.2f "
          "ms; %d steps, %d decoded tokens, mean slot occupancy %.3f, %.2f "
          "sequences a step; peak memory %.3f GB; sessions_per_hbm_gb %.3f "
          "(a replica's peak); prefix hits %s, COW copies %s; failovers %s; pools "
          "built in %.2f s"
          % (label, layout, DECODE_REPLICAS, DECODE_SLOTS, dev,
             len(traffic), traffic[0]["max_new_tokens"], wall,
             stats["tokens_per_s"], stats["ttft_p50_ms"],
             stats["ttft_p99_ms"], steps, decoded, stats["occupancy"],
             stats["seqs_per_step"], peak,
             stats["sessions_per_hbm_gb"], stats["prefix_hits"],
             stats["cow_copies"], stats["failovers"], t_build), flush=True)
    for eng in (r.engine for r in served.replicas):
        off = [t.device for t in eng.state_tensors() if t.device != dev]
        if off:
            raise RuntimeError("decode %s: replica %s holds tensors on %s"
                               % (label, eng.replica, off[:3]))
    return results, stats, (reg, server, pool)


def _close(stack):
    reg, server, _pool = stack
    server.stop()
    reg.close()


def hold_streams(label, traffic, refs, got, want, what, whole=False):
    """The token rule over every session: ``got[i]`` against ``want[i]``
    under the reference rows ``refs[i]``; with ``whole``, every stream
    must also equal ``want[i]`` in full.  Fails the phase on a
    disagreement; returns the count of near-tie stops."""
    ties = held = equal = 0
    for i, req in enumerate(traffic):
        best, gap, scale = refs[i]
        w = best if want is None else want[i]
        ok, stop = token_rule(got[i], w, gap, scale)
        held += len(got[i]) if stop is None else stop
        equal += list(got[i]) == [int(x) for x in w]
        if not ok:
            raise RuntimeError(
                "decode %s: session %d (%s, prompt %d) breaks the token "
                "rule at generated position %d: %d against %d"
                % (label, i, "greedy" if req["temperature"] == 0 else
                   "t=%g" % req["temperature"], len(req["prompt"]), stop,
                   int(got[i][stop]) if stop < len(got[i]) else -1,
                   int(w[stop]) if stop < len(w) else -1))
        ties += stop is not None
    print("decode %s: %s holds for all %d sessions by the token rule "
          "(%d stopped at a near tie, margin < %g of the largest |score|; "
          "%d of %d positions compared before a stop; %d streams equal in "
          "full)" % (label, what, len(traffic), ties, TOKEN_RULE_MARGIN,
                     held, sum(len(g) for g in got), equal), flush=True)
    if whole and equal != len(traffic):
        raise RuntimeError("decode %s: %d of %d streams differ from the "
                           "reference in full" % (label, len(traffic) - equal,
                                                  len(traffic)))
    return ties


def decode_card_vs_cpu(tlm_mod, cfg, params_cpu, params_dev, seed, steps=3,
                       prompt_len=64):
    """One prefill and ``steps`` decode steps of the model on the card
    against the port on the CPU (one slot), each step fed the CPU's
    argmax: each logits row within 1e-4 of the CPU's largest |logit|."""
    rs = np.random.RandomState(seed + 151)
    prompt = rs.randint(0, cfg.vocab, prompt_len).astype(np.int64)
    hd = cfg.embed // cfg.heads
    worst = 0.0
    caches = {}
    with torch.no_grad():
        outs = {}
        for name, p in (("cpu", params_cpu), ("card", params_dev)):
            dev = p["embed"].device
            last, ks, vs = tlm_mod.prefill_kv(cfg, p, prompt, prompt_len)
            shape = (cfg.layers, cfg.heads, 1, cfg.max_len, hd)
            ck = torch.zeros(shape, device=dev)
            cv = torch.zeros(shape, device=dev)
            ck[:, :, 0, :prompt_len] = torch.stack(ks)
            cv[:, :, 0, :prompt_len] = torch.stack(vs)
            caches[name] = (ck, cv)
            outs[name] = last[None]
        tok = int(outs["cpu"][0].argmax())
        for i in range(steps + 1):
            ref = outs["cpu"].float()
            err = (outs["card"].cpu() - ref).abs().max().item() \
                / ref.abs().max().item()
            worst = max(worst, err)
            if i == steps:
                break
            for name, p in (("cpu", params_cpu), ("card", params_dev)):
                dev = p["embed"].device
                ck, cv = caches[name]
                outs[name], _, _ = tlm_mod.decode_step_math(
                    cfg, p, ck, cv, torch.tensor([tok], device=dev),
                    torch.tensor([prompt_len + i], device=dev))
            tok = int(outs["cpu"][0].argmax())
    print("decode card against CPU: one prefill of %d tokens and %d steps "
          "at full width, worst logits error %.3e of the CPU's largest "
          "|logit| (limit 1e-4)" % (prompt_len, steps, worst), flush=True)
    if not worst <= 1e-4:
        raise RuntimeError("decode: card and CPU logits differ by %.3e"
                           % worst)
    return worst


def decode_dense_vs_paged(tlm_mod, cfg, params, traffic, slots):
    """One decode step of ``slots`` slots, each prefilled with a traffic
    prompt, through the dense cache and through block tables over a
    pool: the largest logit difference between the two, and between the
    step and the teacher-forced forward of the same transcripts."""
    dev = params["embed"].device
    hd = cfg.embed // cfg.heads
    mb = -(-cfg.max_len // DECODE_BLOCK)
    with torch.no_grad():
        ck = torch.zeros((cfg.layers, cfg.heads, slots, cfg.max_len, hd),
                         device=dev)
        cv = torch.zeros_like(ck)
        pk = torch.zeros((cfg.layers, cfg.heads, slots * mb + 1,
                          DECODE_BLOCK, hd), device=dev)
        pv = torch.zeros_like(pk)
        tables = (1 + torch.arange(slots * mb, device=dev)).reshape(
            slots, mb)
        last_tok, lengths, fwd = [], [], []
        for s in range(slots):
            prompt = np.asarray(traffic[s]["prompt"], np.int64)
            n = len(prompt)
            last, ks, vs = tlm_mod.prefill_kv(cfg, params, prompt, n)
            ck[:, :, s, :n] = torch.stack(ks)
            cv[:, :, s, :n] = torch.stack(vs)
            tlm_mod.prefill_kv_paged(cfg, params, pk, pv, tables[s], prompt,
                                     0, n)
            tok = int(last.argmax())
            last_tok.append(tok)
            lengths.append(n)
            fwd.append(tlm_mod.forward_logits(
                cfg, params, np.append(prompt, tok)[None])[0, -1])
        lt = torch.tensor(last_tok, device=dev)
        ln = torch.tensor(lengths, device=dev)
        dense, _, _ = tlm_mod.decode_step_math(cfg, params, ck, cv, lt, ln)
        paged, _, _ = tlm_mod.decode_step_paged(cfg, params, pk, pv, tables,
                                                lt, ln)
        fwd = torch.stack(fwd)
        d_dp = (dense - paged).abs().max().item()
        d_fwd = (dense - fwd).abs().max().item()
        scale = fwd.abs().max().item()
    del ck, cv, pk, pv
    print("decode one step of %d slots: dense against paged max |logit "
          "difference| %.3e; step against the teacher-forced forward %.3e "
          "(%.3e of the largest |logit|)" % (slots, d_dp, d_fwd,
                                              d_fwd / scale), flush=True)
    return d_dp, d_fwd / scale


def _drive_engine(eng, ticks):
    """``ticks`` iterations of a non-started engine's loop, driven from
    this thread (the measurement windows)."""
    eng._running = True
    state = eng._boot_state
    eng._boot_state = None
    for _ in range(ticks):
        state = eng._tick(state)
    eng._boot_state = state
    eng._running = False


def decode_step_profile(mx, decode_mod, cfg, params, dev, traffic, layout):
    """A dedicated engine with every slot busy (traffic prompts, sessions
    that outlast the windows): the step's wall time on its stream (CUDA
    events around the call, which mostly wait on the host's launches),
    its host enqueue and loop-iteration ms (host clock), its device ms
    (the kernels' busy time in a profiled window of 20 steps, which must
    also hold exactly 20 device-to-host copies, the packed buffers, and
    no other sync), the step's byte bound, one steady step's kernels by
    group, and each prefill bucket's ms."""
    from torch.profiler import ProfilerActivity, profile

    opts = dict(slots=DECODE_SLOTS, prefill_buckets=DECODE_BUCKETS,
                max_queue=DECODE_QUEUE, device=dev, name="lm-profile",
                autostart=False, kv_layout=layout)
    if layout == "paged":
        opts.update(kv_block_size=DECODE_BLOCK, kv_prefix_cache=False)
    eng = decode_mod.DecodeEngine(cfg, params, **opts)
    try:
        for req in traffic[:DECODE_SLOTS]:
            p = req["prompt"]
            eng.submit(p, max_new_tokens=min(400, cfg.max_len - len(p)),
                       temperature=req["temperature"], seed=req["seed"])
        _drive_engine(eng, 1 + 3)         # the admissions, then warm steps
        base = eng._step_fn
        marks = []

        def timed(*a):
            t0 = time.perf_counter()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record(eng._stream)
            out = base(*a)
            e1.record(eng._stream)
            marks.append((e0, e1, time.perf_counter() - t0))
            return out

        eng._step_fn = timed
        n = DECODE_PROFILE_STEPS
        t0 = time.perf_counter()
        _drive_engine(eng, n)
        tick_ms = (time.perf_counter() - t0) * 1e3 / n
        eng._step_fn = base
        enqueue_ms = 1e3 * sum(m[2] for m in marks) / len(marks)
        wall_ms = sum(a.elapsed_time(b) for a, b, _ in marks) / len(marks)
        lengths = [len(s.prompt) + len(s.tokens) - 1
                   for s in eng._slot_sessions if s is not None]
        fixed, live = step_bytes(cfg, DECODE_SLOTS, lengths)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _drive_engine(eng, n)
            torch.cuda.synchronize()
        evs = prof.events()
        copies = sum(1 for e in evs if "memcpy dtoh" in e.name.lower()
                     and e.device_type.name == "CUDA")
        sync_names = {}
        for e in evs:
            if e.device_type.name == "CPU" and e.name.startswith("cuda") \
                    and "synchronize" in e.name.lower():
                sync_names[e.name] = sync_names.get(e.name, 0) + 1
        print("decode %s synchronising runtime calls: %s"
              % (layout, sync_names), flush=True)
        syncs = sync_names.get("cudaStreamSynchronize", 0)
        kernels = [e for e in prof.key_averages() if _dev_us(e) > 0
                   and e.device_type.name == "CUDA"]
        dev_ms = sum(_dev_us(e) for e in kernels) / 1e3 / n
        print("decode step (%s, %d slots busy, lengths %d-%d): device %.3f "
              "ms (the kernels' busy time, profiler); step wall on the "
              "stream %.3f ms (CUDA events), host enqueue %.3f ms, loop "
              "iteration %.3f ms (host clock, the packed read included); "
              "byte bound %.3f ms at the fixed shape (%.3f GB), %.3f ms for "
              "the live lengths (%.3f GB) at 3.35 TB/s"
              % (layout, len(lengths), min(lengths), max(lengths), dev_ms,
                 wall_ms, enqueue_ms, tick_ms, fixed / PEAK_BYTES * 1e3,
                 fixed / 1e9, live / PEAK_BYTES * 1e3, live / 1e9),
              flush=True)
        print("decode %s profile of %d steps: %d device-to-host copies, %d "
              "stream synchronisations" % (layout, n, copies, syncs),
              flush=True)
        decode_kernel_groups(kernels, dev_ms, n, layout)
        if copies != n:
            raise RuntimeError("decode %s: %d device-to-host copies in %d "
                               "steps" % (layout, copies, n))
        if syncs != n:
            raise RuntimeError("decode %s: %d stream synchronisations in %d "
                               "steps" % (layout, syncs, n))
        # the sampling alone, at the step's shape
        logits = torch.randn(DECODE_SLOTS, cfg.vocab, device=dev)
        temps = torch.full((DECODE_SLOTS,), DECODE_TEMP, device=dev)
        seeds = torch.arange(DECODE_SLOTS, device=dev)
        pos = torch.full((DECODE_SLOTS,), 300, device=dev)
        vidx = torch.arange(cfg.vocab, device=dev)
        samp = _time_ms(lambda: decode_mod.sample_tokens(
            logits, temps, seeds, pos, vidx), 20)
        print("decode sampling alone (%d x %d, the hash and Gumbel-max): "
              "%.3f ms" % (DECODE_SLOTS, cfg.vocab, samp), flush=True)
        prefill, prefill_dev = {}, {}
        for b in DECODE_BUCKETS:
            toks = np.resize(np.asarray(traffic[0]["prompt"], np.int32), b)
            plan = None
            if layout == "paged":
                plan = mx.serving.kvblocks.AdmitPlan(0, 0, 0, False, 0)
            st = eng._boot_state

            def one():
                eng._prefill_fn(st, toks, b, 0, 0, 0.0, 0, False, plan)

            with torch.cuda.stream(eng._stream):
                prefill[b] = _time_ms(one, 3, warmup=1)
                with profile(activities=[ProfilerActivity.CUDA]) as pp:
                    for _ in range(3):
                        one()
                    torch.cuda.synchronize()
            prefill_dev[b] = sum(
                _dev_us(e) for e in pp.key_averages()
                if e.device_type.name == "CUDA") / 1e3 / 3
        print("decode %s prefill ms per bucket, device (the kernels' busy "
              "time, profiler) / wall on the stream (CUDA events): %s" % (
                  layout, ", ".join("%d: %.3f / %.3f" % (b, prefill_dev[b],
                                                         prefill[b])
                                    for b in DECODE_BUCKETS)), flush=True)
    finally:
        eng.close(drain=False)
    return {"step_ms": dev_ms, "wall_ms": wall_ms, "enqueue_ms": enqueue_ms,
            "tick_ms": tick_ms, "bound_fixed_ms": fixed / PEAK_BYTES * 1e3,
            "bound_live_ms": live / PEAK_BYTES * 1e3, "prefill_ms": prefill,
            "prefill_device_ms": prefill_dev, "copies": copies}


def decode_kernel_groups(kernels, per_step_total, n, layout):
    """One steady decode step's device time by group (cuBLAS products,
    softmax, the paged gather and index writes, the sampling hash and
    the other elementwise kernels), from a profiled window of ``n``."""
    rules = (("cuBLAS", lambda k: any(w in k for w in (
                 "gemm", "gemv", "cutlass", "xmma", "cublas"))),
             ("softmax", lambda k: "softmax" in k),
             ("gather/index", lambda k: "index" in k or "gather" in k),
             ("argmax/reduce", lambda k: "reduce" in k or "argmax" in k),
             ("memcpy", lambda k: "memcpy" in k),
             ("elementwise (the hash included)", lambda k: True))
    groups = {}
    for e in kernels:
        k = e.key.lower()
        name = next(g for g, test in rules if test(k))
        groups[name] = groups.get(name, 0.0) + _dev_us(e) / 1e3 / n
    print("decode %s step by group (ms a step): %s" % (layout, ", ".join(
        "%s %.3f (%.1f%%)" % (k, v, 100 * v / per_step_total)
        for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))),
        flush=True)
    for e in sorted(kernels, key=_dev_us, reverse=True)[:8]:
        print("decode %s  %8.3f ms a step  x%-5d %s" % (
            layout, _dev_us(e) / 1e3 / n, e.count, e.key[:100]), flush=True)


def _at_step(eng, step, action):
    """Wraps ``eng``'s step function: ``action()`` runs once, inside the
    call that starts when ``eng.steps == step``, before the step."""
    base = eng._step_fn
    fired = []

    def wrapped(*a):
        if eng.steps == step and not fired:
            fired.append(step)
            action()
        return base(*a)

    eng._step_fn = wrapped
    return fired


def _long_migrations(label, lengths):
    """Fails unless some migrated transcript outgrew the largest prefill
    bucket (so the phase re-prefilled one at max_len); prints them."""
    long = [n for n in lengths if n > DECODE_BUCKETS[-1]]
    print("decode %s: %d transcripts migrated, %d past the largest prefill "
          "bucket %d (longest %d tokens)" % (label, len(lengths), len(long),
                                             DECODE_BUCKETS[-1],
                                             max(lengths, default=0)),
          flush=True)
    if not long:
        raise RuntimeError("decode %s: no migrated transcript outgrew the "
                           "largest prefill bucket" % label)


def decode_phase(mx, seed):
    """Phase 15 (see the module docstring)."""
    from mxnet_tpu_torch.models import transformer_lm as tlm
    from mxnet_tpu_torch.serving import decode as dmod

    dev = torch.device("cuda", 0)
    cfg = tlm.LMConfig(eos_id=DECODE_WIDTHS["vocab"], **DECODE_WIDTHS)
    t_phase = time.perf_counter()
    times, mark = {}, [t_phase]

    def lap(name):
        now = time.perf_counter()
        times[name] = now - mark[0]
        mark[0] = now

    params_cpu = tlm.init_params(cfg, seed=seed)
    params = tlm.params_to(params_cpu, dev)
    n_params = sum(v.numel() for p in params.values()
                   for v in (p.values() if isinstance(p, dict) else [p]))
    print("decode model: transformer_lm vocab %d, embed %d, %d heads, %d "
          "layers, ffn %d, max_len %d: %.1f M parameters (%.3f GB f32); "
          "dense KV %.3f GB a replica at %d slots"
          % (cfg.vocab, cfg.embed, cfg.heads, cfg.layers, cfg.ffn,
             cfg.max_len, n_params / 1e6, 4 * n_params / 1e9,
             2 * cfg.layers * DECODE_SLOTS * cfg.max_len * cfg.embed * 4
             / 1e9, DECODE_SLOTS), flush=True)
    traffic = decode_traffic(seed, DECODE_CLIENTS, cfg.vocab)
    lap("weights")
    engine_opts = {"slots": DECODE_SLOTS, "prefill_buckets": DECODE_BUCKETS,
                   "max_queue": DECODE_QUEUE}
    mx.telemetry.enable()
    out = {}

    # A: dense, B: paged with the prefix cache
    res_a, out["dense"], stack = decode_serving_run(
        mx, tlm, cfg, params, dev, traffic, "dense", engine_opts, "run A")
    _close(stack)
    lap("run A")
    res_b, out["paged"], stack = decode_serving_run(
        mx, tlm, cfg, params, dev, traffic, "paged", engine_opts, "run B")
    if not out["paged"]["prefix_hits"]:
        raise RuntimeError("decode: the paged run took no prefix hit")
    # a retry: one shared prompt sent twice in a row to the idle pool
    # (both land on replica 0); the second admission hits the prefix
    # cache at n - 1 and copies the partial tail block on write
    retry = next(i for i, r in enumerate(traffic) if r["shared"]
                 and (len(r["prompt"]) - 1) % DECODE_BLOCK)
    pool_b = stack[2]
    cow0 = pool_b.describe()["kv"]["cow_copies"]
    res_r = [decode_run(mx, stack[1].url, [traffic[retry]], "run B retry")
             [0][0] for _ in range(2)]
    out["paged"]["cow_copies"] = pool_b.describe()["kv"]["cow_copies"]
    if out["paged"]["cow_copies"] <= cow0:
        raise RuntimeError("decode: the retried prompt took no "
                           "copy-on-write")
    print("decode run B retry: client %d's prompt (%d tokens) twice on the "
          "idle pool: copy-on-write copies %d -> %d"
          % (retry, len(traffic[retry]["prompt"]), cow0,
             out["paged"]["cow_copies"]), flush=True)
    _close(stack)
    lap("run B and its retry")
    streams_a = [r["tokens"] for r in res_a]
    t0 = time.perf_counter()
    refs = [_decision_rows(tlm, dmod, cfg, params, req, streams_a[i])
            for i, req in enumerate(traffic)]
    print("decode references: %d teacher-forced forwards in %.2f s"
          % (len(refs), time.perf_counter() - t0), flush=True)
    lap("references")
    greedy = [i for i, r in enumerate(traffic) if r["temperature"] == 0]
    g_tr = [traffic[i] for i in greedy]
    ties = hold_streams("run A", g_tr, [refs[i] for i in greedy],
                        [streams_a[i] for i in greedy], None,
                        "greedy decode = argmax of the forward")
    ties += hold_streams("run A", traffic, refs, streams_a, None,
                         "each token = the argmax of its decision scores")
    ties += hold_streams("run B", traffic, refs,
                         [r["tokens"] for r in res_b], streams_a,
                         "paged = dense", whole=True)
    ties += hold_streams("run B retry", [traffic[retry]] * 2,
                         [refs[retry]] * 2, [r["tokens"] for r in res_r],
                         [streams_a[retry]] * 2,
                         "the copied-on-write retries = dense")

    # C: failover — one replica's step raises mid-run
    migrated_seeds, migrated_lens = [], []

    def failover(pool, _reg):
        eng = pool.replicas[1].engine

        def boom():
            raise RuntimeError("injected step failure (phase 15)")

        _at_step(eng, DECODE_EVENT_STEP, boom)
        base = pool._migrate_sessions

        def noted(rid, sessions, exc, **kw):
            migrated_seeds.extend(x.seed for x in sessions)
            migrated_lens.extend(x.prompt.size + len(x.tokens)
                                 for x in sessions)
            return base(rid, sessions, exc, **kw)

        pool._migrate_sessions = noted
        return None

    res_c, out["failover"], stack = decode_serving_run(
        mx, tlm, cfg, params, dev, traffic, "dense", engine_opts,
        "run C (failover)", failover, {"quarantine_after": 1})
    reg, server, pool = stack
    migrated = [i for i, r in enumerate(traffic)
                if r["seed"] in set(migrated_seeds)]
    moved = sum(e.resumed for e in (r.engine for r in pool.replicas))
    ties += hold_streams("run C", traffic, refs,
                         [r["tokens"] for r in res_c], streams_a,
                         "failover = uninterrupted")
    deadline = time.monotonic() + 60
    while pool._circuit[1] != mx.serving.pool.CIRCUIT_HALF_OPEN:
        if time.monotonic() > deadline:
            raise RuntimeError("decode: replica 1 never re-warmed "
                               "(circuit %s)" % pool._circuit[1])
        time.sleep(0.02)
    probes = [pool.generate(traffic[i % len(traffic)]["prompt"][:16],
                            max_new_tokens=4)
              for i in range(DECODE_SLOTS + 8)]
    for s in probes:
        s.result(120)
    kinds = [e["event"] for e in mx.telemetry.events_recent(5000)
             if e.get("replica") == "1" and e["event"].startswith(
                 "serving.pool.")]
    want = ["serving.pool.circuit_open", "serving.pool.rewarmed",
            "serving.pool.circuit_half_open", "serving.pool.circuit_close"]
    seen = [k for k in kinds if k in want]
    if pool._circuit[1] != mx.serving.pool.CIRCUIT_CLOSED \
            or seen[-4:] != want:
        raise RuntimeError("decode: breaker of replica 1 went %r, now %s"
                           % (seen, pool._circuit[1]))
    print("decode run C: replica 1 failed at its step %d; %d sessions "
          "re-prefilled on replica 0 (%d clients migrated, %d greedy; %d "
          "streams carried the failover line), every stream equal to run "
          "A by the token rule; breaker %s"
          % (DECODE_EVENT_STEP, moved, len(migrated),
                          sum(traffic[i]["temperature"] == 0
                              for i in migrated),
             sum(1 for r in res_c if r["events"]), " -> ".join(
                                  k.split(".")[-1] for k in seen[-4:])),
          flush=True)
    if not any(traffic[i]["temperature"] == 0 for i in migrated):
        raise RuntimeError("decode: no greedy session was migrated")
    _long_migrations("run C", migrated_lens)
    _close(stack)
    lap("run C and the breaker")

    # D: version swap — register a new pool with the same params mid-run
    new_pool = mx.serving.lm_pool(cfg, params, n_replicas=DECODE_REPLICAS,
                                  devices=[dev] * DECODE_REPLICAS,
                                  engine_opts=dict(engine_opts,
                                                   kv_layout="dense"))
    swapped, adopted_lens = [], []
    adopt = new_pool.adopt

    def noted_adopt(sess):
        adopted_lens.append(sess.prompt.size + len(sess.tokens))
        return adopt(sess)

    new_pool.adopt = noted_adopt

    def swap(pool, reg):
        go = threading.Event()
        _at_step(pool.replicas[0].engine, DECODE_EVENT_STEP, go.set)

        def run():
            if not go.wait(300):
                raise RuntimeError("decode: the swap run never reached "
                                   "its step %d" % DECODE_EVENT_STEP)
            reg.register("lm", new_pool)
            swapped.append(new_pool.describe()["failovers"])

        return run

    res_d, out["swap"], stack = decode_serving_run(
        mx, tlm, cfg, params, dev, traffic, "dense", engine_opts,
        "run D (version swap)", swap)
    if not swapped or not swapped[0]:
        raise RuntimeError("decode: the swap moved no session")
    ties += hold_streams("run D", traffic, refs,
                         [r["tokens"] for r in res_d], streams_a,
                         "version swap = uninterrupted")
    print("decode run D: register('lm', new pool) at step %d of replica 0 "
          "moved %d in-flight sessions to version %d"
          % (DECODE_EVENT_STEP, swapped[0], new_pool.version), flush=True)
    _long_migrations("run D", adopted_lens)
    _close(stack)
    del stack, pool, new_pool, reg, server
    lap("run D")

    out["near_ties"] = ties
    out["dense_vs_paged"], out["step_vs_forward"] = decode_dense_vs_paged(
        tlm, cfg, params, traffic, DECODE_SLOTS)
    lap("dense against paged")
    out["card_vs_cpu"] = decode_card_vs_cpu(tlm, cfg, params_cpu, params,
                                            seed)
    lap("card against CPU")
    for layout in ("dense", "paged"):
        out["profile_" + layout] = decode_step_profile(
            mx, dmod, cfg, params, dev, traffic, layout)
    lap("profiles")
    print("decode phase: %.1f s (%s)" % (
        time.perf_counter() - t_phase,
        ", ".join("%s %.1f s" % kv for kv in times.items())), flush=True)
    # phase 16 serves the same model and traffic and holds its streams to
    # run A's
    out["reuse"] = dict(cfg=cfg, params=params, traffic=traffic,
                        streams=streams_a, refs=refs)
    return out


# -- the fleet control plane over the decode tier (phase 16) ------------------
#: the controller's tick, and run E's autoscale policy: the SLO on the
#: windowed TTFT p99, two breach ticks to scale up, five slack ticks to
#: scale down, 2 s of cooldown after each scale, at most three replicas,
#: three to the card
FLEET_INTERVAL_MS = 200
FLEET_SLO_MS = 1000.0
FLEET_BREACH_TICKS, FLEET_SLACK_TICKS, FLEET_COOLDOWN_S = 2, 5, 2.0
FLEET_PER_DEVICE = FLEET_MAX_REPLICAS = 3
#: run E's arrivals: the first FLEET_BURST clients at once (twice one
#: replica's slots, so the second 32 queue behind the first and breach the
#: SLO when their turn comes), the rest one at a time over FLEET_TRICKLE_S
#: seconds from FLEET_TRICKLE_AT on: past the burst's last session on a
#: slow host too, so that the youngest replica holds live sessions when
#: the controller scales down
FLEET_BURST, FLEET_TRICKLE_AT, FLEET_TRICKLE_S = 64, 3.0, 30.0
#: runs F and G send every other client of the 96
FLEET_STRIDE = 2
#: run F: the kill fires at the pool's step FLEET_KILL_STEP of each
#: replica (midway through their 128-token sessions; the fault point counts
#: the steps of both), the second kill FLEET_KILL2_STEPS steps after the
#: controller replaced the first
FLEET_KILL_STEP, FLEET_KILL2_STEPS = 64, 8
#: run G: half the clients below the pool's priority floor; arrivals every
#: FLEET_G_GAP_S; an SLO under any prefill's wall time (13.8-21.1 ms at
#: 64-512 tokens on an H100 80GB HBM3 at 700 W), so every tick that sees
#: a first token breaches: the run holds the shedding lever, not the
#: threshold
FLEET_LOW, FLEET_FLOOR = 1, 5
FLEET_G_GAP_S, FLEET_G_SLO_MS = 0.1, 10.0
#: how long a run waits for a decision or for the fleet to settle
FLEET_WAIT_S = 60


def fleet_arrivals(n, burst, trickle_at, trickle_s):
    """Arrival offsets (seconds) of ``n`` clients: the first ``burst`` at
    0, the rest evenly over ``[trickle_at, trickle_at + trickle_s)``."""
    rest = n - burst
    return [0.0] * min(burst, n) + [trickle_at + trickle_s * i / rest
                                    for i in range(rest)]


def fleet_priorities(n, seed):
    """Half of ``n`` clients at ``FLEET_LOW``, half at ``FLEET_FLOOR``, in
    an order drawn from ``seed``."""
    rs = np.random.RandomState(seed + 16)
    pr = [FLEET_LOW] * (n // 2) + [FLEET_FLOOR] * (n - n // 2)
    return [int(p) for p in rs.permutation(pr)]


def replica_timeline(samples):
    """``[(t, live replicas)]`` samples reduced to their changes."""
    out = []
    for t, n in samples:
        if not out or out[-1][1] != n:
            out.append((t, n))
    return out


def check_timeline(label, timeline, start, peak, end):
    """The live replica count starts at ``start``, reaches at least
    ``peak`` and at most ``FLEET_MAX_REPLICAS``, and ends at ``end``."""
    counts = [n for _t, n in timeline]
    if not counts or counts[0] != start or max(counts) < peak \
            or max(counts) > FLEET_MAX_REPLICAS or counts[-1] != end:
        raise RuntimeError("fleet %s: replica count went %s (want %d, then "
                           ">= %d, at most %d, ending at %d)"
                           % (label, counts, start, peak,
                              FLEET_MAX_REPLICAS, end))


def check_autoscale(decisions, migrated, burst_done):
    """Run E's decisions: a scale-up decided while the burst's sessions
    were still served, then, once the breach had cleared (the policy
    scales down only on slack), a scale-down whose replica handed live
    sessions to the survivors (``migrated``: replica -> sessions its
    removal migrated).  Returns the scale-ups and scale-downs."""
    ups = [d for d in decisions if d["action"] == "scale_up"]
    downs = [d for d in decisions if d["action"] == "scale_down"]
    if not any(d["t"] <= burst_done for d in ups):
        raise RuntimeError("fleet run E: no scale-up while the burst was "
                           "served (decisions %r)"
                           % [d["action"] for d in decisions])
    if not any(d["t"] > ups[0]["t"] and migrated.get(d["replica"], 0) > 0
               for d in downs):
        raise RuntimeError(
            "fleet run E: no scale-down moved live sessions (scale-downs "
            "%r, migrated %r)" % ([(d["t"] - ups[0]["t"], d["replica"])
                                   for d in downs], migrated))
    return ups, downs


def check_supervision(decisions):
    """Run F's supervision decisions: one restart, then the quarantine."""
    acts = [d["action"] for d in decisions
            if d["action"] in ("restart", "restart_failed", "quarantine")]
    if acts != ["restart", "quarantine"]:
        raise RuntimeError("fleet run F: supervision went %r, want "
                           "['restart', 'quarantine']" % acts)


def pressure_windows(events, t_end):
    """``[(on, off)]`` wall-time spans of the pool's shed pressure from its
    ``serving.pool.shed_pressure`` events (a span still open ends at
    ``t_end``)."""
    spans = []
    for e in events:
        if e["on"] and (not spans or spans[-1][1] is not None):
            spans.append([e["ts"], None])
        elif not e["on"] and spans and spans[-1][1] is None:
            spans[-1][1] = e["ts"]
    return [(a, t_end if b is None else b) for a, b in spans]


def check_shed(results, priorities, spans, margin=0.05, slack=0.25):
    """Run G: only clients under the floor are refused, each with a 429
    for its priority while the pressure was on (its request overlaps a
    span, ``margin`` seconds of clock slack either side); none sent well
    inside a span (``slack`` in from its ends) completes; every client at
    the floor or above completes.  Returns the indices shed and those
    under the floor that completed."""
    shed, low_done = [], []
    for i, (r, p) in enumerate(zip(results, priorities)):
        if r.get("status") == 429:
            err = r.get("error", "")
            inside = any(r["recv"] >= a - margin and r["sent"] <= b + margin
                         for a, b in spans)
            if p >= FLEET_FLOOR or "priority" not in err \
                    or "shed pressure" not in err or not inside:
                raise RuntimeError("fleet run G: client %d (priority %d) "
                                   "refused outside the pressure: %r"
                                   % (i, p, r))
            shed.append(i)
        elif r.get("error") or r.get("status") != 200:
            raise RuntimeError("fleet run G: client %d (priority %d) failed: "
                               "%r" % (i, p, r))
        elif p < FLEET_FLOOR:
            if any(a + slack <= r["sent"] <= b - slack for a, b in spans):
                raise RuntimeError("fleet run G: client %d (priority %d) "
                                   "sent under pressure was admitted" % (i, p))
            low_done.append(i)
    if not shed:
        raise RuntimeError("fleet run G: nothing was shed")
    return shed, low_done


def fleet_clients(url, traffic, offsets, priorities=None):
    """Each client posts its request (``_http_generate``) at its offset
    from the start, on its own thread; each result carries its send and
    receive wall times.  Returns the results and the start time."""
    results = [None] * len(traffic)
    t0 = time.time()

    def client(i):
        wait = t0 + offsets[i] - time.time()
        if wait > 0:
            time.sleep(wait)
        req = dict(traffic[i])
        if priorities is not None:
            req["priority"] = priorities[i]
        sent = time.time()
        try:
            r = _http_generate(url, req)
        except Exception as e:  # noqa: broad-except — checked by the caller
            r = {"status": None, "error": repr(e)}
        r["sent"], r["recv"] = sent, time.time()
        results[i] = r

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(traffic))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(r is None for r in results):
        raise RuntimeError("fleet: a client never returned")
    return results, t0


class _FleetWatch:
    """Samples a pool every 20 ms: its live replica count over time and
    the wall time of each replica's first emitted token."""

    def __init__(self, pool):
        self.pool = pool
        self.samples = []
        self.first_token = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.02):
            now = time.time()
            reps = list(self.pool.replicas)
            self.samples.append((now, sum(
                1 for r in reps if r.state == "active" and not r.dead)))
            for r in reps:
                if r.rid not in self.first_token and r.engine.tokens_out:
                    self.first_token[r.rid] = now

    def live(self):
        return self.samples[-1][1] if self.samples else None

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)


def _wait_until(cond, what, timeout=FLEET_WAIT_S):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise RuntimeError("fleet: %s" % what())
        time.sleep(0.05)


def _get_json(url, path):
    import urllib.request

    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return json.loads(resp.read().decode())


def _print_gets(label, url):
    """GET /fleet and /healthz, each printed on a line of its own behind
    its label; returns both documents."""
    fleet = _get_json(url, "/fleet")
    health = _get_json(url, "/healthz")
    print("fleet %s GET /fleet %s" % (label, json.dumps(fleet, sort_keys=True)),
          flush=True)
    print("fleet %s GET /healthz %s" % (label, json.dumps(
        health, sort_keys=True)), flush=True)
    return fleet, health


def _fleet_stack(mx, cfg, params, dev, n_replicas, ctl_opts,
                 per_device=FLEET_PER_DEVICE):
    """``lm_pool`` -> ``register`` -> ``FleetController`` (started) ->
    ``ServingHTTPServer``, all on ``dev``, dense, 32 slots a replica.  The
    controller's ticks are timed on the host clock (seconds, appended to
    ``ctl.tick_s``)."""
    opts = {"slots": DECODE_SLOTS, "prefill_buckets": DECODE_BUCKETS,
            "max_queue": DECODE_QUEUE, "kv_layout": "dense"}
    pool = mx.serving.lm_pool(cfg, params, n_replicas=n_replicas,
                              devices=[dev] * n_replicas, engine_opts=opts)
    reg = mx.serving.ModelRegistry(ctx=mx.cpu())
    reg.register("lm", pool)
    ctl = mx.serving.FleetController(
        reg, fleet=mx.serving.DeviceFleet([dev], per_device=per_device),
        interval_ms=FLEET_INTERVAL_MS, **ctl_opts)
    ctl.tick_s, tick = [], ctl.tick

    def timed_tick(now=None):
        t = time.perf_counter()
        try:
            tick(now)
        finally:
            ctl.tick_s.append(time.perf_counter() - t)

    ctl.tick = timed_tick
    ctl.start()
    server = mx.serving.ServingHTTPServer(reg, port=0).start()
    return pool, reg, ctl, server


def _tick_cost(label, ctl, wall):
    """Prints what the controller's ticks took on the host: the median
    and the longest tick (a scale-up or a replacement builds and warms a
    replica inside its tick), and the share of the run's wall time in
    ticks."""
    ts = sorted(ctl.tick_s)
    if not ts:
        return {}
    out = {"ticks": len(ts), "tick_median_ms": 1e3 * ts[len(ts) // 2],
           "tick_max_ms": 1e3 * ts[-1], "tick_share": sum(ts) / wall}
    print("fleet %s: controller %d ticks, median %.3f ms, longest %.1f ms, "
          "%.2f%% of the run's wall time in ticks"
          % (label, out["ticks"], out["tick_median_ms"], out["tick_max_ms"],
             100 * out["tick_share"]), flush=True)
    return out


def _fleet_close(reg, ctl, server):
    server.stop()
    ctl.close()
    reg.close()


def _run_stats(label, traffic, results, t0, dev):
    """Tokens/s, TTFT p50/p99 and peak memory of a run; prints them."""
    done = [r for r in results if r.get("status") == 200]
    gen = sum(len(r["tokens"]) for r in done)
    wall = max(r["recv"] for r in results) - t0
    ttft = np.array([r["ttft_ms"] for r in done], np.float64)
    stats = {"tokens_per_s": gen / wall, "wall_s": wall,
             "ttft_p50_ms": float(np.percentile(ttft, 50)),
             "ttft_p99_ms": float(np.percentile(ttft, 99)),
             "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
             "peak_reserved_gb": torch.cuda.max_memory_reserved(dev) / 1e9}
    print("fleet %s: %d of %d requests served, %d tokens in %.3f s = %.1f "
          "tokens/s; TTFT p50 %.2f ms, p99 %.2f ms; peak memory %.3f GB "
          "allocated, %.3f GB reserved"
          % (label, len(done), len(traffic), gen, wall,
             stats["tokens_per_s"], stats["ttft_p50_ms"],
             stats["ttft_p99_ms"], stats["peak_gb"],
             stats["peak_reserved_gb"]), flush=True)
    return stats


def _print_decisions(label, decisions, t0):
    for d in decisions:
        extra = {k: v for k, v in d.items() if k not in ("t", "model",
                                                          "action")}
        print("fleet %s decision at %+.3f s: %s %s"
              % (label, d["t"] - t0, d["action"], json.dumps(
                  extra, sort_keys=True, default=str)), flush=True)


def _shed_by(mx, reason):
    c = mx.telemetry.snapshot()["counters"].get("serving.shed.count", {})
    return c.get("model=lm,reason=%s" % reason, 0)


def fleet_autoscale_run(mx, cfg, params, dev, traffic, refs, streams):
    """Run E (see the module docstring)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the run's reserved peak is its own
    torch.cuda.reset_peak_memory_stats(dev)
    pool, reg, ctl, server = _fleet_stack(
        mx, cfg, params, dev, 1, {"policy_opts": {
            "slo_ttft_ms": FLEET_SLO_MS, "breach_ticks": FLEET_BREACH_TICKS,
            "slack_ticks": FLEET_SLACK_TICKS,
            "cooldown_s": FLEET_COOLDOWN_S,
            "max_replicas": FLEET_MAX_REPLICAS}})
    watch = _FleetWatch(pool)
    try:
        shed0 = _shed_total(mx)
        offsets = fleet_arrivals(len(traffic), FLEET_BURST, FLEET_TRICKLE_AT,
                                 FLEET_TRICKLE_S)
        results, t0 = fleet_clients(server.url, traffic, offsets)
        bad = [(i, r) for i, r in enumerate(results)
               if r.get("status") != 200 or r.get("error")]
        if bad or _shed_total(mx) != shed0:
            raise RuntimeError("fleet run E: %d requests failed (first %r), "
                               "%d shed" % (len(bad), bad[:1],
                                            _shed_total(mx) - shed0))
        stats = _run_stats("run E (autoscale)", traffic, results, t0, dev)
        stats.update(_tick_cost("run E", ctl, stats["wall_s"]))
        burst_done = max(r["recv"] for r in results[:FLEET_BURST])
        _wait_until(lambda: watch.live() == 1,
                    lambda: "run E never scaled back to one replica (%s)"
                    % replica_timeline(watch.samples)[-5:])
        time.sleep(0.1)
        watch.close()
        decisions = ctl.decisions()
        fleet, health = _print_gets("run E", server.url)
    finally:
        watch.close()
        _fleet_close(reg, ctl, server)
    _print_decisions("run E", decisions, t0)
    migrated = {int(e["replica"]): e["migrated"]
                for e in mx.telemetry.events_recent(10000)
                if e["event"] == "serving.pool.replica_remove"
                and e["ts"] >= t0}
    timeline = replica_timeline(watch.samples)
    print("fleet run E: replicas over time %s" % ", ".join(
        "%+.2f s: %d" % (t - t0, n) for t, n in timeline), flush=True)
    check_timeline("run E", timeline, 1, 2, 1)
    ups, downs = check_autoscale(decisions, migrated, burst_done)
    breaches = [d for d in decisions if d["action"] == "slo_breach"]
    to_serving = []
    for d in ups:
        seen = [b["t"] for b in breaches if b["t"] <= d["t"]]
        first = watch.first_token.get(d["replica"])
        to_serving.append(dict(
            replica=d["replica"],
            breach_to_decision_s=(d["t"] - seen[-1]) if seen else None,
            breach_to_serving_s=(first - seen[-1]) if seen and first
            else None,
            decision_to_serving_s=(first - d["t"]) if first else None))
    print("fleet run E: %d scale-ups, %d scale-downs (migrated %s); the "
          "burst's last session ended at %+.3f s; added replicas %s"
          % (len(ups), len(downs), migrated, burst_done - t0,
             json.dumps(to_serving)), flush=True)
    if not any(x["decision_to_serving_s"] is not None for x in to_serving):
        raise RuntimeError("fleet run E: no added replica served a token")
    if fleet["models"]["lm"]["quarantined"] or not health["fleet"]["running"]:
        raise RuntimeError("fleet run E: /fleet or /healthz is wrong")
    ties = hold_streams("fleet run E", traffic, refs,
                        [r["tokens"] for r in results], streams,
                        "autoscaled = run A", whole=True)
    stats.update(ups=len(ups), downs=len(downs), to_serving=to_serving,
                 timeline=[(t - t0, n) for t, n in timeline], ties=ties)
    return stats


def fleet_supervision_run(mx, cfg, params, dev, traffic, refs, streams):
    """Run F (see the module docstring)."""
    from mxnet_tpu_torch import faults

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the run's reserved peak is its own
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    pool, reg, ctl, server = _fleet_stack(
        mx, cfg, params, dev, DECODE_REPLICAS, {
            "restart_budget": 1, "backoff_base": 0.1,
            # supervision only: no SLO to breach, no scaling
            "policy_opts": {"slo_ttft_ms": 1e9,
                            "min_replicas": DECODE_REPLICAS,
                            "max_replicas": DECODE_REPLICAS}})
    watch = _FleetWatch(pool)
    second = {}

    def supervise():
        try:
            _wait_until(lambda: any(d["action"] == "restart"
                                    for d in ctl.decisions()),
                        lambda: "run F: no restart %r" % ctl.describe())
            second["armed"] = time.time()
            faults.arm("serving.replica.kill", at=FLEET_KILL2_STEPS)
            _wait_until(lambda: any(d["action"] == "quarantine"
                                    for d in ctl.decisions()),
                        lambda: "run F: no quarantine %r" % ctl.describe())
        except Exception as e:  # noqa: broad-except — raised below
            second["error"] = e

    try:
        faults.arm("serving.replica.kill",
                   at=DECODE_REPLICAS * FLEET_KILL_STEP)
        hook = threading.Thread(target=supervise, daemon=True)
        hook.start()
        results, t0 = fleet_clients(server.url, traffic,
                                    [0.0] * len(traffic))
        hook.join(timeout=FLEET_WAIT_S * 3)
        faults.disarm()
        if "error" in second or hook.is_alive():
            raise RuntimeError("fleet run F: %r" % second.get("error"))
        bad = [(i, r) for i, r in enumerate(results)
               if r.get("status") != 200 or r.get("error")]
        if bad:
            raise RuntimeError("fleet run F: %d requests failed, first %r"
                               % (len(bad), bad[0]))
        stats = _run_stats("run F (supervision)", traffic, results, t0, dev)
        stats.update(_tick_cost("run F", ctl, stats["wall_s"]))
        watch.close()
        decisions = ctl.decisions()
        fleet, health = _print_gets("run F", server.url)
        reps = {r.rid: r for r in pool.replicas}
        # both killed replicas' caches are back on the device: what the
        # pool holds beyond the shared weights is the replacement's cache
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev) - base
        cache = pool.describe()["kv"]["hbm_bytes"] / len(reps)
    finally:
        faults.disarm()
        watch.close()
        _fleet_close(reg, ctl, server)
    _print_decisions("run F", decisions, t0)
    check_supervision(decisions)
    restart = [d for d in decisions if d["action"] == "restart"][0]
    new = reps[restart["new_replica"]]
    card = fleet["models"]["lm"]
    if not (card["quarantined"] and card["restarts_used"] == 1
            and health["fleet"]["models"]["lm"]["quarantined"]
            and any(d["action"] == "quarantine"
                    for d in health["fleet"]["decisions"])):
        raise RuntimeError("fleet run F: /fleet %r or /healthz %r miss the "
                           "restart or the quarantine"
                           % (card, health["fleet"]))
    if new.device != dev or not new.engine.tokens_out \
            or any(t.device != dev for t in new.engine.state_tensors()):
        raise RuntimeError("fleet run F: the replacement is not serving on "
                           "%s" % dev)
    dead = sorted(r.rid for r in reps.values() if r.dead)
    moved = sum(r["migrations"] or 0 for r in results
                if r["migrations"] is not None)
    kills = [e["ts"] - t0 for e in mx.telemetry.events_recent(10000)
             if e["event"] == "fault_injected" and e["ts"] >= t0
             and e["point"] == "serving.replica.kill"]
    print("fleet run F: kills at %s s; the first kill to the restart "
          "decision (death noticed, replica removed, its replacement built "
          "and warmed) %.3f s; memory the pool holds after the quarantine "
          "beyond the weights %.3f GB, one replica's cache %.3f GB"
          % (", ".join("%+.3f" % k for k in kills),
             restart["t"] - t0 - kills[0] if kills else float("nan"),
             held / 1e9, cache / 1e9), flush=True)
    if len(kills) != 2 or held > 1.05 * cache:
        raise RuntimeError("fleet run F: %d kills; %.3f GB held for one "
                           "replica's %.3f GB cache"
                           % (len(kills), held / 1e9, cache / 1e9))
    print("fleet run F: killed at the pool's step %d, replica %d replaced "
          "by replica %d on %s (restart %+.3f s after the start; its first "
          "token %+.3f s), the survivor killed %d steps after the restart "
          "was armed (%+.3f s) and the model quarantined; dead replicas %s; "
          "streamed sessions report %d migrations"
          % (DECODE_REPLICAS * FLEET_KILL_STEP, restart["replica"],
             restart["new_replica"], new.device, restart["t"] - t0,
             watch.first_token.get(new.rid, float("nan")) - t0,
             FLEET_KILL2_STEPS, second["armed"] - t0, dead, moved),
          flush=True)
    if len(dead) != 1:
        raise RuntimeError("fleet run F: dead replicas %r" % dead)
    ties = hold_streams("fleet run F", traffic, refs,
                        [r["tokens"] for r in results], streams,
                        "supervised = run A", whole=True)
    stats.update(restart_s=restart["t"] - t0, ties=ties, held_gb=held / 1e9,
                 kills=kills)
    return stats


def fleet_shed_run(mx, cfg, params, dev, traffic, refs, streams, seed):
    """Run G (see the module docstring)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the run's reserved peak is its own
    torch.cuda.reset_peak_memory_stats(dev)
    n = len(traffic)
    priorities = fleet_priorities(n, seed)
    # a full fleet: as many replicas as the card takes and the policy
    # allows
    pool, reg, ctl, server = _fleet_stack(
        mx, cfg, params, dev, DECODE_REPLICAS, {"policy_opts": {
            "slo_ttft_ms": FLEET_G_SLO_MS, "breach_ticks": FLEET_BREACH_TICKS,
            "max_replicas": DECODE_REPLICAS,
            "min_replicas": DECODE_REPLICAS}}, per_device=DECODE_REPLICAS)
    try:
        shed0 = _shed_by(mx, "priority")
        results, t0 = fleet_clients(server.url, traffic,
                                    [FLEET_G_GAP_S * i for i in range(n)],
                                    priorities)
        _wait_until(lambda: not pool.admission_state()[2],
                    lambda: "run G: shed pressure never lifted")
        probe = _http_generate(server.url, dict(traffic[0],
                                                priority=FLEET_LOW))
        decisions = ctl.decisions()
        fleet, health = _print_gets("run G", server.url)
        shed_count = _shed_by(mx, "priority") - shed0
        tick_cost = _tick_cost("run G", ctl, time.time() - t0)
    finally:
        _fleet_close(reg, ctl, server)
    _print_decisions("run G", decisions, t0)
    events = [e for e in mx.telemetry.events_recent(10000)
              if e["event"] == "serving.pool.shed_pressure" and e["ts"] >= t0]
    spans = pressure_windows(events, time.time())
    shed, low_done = check_shed(results, priorities, spans)
    # the pressure lifts once the breach clears: the last event turns it
    # off (in a quiet stretch of the burst, or after it)
    if shed_count != len(shed) or not events or events[-1]["on"]:
        raise RuntimeError("fleet run G: %d priority sheds counted for %d "
                           "refusals; pressure events %r"
                           % (shed_count, len(shed), events))
    if probe.get("status") != 200 or probe["tokens"] != streams[0]:
        raise RuntimeError("fleet run G: the priority-%d probe after the "
                           "pressure lifted failed: %r" % (FLEET_LOW, probe))
    stats = _run_stats("run G (shed at capacity)", traffic, results, t0, dev)
    print("fleet run G: pressure on %s; %d of %d clients under the floor "
          "shed (429, reason priority), %d of them served (sent outside the "
          "pressure), every client at priority >= %d served; a priority-%d "
          "probe after the pressure lifted served"
          % (", ".join("%+.3f..%+.3f s" % (a - t0, b - t0) for a, b in spans),
             len(shed), priorities.count(FLEET_LOW), len(low_done),
             FLEET_FLOOR, FLEET_LOW), flush=True)
    served = [i for i, r in enumerate(results) if r.get("status") == 200]
    ties = hold_streams("fleet run G", [traffic[i] for i in served],
                        [refs[i] for i in served],
                        [results[i]["tokens"] for i in served],
                        [streams[i] for i in served],
                        "served under shedding = run A", whole=True)
    stats.update(shed=len(shed), low_served=len(low_done),
                 pressure_spans=len(spans), ties=ties, **tick_cost)
    return stats


def fleet_phase(mx, seed, reuse):
    """Phase 16 (see the module docstring)."""
    dev = torch.device("cuda", 0)
    cfg, params = reuse["cfg"], reuse["params"]
    traffic, refs, streams = reuse["traffic"], reuse["refs"], reuse["streams"]
    t_phase = time.perf_counter()
    mx.telemetry.enable()
    out = {"autoscale": fleet_autoscale_run(mx, cfg, params, dev, traffic,
                                            refs, streams)}
    sub = slice(None, None, FLEET_STRIDE)
    out["supervision"] = fleet_supervision_run(
        mx, cfg, params, dev, traffic[sub], refs[sub], streams[sub])
    out["shed"] = fleet_shed_run(mx, cfg, params, dev, traffic[sub],
                                 refs[sub], streams[sub], seed)
    print("fleet phase: %.1f s" % (time.perf_counter() - t_phase), flush=True)
    return out


# -- the rest of the RNN toolkit (phase 17) -----------------------------------
def _lstm_corpus_iters(mx, lstm_lm, seed, layout):
    """Phase 9's training and validation iterators, seeded as phase 9
    seeds them, in ``layout`` ("TN" for the fused model, "NT" for
    ``lstm_bucketing.py``'s)."""
    random.seed(seed)
    np.random.seed(seed)
    return [mx.rnn.BucketSentenceIter(
        lstm_lm.synth_corpus(count, LSTM_VOCAB, seed=seed + s,
                             buckets=LSTM_BUCKETS), LSTM_BATCH,
        buckets=list(LSTM_BUCKETS), invalid_label=0, layout=layout)
        for count, s in ((LSTM_TRAIN_SENTENCES, 3), (LSTM_VAL_SENTENCES, 17))]


def _lstm_counts(rk, reset=False):
    kernels = (rk.lstm_infer_cuda, rk.lstm_fwd_cuda, rk.lstm_bwd_cuda)
    if reset:
        for k in kernels:
            k.launches = 0
    return tuple(k.launches for k in kernels)


def _update_distances(label, smi, got, want, floor_of, what):
    """Each update of ``got`` against ``want`` within 1e-4 of its norm, or
    3x the distance ``floor_of`` (the CPU's own update on a perturbed
    embedding) where that is larger; returns the worst distance over its
    bound."""
    worst = 0.0
    for k in sorted(want):
        norm = max(float(np.linalg.norm(want[k])), 1e-30)
        dist = float(np.linalg.norm(got[k] - want[k])) / norm
        floor = float(np.linalg.norm(floor_of[k] - want[k])) / norm \
            if floor_of is not None else 0.0
        bound = 3 * floor if floor > 1e-4 else 1e-4
        worst = max(worst, dist / bound)
        print("%s [%s] %s: %s %.3g of its norm, floor %.3g, bound %.3g"
              % (label, smi, k, what, dist, floor, bound), flush=True)
        if not dist <= bound:
            raise RuntimeError("%s: %s of %s is %.3g of the norm (bound "
                               "%.3g)" % (label, what, k, dist, bound))
    return worst


def lstm_unfused_phase(mx, rk, seed, smi, fused_ms):
    """Phase 17a: ``lstm_bucketing.py``'s unfused stack (``LSTMCell`` x 2,
    NT batches unrolled NTC) at phase 9's widths through
    ``BucketingModule.fit`` on the card for one epoch of phase 9's corpus
    with ``score`` on its eval data: no K4-K6 launch and no plain LSTM on
    the card; step ms per bucket beside phase 9's fused step, peak
    memory; then one T=60 step on the card against the CPU (NTC), and the
    stack's step in TNC against the fused model's step through K5/K6 from
    the same weights (carried with ``unpack_weights``; one layout for
    both, as ``Module`` takes the batch size from the data's first axis),
    each update within 1e-4 of its norm (3x the CPU's perturbed-embedding
    floor where that is larger)."""
    from mxnet_tpu_torch.models import lstm_lm

    train, val = _lstm_corpus_iters(mx, lstm_lm, seed, "NT")
    stack = lstm_lm.build_stack(LSTM_HIDDEN, LSTM_LAYERS)
    mod = _lstm_module(mx, lstm_lm, cell=stack, layout="NTC")
    marks, evals = [], []

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
        _lstm_counts(rk, reset=True)
        start.record()
        t0 = time.perf_counter()
        mod.fit(train, eval_data=val, eval_metric=mx.metric.Perplexity(0),
                validation_metric=val_metric, num_epoch=1,
                batch_end_callback=mark,
                eval_batch_end_callback=lambda p: evals.append(p.nbatch),
                optimizer="sgd", optimizer_params={
                    "learning_rate": 0.02, "momentum": 0.0, "wd": 1e-5},
                initializer=mx.init.Xavier(factor_type="in", magnitude=2.34))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _lstm_counts(rk)
        # -- end of the main path --
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    (_, ppl), = val_metric.get_name_value()
    arg, _ = mod.get_params()
    nodes = len(mod._buckets[max(LSTM_BUCKETS)]._exec._nodes)
    print("lstm unfused [%s] BucketingModule.fit of lstm_bucketing.py's "
          "stack (%d LSTMCell of %d, vocab %d, embed %d, b%d, NTC): %d "
          "training batches, %d eval batches, fit %.2f s (binds included), "
          "%d graph nodes at T=%d; K4/K5/K6 launches %s (expected none); "
          "peak memory allocated %.3f GB; validation perplexity %.4f"
          % (smi, LSTM_LAYERS, LSTM_HIDDEN, LSTM_VOCAB, LSTM_EMBED,
             LSTM_BATCH, len(marks), len(evals), fit_s, nodes,
             max(LSTM_BUCKETS), launches, peak_gb, ppl), flush=True)
    if launches != (0, 0, 0) or not evals:
        raise RuntimeError("the unfused LM launched K4/K5/K6 %s times"
                           % (launches,))
    bad = [k for k, v in arg.items() if not torch.isfinite(v._t).all()]
    if bad or not np.isfinite(ppl):
        raise RuntimeError("the unfused LM gave non-finite params %s or "
                           "perplexity %s" % (bad, ppl))
    times, prev = {}, start
    for key, ev in marks:
        times.setdefault(key, []).append(prev.elapsed_time(ev))
        prev = ev
    steps = {}
    for key in LSTM_BUCKETS:
        ms = times[key]
        steps[key] = float(np.median(ms[1:]))
        print("lstm unfused [%s] bucket %d: ms per batch (CUDA events "
              "between batch ends, the first binds the bucket) %s; median "
              "after the first %.3f ms (%.0f tokens/s), phase 9's fused "
              "step %.3f ms (%.2fx)" % (
                  smi, key, ["%.2f" % t for t in ms], steps[key],
                  key * LSTM_BATCH / steps[key] * 1e3, fused_ms[key],
                  steps[key] / fused_ms[key]), flush=True)
    del mod
    torch.cuda.empty_cache()

    T = max(LSTM_BUCKETS)
    rs = np.random.RandomState(seed + 5)
    ids = rs.randint(1, LSTM_VOCAB, (T, LSTM_BATCH)).astype(np.float32)
    init = _lstm_module(mx, lstm_lm, mx.cpu(), key=T)
    init.bind([("data", ids.shape)], [("softmax_label", ids.shape)])
    mx.init.seed(seed)
    init.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34))
    fused = mx.convert.module_params_to_numpy(init)[0]
    del init
    cell = lstm_lm.build_cell(LSTM_HIDDEN, LSTM_LAYERS)

    def unpacked(params):
        return {k: v.asnumpy() if hasattr(v, "asnumpy") else v
                for k, v in cell.unpack_weights(params).items()}

    unfused = unpacked(fused)
    with lstm_plain_refused(rk):
        _lstm_counts(rk, reset=True)
        t = time.perf_counter()
        gu = lstm_step_updates(mx, lstm_lm, mx.gpu(0), unfused, ids,
                               cell=stack, layout="NTC")
        gs = time.perf_counter() - t
        # the fused model's layout: Module takes the batch size (and so
        # rescale_grad) from the data's first axis, T in TNC
        gt = lstm_step_updates(mx, lstm_lm, mx.gpu(0), unfused, ids,
                               cell=stack)
        step_launches = _lstm_counts(rk)
        fu = unpacked(lstm_step_updates(mx, lstm_lm, mx.gpu(0), fused, ids))
        fused_launches = _lstm_counts(rk)
    if step_launches != (0, 0, 0) or fused_launches != (0, 2, 2):
        raise RuntimeError("unfused steps launched %s, fused step %s"
                           % (step_launches, fused_launches))
    t = time.perf_counter()
    cu = lstm_step_updates(mx, lstm_lm, mx.cpu(), unfused, ids, cell=stack,
                           layout="NTC")
    cs = time.perf_counter() - t
    perturbed = dict(unfused)
    perturbed["embed_weight"] = (unfused["embed_weight"] * (
        1 + 1e-7 * rs.standard_normal(unfused["embed_weight"].shape))) \
        .astype(np.float32)
    pu = lstm_step_updates(mx, lstm_lm, mx.cpu(), perturbed, ids,
                           cell=stack, layout="NTC")
    w_cpu = _update_distances("lstm unfused parity T=%d" % T, smi, gu, cu,
                              pu, "card vs CPU update")
    w_fused = _update_distances("lstm unfused vs fused T=%d" % T, smi, gt,
                                fu, None, "unfused vs fused (K5/K6) update")
    print("lstm unfused [%s] one step b%d T=%d: card %.2f s, CPU %.2f s; "
          "worst distance over its bound: card vs CPU %.3g, unfused vs "
          "fused %.3g" % (smi, LSTM_BATCH, T, gs, cs, w_cpu, w_fused),
          flush=True)
    return steps


def lstm_unfused_score(mx, rk, seed, smi, prefix):
    """Phase 17b, ``fused_lstm_bucketing.py --test``: phase 9's fused epoch
    checkpoint scored by the fused model through K4 (TN batches), then
    loaded into ``cell.unfuse()`` through ``load_rnn_checkpoint`` and
    scored on the card on the same batches in NT (no K4-K6 launch): the
    perplexities within 1e-5 (relative), each batch's outputs within
    1e-4 of their largest magnitude.  Returns the K4 launches."""
    from mxnet_tpu_torch.models import lstm_lm

    def scored(cell, layout):
        _train, val = _lstm_corpus_iters(mx, lstm_lm, seed, layout[:2])
        mod = _lstm_module(mx, lstm_lm, cell=cell, layout=layout)
        mod.bind(val.provide_data, val.provide_label, for_training=False)
        _sym, arg, aux = mx.rnn.load_rnn_checkpoint(cell, prefix, 1)
        mod.set_params(arg, aux)
        outs = []
        # the val iterator is the second one built after the seeds, as in
        # phase 9; score's reset reshuffles it alike for both layouts
        with lstm_plain_refused(rk):
            _lstm_counts(rk, reset=True)
            (_, ppl), = mod.score(val, mx.metric.Perplexity(0),
                                  batch_end_callback=lambda p: outs.append(
                                      (p.locals["eval_batch"].bucket_key,
                                       mod.get_outputs()[0]._t.clone())))
            torch.cuda.synchronize()
            launches = _lstm_counts(rk)
        return ppl, outs, launches, sorted(arg)

    fused_ppl, fused_outs, f_launches, _ = scored(
        lstm_lm.build_cell(LSTM_HIDDEN, LSTM_LAYERS), "TNC")
    stack = lstm_lm.build_cell(LSTM_HIDDEN, LSTM_LAYERS).unfuse()
    ppl, outs, u_launches, names = scored(stack, "NTC")
    worst = 0.0
    for (fk, fo), (uk, uo) in zip(fused_outs, outs):
        if fk != uk:
            raise RuntimeError("bucket %s against %s" % (fk, uk))
        # the fused rows are (t, n), the unfused (n, t)
        fo = fo.reshape(fk, LSTM_BATCH, -1).transpose(0, 1).reshape(
            uo.shape)
        worst = max(worst, float((uo - fo).abs().max() / fo.abs().max()))
    rel = abs(ppl - fused_ppl) / fused_ppl
    print("lstm unfused score [%s] of phase 9's fused checkpoint through "
          "unfuse() + load_rnn_checkpoint (%d arrays: %s...): perplexity "
          "%.6f against the fused K4 score's %.6f (relative %.3g, limit "
          "1e-5); %d batches, worst output difference %.3g of the batch's "
          "largest (limit 1e-4); launches K4/K5/K6 fused %s, unfused %s"
          % (smi, len(names), names[:3], ppl, fused_ppl, rel,
             len(outs), worst, f_launches, u_launches), flush=True)
    if len(outs) != len(fused_outs) or not outs:
        raise RuntimeError("scored %d and %d batches"
                           % (len(outs), len(fused_outs)))
    if not rel <= 1e-5 or not worst <= 1e-4:
        raise RuntimeError("unfused score %r against fused %r, outputs %.3g"
                           % (ppl, fused_ppl, worst))
    if u_launches != (0, 0, 0) or f_launches != (
            LSTM_LAYERS * len(outs), 0, 0):
        raise RuntimeError("launches: fused %s, unfused %s"
                           % (f_launches, u_launches))
    return f_launches[0]


@contextlib.contextmanager
def dropout_counted(nn_rnn, kept):
    """Within the block the ``RNN`` op's dropout adds its kept and total
    elements (device tensors, read once after) to ``kept``."""
    drop = nn_rnn.dropout

    def counted(x, p):
        out = drop(x, p)
        kept.append(((out != 0).sum(), out.numel()))
        return out

    nn_rnn.dropout = counted
    try:
        yield
    finally:
        nn_rnn.dropout = drop


@contextlib.contextmanager
def lstm_checking(rk, errs):
    """Within the block each K5 and K6 call is held against its plain
    version on the call's own tensors: ``errs[name]`` collects each
    output's largest difference over that output's largest magnitude."""
    route = rk._route

    def rerouted(x, cuda_fn, plain_fn):
        fn = route(x, cuda_fn, plain_fn)
        if fn is not cuda_fn:
            return fn

        def checked(*args):
            out = fn(*args)
            with torch.no_grad():
                ref = plain_fn(*args)
            errs.setdefault(cuda_fn.__name__, []).append([
                float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                for g, w in zip(out, ref)])
            return out
        return checked

    rk._route = rerouted
    try:
        yield
    finally:
        rk._route = route


def lstm_dropout_phase(mx, rk, seed, smi):
    """Phase 17c, ``fused_lstm_bucketing.py --dropout 0.5``: the fused fit
    with dropout between its two layers for one epoch of phase 9's corpus
    on the card, 2 K5 + 2 K6 launches a batch, the kept share within 0.5
    +- 0.01; the first batch's update from the same seed bit for bit
    twice, and different at p=0; then one T=60 step with each K5/K6 call
    held against its plain version on its own tensors (forward 1e-5,
    backward 1e-4 of each output's largest magnitude).  Returns the K5
    and K6 launches."""
    from mxnet_tpu_torch.models import lstm_lm
    from mxnet_tpu_torch.ops import rnn as nn_rnn

    train, _val = _lstm_corpus_iters(mx, lstm_lm, seed, "TN")
    cell = lstm_lm.build_cell(LSTM_HIDDEN, LSTM_LAYERS, dropout=0.5)
    mod = _lstm_module(mx, lstm_lm, cell=cell)
    kept, seen = [], []
    mx.init.seed(seed)
    mx.random.seed(seed)
    with lstm_plain_refused(rk), dropout_counted(nn_rnn, kept):
        # -- the main path: counts from 0, one epoch --
        _lstm_counts(rk, reset=True)
        t0 = time.perf_counter()
        mod.fit(train, eval_metric=mx.metric.Perplexity(0), num_epoch=1,
                batch_end_callback=lambda p: seen.append(1),
                optimizer="sgd", optimizer_params={
                    "learning_rate": 0.02, "momentum": 0.0, "wd": 1e-5},
                initializer=mx.init.Xavier(factor_type="in", magnitude=2.34))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _lstm_counts(rk)
        # -- end of the main path --
    n = len(seen)
    share = float(sum(k for k, _ in kept)) / sum(t for _, t in kept)
    arg, _ = mod.get_params()
    finite = all(torch.isfinite(v._t).all() for v in arg.values())
    print("lstm dropout [%s] fused fit, dropout 0.5 between 2 layers: %d "
          "batches in %.2f s, K4/K5/K6 launches %s (expected (0, %d, %d)); "
          "%d masks, kept share %.5f over %d elements (limit 0.5 +- 0.01); "
          "parameters finite %s" % (
              smi, n, fit_s, launches, 2 * n, 2 * n, len(kept), share,
              sum(t for _, t in kept), finite), flush=True)
    if launches != (0, LSTM_LAYERS * n, LSTM_LAYERS * n) or not finite:
        raise RuntimeError("dropout fit launched %s over %d batches"
                           % (launches, n))
    if not abs(share - 0.5) <= 0.01 or len(kept) != (LSTM_LAYERS - 1) * n:
        raise RuntimeError("dropout kept %.5f in %d masks" % (share,
                                                              len(kept)))
    batch = next(iter(train))
    ids = batch.data[0].asnumpy()
    params = mx.convert.module_params_to_numpy(mod)[0]
    del mod
    torch.cuda.empty_cache()
    a, b = (lstm_step_updates(mx, lstm_lm, mx.gpu(0), params, ids, cell=cell,
                              draw_seed=seed) for _ in range(2))
    plain = lstm_step_updates(mx, lstm_lm, mx.gpu(0), params, ids,
                              cell=lstm_lm.build_cell(LSTM_HIDDEN,
                                                      LSTM_LAYERS))
    same = all(np.array_equal(a[k], b[k]) for k in a)
    other = max(float(np.abs(a[k] - plain[k]).max()) for k in a)
    print("lstm dropout [%s] first batch (T=%d) from seed %d twice: updates "
          "equal bit for bit %s; the p=0 step's largest difference %.3g"
          % (smi, ids.shape[0], seed, same, other), flush=True)
    if not same or not other > 0:
        raise RuntimeError("dropout step: rerun equal %s, p=0 difference %s"
                           % (same, other))
    T = max(LSTM_BUCKETS)
    rs = np.random.RandomState(seed + 7)
    ids = rs.randint(1, LSTM_VOCAB, (T, LSTM_BATCH)).astype(np.float32)
    errs = {}
    with lstm_checking(rk, errs):
        lstm_step_updates(mx, lstm_lm, mx.gpu(0), params, ids, cell=cell,
                          draw_seed=seed)
        torch.cuda.synchronize()
    for name, limit in (("lstm_fwd_cuda", 1e-5), ("lstm_bwd_cuda", 1e-4)):
        calls = errs.get(name, [])
        worst = [max(e[i] for e in calls) for i in range(len(calls[0]))] \
            if calls else []
        print("lstm dropout [%s] checked T=%d step: %d %s calls on their "
              "own tensors, worst error by output %s (limit %g)" % (
                  smi, T, len(calls), name, ["%.3g" % w for w in worst],
                  limit), flush=True)
        if len(calls) != LSTM_LAYERS or not max(worst) <= limit:
            raise RuntimeError("%s: %d calls, errors %s" % (name, len(calls),
                                                             worst))
    return launches[1], launches[2]


class _FirstBatches:
    """The first ``n`` batches of ``inner`` as an epoch."""

    def __init__(self, inner, n):
        self.inner, self.n, self.seen = inner, n, 0
        self.provide_data = inner.provide_data
        self.provide_label = inner.provide_label

    def __iter__(self):
        return self

    def reset(self):
        self.inner.reset()
        self.seen = 0

    def __next__(self):
        if self.seen == self.n:
            raise StopIteration
        self.seen += 1
        return next(self.inner)


def _ce_grad(scores, labels):
    """The softmax cross-entropy gradient of a ``PythonLossModule`` head,
    in numpy, averaged over the batch."""
    s = scores.asnumpy()
    lab = labels.asnumpy().astype(int)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    p[np.arange(len(lab)), lab] -= 1.0
    return p / len(lab)


SEQ_BATCHES = 8


def sequential_fit(mx, paths, ctx, seed, perturb=None):
    """BASELINE #1's MLP feature layers (``fc1``-``fc3``) as a ``Module``
    and a ``PythonLossModule`` softmax head in a ``SequentialModule``,
    fit over the first ``SEQ_BATCHES`` flat ``MNISTIter`` batches on
    ``ctx`` (SGD lr 0.05 momentum 0.9, Xavier gaussian in 2 from
    ``seed``): (initial params, final params, accuracy)."""
    it = mx.io.MNISTIter(image=paths["train_img"], label=paths["train_lab"],
                         batch_size=MNIST_BATCH, shuffle=False, flat=True)
    if perturb is not None:
        rng = np.random.default_rng(perturb[1])
        inner = it._inner
        inner.data = [(k, (v * (1 + perturb[0] * rng.standard_normal(
            v.shape))).astype(np.float32)) for k, v in inner.data]
    with mx.name.NameManager():
        feat = mx.models.get_symbol("mlp", num_classes=10).get_internals()[
            "fc3_output"]
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(feat, label_names=(), context=ctx))
    seq.add(mx.mod.PythonLossModule(grad_func=_ce_grad), take_labels=True,
            auto_wiring=True)
    it = _FirstBatches(it, SEQ_BATCHES)
    seq.bind(it.provide_data, it.provide_label)
    mx.init.seed(seed)
    seq.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    before = {k: v.asnumpy() for k, v in seq.get_params()[0].items()}
    metric = mx.metric.Accuracy()
    seq.fit(it, eval_metric=metric, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
    after = {k: v.asnumpy() for k, v in seq.get_params()[0].items()}
    return before, after, metric.get()[1]


def sequential_phase(mx, seed, smi):
    """Phase 17d: ``sequential_fit`` on the card and on the CPU from the
    same seeded weights and batches: each parameter's update within 1e-4
    of its norm (3x the CPU's own spread on perturbed images where that
    is larger), the training accuracy within 0.02 (phase 14's limit)."""
    with tempfile.TemporaryDirectory() as d:
        paths = mx.models.lenet.synth_mnist(d)
        t = time.perf_counter()
        g0, g1, gacc = sequential_fit(mx, paths, mx.gpu(0), seed)
        torch.cuda.synchronize()
        gs = time.perf_counter() - t
        c0, c1, cacc = sequential_fit(mx, paths, mx.cpu(), seed)
        p0, p1, _ = sequential_fit(mx, paths, mx.cpu(), seed,
                                   perturb=(1e-7, seed))
    for k in c0:
        if not np.array_equal(g0[k], c0[k]):
            raise RuntimeError("sequential: %s initialized apart" % k)
    upd = {k: g1[k] - g0[k] for k in g1}
    worst = _update_distances(
        "sequential %d batches b%d" % (SEQ_BATCHES, MNIST_BATCH), smi, upd,
        {k: c1[k] - c0[k] for k in c1}, {k: p1[k] - p0[k] for k in p1},
        "card vs CPU update")
    print("sequential [%s] SequentialModule(Module(mlp fc1-fc3), "
          "PythonLossModule) over %d MNISTIter batches: card %.2f s, "
          "training accuracy card %.4f, CPU %.4f (limit 0.02); worst update "
          "distance over its bound %.3g" % (smi, SEQ_BATCHES, gs, gacc, cacc,
                                            worst), flush=True)
    if not abs(gacc - cacc) <= 0.02:
        raise RuntimeError("sequential accuracy card %r, CPU %r"
                           % (gacc, cacc))


def rnn_toolkit_phase(mx, rk, seed, smi, fused):
    """Phase 17 (a-d); ``fused`` holds phase 9's step ms per bucket and
    checkpoint.  Returns the K4, K5 and K6 launches of its main paths."""
    import shutil

    try:
        t = time.perf_counter()
        lstm_unfused_phase(mx, rk, seed, smi, fused["ms"])
        ta = time.perf_counter() - t
        k4 = lstm_unfused_score(mx, rk, seed, smi, fused["prefix"])
    finally:
        shutil.rmtree(os.path.dirname(fused["prefix"]), ignore_errors=True)
    tb = time.perf_counter() - t - ta
    k5, k6 = lstm_dropout_phase(mx, rk, seed, smi)
    tc = time.perf_counter() - t - ta - tb
    sequential_phase(mx, seed, smi)
    td = time.perf_counter() - t - ta - tb - tc
    print("rnn toolkit phase [%s]: 17a %.1f s, 17b %.1f s, 17c %.1f s, 17d "
          "%.1f s" % (smi, ta, tb, tc, td), flush=True)
    return k4, k5, k6


# -- SSD-VGG16 (BASELINE #4) and the classic classifiers (phase 18) ---------
#: example/ssd/train.py at VOC's 20 classes and the reference's batch of 32
SSD_IMAGE, SSD_BATCH, SSD_CLASSES, SSD_STEPS = 300, 32, 20, 4
#: train.py's SGD defaults
SSD_OPT = {"learning_rate": 0.002, "momentum": 0.9, "wd": 5e-4}
#: SSD300's anchors: 38^2*3 + (19^2 + 10^2 + 5^2 + 3^2 + 1) * 6
SSD_ANCHORS = 7308
#: the deploy graph's NMS (ssd_vgg16.get_symbol's defaults)
SSD_NMS, SSD_FORCE = 0.5, True
SSD_VARIANCES = (0.1, 0.1, 0.2, 0.2)
#: K7's operations per IoU (4 max/min, 6 differences, 2 clamps, 3
#: products, a sum, a difference, the division and the comparison)
NMS_IOU_OPS = 19
#: the classic classifiers: (network, kwargs, image side); GoogLeNet's
#: fixed 7x7 average pool needs 256 (at 224 its last map is 6x6)
CLASSIC_NETS = (("vgg", {}, 224), ("vgg", {"batch_norm": True}, 224),
                ("googlenet", {}, 256), ("inception-bn", {}, 224),
                ("alexnet", {}, 224), ("inception-resnet-v2", {}, 299))
CLASSIC_BATCH, CLASSIC_STEPS = 32, 3
#: the classic networks whose step is also profiled, and the profile's
#: groups beside the default ones (lowercase kernel names)
CLASSIC_PROFILED = ("inception-resnet-v2",)
CLASSIC_GROUPS = (("scale (_mul_scalar)", lambda k: "mul" in k and not any(
    w in k for w in ("multi_tensor", "gemm", "conv"))),)


def _ssd_module(mx, ssd, ctx=None):
    net = ssd.get_symbol_train(num_classes=SSD_CLASSES)
    return mx.mod.Module(net, label_names=("label",)) if ctx is None \
        else mx.mod.Module(net, label_names=("label",), context=ctx)


def _detection_iter(mx, x, y, batch):
    return mx.io.NDArrayIter({"data": x}, {"label": y}, batch_size=batch,
                             label_name="label")


def ssd_step_updates(mx, make_module, ctx, x, y, seed):
    """:func:`step_updates` for SSD: one step of ``train.py``'s fit with
    ``MultiBoxMetric`` on detection labels ``y``."""
    from mxnet_tpu_torch.models import ssd_vgg16

    it = _detection_iter(mx, x, y, x.shape[0])
    mod = make_module(mx, ctx)
    mod.bind(it.provide_data, it.provide_label)
    mx.init.seed(seed)
    mod.init_params(mx.init.Xavier())
    before = mx.convert.module_params_to_numpy(mod)[0]
    mod.fit(it, num_epoch=1, eval_metric=ssd_vgg16.MultiBoxMetric(),
            optimizer_params=dict(SSD_OPT))
    arg, aux = mx.convert.module_params_to_numpy(mod)
    return {k: arg[k] - before[k] for k in arg}, aux, arg


def _step_events():
    events = []

    def mark(_param):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    return events, mark


def _steps_ms(start, events):
    return [start.elapsed_time(events[0])] + [
        a.elapsed_time(b) for a, b in zip(events, events[1:])]


def _finite_params(label, mod):
    arg, aux = mod.get_params()
    bad = [k for k, v in list(arg.items()) + list(aux.items())
           if not torch.isfinite(v._t).all()]
    if bad:
        raise RuntimeError("%s produced non-finite parameters %s"
                           % (label, bad[:5]))


def ssd_training_phase(mx, bnk, ssd, nms, seed, smi):
    """Phase 18a: ``train.py``'s fit of SSD300 (VOC's 20 classes, b32,
    300x300, f32) over ``SSD_STEPS`` batches of ``synth_detection_set``
    on the card, classic and then with ``MXNET_FUSE_TRAIN_STEP=1`` (one
    eager warm-up and a capture, then replays), with ``MultiBoxMetric``.
    Each run ends with finite parameters and metric values, launches no
    K7 (NMS is not on the training path), and the captured run replays
    in every step after the first.  Prints step ms (CUDA events between
    batch ends, the first step apart), images/s, peak memory allocated
    and reserved, the metric's host read of the three outputs (timed
    apart) and a profile of one classic step.  Then one b4 step on the
    card against the CPU within 3x the perturbed f32 floor
    (:func:`parity_phase`), its inputs perturbed by 1e-6 relative: without
    BatchNorm nothing amplifies a 1e-7 perturbation, while cuDNN runs
    some of SSD's f32 convolutions through FFTs (``fft2d_r2c``,
    ``pointwise_mult_and_sum_complex`` in the profile), whose rounding
    moved a bias update 3.7x that floor in one run.  Returns the classic
    run's module."""
    x, y = ssd.synth_detection_set(SSD_BATCH * SSD_STEPS, SSD_IMAGE,
                                   SSD_CLASSES, seed=5 + seed)
    out = None
    for fused in (False, True):
        name = "captured" if fused else "classic"
        it = _detection_iter(mx, x, y, SSD_BATCH)
        mod = _ssd_module(mx, ssd)
        metric = ssd.MultiBoxMetric()
        events, mark = _step_events()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        with environment({"MXNET_FUSE_TRAIN_STEP": "1" if fused else None,
                          "MXNET_BULK_TRAIN_STEPS": None}):
            mx.init.seed(seed)
            nms.greedy_nms_cuda.launches = 0
            start.record()
            t0 = time.perf_counter()
            mod.fit(it, eval_metric=metric, optimizer="sgd",
                    optimizer_params=dict(SSD_OPT),
                    initializer=mx.init.Xavier(), num_epoch=1,
                    batch_end_callback=[mark])
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() / 1e9,
                torch.cuda.max_memory_reserved() / 1e9)
        step_ms = _steps_ms(start, events)
        steady = float(np.median(step_ms[1:]))
        names, values = metric.get()
        replays = mod._exec.graph_replays
        t0 = time.perf_counter()
        probe = ssd.MultiBoxMetric()
        probe.update([], mod.get_outputs())
        read_ms = (time.perf_counter() - t0) * 1e3
        out_mb = sum(math.prod(o.shape) for o in mod.get_outputs()) * 4 / 1e6
        print("ssd300 %s b%d f32 on the card (%s): fit of %d steps %.2f s "
              "(init and bind included); step ms %s (CUDA events between "
              "batch ends; the metric's host read inside); median after "
              "the first %.2f ms = %.1f images/s; graph replays %d; "
              "MultiBoxMetric %s; its read of the three outputs (%.1f MB) "
              "and update %.2f ms; peak memory allocated %.2f GB, "
              "reserved %.2f GB; K7 launches %d"
              % (name, SSD_BATCH, smi, SSD_STEPS, fit_s,
                 ["%.2f" % t for t in step_ms], steady,
                 SSD_BATCH / steady * 1e3, replays,
                 dict(zip(names, ["%.4f" % v for v in values])), out_mb,
                 read_ms, peak[0], peak[1], nms.greedy_nms_cuda.launches),
              flush=True)
        _finite_params("ssd300 " + name, mod)
        if not all(np.isfinite(values)):
            raise RuntimeError("ssd300 %s: metric values %s" % (name, values))
        if nms.greedy_nms_cuda.launches:
            raise RuntimeError("ssd300 training launched K7")
        if fused and replays != SSD_STEPS - 1:
            raise RuntimeError("ssd300 captured: %d replays in %d steps"
                               % (replays, SSD_STEPS))
        if not fused:
            it.reset()
            profile_step(mod, next(it), steady)
            out = mod
        else:
            del mod
        torch.cuda.empty_cache()
    rs = np.random.RandomState(seed + 18)
    pick = rs.choice(len(x), PARITY_BATCH, replace=False)
    parity_phase(mx, bnk, seed, lambda mx, ctx=None: _ssd_module(mx, ssd,
                                                                 ctx),
                 "SSD300", step=ssd_step_updates, data=(x[pick], y[pick]),
                 perturb=1e-6)
    return out


def nms_ops(keep_sorted, cid_sorted, force):
    """IoUs the greedy loop computes on this data: for each visited box
    still kept and valid, one against each later valid box (of its class
    unless ``force``); times ``NMS_IOU_OPS``."""
    total = 0
    for keep, cid in zip(keep_sorted, cid_sorted):
        valid = cid >= 0
        later = np.cumsum(valid[::-1])[::-1] - valid
        alive = keep & valid
        if force:
            total += int(later[alive].sum())
        else:
            for c in np.unique(cid[alive]):
                same = cid == c
                lc = np.cumsum(same[::-1])[::-1] - same
                total += int(lc[alive & same].sum())
    return total * NMS_IOU_OPS


def mask_pass_pairs(cid_sorted):
    """Pair tests K7's mask pass makes on this data: each block of a row
    chunk and a column chunk at or right of it (64 visit positions each)
    whose chunks both hold a valid box tests every valid row against the
    64 columns."""
    total = 0
    for cid in cid_sorted:
        n = -(-len(cid) // 64)
        valid = np.zeros(n * 64, bool)
        valid[:len(cid)] = cid >= 0
        rows = valid.reshape(n, 64).sum(1)
        later = np.cumsum((rows > 0)[::-1])[::-1]
        total += int((rows * later).sum()) * 64
    return total


def ssd_k7_inputs(mx, contrib, deploy, arg, aux, x):
    """K7's inputs for the batch ``x`` from the deploy graph's internals
    under the weights ``arg``, ``aux``: (cls_prob, loc_pred, anchors,
    class ids, boxes, visit order), the last three as MultiBoxDetection
    hands them to NMS (threshold 0.01, clipped)."""
    inner = deploy.get_internals()
    heads = mx.sym.Group([inner["cls_prob_output"],
                          inner["multibox_loc_pred_output"],
                          inner["multibox_anchors_output"]])
    ex = heads.simple_bind(mx.gpu(0), data=x.shape)
    ex.copy_params_from(arg, aux, allow_extra_params=True)
    ex.arg_dict["data"][:] = x
    cls_prob, loc, anchors = [o._t for o in ex.forward(is_train=False)]
    anchors = anchors.reshape(-1, 4)
    if anchors.shape[0] != SSD_ANCHORS:
        raise RuntimeError("SSD300 has %d anchors, expected %d"
                           % (anchors.shape[0], SSD_ANCHORS))
    with torch.no_grad():
        _score, cid, boxes, order = contrib.nms_inputs(
            cls_prob, loc, anchors, True, 0.01, SSD_VARIANCES)
    return cls_prob, loc, anchors, cid, boxes, order


def ssd_detection_phase(mx, ssd, ssd_detect, contrib, nms, mod, seed, smi):
    """Phase 18b: the trained weights of 18a through the deploy graph
    (``get_symbol``: ``SoftmaxActivation``, ``MultiBoxDetection`` with NMS
    0.5, ``force_suppress``, top 400) and the port's ``Detector`` at b32
    on the card: two ``detect`` passes over 32 images of
    ``synth_detection_set`` (seed 99), one K7 launch each, no plain NMS
    on the card; the VOC mAP of the kept rows printed, not judged (random
    weights after a few steps).  Then K7 on that batch's own inputs
    against its plain version run on the card: equal class ids, scores
    and boxes within 1e-6; K7's time (CUDA events, 10 launches) beside
    the plain version's (one call), the bound (the larger of the bytes,
    each input read once and the mask written, over 3.35 TB/s, and the
    IoUs this data needs over 67 TFLOP/s f32) and no library call (core
    PyTorch has no NMS); its time split into the mask pass and the scan
    (each launched alone over one workspace, 10 launches), the workspace
    MB and the mask pass's pair tests on this data.  Then one call at
    ``_contrib_Proposal``'s inference size (B=1, A=6000, ``force``, IoU
    0.7, visit order ``arange``) over the first image's top 6000 boxes,
    held against the plain version on the card and timed beside it.
    Returns K7's row for the kernels line."""
    x, labels = ssd.synth_detection_set(SSD_BATCH, SSD_IMAGE, SSD_CLASSES,
                                        seed=99 + seed)
    arg, aux = mod.get_params()
    plain = nms.greedy_nms_plain

    def refused(boxes, *a):
        if boxes.is_cuda:
            raise RuntimeError("plain NMS called on the card")
        return plain(boxes, *a)

    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "ssd300")
        mx.model.save_checkpoint(prefix, 1, mod.symbol, arg, aux)
        deploy = ssd.get_symbol(num_classes=SSD_CLASSES)
        det = ssd_detect.Detector(deploy, prefix, 1, SSD_IMAGE,
                                  mean_pixels=(0, 0, 0),
                                  batch_size=SSD_BATCH)
        nms.greedy_nms_plain = refused
        try:
            nms.greedy_nms_cuda.launches = 0
            det.detect(mx.io.NDArrayIter(data=x, batch_size=SSD_BATCH))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = det.detect(mx.io.NDArrayIter(data=x,
                                                   batch_size=SSD_BATCH))
            torch.cuda.synchronize()
            det_s = time.perf_counter() - t0
            launches = nms.greedy_nms_cuda.launches
        finally:
            nms.greedy_nms_plain = plain
    if launches != 2:
        raise RuntimeError("detection launched K7 %d times in 2 passes"
                           % launches)
    aps, mean_ap = ssd_detect.eval_detections(results, list(labels),
                                              SSD_CLASSES)
    kept = [len(r) for r in results]
    cls_prob, loc, anchors, cid, boxes, order = ssd_k7_inputs(
        mx, contrib, deploy, arg, aux, x)
    with torch.no_grad():
        rows = [contrib.multibox_detection(
            cls_prob, loc, anchors, True, 0.01, SSD_NMS, SSD_FORCE,
            SSD_VARIANCES, 400, nms=fn)
            for fn in (nms.greedy_nms_cuda, plain)]
        keep = nms.greedy_nms_cuda(boxes, cid, order, SSD_NMS, SSD_FORCE)
        keep_p = plain(boxes, cid, order, SSD_NMS, SSD_FORCE)
    torch.cuda.synchronize()
    if not torch.equal(rows[0][..., 0], rows[1][..., 0]) \
            or not torch.equal(keep, keep_p):
        raise RuntimeError("K7 keeps %d boxes, its plain version %d "
                           "(%d disagree)" % (
                               int(keep.sum()), int(keep_p.sum()),
                               int((keep != keep_p).sum())))
    err = float((rows[0][..., 1:] - rows[1][..., 1:]).abs().max())
    if err > 1e-6:
        raise RuntimeError("K7's rows differ from the plain version's by "
                           "%.3g" % err)
    ms = _time_ms(lambda: nms.greedy_nms_cuda(boxes, cid, order, SSD_NMS,
                                              SSD_FORCE), 10)
    plain_ms = _time_ms(lambda: plain(boxes, cid, order, SSD_NMS,
                                      SSD_FORCE), 1, warmup=0)
    _keep, work = nms.launch_parts(boxes, cid, order, SSD_NMS, SSD_FORCE)
    mask_ms, scan_ms = [
        _time_ms(lambda p=part: nms.launch_parts(
            boxes, cid, order, SSD_NMS, SSD_FORCE, parts=p, work=work), 10)
        for part in (nms.MASK, nms.SCAN)]
    del work, _keep
    b, a = cid.shape
    work_mb = nms.workspace_bytes(b, a) / 1e6
    order_np = order.cpu().numpy()
    keep_sorted = np.take_along_axis(keep.cpu().numpy(), order_np, 1)
    cid_sorted = np.take_along_axis(cid.cpu().numpy(), order_np, 1)
    ops = nms_ops(keep_sorted, cid_sorted, SSD_FORCE)
    pairs = mask_pass_pairs(cid_sorted)
    # rcnn's Proposal: its pre-NMS top 6000 boxes of one image, in score
    # order, one class
    n_prop = 6000
    pb = boxes[0][order[0][:n_prop]][None].contiguous()
    pc = torch.where(cid[0][order[0][:n_prop]] >= 0, 0.0, -1.0)[None]
    po = torch.arange(n_prop, device=pb.device)[None]
    with torch.no_grad():
        pk = nms.greedy_nms_cuda(pb, pc, po, 0.7, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pk_p = plain(pb, pc, po, 0.7, True)
        torch.cuda.synchronize()
        prop_plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(pk, pk_p):
        raise RuntimeError("K7 at the Proposal size keeps %d boxes, its "
                           "plain version %d" % (int(pk.sum()),
                                                 int(pk_p.sum())))
    prop_ms = _time_ms(lambda: nms.greedy_nms_cuda(pb, pc, po, 0.7, True),
                       10)
    print("K7 at rcnn Proposal's inference size (%s): B=1, A=%d, force, "
          "IoU 0.7, the first image's top boxes: keeps %d, equal to its "
          "plain version; kernel %.4f ms, plain %.1f ms, workspace %.1f MB"
          % (smi, n_prop, int(pk.sum()), prop_ms, prop_plain_ms,
             nms.workspace_bytes(1, n_prop) / 1e6), flush=True)
    byte_ms = b * a * (16 + 4 + 4 + 1) / PEAK_BYTES * 1e3
    op_ms = ops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(byte_ms, op_ms)
    bound_by = "bytes" if byte_ms >= op_ms else "operations"
    print("ssd300 detection b%d on the card (%s): Detector.detect %.1f ms "
          "(deploy forward, K7 and the host copy of the rows); kept rows "
          "an image %s; synthetic VOC mAP %.4f (not judged); K7 launches "
          "on the detection path %d; K7 at A=%d: keeps %d of %d valid "
          "boxes, max_abs_err %.3g against its plain version, kernel %.4f "
          "ms (launched apart: mask pass %.4f ms, scan %.4f ms; workspace "
          "%.1f MB), plain %.2f ms, bound %.5f ms (%s: %.3g IoU "
          "operations, %.3g MB); the mask pass tests %d pairs (%.3g times "
          "the greedy loop's IoUs; %.4f ms at %d operations a pair over "
          "67 TFLOP/s); no library call (core PyTorch has no NMS)"
          % (SSD_BATCH, smi, det_s * 1e3, kept, mean_ap, launches, a,
             int((keep & (cid >= 0)).sum()), int((cid >= 0).sum()), err, ms,
             mask_ms, scan_ms, work_mb, plain_ms, bound_ms, bound_by, ops,
             b * a * 25 / 1e6, pairs, pairs / (ops / NMS_IOU_OPS),
             pairs * NMS_IOU_OPS / PEAK_F32_FLOPS * 1e3, NMS_IOU_OPS),
          flush=True)
    row = dict(name="greedy_nms", route="cuda",
               source="mxnet_tpu_torch/csrc/nms.cu",
               replaces="mxnet_tpu/ops/contrib.py:243", launches=launches,
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None, mask_ms=mask_ms,
               scan_ms=scan_ms, workspace_mb=work_mb, mask_pairs=pairs,
               proposal_a6000=dict(ms=prop_ms, plain_ms=prop_plain_ms))
    return row


def _classic_module(network, kw):
    def make(mx, ctx=None):
        net = mx.models.get_symbol(network, num_classes=1000, **kw)
        return mx.mod.Module(net) if ctx is None \
            else mx.mod.Module(net, context=ctx)
    return make


def classic_phase(mx, bnk, seed, smi):
    """Phase 18c: ``Module.fit`` of VGG-16 (with and without
    ``batch_norm``), GoogLeNet, Inception-BN, AlexNet and
    Inception-ResNet-v2 (1000 classes, f32, b32) on the card for
    ``CLASSIC_STEPS`` batches of uniform data
    from ``--seed``, SGD lr 0.01 momentum 0.9 wd 1e-4, Xavier (gaussian,
    in, 2).  The BatchNorm networks launch K1 and K2 once per BatchNorm a
    step, no plain BatchNorm on the card, and in one more step every K1
    and K2 call is held against its references on its own tensors
    (:func:`checked_step`); every network ends finite.  Prints step ms,
    images/s and peak memory, and for ``CLASSIC_PROFILED`` one more step
    under the profiler (:func:`profile_step`).  Then one Inception-BN b4 step on the card
    against the CPU (:func:`parity_phase`), the distance over all updates
    within 3x the largest of three perturbed CPU steps: per tensor, its
    tail (7x7 maps at b4, 3x3 max pools of stride 1) sits at near-ties,
    where the card's convolutions, rounded otherwise than the CPU's, route
    a max-pool or ReLU gradient to another element and move one tensor's
    update 59x its perturbed floor in one run, with the plain BatchNorm on
    the card as with K1/K2.  Returns the K1 and K2 launches."""
    total = [0, 0]
    for network, kw, side in CLASSIC_NETS:
        label = network + ("-bn" if kw.get("batch_norm") else "")
        make = _classic_module(network, kw)
        mod = make(mx)
        n_bn = sum(net_bn_configs(mx, mod.symbol,
                                  (CLASSIC_BATCH, 3, side, side)).values())
        rng = np.random.default_rng(seed + 18)
        n = CLASSIC_BATCH * CLASSIC_STEPS
        x = rng.random((n, 3, side, side), dtype=np.float32) * 2 - 1
        y = rng.integers(0, 1000, n).astype(np.float32)
        it = mx.io.NDArrayIter(x, y, batch_size=CLASSIC_BATCH)
        events, mark = _step_events()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        with bn_plain_refused(bnk):
            mx.init.seed(seed)
            bnk.bn_fwd_cuda.launches = 0
            bnk.bn_bwd_cuda.launches = 0
            start.record()
            mod.fit(it, num_epoch=1, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.01,
                                      "momentum": 0.9, "wd": 1e-4},
                    initializer=mx.init.Xavier(rnd_type="gaussian",
                                               factor_type="in",
                                               magnitude=2),
                    batch_end_callback=[mark])
            torch.cuda.synchronize()
            launches = (bnk.bn_fwd_cuda.launches, bnk.bn_bwd_cuda.launches)
        step_ms = _steps_ms(start, events)
        steady = float(np.median(step_ms[1:]))
        print("%s b%d %dx%d f32 on the card (%s): step ms %s (CUDA events "
              "between batch ends); median after the first %.2f ms = %.1f "
              "images/s; %d BatchNorms, K1 launches %d, K2 launches %d; "
              "peak memory allocated %.2f GB, reserved %.2f GB"
              % (label, CLASSIC_BATCH, side, side, smi,
                 ["%.2f" % t for t in step_ms], steady,
                 CLASSIC_BATCH / steady * 1e3, n_bn, launches[0],
                 launches[1], torch.cuda.max_memory_allocated() / 1e9,
                 torch.cuda.max_memory_reserved() / 1e9), flush=True)
        want = n_bn * CLASSIC_STEPS
        if launches != (want, want):
            raise RuntimeError("%s: K1/K2 launched %s times, expected %d "
                               "each" % (label, launches, want))
        _finite_params(label, mod)
        total = [total[0] + launches[0], total[1] + launches[1]]
        if n_bn:
            it.reset()
            checked_step(mod, next(it), bnk, n_bn, label)
        if network in CLASSIC_PROFILED:
            it.reset()
            profile_step(mod, next(it), steady, groups=CLASSIC_GROUPS)
        del mod, it
        torch.cuda.empty_cache()
    parity_phase(mx, bnk, seed, _classic_module("inception-bn", {}),
                 "Inception-BN", (3, 224, 224), (-1, 1), bound="global")
    return total


def detection_phase(mx, bnk, seed, smi):
    """Phase 18: SSD300 training (18a), detection through K7 (18b) and
    the classic classifiers (18c).  Returns (K7's row, K1/K2 launches)."""
    from mxnet_tpu_torch.models import ssd_detect, ssd_vgg16
    from mxnet_tpu_torch.ops import contrib, nms_kernel

    t0 = time.perf_counter()
    mod = ssd_training_phase(mx, bnk, ssd_vgg16, nms_kernel, seed, smi)
    t1 = time.perf_counter()
    k7 = ssd_detection_phase(mx, ssd_vgg16, ssd_detect, contrib, nms_kernel,
                             mod, seed, smi)
    del mod
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    bn = classic_phase(mx, bnk, seed, smi)
    print("phase 18 %.1f s: training %.1f, detection %.1f, classic %.1f"
          % (time.perf_counter() - t0, t1 - t0, t2 - t1,
             time.perf_counter() - t2), flush=True)
    return k7, bn


# -- Faster R-CNN (phase 19) --------------------------------------------------
#: Faster R-CNN's single-scale setting (Ren et al., NIPS 2015, sections
#: 3.1.3 and 4): one image a mini-batch, its shorter side 600 (600x1000),
#: VOC's 20 classes and the background, 9 anchors
RCNN_IMAGE, RCNN_CLASSES, RCNN_ANCHORS = (600, 1000), 21, 9
RCNN_STEPS = 4
#: example/rcnn/train.py's SGD
RCNN_OPT = {"learning_rate": 0.001, "momentum": 0.9}
#: the pre- and post-NMS top-N of training and inference (rcnn.py:56-57)
RCNN_TRAIN_PRE, RCNN_TRAIN_ROIS = 12000, 2000
RCNN_TEST_PRE, RCNN_TEST_ROIS = 6000, 300
#: the share of anchors labelled -1 (ignored through use_ignore)
RCNN_IGNORE = 0.1
#: the relative input perturbation of the RPN step's floor, phase 18a's:
#: VGG16 has no BatchNorm to amplify a smaller one
RPN_PERTURB = 1e-6
RPN_LABELS = ("label", "bbox_target", "bbox_weight")
ROI_LABELS = ("roi_label", "roi_bbox_target", "roi_bbox_weight")
#: ROIPooling of rcnn.py: 7x7 bins of conv5_3 at stride 16
ROI_POOLED, ROI_SCALE = (7, 7), 1.0 / 16
#: operations a bin's pixel costs K8 (a comparison) and K8b (a comparison
#: and an addition)
ROI_FWD_OPS, ROI_BWD_OPS = 1, 2
#: the profile's groups of phase 19's kernels (lowercase names)
RCNN_GROUPS = (("K7 (nms_*)", lambda k: "nms_" in k),
               ("K8 (roi_pool_fwd)", lambda k: "roi_pool_fwd" in k),
               ("K8b (roi_pool_bwd)", lambda k: "roi_pool_bwd" in k),
               ("K8 ROI bounds", lambda k: "roi_bounds" in k))


def rcnn_feature_map(image=RCNN_IMAGE):
    """VGG16's conv5 map of an image: four 2x2 pools of stride 2, each
    rounding down (37x62 at 600x1000)."""
    h, w = image
    for _ in range(4):
        h, w = h // 2, w // 2
    return h, w


def rcnn_batches(seed, steps, build, image=RCNN_IMAGE,
                 classes=RCNN_CLASSES):
    """``steps`` seeded batches ``{name: array}`` of the inputs of graph
    ``build`` ("rpn", "train" or "test"): images uniform in [0, 1); the
    example's anchor labels (an anchor is positive where the image is
    bright at its cell) with ``RCNN_IGNORE`` of them -1; box targets with
    weights on the positive anchors; ROI labels in [0, classes), box
    targets with weights on the foreground ROIs."""
    rs = np.random.RandomState(seed)
    h, w = image
    fh, fw = rcnn_feature_map(image)
    out = []
    for _ in range(steps):
        img = rs.rand(1, 3, h, w).astype(np.float32)
        b = {"data": img}
        if build != "rpn":
            b["im_info"] = np.array([[h, w, 1.0]], np.float32)
        if build != "test":
            lab = (img.mean(1)[:, :16 * fh:16, :16 * fw:16] > 0.5)
            lab = np.tile(lab.reshape(1, 1, -1).astype(np.float32),
                          (1, RCNN_ANCHORS, 1)).reshape(1, -1)
            lab[rs.rand(*lab.shape) < RCNN_IGNORE] = -1.0
            b["label"] = lab
            b["bbox_target"] = rs.normal(
                0, 0.5, (1, 4 * RCNN_ANCHORS, fh, fw)).astype(np.float32)
            pos = (lab.reshape(1, RCNN_ANCHORS, 1, fh, fw) > 0)
            b["bbox_weight"] = np.broadcast_to(
                pos, (1, RCNN_ANCHORS, 4, fh, fw)).reshape(
                1, 4 * RCNN_ANCHORS, fh, fw).astype(np.float32)
        if build == "train":
            rl = rs.randint(0, classes, RCNN_TRAIN_ROIS).astype(np.float32)
            b["roi_label"] = rl
            b["roi_bbox_target"] = rs.normal(
                0, 0.5, (RCNN_TRAIN_ROIS, 4 * classes)).astype(np.float32)
            b["roi_bbox_weight"] = np.repeat(
                (rl > 0)[:, None], 4 * classes, 1).astype(np.float32)
        out.append(b)
    return out


def rcnn_names(build):
    """(data names, label names) of graph ``build``."""
    data = ("data",) if build == "rpn" else ("data", "im_info")
    labels = {"rpn": RPN_LABELS, "train": RPN_LABELS + ROI_LABELS,
              "test": ()}[build]
    return data, labels


def rcnn_iter(mx, batches, build):
    """A ``DataIter`` over ``batches`` (:func:`rcnn_batches`), as
    ``example/rcnn`` feeds its ``DataBatch``es: the ROI inputs keep their
    (2000, ...) shapes, which an ``NDArrayIter`` would batch."""
    data_names, label_names = rcnn_names(build)

    class BatchList(mx.io.DataIter):
        def __init__(self):
            super().__init__(1)
            self.cursor = 0
            self.provide_data = [mx.io.DataDesc(k, batches[0][k].shape)
                                 for k in data_names]
            self.provide_label = [mx.io.DataDesc(k, batches[0][k].shape)
                                  for k in label_names]

        def reset(self):
            self.cursor = 0

        def next(self):
            if self.cursor == len(batches):
                raise StopIteration
            b = batches[self.cursor]
            self.cursor += 1
            return mx.io.DataBatch(
                data=[mx.nd.array(b[k]) for k in data_names],
                label=[mx.nd.array(b[k]) for k in label_names], pad=0)

    return BatchList()


def anchor_ce_metric(mx):
    """The cross-entropy of the RPN's anchor labels (output 0 against the
    first label, the -1 anchors left out), each batch kept in ``.ces``;
    the port's ``SoftmaxOutput`` with ``use_ignore`` trains on it."""
    class AnchorCE(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("anchor-ce")
            self.ces = []

        def update(self, labels, preds):
            lab = labels[0].asnumpy().reshape(-1)
            p = preds[0].asnumpy()[0].T  # (anchors, 2)
            keep = lab >= 0
            ce = float(-np.log(np.maximum(
                p[np.nonzero(keep)[0], lab[keep].astype(int)], 1e-9)).mean())
            self.ces.append(ce)
            self.sum_metric += ce
            self.num_inst += 1

    return AnchorCE()


def rcnn_module(mx, rcnn, build, ctx=None):
    net = rcnn.get_symbol_rpn() if build == "rpn" else getattr(
        rcnn, "get_symbol_" + build)(num_classes=RCNN_CLASSES)
    data_names, label_names = rcnn_names(build)
    kw = {} if ctx is None else {"context": ctx}
    return mx.mod.Module(net, data_names=data_names, label_names=label_names,
                         **kw)


def rcnn_fit(mx, rcnn, build, batches, seed):
    """``Module.fit`` of graph ``build`` over ``batches`` on the card from
    seeded Xavier weights with ``RCNN_OPT``: (module, metric, step ms by
    CUDA events between batch ends, fit seconds, peak GB allocated and
    reserved)."""
    mod = rcnn_module(mx, rcnn, build)
    metric = anchor_ce_metric(mx)
    events, mark = _step_events()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    mx.init.seed(seed)
    start.record()
    t0 = time.perf_counter()
    mod.fit(rcnn_iter(mx, batches, build), eval_metric=metric,
            optimizer="sgd", optimizer_params=dict(RCNN_OPT),
            initializer=mx.init.Xavier(), num_epoch=1,
            batch_end_callback=[mark])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() / 1e9,
            torch.cuda.max_memory_reserved() / 1e9)
    _finite_params("rcnn " + build, mod)
    if not all(np.isfinite(metric.ces)):
        raise RuntimeError("rcnn %s: anchor cross-entropies %s"
                           % (build, metric.ces))
    return mod, metric, _steps_ms(start, events), fit_s, peak


def rcnn_counts(nms, rk, reset=False):
    """K7, K8 and K8b launches (set to 0 first when ``reset``)."""
    wrappers = (nms.greedy_nms_cuda, rk.roi_pool_fwd_cuda,
                rk.roi_pool_bwd_cuda)
    if reset:
        for w in wrappers:
            w.launches = 0
    return tuple(w.launches for w in wrappers)


def rcnn_plain_refused(nms, rk):
    """The plain NMS and ROI pooling refused on the card: the path must
    take K7, K8 and K8b."""
    return plain_refused((nms, "greedy_nms_plain"),
                         (rk, "roi_pool_fwd_plain"),
                         (rk, "roi_pool_bwd_plain"))


def rpn_fit_phase(mx, rcnn, nms, rk, seed, smi):
    """Phase 19a: ``get_symbol_rpn`` through ``Module.fit`` on the card
    for ``RCNN_STEPS`` steps at 600x1000 (SGD lr 0.001, momentum 0.9, as
    ``example/rcnn/train.py``), the example's brightness labels with a
    tenth of the anchors ignored: step ms and the anchor cross-entropy of
    each step, peak memory; no K7, K8 or K8b launch (the RPN graph has no
    Proposal and no ROIPooling)."""
    batches = rcnn_batches(seed + 19, RCNN_STEPS, "rpn")
    rcnn_counts(nms, rk, reset=True)
    mod, metric, step_ms, fit_s, peak = rcnn_fit(mx, rcnn, "rpn", batches,
                                                 seed)
    counts = rcnn_counts(nms, rk)
    steady = float(np.median(step_ms[1:]))
    print("rcnn RPN fit b1 %dx%d f32 on the card (%s): fit of %d steps "
          "%.2f s (init and bind included); step ms %s (CUDA events between "
          "batch ends; the metric's host read inside), median after the "
          "first %.2f ms; anchor cross-entropy by step %s; peak memory "
          "allocated %.2f GB, reserved %.2f GB; K7/K8/K8b launches %s"
          % (RCNN_IMAGE + (smi, RCNN_STEPS, fit_s,
                           ["%.2f" % t for t in step_ms], steady,
                           ["%.4f" % c for c in metric.ces]) + peak
             + (counts,)), flush=True)
    if any(counts):
        raise RuntimeError("the RPN fit launched K7/K8/K8b %s" % (counts,))
    return steady


def rcnn_step_updates(mx, make_module, ctx, x, y, seed):
    """:func:`step_updates` for the RPN graph: one step of ``RCNN_OPT`` on
    the image ``x`` with the labels ``y`` (a dict)."""
    batch = dict(y, data=x)
    mod = make_module(mx, ctx)
    it = rcnn_iter(mx, [batch], "rpn")
    mod.bind(it.provide_data, it.provide_label)
    mx.init.seed(seed)
    mod.init_params(mx.init.Xavier())
    before = mx.convert.module_params_to_numpy(mod)[0]
    mod.fit(it, num_epoch=1, eval_metric=anchor_ce_metric(mx),
            optimizer_params=dict(RCNN_OPT))
    arg, aux = mx.convert.module_params_to_numpy(mod)
    return {k: arg[k] - before[k] for k in arg}, aux, arg


def e2e_fit_phase(mx, rcnn, nms, rk, seed, smi):
    """Phase 19b: ``get_symbol_train`` (21 classes) through ``Module.fit``
    on the card for ``RCNN_STEPS`` steps at 600x1000, classic and then
    captured (``MXNET_FUSE_TRAIN_STEP=1``) where ``_full_step_eligible``
    admits it; Proposal (pre/post-NMS 12000/2000) and ROIPooling forward
    on the forward path, ROIPooling's backward on the backward path.
    Each run launches K7, K8 and K8b once a step (a replay adds what its
    capture recorded), calls no plain NMS or ROI pooling on the card and
    ends finite.  Prints step ms, the launches, peak memory and a profile
    of one classic step by group.  Returns (the classic module, its
    batches, launches over both runs, step ms by run)."""
    batches = rcnn_batches(seed + 20, RCNN_STEPS, "train")
    total = (0, 0, 0)
    out, times = None, {}
    for fused in (False, True):
        name = "captured" if fused else "classic"
        with environment({"MXNET_FUSE_TRAIN_STEP": "1" if fused else None,
                          "MXNET_BULK_TRAIN_STEPS": None}), \
                rcnn_plain_refused(nms, rk):
            rcnn_counts(nms, rk, reset=True)
            mod, metric, step_ms, fit_s, peak = rcnn_fit(
                mx, rcnn, "train", batches, seed)
            counts = rcnn_counts(nms, rk)
            eligible = mod._full_step_eligible()
        replays = mod._exec.graph_replays
        steady = float(np.median(step_ms[1:]))
        times[name] = steady
        print("rcnn end-to-end fit b1 %dx%d, %d classes, f32 on the card "
              "(%s), %s: fit of %d steps %.2f s (init and bind included); "
              "step ms %s (CUDA events between batch ends), median after "
              "the first %.2f ms; graph replays %d; anchor cross-entropy "
              "by step %s; K7/K8/K8b launches %s (%s a step); peak memory "
              "allocated %.2f GB, reserved %.2f GB"
              % (RCNN_IMAGE + (RCNN_CLASSES, smi, name, RCNN_STEPS, fit_s,
                               ["%.2f" % t for t in step_ms], steady,
                               replays, ["%.4f" % c for c in metric.ces],
                               counts, [c / RCNN_STEPS for c in counts])
                 + peak), flush=True)
        if fused and not eligible:
            print("rcnn end-to-end: _full_step_eligible refuses the fused "
                  "step (the classic two-phase step ran)", flush=True)
        if counts != (RCNN_STEPS,) * 3:
            raise RuntimeError("rcnn %s fit launched K7/K8/K8b %s times in "
                               "%d steps" % (name, counts, RCNN_STEPS))
        if fused and eligible and replays != RCNN_STEPS - 1:
            raise RuntimeError("rcnn captured: %d replays in %d steps"
                               % (replays, RCNN_STEPS))
        total = tuple(a + b for a, b in zip(total, counts))
        if not fused:
            it = rcnn_iter(mx, batches, "train")
            profile_step(mod, next(it), steady, groups=RCNN_GROUPS)
            out = mod
        else:
            del mod
        torch.cuda.empty_cache()
    return out, batches, total, times


def rcnn_internals(mx, mod, names, batch):
    """The outputs ``names`` of ``mod``'s graph on ``batch`` (a dict) under
    its weights, on the card, as tensors."""
    inner = mod.symbol.get_internals()
    group = mx.sym.Group([inner[n] for n in names])
    args = set(group.list_arguments())
    ex = group.simple_bind(mx.gpu(0), grad_req="null",
                           **{k: v.shape for k, v in batch.items()
                              if k in args})
    arg, aux = mod.get_params()
    ex.copy_params_from(arg, aux, allow_extra_params=True)
    for k, v in batch.items():
        if k in args:
            ex.arg_dict[k][:] = v
    return [o._t for o in ex.forward(is_train=False)]


def proposal_nms_inputs(mx, contrib, nms, mod, batch, pre, post):
    """K7's inputs (boxes, class ids, visit order) in Proposal on
    ``batch`` under ``mod``'s weights, as its graph runs it."""
    cls_prob, bbox_pred = rcnn_internals(
        mx, mod, ["rpn_cls_act_reshape_output", "rpn_bbox_pred_output"],
        batch)
    info = torch.from_numpy(batch["im_info"]).to(cls_prob.device)
    seen = {}

    def capture(boxes, cls_id, order, thresh, force):
        seen.update(boxes=boxes, cls=cls_id, order=order)
        return nms.greedy_nms_cuda(boxes, cls_id, order, thresh, force)

    args = (cls_prob, bbox_pred, info, 16, (8.0, 16.0, 32.0),
            (0.5, 1.0, 2.0), pre, post, 0.7, 16)
    with torch.no_grad():
        contrib.proposal(*args, nms=capture)
    return seen


def roi_bytes(x, rois, bwd, design=None):
    """Bytes ROI pooling's forward (``bwd`` False) or backward must move
    on these inputs, each read or written once: the forward reads the map
    and the ROIs and writes the maxima; the backward reads the map, the
    ROIs and the maxima's gradient and writes the map's.  With ``design``
    (for the backward :func:`roi_g_reads`' count; any value for the
    forward), what K8 and K8b move instead: K8 also writes and reads the
    channels-last map; K8b reads that map in place of the other (the same
    bytes) and the gradient's bins ``design`` times in all."""
    out = rois.shape[0] * x.shape[1] * ROI_POOLED[0] * ROI_POOLED[1] * 4
    need = x.numel() * 4 * (2 if bwd else 1) + rois.numel() * 4 + out
    if design is None:
        return need
    if not bwd:
        return need + 2 * x.numel() * 4
    return need - out + design * x.shape[1] * 4


def roi_g_reads(rk, x, rois, plan=None):
    """The (ROI, bin) gradient vectors K8b reads on these inputs with
    ``plan`` (:func:`roi_bwd_plan`'s when None): a tile's staging reads
    each bin row and column of a listed ROI that meets the tile, so a bin
    is read once for each tile it meets."""
    B, C, H, W = x.shape
    p = rk.roi_bwd_plan(H, W) if plan is None else plan
    _b, hs, he, ws, we = rk.roi_bounds(rois, B, H, W, ROI_POOLED, ROI_SCALE)
    lo = torch.arange(0, H, p["band"], device=hs.device)
    hi = (lo + p["band"]).clamp(max=H)
    wlo = torch.arange(0, W, p["width"], device=hs.device)
    whi = (wlo + p["width"]).clamp(max=W)
    # (R, bands, ph) and (R, column tiles, pw): the bins meeting a tile
    rows = (he[:, None, :] > lo[None, :, None]) \
        & (hs[:, None, :] < hi[None, :, None])
    cols = (we[:, None, :] > wlo[None, :, None]) \
        & (ws[:, None, :] < whi[None, :, None])
    meets_r = (hs[:, None, 0] < hi) & (he[:, None, -1] > lo)
    meets_c = (ws[:, None, 0] < whi) & (we[:, None, -1] > wlo)
    nr = rows.sum(-1) * meets_r  # (R, bands)
    nc = cols.sum(-1) * meets_c  # (R, column tiles)
    return int((nr[:, :, None] * nc[:, None, :]).sum())


def roi_bound_ms(rk, x, rois, bwd):
    """The least time the card could take for ROI pooling's forward (K8,
    ``bwd`` False) or backward (K8b) on these inputs: the larger of
    :func:`roi_bytes` over 3.35 TB/s and the bins' pixels this data visits
    (a comparison each; the backward also an addition) over 67 TFLOP/s.
    Returns (ms, "bytes" or "operations")."""
    B, C, H, W = x.shape
    nbytes = roi_bytes(x, rois, bwd)
    _b, hs, he, ws, we = rk.roi_bounds(rois, B, H, W, ROI_POOLED, ROI_SCALE)
    pixels = int(((he - hs).clamp(min=0)[:, :, None]
                  * (we - ws).clamp(min=0)[:, None, :]).sum()) * C
    ops = pixels * (ROI_BWD_OPS if bwd else ROI_FWD_OPS)
    byte_ms = nbytes / PEAK_BYTES * 1e3
    op_ms = ops / PEAK_F32_FLOPS * 1e3
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms
                                 else "operations")


def roi_kernel_rows(rk, x, rois, g, launches, smi, label):
    """K8 and K8b on ``x`` (B, C, H, W), ``rois`` and the output gradient
    ``g`` on the card against their plain versions run on the card:
    K8's maxima and channels-last map bit for bit, K8b within 1e-5 of the
    largest |dx| of the plain version and bit for bit across two
    launches; timed (CUDA events, 10 launches; the plain versions once)
    beside the bound (:func:`roi_bound_ms`) and the bytes the kernels
    move (:func:`roi_bytes` with ``design``).  Returns the kernels line's
    two rows, with ``launches`` (K8's, K8b's) from the main path; no
    library call (core PyTorch has no ROI pooling, and ``torchvision`` is
    not on the card machine)."""
    with torch.no_grad():
        out, bnd, xt = rk.roi_pool_fwd_cuda(x, rois, ROI_POOLED, ROI_SCALE)
        pout, pbnd, pxt = rk.roi_pool_fwd_plain(x, rois, ROI_POOLED,
                                                ROI_SCALE)
        dx = rk.roi_pool_bwd_cuda(xt, bnd, g, ROI_POOLED)
        again = rk.roi_pool_bwd_cuda(xt, bnd, g, ROI_POOLED)
        pdx = rk.roi_pool_bwd_plain(pxt, pbnd, g, ROI_POOLED)
        count = rk.roi_bin_stats(pxt, pbnd, ROI_POOLED)[1]
        torch.cuda.synchronize()
    if not (torch.equal(out, pout) and torch.equal(xt, pxt)):
        raise RuntimeError("K8 differs from its plain version on %s: %d "
                           "maxima, %d map values" % (
                               label, int((out != pout).sum()),
                               int((xt != pxt).sum())))
    fwd_err = float((out - pout).abs().max())
    err = float((dx - pdx).abs().max())
    scale = float(pdx.abs().max())
    if not err <= 1e-5 * scale:
        raise RuntimeError("K8b differs from its plain version on %s by "
                           "%.3g (largest |dx| %.3g)" % (label, err, scale))
    if not torch.equal(dx, again):
        raise RuntimeError("K8b is not bit for bit across two launches")
    with torch.no_grad():
        fwd_ms = _time_ms(lambda: rk.roi_pool_fwd_cuda(
            x, rois, ROI_POOLED, ROI_SCALE), 10)
        bwd_ms = _time_ms(lambda: rk.roi_pool_bwd_cuda(
            xt, bnd, g, ROI_POOLED), 10)
        pf_ms = _time_ms(lambda: rk.roi_pool_fwd_plain(
            x, rois, ROI_POOLED, ROI_SCALE), 1, warmup=0)
        pb_ms = _time_ms(lambda: rk.roi_pool_bwd_plain(
            pxt, pbnd, g, ROI_POOLED), 1, warmup=0)
    rows = []
    for name, bwd, ms, plain_ms, e, n in (
            ("roi_pooling_fwd", False, fwd_ms, pf_ms, fwd_err, launches[0]),
            ("roi_pooling_bwd", True, bwd_ms, pb_ms, err, launches[1])):
        bound, by = roi_bound_ms(rk, x, rois, bwd)
        rows.append(dict(name=name, route="cuda",
                         source="mxnet_tpu_torch/csrc/roi_pooling.cu",
                         replaces="mxnet_tpu/ops/spatial.py:28",
                         launches=n, max_abs_err=e, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, library_ms=None))
    plan = rk.roi_bwd_plan(x.shape[2], x.shape[3])
    reads = roi_g_reads(rk, x, rois, plan)
    design = [roi_bytes(x, rois, False, design=True) / PEAK_BYTES * 1e3,
              roi_bytes(x, rois, True, design=reads) / PEAK_BYTES * 1e3]
    print("K8/K8b on %s (%s): map %s, %d ROIs, 7x7: K8 equals its plain "
          "version bit for bit (%d ties, %d empty or non-finite bins), "
          "K8b within %.3g of it (largest |dx| %.3g), bit for bit across "
          "two launches; K8 %.4f ms (plain %.2f, bound %.4f, %s; %.1fx the "
          "bound), K8b %.4f ms (plain %.2f, bound %.4f, %s; %.1fx the "
          "bound); K8b tiles of %d rows x %d columns x %d channels, %d "
          "threads, steps of up to %d ROIs and %d bins, %.2f reads of each "
          "bin's gradient; the bytes the kernels move, over the memory "
          "rate: K8 %.4f ms (with the channels-last map written and read), "
          "K8b %.4f ms (the gradient once a tile its bin meets); no library "
          "call (core PyTorch has no ROI pooling)"
          % (label, smi, tuple(x.shape), rois.shape[0],
             int((count > 1).sum()), int((count == 0).sum()), err, scale,
             fwd_ms, pf_ms, rows[0]["bound_ms"], rows[0]["bound_by"],
             fwd_ms / rows[0]["bound_ms"], bwd_ms, pb_ms,
             rows[1]["bound_ms"], rows[1]["bound_by"],
             bwd_ms / rows[1]["bound_ms"], plan["band"], plan["width"],
             plan["channels"], plan["threads"], plan["group"], plan["cap"],
             reads / g[:, 0].numel(), design[0], design[1]),
          flush=True)
    return rows


def e2e_roi_tensors(rk, mod, batch, mx):
    """One more end-to-end step (forward and backward, no update) with
    ROIPooling's backward recording what it was given: (conv5_3 map,
    rois, the gradient of pool5) of 19b's own step."""
    seen = {}
    real_fwd, real_bwd = rk.ROIPoolFn.forward, rk.ROIPoolFn.backward

    def forward(ctx, data, rois, *rest):
        seen.update(x=data, rois=rois)
        return real_fwd(ctx, data, rois, *rest)

    def backward(ctx, g):
        seen.update(g=g.contiguous())
        return real_bwd(ctx, g)

    rk.ROIPoolFn.forward = staticmethod(forward)
    rk.ROIPoolFn.backward = staticmethod(backward)
    try:
        mod.forward_backward(mx.io.DataBatch(
            data=[mx.nd.array(batch[k]) for k in rcnn_names("train")[0]],
            label=[mx.nd.array(batch[k]) for k in rcnn_names("train")[1]]))
        torch.cuda.synchronize()
    finally:
        rk.ROIPoolFn.forward = real_fwd
        rk.ROIPoolFn.backward = real_bwd
    return seen["x"].detach(), seen["rois"].detach(), seen["g"].detach()


def detection_test_phase(mx, rcnn, nms, rk, mod, seed, smi):
    """Phase 19c: 19b's classic weights through ``get_symbol_test`` and
    ``Module.forward(is_train=False)`` at b1 on the card, two passes over
    one seeded image: ``forward`` ms (host clock to the outputs' host
    copy), one K7 and one K8 launch a pass and no plain version on the
    card; 300 rois with finite boxes in the image, class probabilities
    that sum to 1, finite box deltas.  Returns (the module, its batch,
    launches (K7, K8), the second pass's ms)."""
    batch = rcnn_batches(seed + 21, 1, "test")[0]
    tmod = rcnn_module(mx, rcnn, "test")
    tmod.bind(for_training=False,
              data_shapes=[(k, batch[k].shape) for k in ("data", "im_info")])
    arg, aux = mod.get_params()
    tmod.set_params(arg, aux)
    db = mx.io.DataBatch(data=[mx.nd.array(batch[k])
                               for k in ("data", "im_info")], label=[])
    ms = []
    with rcnn_plain_refused(nms, rk):
        rcnn_counts(nms, rk, reset=True)
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tmod.forward(db, is_train=False)
            rois, cls_prob, bbox = [o.asnumpy() for o in tmod.get_outputs()]
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = rcnn_counts(nms, rk)
    h, w = RCNN_IMAGE
    ok = (rois.shape == (RCNN_TEST_ROIS, 5) and np.isfinite(rois).all()
          and (rois[:, 0] == 0).all() and (rois[:, 1:] >= 0).all()
          and (rois[:, [1, 3]] <= w - 1).all()
          and (rois[:, [2, 4]] <= h - 1).all()
          and cls_prob.shape == (RCNN_TEST_ROIS, RCNN_CLASSES)
          and np.allclose(cls_prob.sum(1), 1, atol=1e-5)
          and np.isfinite(bbox).all())
    kept = len(np.unique(rois[:, 1:], axis=0))
    print("rcnn detection b1 %dx%d on the card (%s): forward ms %s (host "
          "clock to the outputs' host copy; the second pass warm); %d "
          "distinct rois of %d; K7/K8/K8b launches %s"
          % (RCNN_IMAGE + (smi, ["%.2f" % t for t in ms], kept,
                           RCNN_TEST_ROIS, counts)), flush=True)
    if not ok:
        raise RuntimeError("rcnn detection outputs are malformed")
    if counts != (2, 2, 0):
        raise RuntimeError("rcnn detection launched K7/K8/K8b %s times in "
                           "2 passes" % (counts,))
    return tmod, batch, counts[:2], ms[1]


def rcnn_checks_phase(mx, bnk, rcnn, contrib, nms, rk, mod, batches, tmod,
                      tbatch, launches, smi, seed):
    """Phase 19d: K7 against the plain loop on Proposal's own inputs of
    19b (A = 12000) and 19c (A = 6000), the keep masks equal, each
    timed; K8/K8b (:func:`roi_kernel_rows`) on 19b's own conv5_3 map,
    ROIs and pool5 gradient (R = 2000), K8 on 19c's (R = 300) timed
    apart; one RPN-graph step on the card against the CPU within 3x the
    f32 floor of each parameter (:func:`parity_phase`, inputs perturbed
    by ``RPN_PERTURB``, and the CPU step on one thread among the
    witnesses: the classifier's bias gradient sums 2294 positions whose
    terms cancel, and its rounding moves with the order of the sum, not
    with the input).  Returns the kernels line's K8/K8b rows and K7's times at
    Proposal's sizes."""
    k7 = {}
    for label, m, b, pre, post in (
            ("19b", mod, batches[0], RCNN_TRAIN_PRE, RCNN_TRAIN_ROIS),
            ("19c", tmod, tbatch, RCNN_TEST_PRE, RCNN_TEST_ROIS)):
        seen = proposal_nms_inputs(mx, contrib, nms, m, b, pre, post)
        with torch.no_grad():
            keep = nms.greedy_nms_cuda(seen["boxes"], seen["cls"],
                                       seen["order"], 0.7, True)
            keep_p = nms.greedy_nms_plain(seen["boxes"], seen["cls"],
                                          seen["order"], 0.7, True)
        torch.cuda.synchronize()
        if not torch.equal(keep, keep_p):
            raise RuntimeError("K7 on Proposal's inputs of %s keeps %d "
                               "boxes, the plain loop %d" % (
                                   label, int(keep.sum()),
                                   int(keep_p.sum())))
        ms = _time_ms(lambda s=seen: nms.greedy_nms_cuda(
            s["boxes"], s["cls"], s["order"], 0.7, True), 10)
        k7[label] = dict(a=int(seen["boxes"].shape[1]), kept=int(keep.sum()),
                         ms=ms)
        print("K7 on Proposal's own inputs of %s (%s): A = %d, keeps %d, "
              "equal to the plain loop; %.4f ms"
              % (label, smi, k7[label]["a"], k7[label]["kept"], ms),
              flush=True)
    x, rois, g = e2e_roi_tensors(rk, mod, batches[0], mx)
    rows = roi_kernel_rows(rk, x, rois, g, launches, smi,
                           "19b's conv5_3, ROIs and pool5 gradient")
    x3, r3 = rcnn_internals(mx, tmod, ["relu5_3_output", "rois_output"],
                            tbatch)
    with torch.no_grad():
        out, _bnd, _xt = rk.roi_pool_fwd_cuda(x3, r3, ROI_POOLED, ROI_SCALE)
        pout, _pbnd, _pxt = rk.roi_pool_fwd_plain(x3, r3, ROI_POOLED,
                                                  ROI_SCALE)
    if not torch.equal(out, pout):
        raise RuntimeError("K8 differs from its plain version on 19c")
    k8_test = _time_ms(lambda: rk.roi_pool_fwd_cuda(
        x3, r3, ROI_POOLED, ROI_SCALE), 10)
    print("K8 at 19c's R = %d (%s): equal to its plain version bit for "
          "bit; %.4f ms (bound %.4f)" % (r3.shape[0], smi, k8_test,
                                        roi_bound_ms(rk, x3, r3, False)[0]),
          flush=True)
    rows[0]["detection_r300_ms"] = k8_test
    b = rcnn_batches(seed + 22, 1, "rpn")[0]
    parity_phase(mx, bnk, seed, lambda mx, ctx=None: rcnn_module(
        mx, rcnn, "rpn", ctx), "RPN (VGG16, 600x1000)",
        step=rcnn_step_updates, data=(b.pop("data"), b),
        perturb=RPN_PERTURB, reorder=True)
    return rows, k7


def rcnn_phase(mx, bnk, seed, smi):
    """Phase 19: Faster R-CNN (VGG16) at 600x1000: the RPN fit (19a), the
    end-to-end fit classic and captured (19b), detection (19c) and the
    kernels and the RPN step against the CPU (19d).  Returns (K7's
    launches, the K8/K8b rows, K7's times at Proposal's sizes)."""
    from mxnet_tpu_torch.models import rcnn
    from mxnet_tpu_torch.ops import contrib, nms_kernel
    from mxnet_tpu_torch.ops import roi_pool_kernel as rk

    t0 = time.perf_counter()
    rpn_fit_phase(mx, rcnn, nms_kernel, rk, seed, smi)
    t1 = time.perf_counter()
    mod, batches, fit_counts, _times = e2e_fit_phase(mx, rcnn, nms_kernel,
                                                     rk, seed, smi)
    t2 = time.perf_counter()
    tmod, tbatch, det_counts, _det_ms = detection_test_phase(
        mx, rcnn, nms_kernel, rk, mod, seed, smi)
    t3 = time.perf_counter()
    launches = (fit_counts[1] + det_counts[1], fit_counts[2])
    rows, k7 = rcnn_checks_phase(mx, bnk, rcnn, contrib, nms_kernel, rk,
                                 mod, batches, tmod, tbatch, launches, smi,
                                 seed)
    del mod, tmod
    torch.cuda.empty_cache()
    print("phase 19 %.1f s: RPN fit %.1f, end-to-end fits %.1f, detection "
          "%.1f, checks %.1f" % (time.perf_counter() - t0, t1 - t0, t2 - t1,
                                 t3 - t2, time.perf_counter() - t3),
          flush=True)
    return fit_counts[0] + det_counts[0], rows, k7


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
    inc_configs = inception_bn_configs(mx, TRAIN_BATCH)
    if sum(inc_configs.values()) != INCEPTION_BNS:
        raise RuntimeError("Inception-v3 has %d BatchNorms, expected %d"
                           % (sum(inc_configs.values()), INCEPTION_BNS))
    _inc_rows, inc_totals = bn_kernel_phase(
        bnk, dev, args.seed, inc_configs, eps=INCEPTION_EPS,
        net="Inception-v3")
    lstm_rows = lstm_kernel_phase(rk, dev, args.seed)
    launches = serving_phase(mx, att, dev, args.seed)
    lm_k3, lm_k3b = lm_training_phase(mx, att, args.seed)
    lm_parity_phase(mx, att, args.seed)
    (k1_launches, k2_launches), classic = training_phase(
        mx, bnk, args.seed, TRAIN_STEPS, bn_totals)
    sync_free = sync_free_phase(mx, bnk, args.seed, TRAIN_STEPS, classic)
    checkpoint_phase(mx, bnk, args.seed, TRAIN_STEPS, sync_free)
    parity_phase(mx, bnk, args.seed)
    inception = inception_phase(mx, bnk, args.seed, TRAIN_STEPS)
    parity_phase(mx, bnk, args.seed, _inception_module, "Inception-v3",
                 INCEPTION_IMAGE, (-1, 1))
    lstm_fused = {}
    lstm_launches = lstm_training_phase(mx, rk, args.seed, keep=lstm_fused)
    lstm_parity_phase(mx, args.seed)
    mnist_phase(mx, args.seed)
    decode = decode_phase(mx, args.seed)
    fleet_phase(mx, args.seed, decode.pop("reuse"))
    toolkit = rnn_toolkit_phase(mx, rk, args.seed, smi, lstm_fused)
    k7_row, classic_bn = detection_phase(mx, bnk, args.seed, smi)
    rcnn_k7, roi_rows, k7_proposal = rcnn_phase(mx, bnk, args.seed, smi)

    main_row = rows[(4, True)]  # the bucket-4 dispatch's shape
    source = "mxnet_tpu_torch/csrc/batch_norm.cu"
    # K3's launches: serving's dispatches and the LM fit and score; K3b's:
    # the LM fit (its time at the training step's shape, B=4 causal)
    # the BatchNorm rows: times summed over the 51 BatchNorms of one b128
    # ResNet-50 step, and under "inception_v3" over the 94 of one b128
    # Inception-v3 step; launches over the four fits of the main path
    # (ResNet-50 and Inception-v3, classic and sync-free) and phase 18c's
    # BatchNorm networks (VGG-16-BN, Inception-BN, Inception-ResNet-v2)
    inc_launches = [sum(inception[run]["launches"][i]
                        for run in ("classic", "sync_free"))
                    for i in (0, 1)]
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
                    launches=k1_launches + sync_free["launches"][0]
                    + inc_launches[0] + classic_bn[0], **bn_totals["fwd"],
                    inception_v3=dict(inc_totals["fwd"],
                                      launches=inc_launches[0])),
               dict(name="batch_norm_bwd", route="cuda", source=source,
                    replaces="mxnet_tpu/ops/bn_pallas.py:110",
                    launches=k2_launches + sync_free["launches"][1]
                    + inc_launches[1] + classic_bn[1], **bn_totals["bwd"],
                    inception_v3=dict(inc_totals["bwd"],
                                      launches=inc_launches[1]))]
    # the LSTM rows: times at T=60, N=32, H=200 (the default bucket);
    # launches over phase 9's fit (K4 in its score pass), phase 17b's
    # fused score (K4) and phase 17c's dropout fit (K5, K6)
    t_max = max(LSTM_BUCKETS)
    for (kid, kname, line), n in zip(
            (("K4", "lstm_infer", 126), ("K5", "lstm_fwd", 56),
             ("K6", "lstm_bwd", 82)),
            [a + b for a, b in zip(lstm_launches, toolkit)]):
        kernels.append(dict(
            name=kname, route="cuda", source="mxnet_tpu_torch/csrc/lstm.cu",
            replaces="mxnet_tpu/ops/rnn_pallas.py:%d" % line, launches=n,
            **lstm_rows[(kid, t_max)]))
    # K7: launches over phase 18b's two detection passes and phase 19's
    # Proposal calls (19b's fits, 19c's passes), times at SSD300 b32 (A =
    # 7308) on that batch's own inputs, and at Proposal's own inputs
    k7_row["launches"] += rcnn_k7
    k7_row["proposal"] = k7_proposal
    kernels.append(k7_row)
    # K8/K8b: launches over 19b's fits (and 19c's passes for K8), times at
    # 19b's own map, ROIs and gradient (R = 2000, C = 512, 37x62)
    kernels.extend(roi_rows)
    print(json.dumps({"kernels": kernels}))
    print("nvidia-smi: %s" % smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
