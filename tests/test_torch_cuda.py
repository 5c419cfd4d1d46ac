"""Tests of the PyTorch port that need an NVIDIA card (marker ``cuda``).

They import neither JAX nor ``mxnet_tpu``, so they also run on a machine
that has only PyTorch; there, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a card each test skips inside the ``cuda_device`` fixture.  Each
kernel is held against its plain version with TF32 off for the plain
version (K3 keeps f32 accuracy on the tensor cores with three TF32
products per product); the sums run in another order, hence
``rtol=atol=1e-4`` for flash attention (K3),
for BatchNorm (K1/K2) a max error of ``1e-4`` relative to the largest
magnitude of each output (its per-channel sums span up to 6.4 M terms),
and for the LSTM kernels ``1e-5`` (K4/K5) and ``1e-4`` (K6) of each
output's largest magnitude (the error compounds over up to 60 steps).
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import bn_kernel
from mxnet_tpu_torch.ops import rnn_kernel


@pytest.fixture
def cuda_device():
    """The card; decided here, never at import, so every worker collects
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _qkv(b, h, lq, lk, d, seed, device):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.normal(0, 1, (b, h, n, d)).astype(np.float32))
            .to(device) for n in (lq, lk, lk)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk,d", [
    (128, 128, 128), (100, 70, 64), (48, 48, 20), (64, 200, 128),
    # one below and one above K3's tiles (128 query rows, 64 keys), Lq !=
    # Lk, head dims that fill part of an 8-wide step, D % 4 != 0 (the
    # 4-byte copy path)
    (127, 63, 128), (129, 65, 64), (128, 129, 20), (65, 200, 33),
    (200, 65, 33), (1, 1, 128)])
def test_kernel_matches_plain(cuda_device, causal, lq, lk, d):
    q, k, v = _qkv(2, 3, lq, lk, d, 5, cuda_device)
    before = tatt.flash_attention_cuda.launches
    out, lse = tatt.flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tatt.flash_attention_cuda.launches == before + 1
    pout, plse = tatt.flash_attention_plain(q, k, v, causal, 1 / np.sqrt(d))
    torch.testing.assert_close(out, pout, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("length,d,offset", [(96, 32, 0), (150, 33, 0),
                                             (150, 32, 1), (150, 128, 0)])
def test_kernel_reads_strided_heads(cuda_device, length, d, offset):
    """(B, L, H, D) -> (B, H, L, D) views, as MultiHeadAttention passes
    them: the kernel reads the strides, no copy.  Rows that are not
    16-byte aligned (D = 33, or a view starting one float in) take the
    4-byte copies, aligned ones the 16-byte copies."""
    rs = np.random.RandomState(2)
    x = [torch.from_numpy(rs.normal(0, 1, (2, length, 4, d + offset))
                          .astype(np.float32)).to(cuda_device)
         [..., offset:].transpose(1, 2) for _ in range(3)]
    for causal in (True, False):
        out, lse = tatt.flash_attention_cuda(*x, causal, 0.2)
        pout, plse = tatt.flash_attention_plain(*x, causal, 0.2)
        torch.testing.assert_close(out, pout, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_beyond_one_wave(cuda_device, causal):
    """More CTAs than SMs (3 x 50 heads x 3 Q tiles = 450), so the
    heaviest-first order wraps over several waves; the output repeats
    bit for bit."""
    q, k, v = _qkv(3, 50, 257, 257, 64, 9, cuda_device)
    out, lse = tatt.flash_attention_cuda(q, k, v, causal, 0.125)
    torch.cuda.synchronize()
    pout, plse = tatt.flash_attention_plain(q, k, v, causal, 0.125)
    torch.testing.assert_close(out, pout, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
    again, _ = tatt.flash_attention_cuda(q, k, v, causal, 0.125)
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 1, 8, 160), device=cuda_device)
    with pytest.raises(mx.MXNetError, match="head_dim"):
        tatt.flash_attention(q, q, q)
    h = torch.zeros((1, 1, 8, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(mx.MXNetError, match="float32"):
        tatt.flash_attention(h, h, h)


@pytest.mark.cuda
def test_served_lm_on_card_launches_once_per_dispatch(cuda_device, tmp_path):
    """A tiny build_lm served on the card (the default context) matches the
    same model served on the CPU, and each dispatch launches K3 once."""
    from mxnet_tpu_torch.models import build_lm

    net = build_lm(50, 64, 2, 40)
    shapes, _, _ = net.infer_shape(data=(1, 40))
    rs = np.random.RandomState(0)
    params = {n: rs.normal(0, 0.1, s).astype(np.float32)
              for n, s in zip(net.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    mx.serving.save_model(str(tmp_path), net, mx.nd.save_bytes(params),
                          (40,), buckets=(1, 4))
    x = rs.randint(0, 50, (3, 40)).astype(np.float32)
    cpu_reg = mx.serving.ModelRegistry(ctx=mx.cpu())
    want = cpu_reg.load_dir(str(tmp_path)).predict(x)
    cpu_reg.close()
    reg = mx.serving.ModelRegistry()
    try:
        model = reg.load_dir(str(tmp_path))
        before = tatt.flash_attention_cuda.launches
        got = model.predict(x)
        assert tatt.flash_attention_cuda.launches == before + 1
    finally:
        reg.close()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def _k3b_inputs(b, h, lq, lk, d, seed, device, offset=0):
    """q, k, v as (B, L, H, D) -> (B, H, L, D) views (``offset`` floats
    into each row: 4-byte copies when not 16-byte aligned), the forward's
    out and lse from K3, do as the strided view MultiHeadAttention's
    backward hands over, and a dlse."""
    rs = np.random.RandomState(seed)

    def view(n):
        t = rs.normal(0, 1, (b, n, h, d + offset)).astype(np.float32)
        return torch.from_numpy(t).to(device)[..., offset:].transpose(1, 2)

    q, k, v = view(lq), view(lk), view(lk)
    do = view(lq)
    dlse = torch.from_numpy(rs.normal(0, 1, (b, h, lq)).astype(np.float32)) \
        .to(device)
    return q, k, v, do, dlse


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("lq,lk,d,offset", [
    (256, 256, 128, 0), (200, 200, 64, 0), (100, 70, 16, 0),
    # around K3b's tiles (128 keys a dK/dV CTA, 32 rows a stage; 128 query
    # rows a dQ CTA, 32 keys a stage), Lq != Lk both ways, a head dim off
    # the 4-wide copies (D = 30) and rows one float off 16-byte alignment
    (127, 129, 128, 0), (129, 33, 64, 0), (31, 257, 16, 0),
    (150, 150, 30, 0), (150, 97, 64, 1), (1, 1, 128, 0)])
def test_k3b_matches_plain(cuda_device, causal, with_dlse, lq, lk, d,
                           offset):
    """K3b against its plain version on the same inputs, each of dq, dk,
    dv within ``1e-4`` of its largest magnitude (3xTF32 against f32 sums
    in another order), on strided head views; the gradients take the
    strides of q, k and v."""
    q, k, v, do, dlse = _k3b_inputs(2, 3, lq, lk, d, lq + lk + d,
                                    cuda_device, offset)
    scale = 1 / np.sqrt(d)
    out, lse = tatt.flash_attention_cuda(q, k, v, causal, scale)
    dlse = dlse if with_dlse else None
    before = tatt.flash_attention_bwd_cuda.launches
    got = tatt.flash_attention_bwd_cuda(q, k, v, out, lse, do, dlse,
                                        causal, scale)
    torch.cuda.synchronize()
    assert tatt.flash_attention_bwd_cuda.launches == before + 1
    want = tatt.flash_attention_bwd_plain(q, k, v, out, lse, do, dlse,
                                          causal, scale)
    for name, g, w, src in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        if offset == 0:  # a dense view: empty_like keeps its strides
            assert g.stride() == src.stride(), name
        _assert_close_scaled(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_k3b_repeats_bit_for_bit(cuda_device, causal):
    """No atomics: two launches on the same inputs give the same bits,
    over several waves of CTAs (3 x 20 heads x 3 tiles)."""
    q, k, v, do, dlse = _k3b_inputs(3, 20, 300, 300, 64, 4, cuda_device)
    out, lse = tatt.flash_attention_cuda(q, k, v, causal, 0.125)
    one = tatt.flash_attention_bwd_cuda(q, k, v, out, lse, do, dlse, causal,
                                        0.125)
    two = tatt.flash_attention_bwd_cuda(q, k, v, out, lse, do, dlse, causal,
                                        0.125)
    torch.cuda.synchronize()
    for a, b in zip(one, two):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,lq,lk,d", [
    # one head group on 132 SMs (the balanced grid at B=1), and 1024 work
    # items, many times the persistent grid
    (1, 8, 2048, 2048, 128), (8, 16, 512, 512, 64)])
def test_k3b_repeats_bit_for_bit_on_the_persistent_grid(cuda_device, causal,
                                                        b, h, lq, lk, d):
    """dq's key tiles are summed in a fixed order whichever CTA takes
    them: two launches agree bit for bit, and both agree with the plain
    version."""
    q, k, v, do, dlse = _k3b_inputs(b, h, lq, lk, d, 17, cuda_device)
    scale = d ** -0.5
    out, lse = tatt.flash_attention_cuda(q, k, v, causal, scale)
    one = tatt.flash_attention_bwd_cuda(q, k, v, out, lse, do, dlse, causal,
                                        scale)
    two = tatt.flash_attention_bwd_cuda(q, k, v, out, lse, do, dlse, causal,
                                        scale)
    torch.cuda.synchronize()
    for a, c in zip(one, two):
        assert torch.equal(a, c)
    want = tatt.flash_attention_bwd_plain(q, k, v, out, lse, do, dlse,
                                          causal, scale)
    for g, w in zip(one, want):
        _assert_close_scaled(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,d,offset", [
    # ragged both ways under the causal mask, past one key tile (64) and
    # one query stage (32): key tiles that see no query write zeros
    (1337, 1901, 128, 0), (1901, 1337, 128, 0), (95, 300, 64, 0),
    # odd head dims take the 4-byte copies and the scalar dq adds
    (300, 300, 72, 1), (300, 300, 5, 0), (77, 131, 72, 0)])
def test_k3b_ragged_causal_and_odd_head_dims(cuda_device, lq, lk, d,
                                             offset):
    q, k, v, do, dlse = _k3b_inputs(2, 3, lq, lk, d, lq + d, cuda_device,
                                    offset)
    scale = d ** -0.5
    out, lse = tatt.flash_attention_cuda(q, k, v, True, scale)
    got = tatt.flash_attention_bwd_cuda(q, k, v, out, lse, do, dlse, True,
                                        scale)
    again = tatt.flash_attention_bwd_cuda(q, k, v, out, lse, do, dlse, True,
                                          scale)
    torch.cuda.synchronize()
    want = tatt.flash_attention_bwd_plain(q, k, v, out, lse, do, dlse, True,
                                          scale)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        _assert_close_scaled(g, w)


@pytest.mark.cuda
def test_k3b_same_bits_on_two_streams(cuda_device):
    """No floating-point atomics: the same inputs launched at once on two
    streams (their CTAs sharing the card) give the same bits."""
    q, k, v, do, dlse = _k3b_inputs(2, 8, 1024, 1024, 128, 23, cuda_device)
    out, lse = tatt.flash_attention_cuda(q, k, v, True, 0.1)
    torch.cuda.synchronize()
    results = []
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    for st in streams:
        with torch.cuda.stream(st):
            results.append(tatt.flash_attention_bwd_cuda(
                q, k, v, out, lse, do, dlse, True, 0.1))
    torch.cuda.synchronize()
    for a, c in zip(*results):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_autograd_through_the_kernels_matches_plain(cuda_device):
    """``flash_attention_with_lse`` under autograd on the card: K3 forward
    and K3b backward, once each, against the plain pair on the same
    tensors, with cotangents for both out and lse."""
    q, k, v, do, dlse = _k3b_inputs(2, 4, 96, 96, 32, 8, cuda_device)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    f0 = tatt.flash_attention_cuda.launches
    b0 = tatt.flash_attention_bwd_cuda.launches
    out, lse = tatt.flash_attention_with_lse(*leaves, causal=True)
    got = torch.autograd.grad((out, lse), leaves, (do, dlse))
    torch.cuda.synchronize()
    assert tatt.flash_attention_cuda.launches == f0 + 1
    assert tatt.flash_attention_bwd_cuda.launches == b0 + 1
    pout, plse = tatt.flash_attention_plain(q, k, v, True, 32 ** -0.5)
    want = tatt.flash_attention_bwd_plain(q, k, v, pout, plse, do, dlse,
                                          True, 32 ** -0.5)
    for g, w in zip(got, want):
        _assert_close_scaled(g, w)


@pytest.mark.cuda
def test_k3b_wrapper_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 1, 8, 64), device=cuda_device)
    lse = torch.zeros((1, 1, 8), device=cuda_device)
    with pytest.raises(mx.MXNetError, match="do must be"):
        tatt.flash_attention_bwd_cuda(q, q, q, q, lse, q[:, :, :4], None,
                                      True, 0.1)
    with pytest.raises(mx.MXNetError, match="lse must be"):
        tatt.flash_attention_bwd_cuda(q, q, q, q, lse.double(), q, None,
                                      True, 0.1)
    with pytest.raises(mx.MXNetError, match="head_dim"):
        big = torch.zeros((1, 1, 8, 160), device=cuda_device)
        tatt.flash_attention_bwd_cuda(big, big, big, big, lse, big, None,
                                      True, 0.1)


def _assert_close_scaled(got, want, tol=1e-4):
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,fix_gamma,relu,offset", [
    ((128, 3, 224, 224), True, False, 120.0),   # bn_data: 3 huge channels
    ((128, 2048, 7, 7), False, True, 0.0),      # the last BN
    ((16, 64, 13, 11), False, True, 0.0),       # odd spatial
    ((6, 40, 5), True, True, 1.0),              # fix_gamma + ReLU, 3D
    ((9, 7), False, False, 0.0),                # 2D
    # one shape per plan of the resident path (bn_plan): a 56x56 channel
    # on 8-CTA (K1) and 16-CTA (K2) clusters, 28x28 on 2 and 4, one CTA a
    # channel at 14x14 and 7x7 (4-byte copies), several channels a CTA
    ((128, 4, 56, 56), False, True, 0.0),
    ((128, 4, 28, 28), False, True, 0.0),
    ((128, 16, 14, 14), False, True, 0.0),
    ((128, 64, 7, 7), False, True, 0.0),
    ((8, 2112, 4, 4), False, True, 0.0),
    ((8, 2112, 3, 3), True, False, 0.0),
    # one strip too large for 16 CTAs: K1 on 9-CTA clusters and K2
    # chunked, then both chunked
    ((129, 4, 56, 56), False, True, 0.0),
    ((257, 2, 56, 56), False, True, 0.0),
    # Inception-v3's odd spatial sizes at N = 128 (fix_gamma, ReLU fused):
    # 35x35 on 4-CTA (K1) and 7-CTA (K2) clusters of 4-byte copies, 71x71
    # and 73x73 on 13- and 15-CTA clusters (K1; K2 chunked), 149x149
    # chunked in both
    ((128, 4, 35, 35), True, True, 0.0),
    ((128, 3, 71, 71), True, True, 0.0),
    ((128, 3, 73, 73), True, True, 0.0),
    ((128, 2, 149, 149), True, True, 0.0),
])
def test_bn_kernels_match_plain(cuda_device, shape, fix_gamma, relu, offset):
    rs = np.random.RandomState(4)
    x = torch.from_numpy((rs.standard_normal(shape) * 50 + offset)
                         .astype(np.float32)).to(cuda_device)
    c = shape[1]
    gamma = torch.from_numpy(rs.uniform(0.5, 1.5, c).astype(np.float32)) \
        .to(cuda_device)
    beta = torch.from_numpy(rs.normal(0, 1, c).astype(np.float32)) \
        .to(cuda_device)
    g = torch.from_numpy(rs.standard_normal(shape).astype(np.float32)) \
        .to(cuda_device)
    before = (bn_kernel.bn_fwd_cuda.launches, bn_kernel.bn_bwd_cuda.launches)
    y, mean, var = bn_kernel.bn_fwd_cuda(x, gamma, beta, 1e-3, fix_gamma,
                                         relu)
    torch.cuda.synchronize()
    py, pmean, pvar = bn_kernel.bn_fwd_plain(x, gamma, beta, 1e-3,
                                             fix_gamma, relu)
    for got, want in ((y, py), (mean, pmean), (var, pvar)):
        _assert_close_scaled(got, want)
    # the same saved stats into both backwards: the ReLU masks agree
    dx, dg, db = bn_kernel.bn_bwd_cuda(x, g, mean, var, gamma, beta, 1e-3,
                                       fix_gamma, relu)
    torch.cuda.synchronize()
    pdx, pdg, pdb = bn_kernel.bn_bwd_plain(x, g, mean, var, gamma, beta,
                                           1e-3, fix_gamma, relu)
    for got, want in ((dx, pdx), (dg, pdg), (db, pdb)):
        _assert_close_scaled(got, want)
    assert (bn_kernel.bn_fwd_cuda.launches,
            bn_kernel.bn_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    # deterministic: no atomics in the statistics or the sums
    y2, mean2, var2 = bn_kernel.bn_fwd_cuda(x, gamma, beta, 1e-3, fix_gamma,
                                            relu)
    assert torch.equal(y, y2) and torch.equal(mean, mean2) \
        and torch.equal(var, var2)
    dx2, dg2, db2 = bn_kernel.bn_bwd_cuda(x, g, mean, var, gamma, beta, 1e-3,
                                          fix_gamma, relu)
    assert torch.equal(dx, dx2) and torch.equal(dg, dg2) \
        and torch.equal(db, db2)


@pytest.mark.cuda
def test_bn_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros((4, 3, 5, 5), device=cuda_device)
    vec = torch.ones(3, device=cuda_device)
    with pytest.raises(mx.MXNetError, match="float32"):
        bn_kernel.bn_fwd_cuda(x.to(torch.bfloat16), vec, vec, 1e-3, False)
    with pytest.raises(mx.MXNetError, match="cpu"):
        bn_kernel.bn_fwd_cuda(x, vec.cpu(), vec, 1e-3, False)
    with pytest.raises(mx.MXNetError, match="contiguous"):
        bn_kernel.bn_fwd_cuda(x.transpose(2, 3), vec, vec, 1e-3, False)
    with pytest.raises(mx.MXNetError, match="contiguous"):
        bn_kernel.bn_bwd_cuda(x, x.transpose(2, 3), vec, vec, vec, vec,
                              1e-3, False)
    # the size limits live in the kernel source, which sizes the work space
    lib = _kernels.load("batch_norm")
    with pytest.raises(mx.MXNetError, match="does not take"):
        bn_kernel._work(lib, x, 1, 70000, 1, bwd=False)
    with pytest.raises(mx.MXNetError, match="does not take"):
        bn_kernel._work(lib, x, 2 ** 16, 1, 2 ** 15, bwd=True)
    # the resident path needs none; the chunked path 2 floats per (channel,
    # 4096-element chunk), then 2 (K1) or 3 (K2) per channel
    assert bn_kernel._work(lib, x, 4, 3, 25, bwd=True).numel() == 0
    chunks = 128 * 50176 // 4096
    assert bn_kernel._work(lib, x, 128, 3, 50176, bwd=False).numel() \
        == 3 * chunks * 2 + 3 * 2
    assert bn_kernel._work(lib, x, 128, 3, 50176, bwd=True).numel() \
        == 3 * chunks * 2 + 3 * 3


#: the 13 BatchNorm inputs of the ResNet-50 b128 step as (N, C, S)
_RESNET50_BN = [(128, 3, 224 * 224), (128, 64, 112 * 112)] + [
    (128, c, s * s) for s, cs in ((56, (64, 128, 256)), (28, (128, 256, 512)),
                                  (14, (256, 512, 1024)), (7, (512, 2048)))
    for c in cs]


@pytest.mark.cuda
def test_bn_plan(cuda_device):
    """The resident path takes every BatchNorm of the ResNet-50 step but
    bn_data and bn0, on the clusters the kernel source's note gives, and
    the card holds at least one cluster of every plan."""
    want = {224 * 224: (None, None), 112 * 112: (None, None),
            56 * 56: (8, 16), 28 * 28: (2, 4), 14 * 14: (1, 1),
            7 * 7: (1, 1)}
    for n, c, s in _RESNET50_BN:
        for bwd in (False, True):
            plan = bn_kernel.bn_plan(n, c, s, bwd, cuda_device)
            k = want[s][bwd]
            assert plan["path"] == ("chunked" if k is None else "resident"), \
                (n, c, s, bwd, plan)
            if k is not None:
                assert plan["ctas_per_cluster"] == k, (n, c, s, bwd, plan)
                assert plan["strips_per_cta"] == n // k
                assert plan["clusters"] * plan["channels_per_cta"] >= c
                assert plan["smem_bytes"] <= 200 * 1024
            assert plan["clusters"] > 0 and plan["active_clusters"] > 0, \
                (n, c, s, bwd, plan)
    # the test shapes of test_bn_kernels_match_plain reach the other plans
    assert bn_kernel.bn_plan(129, 4, 3136, False, cuda_device)[
        "ctas_per_cluster"] == 9
    assert bn_kernel.bn_plan(129, 4, 3136, True, cuda_device)["path"] \
        == "chunked"
    assert bn_kernel.bn_plan(257, 2, 3136, False, cuda_device)["path"] \
        == "chunked"
    small = bn_kernel.bn_plan(8, 2112, 16, True, cuda_device)
    assert small["path"] == "resident" and small["channels_per_cta"] > 1


#: Inception-v3's BatchNorm spatial sizes at N = 128 and the clusters
#: (K1, K2) their plans take (None: the chunked path)
_INCEPTION_PLANS = {149: (None, None), 147: (None, None), 73: (15, None),
                    71: (13, None), 35: (4, 7), 17: (1, 2), 8: (1, 1)}


@pytest.mark.cuda
def test_bn_plan_inception(cuda_device):
    """Every BatchNorm spatial size of the Inception-v3 b128 step takes
    the path and the cluster its strip size gives (at most 200 KiB a CTA,
    at most 16 CTAs a cluster), and the card holds at least one cluster
    of each, the 13- and 15-CTA clusters of 187-196 KB CTAs included."""
    for side, want in _INCEPTION_PLANS.items():
        for bwd in (False, True):
            plan = bn_kernel.bn_plan(128, 64, side * side, bwd, cuda_device)
            k = want[bwd]
            assert plan["path"] == ("chunked" if k is None else "resident"), \
                (side, bwd, plan)
            if k is not None:
                assert plan["ctas_per_cluster"] == k, (side, bwd, plan)
                assert plan["strips_per_cta"] == -(-128 // k)
                assert plan["smem_bytes"] <= 200 * 1024
            assert plan["active_clusters"] > 0, (side, bwd, plan)


def _resnet50_step(net, ctx, x, y):
    """One fit step from seeded Xavier weights: ({name: update}, aux)."""
    it = mx.io.NDArrayIter(x, y, batch_size=x.shape[0])
    mod = mx.mod.Module(net, context=ctx)
    mod.bind(it.provide_data, it.provide_label)
    mx.init.seed(1)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    before = mx.convert.module_params_to_numpy(mod)[0]
    bn_kernel.bn_fwd_cuda.launches = bn_kernel.bn_bwd_cuda.launches = 0
    mod.fit(it, num_epoch=1, optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    launches = (bn_kernel.bn_fwd_cuda.launches,
                bn_kernel.bn_bwd_cuda.launches)
    arg, aux = mx.convert.module_params_to_numpy(mod)
    return {k: arg[k] - before[k] for k in arg}, aux, launches


@pytest.mark.cuda
def test_resnet50_step_launches_k1_and_k2_51_times(cuda_device):
    """One Module step of full-width ResNet-50 (batch 8) on the card: the
    graph has 51 BatchNorms (50 feeding only a ReLU, fused), each one K1
    and one K2 launch; the step matches the same step on the CPU.

    The first step of a random ResNet-50 is ill-conditioned: an input
    perturbed by 1e-7 relative moves the CPU's own updates by 1-2%.  So
    each parameter's update on the card is held to within 3x the largest
    distance of the CPU's updates on three perturbed inputs, and the
    moving statistics, a forward quantity, to ``rtol=1e-4, atol=1e-5``."""
    net = mx.models.get_symbol("resnet", num_classes=1000, num_layers=50,
                               image_shape="3,224,224")
    rs = np.random.RandomState(0)
    x = rs.uniform(0, 255, (8, 3, 224, 224)).astype(np.float32)
    y = rs.randint(0, 1000, 8).astype(np.float32)
    gu, gaux, glaunch = _resnet50_step(net, mx.gpu(0), x, y)
    cu, caux, claunch = _resnet50_step(net, mx.cpu(), x, y)
    assert glaunch == (51, 51) and claunch == (0, 0)

    def dists(a, b):
        return np.array([np.linalg.norm(a[k] - b[k]) for k in sorted(cu)])

    floor = np.max([dists(_resnet50_step(net, mx.cpu(), (x * (
        1 + 1e-7 * rs.standard_normal(x.shape))).astype(np.float32), y)[0],
        cu) for _ in range(3)], axis=0)
    ratio = dists(gu, cu) / np.maximum(floor, 1e-30)
    assert ratio.max() <= 3, (sorted(cu)[int(ratio.argmax())], ratio.max())
    for k in caux:
        np.testing.assert_allclose(gaux[k], caux[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


# -- LSTM kernels K4, K5, K6 --------------------------------------------------
def _assert_rel(got, want, tol):
    """Max error within ``tol`` of the largest magnitude of ``want``."""
    top = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol * (top if top > 0 else 1.0), (err, top)


def _lstm_inputs(T, N, H, seed, device):
    rs = np.random.RandomState(seed)

    def draw(shape, scale):
        return torch.from_numpy((rs.standard_normal(shape) * scale)
                                .astype(np.float32)).to(device)

    return (draw((T, 4, N, H), 0.5), draw((4, H, H), 1 / np.sqrt(H)),
            draw((4, H), 0.1), draw((N, H), 0.5), draw((N, H), 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,H", [
    (5, 3, 20), (7, 5, 33), (10, 32, 200), (60, 32, 200),
    # batch rows over many clusters, one row, slices so narrow that CTAs
    # idle, more row groups than clusters with w4 streaming from L2
    (6, 200, 200), (5, 1, 200), (3, 2, 9), (2, 1000, 1024)])
def test_lstm_kernels_match_plain(cuda_device, T, N, H):
    """K4, K5 and K6 against their plain versions on the same inputs:
    forward within 1e-5 and backward within 1e-4 of each output's largest
    magnitude (f32 sums in another order, compounded over T steps); K4's
    and K5's outputs and K6's dw4 and dbh repeat bit for bit."""
    xp, w4, bh, h0, c0 = _lstm_inputs(T, N, H, 3, cuda_device)
    before = (rnn_kernel.lstm_infer_cuda.launches,
              rnn_kernel.lstm_fwd_cuda.launches,
              rnn_kernel.lstm_bwd_cuda.launches)
    ys4, hT4, cT4 = rnn_kernel.lstm_infer_cuda(xp, w4, bh, h0, c0)
    fwd = rnn_kernel.lstm_fwd_cuda(xp, w4, bh, h0, c0)
    torch.cuda.synchronize()
    want = rnn_kernel.lstm_fwd_plain(xp, w4, bh, h0, c0)
    for got, ref in zip(fwd, want):
        _assert_rel(got, ref, 1e-5)
    for got, ref in zip((ys4, hT4, cT4), (want[0], want[3], want[4])):
        _assert_rel(got, ref, 1e-5)
    again = (rnn_kernel.lstm_infer_cuda(xp, w4, bh, h0, c0)
             + rnn_kernel.lstm_fwd_cuda(xp, w4, bh, h0, c0))
    for a, b in zip((ys4, hT4, cT4) + fwd, again):
        assert torch.equal(a, b)
    ys, gates, cs = fwd[:3]
    rs = np.random.RandomState(4)
    dys, dhT, dcT = [torch.from_numpy(rs.standard_normal(s).astype(
        np.float32)).to(cuda_device) for s in ((T, N, H), (N, H), (N, H))]
    got = rnn_kernel.lstm_bwd_cuda(gates, cs, ys, w4, h0, c0, dys, dhT, dcT)
    torch.cuda.synchronize()
    ref = rnn_kernel.lstm_bwd_plain(gates, cs, ys, w4, h0, c0, dys, dhT, dcT)
    for g, r in zip(got, ref):
        _assert_rel(g, r, 1e-4)
    again = rnn_kernel.lstm_bwd_cuda(gates, cs, ys, w4, h0, c0, dys, dhT,
                                     dcT)
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    assert (rnn_kernel.lstm_infer_cuda.launches,
            rnn_kernel.lstm_fwd_cuda.launches,
            rnn_kernel.lstm_bwd_cuda.launches) == (
                before[0] + 2, before[1] + 2, before[2] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,H", [(6, 200, 200), (5, 16, 512),
                                   (4, 8, 1024), (3, 2, 9)])
def test_lstm_bwd_across_clusters(cuda_device, T, N, H):
    """K6 where its batch rows span several clusters (N = 200), where a
    CTA's rows of w4 exceed its shared memory and stream from L2
    (H = 512, 1024: w4 is 4 and 16 MB), and where H < 8 slices leave CTAs
    idle (H = 9): within 1e-4 of each output's largest magnitude, and
    every output bit for bit across launches."""
    xp, w4, bh, h0, c0 = _lstm_inputs(T, N, H, 6, cuda_device)
    # the saved tensors from the plain forward: K6 is under test here
    ys, gates, cs = rnn_kernel.lstm_fwd_plain(xp, w4, bh, h0, c0)[:3]
    rs = np.random.RandomState(7)
    dys, dhT, dcT = [torch.from_numpy(rs.standard_normal(s).astype(
        np.float32)).to(cuda_device) for s in ((T, N, H), (N, H), (N, H))]
    args = (gates, cs, ys, w4, h0, c0, dys, dhT, dcT)
    got = rnn_kernel.lstm_bwd_cuda(*args)
    torch.cuda.synchronize()
    ref = rnn_kernel.lstm_bwd_plain(*args)
    for g, r in zip(got, ref):
        _assert_rel(g, r, 1e-4)
    again = rnn_kernel.lstm_bwd_cuda(*args)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_lstm_forward_plan(cuda_device):
    """K4/K5's layout: at the LM's shape every row group runs at once with
    the whole slice of w4 in shared memory; at N = 1000, H = 1024 row
    groups outnumber clusters (the kernel loops over them) and the slice
    streams from L2 past its first rows."""
    lm = rnn_kernel.lstm_fwd_plan(32, 200, cuda_device)
    assert (lm["slice"], lm["w4_rows_in_smem"]) == (25, 200)
    assert lm["rows"] * lm["clusters"] >= 32
    wide = rnn_kernel.lstm_fwd_plan(1000, 1024, cuda_device)
    assert wide["slice"] == 128 and wide["w4_rows_in_smem"] < 1024
    assert -(-1000 // wide["rows"]) > wide["clusters"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("H", [513, 1024])
def test_lstm_forward_above_512_columns(cuda_device, H):
    """K4 and K5 launch above H = 512 (a block of one thread per column
    would need more registers than an SM has) and agree with their plain
    versions within 1e-5 of each output's largest magnitude; at
    H = 1024, K6 run on K5's own outputs agrees with its plain version
    on the same inputs within 1e-4."""
    T, N = 4, 8
    xp, w4, bh, h0, c0 = _lstm_inputs(T, N, H, 8, cuda_device)
    ys4, hT4, cT4 = rnn_kernel.lstm_infer_cuda(xp, w4, bh, h0, c0)
    fwd = rnn_kernel.lstm_fwd_cuda(xp, w4, bh, h0, c0)
    torch.cuda.synchronize()
    want = rnn_kernel.lstm_fwd_plain(xp, w4, bh, h0, c0)
    for got, ref in zip(fwd, want):
        _assert_rel(got, ref, 1e-5)
    for got, ref in zip((ys4, hT4, cT4), (want[0], want[3], want[4])):
        _assert_rel(got, ref, 1e-5)
    if H != 1024:
        return
    ys, gates, cs = fwd[:3]
    rs = np.random.RandomState(9)
    grads = [torch.from_numpy(rs.standard_normal(s).astype(np.float32))
             .to(cuda_device) for s in ((T, N, H), (N, H), (N, H))]
    args = (gates, cs, ys, w4, h0, c0, *grads)
    got = rnn_kernel.lstm_bwd_cuda(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, rnn_kernel.lstm_bwd_plain(*args)):
        _assert_rel(g, r, 1e-4)


@pytest.mark.cuda
def test_lstm_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    xp, w4, bh, h0, c0 = _lstm_inputs(4, 3, 8, 0, cuda_device)
    with pytest.raises(mx.MXNetError, match="float32"):
        rnn_kernel.lstm_infer_cuda(xp.to(torch.bfloat16), w4, bh, h0, c0)
    with pytest.raises(mx.MXNetError, match="contiguous"):
        rnn_kernel.lstm_fwd_cuda(xp, w4.transpose(1, 2), bh, h0, c0)
    with pytest.raises(mx.MXNetError, match="cpu"):
        rnn_kernel.lstm_fwd_cuda(xp, w4, bh, h0.cpu(), c0)
    with pytest.raises(mx.MXNetError, match="shape"):
        rnn_kernel.lstm_infer_cuda(xp, w4, bh[:3], h0, c0)
    ys, gates, cs, _h, _c = rnn_kernel.lstm_fwd_cuda(xp, w4, bh, h0, c0)
    with pytest.raises(mx.MXNetError, match="contiguous"):
        rnn_kernel.lstm_bwd_cuda(gates, cs, ys, w4, h0, c0,
                                 ys.transpose(0, 1).contiguous()
                                 .transpose(0, 1), h0, c0)
    # the limits live in the kernel source, which sizes the work space
    lib = _kernels.load("lstm")
    # K6's dw4 product at T*N = 1920, H = 200 splits T*N in 9 chunks
    assert rnn_kernel._work(lib, 60, 32, 200, True, cuda_device).numel() \
        == 9 * 4 * 201 * 200
    assert rnn_kernel._work(lib, 60, 32, 1024, True, cuda_device).numel() \
        == 0
    assert rnn_kernel._work(lib, 60, 32, 200, False, cuda_device).numel() \
        == 0
    with pytest.raises(mx.MXNetError, match="does not take"):
        rnn_kernel._work(lib, 4, 3, 1025, False, cuda_device)
    with pytest.raises(mx.MXNetError, match="does not take"):
        rnn_kernel._work(lib, 2 ** 12, 2 ** 9, 256, True, cuda_device)


@pytest.mark.cuda
def test_bucketing_step_launches_k5_k6_per_layer_and_k4_on_eval(
        cuda_device):
    """One BucketingModule training step of a small 2-layer LSTM LM on the
    card launches K5 and K6 once per layer (2 + 2), an eval forward K4
    twice; the step and the eval output match the same on the CPU
    (``rtol=1e-4``; the atol is 1e-5 of each update's largest
    magnitude)."""
    import random

    from mxnet_tpu_torch.models import lstm_lm

    def run(ctx):
        random.seed(0)
        np.random.seed(0)
        it = mx.rnn.BucketSentenceIter(
            lstm_lm.synth_corpus(40, 50, buckets=(5, 10)), 4,
            buckets=[5, 10], invalid_label=0, layout="TN")
        mod = mx.mod.BucketingModule(
            lstm_lm.make_sym_gen(lstm_lm.build_cell(16, 2), 50, 16, 16),
            default_bucket_key=10, context=ctx)
        mod.bind(it.provide_data, it.provide_label)
        mx.init.seed(0)
        mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34))
        before = mx.convert.module_params_to_numpy(mod)[0]
        mod.init_optimizer(optimizer_params={"learning_rate": 0.5})
        batch = next(it)
        counts = [rnn_kernel.lstm_infer_cuda, rnn_kernel.lstm_fwd_cuda,
                  rnn_kernel.lstm_bwd_cuda]
        for c in counts:
            c.launches = 0
        mod.forward_backward(batch)
        mod.update()
        step = [c.launches for c in counts]
        mod.forward(batch, is_train=False)
        out = mod.get_outputs()[0].asnumpy()
        after = mx.convert.module_params_to_numpy(mod)[0]
        return ({k: after[k] - before[k] for k in after}, out, step,
                [c.launches for c in counts])

    gu, gout, gstep, gall = run(mx.gpu(0))
    cu, cout, cstep, call = run(mx.cpu())
    assert (gstep, gall) == ([0, 2, 2], [2, 2, 2])
    assert (cstep, call) == ([0, 0, 0], [0, 0, 0])
    for k in cu:
        np.testing.assert_allclose(gu[k], cu[k], rtol=1e-4,
                                   atol=1e-5 * np.abs(cu[k]).max(),
                                   err_msg=k)
    np.testing.assert_allclose(gout, cout, rtol=1e-4, atol=1e-6)


# -- the sync-free step: CUDA-graph capture and replay ------------------------
SMALL = dict(units=[1, 1], num_stages=2, filter_list=[8, 16, 32],
             num_classes=4, image_shape=(3, 40, 40), bottle_neck=True)


def _small_batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [mx.io.DataBatch(
        data=[mx.nd.array(rs.uniform(0, 255, (4, 3, 40, 40))
                          .astype(np.float32))],
        label=[mx.nd.array(rs.randint(0, 4, 4).astype(np.float32))])
        for _ in range(n)]


def _small_module(ctx, sched=None):
    from mxnet_tpu_torch.models import resnet

    mod = mx.mod.Module(resnet.resnet(**SMALL), context=ctx)
    mod.bind(data_shapes=[("data", (4, 3, 40, 40))],
             label_shapes=[("softmax_label", (4,))])
    mx.init.seed(3)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    opt = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
    if sched is not None:
        opt["lr_scheduler"] = sched
    mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    return mod


def _small_steps(monkeypatch, fused, batches, sched=None, mod=None):
    monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "1" if fused else "0")
    mod = mod or _small_module(mx.gpu(0), sched)
    bn_kernel.bn_fwd_cuda.launches = bn_kernel.bn_bwd_cuda.launches = 0
    for b in batches:
        mod.forward_backward(b)
        mod.update()
    torch.cuda.synchronize()
    launches = (bn_kernel.bn_fwd_cuda.launches,
                bn_kernel.bn_bwd_cuda.launches)
    arg, aux = mx.convert.module_params_to_numpy(mod)
    arg.update({"aux:" + k: v for k, v in aux.items()})
    return mod, arg, launches


def _assert_steps_agree(got, want):
    """The captured step against the eager one: the same kernels on the
    same tensors, so equal up to cuDNN's choice of algorithm (``1e-5``
    of each tensor's largest magnitude)."""
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=1e-5,
            atol=1e-5 * max(1.0, np.abs(want[k]).max()), err_msg=k)


@pytest.mark.cuda
def test_captured_step_equals_the_eager_step(cuda_device, monkeypatch):
    """Four fused steps (a warm-up with the capture, then three replays)
    against four eager steps from the same weights and batches; the
    replays add the K1/K2 launches they ran (9 BatchNorms a step)."""
    batches = _small_batches(4)
    mod, fused, f_launch = _small_steps(monkeypatch, True, batches)
    _m, eager, e_launch = _small_steps(monkeypatch, False, batches)
    assert mod._exec.graph_replays == 3 and len(mod._exec._graphs) == 1
    assert f_launch == e_launch == (36, 36)
    _assert_steps_agree(fused, eager)
    assert mod.get_outputs()[0].shape == (4, 4)


@pytest.mark.cuda
def test_scheduler_step_inside_replays_reaches_the_graph(cuda_device,
                                                         monkeypatch):
    """The lr drops after update 2, between two replays: the graph reads
    it from its lr tensor, so the replays follow the eager steps."""
    batches = _small_batches(4, 1)
    sched = lambda: mx.lr_scheduler.MultiFactorScheduler(  # noqa: E731
        step=[2], factor=0.1)
    mod, fused, _ = _small_steps(monkeypatch, True, batches, sched())
    _m, eager, _ = _small_steps(monkeypatch, False, batches, sched())
    (step,) = mod._exec._graphs.values()
    assert step.hyper[0].cpu().tolist() == pytest.approx([0.005])
    _assert_steps_agree(fused, eager)
    # without the drop the replays land elsewhere
    _m, flat, _ = _small_steps(monkeypatch, False, batches)
    assert not np.allclose(flat["fc1_weight"], fused["fc1_weight"],
                           rtol=1e-3, atol=1e-6)


@pytest.mark.cuda
def test_replayed_step_runs_k1_and_k2_on_the_device(cuda_device,
                                                    monkeypatch):
    """torch.profiler sees as many BatchNorm kernel executions in one
    replayed step as in one eager step."""
    from torch.profiler import ProfilerActivity, profile

    batches = _small_batches(3, 2)

    def bn_kernels(fused):
        monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "1" if fused else "0")
        mod = _small_module(mx.gpu(0))
        for b in batches[:2]:
            mod.forward_backward(b)
            mod.update()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # a few kernels first: the start of the window stays off the step
            pad = torch.zeros(1, device=cuda_device)
            for _ in range(20):
                pad.add_(1)
            torch.cuda.synchronize()
            mod.forward_backward(batches[2])
            mod.update()
            torch.cuda.synchronize()
        assert mod._exec.graph_replays == (2 if fused else 0)
        return sum(e.count for e in prof.key_averages()
                   if "bn_fwd_" in e.key or "bn_bwd_" in e.key)

    eager = bn_kernels(False)
    assert eager >= 18
    assert bn_kernels(True) == eager


@pytest.mark.cuda
def test_new_params_and_optimizer_after_capture_take_effect(cuda_device,
                                                            monkeypatch):
    """``set_params`` writes into the captured tensors; a new optimizer
    brings new momenta, and the step is captured anew rather than
    replayed into the old ones."""
    batches = _small_batches(5, 3)
    rs = np.random.RandomState(4)

    def run(fused):
        mod, _, _ = _small_steps(monkeypatch, fused, batches[:2])
        arg, aux = mod.get_params()
        mod.set_params({k: mx.nd.array(rs.normal(0, 0.05, v.shape)
                                       .astype(np.float32))
                        for k, v in sorted(arg.items())}, aux)
        _small_steps(monkeypatch, fused, batches[2:4], mod=mod)
        mod.init_optimizer(optimizer="sgd", force_init=True,
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.5})
        return _small_steps(monkeypatch, fused, batches[4:], mod=mod)

    rs.seed(4)
    mod, fused, _ = run(True)
    rs.seed(4)
    _m, eager, _ = run(False)
    assert mod._exec.graph_replays == 3  # one capture for each optimizer
    assert len(mod._exec._graphs) == 1
    _assert_steps_agree(fused, eager)


class _SlowIter(mx.io.NDArrayIter):
    """An ``NDArrayIter`` whose ``next`` first sleeps ``delay`` seconds, so
    that a prefetch producer pins and copies the next batch at a chosen
    point of the consumer's step (its warm-up and capture included)."""

    def __init__(self, *args, delay=0.0, **kw):
        super().__init__(*args, **kw)
        self.delay = delay

    def next(self):
        time.sleep(self.delay)
        return super().next()


@pytest.mark.cuda
@pytest.mark.parametrize("bulk", [None, 2])
def test_captured_fit_with_device_prefetch(cuda_device, monkeypatch, bulk):
    """``fit(prefetch_to_device=True)`` with the captured step, the
    producer's next batch arriving at several points of the warm-up and
    the capture: each fit captures once, replays every later step and
    ends where the fit without prefetch ends."""
    from mxnet_tpu_torch.models import resnet

    monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "1")
    if bulk:
        monkeypatch.setenv("MXNET_BULK_TRAIN_STEPS", str(bulk))
    rs = np.random.RandomState(5)
    x = rs.uniform(0, 255, (24, 3, 40, 40)).astype(np.float32)
    y = rs.randint(0, 4, 24).astype(np.float32)

    def fit(prefetch, delay=0.0):
        mod = mx.mod.Module(resnet.resnet(**SMALL), context=mx.gpu(0))
        mx.init.seed(3)
        mod.fit(_SlowIter(x, y, batch_size=4, delay=delay), num_epoch=2,
                prefetch_to_device=prefetch,
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                                  "wd": 1e-4},
                initializer=mx.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
        torch.cuda.synchronize()
        assert mod._exec.graph_replays == 11 and len(mod._exec._graphs) == 1
        arg, aux = mx.convert.module_params_to_numpy(mod)
        arg.update({"aux:" + k: v for k, v in aux.items()})
        return arg

    want = fit(False)
    for delay in (0.0, 0.001, 0.005, 0.02, 0.05):
        _assert_steps_agree(fit(True, delay), want)


@pytest.mark.cuda
def test_device_prefetch_iter_pins_and_copies_on_a_side_stream(cuda_device):
    x = np.arange(16 * 6, dtype=np.float32).reshape(16, 6)
    seen = []

    def placer(name, t):
        seen.append((name, t.is_pinned(), torch.cuda.current_stream(
            cuda_device)))
        return t.to(cuda_device, non_blocking=True)

    with mx.io.DevicePrefetchIter(mx.io.NDArrayIter(x, x[:, 0],
                                                    batch_size=4),
                                  mx.gpu(0), placer=placer) as it:
        batches = list(it)
        side = it._stream
    assert len(batches) == 4 and len(seen) == 8
    assert all(pinned and stream == side for _n, pinned, stream in seen)
    assert side != torch.cuda.current_stream(cuda_device)
    for i, b in enumerate(batches):
        assert b.data[0]._t.is_cuda and b.label[0]._t.is_cuda
        np.testing.assert_array_equal(b.data[0].asnumpy(), x[4 * i:4 * i + 4])


@pytest.mark.cuda
def test_device_metric_takes_host_labels_beside_card_outputs(cuda_device):
    """Labels from the host join outputs on the card; the sums stay on
    the card until the read and equal the host metric's."""
    rs = np.random.RandomState(0)
    labels = [rs.randint(0, 10, 32).astype(np.float32) for _ in range(3)]
    preds = [rs.dirichlet(np.ones(10), 32).astype(np.float32)
             for _ in range(3)]
    make = lambda: mx.metric.create(  # noqa: E731
        ["acc", mx.metric.TopKAccuracy(top_k=3), "ce"])
    dev, host = mx.metric.DeviceMetric(make()), make()
    for lab, p in zip(labels, preds):
        dev.update([mx.nd.array(lab)], [mx.nd.array(p, ctx=mx.gpu(0))])
        host.update([mx.nd.array(lab)], [mx.nd.array(p)])
    assert dev._acc.is_cuda and dev.sync_count == 0
    (dn, dv), (hn, hv) = dev.get(), host.get()
    assert dn == hn and dv[:2] == hv[:2] and dev.sync_count == 1
    np.testing.assert_allclose(dv[2], hv[2], rtol=1e-5)


@pytest.mark.cuda
def test_failed_capture_raises_and_never_runs_eagerly(cuda_device,
                                                      monkeypatch):
    """A step that reads a value back to the host cannot be captured: the
    eligible step raises instead of falling back to the eager path."""
    from mxnet_tpu_torch.ops import nn

    relu = nn._ACTS["relu"]

    def relu_read_back(x):
        if x.is_cuda:  # not in the shape inference of the bind
            return relu(x) * (1.0 + 0.0 * x.sum().item())
        return relu(x)

    monkeypatch.setitem(nn._ACTS, "relu", relu_read_back)
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(mx.sym.Activation(
        mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=8,
                              name="fc1"), act_type="relu"),
        num_hidden=3, name="fc2"), name="softmax")
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (4, 5))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "1")
    batch = mx.io.DataBatch(data=[mx.nd.array(np.ones((4, 5), np.float32))],
                            label=[mx.nd.array(np.zeros(4, np.float32))])
    mod.forward_backward(batch)
    with pytest.raises(mx.MXNetError, match="capture"):
        mod.update()
    assert mod._exec.graph_replays == 0 and not mod._exec._graphs


# -- checkpoints and resume ----------------------------------------------------
def _momenta(mod):
    return {i: s.asnumpy() for i, s in mod._updater.states.items()
            if s is not None}


@pytest.mark.cuda
def test_resumed_fused_fit_recaptures_on_loaded_momenta(cuda_device,
                                                        monkeypatch,
                                                        tmp_path):
    """Parameters and momenta loaded into a module whose step is captured:
    the parameters are copied into the bound arrays, the momenta arrive
    as new tensors (from a states file), so the next step captures anew
    and never replays the old momenta; it equals an eager step from the
    same state."""
    batches = _small_batches(6, seed=2)
    mod, _, _ = _small_steps(monkeypatch, True, batches[:3])
    assert mod._exec.graph_replays == 2
    # the state to resume: another module, two eager steps further on
    other, _, _ = _small_steps(monkeypatch, False, batches[3:5])
    states = str(tmp_path / "resume.states")
    other.save_optimizer_states(states)
    arg, aux = mx.convert.module_params_to_numpy(other)
    old = [s._t for s in mod._updater.states.values() if s is not None]
    mod.set_params(arg, aux)
    mod.load_optimizer_states(states)
    assert all(s._t.is_cuda for s in mod._updater.states.values()
               if s is not None)
    assert not any(s._t is o for s, o in zip(
        mod._updater.states.values(), old))
    np.testing.assert_array_equal(
        np.concatenate([v.ravel() for v in _momenta(mod).values()]),
        np.concatenate([v.ravel() for v in _momenta(other).values()]))
    _m, fused, _ = _small_steps(monkeypatch, True, batches[5:], mod=mod)
    assert mod._exec.graph_replays == 2  # a new capture, no replay
    (step,) = mod._exec._graphs.values()
    bound = {id(t) for t in step.bound}
    assert all(id(s._t) in bound for s in mod._updater.states.values()
               if s is not None)
    _m, eager, _ = _small_steps(monkeypatch, False, batches[5:], mod=other)
    _assert_steps_agree(fused, eager)
    _small_steps(monkeypatch, True, batches[:1], mod=mod)
    assert mod._exec.graph_replays == 3


@pytest.mark.cuda
def test_snapshot_copies_while_a_step_captures(cuda_device, monkeypatch,
                                               tmp_path):
    """``fit`` with the captured step, device prefetch and a snapshot
    every batch; a change of the weight-decay groups after batch 0 makes
    batch 1 capture anew, and the writer's copy of snapshot 0 to the
    host is held until that capture has begun, so it runs inside it.  The
    capture must survive it, and the files equal the arrays at batch 0."""
    from mxnet_tpu_torch import checkpoint as ck
    from mxnet_tpu_torch.models import resnet

    monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "1")
    monkeypatch.setenv("MXNET_CKPT_KEEP_LAST", "100")
    capturing, copied = threading.Event(), threading.Event()
    begins = []
    real_begin = torch.cuda.CUDAGraph.capture_begin
    real_to_host = ck._to_host

    def capture_begin(self, *a, **kw):
        real_begin(self, *a, **kw)
        begins.append(1)
        if len(begins) == 2:
            capturing.set()
            assert copied.wait(30), "the writer's copy did not run"

    def to_host(snap):
        if snap.nbatch == 0:
            assert capturing.wait(30), "batch 1 did not capture"
        real_to_host(snap)
        if snap.nbatch == 0:
            copied.set()

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", capture_begin)
    monkeypatch.setattr(ck, "_to_host", to_host)
    rs = np.random.RandomState(5)
    x = rs.uniform(0, 255, (24, 3, 40, 40)).astype(np.float32)
    y = rs.randint(0, 4, 24).astype(np.float32)
    mod = mx.mod.Module(resnet.resnet(**SMALL), context=mx.gpu(0))
    seen = {}

    def at_batch_end(p):
        if p.nbatch == 0:
            arg, aux = mx.convert.module_params_to_numpy(mod)
            seen.update({"arg:" + k: v for k, v in arg.items()})
            seen.update({"aux:" + k: v for k, v in aux.items()})
            seen["states"] = _momenta(mod)
            mod._optimizer.wd_mult["fc1_bias"] = 0.0  # a new group

    prefix = str(tmp_path / "ck")
    mx.init.seed(3)
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
            prefetch_to_device=True, checkpoint_prefix=prefix,
            checkpoint_every_n_batches=1, batch_end_callback=at_batch_end,
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                              "wd": 1e-4},
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2))
    assert len(begins) == 2 and copied.is_set()
    assert mod._exec.graph_replays == 4
    m = mx.model.checkpoint_manifest(prefix)
    (entry,) = [s for s in m["snapshots"] if s["nbatch"] == 0]
    saved = mx.nd.load(str(tmp_path / entry["params"]))
    assert sorted(saved) == sorted(k for k in seen if k != "states")
    for k, v in saved.items():
        np.testing.assert_array_equal(v.asnumpy(), seen[k], err_msg=k)
    with open(str(tmp_path / entry["states"]), "rb") as f:
        states = mx.optimizer.load_states(f.read())
    assert sorted(seen["states"]) == sorted(
        i for i, s in states.items() if s is not None)
    for i, v in seen["states"].items():
        np.testing.assert_array_equal(states[i].asnumpy(), v)


@pytest.mark.cuda
def test_states_from_a_cpu_pickle_land_on_the_card(cuda_device,
                                                   monkeypatch, tmp_path):
    """Optimizer states pickled from CPU arrays, through a states file and
    through a snapshot's bytes: every momentum ends on ``cuda:0`` and the
    captured step takes them."""
    import pickle

    mod = _small_module(mx.gpu(0))
    names = mod._param_names
    rs = np.random.RandomState(1)
    cpu_states = {i: mx.nd.array(rs.randn(*mod._exec.arg_dict[n].shape)
                                 .astype(np.float32), ctx=mx.cpu())
                  for i, n in enumerate(names)}
    blob = pickle.dumps(cpu_states)
    path = str(tmp_path / "cpu.states")
    with open(path, "wb") as f:
        f.write(blob)
    for load in (lambda: mod.load_optimizer_states(path),
                 lambda: mod._restore_opt_snapshot(
                     blob, {"num_update": 7, "index_update_count": {
                         str(i): 7 for i in range(len(names))}})):
        load()
        assert sorted(mod._updater.states) == list(range(len(names)))
        for i, s in mod._updater.states.items():
            assert s._t.device == cuda_device
            np.testing.assert_array_equal(s.asnumpy(),
                                          cpu_states[i].asnumpy())
    assert mod._optimizer.num_update == 7
    _small_steps(monkeypatch, True, _small_batches(2), mod=mod)
    assert mod._exec.graph_replays == 1


@pytest.mark.cuda
def test_device_metric_state_is_one_sync(cuda_device):
    rs = np.random.RandomState(0)
    make = lambda: mx.metric.create(  # noqa: E731
        ["acc", mx.metric.TopKAccuracy(top_k=3), "ce"])
    dev, host = mx.metric.DeviceMetric(make()), make()
    for _ in range(3):
        lab = rs.randint(0, 10, 32).astype(np.float32)
        p = rs.dirichlet(np.ones(10), 32).astype(np.float32)
        dev.update([mx.nd.array(lab, ctx=mx.gpu(0))],
                   [mx.nd.array(p, ctx=mx.gpu(0))])
        host.update([mx.nd.array(lab)], [mx.nd.array(p)])
    state = dev.get_state()
    assert dev.sync_count == 1
    want = host.get_state()
    for got, exp in zip(state["children"], want["children"]):
        assert got["num_inst"] == exp["num_inst"]
        assert got["sum_metric"] == pytest.approx(exp["sum_metric"],
                                                  rel=1e-5)
    json.dumps(state)


# -- LM training through K3 and K3b, with Adam --------------------------------
def _lm_iter(n=16, seq=16, vocab=50, batch=4, seed=0):
    from mxnet_tpu_torch.models import copy_task

    x, y = copy_task(n, seq, vocab, np.random.RandomState(seed))
    return mx.io.NDArrayIter(x, y, batch_size=batch,
                             label_name="softmax_label")


def _refuse_plain_attention(monkeypatch):
    """The plain attention versions raise on CUDA tensors: the card's path
    must launch K3 and K3b."""
    for name in ("flash_attention_plain", "flash_attention_bwd_plain"):
        plain = getattr(tatt, name)

        def refused(q, *args, _name=name, _plain=plain, **kw):
            if q.is_cuda:
                raise RuntimeError("%s called on the card" % _name)
            return _plain(q, *args, **kw)

        monkeypatch.setattr(tatt, name, refused)


@pytest.mark.cuda
def test_lm_fit_launches_k3_and_k3b_once_a_step(cuda_device, monkeypatch):
    """A tiny ``build_lm`` through ``Module.fit`` with Adam on the card:
    one K3 and one K3b launch per training step, one K3 per ``score``
    batch, no plain attention; finite parameters and perplexities."""
    from mxnet_tpu_torch.models import build_lm

    _refuse_plain_attention(monkeypatch)
    it = _lm_iter()
    mod = mx.mod.Module(build_lm(50, 32, 2, 16))
    mx.init.seed(0)
    tatt.flash_attention_cuda.launches = 0
    tatt.flash_attention_bwd_cuda.launches = 0
    mod.fit(it, num_epoch=2, optimizer="adam",
            optimizer_params={"learning_rate": 1e-2},
            eval_metric=mx.metric.Perplexity(ignore_label=None))
    torch.cuda.synchronize()
    assert tatt.flash_attention_cuda.launches == 8
    assert tatt.flash_attention_bwd_cuda.launches == 8
    (_, ppl), = mod.score(it, mx.metric.Perplexity(ignore_label=None))
    assert tatt.flash_attention_cuda.launches == 12
    assert tatt.flash_attention_bwd_cuda.launches == 8
    assert np.isfinite(ppl)
    for i, (mean, var) in mod._updater.states.items():
        assert mean._t.device == cuda_device and var._t.device == cuda_device
    arg, _ = mod.get_params()
    assert all(torch.isfinite(a._t).all() for a in arg.values())


@pytest.mark.cuda
def test_adam_checkpoint_reloads_onto_the_card(cuda_device, tmp_path):
    """An Adam checkpoint (tuple states) reloaded with ``Module.load``:
    the moments land on the card, equal to the saved ones, and the next
    step runs there, through K3 and K3b."""
    from mxnet_tpu_torch.models import build_lm

    it = _lm_iter()
    mod = mx.mod.Module(build_lm(50, 32, 2, 16))
    mx.init.seed(1)
    mod.fit(it, num_epoch=1, optimizer="adam",
            optimizer_params={"learning_rate": 1e-2})
    prefix = str(tmp_path / "lm")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    saved = {i: (m.asnumpy(), v.asnumpy())
             for i, (m, v) in mod._updater.states.items()}
    other = mx.mod.Module.load(prefix, 1, load_optimizer_states=True)
    other.bind(it.provide_data, it.provide_label)
    other.init_optimizer(optimizer="adam",
                         optimizer_params={"learning_rate": 1e-2})
    assert sorted(other._updater.states) == sorted(saved)
    for i, (mean, var) in other._updater.states.items():
        assert mean._t.device == cuda_device and var._t.device == cuda_device
        np.testing.assert_array_equal(mean.asnumpy(), saved[i][0])
        np.testing.assert_array_equal(var.asnumpy(), saved[i][1])
    it.reset()
    batch = next(iter(it))
    k3b = tatt.flash_attention_bwd_cuda.launches
    other.forward_backward(batch)
    other.update()
    torch.cuda.synchronize()
    assert tatt.flash_attention_bwd_cuda.launches == k3b + 1
    for i, (mean, var) in other._updater.states.items():
        assert mean._t.device == cuda_device
        assert not np.array_equal(var.asnumpy(), saved[i][1])


@pytest.mark.cuda
def test_inception_v3_step_launches_k1_and_k2_94_times(cuda_device):
    """One Module step of full-width Inception-v3 (batch 8, 3x299x299) on
    the card: 94 BatchNorms, each fix_gamma with a ReLU fused, each one K1
    and one K2 launch; the step matches the CPU's within 3x the floor of
    three perturbed CPU steps, the moving statistics at ``rtol=1e-4,
    atol=1e-5`` (as the ResNet-50 step)."""
    net = mx.models.get_symbol("inception-v3", num_classes=1000)
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (8, 3, 299, 299)).astype(np.float32)
    y = rs.randint(0, 1000, 8).astype(np.float32)
    gu, gaux, glaunch = _resnet50_step(net, mx.gpu(0), x, y)
    cu, caux, claunch = _resnet50_step(net, mx.cpu(), x, y)
    assert glaunch == (94, 94) and claunch == (0, 0)

    def dists(a, b):
        return np.array([np.linalg.norm(a[k] - b[k]) for k in sorted(cu)])

    floor = np.max([dists(_resnet50_step(net, mx.cpu(), (x * (
        1 + 1e-7 * rs.standard_normal(x.shape))).astype(np.float32), y)[0],
        cu) for _ in range(3)], axis=0)
    ratio = dists(gu, cu) / np.maximum(floor, 1e-30)
    assert ratio.max() <= 3, (sorted(cu)[int(ratio.argmax())], ratio.max())
    for k in caux:
        np.testing.assert_allclose(gaux[k], caux[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


# -- the decode tier (transformer_lm, DecodeEngine, the pool) ----------------
def _decode_cfg():
    from mxnet_tpu_torch.models import transformer_lm as tlm

    cfg = tlm.LMConfig(64, 32, 4, 2, 64, 64, eos_id=64)
    return tlm, cfg, tlm.init_params(cfg, seed=3)


def _greedy_ref(tlm, cfg, params, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        lg = tlm.forward_logits(cfg, params, np.array([toks]))
        toks.append(int(lg[0, -1].argmax()))
    return toks[len(prompt):]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_engine_on_the_card(cuda_device, layout):
    """A tiny engine on cuda:0: its state lives there, greedy decode is
    the argmax of the teacher-forced forward on the card, and a
    temperature stream is the same in both layouts (the hash's bits are
    the device's)."""
    from mxnet_tpu_torch.serving import DecodeEngine

    tlm, cfg, params = _decode_cfg()
    eng = DecodeEngine(cfg, params, slots=4, prefill_buckets=(8, 16),
                       kv_layout=layout, kv_block_size=4)
    try:
        assert all(t.device == cuda_device for t in eng.state_tensors())
        prompts = [[5, 7, 9, 2], [1, 2, 3, 4, 5, 6], [9] * 11]
        sess = [eng.submit(p, max_new_tokens=10) for p in prompts]
        hot = eng.submit([3, 1, 4, 1, 5], max_new_tokens=12,
                         temperature=0.9, seed=77)
        got = [s.result(60) for s in sess]
        pdev = tlm.params_to(params, cuda_device)
        for p, g in zip(prompts, got):
            assert g == _greedy_ref(tlm, cfg, pdev, p, 10)
        other = DecodeEngine(cfg, params, slots=2, prefill_buckets=(8,),
                             kv_layout="dense" if layout == "paged"
                             else "paged", kv_block_size=4)
        try:
            twin = other.generate([3, 1, 4, 1, 5], max_new_tokens=12,
                                  temperature=0.9, seed=77, timeout=60)
        finally:
            other.close()
        assert hot.result(60) == twin
    finally:
        eng.close()


@pytest.mark.cuda
def test_sampling_hash_bits_equal_on_card_and_cpu(cuda_device):
    from mxnet_tpu_torch.serving.decode import gumbel_noise, sample_bits

    rs = np.random.RandomState(0)
    seeds = torch.from_numpy(rs.randint(0, 1 << 32, 64, dtype=np.int64))
    pos = torch.from_numpy(rs.randint(0, 1 << 20, 64))
    vidx = torch.arange(50257)
    cpu = sample_bits(seeds, pos, vidx)
    card = sample_bits(seeds.to(cuda_device), pos.to(cuda_device),
                       vidx.to(cuda_device)).cpu()
    assert torch.equal(cpu, card)
    g_cpu = gumbel_noise(seeds, pos, vidx)
    g_card = gumbel_noise(seeds.to(cuda_device), pos.to(cuda_device),
                          vidx.to(cuda_device)).cpu()
    assert (g_cpu - g_card).abs().max().item() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_step_reads_the_host_once(cuda_device, layout):
    """A profiled window of decode steps holds one device-to-host copy
    and one stream synchronisation per step, and nothing else syncs."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.serving import DecodeEngine

    tlm, cfg, params = _decode_cfg()
    eng = DecodeEngine(cfg, params, slots=4, prefill_buckets=(8,),
                       kv_layout=layout, kv_block_size=4, autostart=False)
    try:
        for i in range(4):
            eng.submit([1 + i, 2, 3], max_new_tokens=40,
                       temperature=0.5 * (i % 2), seed=i)
        eng._running = True
        state = eng._tick(eng._boot_state)      # the admissions + a step
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                state = eng._tick(state)
        evs = prof.events()
        d2h = sum(1 for e in evs if e.device_type.name == "CUDA"
                  and "memcpy dtoh" in e.name.lower())
        syncs = sum(1 for e in evs if e.device_type.name == "CPU"
                    and e.name == "cudaStreamSynchronize")
        assert eng.steps == 11
        assert d2h == 10 and syncs == 10
    finally:
        eng._running = False
        eng.close(drain=False)


@pytest.mark.cuda
def test_decode_engine_for_an_absent_card_raises(cuda_device):
    from mxnet_tpu_torch.serving import DecodeEngine, lm_pool

    tlm, cfg, params = _decode_cfg()
    absent = "cuda:%d" % torch.cuda.device_count()
    with pytest.raises(mx.MXNetError, match="CUDA"):
        DecodeEngine(cfg, params, slots=2, prefill_buckets=(8,),
                     device=absent)
    with pytest.raises(mx.MXNetError, match="CUDA"):
        lm_pool(cfg, params, n_replicas=1, devices=[absent])


@pytest.mark.cuda
def test_pool_failover_on_the_card(cuda_device):
    """Two replicas on cuda:0; one's step raises: its sessions continue
    on the other, equal to an uninterrupted pool's streams."""
    from mxnet_tpu_torch.serving import lm_pool

    tlm, cfg, params = _decode_cfg()
    opts = {"slots": 4, "prefill_buckets": (8, 16)}
    ref = lm_pool(cfg, params, n_replicas=2, engine_opts=opts)
    try:
        want = [ref.generate([1, 2, 3, i], max_new_tokens=16, seed=i,
                             temperature=0.7 * (i % 2)).result(60)
                for i in range(6)]
    finally:
        ref.close()
    pool = lm_pool(cfg, params, n_replicas=2, engine_opts=opts,
                   quarantine_after=1)
    try:
        eng = pool.replicas[1].engine
        base = eng._step_fn

        def boom(*a):
            if eng.steps == 3:
                raise RuntimeError("injected")
            return base(*a)

        eng._step_fn = boom
        sess = [pool.generate([1, 2, 3, i], max_new_tokens=16, seed=i,
                              temperature=0.7 * (i % 2)) for i in range(6)]
        got = [s.result(60) for s in sess]
        assert got == want
        assert sum(s.migrations for s in sess) >= 1
    finally:
        pool.close()


# -- the fleet control plane over the decode tier -----------------------------
def _fleet(pool, devices, **kw):
    from mxnet_tpu_torch.serving import (DeviceFleet, FleetController,
                                         ModelRegistry)

    reg = ModelRegistry()
    reg.register("lm", pool)
    ctl = FleetController(reg, fleet=DeviceFleet(devices, per_device=3),
                          **kw)
    return reg, ctl


def _wait_for(cond, what, timeout=120):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, what()
        time.sleep(0.01)


@pytest.mark.cuda
def test_controller_replaces_a_killed_replica_on_the_card(cuda_device):
    """``serving.replica.kill`` on cuda:0: the killed engine releases its
    cache before the controller removes it, the sessions finish on the
    survivor with an uninterrupted pool's streams, and the replacement is
    built on cuda:0, serves, and leaves the allocated memory where two
    replicas had it."""
    from mxnet_tpu_torch import faults
    from mxnet_tpu_torch.serving import lm_pool

    tlm, cfg, params = _decode_cfg()
    opts = {"slots": 4, "prefill_buckets": (8, 16)}
    reqs = [([1, 2, 3, i], dict(max_new_tokens=16, seed=i,
                                temperature=0.7 * (i % 2)))
            for i in range(6)]
    ref = lm_pool(cfg, params, n_replicas=2, engine_opts=opts)
    try:
        want = [ref.generate(p, **kw).result(60) for p, kw in reqs]
    finally:
        ref.close()
    pool = lm_pool(cfg, params, n_replicas=2, engine_opts=opts)
    reg, ctl = _fleet(pool, [cuda_device], interval_ms=30,
                      backoff_base=0.01)
    ctl.start()
    try:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda_device)
        sess = [pool.generate(p, **kw) for p, kw in reqs]
        # armed once every session is routed (three a replica): the fifth
        # step from here kills one replica with its three sessions
        faults.arm("serving.replica.kill", at=5)
        assert [s.result(60) for s in sess] == want
        faults.disarm()
        assert sum(s.migrations for s in sess) == 3
        _wait_for(lambda: any(d["action"] == "restart"
                              for d in ctl.decisions()), ctl.describe)
        live = [r for r in pool.replicas
                if r.state == "active" and not r.dead]
        assert len(live) == 2 and live[-1].rid == 2
        new = live[-1]
        assert new.device == cuda_device
        assert all(t.device == cuda_device
                   for t in new.engine.state_tensors())
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(cuda_device) <= before * 1.02
        got = [pool.generate(p, **kw) for p, kw in reqs]
        assert [s.result(60) for s in got] == want
        assert new.engine.tokens_out > 0
    finally:
        faults.disarm()
        ctl.close()
        reg.close()


@pytest.mark.cuda
def test_add_replica_is_warmed_before_routing_on_the_card(cuda_device):
    """The new engine runs every prefill bucket and the step before the
    pool publishes it: a request sent once the engine is built and warm,
    but before ``add_replica`` returns, still goes to the old replica;
    the warm event precedes the ``replica_add`` event."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving import lm_pool

    tlm, cfg, params = _decode_cfg()
    pool = lm_pool(cfg, params, n_replicas=1,
                   engine_opts={"slots": 4, "prefill_buckets": (8, 16)})
    telemetry.reset()
    telemetry.enable()
    base, early = pool._factory, []

    def factory(device, rid):
        eng = base(device, rid)
        early.append(pool.generate([2, 3, 4], max_new_tokens=2))
        return eng

    pool._factory = factory
    try:
        assert pool.add_replica(device="cuda:0") == 1
        assert early[0].result(60)
        assert [r.routed for r in pool.replicas] == [1, 0]
        ev = [(e["event"], e.get("replica"))
              for e in telemetry.events_recent(5000)
              if e["event"] in ("serving.decode.warm",
                                "serving.pool.replica_add")]
        assert ev.index(("serving.decode.warm", "1")) \
            < ev.index(("serving.pool.replica_add", "1"))
        # two at once: the second goes to the new replica
        two = [pool.generate([5, 7, 9, 2], max_new_tokens=6)
               for _ in range(2)]
        pdev = tlm.params_to(params, cuda_device)
        want = _greedy_ref(tlm, cfg, pdev, [5, 7, 9, 2], 6)
        assert [s.result(60) for s in two] == [want, want]
        assert [r.routed for r in pool.replicas] == [2, 1]
        assert pool.replicas[1].engine.tokens_out == 6
    finally:
        telemetry.disable()
        telemetry.reset()
        pool.close()


@pytest.mark.cuda
def test_controller_moves_a_replica_between_two_cards(cuda_device):
    """A rebalancing move adds a replica on the emptier card and drains
    the busier one by migration.  It needs two cards; a second device is
    never faked on one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("a rebalancing move needs two CUDA devices; this "
                    "machine has %d" % torch.cuda.device_count())
    from mxnet_tpu_torch.serving import lm_pool

    tlm, cfg, params = _decode_cfg()
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    opts = {"slots": 4, "prefill_buckets": (8, 16)}
    pool = lm_pool(cfg, params, n_replicas=2, devices=[d0, d0],
                   engine_opts=opts)
    reg, ctl = _fleet(pool, [d0, d1], interval_ms=10_000,
                      rebalance_every_s=0.0)
    try:
        want = [pool.generate([1, 2, 3, i], max_new_tokens=8,
                              seed=i).result(60) for i in range(4)]
        sess = [pool.generate([1, 2, 3, i], max_new_tokens=8, seed=i)
                for i in range(4)]
        ctl.tick(1.0)
        assert [s.result(60) for s in sess] == want
        assert any(d["action"] == "rebalance" for d in ctl.decisions())
        assert sorted(str(r.device) for r in pool.replicas) \
            == ["cuda:0", "cuda:1"]
        moved = [r for r in pool.replicas if r.device == d1][0]
        assert all(t.device == d1 for t in moved.engine.state_tensors())
        assert ctl.describe()["fleet"]["loads"] == [1, 1]
    finally:
        ctl.close()
        reg.close()


# -- the rest of the RNN toolkit: dropout, unfused cells ----------------------
@pytest.mark.cuda
def test_rnn_op_dropout_on_the_card(cuda_device):
    """The ``RNN`` op in training at p=0.5 (3 LSTM layers, 100,000 units a
    layer input): K5 and K6 launch once per layer; the output equals the
    layers run one at a time through K5 with ``nn.dropout`` of each later
    layer's input drawn in the same order from the card's generator;
    each mask keeps 0.5 +- 0.01; kept elements are
    ``x / keep`` bit for bit and dropped ones 0; the second layer's input
    weights get no gradient from dropped units; inference is the op at
    p=0 (K4)."""
    t_, n_, nin, nh, layers, p = 50, 40, 8, 50, 3, 0.5
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.normal(0, 0.5, (t_, n_, nin)).astype(
        np.float32)).to(cuda_device)
    size = mx.ops.rnn.rnn_param_size(nin, nh, layers, "lstm")
    params = torch.from_numpy(rs.normal(0, 0.1, size).astype(
        np.float32)).to(cuda_device).requires_grad_(True)
    zeros = torch.zeros(layers, n_, nh, device=cuda_device)
    op = mx.ops.get("RNN")

    def attrs(p_, n_layers=layers):
        return op.canonicalize_attrs(dict(state_size=nh, num_layers=n_layers,
                                          mode="lstm", p=p_))

    gen = mx.random.generator(cuda_device)
    state = gen.get_state()
    rnn_kernel.lstm_fwd_cuda.launches = rnn_kernel.lstm_bwd_cuda.launches = 0
    got = op.apply(attrs(p), [x, params, zeros, zeros], [], True)[0]
    got.sum().backward()
    torch.cuda.synchronize()
    assert (rnn_kernel.lstm_fwd_cuda.launches,
            rnn_kernel.lstm_bwd_cuda.launches) == (layers, layers)
    gen.set_state(state)
    slices = mx.ops.rnn._layer_param_slices(nin, nh, layers, "lstm", False)
    cur, masks = x, []
    with torch.no_grad():
        p_leaf = params.detach().requires_grad_(True)
    for layer, _d, sl in slices:
        if layer > 0:
            dropped = mx.ops.nn.dropout(cur, p)
            keep = dropped != 0
            masks.append(keep)
            assert torch.equal(dropped[keep], cur[keep] / 0.5)
            cur = dropped
        blob = torch.cat([p_leaf[o:o + int(np.prod(s))] for o, s in (
            sl[k] for k in ("wx", "wh", "bx", "bh"))])
        cur = op.apply(attrs(0.0, 1), [cur, blob, zeros[:1], zeros[:1]],
                       [], True)[0]
    # the same masks: equal up to cuBLAS's choice of product for the
    # blob's other alignment
    torch.testing.assert_close(got, cur, rtol=1e-6, atol=1e-7)
    for keep in masks:
        assert keep.numel() == 100000
        assert abs(float(keep.float().mean()) - 0.5) < 0.01
    # one step of one row: a dropped unit's column gets no gradient
    one = torch.from_numpy(rs.normal(0, 1, (1, 1, nin)).astype(
        np.float32)).to(cuda_device)
    small = torch.from_numpy(rs.normal(0, 0.3, mx.ops.rnn.rnn_param_size(
        nin, 64, 2, "lstm")).astype(np.float32)).to(
        cuda_device).requires_grad_(True)
    z2 = torch.zeros(2, 1, 64, device=cuda_device)
    a2 = op.canonicalize_attrs(dict(state_size=64, num_layers=2,
                                    mode="lstm", p=p))
    state = gen.get_state()
    op.apply(a2, [one, small, z2, z2], [], True)[0].sum().backward()
    gen.set_state(state)
    kept = (torch.rand((1, 1, 64), generator=gen, device=cuda_device)
            < 0.5).reshape(-1)
    off, shape = mx.ops.rnn._layer_param_slices(nin, 64, 2, "lstm",
                                                False)[1][2]["wx"]
    gwx = small.grad[off:off + shape[0] * shape[1]].reshape(shape)
    assert 10 < int(kept.sum()) < 54
    assert torch.all(gwx[:, ~kept] == 0)
    assert torch.all(gwx[:, kept].abs().sum(0) > 0)
    with torch.no_grad():
        infer = op.apply(attrs(p), [x, params, zeros, zeros], [], False)[0]
        plain = op.apply(attrs(0.0), [x, params, zeros, zeros], [], False)[0]
    torch.testing.assert_close(infer, plain, rtol=0, atol=0)


def _lm_step(ctx, cell, layout, params, ids, seed=0):
    """One SGD step of the small LSTM LM on ``ctx`` from ``params``
    (``ids`` time-major): {name: update}."""
    from mxnet_tpu_torch.models import lstm_lm

    data = ids if layout == "TNC" else np.ascontiguousarray(ids.T)
    label = np.concatenate([ids[1:], np.zeros_like(ids[:1])])
    label = label if layout == "TNC" else np.ascontiguousarray(label.T)
    mod = mx.mod.BucketingModule(
        lstm_lm.make_sym_gen(cell, 50, 16, 16, layout=layout),
        default_bucket_key=ids.shape[0], context=ctx)
    mod.bind([("data", data.shape)], [("softmax_label", data.shape)])
    mod.init_params(mx.init.Zero())
    mx.convert.set_module_params(mod, params, {})
    mod.init_optimizer(optimizer_params={"learning_rate": 0.5})
    mx.random.seed(seed)
    mod.forward_backward(mx.io.DataBatch(
        [mx.nd.array(data)], [mx.nd.array(label)], bucket_key=ids.shape[0],
        provide_data=[mx.io.DataDesc("data", data.shape)],
        provide_label=[mx.io.DataDesc("softmax_label", data.shape)]))
    mod.update()
    after = mx.convert.module_params_to_numpy(mod)[0]
    return {k: after[k] - params[k] for k in params}


@pytest.mark.cuda
def test_unfused_step_matches_the_fused_step(cuda_device):
    """One step of ``lstm_bucketing.py``'s unfused stack (no kernel
    launched) against the fused cell's step through K5/K6, from the same
    weights carried with ``unpack_weights``, both in TNC (``Module``
    takes the batch size, and so ``rescale_grad``, from the data's first
    axis): each update within 1e-4 of its norm."""
    from mxnet_tpu_torch.models import lstm_lm

    rs = np.random.RandomState(4)
    ids = rs.randint(1, 50, (10, 8)).astype(np.float32)
    cell = lstm_lm.build_cell(16, 2)
    size = mx.ops.rnn.rnn_param_size(16, 16, 2, "lstm")
    fused = {"embed_weight": rs.normal(0, 0.3, (50, 16)),
             "lstm_parameters": rs.normal(0, 0.3, size),
             "pred_weight": rs.normal(0, 0.3, (50, 16)),
             "pred_bias": np.zeros(50)}
    fused = {k: v.astype(np.float32) for k, v in fused.items()}
    unfused = {k: v.asnumpy() if hasattr(v, "asnumpy") else v
               for k, v in cell.unpack_weights(fused).items()}
    counts = [rnn_kernel.lstm_infer_cuda, rnn_kernel.lstm_fwd_cuda,
              rnn_kernel.lstm_bwd_cuda]
    for c in counts:
        c.launches = 0
    gu = _lm_step(mx.gpu(0), lstm_lm.build_stack(16, 2), "TNC", unfused, ids)
    assert [c.launches for c in counts] == [0, 0, 0]
    fu = _lm_step(mx.gpu(0), lstm_lm.build_cell(16, 2), "TNC", fused, ids)
    assert [c.launches for c in counts] == [0, 2, 2]
    fu = {k: v.asnumpy() if hasattr(v, "asnumpy") else v
          for k, v in cell.unpack_weights(fu).items()}
    assert sorted(fu) == sorted(gu)
    for k in gu:
        norm = np.linalg.norm(fu[k])
        assert norm > 0, k
        assert np.linalg.norm(gu[k] - fu[k]) <= 1e-4 * norm, k


@pytest.mark.cuda
def test_captured_step_draws_a_fresh_dropout_mask_each_replay(
        cuda_device, monkeypatch):
    """A fused (captured) step of a graph with ``Dropout`` at lr 0: the
    warm-up and two replays see the same weights and batch, so their
    outputs differ only through the masks, and they all differ; the
    generator's state moves with each replay.  The same seed replays the
    same three masks."""
    monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "1")
    rs = np.random.RandomState(0)
    batch = mx.io.DataBatch([mx.nd.array(rs.normal(0, 1, (8, 32)).astype(
        np.float32))], [mx.nd.array(rs.randint(0, 4, 8).astype(np.float32))])

    def run():
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(mx.sym.Dropout(
            mx.sym.Variable("data"), p=0.5), num_hidden=4, name="fc"),
            name="softmax")
        mod = mx.mod.Module(net, context=mx.gpu(0))
        mod.bind([("data", (8, 32))], [("softmax_label", (8,))])
        mx.init.seed(1)
        mod.init_params(mx.init.Xavier())
        mod.init_optimizer(optimizer_params={"learning_rate": 0.0})
        mx.random.seed(5)
        outs, states = [], []
        for _ in range(3):
            mod.forward_backward(batch)
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
            states.append(mx.random.get_state()["op_generators"]["cuda:0"])
        assert mod._exec.graph_replays == 2
        return outs, states

    outs, states = run()
    assert not np.array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[1], outs[2])
    assert states[0] != states[1] != states[2]
    again, again_states = run()
    for a, b in zip(outs, again):
        np.testing.assert_array_equal(a, b)
    assert again_states == states


def _dropout_mlp_module(lr, seed=1):
    """A Dropout MLP on the card with Xavier weights from ``seed``."""
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(mx.sym.Dropout(
        mx.sym.Activation(mx.sym.FullyConnected(
            mx.sym.Variable("data"), num_hidden=64, name="fc1"),
            act_type="relu"), p=0.5), num_hidden=4, name="fc2"),
        name="softmax")
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind([("data", (8, 32))], [("softmax_label", (8,))])
    mx.init.seed(seed)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": lr,
                                         "momentum": 0.9})
    return mod


def _dropout_batches(n):
    rs = np.random.RandomState(0)
    return [mx.io.DataBatch(
        [mx.nd.array(rs.normal(0, 1, (8, 32)).astype(np.float32))],
        [mx.nd.array(rs.randint(0, 4, 8).astype(np.float32))])
        for _ in range(n)]


def _dropout_steps(mod, batches):
    """Outputs and parameters after each step."""
    outs, params = [], []
    for b in batches:
        mod.forward_backward(b)
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
        params.append({k: v.asnumpy()
                       for k, v in mod.get_params()[0].items()})
    return outs, params


@pytest.mark.cuda
@pytest.mark.parametrize("lr", [0.0, 0.1])
def test_captured_step_draws_the_masks_of_an_eager_step(cuda_device,
                                                        monkeypatch, lr):
    """Four steps of a Dropout MLP from seed 5, captured
    (``MXNET_FUSE_TRAIN_STEP=1``: a warm-up, then three replays) against
    four eager two-phase steps: at lr 0 the outputs, which differ only
    through the masks, are equal bit for bit; at lr 0.1 the outputs and
    updates agree within 1e-6 of their largest magnitude (the two paths
    run the same SGD arithmetic in other kernels)."""
    batches = _dropout_batches(4)
    runs = {}
    for fuse in ("1", "0"):
        monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", fuse)
        mod = _dropout_mlp_module(lr)
        mx.random.seed(5)
        runs[fuse] = _dropout_steps(mod, batches)
        assert mod._exec.graph_replays == (3 if fuse == "1" else 0)
    (c_out, c_par), (e_out, e_par) = runs["1"], runs["0"]
    for step in range(4):
        if lr == 0.0:
            np.testing.assert_array_equal(c_out[step], e_out[step])
            continue
        scale = np.abs(e_out[step]).max()
        assert np.abs(c_out[step] - e_out[step]).max() <= 1e-6 * scale
        for k, v in e_par[step].items():
            assert np.abs(c_par[step][k] - v).max() <= \
                1e-6 * np.abs(v).max(), (step, k)


@pytest.mark.cuda
def test_resumed_captured_fit_draws_the_uninterrupted_masks(cuda_device,
                                                            monkeypatch):
    """A captured Dropout fit at lr 0 (the masks alone move the outputs):
    six steps uninterrupted, against three steps, then ``get_state`` ->
    ``seed(123)`` -> ``set_state`` and a new module whose three steps are
    a new warm-up and two replays of a new capture.  The last three
    outputs are equal bit for bit."""
    monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "1")
    batches = _dropout_batches(6)
    mx.random.seed(5)
    whole, _ = _dropout_steps(_dropout_mlp_module(0.0), batches)
    mx.random.seed(5)
    mod = _dropout_mlp_module(0.0)
    _dropout_steps(mod, batches[:3])
    state = json.loads(json.dumps(mx.random.get_state()))
    mx.random.seed(123)
    mx.random.set_state(state)
    mod = _dropout_mlp_module(0.0)
    resumed, _ = _dropout_steps(mod, batches[3:])
    assert mod._exec.graph_replays == 2
    for a, b in zip(resumed, whole[3:]):
        np.testing.assert_array_equal(a, b)


# -- SSD (BASELINE #4): K7, the captured step; Inception-BN through K1/K2 ----
def _nms_case(b, a, seed, classes=21, invalid=0.1, quantized=False):
    """Random corner boxes, class ids (a share invalid) and a stable visit
    order by score on the card; ``quantized`` snaps coordinates to a
    1/8 grid and scores to tenths, so IoUs hit thresholds exactly and
    scores tie."""
    rs = np.random.RandomState(seed)
    xy = rs.rand(b, a, 2) * 0.8
    wh = rs.rand(b, a, 2) * 0.3 + 0.02
    if quantized:
        xy, wh = np.round(xy * 8) / 8, np.round(wh * 8) / 8 + 0.125
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    cls = rs.randint(0, classes, (b, a)).astype(np.float32)
    cls[rs.rand(b, a) < invalid] = -1.0
    score = rs.rand(b, a).astype(np.float32)
    if quantized:
        score = np.round(score, 1).astype(np.float32)
    score[cls < 0] = -np.inf
    order = np.argsort(-score, axis=1, kind="stable")
    dev = torch.device("cuda", 0)
    return (torch.from_numpy(boxes).to(dev), torch.from_numpy(cls).to(dev),
            torch.from_numpy(order).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("force", [True, False])
@pytest.mark.parametrize("thresh", [0.45, 0.5])
def test_k7_matches_plain_at_ssd300_b32(cuda_device, force, thresh):
    """K7 at SSD300's shape (b32, 7308 boxes an image, 20 classes and a
    tenth invalid): the keep mask equals the plain loop's, one launch."""
    from mxnet_tpu_torch.ops import nms_kernel

    boxes, cls, order = _nms_case(32, 7308, 1)
    before = nms_kernel.greedy_nms_cuda.launches
    keep = nms_kernel.greedy_nms(boxes, cls, order, thresh, force)
    torch.cuda.synchronize()
    assert nms_kernel.greedy_nms_cuda.launches == before + 1
    want = nms_kernel.greedy_nms_plain(boxes, cls, order, thresh, force)
    assert torch.equal(keep, want)
    assert 0 < int(keep.sum()) < keep.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("a", [1, 2, 1023, 1025, 3000])
@pytest.mark.parametrize("force", [True, False])
def test_k7_on_ties(cuda_device, a, force):
    """Boxes on a 1/8 grid (IoUs exactly at the 0.5 threshold, repeated
    boxes at IoU 1), tied scores in index order, invalid boxes, fewer
    boxes than threads and more: K7 keeps what the plain loop keeps, bit
    for bit across two launches."""
    from mxnet_tpu_torch.ops import nms_kernel

    boxes, cls, order = _nms_case(3, a, a, classes=3, invalid=0.2,
                                  quantized=True)
    if a > 1:
        boxes[:, 1] = boxes[:, 0]
        cls[:, 1] = cls[:, 0]
    keep = nms_kernel.greedy_nms_cuda(boxes, cls, order, 0.5, force)
    again = nms_kernel.greedy_nms_cuda(boxes, cls, order, 0.5, force)
    want = nms_kernel.greedy_nms_plain(boxes, cls, order, 0.5, force)
    assert torch.equal(keep, want) and torch.equal(keep, again)


def _k7_equal(boxes, cls, order, force, thresh=0.5):
    """K7 (one counted call of its two kernels) against the plain loop,
    bit for bit; returns the keep mask."""
    from mxnet_tpu_torch.ops import nms_kernel

    before = nms_kernel.greedy_nms_cuda.launches
    keep = nms_kernel.greedy_nms_cuda(boxes, cls, order, thresh, force)
    torch.cuda.synchronize()
    assert nms_kernel.greedy_nms_cuda.launches == before + 1
    want = nms_kernel.greedy_nms_plain(boxes, cls, order, thresh, force)
    assert torch.equal(keep, want)
    return keep


@pytest.mark.cuda
@pytest.mark.parametrize("a", [63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("force", [True, False])
def test_k7_at_chunk_edges(cuda_device, a, force):
    """Box counts around K7's 64-position mask words: boxes on a 1/8 grid
    (IoUs exactly at the threshold, tied scores), a box repeated exactly
    (IoU 1), a fifth invalid at the tail."""
    boxes, cls, order = _nms_case(4, a, a, classes=3, invalid=0.2,
                                  quantized=True)
    boxes[:, 1] = boxes[:, 0]
    cls[:, 1] = cls[:, 0]
    keep = _k7_equal(boxes, cls, order, force)
    assert not keep.all()


@pytest.mark.cuda
@pytest.mark.parametrize("force", [True, False])
def test_k7_on_invalid_images_and_prefixes(cuda_device, force):
    """An image with no valid box, and images whose valid prefix of the
    visit order ends inside a chunk, inside a scan tile (512 positions)
    and on a chunk edge, 700 boxes crossing a tile edge; plus boxes
    invalid amid the valid ones."""
    boxes, cls, order = _nms_case(5, 700, 3, classes=4, invalid=0.0,
                                  quantized=True)
    pos = torch.empty_like(order).scatter_(
        1, order, torch.arange(700, device=order.device).expand(5, 700))
    cls[0] = -1.0
    for b, n in ((1, 100), (2, 300), (3, 448)):
        cls[b][pos[b] >= n] = -1.0
    cls[4][pos[4] % 7 == 3] = -1.0
    keep = _k7_equal(boxes, cls, order, force)
    assert keep[0].all()
    for b, n in ((1, 100), (2, 300), (3, 448)):
        assert keep[b][pos[b] >= n].all() and not keep[b].all()


@pytest.mark.cuda
@pytest.mark.parametrize("a", [6000, 12000])
def test_k7_at_proposal_sizes(cuda_device, a):
    """rcnn's ``_contrib_Proposal`` calls greedy NMS over its pre-NMS top
    6000 (inference) or 12000 (training) boxes: one image, ``force``, the
    visit order ``arange(A)``."""
    boxes, cls, _order = _nms_case(1, a, a, classes=1, invalid=0.0)
    order = torch.arange(a, device=boxes.device)[None]
    keep = _k7_equal(boxes, cls, order, True, thresh=0.7)
    assert 0 < int(keep.sum()) < a


@pytest.mark.cuda
def test_k7_above_the_old_shared_memory_cap(cuda_device):
    """26,000 boxes an image, above the 9 bytes a box of shared memory the
    one-block-an-image kernel needed (~25,800 on an H100): taken, equal
    to the plain loop, and two launches give equal masks."""
    from mxnet_tpu_torch.ops import nms_kernel

    boxes, cls, order = _nms_case(1, 26000, 4, classes=20, invalid=0.05)
    keep = _k7_equal(boxes, cls, order, False)
    again = nms_kernel.greedy_nms_cuda(boxes, cls, order, 0.5, False)
    assert torch.equal(keep, again)


@pytest.mark.cuda
@pytest.mark.parametrize("force", [True, False])
def test_k7_on_degenerate_boxes(cuda_device, force):
    """Boxes of zero area, inverted on one side or both, and of an area
    past float32's range, amid ordinary ones: the tiles that hold them
    take the mask pass's division on every pair, and K7 keeps what the
    plain loop keeps."""
    boxes, cls, order = _nms_case(2, 300, 9, classes=3, invalid=0.1,
                                  quantized=True)
    rs = np.random.RandomState(9)
    for b in range(2):
        pick = torch.from_numpy(rs.choice(300, 40, replace=False))
        kind = pick % 4
        x = boxes[b, pick]
        x[kind == 0, 2] = x[kind == 0, 0]                      # zero width
        x[kind == 1, 2] = x[kind == 1, 0] - 0.125              # one side
        x[kind == 2] = x[kind == 2][:, [2, 3, 0, 1]]           # both sides
        x[kind == 3] = x[kind == 3] * 1e30                     # area inf
        boxes[b, pick] = x
    _k7_equal(boxes, cls, order, force)


@pytest.mark.cuda
def test_k7_parts_and_workspace(cuda_device):
    """The mask pass and the scan launched apart, over one workspace,
    give the counted call's mask; neither counts a launch."""
    from mxnet_tpu_torch.ops import nms_kernel

    boxes, cls, order = _nms_case(3, 1000, 5, classes=5)
    want = nms_kernel.greedy_nms_cuda(boxes, cls, order, 0.45, False)
    before = nms_kernel.greedy_nms_cuda.launches
    _keep, work = nms_kernel.launch_parts(boxes, cls, order, 0.45, False,
                                          parts=nms_kernel.MASK)
    assert work.numel() * 8 == nms_kernel.workspace_bytes(3, 1000)
    keep, _work = nms_kernel.launch_parts(boxes, cls, order, 0.45, False,
                                          parts=nms_kernel.SCAN, work=work)
    torch.cuda.synchronize()
    assert torch.equal(keep.bool(), want)
    assert nms_kernel.greedy_nms_cuda.launches == before


def _ssd_run(lr, fuse, monkeypatch, steps=3):
    """``steps`` SSD steps (3 classes, 96x96, b2) on the card from one
    seed: (outputs a step, parameters after each step, replays)."""
    from mxnet_tpu_torch.models import ssd_vgg16

    monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", fuse)
    x, y = ssd_vgg16.synth_detection_set(2 * steps, 96, 3)
    mod = mx.mod.Module(ssd_vgg16.get_symbol_train(num_classes=3),
                        label_names=("label",), context=mx.gpu(0))
    mod.bind([("data", (2, 3, 96, 96))], [("label", (2, 3, 5))])
    mx.init.seed(1)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": lr,
                                         "momentum": 0.9, "wd": 5e-4})
    outs, params = [], []
    for i in range(steps):
        mod.forward_backward(mx.io.DataBatch(
            [mx.nd.array(x[2 * i:2 * i + 2])],
            [mx.nd.array(y[2 * i:2 * i + 2])]))
        mod.update()
        outs.append([o.asnumpy() for o in mod.get_outputs()])
        params.append({k: v.asnumpy()
                       for k, v in mod.get_params()[0].items()})
    return outs, params, mod._exec.graph_replays


@pytest.mark.cuda
@pytest.mark.parametrize("lr", [0.0, 0.002])
def test_captured_ssd_step_matches_an_eager_one(cuda_device, monkeypatch,
                                                lr):
    """Three SSD steps captured (``MXNET_FUSE_TRAIN_STEP=1``: MultiBoxTarget,
    the valid-normalized SoftmaxOutput and MakeLoss inside one CUDA
    graph, two replays) against three eager steps: at lr 0 every output
    equal bit for bit (the matching, mining and losses), at lr 0.002 the
    targets equal and the outputs and updates within 1e-5 of their
    largest magnitude."""
    c_out, c_par, replays = _ssd_run(lr, "1", monkeypatch)
    e_out, e_par, _ = _ssd_run(lr, "0", monkeypatch)
    assert replays == 2
    for step in range(3):
        np.testing.assert_array_equal(c_out[step][2], e_out[step][2])
        for c, e in zip(c_out[step], e_out[step]):
            if lr == 0.0:
                np.testing.assert_array_equal(c, e)
            else:
                assert np.abs(c - e).max() <= 1e-5 * np.abs(e).max()
        for k, v in e_par[step].items():
            assert np.abs(c_par[step][k] - v).max() <= \
                1e-5 * np.abs(v).max() + 1e-12, (step, k)


@pytest.mark.cuda
def test_inception_bn_step_launches_k1_and_k2_at_every_batchnorm(
        cuda_device):
    """One Module step of Inception-BN (b4, 3x224x224) on the card: one K1
    and one K2 launch per BatchNorm node of the graph, none on the CPU;
    the step matches the CPU's within 3x the floor of three perturbed CPU
    steps, the moving statistics at ``rtol=1e-4, atol=1e-5``."""
    net = mx.models.get_symbol("inception-bn", num_classes=1000)
    n_bn = sum(1 for n in net._nodes()
               if not n.is_variable and n.op.name == "BatchNorm")
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (4, 3, 224, 224)).astype(np.float32)
    y = rs.randint(0, 1000, 4).astype(np.float32)
    gu, gaux, glaunch = _resnet50_step(net, mx.gpu(0), x, y)
    cu, caux, claunch = _resnet50_step(net, mx.cpu(), x, y)
    assert glaunch == (n_bn, n_bn) and claunch == (0, 0) and n_bn > 60

    def dists(a, b):
        return np.array([np.linalg.norm(a[k] - b[k]) for k in sorted(cu)])

    floor = np.max([dists(_resnet50_step(net, mx.cpu(), (x * (
        1 + 1e-7 * rs.standard_normal(x.shape))).astype(np.float32), y)[0],
        cu) for _ in range(3)], axis=0)
    ratio = dists(gu, cu) / np.maximum(floor, 1e-30)
    assert ratio.max() <= 3, (sorted(cu)[int(ratio.argmax())], ratio.max())
    for k in caux:
        np.testing.assert_allclose(gaux[k], caux[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


# -- Faster R-CNN: K8/K8b, Proposal through K7, the spatial ops ----------------
def _roi_inputs(r, seed, c=512, hw=(37, 62), image=(600, 1000), batch=1):
    """A ReLU map with a block of zeros (whole bins tie), ``r`` ROIs with
    corners uniform over the image (one covering the whole map, a few past
    its edges, so some bins are empty) and an output gradient, on the
    card."""
    rs = np.random.RandomState(seed)
    x = np.maximum(rs.normal(0, 1, (batch, c) + hw), 0).astype(np.float32)
    x[:, :, 5:15, 10:30] = 0.0
    xy = rs.uniform(0, 1, (r, 4))
    rois = np.zeros((r, 5), np.float32)
    rois[:, 0] = rs.randint(0, batch, r)
    xs = np.sort(xy[:, :2] * (image[1] - 1), 1)
    ys = np.sort(xy[:, 2:] * (image[0] - 1), 1)
    rois[:, 1], rois[:, 3], rois[:, 2], rois[:, 4] = xs[:, 0], xs[:, 1], \
        ys[:, 0], ys[:, 1]
    rois[0, 1:] = [0, 0, image[1] - 1, image[0] - 1]
    rois[1:4, 1:] = [image[1] + 40, image[0] + 40, image[1] + 200,
                     image[0] + 90]
    g = rs.normal(0, 1, (r, c, 7, 7)).astype(np.float32)
    dev = torch.device("cuda", 0)
    return [torch.from_numpy(a).to(dev) for a in (x, rois, g)]


def _k8_k8b_equal(x, rois, g, pooled=(7, 7), scale=1 / 16.0):
    """K8 and K8b (one counted launch each) against the plain versions on
    the card: maxima and the channels-last map bit for bit, dx within
    1e-5 of its largest magnitude and bit for bit across two launches.
    Returns the tie counts the plain backward rebuilds."""
    from mxnet_tpu_torch.ops import roi_pool_kernel as rk

    before = (rk.roi_pool_fwd_cuda.launches, rk.roi_pool_bwd_cuda.launches)
    out, bounds, xt = rk.roi_pool_fwd_cuda(x, rois, pooled, scale)
    dx = rk.roi_pool_bwd_cuda(xt, bounds, g, pooled)
    torch.cuda.synchronize()
    assert (rk.roi_pool_fwd_cuda.launches,
            rk.roi_pool_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    again = rk.roi_pool_bwd_cuda(xt, bounds, g, pooled)
    pout, pbounds, pxt = rk.roi_pool_fwd_plain(x, rois, pooled, scale)
    pdx = rk.roi_pool_bwd_plain(pxt, pbounds, g, pooled)
    assert torch.equal(out, pout) and torch.equal(xt, pxt)
    assert float((dx - pdx).abs().max()) <= 1e-5 * float(pdx.abs().max())
    assert torch.equal(dx, again)
    return rk.roi_bin_stats(pxt, pbounds, pooled)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2000, 300])
def test_k8_and_k8b_match_plain_at_rcnn_shapes(cuda_device, r):
    """At phase 19b's (2000 ROIs) and 19c's (300) shapes: a 512-channel
    37x62 map, 7x7 bins, ties (a block of zeros), empty bins (ROIs past
    the edges) and one ROI over the whole map."""
    count = _k8_k8b_equal(*_roi_inputs(r, r))
    assert (count > 1).any() and (count[1:4] == 0).all()
    assert (count[0] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("pooled,scale", [((3, 4), 0.3), ((1, 1), 1.0),
                                          ((7, 7), 0.0625)])
def test_k8_and_k8b_on_small_maps_and_batches(cuda_device, pooled, scale):
    """Two images, batch indices past the ends (clamped, a negative one
    counted from the end), a scale that is not a power of two, one bin
    per ROI, and ROIs on half-integer coordinates."""
    x, rois, _g = _roi_inputs(64, 3, c=5, hw=(9, 13), image=(144, 208),
                              batch=2)
    rois[:8, 0] = torch.tensor([2, 1, 0, -1, 5, 2.7, -0.5, -1.5])
    rois[8:16, 1:] = (torch.arange(32, device=rois.device).reshape(8, 4)
                      .float() + 0.5) * 16
    rois[8:16, 1:] = torch.stack([rois[8:16, [1, 3]].min(1).values,
                                  rois[8:16, [2, 4]].min(1).values,
                                  rois[8:16, [1, 3]].max(1).values,
                                  rois[8:16, [2, 4]].max(1).values], 1)
    g = torch.randn((64, 5) + pooled, device=x.device)
    _k8_k8b_equal(x, rois, g, pooled, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [5, 513])
def test_k8_and_k8b_with_a_partial_channel_tile(cuda_device, c):
    """Channel counts that are not a multiple of the 32-channel tile: the
    last tile's idle lanes read and write nothing."""
    _k8_k8b_equal(*_roi_inputs(400, c, c=c))


@pytest.mark.cuda
def test_k8b_over_many_bands_with_bins_across_band_edges(cuda_device):
    """A 64-row map in bands of a few rows: most bins straddle a band
    edge, so each is rebuilt in every band it meets; two images."""
    from mxnet_tpu_torch.ops import roi_pool_kernel as rk

    x, rois, g = _roi_inputs(300, 11, c=64, hw=(64, 40), image=(1024, 640),
                             batch=2)
    plan = rk.roi_bwd_plan(64, 40)
    assert 64 // plan["band"] >= 4 and plan["width"] == 40
    assert rk.kernel_bwd_plan(64, 40, (7, 7))[0] == plan
    _b, hs, he, _ws, _we = rk.roi_bounds(rois, 2, 64, 40, (7, 7), 1 / 16.0)
    band = plan["band"]
    assert ((hs // band) != ((he - 1) // band)).float().mean() > 0.3
    _k8_k8b_equal(x, rois, g)


@pytest.mark.cuda
def test_k8b_with_one_pixel_under_all_2000_rois(cuda_device):
    """Every one of 2000 ROIs covers map pixel (20, 30): its tile lists
    them all, in order, in four compactions of 512 (a block of threads)."""
    from mxnet_tpu_torch.ops import roi_pool_kernel as rk

    x, rois, g = _roi_inputs(2000, 13)
    rs = np.random.RandomState(13)
    lo = rs.uniform(0, 1, (2000, 2)) * [440, 300]
    hi = rs.uniform(0, 1, (2000, 2)) * [480, 270] + [520, 330]
    rois[:, 1:] = torch.from_numpy(np.concatenate([lo, hi], 1)
                                   .astype(np.float32)).to(rois.device)
    _b, hs, he, ws, we = rk.roi_bounds(rois, 1, 37, 62, (7, 7), 1 / 16.0)
    assert ((hs[:, 0] <= 20) & (he[:, -1] > 20) & (ws[:, 0] <= 30)
            & (we[:, -1] > 30)).all()
    _k8_k8b_equal(x, rois, g)


@pytest.mark.cuda
@pytest.mark.parametrize("pooled", [(1, 1), (64, 64)])
def test_k8_and_k8b_at_the_pooled_size_limits(cuda_device, pooled):
    """One bin a ROI, and MAX_POOL x MAX_POOL bins, most smaller than a
    pixel, so a pixel lies in many bins and K8b splits each ROI over
    steps by bin rows (its partial sums carried between them)."""
    from mxnet_tpu_torch.ops import roi_pool_kernel as rk

    assert pooled[0] in (1, rk.MAX_POOL)
    x, rois, _g = _roi_inputs(40, 17, c=8)
    g = torch.randn((40, 8) + pooled, device=x.device)
    _k8_k8b_equal(x, rois, g, pooled)


@pytest.mark.cuda
def test_roi_pooling_op_on_the_card_matches_the_cpu(cuda_device):
    """The registered op in a bound graph on the card (K8 forward, K8b
    backward: one launch each) against the same graph on the CPU."""
    from mxnet_tpu_torch.ops import roi_pool_kernel as rk

    x, rois, g = [t.cpu().numpy() for t in _roi_inputs(300, 7, c=64)]
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        net = mx.sym.ROIPooling(mx.sym.Variable("data"),
                                mx.sym.Variable("rois"), pooled_size=(7, 7),
                                spatial_scale=1 / 16.0)
        ex = net.simple_bind(ctx, grad_req="write", data=x.shape,
                             rois=rois.shape)
        ex.arg_dict["data"][:] = x
        ex.arg_dict["rois"][:] = rois
        before = (rk.roi_pool_fwd_cuda.launches,
                  rk.roi_pool_bwd_cuda.launches)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(out_grads=[mx.nd.array(g)])
        res.append((out, ex.grad_dict["data"].asnumpy(),
                    (rk.roi_pool_fwd_cuda.launches - before[0],
                     rk.roi_pool_bwd_cuda.launches - before[1])))
    assert res[0][2] == (1, 1) and res[1][2] == (0, 0)
    np.testing.assert_array_equal(res[0][0], res[1][0])
    assert np.abs(res[0][1] - res[1][1]).max() <= \
        1e-5 * np.abs(res[1][1]).max()


@pytest.mark.cuda
@pytest.mark.parametrize("pre,post", [(12000, 2000), (6000, 300)])
def test_proposal_through_k7_matches_the_plain_loop(cuda_device, pre, post):
    """Proposal at 600x1000 (20,646 anchors, the pre/post-NMS top-N of
    training and inference) on the card: one K7 launch, and rois and
    scores bit for bit those of the same op with the plain loop run on
    the card; nothing read back to the host on the way."""
    from mxnet_tpu_torch.ops import contrib, nms_kernel

    rs = np.random.RandomState(pre)
    k, h, w = 9, 37, 62
    logits = rs.normal(0, 1, (1, 2, k, h, w))
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    dev = cuda_device
    cls = torch.from_numpy(p.reshape(1, 2 * k, h, w).astype(np.float32)) \
        .to(dev)
    d = torch.from_numpy(rs.normal(0, 0.2, (1, 4 * k, h, w))
                         .astype(np.float32)).to(dev)
    info = torch.tensor([[600.0, 1000.0, 1.0]], device=dev)
    args = (cls, d, info, 16, (8.0, 16.0, 32.0), (0.5, 1.0, 2.0), pre, post,
            0.7, 16)
    before = nms_kernel.greedy_nms_cuda.launches
    got = contrib.proposal(*args)
    torch.cuda.synchronize()
    assert nms_kernel.greedy_nms_cuda.launches == before + 1
    want = contrib.proposal(*args, nms=nms_kernel.greedy_nms_plain)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].shape == (post, 5)


@pytest.mark.cuda
def test_rcnn_training_step_launches_k7_k8_and_k8b_once(cuda_device):
    """One step of the end-to-end graph at 64x64 on the card: one K7, one
    K8 and one K8b launch; the outputs within 1e-4 of the CPU's step from
    the same weights (convolutions and products round otherwise)."""
    from mxnet_tpu_torch.models import rcnn
    from mxnet_tpu_torch.ops import nms_kernel
    from mxnet_tpu_torch.ops import roi_pool_kernel as rk

    rs = np.random.RandomState(0)
    a, r = 9 * 16, 2000
    batch = {"data": rs.rand(1, 3, 64, 64).astype(np.float32),
             "im_info": np.array([[64, 64, 1.0]], np.float32),
             "label": rs.randint(-1, 2, (1, a)).astype(np.float32),
             "bbox_target": rs.normal(0, 1, (1, 36, 4, 4)).astype(
                 np.float32),
             "bbox_weight": np.ones((1, 36, 4, 4), np.float32),
             "roi_label": rs.randint(0, 4, r).astype(np.float32),
             "roi_bbox_target": rs.normal(0, 1, (r, 16)).astype(np.float32),
             "roi_bbox_weight": np.ones((r, 16), np.float32)}
    labels = ("label", "bbox_target", "bbox_weight", "roi_label",
              "roi_bbox_target", "roi_bbox_weight")
    outs, params = [], None
    for ctx in (mx.gpu(0), mx.cpu()):
        with mx.name.NameManager():
            net = rcnn.get_symbol_train(num_classes=4)
        mod = mx.mod.Module(net, data_names=("data", "im_info"),
                            label_names=labels, context=ctx)
        mod.bind(data_shapes=[(k, batch[k].shape)
                              for k in ("data", "im_info")],
                 label_shapes=[(k, batch[k].shape) for k in labels])
        if params is None:
            mx.init.seed(0)
            mod.init_params(mx.init.Xavier())
            params = mx.convert.module_params_to_numpy(mod)
        else:
            mx.convert.set_module_params(mod, *params)
        before = (nms_kernel.greedy_nms_cuda.launches,
                  rk.roi_pool_fwd_cuda.launches, rk.roi_pool_bwd_cuda.launches)
        mod.forward_backward(mx.io.DataBatch(
            data=[mx.nd.array(batch[k]) for k in ("data", "im_info")],
            label=[mx.nd.array(batch[k]) for k in labels]))
        outs.append([o.asnumpy() for o in mod.get_outputs()])
        after = (nms_kernel.greedy_nms_cuda.launches,
                 rk.roi_pool_fwd_cuda.launches, rk.roi_pool_bwd_cuda.launches)
        assert [b - a for a, b in zip(before, after)] == \
            ([1, 1, 1] if ctx.device_type == "gpu" else [0, 0, 0])
    for g, c in zip(*outs):
        assert np.abs(g - c).max() <= 1e-4 * max(np.abs(c).max(), 1.0)


@pytest.mark.cuda
def test_captured_rcnn_fit_launches_k7_k8_and_k8b_once_a_step(cuda_device,
                                                             monkeypatch):
    """Three captured steps of the end-to-end graph at 64x64
    (``MXNET_FUSE_TRAIN_STEP=1``: a warm-up with the capture, then two
    replays): one K7, one K8 and one K8b launch a step, the replays
    counting what the capture recorded."""
    import chip_smoke

    from mxnet_tpu_torch.models import rcnn
    from mxnet_tpu_torch.ops import nms_kernel
    from mxnet_tpu_torch.ops import roi_pool_kernel as rk

    monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "1")
    batches = chip_smoke.rcnn_batches(0, 3, "train", image=(64, 64),
                                      classes=4)
    with mx.name.NameManager():
        net = rcnn.get_symbol_train(num_classes=4)
    data, labels = chip_smoke.rcnn_names("train")
    mod = mx.mod.Module(net, data_names=data, label_names=labels,
                        context=mx.gpu(0))
    wrappers = (nms_kernel.greedy_nms_cuda, rk.roi_pool_fwd_cuda,
                rk.roi_pool_bwd_cuda)
    before = [w.launches for w in wrappers]
    mx.init.seed(0)
    mod.fit(chip_smoke.rcnn_iter(mx, batches, "train"), num_epoch=1,
            eval_metric=chip_smoke.anchor_ce_metric(mx),
            optimizer_params=dict(chip_smoke.RCNN_OPT),
            initializer=mx.init.Xavier())
    torch.cuda.synchronize()
    assert mod._full_step_eligible() and mod._exec.graph_replays == 2
    assert [w.launches - b for w, b in zip(wrappers, before)] == [3, 3, 3]


def _spatial_cases():
    """(id, build(sym) -> symbol, {input: array}) of the other five spatial
    ops."""
    rs = np.random.RandomState(0)
    theta = np.tile(np.array([[1, 0, 0, 0, 1, 0]], np.float32), (2, 1)) \
        * 0.9 + rs.normal(0, 0.2, (2, 6)).astype(np.float32)
    v = mx.sym.Variable
    return [
        ("bilinear", lambda: mx.sym.BilinearSampler(v("data"), v("grid")),
         {"data": rs.normal(0, 1, (2, 3, 17, 23)).astype(np.float32),
          "grid": rs.uniform(-1.2, 1.2, (2, 2, 11, 13)).astype(
              np.float32)}),
        ("grid-affine", lambda: mx.sym.GridGenerator(
            v("data"), transform_type="affine", target_shape=(9, 11)),
         {"data": theta}),
        ("grid-warp", lambda: mx.sym.GridGenerator(
            v("data"), transform_type="warp"),
         {"data": rs.normal(0, 2, (2, 2, 9, 11)).astype(np.float32)}),
        ("spatial-transformer", lambda: mx.sym.SpatialTransformer(
            v("data"), v("loc"), target_shape=(9, 11)),
         {"data": rs.normal(0, 1, (2, 3, 12, 16)).astype(np.float32),
          "loc": theta}),
        ("correlation", lambda: mx.sym.Correlation(
            v("a"), v("b"), kernel_size=3, max_displacement=4, stride1=1,
            stride2=2, pad_size=4),
         {"a": rs.normal(0, 1, (2, 8, 12, 16)).astype(np.float32),
          "b": rs.normal(0, 1, (2, 8, 12, 16)).astype(np.float32)}),
        ("crop", lambda: mx.sym.Crop(v("data"), v("like"), num_args=2,
                                     center_crop=True),
         {"data": rs.normal(0, 1, (2, 3, 12, 16)).astype(np.float32),
          "like": rs.normal(0, 1, (2, 3, 7, 9)).astype(np.float32)}),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _spatial_cases(), ids=lambda c: c[0])
def test_spatial_ops_on_the_card_match_the_cpu(cuda_device, case):
    """BilinearSampler, GridGenerator, SpatialTransformer, Correlation and
    Crop on the card against the CPU, forward and gradient, within 1e-5
    of each output's largest magnitude."""
    _name, build, values = case
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        ex = build().simple_bind(ctx, grad_req="write",
                                 **{k: v.shape for k, v in values.items()})
        for k, val in values.items():
            ex.arg_dict[k][:] = val
        out = ex.forward(is_train=True)[0].asnumpy()
        head = np.random.RandomState(1).normal(0, 1, out.shape).astype(
            np.float32)
        ex.backward(out_grads=[mx.nd.array(head)])
        res.append([out] + [ex.grad_dict[k].asnumpy() for k in values])
    for g, c in zip(*res):
        assert np.abs(g - c).max() <= 1e-5 * max(np.abs(c).max(), 1.0)


@pytest.mark.cuda
def test_kernels_line_names_k8_and_k8b(cuda_device):
    """``chip_smoke.py``'s rows of K8 and K8b (here on a small map) carry
    every key of the contract's kernels line, the source and the JAX
    function they replace."""
    import chip_smoke

    from mxnet_tpu_torch.ops import roi_pool_kernel as rk

    x, rois, g = _roi_inputs(50, 9, c=16)
    rows = chip_smoke.roi_kernel_rows(rk, x, rois, g, (3, 2), "card",
                                      "a small map")
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [r["name"] for r in rows] == ["roi_pooling_fwd",
                                         "roi_pooling_bwd"]
    for row, n in zip(rows, (3, 2)):
        assert keys <= set(row) and row["launches"] == n
        assert row["route"] == "cuda" and row["library_ms"] is None
        assert row["source"] == "mxnet_tpu_torch/csrc/roi_pooling.cu"
        assert row["replaces"] == "mxnet_tpu/ops/spatial.py:28"
        assert row["ms"] > 0 and row["bound_ms"] > 0
        assert row["bound_by"] in ("bytes", "operations")
    json.dumps(rows)
