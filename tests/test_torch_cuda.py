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
