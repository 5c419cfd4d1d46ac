"""Flash attention of the PyTorch port held against the JAX package.

On the CPU the port's wrapper takes its plain version
(``flash_attention_plain``); it is compared with the TPU kernel run in
Pallas interpret mode (``_flash_pallas(..., interpret=True)``) and with the
quadratic reference ``_attn_reference``, for ``out`` and ``lse``.  The
tolerance ``rtol=atol=1e-5`` covers f32 sums taken in another order.
The kernels themselves run only on the card: ``tests/test_torch_cuda.py``.
Here the arithmetic of K3 and of the backward K3b is emulated in torch
(their TF32 splits, K3b's dq order), held against float64 and the JAX
package, and K3b's source is checked for floating-point atomics.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops.attention import (_attn_reference, _flash_bwd_core,
                                     _flash_pallas)
from mxnet_tpu_torch.ops import attention as tatt

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b, h, lq, lk, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.normal(0, 1, (b, h, n, d)).astype(np.float32)
            for n in (lq, lk, lk)]


def _ref_lse(q, k, scale, causal):
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    if causal:
        mask = np.arange(q.shape[2])[:, None] >= np.arange(k.shape[2])[None]
        s = np.where(mask, s, -1e30)
    mx = s.max(-1, keepdims=True)
    return (np.log(np.exp(s - mx).sum(-1)) + mx[..., 0]).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_interpret(causal):
    """A Pallas-eligible shape: Lq, Lk multiples of the kernel blocks."""
    q, k, v = _qkv(1, 2, 32, 64, 16, seed=3)
    jout, jlse = _flash_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal, 0.25, block_q=16, block_k=16,
                               interpret=True)
    out, lse = tatt.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, softmax_scale=0.25)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk,d,block_k", [(48, 48, 16, 512),
                                             (48, 48, 16, 16),
                                             (40, 70, 8, 32)])
def test_plain_matches_reference_ragged(causal, lq, lk, d, block_k):
    """Ragged lengths (not multiples of any block) against the quadratic
    reference, with lse against a float64 logsumexp."""
    q, k, v = _qkv(2, 3, lq, lk, d, seed=lq + lk)
    scale = 1.0 / np.sqrt(d)
    ref = _attn_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal)
    out, lse = tatt.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, scale, block_k=block_k)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), _ref_lse(q, k, scale, causal),
                               **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_op_matches_jax(causal):
    """The registered MultiHeadAttention op, weight layout included
    (qkv_weight (3E, E) split on axis 0, each applied as x @ W^T)."""
    from mxnet_tpu.ops.registry import get as jget
    from mxnet_tpu_torch.ops.registry import get as tget

    rs = np.random.RandomState(7)
    b, l, e, heads = 2, 24, 32, 4
    ins = [rs.normal(0, 1, (b, l, e)), rs.normal(0, 1, (b, l, e)),
           rs.normal(0, 0.2, (3 * e, e)), rs.normal(0, 0.2, (e, e)),
           rs.normal(0, 0.2, (3 * e,)), rs.normal(0, 0.2, (e,))]
    ins = [x.astype(np.float32) for x in ins]
    jop = jget("MultiHeadAttention")
    attrs = jop.canonicalize_attrs({"num_heads": heads, "causal": causal})
    (jout,), _ = jop.apply(attrs, [jnp.asarray(x) for x in ins], [], False,
                           None)
    top = tget("MultiHeadAttention")
    tattrs = top.canonicalize_attrs({"num_heads": heads, "causal": causal})
    (tout,) = top.apply(tattrs, [torch.from_numpy(x) for x in ins], [], False)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_flash_attention_op_matches_jax():
    q, k, v = _qkv(1, 2, 16, 16, 8, seed=11)
    jout = jmx.nd.FlashAttention(jmx.nd.array(q), jmx.nd.array(k),
                                 jmx.nd.array(v), causal=True).asnumpy()
    from mxnet_tpu_torch.ops.registry import get as tget

    op = tget("FlashAttention")
    (tout,) = op.apply(op.canonicalize_attrs({"causal": True}),
                       [torch.from_numpy(x) for x in (q, k, v)], [], False)
    np.testing.assert_allclose(tout.numpy(), jout, **TOL)


def test_cpu_path_launches_no_kernel():
    before = tatt.flash_attention_cuda.launches
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 8, 8, 4, seed=1))
    tatt.flash_attention(q, k, v, causal=True)
    assert tatt.flash_attention_cuda.launches == before


def test_meta_tensors_give_shapes_only():
    q = torch.empty((2, 3, 5, 8), device="meta")
    k = torch.empty((2, 3, 7, 8), device="meta")
    out, lse = tatt.flash_attention_with_lse(q, k, k)
    assert out.shape == (2, 3, 5, 8) and lse.shape == (2, 3, 5)
    assert lse.dtype == torch.float32


def _tf32(x):
    """``cvt.rna.tf32.f32`` in torch: round an f32 to the nearest TF32
    (ties away from zero), then mask off the low 13 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_rz(x):
    """What the tensor cores read of an f32 passed as .tf32: the low 13
    mantissa bits masked off (round toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a, b, passes):
    """``a @ b`` as the tensor cores take it: one TF32 product, or the
    3xTF32 split of kernel K3 (big*small + small*big + big*big, f32 sums;
    big rounded to nearest, the remainder truncated)."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    asm, bsm = _tf32_rz(a - ab), _tf32_rz(b - bb)
    return ab @ bsm + asm @ bb + ab @ bb


def _tf32_attention(q, k, v, scale, qk_passes, pv_passes):
    """Causal attention with Q K^T and P V emulated in TF32 (1 or 3
    passes each), softmax and its sums in f32 as in the kernel."""
    s = _tf32_matmul(q, k.transpose(-1, -2), qk_passes) * scale
    lq, lk = s.shape[-2:]
    mask = torch.arange(lq)[:, None] >= torch.arange(lk)[None]
    s = torch.where(mask, s, torch.tensor(-1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return _tf32_matmul(p, v, pv_passes) / l, (m + torch.log(l))[..., 0]


def _tf32_attention_f64(q, k, v, scale):
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
    lq, lk = s.shape[-2:]
    mask = torch.arange(lq)[:, None] >= torch.arange(lk)[None]
    s = torch.where(mask, s, torch.tensor(-1e30, dtype=torch.float64))
    return torch.matmul(torch.softmax(s, -1), v.double()), \
        torch.logsumexp(s, -1)


def test_tf32_split_meets_the_kernel_tolerance():
    """Why K3 takes three TF32 products per product: at the served shape
    (L=2048, D=128, causal) the 3xTF32 split of both Q K^T and P V stays
    within the kernel's ``atol=rtol=1e-4`` of a float64 reference, and
    every cheaper choice (one TF32 pass for either product or both) does
    not; each one's error is printed."""
    b, h, L, d = 1, 2, 2048, 128
    q, k, v = (torch.from_numpy(x) for x in _qkv(b, h, L, L, d, seed=5))
    scale = 1.0 / np.sqrt(d)
    ref, ref_lse = _tf32_attention_f64(q, k, v, scale)
    over = {}  # largest |err| - (1e-4 + 1e-4 |ref|): <= 0 within tolerance
    for passes in ((3, 3), (3, 1), (1, 3), (1, 1)):
        out, lse = _tf32_attention(q, k, v, scale, *passes)
        err_o = (out.double() - ref).abs()
        err_l = (lse.double() - ref_lse).abs()
        over[passes] = max(
            (err_o - 1e-4 - 1e-4 * ref.abs()).max().item(),
            (err_l - 1e-4 - 1e-4 * ref_lse.abs()).max().item())
        print("TF32 passes (QK^T, PV) = %s: max |err| out %.3g, lse %.3g"
              % (passes, err_o.max().item(), err_l.max().item()))
    assert over[(3, 3)] <= 0
    assert all(over[p] > 0 for p in ((3, 1), (1, 3), (1, 1)))


K3B_TILE = 64  # keys a K3b work item holds
K3B_PRODUCTS = ("S^T = K Q^T", "dP^T = V dO^T", "dV = P^T dO",
                "dK = dS^T Q", "dQ = dS K")


def _k3b_product(a, b, passes):
    """``a @ b`` as K3b takes it: each operand split toward zero (big =
    the low 13 mantissa bits cleared, small = the rest, which the tensor
    cores read truncated), then one TF32 product or three summed in f32
    (big*small + small*big + big*big)."""
    ab, bb = _tf32_rz(a), _tf32_rz(b)
    if passes == 1:
        return ab @ bb
    return ab @ _tf32_rz(b - bb) + _tf32_rz(a - ab) @ bb + ab @ bb


def _k3b_emulated(q, k, v, out, lse, do, scale, passes):
    """K3b's arithmetic, causal, in torch f32: for each 64-key tile the
    five products with ``passes[i]`` TF32 passes for product i, over the
    queries that can see the tile; dq summed over the key tiles in
    ascending order (tile 0 stores, each later tile adds its part), the
    kernel's fixed order."""
    log2e = 1.4426950408889634
    dd = (do * out).sum(-1)
    lq = q.shape[-2]
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, k.shape[-2], K3B_TILE):
        kj, vj = k[..., k0:k0 + K3B_TILE, :], v[..., k0:k0 + K3B_TILE, :]
        qs, dos = q[..., k0:, :], do[..., k0:, :]
        st = _k3b_product(kj, qs.transpose(-1, -2), passes[0])
        pt = torch.exp2(st * (scale * log2e)
                        - lse[..., None, k0:] * log2e)
        keys = k0 + torch.arange(kj.shape[-2])[:, None]
        pt = torch.where(keys <= k0 + torch.arange(lq - k0)[None], pt, 0.0)
        dpt = _k3b_product(vj, dos.transpose(-1, -2), passes[1])
        dst = pt * (dpt - dd[..., None, k0:]) * scale
        dv[..., k0:k0 + K3B_TILE, :] = _k3b_product(pt, dos, passes[2])
        dk[..., k0:k0 + K3B_TILE, :] = _k3b_product(dst, qs, passes[3])
        part = _k3b_product(dst.transpose(-1, -2), kj, passes[4])
        dq[..., k0:, :] = part if k0 == 0 else dq[..., k0:, :] + part
    return dq, dk, dv


def test_k3b_arithmetic_meets_the_kernel_tolerance():
    """K3b's arithmetic emulated on the CPU at the LM's shape (L=2048,
    D=128, causal): with three TF32 passes in each of the five products,
    the split toward zero and dq summed in the kernel's key-tile order,
    dq, dk and dv lie within 1e-4 of each output's magnitude of a float64
    backward and of the JAX package's ``_flash_bwd_core``.  One TF32 pass
    in any one of the five products, the others at three, misses that
    tolerance (2e-3 for S^T and dP^T, 6e-4 to 9e-4 for dV, dK and dQ;
    each one's error is printed), so each product takes three passes."""
    b, h, L, d = 1, 1, 2048, 128
    rs = np.random.RandomState(11)
    q, k, v, do = (torch.from_numpy(rs.normal(0, 1, (b, h, L, d))
                                    .astype(np.float32)) for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    out, lse = tatt.flash_attention_plain(q, k, v, True, scale)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    s = q64 @ k64.transpose(-1, -2) * scale
    s = torch.where(torch.arange(L)[:, None] >= torch.arange(L)[None], s,
                    torch.tensor(-1e30, dtype=torch.float64))
    p = torch.softmax(s, -1)
    dp = do64 @ v64.transpose(-1, -2)
    ds = p * (dp - (do64 * (p @ v64)).sum(-1, keepdim=True)) * scale
    ref = (ds @ k64, ds.transpose(-1, -2) @ q64, p.transpose(-1, -2) @ do64)
    jax_grads = _flash_bwd_core(
        True, scale, 128, 128, tuple(jnp.asarray(t.numpy())
                                     for t in (q, k, v, out, lse)),
        jnp.asarray(do.numpy()))

    def worst(got, want):
        return max(((g.double() - w).abs().max()
                    / max(1.0, w.abs().max())).item()
                   for g, w in zip(got, want))

    got = _k3b_emulated(q, k, v, out, lse, do, scale, (3,) * 5)
    assert worst(got, ref) <= 1e-4
    assert worst(got, [torch.from_numpy(np.array(g)).double()
                       for g in jax_grads[:3]]) <= 1e-4
    misses = []
    for i, name in enumerate(K3B_PRODUCTS):
        passes = tuple(1 if j == i else 3 for j in range(5))
        err = worst(_k3b_emulated(q, k, v, out, lse, do, scale, passes),
                    ref)
        print("K3b with one TF32 pass in %s: %.3g of the magnitude"
              % (name, err))
        if err > 1e-4:
            misses.append(name)
    assert misses == list(K3B_PRODUCTS)


def test_k3b_source_has_no_floating_point_atomics():
    """K3b sums dq in a fixed order: its source adds floats only with
    plain loads and stores; the one atomic it takes is the integer work
    counter, and its reductions (``red``) are integer adds on the flags."""
    path = os.path.join(os.path.dirname(tatt.__file__), "..", "csrc",
                        "flash_attention.cu")
    with open(path) as f:
        src = f.read()
    k3b = src[src.index("// K3b: the backward"):]
    assert re.findall(r"atomicAdd\(([^,]+),", k3b) == ["p.work"]
    assert not re.search(r"\b(atomicAdd|atomicExch)\(\s*\(?\s*float", k3b)
    reds = re.findall(r"\b(?:red|atom)\.[a-z0-9.:]+", k3b)
    assert reds and all(r.endswith(".s32") for r in reds), reds
