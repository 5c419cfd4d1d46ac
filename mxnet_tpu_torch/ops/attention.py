"""Attention ops: flash attention (hand-written Hopper kernels + their
plain PyTorch versions), counterpart of ``mxnet_tpu/ops/attention.py``.

* :func:`flash_attention_plain` — blockwise online softmax over K/V blocks
  in torch f32, the counterpart of ``_flash_scan``.  Taken for CPU tensors.
* :func:`flash_attention_cuda` — the wrapper of kernel K3
  (``csrc/flash_attention.cu``), which replaces the TPU kernel
  ``mxnet_tpu/ops/attention.py::_fa_kernel``: 3xTF32 on the tensor cores
  (``mma.sync``), f32-accurate; the source says what bounds it and how
  the design meets that.  Taken for CUDA tensors: it launches
  the kernel or raises.  ``flash_attention_cuda.launches`` counts the
  launches.
* :func:`flash_attention_bwd_plain` — the FA2 backward, blockwise over K
  in torch f32, the counterpart of ``_flash_bwd_core`` (plain JAX in the
  JAX package, which has no Pallas backward): ``delta = sum_d do*o``,
  ``p = exp(s - lse)`` masked to 0, ``ds = p*(dp - delta + dlse)*scale``.
* :func:`flash_attention_bwd_cuda` — the wrapper of kernel K3b, the same
  backward by hand in the same source (a row prologue for ``delta -
  dlse``, then one persistent kernel: five products a (key tile, query
  tile) pair, dq summed in a fixed key-tile order through integer flags,
  no floating-point atomics, so gradients repeat bit for bit).
  ``flash_attention_bwd_cuda.launches`` counts one per call.
* :class:`FlashAttention` — the ``torch.autograd.Function`` joining them
  (the counterpart of ``_flash``/``_flash_pair``'s ``custom_vjp``): its
  forward saves ``(q, k, v, out, lse)``; its backward takes the
  cotangents of ``out`` and of ``lse`` (``dlse``, which ring attention
  needs).  Both directions are routed by the device the tensors lie on:
  the kernels for CUDA tensors, the plain versions for CPU tensors.
* :func:`flash_attention_with_lse` / :func:`flash_attention` — the public
  functions, differentiable in both outputs (``meta`` tensors give
  shapes only, for shape inference).

Shapes follow (batch, heads, seq, head_dim) throughout.  The kernels read
q, k, v, out and do through their strides (the last dim contiguous), and
K3b writes dq, dk and dv in the strides of q, k and v, so the head views
the ``MultiHeadAttention`` op makes cost no copy either way.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _kernels
from ..base import MXNetError
from . import launches
from .registry import REQUIRED, pbool, pfloat, pint, register

NEG_INF = -1e30

#: largest head dim the kernel takes
MAX_HEAD_DIM = 128


def flash_attention_plain(q, k, v, causal, scale, block_k=512):
    """Blockwise attention in torch f32; returns ``(out, lse)`` with
    ``out`` in q's dtype and ``lse`` (B, H, Lq) f32."""
    qf, kf, vf = q.float(), k.float(), v.float()
    b, h, lq, d = q.shape
    lk = k.shape[2]
    o = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    qi = torch.arange(lq, device=q.device)[:, None]
    for k0 in range(0, lk, block_k):
        k_blk = kf[:, :, k0:k0 + block_k]
        v_blk = vf[:, :, k0:k0 + block_k]
        s = torch.matmul(qf, k_blk.transpose(-1, -2)) * scale
        if causal:
            kpos = k0 + torch.arange(k_blk.shape[2], device=q.device)
            s = torch.where(qi >= kpos[None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.matmul(p, v_blk)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return (o / l[..., None]).to(q.dtype), m + torch.log(l)


def flash_attention_bwd_plain(q, k, v, out, lse, do, dlse, causal, scale,
                              block_k=512):
    """The backward of :func:`flash_attention_plain` in torch f32,
    blockwise over K: ``(dq, dk, dv)`` in the dtypes of q, k, v from the
    forward's ``out`` and ``lse``, the cotangent ``do`` of out and the
    optional cotangent ``dlse`` (B, H, Lq) of lse."""
    qf, kf, vf = q.float(), k.float(), v.float()
    dof, of = do.float(), out.float()
    b, h, lq, d = q.shape
    lk = k.shape[2]
    # delta - dlse, one value a row: ds = p * (dp - delta + dlse) * scale
    dd = (dof * of).sum(dim=-1)
    if dlse is not None:
        dd = dd - dlse.float()
    dq = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, h, lk, d), dtype=torch.float32, device=q.device)
    dv = torch.empty((b, h, lk, d), dtype=torch.float32, device=q.device)
    qi = torch.arange(lq, device=q.device)[:, None]
    for k0 in range(0, lk, block_k):
        k_blk = kf[:, :, k0:k0 + block_k]
        v_blk = vf[:, :, k0:k0 + block_k]
        s = torch.matmul(qf, k_blk.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[..., None])
        if causal:
            kpos = k0 + torch.arange(k_blk.shape[2], device=q.device)
            p = torch.where(qi >= kpos[None, :], p, 0.0)
        dv[:, :, k0:k0 + block_k] = torch.matmul(p.transpose(-1, -2), dof)
        dp = torch.matmul(dof, v_blk.transpose(-1, -2))
        ds = p * (dp - dd[..., None]) * scale
        dq += torch.matmul(ds, k_blk)
        dk[:, :, k0:k0 + block_k] = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise MXNetError("flash attention kernel takes float32, got %s "
                             "%s" % (name, t.dtype))
        if t.device != q.device:
            raise MXNetError("flash attention: %s on %s, q on %s"
                             % (name, t.device, q.device))
        if t.dim() != 4 or t.stride(-1) != 1:
            raise MXNetError("flash attention: %s must be (B, H, L, D) with "
                             "a contiguous last dim" % name)
    b, h, lq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise MXNetError("flash attention: shapes q %s k %s v %s disagree"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not 1 <= d <= MAX_HEAD_DIM:
        raise MXNetError("flash attention kernel takes head_dim <= %d, got %d"
                         % (MAX_HEAD_DIM, d))


def _vector_ok(t):
    """float4 loads need 16-byte aligned rows."""
    return t.data_ptr() % 16 == 0 \
        and all(s % 4 == 0 for s in t.stride()[:3])


def _c_args(lib):
    fn = lib.mxtt_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, causal, scale):
    """Launch kernel K3 on q's card, on the current stream.  Returns
    ``(out, lse)``; raises on inputs the kernel does not take."""
    _check_cuda_inputs(q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    out = torch.empty((b, h, lq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    fn = _c_args(_kernels.load("flash_attention"))
    vec = int(d % 4 == 0 and all(_vector_ok(t) for t in (q, k, v)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, h, lq, lk, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], float(scale), int(bool(causal)), vec,
                 stream)
    if err != 0:
        raise MXNetError("flash attention kernel launch failed: CUDA error "
                         "%d" % err)
    launches.count(flash_attention_cuda)
    return out, lse


#: launches of kernel K3 in this process (reset freely)
flash_attention_cuda.launches = 0


def _bwd_c_args(lib):
    fn = lib.mxtt_flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 24
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        words = lib.mxtt_flash_attention_bwd_work_words
        words.argtypes = [ctypes.c_int] * 3
        words.restype = ctypes.c_longlong
    return fn, lib.mxtt_flash_attention_bwd_work_words


def _check_like(name, t, shape, device):
    if t.dtype != torch.float32 or t.device != device \
            or tuple(t.shape) != tuple(shape):
        raise MXNetError("flash attention backward: %s must be float32 %s "
                         "on %s, got %s %s on %s"
                         % (name, tuple(shape), device, t.dtype,
                            tuple(t.shape), t.device))


def flash_attention_bwd_cuda(q, k, v, out, lse, do, dlse, causal, scale):
    """Launch kernel K3b on q's card, on the current stream: ``(dq, dk,
    dv)`` from the forward's ``out`` and ``lse``, the cotangent ``do`` of
    out and the optional cotangent ``dlse`` of lse.  dq, dk and dv take
    the strides of q, k and v (``empty_like``); raises on inputs the
    kernel does not take."""
    _check_cuda_inputs(q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    for name, t in (("out", out), ("do", do)):
        _check_like(name, t, (b, h, lq, d), q.device)
    _check_like("lse", lse, (b, h, lq), q.device)
    if dlse is not None:
        _check_like("dlse", dlse, (b, h, lq), q.device)
        dlse = dlse.contiguous()
    lse = lse.contiguous()
    if out.stride(-1) != 1:
        raise MXNetError("flash attention backward: out must have a "
                         "contiguous last dim")
    if do.stride(-1) != 1:
        # not the MultiHeadAttention path (its do is a strided view with a
        # contiguous last dim): an expanded cotangent, as of out.sum()
        do = do.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dd = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    fn, work_words = _bwd_c_args(_kernels.load("flash_attention"))
    # the item counter and the dq flags; the kernel's prologue zeroes them
    work = torch.empty((work_words(b, h, lq),), dtype=torch.int32,
                       device=q.device)
    vec = int(d % 4 == 0 and all(_vector_ok(t) for t in (q, k, v, do, dq)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 do.data_ptr(), lse.data_ptr(),
                 None if dlse is None else dlse.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dd.data_ptr(),
                 work.data_ptr(), b, h, lq, lk, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], *do.stride()[:3], *dq.stride()[:3],
                 *dk.stride()[:3], *dv.stride()[:3], float(scale),
                 int(bool(causal)), vec, stream)
    if err != 0:
        raise MXNetError("flash attention backward kernel launch failed: "
                         "CUDA error %d" % err)
    launches.count(flash_attention_bwd_cuda)
    return dq, dk, dv


#: calls of kernel K3b (a prologue and the persistent kernel each) in this
#: process (reset freely)
flash_attention_bwd_cuda.launches = 0


#: the kernel for CUDA tensors, the plain version for CPU tensors
_route = functools.partial(launches.route, what="flash attention")


class FlashAttention(torch.autograd.Function):
    """``(q, k, v) -> (out, lse)`` through K3, backward through K3b
    (their plain versions on the CPU), differentiable in both outputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        fwd = _route(q, flash_attention_cuda, flash_attention_plain)
        out, lse = fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.hyper = (causal, scale)
        # an unused output's cotangent stays None: no dlse term without
        # one, no zero tensor made for it
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale = ctx.hyper
        if do is None:
            do = torch.zeros_like(out)
        bwd = _route(q, flash_attention_bwd_cuda, flash_attention_bwd_plain)
        dq, dk, dv = bwd(q, k, v, out, lse, do, dlse, causal, scale)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal=False, softmax_scale=None):
    """Attention returning ``(out, lse)``, differentiable in both."""
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "meta":
        b, h, lq, d = q.shape
        return (torch.empty((b, h, lq, d), dtype=q.dtype, device="meta"),
                torch.empty((b, h, lq), dtype=torch.float32, device="meta"))
    # where no input requires grad, apply records no graph and keeps
    # nothing saved: the same forward serves inference
    return FlashAttention.apply(q, k, v, bool(causal), float(softmax_scale))


def flash_attention(q, k, v, causal=False, softmax_scale=None):
    """Memory-efficient attention. q/k/v: (batch, heads, seq, head_dim)."""
    return flash_attention_with_lse(q, k, v, causal, softmax_scale)[0]


# -- registered ops ---------------------------------------------------------
def _flash_attention_op(attrs, inputs, aux, is_train):
    # block_q/block_k are the TPU kernel's tiling, kept so graph JSON
    # round-trips; the Hopper kernel's tiles are fixed by its design
    q, k, v = inputs
    return [flash_attention(q, k, v, causal=attrs["causal"],
                            softmax_scale=attrs["softmax_scale"] or None)]


register("_contrib_FlashAttention", _flash_attention_op,
         arguments=("query", "key", "value"),
         params={"causal": (pbool, False),
                 "softmax_scale": (pfloat, 0.0),
                 "block_q": (pint, 256), "block_k": (pint, 512)},
         aliases=("FlashAttention",), hint="flashattention")


def _mha_op(attrs, inputs, aux, is_train):
    """MultiHeadAttention: (B, L, E) inputs, fused qkv projection weights
    ``qkv_weight`` (3E, E) split on axis 0, each applied as ``x @ W^T``."""
    x_q, x_kv, w_qkv, w_out = inputs[:4]
    b_qkv = inputs[4] if len(inputs) > 4 else None
    b_out = inputs[5] if len(inputs) > 5 else None
    num_heads = attrs["num_heads"]
    bsz, lq, e = x_q.shape
    hd = e // num_heads
    wq, wk, wv = torch.chunk(w_qkv, 3, dim=0)
    q = torch.matmul(x_q, wq.t())
    kk = torch.matmul(x_kv, wk.t())
    vv = torch.matmul(x_kv, wv.t())
    if b_qkv is not None:
        bq, bk, bv = torch.chunk(b_qkv, 3)
        q, kk, vv = q + bq, kk + bk, vv + bv

    def heads(t):
        # (B, L, E) -> (B, H, L, hd) as a strided view; the kernels read
        # the strides (K3b writes the gradients in them), so no copy is
        # made either way
        return t.reshape(t.shape[0], t.shape[1], num_heads, hd).transpose(1, 2)

    o = flash_attention(heads(q), heads(kk), heads(vv), causal=attrs["causal"])
    o = o.transpose(1, 2).reshape(bsz, lq, e)
    out = torch.matmul(o, w_out.t())
    if b_out is not None:
        out = out + b_out
    return [out]


register("_contrib_MultiHeadAttention", _mha_op,
         arguments=lambda a: (["query", "key_value", "qkv_weight", "out_weight"]
                              + ([] if a["no_bias"] else ["qkv_bias", "out_bias"])),
         params={"num_heads": (pint, REQUIRED), "causal": (pbool, False),
                 "no_bias": (pbool, False)},
         aliases=("MultiHeadAttention",), hint="multiheadattention")
