"""Whole-sequence LSTM: hand-written Hopper kernels K4 (inference
forward), K5 (training forward, saving gates and cell states) and K6
(backward) with their plain PyTorch versions, counterpart of
``mxnet_tpu/ops/rnn_pallas.py``.

* :func:`lstm_infer_plain`, :func:`lstm_fwd_plain`, :func:`lstm_bwd_plain`
  — the same math in torch, a Python loop over T in f32.  Taken for CPU
  tensors.
* :func:`lstm_infer_cuda`, :func:`lstm_fwd_cuda`, :func:`lstm_bwd_cuda` —
  the wrappers of kernels K4, K5 and K6 (``csrc/lstm.cu``), which replace
  the TPU kernels ``rnn_pallas.py::_infer_kernel``, ``::_fwd_kernel`` and
  ``::_bwd_kernel``; the source says what bounds them and how the design
  meets that.  Taken for CUDA tensors: they launch the kernel or raise.
  ``.launches`` on each counts its launches.
* :func:`lstm_seq` — the public entry, mirroring ``rnn_pallas.lstm_seq``'s
  ``custom_vjp``: with no gradient needed (``torch.is_grad_enabled()``
  false, as under the executor's ``inference_mode``, or no input that
  requires one) K4 runs; under autograd :class:`LSTMSeqFn` runs K5 and
  saves gates, cs and ys for K6.

Layout (the JAX package's, at the kernels' interface): xp (T, 4, N, H)
input-side projections, w4 (4, H, H) with ``w4[k]`` the (in, out) matrix
of gate k, bh (4, H), h0 and c0 (N, H); gate order i, f, g, o.  f32 only.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels
from ..base import MXNetError
from . import launches

__all__ = ["lstm_infer_plain", "lstm_fwd_plain", "lstm_bwd_plain",
           "lstm_infer_cuda", "lstm_fwd_cuda", "lstm_bwd_cuda",
           "lstm_fwd_plan", "lstm_bwd_plan", "LSTMSeqFn", "lstm_seq"]


# -- the plain versions -------------------------------------------------------
def _cell(xpt, h, c, w4, bh):
    """One step: ((i, f, g, o), c, h)."""
    z = torch.matmul(h.unsqueeze(0), w4)  # (4, N, H): z[k] = h @ w4[k]
    i = torch.sigmoid(xpt[0] + z[0] + bh[0])
    f = torch.sigmoid(xpt[1] + z[1] + bh[1])
    g = torch.tanh(xpt[2] + z[2] + bh[2])
    o = torch.sigmoid(xpt[3] + z[3] + bh[3])
    c = f * c + i * g
    return (i, f, g, o), c, o * torch.tanh(c)


def lstm_fwd_plain(xp, w4, bh, h0, c0):
    """K5's function in torch: ``(ys, gates, cs, hT, cT)``."""
    h, c = h0, c0
    ys, gates, cs = [], [], []
    for t in range(xp.shape[0]):
        gs, c, h = _cell(xp[t], h, c, w4, bh)
        ys.append(h)
        cs.append(c)
        gates.append(torch.stack(gs))
    return torch.stack(ys), torch.stack(gates), torch.stack(cs), h, c


def lstm_infer_plain(xp, w4, bh, h0, c0):
    """K4's function in torch: ``(ys, hT, cT)``."""
    h, c = h0, c0
    ys = []
    for t in range(xp.shape[0]):
        _gs, c, h = _cell(xp[t], h, c, w4, bh)
        ys.append(h)
    return torch.stack(ys), h, c


def lstm_bwd_plain(gates, cs, ys, w4, h0, c0, dys, dhT, dcT):
    """K6's function in torch: ``(dxp, dw4, dbh, dh0, dc0)``."""
    T = gates.shape[0]
    dw4 = torch.zeros_like(w4)
    dbh = torch.zeros(w4.shape[0], w4.shape[2], dtype=w4.dtype,
                      device=w4.device)
    dxp = [None] * T
    dh, dc = dhT, dcT
    for t in range(T - 1, -1, -1):
        i, f, g, o = gates[t]
        c = cs[t]
        c_prev = cs[t - 1] if t > 0 else c0
        h_prev = ys[t - 1] if t > 0 else h0
        dh = dh + dys[t]
        tc = torch.tanh(c)
        do = dh * tc
        dc = dc + dh * o * (1.0 - tc * tc)
        dz = torch.stack([dc * g * i * (1.0 - i),
                          dc * c_prev * f * (1.0 - f),
                          dc * i * (1.0 - g * g),
                          do * o * (1.0 - o)])
        dxp[t] = dz
        dbh += dz.sum(dim=1)
        dw4 += torch.matmul(h_prev.t().unsqueeze(0), dz)
        dh = torch.matmul(dz, w4.transpose(1, 2)).sum(dim=0)
        dc = dc * f
    return torch.stack(dxp), dw4, dbh, dh, dc


# -- the kernels --------------------------------------------------------------
def _check(name, t, ref, shape):
    if t.dtype != torch.float32:
        raise MXNetError("LSTM kernel takes float32 (bfloat16 is not ported "
                         "yet), got %s %s" % (name, t.dtype))
    if t.device != ref.device:
        raise MXNetError("LSTM kernel: %s on %s, the first input on %s"
                         % (name, t.device, ref.device))
    if tuple(t.shape) != tuple(shape):
        raise MXNetError("LSTM kernel: %s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise MXNetError("LSTM kernel: %s must be contiguous, got strides %s"
                         % (name, t.stride()))


def _dims(xp):
    if xp.dim() != 4 or xp.shape[1] != 4:
        raise MXNetError("LSTM kernel: xp must be (T, 4, N, H), got %s"
                         % (tuple(xp.shape),))
    return xp.shape[0], xp.shape[2], xp.shape[3]


def _check_fwd(xp, w4, bh, h0, c0):
    T, N, H = _dims(xp)
    for name, t, shape in (("xp", xp, xp.shape), ("w4", w4, (4, H, H)),
                           ("bh", bh, (4, H)), ("h0", h0, (N, H)),
                           ("c0", c0, (N, H))):
        _check(name, t, xp, shape)
    return T, N, H


def _work(lib, T, N, H, bwd, device):
    """The kernels' work space, sized by the kernel source itself."""
    fn = lib.mxtt_lstm_work_floats
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_longlong] * 3 + [ctypes.c_int]
        fn.restype = ctypes.c_longlong
    floats = fn(T, N, H, int(bwd))
    if floats < 0:
        raise MXNetError("LSTM kernel does not take T=%d N=%d H=%d (it takes "
                         "H <= 1024 and T*4*N*H below 2^31)" % (T, N, H))
    return torch.empty((floats,), dtype=torch.float32, device=device)


def _fn(lib, name, n_ptr):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(fn, what, tensors, dims, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], *dims, stream)
    if err != 0:
        raise MXNetError("LSTM %s kernel launch failed: CUDA error %d"
                         % (what, err))


def lstm_infer_cuda(xp, w4, bh, h0, c0):
    """Launch kernel K4 on xp's card, on the current stream.  Returns
    ``(ys, hT, cT)``; raises on inputs the kernel does not take."""
    T, N, H = _check_fwd(xp, w4, bh, h0, c0)
    lib = _kernels.load("lstm")
    _work(lib, T, N, H, False, xp.device)
    ys = torch.empty((T, N, H), dtype=torch.float32, device=xp.device)
    hT, cT = torch.empty_like(h0), torch.empty_like(c0)
    _launch(_fn(lib, "mxtt_lstm_infer", 8), "inference forward",
            (xp, w4, bh, h0, c0, ys, hT, cT), (T, N, H), xp.device)
    launches.count(lstm_infer_cuda)
    return ys, hT, cT


def lstm_fwd_cuda(xp, w4, bh, h0, c0):
    """Launch kernel K5 on xp's card, on the current stream.  Returns
    ``(ys, gates, cs, hT, cT)``; raises on inputs the kernel does not
    take."""
    T, N, H = _check_fwd(xp, w4, bh, h0, c0)
    lib = _kernels.load("lstm")
    _work(lib, T, N, H, False, xp.device)
    ys = torch.empty((T, N, H), dtype=torch.float32, device=xp.device)
    gates = torch.empty_like(xp)
    cs = torch.empty_like(ys)
    hT, cT = torch.empty_like(h0), torch.empty_like(c0)
    _launch(_fn(lib, "mxtt_lstm_fwd", 10), "forward",
            (xp, w4, bh, h0, c0, ys, gates, cs, hT, cT), (T, N, H),
            xp.device)
    launches.count(lstm_fwd_cuda)
    return ys, gates, cs, hT, cT


def lstm_bwd_cuda(gates, cs, ys, w4, h0, c0, dys, dhT, dcT):
    """Launch kernel K6 on gates' card, on the current stream (the
    clustered recurrence, then the dw4/dbh product and, where its T*N axis
    is split, the fixed-order sum of the partial products).
    Returns ``(dxp, dw4, dbh, dh0, dc0)``; raises on inputs the kernel
    does not take."""
    T, N, H = _dims(gates)
    for name, t, shape in (("gates", gates, gates.shape),
                           ("cs", cs, (T, N, H)), ("ys", ys, (T, N, H)),
                           ("w4", w4, (4, H, H)), ("h0", h0, (N, H)),
                           ("c0", c0, (N, H)), ("dys", dys, (T, N, H)),
                           ("dhT", dhT, (N, H)), ("dcT", dcT, (N, H))):
        _check(name, t, gates, shape)
    lib = _kernels.load("lstm")
    work = _work(lib, T, N, H, True, gates.device)
    dxp = torch.empty_like(gates)
    dw4 = torch.empty_like(w4)
    dbh = torch.empty((4, H), dtype=torch.float32, device=gates.device)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
    _launch(_fn(lib, "mxtt_lstm_bwd", 15), "backward",
            (gates, cs, ys, w4, h0, c0, dys, dhT, dcT, dxp, dw4, dbh, dh0,
             dc0, work), (T, N, H), gates.device)
    launches.count(lstm_bwd_cuda)
    return dxp, dw4, dbh, dh0, dc0


def _plan(name, what, N, H, device):
    fn = getattr(_kernels.load("lstm"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 5)()
    with torch.cuda.device(device):
        err = fn(N, H, out)
    if err != 0:
        raise MXNetError("LSTM %s plan failed: CUDA error %d" % (what, err))
    return dict(zip(("rows", "slice", "w4_rows_in_smem", "clusters",
                     "smem_bytes"), out))


def lstm_fwd_plan(N, H, device):
    """How K4 and K5 lay out their recurrence for batch ``N`` and width
    ``H`` on ``device``: rows per cluster pass, slice width (columns per
    CTA), rows of the slice of w4 kept in shared memory, clusters
    launched, shared memory per CTA."""
    return _plan("mxtt_lstm_fwd_plan", "forward", N, H, device)


def lstm_bwd_plan(N, H, device):
    """How K6 lays out its recurrence for batch ``N`` and width ``H`` on
    ``device``: rows per cluster pass, slice width, rows of w4 per slice
    kept in shared memory, clusters launched, shared memory per CTA."""
    return _plan("mxtt_lstm_bwd_plan", "backward", N, H, device)


#: launches of kernels K4, K5 and K6 in this process (reset freely)
lstm_infer_cuda.launches = 0
lstm_fwd_cuda.launches = 0
lstm_bwd_cuda.launches = 0


def _route(x, cuda_fn, plain_fn):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    dev = x.device.type
    if dev == "cuda":
        return cuda_fn
    if dev == "cpu":
        return plain_fn
    raise MXNetError("LSTM: no implementation for device %s" % x.device)


class LSTMSeqFn(torch.autograd.Function):
    """``(xp, w4, bh, h0, c0) -> (ys, hT, cT)`` through K5, backward through
    K6 (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, xp, w4, bh, h0, c0):
        fwd = _route(xp, lstm_fwd_cuda, lstm_fwd_plain)
        ys, gates, cs, hT, cT = fwd(xp, w4, bh, h0, c0)
        ctx.save_for_backward(gates, cs, ys, w4, h0, c0)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        gates, cs, ys, w4, h0, c0 = ctx.saved_tensors
        # the kernel reads the cotangents in their own layout; autograd
        # hands a strided one only behind a view op, and then this is
        # the one copy
        bwd = _route(gates, lstm_bwd_cuda, lstm_bwd_plain)
        return bwd(gates, cs, ys, w4, h0, c0, dys.contiguous(),
                   dhT.contiguous(), dcT.contiguous())


def lstm_seq(xp, w4, bh, h0, c0):
    """Fused LSTM over a whole sequence: ``(ys (T, N, H), hT, cT)``.

    With no gradient needed the residual-free K4 runs; under autograd
    :class:`LSTMSeqFn` runs K5 and K6.  ``meta`` tensors (shape inference)
    give empty outputs of the right shapes."""
    T, N, H = xp.shape[0], xp.shape[2], xp.shape[3]
    if xp.device.type == "meta":
        return (torch.empty((T, N, H), dtype=xp.dtype, device="meta"),
                torch.empty((N, H), dtype=xp.dtype, device="meta"),
                torch.empty((N, H), dtype=xp.dtype, device="meta"))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp, w4, bh, h0, c0)):
        return LSTMSeqFn.apply(xp, w4, bh, h0, c0)
    return _route(xp, lstm_infer_cuda, lstm_infer_plain)(xp, w4, bh, h0, c0)
