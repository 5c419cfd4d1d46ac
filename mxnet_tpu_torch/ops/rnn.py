"""The fused multi-layer ``RNN`` op and ``_rnn_begin_state``, counterpart
of ``mxnet_tpu/ops/rnn.py``.

* The input projection of a whole layer is one matmul over the full
  ``(T*N, I)`` activation (``torch.matmul``, cuBLAS on the card); only the
  ``h @ Wh`` recurrence runs step by step.  For ``lstm`` the recurrence is
  :func:`~mxnet_tpu_torch.ops.rnn_kernel.lstm_seq`: kernels K4 (no
  gradient) or K5 and K6 (under autograd) on the card, their plain
  versions on the CPU, for every layer and every sequence length.  The
  JAX package runs its Pallas kernels only when ``MXNET_RNN_PALLAS=1``
  and its VMEM gate admits the shape; the port routes by device only.
* ``gru``, ``rnn_tanh`` and ``rnn_relu`` are plain step loops, as the
  JAX package has no kernel for them either.
* Bidirectional: the same recurrence over a time-flipped copy, outputs
  concatenated on the feature axis.
* Parameter blob layout: for each layer, for each direction,
  ``[Wx (G*H, I), Wh (G*H, H), bx (G*H), bh (G*H)]`` flattened and
  concatenated (the JAX package's, so blobs carry across as they are).
  Gate order: LSTM ``i, f, g, o``; GRU ``r, z, n``.

Data layout is time-major ``(T, N, C)``.  Dropout between layers
(``p > 0`` in training): the input of every layer after the first (the
directions concatenated) goes through ``nn.dropout``, drawn from
``mx.random``'s generator of the device, as torch ops before that
layer's input projection (on the card each LSTM layer still runs K5 and
K6); in inference it is the identity, as in
``mxnet_tpu/ops/rnn.py:157-163``.
"""

from __future__ import annotations

import torch

from ..base import MXNetError
from .nn import dropout
from .registry import REQUIRED, pbool, pfloat, pint, pstr, ptuple, register
from .rnn_kernel import lstm_seq

__all__ = ["rnn_param_size"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(input_size, state_size, num_layers, mode,
                   bidirectional=False):
    """Total length of the flat parameter blob."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    total = 0
    for layer in range(num_layers):
        i = input_size if layer == 0 else h * d
        total += d * (g * h * i + g * h * h + 2 * g * h)
    return total


def _layer_param_slices(input_size, state_size, num_layers, mode,
                        bidirectional):
    """[(layer, direction, {"wx"|"wh"|"bx"|"bh": (offset, shape)})], the
    blob layout."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    off = 0
    out = []
    for layer in range(num_layers):
        i = input_size if layer == 0 else h * d
        for direction in range(d):
            sl = {}
            sl["wx"] = (off, (g * h, i)); off += g * h * i
            sl["wh"] = (off, (g * h, h)); off += g * h * h
            sl["bx"] = (off, (g * h,)); off += g * h
            sl["bh"] = (off, (g * h,)); off += g * h
            out.append((layer, direction, sl))
    return out


def _take(params, spec):
    off, shape = spec
    n = 1
    for s in shape:
        n *= s
    return params[off:off + n].reshape(shape)


def _lstm_layer(xproj, wh, bh, h0, c0):
    """The recurrence in the kernels' layout (``rnn_pallas.py``'s, as
    ``mxnet_tpu/ops/rnn.py:97-99`` builds it)."""
    T, N = xproj.shape[0], xproj.shape[1]
    H = h0.shape[-1]
    xp4 = xproj.reshape(T, N, 4, H).permute(0, 2, 1, 3).contiguous()
    w4 = wh.t().reshape(H, 4, H).permute(1, 0, 2).contiguous()
    return lstm_seq(xp4, w4, bh.reshape(4, H), h0.contiguous(),
                    c0.contiguous())


def _scan_layer(x, wx, wh, bx, bh, h0, c0, mode):
    """One direction of one layer. x: (T, N, I) -> (ys (T, N, H), hT,
    cT or None)."""
    xproj = torch.matmul(x, wx.t()) + bx  # one big matmul
    if mode == "lstm":
        return _lstm_layer(xproj, wh, bh, h0, c0)
    h = h0
    ys = []
    if mode == "gru":
        for t in range(xproj.shape[0]):
            hproj = torch.matmul(h, wh.t()) + bh
            xr, xz, xn = torch.chunk(xproj[t], 3, dim=-1)
            hr, hz, hn = torch.chunk(hproj, 3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            ys.append(h)
        return torch.stack(ys), h, None
    act = torch.relu if mode == "rnn_relu" else torch.tanh
    for t in range(xproj.shape[0]):
        h = act(xproj[t] + torch.matmul(h, wh.t()) + bh)
        ys.append(h)
    return torch.stack(ys), h, None


def _rnn(attrs, inputs, aux, is_train):
    mode = attrs["mode"]
    if mode not in _GATES:
        raise MXNetError("RNN: bad mode %r" % mode)
    lstm = mode == "lstm"
    x, params, state = inputs[0], inputs[1], inputs[2]
    state_cell = inputs[3] if lstm else None
    num_layers = attrs["num_layers"]
    h = attrs["state_size"]
    bidir = attrs["bidirectional"]
    d = 2 if bidir else 1
    p = attrs["p"]

    layout = _layer_param_slices(x.shape[2], h, num_layers, mode, bidir)
    cur = x
    hs, cs = [], []
    for layer in range(num_layers):
        if layer > 0 and is_train and p > 0.0:
            cur = dropout(cur, p)
        outs = []
        for direction in range(d):
            sl = layout[layer * d + direction][2]
            wx, wh = _take(params, sl["wx"]), _take(params, sl["wh"])
            bx, bh = _take(params, sl["bx"]), _take(params, sl["bh"])
            idx = layer * d + direction
            h0 = state[idx]
            c0 = state_cell[idx] if lstm else None
            xin = cur if direction == 0 else torch.flip(cur, dims=(0,))
            ys, hT, cT = _scan_layer(xin, wx, wh, bx, bh, h0, c0, mode)
            if direction == 1:
                ys = torch.flip(ys, dims=(0,))
            outs.append(ys)
            hs.append(hT)
            if lstm:
                cs.append(cT)
        cur = outs[0] if d == 1 else torch.cat(outs, dim=-1)

    result = [cur]
    if attrs["state_outputs"]:
        result.append(torch.stack(hs, dim=0))
        if lstm:
            result.append(torch.stack(cs, dim=0))
    return result


def _rnn_begin_state(attrs, inputs, aux, is_train):
    """Zeros of ``shape`` with the 0 entry replaced by the data's batch
    dimension (``batch_axis``): how ``mx.rnn`` cells derive their default
    begin state from the data symbol."""
    data = inputs[0]
    n = data.shape[attrs["batch_axis"]]
    shape = tuple(n if s == 0 else s for s in attrs["shape"])
    return [torch.zeros(shape, dtype=data.dtype, device=data.device)]


register("_rnn_begin_state", _rnn_begin_state, arguments=("data",),
         params={"shape": (ptuple, REQUIRED), "batch_axis": (pint, 0)},
         hint="rnn_begin_state")


register(
    "RNN", _rnn,
    arguments=lambda a: (["data", "parameters", "state", "state_cell"]
                         if a["mode"] == "lstm"
                         else ["data", "parameters", "state"]),
    outputs=lambda a: (["output"]
                       + (["state"] if a["state_outputs"] else [])
                       + (["state_cell"]
                          if a["state_outputs"] and a["mode"] == "lstm"
                          else [])),
    params={"state_size": (pint, REQUIRED), "num_layers": (pint, REQUIRED),
            "mode": (pstr, REQUIRED), "bidirectional": (pbool, False),
            "p": (pfloat, 0.0), "state_outputs": (pbool, False),
            "pkeep_": (pfloat, 1.0), "lstm_q_": (pbool, False)},
    hint="rnn", draws=True)
