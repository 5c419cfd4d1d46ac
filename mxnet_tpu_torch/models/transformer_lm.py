"""Decode-capable transformer LM, the served autoregressive workload
(counterpart of ``mxnet_tpu/models/transformer_lm.py``).

A compact decoder-only transformer (RMSNorm, no biases, tanh GELU) whose
forward is split along the line a continuous-batching server needs:

* :func:`prefill_kv` runs one prompt and returns its last-token logits
  plus the per-layer K/V rows that seed a slot of the engine's cache;
* :func:`decode_step_math` advances ALL ``S`` cache slots by one token:
  it writes the incoming token's K/V into each slot's cache row in place,
  attends over ``positions <= length`` and returns ``(S, vocab)`` logits;
* :func:`prefill_kv_paged` / :func:`decode_step_paged` are the same math
  through per-slot block tables over shared K/V pools
  (:mod:`mxnet_tpu_torch.serving.kvblocks` owns the bookkeeping);
* :func:`forward_logits` is the teacher-forcing forward, the ground truth
  the decode path is held to (greedy decode equals its argmax).

Plain functions on tensors: each computes on the device of its inputs.
:func:`init_params` draws from ``np.random.RandomState(seed)`` exactly as
the JAX package does, so both packages start from the same floats, and
:func:`params_to_blob` writes the JAX package's npz blob.

**K/V layout.** The JAX package keeps a layer's cache as ``(S, max_len,
heads, head_dim)`` and its pool as ``(num_blocks, block_size, heads,
head_dim)``.  The port keeps them head-major, ``(heads, S, max_len,
head_dim)`` and ``(heads, num_blocks, block_size, head_dim)``, so one
step's attention is a batched product over (head, slot) on the cache as
it lies, without a transposed copy of it; a prefill returns its K/V rows
as ``(heads, P, head_dim)``.  The numbers are the same.  The cache
arguments are per-layer sequences: a tuple of tensors or one stacked
``(layers, ...)`` tensor, which the engine uses so that each step writes
one tensor in place.
"""

from __future__ import annotations

import io
import json
import math
from collections import namedtuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["LMConfig", "init_params", "forward_logits", "prefill_kv",
           "decode_step_math", "prefill_kv_paged", "decode_step_paged",
           "params_to_blob", "params_from_blob", "params_to"]

#: model hyperparameters; ``max_len`` bounds the KV cache (prompt plus
#: generated length), ``eos_id`` is the token that retires a sequence early
LMConfig = namedtuple("LMConfig", ["vocab", "embed", "heads", "layers",
                                   "ffn", "max_len", "eos_id"])

#: the attention mask's fill, as in the JAX package
_NEG = -1e30


def init_params(cfg, seed=0, dtype=torch.float32):
    """Host parameter dict (the caller moves it where the replica lives,
    :func:`params_to`); per-layer weights are stacked on axis 0.  Draws
    the JAX package's numbers, in its order."""
    if cfg.embed % cfg.heads:
        raise ValueError("embed=%d not divisible by heads=%d"
                         % (cfg.embed, cfg.heads))
    rs = np.random.RandomState(seed)

    def nrm(*shape, s=0.05):
        return torch.from_numpy(
            rs.normal(0, s, shape).astype(np.float32)).to(dtype)

    L, E, F_ = cfg.layers, cfg.embed, cfg.ffn
    return {
        "embed": nrm(cfg.vocab, E),
        "pos": nrm(cfg.max_len, E),
        "head": nrm(E, cfg.vocab),
        "ln_f": torch.ones((E,), dtype=dtype),
        "blocks": {
            "ln1": torch.ones((L, E), dtype=dtype),
            "qkv_w": nrm(L, E, 3 * E),
            "out_w": nrm(L, E, E),
            "ln2": torch.ones((L, E), dtype=dtype),
            "up_w": nrm(L, E, F_),
            "down_w": nrm(L, F_, E),
        },
    }


def params_to(params, device):
    """The parameter dict with every tensor on ``device`` (tensors already
    there are shared, not copied)."""
    return {k: (params_to(v, device) if isinstance(v, dict)
                else torch.as_tensor(v).to(device))
            for k, v in params.items()}


def _device(params):
    return params["embed"].device


def _ids(tokens, device):
    return torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens)
                           else tokens, device=device).long()


def _rmsnorm(x, g):
    return x * g * torch.rsqrt((x.float() ** 2).mean(-1, keepdim=True)
                               + 1e-6).to(x.dtype)


def _layer(blocks, l):
    return {k: v[l] for k, v in blocks.items()}


def _ffn(x, p):
    h = _rmsnorm(x, p["ln2"])
    return x + F.gelu(h @ p["up_w"], approximate="tanh") @ p["down_w"]


def _logits(cfg, params, x):
    return (_rmsnorm(x, params["ln_f"]) @ params["head"]).float()


def forward_logits(cfg, params, tokens):
    """Teacher-forcing forward: ``tokens (B, T)`` -> ``(B, T, vocab)``
    float32 logits, the decode-parity ground truth."""
    dev = _device(params)
    tokens = _ids(tokens, dev)
    b, t = tokens.shape
    pos = torch.arange(t, device=dev)
    x = params["embed"][tokens] + params["pos"][pos][None]
    causal = pos[None, :] <= pos[:, None]            # (q, k)
    hd = cfg.embed // cfg.heads
    scale = 1.0 / math.sqrt(hd)
    for l in range(cfg.layers):
        p = _layer(params["blocks"], l)
        qkv = _rmsnorm(x, p["ln1"]) @ p["qkv_w"]
        q, k, v = (a.reshape(b, t, cfg.heads, hd).transpose(1, 2)
                   for a in qkv.split(cfg.embed, dim=-1))
        scores = (q @ k.transpose(-1, -2)) * scale     # (b, h, q, k)
        att = torch.softmax(torch.where(causal, scores, _NEG), dim=-1)
        ctx = (att @ v).transpose(1, 2).reshape(b, t, cfg.embed)
        x = _ffn(x + ctx @ p["out_w"], p)
    return _logits(cfg, params, x)


def _qkv(cfg, x, p):
    """``x (n, E)`` -> q, k, v as ``(heads, n, head_dim)``."""
    n = x.shape[0]
    qkv = _rmsnorm(x, p["ln1"]) @ p["qkv_w"]
    return [a.reshape(n, cfg.heads, -1).transpose(0, 1)
            for a in qkv.split(cfg.embed, dim=-1)]


def _attend(q, ck, cv, mask, scale):
    """Attention of ``q (H, B, n, D)`` over ``ck``/``cv (H, B, m, D)``
    under ``mask`` (broadcast to ``(H, B, n, m)``): ``(H, B, n, D)``.
    The decode step and its paged twin both come here, on operands of
    one layout, so they compute the same floats."""
    scores = (q @ ck.transpose(-1, -2)) * scale
    att = torch.softmax(torch.where(mask, scores, _NEG), dim=-1)
    return att @ cv


def _merge_heads(ctx):
    """``(H, n, D)`` -> ``(n, H*D)``."""
    return ctx.transpose(0, 1).reshape(ctx.shape[1], -1)


def prefill_kv(cfg, params, tokens, length):
    """One prompt through the model: ``tokens (P,)`` (bucket-padded,
    ``length`` real tokens) -> ``(last_logits (vocab,), ks, vs)`` where
    ``ks``/``vs`` are per-layer lists of ``(heads, P, head_dim)`` cache
    rows for positions ``0..P-1``.  Rows past ``length`` hold pad-token
    K/V, which the decode mask never reads before a step overwrites them.
    ``length`` is a host integer."""
    dev = _device(params)
    tokens = _ids(tokens, dev)
    (p,) = tokens.shape
    pos = torch.arange(p, device=dev)
    x = params["embed"][tokens] + params["pos"][pos]
    causal = pos[None, :] <= pos[:, None]
    scale = 1.0 / math.sqrt(cfg.embed // cfg.heads)
    ks, vs = [], []
    for l in range(cfg.layers):
        pl = _layer(params["blocks"], l)
        q, k, v = _qkv(cfg, x, pl)
        ctx = _attend(q, k, v, causal, scale)
        x = _ffn(x + _merge_heads(ctx) @ pl["out_w"], pl)
        ks.append(k)
        vs.append(v)
    logits = _logits(cfg, params, x)
    return logits[min(max(int(length) - 1, 0), p - 1)], ks, vs


def _step_embed(cfg, params, last_tok, lengths):
    pos = lengths.clamp(0, cfg.max_len - 1)
    return params["embed"][last_tok] + params["pos"][pos], pos


def _step_layers(cfg, params, x, pos, caches):
    """The layer loop of a decode step; ``caches(l, k, v)`` writes slot
    rows ``k``/``v (heads, S, head_dim)`` of layer ``l`` in place and
    returns the layer's ``(heads, S, m, head_dim)`` K and V to attend."""
    scale = 1.0 / math.sqrt(cfg.embed // cfg.heads)
    kpos = torch.arange(cfg.max_len, device=x.device)
    mask = (kpos[None, :] <= pos[:, None])[None, :, None, :]
    for l in range(cfg.layers):
        pl = _layer(params["blocks"], l)
        q, k, v = _qkv(cfg, x, pl)
        ck, cv = caches(l, k, v)
        ctx = _attend(q[:, :, None], ck, cv, mask, scale)[:, :, 0]
        x = _ffn(x + _merge_heads(ctx) @ pl["out_w"], pl)
    return _logits(cfg, params, x)


def decode_step_math(cfg, params, cache_k, cache_v, last_tok, lengths):
    """One decode token for all ``S`` slots.

    ``cache_k``/``cache_v``: per layer ``(heads, S, max_len, head_dim)``,
    written in place; ``last_tok (S,)`` is each slot's newest token;
    ``lengths (S,)`` each slot's cache fill, the position the incoming
    token's K/V goes to and the inclusive attention horizon.  Returns
    ``(logits (S, vocab), cache_k, cache_v)``.  Inactive slots ride along
    at fixed shape: their row is unreachable under the mask until a real
    write replaces it.  No host read, no host branch on device values."""
    x, pos = _step_embed(cfg, params, last_tok, lengths)
    rows = torch.arange(x.shape[0], device=x.device)

    def caches(l, k, v):
        ck, cv = cache_k[l], cache_v[l]
        ck[:, rows, pos] = k
        cv[:, rows, pos] = v
        return ck, cv

    return _step_layers(cfg, params, x, pos, caches), cache_k, cache_v


def _gathered(pool, tables, m):
    """Pool rows named by ``tables (S, max_blocks)`` as one ``(heads, S,
    m, head_dim)`` tensor (materialised, as JAX's ``pk[tables]`` is)."""
    h, _nb, bs, d = pool.shape
    s, mb = tables.shape
    return pool[:, tables].reshape(h, s, mb * bs, d)[:, :, :m].contiguous()


def prefill_kv_paged(cfg, params, pool_k, pool_v, table, tokens, start,
                     length):
    """Suffix prefill through a block table, the paged twin of
    :func:`prefill_kv`.

    ``pool_k``/``pool_v``: per layer ``(heads, num_blocks, block_size,
    head_dim)``, written in place; ``table (max_blocks,)`` maps the slot's
    logical blocks to pool rows (0 is the scratch block unallocated
    entries point to).  ``tokens (P,)`` is the bucket-padded transcript
    suffix at absolute positions ``start .. start+P-1``: ``start > 0`` is
    a prefix-cache hit whose shared positions are only gathered, never
    recomputed.  ``length`` is the absolute transcript length (host
    integers both).  Returns ``(last_logits (vocab,), pool_k, pool_v)``."""
    dev = _device(params)
    tokens = _ids(tokens, dev)
    table = _ids(table, dev)
    (p,) = tokens.shape
    bs = pool_k[0].shape[2]
    m = cfg.max_len
    scale = 1.0 / math.sqrt(cfg.embed // cfg.heads)
    pos = int(start) + torch.arange(p, device=dev)
    posc = pos.clamp(0, m - 1)          # only pad rows ever clamp
    blk = table[posc // bs]
    off = posc % bs
    x = params["embed"][tokens] + params["pos"][posc]
    kpos = torch.arange(m, device=dev)
    mask = kpos[None, :] <= pos[:, None]
    for l in range(cfg.layers):
        pl = _layer(params["blocks"], l)
        q, k, v = _qkv(cfg, x, pl)
        pk, pv = pool_k[l], pool_v[l]
        pk[:, blk, off] = k
        pv[:, blk, off] = v
        ck = _gathered(pk, table[None], m)[:, 0]
        cv = _gathered(pv, table[None], m)[:, 0]
        ctx = _attend(q, ck, cv, mask, scale)
        x = _ffn(x + _merge_heads(ctx) @ pl["out_w"], pl)
    logits = _logits(cfg, params, x)
    return (logits[min(max(int(length) - 1 - int(start), 0), p - 1)],
            pool_k, pool_v)


def decode_step_paged(cfg, params, pool_k, pool_v, tables, last_tok,
                      lengths):
    """One decode token for all ``S`` slots through per-slot block tables
    ``(S, max_blocks)``, the paged twin of :func:`decode_step_math`: the
    incoming K/V goes to the block covering position ``lengths`` (the
    engine allocates it first), the slot's table is gathered and cut to
    ``max_len``, and attention proceeds as the dense step's, on operands
    of the same shape and layout.  Inactive slots hold all-zero tables:
    they write the scratch block and read mask-dead lanes."""
    x, pos = _step_embed(cfg, params, last_tok, lengths)
    rows = torch.arange(x.shape[0], device=x.device)
    bs = pool_k[0].shape[2]
    wblk = tables[rows, pos // bs]
    woff = pos % bs

    def caches(l, k, v):
        pk, pv = pool_k[l], pool_v[l]
        pk[:, wblk, woff] = k
        pv[:, wblk, woff] = v
        return (_gathered(pk, tables, cfg.max_len),
                _gathered(pv, tables, cfg.max_len))

    return _step_layers(cfg, params, x, pos, caches), pool_k, pool_v


def params_to_blob(cfg, params):
    """Serialize ``(cfg, params)`` to the JAX package's npz blob (the
    serving publish payload); either package loads the other's."""
    flat = {"__config__": np.frombuffer(
        json.dumps(cfg._asdict()).encode(), np.uint8)}
    for k, v in params.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                flat["%s.%s" % (k, k2)] = v2.detach().cpu().numpy()
        else:
            flat[k] = v.detach().cpu().numpy()
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def params_from_blob(blob):
    """Inverse of :func:`params_to_blob`: ``(cfg, params)`` with host
    tensors."""
    with np.load(io.BytesIO(blob)) as z:
        cfg = LMConfig(**json.loads(bytes(z["__config__"]).decode()))
        params = {"blocks": {}}
        for k in z.files:
            if k == "__config__":
                continue
            if k.startswith("blocks."):
                params["blocks"][k.split(".", 1)[1]] = \
                    torch.from_numpy(np.array(z[k]))
            else:
                params[k] = torch.from_numpy(np.array(z[k]))
    return cfg, params
