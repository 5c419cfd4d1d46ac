"""The port's decode-capable transformer LM
(``mxnet_tpu_torch.models.transformer_lm``) against the JAX package's on
the CPU: the same ``init_params(seed)`` floats, the seven model functions
within ``rtol=atol=1e-5`` (the port keeps K/V head-major, so its caches
are compared transposed), and the npz blob in both directions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.models import transformer_lm as jtlm
from mxnet_tpu_torch.models import transformer_lm as ttlm

#: the JAX decode tests' tiny LM (tests/test_decode.py)
WIDTHS = (32, 16, 2, 2, 32, 32)
JCFG = jtlm.LMConfig(*WIDTHS, eos_id=32)
TCFG = ttlm.LMConfig(*WIDTHS, eos_id=32)
TOL = dict(rtol=1e-5, atol=1e-5)


def _params(seed=3, scale=None):
    """Both packages' parameters from one seed; ``scale`` multiplies the
    FFN's input weights in both (large pre-activations for the GELU)."""
    jp, tp = jtlm.init_params(JCFG, seed=seed), ttlm.init_params(TCFG,
                                                                 seed=seed)
    if scale is not None:
        jp["blocks"]["up_w"] = jp["blocks"]["up_w"] * scale
        tp["blocks"]["up_w"] = tp["blocks"]["up_w"] * scale
    return jp, tp


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _flat(params):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({"%s.%s" % (k, k2): _np(v2) for k2, v2 in v.items()})
        else:
            out[k] = _np(v)
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_are_the_jax_floats_bit_for_bit(seed):
    j, t = _params(seed)
    fj, ft = _flat(j), _flat(t)
    assert sorted(fj) == sorted(ft)
    for k in fj:
        assert fj[k].dtype == ft[k].dtype == np.float32
        assert np.array_equal(fj[k], ft[k]), k


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_blobs_cross_between_packages(writer):
    j, t = _params()
    if writer == "jax":
        cfg, params = ttlm.params_from_blob(jtlm.params_to_blob(JCFG, j))
        assert tuple(cfg) == tuple(JCFG)
        ref = _flat(j)
    else:
        cfg, params = jtlm.params_from_blob(ttlm.params_to_blob(TCFG, t))
        assert tuple(cfg) == tuple(TCFG)
        ref = _flat(t)
    got = _flat(params)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k


def test_init_params_rejects_indivisible_heads():
    with pytest.raises(ValueError, match="divisible"):
        ttlm.init_params(ttlm.LMConfig(32, 15, 2, 1, 8, 8, 32))


@pytest.mark.parametrize("scale", [None, 40.0])
def test_forward_logits_matches_jax(scale):
    j, t = _params(scale=scale)
    toks = np.random.RandomState(1).randint(0, 32, (3, 11)).astype(np.int32)
    want = np.asarray(jtlm.forward_logits(JCFG, j, jnp.asarray(toks)))
    got = _np(ttlm.forward_logits(TCFG, t, toks))
    np.testing.assert_allclose(got, want, **TOL)


def test_erf_gelu_would_miss_the_tolerance(monkeypatch):
    """The JAX package's bare ``jax.nn.gelu`` is the tanh form; at large
    pre-activations torch's default erf form leaves the tolerance, so the
    parity above holds only because the port asks for tanh."""
    j, t = _params(scale=40.0)
    toks = np.random.RandomState(1).randint(0, 32, (3, 11)).astype(np.int32)
    want = np.asarray(jtlm.forward_logits(JCFG, j, jnp.asarray(toks)))
    erf = torch.nn.functional.gelu

    class _Erf:
        @staticmethod
        def gelu(x, approximate="none"):
            return erf(x)

    monkeypatch.setattr(ttlm, "F", _Erf)
    got = _np(ttlm.forward_logits(TCFG, t, toks))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("scale", [None, 40.0])
@pytest.mark.parametrize("length,bucket", [(5, 8), (8, 8), (1, 4)])
def test_prefill_kv_matches_jax(scale, length, bucket):
    j, t = _params(scale=scale)
    toks = np.zeros(bucket, np.int32)
    toks[:length] = np.random.RandomState(2).randint(0, 32, length)
    lj, kj, vj = jtlm.prefill_kv(JCFG, j, jnp.asarray(toks), length)
    lt, kt, vt = ttlm.prefill_kv(TCFG, t, toks, length)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **TOL)
    for l in range(TCFG.layers):
        # the port's rows are (heads, P, head_dim); JAX's (P, heads, hd)
        np.testing.assert_allclose(_np(kt[l]).transpose(1, 0, 2),
                                   np.asarray(kj[l]), **TOL)
        np.testing.assert_allclose(_np(vt[l]).transpose(1, 0, 2),
                                   np.asarray(vj[l]), **TOL)


def _caches(rs, shape_jax):
    """Random per-layer caches in JAX's layout and the port's stacked
    head-major one (``(S|NB, M|BS, H, D)`` -> ``(L, H, S|NB, M|BS, D)``)."""
    a = rs.normal(size=(TCFG.layers,) + shape_jax).astype(np.float32)
    return (tuple(jnp.asarray(a[l]) for l in range(TCFG.layers)),
            torch.from_numpy(a.transpose(0, 3, 1, 2, 4).copy()))


def _to_jax_layout(t):
    return _np(t).transpose(1, 2, 0, 3)


@pytest.mark.parametrize("scale", [None, 40.0])
def test_decode_step_math_matches_jax(scale):
    j, t = _params(scale=scale)
    rs = np.random.RandomState(4)
    s, hd = 5, TCFG.embed // TCFG.heads
    jk, tk = _caches(rs, (s, TCFG.max_len, TCFG.heads, hd))
    jv, tv = _caches(rs, (s, TCFG.max_len, TCFG.heads, hd))
    last = rs.randint(0, 32, s).astype(np.int32)
    # a slot at 0, one at the last position, one past it (clamped)
    lens = np.array([0, 7, 19, 31, 40], np.int32)
    lj, nkj, nvj = jtlm.decode_step_math(JCFG, j, jk, jv, jnp.asarray(last),
                                         jnp.asarray(lens))
    lt, nkt, nvt = ttlm.decode_step_math(
        TCFG, t, tk, tv, torch.from_numpy(last).long(),
        torch.from_numpy(lens).long())
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **TOL)
    assert nkt is tk and nvt is tv          # written in place
    for l in range(TCFG.layers):
        np.testing.assert_allclose(_to_jax_layout(tk[l]),
                                   np.asarray(nkj[l]), **TOL)
        np.testing.assert_allclose(_to_jax_layout(tv[l]),
                                   np.asarray(nvj[l]), **TOL)


@pytest.mark.parametrize("block_size", [4, 5])
def test_decode_step_paged_matches_jax(block_size):
    """Block sizes that divide max_len and one that does not (the gather
    is cut to max_len)."""
    j, t = _params()
    rs = np.random.RandomState(5)
    hd = TCFG.embed // TCFG.heads
    mb = -(-TCFG.max_len // block_size)
    s, nb = 3, 3 * mb + 1
    jk, tk = _caches(rs, (nb, block_size, TCFG.heads, hd))
    jv, tv = _caches(rs, (nb, block_size, TCFG.heads, hd))
    tables = np.zeros((s, mb), np.int32)
    tables[0] = 1 + np.arange(mb)
    tables[1, :3] = [mb + 1, mb + 2, mb + 3]
    # slot 2 inactive: an all-zero table (the scratch block)
    last = rs.randint(0, 32, s).astype(np.int32)
    lens = np.array([20, 2 * block_size - 1, 4], np.int32)
    lj, pkj, pvj = jtlm.decode_step_paged(
        JCFG, j, jk, jv, jnp.asarray(tables), jnp.asarray(last),
        jnp.asarray(lens))
    lt, _, _ = ttlm.decode_step_paged(
        TCFG, t, tk, tv, torch.from_numpy(tables).long(),
        torch.from_numpy(last).long(), torch.from_numpy(lens).long())
    np.testing.assert_allclose(_np(lt)[:2], np.asarray(lj)[:2], **TOL)
    for l in range(TCFG.layers):
        # the scratch block's contents depend on the write order of the
        # rows that collide there; every other block must agree
        np.testing.assert_allclose(_to_jax_layout(tk[l])[1:],
                                   np.asarray(pkj[l])[1:], **TOL)
        np.testing.assert_allclose(_to_jax_layout(tv[l])[1:],
                                   np.asarray(pvj[l])[1:], **TOL)


@pytest.mark.parametrize("start,n_real,bucket", [(0, 6, 8), (9, 13, 8),
                                                 (16, 20, 4)])
def test_prefill_kv_paged_matches_jax(start, n_real, bucket):
    """A cold prefill and prefix hits (the suffix at ``start``)."""
    j, t = _params()
    rs = np.random.RandomState(6)
    hd = TCFG.embed // TCFG.heads
    bs, mb = 4, TCFG.max_len // 4
    nb = mb + 2
    jk, tk = _caches(rs, (nb, bs, TCFG.heads, hd))
    jv, tv = _caches(rs, (nb, bs, TCFG.heads, hd))
    table = np.zeros(mb, np.int32)
    used = -(-(n_real + 1) // bs)
    table[:used] = 1 + np.arange(used)
    toks = np.zeros(bucket, np.int32)
    toks[:n_real - start] = rs.randint(0, 32, n_real - start)
    lj, pkj, pvj = jtlm.prefill_kv_paged(
        JCFG, j, jk, jv, jnp.asarray(table), jnp.asarray(toks), start,
        n_real)
    lt, _, _ = ttlm.prefill_kv_paged(TCFG, t, tk, tv, table, toks, start,
                                     n_real)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **TOL)
    for l in range(TCFG.layers):
        np.testing.assert_allclose(_to_jax_layout(tk[l])[1:],
                                   np.asarray(pkj[l])[1:], **TOL)


@pytest.mark.parametrize("block_size", [4, 5])
def test_dense_and_paged_steps_are_bit_identical_on_the_cpu(block_size):
    """The same cache contents through the dense cache and through block
    tables give the same logits bit for bit, step after step: both
    attend on operands of one shape and layout.  (The two prefills attend
    over different key counts, P against max_len, so their K/V may differ
    in the last bit; the streams are then held by the token rule.)"""
    _, t = _params()
    rs = np.random.RandomState(7)
    hd = TCFG.embed // TCFG.heads
    s, bs = 3, block_size
    mb = -(-TCFG.max_len // bs)
    ck = torch.zeros((TCFG.layers, TCFG.heads, s, TCFG.max_len, hd))
    cv = torch.zeros_like(ck)
    pk = torch.zeros((TCFG.layers, TCFG.heads, s * mb + 1, bs, hd))
    pv = torch.zeros_like(pk)
    tables = (1 + torch.arange(s * mb)).reshape(s, mb)
    last, lens = [], []
    for i, n in enumerate((3, 9, 14)):
        toks = rs.randint(0, 32, n)
        lg, ks, vs = ttlm.prefill_kv(TCFG, t, toks, n)
        ck[:, :, i, :n] = torch.stack(ks)
        cv[:, :, i, :n] = torch.stack(vs)
        for b in range(-(-n // bs)):
            m = min(bs, n - b * bs)
            pk[:, :, tables[i, b], :m] = ck[:, :, i, b * bs:b * bs + m]
            pv[:, :, tables[i, b], :m] = cv[:, :, i, b * bs:b * bs + m]
        last.append(int(lg.argmax()))
        lens.append(n)
    lt, ln = torch.tensor(last), torch.tensor(lens)
    for _ in range(3):
        dense, _, _ = ttlm.decode_step_math(TCFG, t, ck, cv, lt, ln)
        paged, _, _ = ttlm.decode_step_paged(TCFG, t, pk, pv, tables, lt, ln)
        assert torch.equal(dense, paged)
        lt, ln = dense.argmax(-1), ln + 1
