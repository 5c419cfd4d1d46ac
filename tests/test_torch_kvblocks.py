"""The port's paged-KV bookkeeping (``mxnet_tpu_torch.serving.kvblocks``)
against the JAX package's: one sequence of admissions, boundary appends,
releases, prefix offers and evictions gives the same block tables,
refcounts, free lists and prefix hits in both, and the allocator and
prefix cache keep the JAX package's unit contract."""

import numpy as np
import pytest

from mxnet_tpu.models import transformer_lm as jtlm
from mxnet_tpu.serving import kvblocks as jkv
from mxnet_tpu_torch import telemetry as ttelemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer_lm as ttlm
from mxnet_tpu_torch.serving import kvblocks as tkv

WIDTHS = (32, 16, 2, 2, 32, 32)


def _pools(**kw):
    return (jkv.KVBlockPool(jtlm.LMConfig(*WIDTHS, eos_id=32), 4, **kw),
            tkv.KVBlockPool(ttlm.LMConfig(*WIDTHS, eos_id=32), 4, **kw))


def _state(pool):
    a = pool.allocator
    return {"tables": pool.tables.tolist(),
            "free": list(a._free), "ref": dict(sorted(a._ref.items())),
            "hits": pool.prefix_hits, "reused": pool.prefix_tokens_reused,
            "cow": pool.cow_copies, "entries": len(pool.cache),
            "evictions": pool.cache.evictions,
            "describe": pool.describe()}


def _drive(pool, ops):
    """Apply ``ops`` to ``pool``; each op's outcome (plan, append result or
    the exception's class name) is recorded."""
    out = []
    for op, *args in ops:
        try:
            if op == "admit":
                plan = pool.admit(args[0], np.asarray(args[1], np.int32))
                out.append(tuple(plan))
            elif op == "append":
                out.append(pool.append(*args))
            elif op == "release":
                out.append(pool.release(*args))
            elif op == "offer":
                out.append(pool.offer(args[0], np.asarray(args[1],
                                                          np.int32)))
            elif op == "evict":
                out.append(pool.cache.evict_for(*args))
        except Exception as e:  # noqa: broad-except — compared by class
            out.append(type(e).__name__)
        out.append(_state(pool))
    return out


_RS = np.random.RandomState(0)
PREFIX = [int(x) for x in _RS.randint(0, 32, 11)]
OPS = [
    ("admit", 0, PREFIX + [1, 2]),
    ("offer", 0, PREFIX + [1, 2]),
    ("append", 0, 13), ("append", 0, 14), ("append", 0, 16),
    # shares PREFIX: two full blocks by reference, a partial tail COW
    ("admit", 1, PREFIX + [3]),
    ("offer", 1, PREFIX + [3]),
    ("append", 1, 12), ("append", 1, 15),
    # the identical prompt resubmitted hits at n-1
    ("admit", 2, PREFIX + [1, 2]),
    ("release", 0),
    ("admit", 3, [int(x) for x in _RS.randint(0, 32, 20)]),
    ("append", 3, 20), ("append", 3, 24),
    ("release", 1), ("release", 2),
    ("admit", 0, [int(x) for x in _RS.randint(0, 32, 30)]),
    ("evict", 30),
    ("admit", 1, PREFIX + [1, 2, 5]),
    ("release", 3), ("release", 0), ("release", 1),
]


@pytest.mark.parametrize("kw", [
    {"block_size": 4},
    {"block_size": 4, "num_blocks": 14},       # oversubscribed: evictions
    {"block_size": 5, "num_blocks": 12},       # and typed exhaustion
    {"block_size": 4, "prefix_cache": False},
])
def test_same_ops_same_tables_refcounts_and_hits(kw):
    jpool, tpool = _pools(**kw)
    assert _state(jpool) == _state(tpool)
    assert _drive(jpool, OPS) == _drive(tpool, OPS)


def test_exhaustion_is_typed_and_takes_nothing():
    _jpool, tpool = _pools(block_size=4, num_blocks=10)
    tpool.admit(1, np.arange(20) % 32)          # 6 of the 9 blocks
    before = _state(tpool)
    with pytest.raises(tkv.KVBlocksExhausted):
        tpool.admit(0, np.arange(31) % 32)
    assert _state(tpool) == before
    assert issubclass(tkv.KVBlocksExhausted,
                      __import__("mxnet_tpu_torch").serving.Overloaded)


def test_allocator_refcounts_and_misuse():
    a = tkv.BlockAllocator(5, 4)
    got = a.alloc(3)
    assert got == [1, 2, 3] and a.available() == 1 and a.used() == 3
    a.incref([2])
    assert a.decref([1, 2]) == [1] and a.refcount(2) == 1
    with pytest.raises(tkv.KVBlocksExhausted):
        a.alloc(3)
    with pytest.raises(MXNetError, match="double free"):
        a.decref([1])
    with pytest.raises(MXNetError, match="unallocated"):
        a.incref([4])
    with pytest.raises(MXNetError, match=">= 2 blocks"):
        tkv.BlockAllocator(1, 4)


def test_prefix_keys_are_the_jax_sha1_keys():
    toks = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
    for n in (1, 4, 7, 8):
        assert tkv.PrefixCache._key(toks, n) == jkv.PrefixCache._key(toks, n)


def test_sizing_and_gauges():
    ttelemetry.reset()
    ttelemetry.enable()
    try:
        jpool, tpool = _pools(block_size=4)
        assert tpool.hbm_bytes() == jpool.hbm_bytes()
        assert [tpool.admissible(n) for n in (0, 31, 200)] == \
            [jpool.admissible(n) for n in (0, 31, 200)]
        tpool.admit(0, np.arange(9))
        tpool.note_sessions(1)
        assert ttelemetry.gauge_value("serving.kv.blocks_used", model="lm",
                                      replica="0") == 3.0
        gb = tpool.hbm_bytes() / float(1 << 30)
        assert ttelemetry.gauge_value("serving.kv.sessions_per_hbm_gb",
                                      model="lm", replica="0") == 1 / gb
    finally:
        ttelemetry.disable()
        ttelemetry.reset()
    with pytest.raises(MXNetError, match="must be within"):
        tkv.KVBlockPool(ttlm.LMConfig(*WIDTHS, eos_id=32), 4, block_size=33)
