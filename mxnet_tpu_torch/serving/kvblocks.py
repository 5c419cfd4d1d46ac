"""Paged KV-cache bookkeeping — block allocator, prefix cache and per-slot
block tables (counterpart of ``mxnet_tpu/serving/kvblocks.py``, host code
copied from it).

The dense :class:`~mxnet_tpu_torch.serving.decode.DecodeEngine` cache
reserves ``(S, max_len)`` rows per layer for every slot.  The paged layout
keeps per-layer pools of ``num_blocks`` blocks of ``block_size`` positions
on the device (owned by the engine) and names a session's blocks in its
**block table**, a ``(max_blocks,)`` int32 row per slot.  Block 0 is the
reserved **scratch block**: never allocated, it is where unallocated table
entries point, so inactive slots and bucket padding write harmlessly at
fixed shape (the attention mask keeps its contents unread).

This module is the host side: a :class:`BlockAllocator` (free list,
refcounts, under its own lock: the engine thread allocates, describe and
``/healthz`` read), the tables held by :class:`KVBlockPool` (numpy, engine
thread only; the engine copies them to the device once a step as one small
int32 copy), and a sha1-keyed :class:`PrefixCache` through which sessions
sharing a prompt prefix admit by reference: full shared blocks are
increfed into the new table, a partially filled tail block is copied on
write at admission, and only the unshared suffix runs prefill compute.

Freeing is host bookkeeping only: rows are never zeroed, a recycled block
is overwritten by its next owner before the mask exposes it.  Ordering is
safe because every device call that reads or writes the pools runs on
the engine's one thread, in order on its device.

Sizing: ``MXNET_KV_BLOCK_SIZE`` tokens per block (default 16) and
``MXNET_KV_BLOCKS`` blocks per engine (default dense-equivalent, ``slots *
ceil(max_len/block_size) + 1``); ``MXNET_KV_PREFIX_CACHE=0`` disables
prefix reuse; ``MXNET_KV_PREFIX_ENTRIES`` bounds the cache (256).
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict, deque, namedtuple

import numpy as np

from .. import telemetry as _telemetry
from ..base import MXNetError
from ..base import env_int as _env_int
from .batcher import Overloaded

__all__ = ["KVBlocksExhausted", "BlockAllocator", "PrefixCache",
           "KVBlockPool", "AdmitPlan"]


class KVBlocksExhausted(Overloaded):
    """The block pool cannot serve an allocation even after evicting
    the prefix cache — a typed :class:`Overloaded`, so pools and
    clients shed/retry it exactly like a queue-bound rejection."""


#: admission-time block plan: re-/prefill the transcript suffix from
#: absolute position ``start`` (0 = cold, no shared prefix); when
#: ``cow_dst`` is nonzero the prefill first copies pool row
#: ``cow_src`` -> ``cow_dst`` (the shared partial tail block).
AdmitPlan = namedtuple("AdmitPlan", ["start", "cow_src", "cow_dst",
                                     "prefix_hit", "reused_tokens"])


class BlockAllocator:
    """Host-side free list + refcounts over ``num_blocks`` device rows.

    Block ids are ``1 .. num_blocks-1``; block 0 is the scratch block
    and is never handed out.  A block is freed when its refcount drops
    to zero (sessions and prefix-cache entries each hold one reference
    per table/entry occurrence).  All state lives under ``_lock``.
    """

    def __init__(self, num_blocks, block_size):
        num_blocks = int(num_blocks)
        block_size = int(block_size)
        if block_size < 1:
            raise MXNetError("KV block_size must be >= 1, got %d"
                             % block_size)
        if num_blocks < 2:
            raise MXNetError(
                "KV pool needs >= 2 blocks (block 0 is reserved "
                "scratch), got %d" % num_blocks)
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._lock = threading.Lock()
        self._free = deque(range(1, num_blocks))
        self._ref = {}

    def alloc(self, n):
        """Take ``n`` blocks (refcount 1 each); raises
        :class:`KVBlocksExhausted` — atomically, taking none — when the
        free list is short."""
        n = int(n)
        with self._lock:
            if n > len(self._free):
                raise KVBlocksExhausted(
                    "KV pool exhausted: %d blocks requested, %d free of "
                    "%d allocatable" % (n, len(self._free),
                                        self.num_blocks - 1))
            out = [self._free.popleft() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
        return out

    def incref(self, blocks):
        """Add one reference to each (already-allocated) block —
        admit-by-reference and prefix-cache insertion."""
        with self._lock:
            for b in blocks:
                if b not in self._ref:
                    raise MXNetError(
                        "incref of unallocated KV block %d" % int(b))
                self._ref[b] += 1

    def decref(self, blocks):
        """Drop one reference from each block; blocks reaching zero go
        back on the free list.  Returns the freed block ids."""
        freed = []
        with self._lock:
            for b in blocks:
                b = int(b)
                r = self._ref.get(b)
                if r is None:
                    raise MXNetError(
                        "double free of KV block %d" % b)
                if r == 1:
                    del self._ref[b]
                    self._free.append(b)
                    freed.append(b)
                else:
                    self._ref[b] = r - 1
        return freed

    def refcount(self, block):
        with self._lock:
            return self._ref.get(int(block), 0)

    def available(self):
        with self._lock:
            return len(self._free)

    def used(self):
        with self._lock:
            return len(self._ref)

    def reset(self):
        """Forget everything (engine restart after a failed dispatch:
        the device pools were rebuilt from zeros, so every host
        reference is moot)."""
        with self._lock:
            self._free = deque(range(1, self.num_blocks))
            self._ref = {}


class PrefixCache:
    """sha1-keyed index from prompt-prefix content to resident blocks.

    Every admitted prompt is indexed at each block-aligned prefix
    length AND at its full length; each entry holds one allocator
    reference per covered block, so retiring the session that produced
    the K/V does NOT free it — later sessions sharing the prefix admit
    against the cached rows.  A lookup matches the longest indexed
    prefix of the new transcript (capped at ``len-1``: the last prompt
    token is always recomputed, its logits seed the first sample).
    Entries are LRU; the pool evicts them when the allocator runs dry,
    so cached prefixes never block live admissions.

    Sharing is safe without copying because shared rows are never
    rewritten: a session writes positions ``>= len(its own prompt)``
    only, and a matched prefix is at most ``len-1 < len(prompt)`` long
    — the one writable overlap (a partially-filled tail block) is
    copied on write at admission by the engine's prefill.
    """

    def __init__(self, allocator, *, capacity=None, enabled=True):
        self._alloc = allocator
        self.block_size = allocator.block_size
        self.capacity = int(capacity) if capacity is not None \
            else _env_int("MXNET_KV_PREFIX_ENTRIES", 256)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._entries = OrderedDict()   # sha1 -> (length, blocks tuple)
        self.hits = 0
        self.insertions = 0
        self.evictions = 0

    @staticmethod
    def _key(tokens, length):
        return hashlib.sha1(np.ascontiguousarray(
            tokens[:length], dtype=np.int32).tobytes()).hexdigest()

    def lookup(self, tokens):
        """Longest indexed prefix of ``tokens`` (< its full length).
        Returns ``(matched_len, blocks)`` with one reference taken on
        each returned block FOR THE CALLER, or ``(0, [])``."""
        if not self.enabled:
            return 0, []
        n = int(len(tokens))
        top = n - 1
        if top <= 0:
            return 0, []
        bs = self.block_size
        cands = [top]
        for lng in range((top // bs) * bs, 0, -bs):
            if lng != top:
                cands.append(lng)
        for lng in cands:
            key = self._key(tokens, lng)
            with self._lock:
                ent = self._entries.get(key)
                if ent is None or ent[0] != lng:
                    continue
                self._entries.move_to_end(key)
                blocks = list(ent[1])
                # caller's reference, taken under the cache lock so a
                # concurrent eviction cannot free the rows in between
                # (lock order cache -> allocator, one way everywhere)
                self._alloc.incref(blocks)
                self.hits += 1
            return lng, blocks
        return 0, []

    def insert(self, tokens, table_row):
        """Index ``tokens`` (a prompt resident in ``table_row``'s
        blocks) at every block-aligned prefix length plus the full
        length; no-op for lengths already indexed."""
        if not self.enabled:
            return
        n = int(len(tokens))
        if n < 1:
            return
        bs = self.block_size
        # aligned prefixes + the full length (prompt-extension hits) +
        # length n-1 (an IDENTICAL prompt resubmitted hits at n-1: the
        # last token is always recomputed for its first-sample logits,
        # everything before it rides the cache)
        lengths = sorted({lng for lng in
                          set(range(bs, n + 1, bs)) | {n, n - 1}
                          if lng >= 1})
        for lng in lengths:
            nblk = -(-lng // bs)
            blocks = tuple(int(b) for b in table_row[:nblk])
            key = self._key(tokens, lng)
            with self._lock:
                if key in self._entries:
                    self._entries.move_to_end(key)
                    continue
                self._alloc.incref(blocks)
                self._entries[key] = (lng, blocks)
                self.insertions += 1
                while len(self._entries) > self.capacity:
                    self._evict_one_locked()

    def _evict_one_locked(self):
        key = next(iter(self._entries))
        _lng, blocks = self._entries.pop(key)
        self.evictions += 1
        self._alloc.decref(blocks)

    def evict_for(self, n_blocks):
        """Evict LRU entries until the allocator has ``n_blocks`` free
        or the cache is empty (entries whose blocks are still shared by
        live sessions free nothing — keep going).  Returns the number
        of blocks actually freed."""
        freed = 0
        while self._alloc.available() < n_blocks:
            with self._lock:
                if not self._entries:
                    break
                key = next(iter(self._entries))
                _lng, blocks = self._entries.pop(key)
                self.evictions += 1
            freed += len(self._alloc.decref(blocks))
        return freed

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def clear(self):
        """Drop every entry WITHOUT releasing references — only valid
        when the owning pool resets its allocator in the same breath
        (engine restart)."""
        with self._lock:
            self._entries = OrderedDict()


class KVBlockPool:
    """Per-engine facade: sizing, per-slot block tables, admission
    planning, boundary appends, release, and the ``serving.kv.*``
    telemetry families.

    The engine owns the device tensors and the step functions; this
    object owns which pool row means what.  All mutating calls run on
    the engine thread (single writer); reads for describe/healthz go
    through the allocator's lock or read monotonic counters.
    """

    def __init__(self, cfg, slots, *, block_size=None, num_blocks=None,
                 prefix_cache=None, model="lm", replica="0"):
        self.cfg = cfg
        self.slots = int(slots)
        bs = int(block_size) if block_size is not None \
            else _env_int("MXNET_KV_BLOCK_SIZE", 16)
        if bs < 1 or bs > cfg.max_len:
            raise MXNetError(
                "MXNET_KV_BLOCK_SIZE=%d must be within 1..max_len=%d"
                % (bs, cfg.max_len))
        self.block_size = bs
        #: table width: blocks that cover one max_len session
        self.max_blocks = -(-cfg.max_len // bs)
        nb = int(num_blocks) if num_blocks is not None \
            else _env_int("MXNET_KV_BLOCKS", 0)
        if nb <= 0:
            # dense-equivalent default (+ scratch): paged is never
            # worse than dense out of the box; undersize deliberately
            # to oversubscribe
            nb = self.slots * self.max_blocks + 1
        if nb < self.max_blocks + 1:
            raise MXNetError(
                "MXNET_KV_BLOCKS=%d cannot hold one max_len=%d session "
                "(needs >= %d blocks of %d tokens + scratch)"
                % (nb, cfg.max_len, self.max_blocks, bs))
        self.num_blocks = nb
        self.allocator = BlockAllocator(nb, bs)
        if prefix_cache is None:
            prefix_cache = (os.environ.get("MXNET_KV_PREFIX_CACHE", "1")
                            or "1").strip().lower() \
                not in ("0", "false", "off")
        self.cache = PrefixCache(self.allocator,
                                 enabled=bool(prefix_cache))
        self.tables = np.zeros((self.slots, self.max_blocks), np.int32)
        self._model = model
        self._replica = str(replica)
        # monotonic stats (engine-thread writer, racy-read safe)
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.cow_copies = 0
        labels = {"model": model, "replica": self._replica}
        _telemetry.inc("serving.kv.prefix_hits", 0, **labels)
        _telemetry.inc("serving.kv.cow_copies", 0, **labels)
        _telemetry.set_gauge("serving.kv.sessions_per_hbm_gb", 0.0,
                             **labels)
        self._gauges()

    # -- sizing ------------------------------------------------------------
    def hbm_bytes(self):
        """Device bytes the K+V pools occupy (float32)."""
        hd = self.cfg.embed // self.cfg.heads
        return (2 * self.cfg.layers * self.num_blocks * self.block_size
                * self.cfg.heads * hd * 4)

    def admissible(self, n_tokens):
        """Submit-time budget check: can a transcript of ``n_tokens``
        EVER be admitted — worst case (cold, no prefix sharing) it
        needs blocks for positions ``0..n_tokens`` against the whole
        allocatable pool.  Dynamic pressure is not checked here:
        queued sessions wait for blocks to free, they are not shed."""
        need = int(n_tokens) // self.block_size + 1
        return need <= self.num_blocks - 1

    # -- admission ---------------------------------------------------------
    def admit(self, slot, tokens):
        """Plan block storage for transcript ``tokens`` entering
        ``slot``: longest-prefix match against the cache shares full
        blocks by reference, a partial tail block becomes a
        copy-on-write, and fresh blocks cover the rest through position
        ``len(tokens)`` (the first sampled token's row).  Returns an
        :class:`AdmitPlan`; raises :class:`KVBlocksExhausted` — taking
        nothing — when even prefix-cache eviction cannot cover it."""
        tokens = np.asarray(tokens, np.int32)
        n = int(tokens.size)
        row = self.tables[slot]
        if row.any():
            raise MXNetError(
                "KV admit into slot %d which still holds blocks"
                % int(slot))
        bs = self.block_size
        matched, shared = self.cache.lookup(tokens)
        nfull, rem = divmod(matched, bs)
        last_blk = n // bs
        first_fresh = nfull + (1 if rem else 0)
        need = (1 if rem else 0) + max(last_blk - first_fresh + 1, 0)
        try:
            fresh = self._reserve(need)
        except KVBlocksExhausted:
            if shared:
                self.allocator.decref(shared)
            raise
        cow_src = cow_dst = 0
        if nfull:
            row[:nfull] = shared[:nfull]
        take = 0
        if rem:
            # the shared tail block is only partially prefix — copy it
            # on write: the prefill duplicates the row before the
            # suffix writes into the copy.  Our lookup reference on the
            # source is dropped now; the copy runs in the very next
            # prefill on the engine thread, before any later allocation
            # can recycle the source row.
            cow_src, cow_dst = int(shared[nfull]), int(fresh[0])
            row[nfull] = cow_dst
            take = 1
            self.allocator.decref([cow_src])
        if need - take:
            row[first_fresh:last_blk + 1] = fresh[take:]
        if matched:
            self.prefix_hits += 1
            self.prefix_tokens_reused += matched
            _telemetry.inc("serving.kv.prefix_hits", model=self._model,
                           replica=self._replica)
        if rem:
            self.cow_copies += 1
            _telemetry.inc("serving.kv.cow_copies", model=self._model,
                           replica=self._replica)
        self._gauges()
        return AdmitPlan(start=matched, cow_src=cow_src, cow_dst=cow_dst,
                         prefix_hit=bool(matched), reused_tokens=matched)

    def _reserve(self, need):
        if need <= 0:
            return []
        if self.allocator.available() < need:
            # cached prefixes never starve live admissions
            self.cache.evict_for(need)
        return self.allocator.alloc(need)

    def append(self, slot, pos):
        """Make sure the block covering position ``pos`` is allocated
        in ``slot``'s table (the decode loop calls this before every
        step for each live slot — a no-op except on block boundaries).
        Raises :class:`KVBlocksExhausted` when the pool is dry even
        after eviction; the engine sheds that session typed."""
        blk = int(pos) // self.block_size
        row = self.tables[slot]
        if row[blk]:
            return False
        (bid,) = self._reserve(1)
        row[blk] = bid
        self._gauges()
        return True

    def release(self, slot):
        """Drop the slot's references (retire/cancel/shed/migrate-out);
        blocks shared with the prefix cache or other slots survive."""
        row = self.tables[slot]
        held = [int(b) for b in row[row != 0]]
        row[:] = 0
        if held:
            self.allocator.decref(held)
        self._gauges()

    def offer(self, slot, prompt):
        """Index the slot's (just prefilled) prompt in the prefix
        cache so future sessions sharing it admit by reference."""
        self.cache.insert(np.asarray(prompt, np.int32),
                          self.tables[slot])

    def reset(self):
        """Forget all host state (engine restart or a failed dispatch —
        the device pools were rebuilt from zeros)."""
        self.cache.clear()
        self.allocator.reset()
        self.tables[:] = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.cow_copies = 0
        self._gauges()

    # -- observability -----------------------------------------------------
    def _gauges(self):
        labels = {"model": self._model, "replica": self._replica}
        _telemetry.set_gauge("serving.kv.blocks_used",
                             float(self.allocator.used()), **labels)
        _telemetry.set_gauge("serving.kv.blocks_free",
                             float(self.allocator.available()), **labels)

    def note_sessions(self, active):
        """Stamp ``serving.kv.sessions_per_hbm_gb`` — live sessions per
        GiB of KV storage, THE capacity headline the paged design
        exists to raise (the dense engine's is fixed at
        ``slots / dense_gb`` no matter how short its sessions are)."""
        gb = self.hbm_bytes() / float(1 << 30)
        _telemetry.set_gauge("serving.kv.sessions_per_hbm_gb",
                             float(active) / gb, model=self._model,
                             replica=self._replica)

    def describe(self):
        return {"layout": "paged",
                "block_size": self.block_size,
                "num_blocks": self.num_blocks,
                "max_blocks_per_session": self.max_blocks,
                "blocks_used": self.allocator.used(),
                "blocks_free": self.allocator.available(),
                "prefix_hits": self.prefix_hits,
                "prefix_tokens_reused": self.prefix_tokens_reused,
                "cow_copies": self.cow_copies,
                "prefix_entries": len(self.cache),
                "prefix_evictions": self.cache.evictions,
                "hbm_bytes": self.hbm_bytes()}
