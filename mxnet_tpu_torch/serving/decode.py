"""Continuous-batching decode engine — autoregressive serving on slots
(counterpart of ``mxnet_tpu/serving/decode.py``).

:class:`DecodeEngine` owns a device-resident KV cache of fixed shape
``(S slots, max_len)`` per layer (or, under the paged layout, block pools
named by per-slot tables, :mod:`~mxnet_tpu_torch.serving.kvblocks`) and
two functions over preallocated state tensors, where the JAX package
builds two jitted programs:

* **prefill** (one per prompt-length bucket): run a bucket-padded prompt,
  write its K/V rows into a free slot, sample the first token and arm the
  slot;
* **decode step** (fixed shape ``(S, max_len)``): advance ALL slots one
  token (write the incoming token's K/V, attend over each slot's ``<=
  length`` horizon, sample greedy or at a temperature, retire EOS- or
  length-done slots) and return the packed ``(token, done, active)``
  buffer.  Its one device-to-host copy is the loop's only sync; the step
  holds no ``.item()`` and no host branch on a device value, and updates
  its state tensors in place, so it can be captured as a CUDA graph.

**Sampling keys are position-derived.**  Each session carries one 32-bit
``seed``; the token that will occupy absolute position ``i`` is drawn by
Gumbel-max with noise from a counter-based hash of ``(seed, i, vocab
index)`` (:func:`sample_bits`), computed in integer tensor ops on the
device: the same bits on the CPU and on CUDA.  A session's stream is
therefore a pure function of ``(seed, transcript)``: independent of its
slot, of its co-residents and of how often it was interrupted, so
re-prefilling ``prompt + generated`` on any replica resumes the exact
stream (what :class:`~mxnet_tpu_torch.serving.pool.ReplicaPool` failover
relies on).  The JAX package draws with ``fold_in(PRNGKey(seed), i)`` and
threefry: the two packages' temperature streams differ, their greedy
streams agree.

Sequences are admitted into free slots between steps (a late request
joins the running batch), retired on EOS or length, and stream their
tokens through per-session callbacks.  Inactive slots ride along at fixed
shape.  Each engine issues its device work on its own CUDA stream, so two
replicas on one card do not wait on each other's host reads.

Supervision hooks: the loop stamps a heartbeat every iteration
(:meth:`DecodeEngine.heartbeat_age`), and the step consults two fault
points before it launches (:mod:`~mxnet_tpu_torch.faults`):
``serving.decode`` fails that one step, ``serving.replica.kill`` closes
the engine for good (:class:`ReplicaKilled`: the worker exits, the cache
is released, the held sessions migrate).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from .. import faults as _faults
from .. import random as _random
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..base import env_int as _env_int
from ..context import Context, gpu
from ..models import transformer_lm as _tlm
from .batcher import (LATENCY_BUCKETS, DeadlineExceeded, Future,
                      InvalidRequest, Overloaded)
from .kvblocks import AdmitPlan, KVBlockPool, KVBlocksExhausted

__all__ = ["GenerateSession", "DecodeEngine", "ReplicaKilled",
           "TTFT_BUCKETS", "sample_bits", "gumbel_noise", "sample_tokens",
           "resolve_device"]

_log = logging.getLogger("mxnet_tpu_torch.serving")

#: time-to-first-token histogram bounds (seconds)
TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, 30.0)

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """``x * c mod 2**32`` for ``x`` in ``[0, 2**32)`` held in int64 and a
    constant ``c``: the product is split at 16 bits of ``c`` so no
    intermediate leaves ``[0, 2**49)`` (int64 neither overflows nor goes
    negative, so ``>>`` acts as a logical shift)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x):
    """MurmurHash3's 32-bit finaliser (a bijection of ``[0, 2**32)``)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def sample_bits(seeds, positions, vocab_idx):
    """The 32-bit hash of ``(seed, position, vocab index)``: ``seeds`` and
    ``positions`` are ``(S,)`` int64 tensors of 32-bit values,
    ``vocab_idx`` an ``(V,)`` int64 tensor; returns ``(S, V)`` int64.
    Integer ops only, so the same bits on any device."""
    key = _fmix32(_fmix32(seeds ^ 0x9E3779B9) ^ (positions & _M32))
    return _fmix32(_fmix32(key[:, None] ^ vocab_idx[None, :]) ^ 0x2545F491)


def gumbel_noise(seeds, positions, vocab_idx):
    """``(S, V)`` float32 Gumbel noise ``-log(-log(u))``, ``u`` the hash's
    top 24 bits centred in ``(0, 1)``."""
    bits = sample_bits(seeds, positions, vocab_idx)
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_tokens(logits, temps, seeds, positions, vocab_idx):
    """Greedy argmax where ``temps == 0``, else the Gumbel-max draw
    ``argmax(logits / max(t, 1e-6) + g)``: a categorical draw from
    ``softmax(logits / t)``."""
    greedy = logits.argmax(-1)
    g = gumbel_noise(seeds, positions, vocab_idx)
    drawn = (logits / temps.clamp(min=1e-6)[:, None] + g).argmax(-1)
    return torch.where(temps > 0.0, drawn, greedy)


#: Lanes of closed engines, by device.  A lane is a CUDA stream and the one
#: thread that runs an engine's work on it: its warm-up and its serving
#: loop.  PyTorch caches freed device blocks per stream, and a cuBLAS
#: workspace (32 MiB on Hopper) per (cuBLAS handle, stream) pair, for the
#: life of the process; a handle belongs to a thread.  An engine that
#: replaces a closed one on the same card takes the closed one's lane, so
#: it reuses both instead of allocating beside them.  Process-wide, as the
#: allocator is.
_idle_lanes = {}
_idle_lock = threading.Lock()


class _Job:
    """A function run on a lane; ``join`` and ``is_alive`` as a
    thread's."""

    def __init__(self, fn, reraise):
        self._fn = fn
        self.reraise = reraise
        self.result = self.error = None
        self._done = threading.Event()

    def run(self):
        try:
            self.result = self._fn()
        except BaseException as e:  # noqa: broad-except — the lane's
            # thread must outlive any job; the caller or the log gets it
            self.error = e
        finally:
            self._fn = None  # an idle lane keeps no closed engine alive
            self._done.set()

    def join(self, timeout=None):
        self._done.wait(timeout)

    def is_alive(self):
        return not self._done.is_set()


class _Lane:
    """A stream (None on the CPU) and a daemon thread that runs the jobs
    given to it one after another, for the life of the process."""

    def __init__(self, device, index):
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self._jobs = queue.SimpleQueue()
        self._thread = threading.Thread(
            target=self._run, name="decode-lane-%s-%d" % (device, index),
            daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            job = self._jobs.get()
            job.run()
            if job.error is not None and not job.reraise:
                _log.error("decode: a job on %s raised",
                           self._thread.name, exc_info=job.error)
            job = None

    def submit(self, fn, reraise=False):
        """Queue ``fn`` behind the lane's earlier jobs; returns its
        :class:`_Job` (whose exception the lane logs unless ``reraise``:
        then the caller takes it)."""
        job = _Job(fn, reraise)
        self._jobs.put(job)
        return job

    def call(self, fn):
        """``fn()`` run on the lane's thread (at once when called from
        it): its result, or its exception raised here."""
        if threading.current_thread() is self._thread:
            return fn()
        job = self.submit(fn, reraise=True)
        job.join()
        if job.error is not None:
            raise job.error
        return job.result


_lane_ids = itertools.count()


def _take_lane(device):
    with _idle_lock:
        idle = _idle_lanes.get(device)
        if idle:
            return idle.pop()
    return _Lane(device, next(_lane_ids))


def _give_back_lane(device, lane):
    if lane.stream is not None:
        lane.stream.synchronize()
    with _idle_lock:
        _idle_lanes.setdefault(device, []).append(lane)


def resolve_device(device):
    """``None`` -> ``cuda:0`` (raising without a card); a context, string
    or ``torch.device`` -> that device.  A CUDA device that is not there
    raises: nothing falls back to the CPU."""
    if device is None:
        return gpu(0).torch_device()
    if isinstance(device, Context):
        return device.torch_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        idx = 0 if dev.index is None else dev.index
        return Context("gpu", idx).torch_device()
    if dev.type != "cpu":
        raise MXNetError("unsupported decode device %r" % (device,))
    return dev


class ReplicaKilled(MXNetError):
    """A replica was hard-killed mid-generation (the
    ``serving.replica.kill`` fault point): the engine is permanently
    closed, its device state released, and its sessions must migrate (the
    pool treats this as an instant circuit-open and marks the replica
    dead)."""


class GenerateSession:
    """One streaming generation request: queued -> active(slot) ->
    done/shed (or migrated to another replica in between — the session
    object survives the move).  ``result()`` blocks for the full token
    list (prompt NOT included; EOS, when hit, is the last token);
    ``on_token`` streams each token from the engine thread (must be cheap
    and non-blocking — HTTP streaming hands it a queue put).

    The session IS its own failover checkpoint: ``prompt``, ``tokens``
    (everything generated AND delivered so far — the engine appends
    before it emits, and a failed dispatch emits nothing), ``seed`` and
    ``max_new_tokens`` are what a healthy replica needs to resume the
    stream exactly.
    """

    __slots__ = ("prompt", "max_new_tokens", "temperature", "deadline",
                 "on_token", "on_event", "tokens", "future", "seed",
                 "tenant", "migrations", "migrate_t0", "t_submit",
                 "t_first", "t_done", "slot", "admit_step", "done_step",
                 "_finished", "_lock", "_on_done")

    def __init__(self, prompt, max_new_tokens, temperature, deadline_ms,
                 on_token, on_done=None, seed=0, tenant=None,
                 on_event=None):
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.deadline = None if deadline_ms is None \
            else time.monotonic() + float(deadline_ms) / 1e3
        self.on_token = on_token
        self.on_event = on_event
        self.tokens = []
        self.future = Future()
        self.seed = int(seed) & _M32
        self.tenant = tenant
        #: failure-driven migration attempts so far (the pool's retry
        #: budget counts these; version-swap migrations are free)
        self.migrations = 0
        #: failure timestamp of an in-flight migration — the target
        #: engine stamps ``serving.failover.recovery_seconds`` from it
        self.migrate_t0 = None
        self.t_submit = time.monotonic()
        self.t_first = None
        self.t_done = None
        self.slot = None
        self.admit_step = None
        self.done_step = None
        self._finished = False
        # session-level lock: completion must stay exactly-once across
        # MIGRATION — engine A's forced stop can race engine B retiring
        # the same (migrated) session
        self._lock = threading.Lock()
        self._on_done = on_done

    def _resolve(self, error=None):
        """Exactly-once completion: resolve the future and fire the
        pool's on_done hook.  Returns False when the session already
        finished."""
        with self._lock:
            if self._finished:
                return False
            self._finished = True
        self.t_done = time.monotonic()
        if error is not None:
            self.future.set_error(error)
        else:
            self.future.set_result(list(self.tokens))
        if self._on_done is not None:
            try:
                self._on_done(self)
            except Exception:  # noqa: broad-except — pool accounting
                # hooks must never kill the resolving thread
                _log.warning("decode: on_done hook failed", exc_info=True)
        return True

    def finished(self):
        """True once the session resolved (result or typed error)."""
        with self._lock:
            return self._finished

    def cancel(self):
        """Abandon the request: queued sessions are dropped at the next
        admission scan, an active one is retired at the next step
        boundary.  False when the session already finished."""
        return self.future.cancel()

    def cancelled(self):
        return self.future.cancelled()

    def done(self):
        return self.future.done()

    def result(self, timeout=60.0):
        """Block for the full generated token list (re-raising the shed
        or dispatch error when the session failed)."""
        return self.future.result(timeout)

    def ttft(self):
        """Time-to-first-token in seconds (None before the first
        token)."""
        return None if self.t_first is None \
            else self.t_first - self.t_submit


class _State:
    """The engine's device-resident slot state.  ``k``/``v`` are the
    dense caches ``(layers, heads, S, max_len, head_dim)`` or the block
    pools ``(layers, heads, num_blocks, block_size, head_dim)``; the
    rest are ``(S,)`` vectors.  Every function updates them in place."""

    __slots__ = ("k", "v", "last_tok", "lengths", "limits", "active",
                 "temps", "seeds")

    def tensors(self):
        return [getattr(self, n) for n in self.__slots__]


class DecodeEngine:
    """Slot-based continuous batching over one
    :mod:`~mxnet_tpu_torch.models.transformer_lm` replica.

    Parameters
    ----------
    cfg : transformer_lm.LMConfig
    params : dict of tensors
        Host or device params; moved to ``device`` (shared, not copied,
        when already there).
    slots : int
        Concurrent sequences S (``MXNET_DECODE_SLOTS`` default, 8).
    prefill_buckets : tuple of int
        Declared prompt-length buckets; a prompt pads to the smallest
        bucket that fits.  A migrated transcript longer than the largest
        pads to ``max_len`` (:meth:`resume`).
    max_queue : int
        Admission bound on QUEUED sessions; past it ``submit`` raises
        :class:`Overloaded`.
    device : optional
        ``None`` is ``cuda:0`` (raising without a card); ``"cpu"`` for
        the CPU.
    replica : str
        Telemetry label (``replica=<id>``) — the pool names replicas.
    on_step_error / on_step_ok : callable, optional
        Replica-health hooks (the pool's breaker); called outside the
        engine lock.
    kv_layout : str, optional
        ``"dense"`` or ``"paged"`` (``MXNET_KV_LAYOUT``, dense).  Both
        give the same streams for the same ``(seed, transcript)``.
    kv_block_size / kv_blocks / kv_prefix_cache :
        Paged sizing and prefix reuse (see kvblocks.py).
    """

    def __init__(self, cfg, params, *, slots=None, prefill_buckets=(8, 32),
                 max_queue=64, device=None, name="lm", replica="0",
                 autostart=True, on_step_error=None, on_step_ok=None,
                 kv_layout=None, kv_block_size=None, kv_blocks=None,
                 kv_prefix_cache=None):
        self.cfg = cfg
        self.name = name
        self.replica = str(replica)
        self.slots = int(slots) if slots is not None \
            else _env_int("MXNET_DECODE_SLOTS", 8)
        if self.slots < 1:
            raise MXNetError("DecodeEngine needs >= 1 slot")
        buckets = tuple(sorted({int(b) for b in prefill_buckets}))
        if not buckets or buckets[0] < 1 or buckets[-1] > cfg.max_len:
            raise MXNetError(
                "prefill buckets %r must be within 1..max_len=%d"
                % (buckets, cfg.max_len))
        self.prefill_buckets = buckets
        self.max_queue = int(max_queue)
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        self._lane = _take_lane(self._device)
        self._stream = self._lane.stream
        with self._on_stream():
            self._params = _tlm.params_to(params, self._device)
        self._on_step_error = on_step_error
        self._on_step_ok = on_step_ok
        self._on_migrate = None

        self._cond = threading.Condition(threading.Lock())
        self._queue = deque()
        self._slot_sessions = [None] * self.slots
        self._running = False
        self._draining = False
        self._closed = False
        #: the serving loop's job on the lane (``join``/``is_alive``)
        self._thread = None
        #: the last loop started (``stop`` clears ``_thread`` even when
        #: a wedged loop outlives its joins)
        self._worker = None
        self._beat = time.monotonic()
        #: total decode steps (tests pin continuous admission on it)
        self.steps = 0
        #: total generated tokens
        self.tokens_out = 0
        #: sessions re-admitted here by failover
        self.resumed = 0
        #: prompt+generated tokens re-prefilled for those resumes
        self.reprefilled_tokens = 0
        self._rate_t0 = time.monotonic()
        self._rate_tokens = 0

        layout = kv_layout if kv_layout is not None \
            else (os.environ.get("MXNET_KV_LAYOUT", "dense") or "dense")
        layout = str(layout).strip().lower()
        if layout not in ("dense", "paged"):
            raise MXNetError(
                "kv_layout/MXNET_KV_LAYOUT must be 'dense' or 'paged', "
                "got %r" % layout)
        self.kv_layout = layout
        #: paged storage control plane (None under the dense layout)
        self._kv = KVBlockPool(
            cfg, self.slots, block_size=kv_block_size,
            num_blocks=kv_blocks, prefix_cache=kv_prefix_cache,
            model=name, replica=self.replica) \
            if layout == "paged" else None
        #: host mirror of each slot's device ``lengths`` — the paged
        #: loop derives the next write position (and block-boundary
        #: appends) from it without a device read
        self._slot_len = [0] * self.slots
        # the step's host-to-device inputs: pinned staging on the card
        # (each step's packed read orders the next rewrite after the
        # copy), and the vocabulary index the sampling hash reads
        pin = self._cuda
        self._keep_host = torch.zeros(self.slots, dtype=torch.bool,
                                      pin_memory=pin)
        mb = self._kv.max_blocks if self._kv is not None else 1
        self._tables_host = torch.zeros((self.slots, mb), dtype=torch.int64,
                                        pin_memory=pin)
        with self._on_stream():
            self._keep_dev = torch.zeros(self.slots, dtype=torch.bool,
                                         device=self._device)
            self._tables_dev = torch.zeros((self.slots, mb),
                                           dtype=torch.int64,
                                           device=self._device)
            self._vocab_idx = torch.arange(cfg.vocab, device=self._device)

        self._step_fn = None       # set in _build()
        self._prefill_fn = None
        self._live = None
        self._boot_state = self._build()
        labels = {"model": name, "replica": self.replica}
        _telemetry.inc("serving.decode.sessions.count", 0, **labels)
        _telemetry.inc("serving.decode.tokens.count", 0, **labels)
        _telemetry.inc("serving.decode.steps.count", 0, **labels)
        _telemetry.set_gauge("serving.decode.slot_occupancy", 0.0, **labels)
        _telemetry.set_gauge("serving.decode.tokens_per_sec", 0.0, **labels)
        _telemetry.inc("serving.failover.reprefill_tokens.count", 0,
                       **labels)
        for reason in ("deadline", "overload", "abandoned", "drain",
                       "kv_blocks"):
            _telemetry.inc("serving.shed.count", 0, model=name,
                           reason=reason)
        if autostart:
            self.start()

    def _on_stream(self):
        """The engine's CUDA stream as the current one (a no-op context
        on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # -- the two functions -------------------------------------------------
    def _build(self):
        """Set the step and prefill functions and return a warmed fresh
        state: every prefill bucket and the step run once before
        traffic, on the lane's thread, which warms the cuBLAS handle and
        workspace the loop will use and the caching allocator."""
        self._step_fn = self._step_paged if self._kv is not None \
            else self._step_dense
        self._prefill_fn = self._prefill
        state = self._lane.call(lambda: self._warm(self._fresh_state()))
        _telemetry.event("serving.decode.warm", model=self.name,
                         replica=self.replica, slots=self.slots,
                         buckets=len(self.prefill_buckets))
        return state

    def _finish_step(self, st, logits, keep):
        """Sampling and retirement tail shared by both layouts; updates
        ``st`` in place and returns the packed ``(3, S)`` int32 buffer."""
        active = st.active & keep
        # last_tok sits at position ``lengths``; the sampled token will
        # occupy ``lengths + 1``
        tok = sample_tokens(logits, st.temps, st.seeds, st.lengths + 1,
                            self._vocab_idx)
        new_len = st.lengths + active.long()
        done = active & ((tok == self.cfg.eos_id) | (new_len >= st.limits))
        new_active = active & ~done
        packed = torch.stack([torch.where(active, tok, -1), done.long(),
                              new_active.long()]).to(torch.int32)
        st.last_tok.copy_(torch.where(active, tok, st.last_tok))
        st.lengths.copy_(new_len)
        st.active.copy_(new_active)
        return packed

    def _step_dense(self, st, keep, tables=None):
        with self._on_stream():
            logits, _, _ = _tlm.decode_step_math(
                self.cfg, self._params, st.k, st.v, st.last_tok, st.lengths)
            return st, self._finish_step(st, logits, keep)

    def _step_paged(self, st, keep, tables):
        with self._on_stream():
            logits, _, _ = _tlm.decode_step_paged(
                self.cfg, self._params, st.k, st.v, tables, st.last_tok,
                st.lengths)
            return st, self._finish_step(st, logits, keep)

    def _prefill(self, st, tokens, n, slot, limit, temp, seed, activate,
                 plan=None):
        """Prefill one bucket-padded transcript into ``slot`` and arm it;
        returns ``(state, out)`` with ``out`` the ``(2,)`` device tensor
        ``(first token, done at prefill)``.  ``plan`` is the paged
        admission plan (None under the dense layout)."""
        with self._on_stream():
            tok_dev = torch.from_numpy(tokens).to(self._device)
            if plan is None:
                last, ks, vs = _tlm.prefill_kv(self.cfg, self._params,
                                               tok_dev, n)
                p = tok_dev.shape[0]
                st.k[:, :, slot, :p] = torch.stack(ks)
                st.v[:, :, slot, :p] = torch.stack(vs)
            else:
                if plan.cow_dst:
                    # admission-time copy-on-write of the shared partial
                    # tail block, before the suffix writes into the copy
                    st.k[:, :, plan.cow_dst] = st.k[:, :, plan.cow_src]
                    st.v[:, :, plan.cow_dst] = st.v[:, :, plan.cow_src]
                table = torch.from_numpy(
                    np.ascontiguousarray(self._kv.tables[slot])).to(
                        self._device)
                last, _, _ = _tlm.prefill_kv_paged(
                    self.cfg, self._params, st.k, st.v, table, tok_dev,
                    plan.start, n)
            # the prompt holds positions 0..n-1; the sampled token
            # occupies ``n`` — on a failover re-prefill of
            # prompt+generated this is the key the interrupted replica's
            # next step would have used
            dev = self._device
            tok = sample_tokens(
                last[None], torch.full((1,), float(temp), device=dev),
                torch.full((1,), int(seed), dtype=torch.int64, device=dev),
                torch.full((1,), int(n), dtype=torch.int64, device=dev),
                self._vocab_idx)[0]
            first_done = (tok == self.cfg.eos_id) | (int(limit) <= int(n))
            st.last_tok[slot] = tok
            st.lengths[slot] = int(n)
            st.limits[slot] = int(limit)
            st.temps[slot] = float(temp)
            st.seeds[slot] = int(seed)
            st.active[slot] = first_done.logical_not() & bool(activate)
            return st, torch.stack([tok, first_done.long()])

    def _fresh_state(self):
        """Zeroed device-resident slot state.  Under the paged layout the
        K/V tensors are the block pools, and rebuilding them from zeros
        invalidates every block — the host control plane resets in the
        same breath."""
        cfg = self.cfg
        s = self.slots
        hd = cfg.embed // cfg.heads
        if self._kv is not None:
            self._kv.reset()
            kv_shape = (cfg.layers, cfg.heads, self._kv.num_blocks,
                        self._kv.block_size, hd)
        else:
            kv_shape = (cfg.layers, cfg.heads, s, cfg.max_len, hd)
        self._slot_len = [0] * s
        st = _State()
        # drop the old state before the new one is allocated: at full
        # width a cache is gigabytes
        self._live = None
        with self._on_stream():
            dev = self._device
            st.k = torch.zeros(kv_shape, dtype=torch.float32, device=dev)
            st.v = torch.zeros(kv_shape, dtype=torch.float32, device=dev)
            st.last_tok = torch.zeros(s, dtype=torch.int64, device=dev)
            st.lengths = torch.zeros(s, dtype=torch.int64, device=dev)
            st.limits = torch.zeros(s, dtype=torch.int64, device=dev)
            st.active = torch.zeros(s, dtype=torch.bool, device=dev)
            st.temps = torch.zeros(s, dtype=torch.float32, device=dev)
            st.seeds = torch.zeros(s, dtype=torch.int64, device=dev)
        self._live = st
        return st

    def _warm(self, state):
        """Run the step and every prefill bucket once against the real
        state tensors — ``activate=False`` leaves the slots disarmed, so
        warm-up never corrupts serving state.  The paged warm-up runs
        with an all-zero table: every write lands in the scratch block."""
        plan = None
        if self._kv is not None:
            plan = AdmitPlan(start=0, cow_src=0, cow_dst=0,
                             prefix_hit=False, reused_tokens=0)
        for b in self.prefill_buckets:
            state, _out = self._prefill_fn(
                state, np.zeros((b,), np.int32), 1, 0, 0, 0.0, 0, False,
                plan)
        keep = np.ones((self.slots,), bool)
        state, _packed = self._step_fn(state, *self._step_inputs(keep))
        if self._cuda:
            self._stream.synchronize()
        return state

    def state_tensors(self):
        """The live state's tensors and the parameters (the card check
        that nothing of a replica sits on another device)."""
        params = [v for p in self._params.values()
                  for v in (p.values() if isinstance(p, dict) else [p])]
        live = self._live
        return (live.tensors() if live is not None else []) + params

    def set_health_hooks(self, on_error=None, on_ok=None,
                         on_migrate=None):
        """Install the pool's replica-health hooks (and its failover
        hand-off: ``on_migrate(sessions, exc)`` receives the sessions a
        failed dispatch was holding INSTEAD of them being shed).  Plain
        attribute flips, outside the engine lock (the hooks take the
        POOL's lock)."""
        self._on_step_error = on_error
        self._on_step_ok = on_ok
        self._on_migrate = on_migrate

    def rewarm(self):
        """Rebuild the functions (undoing any wrapper) and re-warm on a
        fresh state — the pool's quarantine re-warm.  Refuses a running
        or CLOSED engine, and one whose loop outlived its stop."""
        with self._cond:
            worker = self._worker
            if self._running or (worker is not None and worker.is_alive()):
                raise MXNetError("rewarm() needs a stopped engine")
            if self._closed:
                raise MXNetError("decode engine %r is closed"
                                 % self.name)
        state = self._build()
        with self._cond:
            self._boot_state = state
            self._draining = False

    # -- client side -------------------------------------------------------
    def _bucket(self, n):
        """The prefill length for ``n`` tokens: the smallest declared
        bucket that fits, else ``max_len`` (a resumed transcript only)."""
        return next((b for b in self.prefill_buckets if n <= b),
                    self.cfg.max_len)

    def _validate_admission(self, n, what, resumed=False):
        """The transcript-length admission validator shared by ``submit``
        and ``resume``; also enforces the paged block budget.  Raises
        :class:`InvalidRequest` for transcripts no engine of this shape
        could hold (a prompt past the largest bucket; a resumed
        transcript may pass it, up to ``max_len``), and
        :class:`KVBlocksExhausted` when the block pool is too small for
        the transcript even with every block free."""
        if n > self.prefill_buckets[-1] and not resumed:
            raise InvalidRequest(
                "%s of %d tokens exceeds the largest prefill bucket %d"
                % (what, n, self.prefill_buckets[-1]))
        if n >= self.cfg.max_len:
            raise InvalidRequest(
                "%s of %d tokens leaves no room under max_len=%d"
                % (what, n, self.cfg.max_len))
        if self._kv is not None and not self._kv.admissible(n):
            _telemetry.inc("serving.shed.count", model=self.name,
                           reason="kv_blocks")
            raise KVBlocksExhausted(
                "%s of %d tokens needs %d KV blocks but the pool holds "
                "only %d allocatable (%d blocks x %d tokens)"
                % (what, n, n // self._kv.block_size + 1,
                   self._kv.num_blocks - 1, self._kv.num_blocks,
                   self._kv.block_size))

    def submit(self, prompt, *, max_new_tokens=16, temperature=0.0,
               deadline_ms=None, on_token=None, on_done=None, seed=None,
               tenant=None, on_event=None):
        """Queue a generation request; returns its
        :class:`GenerateSession`.  Raises :class:`Overloaded` past the
        queue bound and :class:`InvalidRequest` for malformed prompts.

        ``seed`` pins the session's sampling stream; None draws one from
        :func:`mxnet_tpu_torch.random.next_seed`, so ``mx.random.seed(n)``
        makes single-stream runs reproducible end to end."""
        prompt = np.array(prompt, np.int32).ravel()
        if prompt.size < 1:
            raise InvalidRequest("empty prompt")
        self._validate_admission(int(prompt.size), "prompt")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab:
            raise InvalidRequest(
                "prompt token ids must be in 0..vocab-1=%d"
                % (self.cfg.vocab - 1))
        if int(max_new_tokens) < 1:
            raise InvalidRequest("max_new_tokens must be >= 1")
        if float(temperature) < 0:
            raise InvalidRequest("temperature must be >= 0")
        if seed is None:
            seed = _random.next_seed()
        sess = GenerateSession(prompt, max_new_tokens, temperature,
                               deadline_ms, on_token, on_done, seed=seed,
                               tenant=tenant, on_event=on_event)
        with self._cond:
            if self._closed:
                raise MXNetError("decode engine %r is closed" % self.name)
            if self._draining:
                _telemetry.inc("serving.shed.count", model=self.name,
                               reason="drain")
                raise Overloaded("decode engine %r is draining"
                                 % self.name)
            if len(self._queue) >= self.max_queue:
                _telemetry.inc("serving.shed.count", model=self.name,
                               reason="overload")
                raise Overloaded(
                    "decode engine %r overloaded: %d sessions queued"
                    % (self.name, len(self._queue)))
            # counted AFTER admission: sessions.count is accepted
            # sessions; rejected submits show only in serving.shed.count
            _telemetry.inc("serving.decode.sessions.count",
                           model=self.name, replica=self.replica)
            self._queue.append(sess)
            self._cond.notify()
        return sess

    def generate(self, prompt, timeout=60.0, **kw):
        """Blocking convenience: ``submit`` + ``result``."""
        sess = self.submit(prompt, **kw)
        try:
            return sess.result(timeout)
        except DeadlineExceeded:
            sess.cancel()
            raise

    def resume(self, sess):
        """Re-admit a migrated session (the pool's failover path): its
        transcript — ``prompt + tokens generated so far`` — is
        re-prefilled into a free slot and decoding continues with the
        same position-derived keys.  A transcript that outgrew the
        largest prefill bucket pads to ``max_len`` (the JAX engine
        refuses it, and its pool sheds the session).  Raises the
        engine's closed/draining errors.  Not bounded by ``max_queue``
        (the session already holds pool admission); resumed sessions
        jump the queue."""
        full = int(sess.prompt.size) + len(sess.tokens)
        self._validate_admission(
            full, "migrated transcript (prompt %d + generated %d)"
            % (sess.prompt.size, len(sess.tokens)), resumed=True)
        with self._cond:
            if self._closed:
                raise MXNetError("decode engine %r is closed" % self.name)
            if self._draining:
                raise Overloaded("decode engine %r is draining"
                                 % self.name)
            self._queue.appendleft(sess)
            self._cond.notify()
        return sess

    # -- introspection -----------------------------------------------------
    def heartbeat_age(self):
        """Seconds since the serve loop last proved liveness, or None
        when no worker is running.  The loop stamps every iteration (an
        idle engine waits 20 ms between them), so only a wedged step or a
        dead worker goes stale: the fleet controller's per-replica
        liveness probe."""
        with self._cond:
            if self._thread is None:
                return None
            return time.monotonic() - self._beat

    def pending_rows(self):
        """Queued plus active sessions — the graceful-drain quiescence
        probe (one row == one sequence)."""
        with self._cond:
            return len(self._queue) + \
                sum(1 for x in self._slot_sessions if x is not None)

    def describe(self):
        with self._cond:
            active = sum(1 for x in self._slot_sessions if x is not None)
            queued = len(self._queue)
            steps = self.steps
            tokens = self.tokens_out
            resumed = self.resumed
            reprefilled = self.reprefilled_tokens
        if self._kv is not None:
            kv = self._kv.describe()
        else:
            hd = self.cfg.embed // self.cfg.heads
            kv = {"layout": "dense",
                  "hbm_bytes": (2 * self.cfg.layers * self.slots
                                * self.cfg.max_len * self.cfg.heads
                                * hd * 4)}
        return {"name": self.name, "kind": "generate",
                "version": getattr(self, "version", None),
                "replica": self.replica, "device": str(self._device),
                "slots": self.slots, "active": active, "queued": queued,
                "steps": steps, "tokens": tokens,
                "sessions_resumed": resumed,
                "reprefilled_tokens": reprefilled,
                "prefill_buckets": list(self.prefill_buckets),
                "max_len": self.cfg.max_len, "kv": kv}

    # -- worker ------------------------------------------------------------
    def start(self):
        with self._cond:
            if self._closed:
                raise MXNetError("decode engine %r is closed"
                                 % self.name)
            if self._thread is not None:
                return self
            if self._boot_state is None:
                # restart after a plain stop(): only the slot state was
                # consumed — rebuild it from zeros
                self._boot_state = self._fresh_state()
            self._draining = False
            self._running = True
            self._beat = time.monotonic()
            self._thread = self._worker = self._lane.submit(
                self._serve_loop)
        return self

    def stop(self, drain=True, deadline=None, hand_off=None):
        """Stop the engine.  ``drain=True`` keeps stepping until every
        ACTIVE sequence finishes (new admissions stop; queued sessions
        are shed with a typed error) under ``deadline`` seconds
        (``MXNET_PREEMPT_DRAIN_DEADLINE``, default 30); past it — or with
        ``drain=False`` — unfinished sessions are shed, never silently
        dropped.  ``hand_off`` (a callable taking a session list) is the
        failover alternative to shedding: queued and slot-holding
        sessions are handed over intact for the pool to re-admit
        elsewhere.  Returns True when the stop lost nothing."""
        if deadline is None:
            deadline = float(os.environ.get(
                "MXNET_PREEMPT_DRAIN_DEADLINE", "30") or 30)
        shed = []
        with self._cond:
            self._draining = True
            if not drain:
                self._running = False
            while self._queue:
                shed.append(self._queue.popleft())
            self._cond.notify_all()
        err = MXNetError("decode engine %r stopped before this session "
                         "was served" % self.name)
        clean = not shed or hand_off is not None
        if hand_off is not None and shed:
            hand_off(shed)
        else:
            for sess in shed:
                _telemetry.inc("serving.shed.count", model=self.name,
                               reason="drain")
                self._finish(sess, error=err)
        with self._cond:
            t, self._thread = self._thread, None
        worker_dead = True
        if t is not None:
            t.join(timeout=deadline if drain else 5.0)
            if t.is_alive():
                clean = False
                with self._cond:
                    self._running = False
                    self._cond.notify_all()
                t.join(timeout=10.0)
            worker_dead = not t.is_alive()
        # anything still holding a slot is handed off or shed typed —
        # hand-off REQUIRES the worker to be provably gone, or a wedged
        # step that returns later would append tokens to a session
        # another replica now owns
        leftovers = []
        with self._cond:
            for i, sess in enumerate(self._slot_sessions):
                if sess is not None:
                    leftovers.append(sess)
                    self._slot_sessions[i] = None
        if hand_off is not None and leftovers and worker_dead:
            hand_off(leftovers)
        else:
            for sess in leftovers:
                clean = False
                _telemetry.inc("serving.shed.count", model=self.name,
                               reason="drain")
                self._finish(sess, error=err)
        self._occupancy_gauge()
        return clean

    def close(self, drain=True):
        """Permanent :meth:`stop`: further submits fail fast, and the
        device state is released."""
        with self._cond:
            self._closed = True
        clean = self.stop(drain=drain)
        worker = self._worker
        if worker is None or not worker.is_alive():
            # no worker is left to release the state at its loop's end
            self._release_state()
        return clean

    def _release_state(self):
        """Drop the device state of a closed engine and give its lane back
        for the next engine on this card (with the blocks the allocator
        cached for its stream and the cuBLAS workspace of its thread).
        Called once nothing of this engine can use the lane again: by the
        loop as it ends, or by ``close`` when no loop is alive.
        Idempotent."""
        with self._cond:
            self._boot_state = self._live = None
            self._stream = None
            lane, self._lane = self._lane, None
        if lane is not None:
            _give_back_lane(self._device, lane)

    def _serve_loop(self):
        with self._cond:
            state = self._boot_state
            self._boot_state = None
        while state is not None:
            state = self._tick(state)
        with self._cond:
            closed = self._closed
        if closed:
            # closed or hard-killed: the state is unreferenced once the
            # loop is out, so the cache is free (and the stream idle)
            # before the pool can replace the replica
            self._release_state()

    def _tick(self, state):
        """One loop iteration: the admission scan, the admissions, then
        at most one step.  Returns the state, or None when the loop must
        end.  An idle engine waits 20 ms here."""
        admits = []
        shed = []  # (session, reason) — finished OUTSIDE the lock:
        # _finish runs the pool's on_done hook, which takes the POOL
        # lock, and pool.describe() takes pool-then-engine
        with self._cond:
            if not self._running:
                return None
            # the liveness heartbeat (heartbeat_age): every iteration,
            # idle ones included
            self._beat = time.monotonic()
            free = [i for i, x in enumerate(self._slot_sessions)
                    if x is None]
            # walk the WHOLE queue every iteration: abandoned or expired
            # entries must release the max_queue bound (and the pool's
            # outstanding accounting) even while every slot is busy
            now = time.monotonic()
            keep = deque()
            while self._queue:
                sess = self._queue.popleft()
                if sess.cancelled():
                    shed.append((sess, "abandoned"))
                elif sess.deadline is not None and now > sess.deadline:
                    shed.append((sess, "deadline"))
                elif free:
                    sess.slot = free.pop(0)
                    self._slot_sessions[sess.slot] = sess
                    admits.append(sess)
                else:
                    keep.append(sess)
            self._queue = keep
            have_active = any(x is not None for x in self._slot_sessions)
            if not admits and not shed and not have_active:
                if self._draining:
                    self._running = False
                    return None
                self._cond.wait(0.02)
                return state
        for sess, reason in shed:
            # every exit path resolves the future and fires on_done
            _telemetry.inc("serving.shed.count", model=self.name,
                           reason=reason)
            err = DeadlineExceeded("deadline expired while queued for a "
                                   "decode slot") \
                if reason == "deadline" else \
                MXNetError("session abandoned by the client while queued")
            self._finish(sess, error=err)
        for sess in admits:
            state, aborted = self._admit(sess, state)
            if aborted:
                # _fail_all already resolved EVERY reserved slot
                break
        with self._cond:
            have_active = any(x is not None for x in self._slot_sessions)
        if have_active:
            state = self._step(state)
        return state

    def _admit(self, sess, state):
        """Prefill ``sess`` into its (already reserved) slot: one
        bucket-shaped prefill + one admission-time host read for the
        first token (TTFT).  A migrated session re-prefills its whole
        transcript; the ``limit`` stays derived from the ORIGINAL prompt
        length.  Returns ``(state, aborted)``; aborted means the prefill
        failed and :meth:`_fail_all` resolved every held session."""
        cfg = self.cfg
        p0 = int(sess.prompt.size)
        resumed = len(sess.tokens) > 0
        if resumed:
            full = np.concatenate([sess.prompt,
                                   np.asarray(sess.tokens, np.int32)])
        else:
            full = sess.prompt
        n = int(full.size)
        limit = min(p0 + sess.max_new_tokens - 1, cfg.max_len)
        if self._kv is not None:
            try:
                plan = self._kv.admit(sess.slot, full)
            except Overloaded as e:
                # typed KV shed: nothing was run, no blocks are held
                _telemetry.inc("serving.shed.count", model=self.name,
                               reason="kv_blocks")
                self._retire(sess, error=e)
                self._occupancy_gauge()
                return state, False
            # prefix-hit admissions prefill ONLY the unshared suffix,
            # bucketed by the suffix length
            suffix = n - plan.start
            bucket = self._bucket(suffix)
            tokens = np.zeros((bucket,), np.int32)
            tokens[:suffix] = full[plan.start:]
        else:
            plan = None
            bucket = self._bucket(n)
            tokens = np.zeros((bucket,), np.int32)
            tokens[:n] = full
        try:
            state, out = self._prefill_fn(
                state, tokens, n, sess.slot, limit, sess.temperature,
                sess.seed, True, plan)
            out = self._read(out)  # the admission-time first-token read
        except Exception as e:  # noqa: broad-except — a failed prefill
            # may have left the state half-written: fail every held
            # session and restart from zeros (the queue is untouched)
            return self._fail_all(e, state), True
        if plan is not None:
            self._slot_len[sess.slot] = n
            # index the (now device-resident) prompt for future
            # admissions — after a successful prefill only
            self._kv.offer(sess.slot, sess.prompt)
        now = time.monotonic()
        tok = int(out[0])
        sess.tokens.append(tok)
        self._emit(sess, tok)
        if sess.t_first is None:
            # TTFT is first token EVER — a migrated session already
            # paid (and recorded) its first-token latency
            sess.t_first = now
            _telemetry.observe("serving.decode.ttft_seconds",
                               sess.t_first - sess.t_submit,
                               buckets=TTFT_BUCKETS, model=self.name)
        _telemetry.inc("serving.decode.tokens.count", model=self.name,
                       replica=self.replica)
        with self._cond:
            sess.admit_step = self.steps
            self.tokens_out += 1
            self._rate_tokens += 1
            if resumed:
                self.resumed += 1
                self.reprefilled_tokens += n
        if resumed:
            _telemetry.inc("serving.failover.reprefill_tokens.count", n,
                           model=self.name, replica=self.replica)
            if sess.migrate_t0 is not None:
                # failure-to-resumed, queue wait and re-prefill included
                _telemetry.observe("serving.failover.recovery_seconds",
                                   now - sess.migrate_t0,
                                   model=self.name)
                sess.migrate_t0 = None
        if out[1]:  # EOS or max_new_tokens == 1: done at prefill
            self._retire(sess)
        self._occupancy_gauge()
        return state, False

    def _read(self, t):
        """Copy a device result to the host, on the engine's stream: the
        copy waits for the kernels that wrote ``t`` (a copy on another
        stream would not)."""
        with self._on_stream():
            return t.cpu().numpy()

    def _step_inputs(self, keep):
        """Stage the step's host inputs and copy them to the device:
        ``keep`` and, paged, the block tables (one small int copy each;
        host-to-device, no sync)."""
        self._keep_host.numpy()[:] = keep
        with self._on_stream():
            self._keep_dev.copy_(self._keep_host, non_blocking=True)
            if self._kv is None:
                return self._keep_dev, None
            self._tables_host.numpy()[:] = self._kv.tables
            self._tables_dev.copy_(self._tables_host, non_blocking=True)
            return self._keep_dev, self._tables_dev

    def _step(self, state):
        """ONE fixed-shape decode step for all slots + the single packed
        host read; host bookkeeping fans tokens out to sessions."""
        keep = np.ones((self.slots,), bool)
        with self._cond:
            sessions = list(self._slot_sessions)
        now = time.monotonic()
        for i, sess in enumerate(sessions):
            if sess is None:
                continue
            if sess.cancelled():
                keep[i] = False
            elif sess.deadline is not None and now > sess.deadline:
                keep[i] = False
        if self._kv is not None:
            # block-boundary appends: the step writes each live slot's
            # K/V at position ``lengths`` — that block must exist first;
            # a dry pool sheds the session typed
            for i, sess in enumerate(sessions):
                if sess is None or not keep[i]:
                    continue
                try:
                    self._kv.append(i, min(self._slot_len[i],
                                           self.cfg.max_len - 1))
                except Overloaded as e:
                    keep[i] = False
                    sessions[i] = None
                    _telemetry.inc("serving.shed.count",
                                   model=self.name, reason="kv_blocks")
                    self._retire(sess, error=e)
        t0 = time.perf_counter()
        try:
            if _faults.should_fire("serving.decode"):
                raise _faults.FaultInjected(
                    "fault 'serving.decode': decode step of model %r "
                    "killed" % self.name)
            if _faults.should_fire("serving.replica.kill"):
                # a hard replica death, not a transient step fault: the
                # engine closes for good (the worker exits, submits fail
                # fast, rewarm refuses) and every held session goes down
                # the migration path
                with self._cond:
                    self._closed = True
                    self._running = False
                raise ReplicaKilled(
                    "fault 'serving.replica.kill': replica %s of model %r "
                    "hard-killed mid-generation" % (self.replica, self.name))
            state, packed = self._step_fn(state, *self._step_inputs(keep))
            packed = self._read(packed)  # THE one host read of the step
        except Exception as e:  # noqa: broad-except — a failed step
            # hands every held session to the pool (or errors them)
            return self._fail_all(e, state)
        dt = time.perf_counter() - t0
        emitted = 0
        for i, sess in enumerate(sessions):
            if sess is None:
                continue
            if not keep[i]:
                reason = "abandoned" if sess.cancelled() else "deadline"
                _telemetry.inc("serving.shed.count", model=self.name,
                               reason=reason)
                err = DeadlineExceeded("session deadline expired "
                                       "mid-generation") \
                    if reason == "deadline" else \
                    MXNetError("session abandoned by the client")
                self._retire(sess, error=err)
                continue
            tok = int(packed[0, i])
            if tok >= 0:
                emitted += 1
                sess.tokens.append(tok)
                self._emit(sess, tok)
                # host mirror of the device ``lengths`` advance
                self._slot_len[i] += 1
            if packed[1, i]:
                self._retire(sess)
        with self._cond:
            self.steps += 1
            self.tokens_out += emitted
            self._rate_tokens += emitted
            rate_t0, rate_tokens = self._rate_t0, self._rate_tokens
        _telemetry.inc("serving.decode.steps.count", model=self.name,
                       replica=self.replica)
        if emitted:
            _telemetry.inc("serving.decode.tokens.count", emitted,
                           model=self.name, replica=self.replica)
        _telemetry.observe("serving.decode.token_latency_seconds", dt,
                           buckets=LATENCY_BUCKETS, model=self.name)
        elapsed = time.monotonic() - rate_t0
        if elapsed >= 0.5:
            _telemetry.set_gauge("serving.decode.tokens_per_sec",
                                 rate_tokens / elapsed, model=self.name,
                                 replica=self.replica)
            with self._cond:
                self._rate_t0 = time.monotonic()
                self._rate_tokens = 0
        self._occupancy_gauge()
        if self._on_step_ok is not None:
            self._on_step_ok()
        return state

    def _fail_all(self, exc, _failed_state):
        """A failed step or prefill may leave the state half-written:
        every held session goes to the pool's migration hook (or, with no
        pool above, gets the error), the state restarts from zeros, and
        the worker survives to serve the queue.  A hard-killed engine
        (:class:`ReplicaKilled`) returns None instead: its worker ends and
        releases the device state."""
        _telemetry.inc("serving.error.count", model=self.name)
        with self._cond:
            held = [x for x in self._slot_sessions if x is not None]
            self._slot_sessions = [None] * self.slots
        # health first: the pool opens the circuit BEFORE the migration
        # hook picks a target, so a failing replica does not re-admit
        # its own casualties
        if self._on_step_error is not None:
            self._on_step_error(exc)
        if held:
            migrate = self._on_migrate
            if migrate is not None:
                try:
                    migrate(held, exc)
                except Exception:  # noqa: broad-except — a broken
                    # migration hook must not silently drop sessions
                    _log.warning("decode: migration hook failed; "
                                 "shedding held sessions", exc_info=True)
                    for sess in held:
                        self._finish(sess, error=exc)
            else:
                for sess in held:
                    self._finish(sess, error=exc)
        self._occupancy_gauge()
        if isinstance(exc, ReplicaKilled):
            # nothing of this engine runs again: no fresh state; the loop
            # ends and releases this one
            return None
        return self._fresh_state()

    # -- session completion ------------------------------------------------
    def _emit(self, sess, tok):
        if sess.on_token is None:
            return
        try:
            sess.on_token(tok)
        except Exception:  # noqa: broad-except — a client callback must
            # never kill the engine thread; drop the stream, keep result()
            _log.warning("decode: on_token callback of %r failed; "
                         "disabling the stream", self.name, exc_info=True)
            sess.on_token = None

    def _retire(self, sess, error=None):
        freed_slot = None
        with self._cond:
            if sess.slot is not None \
                    and self._slot_sessions[sess.slot] is sess:
                self._slot_sessions[sess.slot] = None
                freed_slot = sess.slot
            sess.done_step = self.steps
        if freed_slot is not None and self._kv is not None:
            # outside the engine lock (the allocator has its own); the
            # slot cannot be re-admitted concurrently — admissions run on
            # this same engine thread
            self._kv.release(freed_slot)
        self._finish(sess, error=error)

    def _finish(self, sess, error=None):
        # idempotent ACROSS ENGINES through the session's own lock
        sess._resolve(error=error)

    def _occupancy_gauge(self):
        with self._cond:
            active = sum(1 for x in self._slot_sessions if x is not None)
        _telemetry.set_gauge("serving.decode.slot_occupancy",
                             active / float(self.slots), model=self.name,
                             replica=self.replica)
        if self._kv is not None:
            self._kv.note_sessions(active)
