"""Preemption-tolerant checkpointing: batch-granular snapshots written
asynchronously (counterpart of ``mxnet_tpu/checkpoint.py``).

* **Capture on the device.**  A snapshot starts as device-to-device copies
  of every parameter, auxiliary state and optimizer state array
  (``Module._capture_state_arrays``: one flat buffer per dtype, a few
  launches, no host sync) and a ``torch.cuda.Event`` recorded after them.
  The small host state (iterator position, random state, metric sums,
  update counts) is taken at once; it is dict-sized.
* **One writer thread.**  :class:`AsyncSnapshotWriter` takes the
  snapshot, waits on its event from a CUDA stream of its own, copies each
  flat buffer to pinned host memory there (never on the legacy default
  stream, which would serialize against the training stream's replays)
  and writes the files through ``base.atomic_write``, the manifest entry
  last, so a crash at any byte leaves the previous generation loadable.
  At most one snapshot is in flight: one that arrives while the writer is
  busy is dropped and counted (``resilience.checkpoint.async_dropped``).
  A write error surfaces at :meth:`AsyncSnapshotWriter.drain` and
  :meth:`~AsyncSnapshotWriter.close`, so at ``fit``'s exit.
* **sha256 on every payload.**  The manifest records each file's digest;
  resume hashes again before loading and falls back a generation on a
  mismatch (``resilience.checkpoint.corrupt_skipped``).
* **Generations.**  ``MXNET_CKPT_KEEP_LAST`` (default 3) snapshot
  generations stay on disk; the collector removes a generation's manifest
  entry before its files, so a crash between leaves an orphan file (swept
  by the next pass), never an entry without its bytes.

Every generation is one params file and one states file: the port has no
mesh, so the JAX package's sharded payloads have no counterpart.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time

import torch

from . import telemetry as _telemetry
from .base import MXNetError, atomic_write, atomic_write_bytes
from .ndarray import NDArray
from .optimizer import dumps_states, map_state, state_arrays

__all__ = ["TrainingPreempted", "Snapshot", "TrainingState",
           "AsyncSnapshotWriter", "snapshot_path", "write_snapshot",
           "gc_snapshots", "discard_snapshots_from", "load_latest_state",
           "latest_generation_summary", "keep_last_default"]

#: iterator states longer than this (JSON bytes) go to a file of their
#: own beside the generation instead of into the manifest
ITER_STATE_INLINE_BYTES = 16384


class TrainingPreempted(MXNetError):
    """``Module.fit`` was preempted (SIGTERM or SIGINT) and drained: the
    batch in flight finished and a last checkpoint was written.
    ``checkpoint_path`` names it (None without ``checkpoint_prefix``);
    ``epoch`` and ``nbatch`` locate the last completed batch (``nbatch``
    None at an epoch boundary)."""

    def __init__(self, msg, checkpoint_path=None, epoch=None, nbatch=None,
                 signum=None):
        super().__init__(msg)
        self.checkpoint_path = checkpoint_path
        self.epoch = epoch
        self.nbatch = nbatch
        self.signum = signum


class Snapshot:
    """One captured mid-epoch training state, before it is written.

    ``arg_params``/``aux_params`` map names to NDArray device copies and
    ``opt_states`` is the updater's ``{index: state}`` of copies, a state
    being None, an NDArray or a tuple of them (None without an updater);
    ``ready`` is the CUDA event recorded after the copies on the training
    stream (None on the CPU).  The rest are JSON-able host dicts."""

    __slots__ = ("epoch", "nbatch", "arg_params", "aux_params",
                 "opt_states", "opt_counts", "rng_state", "metric_state",
                 "iter_state", "ready")

    def __init__(self, epoch, nbatch, arg_params, aux_params,
                 opt_states=None, opt_counts=None, rng_state=None,
                 metric_state=None, iter_state=None, ready=None):
        self.epoch = int(epoch)
        self.nbatch = int(nbatch)
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.opt_states = opt_states
        self.opt_counts = opt_counts
        self.rng_state = rng_state
        self.metric_state = metric_state
        self.iter_state = iter_state
        self.ready = ready


class TrainingState:
    """What resume recovers: the newest verified state under a prefix.
    ``nbatch`` is None for an epoch checkpoint (resume starts epoch
    ``epoch`` at batch 0) and the last completed batch for a mid-epoch
    snapshot (resume continues at ``nbatch + 1``)."""

    __slots__ = ("epoch", "nbatch", "arg_params", "aux_params",
                 "states_path", "states_bytes", "rng_state",
                 "metric_state", "iter_state", "opt_counts", "path")

    def __init__(self, epoch, nbatch, arg_params, aux_params,
                 states_path=None, states_bytes=None, rng_state=None,
                 metric_state=None, iter_state=None, opt_counts=None,
                 path=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.states_path = states_path
        self.states_bytes = states_bytes
        self.rng_state = rng_state
        self.metric_state = metric_state
        self.iter_state = iter_state
        self.opt_counts = opt_counts
        self.path = path


def keep_last_default():
    """Snapshot generations kept on disk (``MXNET_CKPT_KEEP_LAST``)."""
    return int(os.environ.get("MXNET_CKPT_KEEP_LAST", "3") or 3)


def snapshot_path(prefix, epoch, nbatch, kind="params"):
    """``<prefix>-snap-EEEE-BBBBBB.<kind>``: apart from the epoch
    checkpoints' ``<prefix>-EEEE.params``, so the epoch scan never takes a
    snapshot for a completed epoch."""
    return "%s-snap-%04d-%06d.%s" % (prefix, epoch, nbatch, kind)


def _leaves(snap):
    out = list(snap.arg_params.values()) + list(snap.aux_params.values())
    out += [a for s in (snap.opt_states or {}).values()
            for a in state_arrays(s)]
    return out


def _to_host(snap):
    """The snapshot's arrays moved to the host in place.  Each flat
    buffer behind the copies is copied once, into pinned memory, on a
    stream of this thread's that first waits on ``snap.ready``; the
    stream is synchronized before the device buffers are let go, so the
    caching allocator cannot hand them out while the copy reads them."""
    cuda = [a for a in _leaves(snap) if a._t.is_cuda]
    if not cuda:
        return
    dev = cuda[0]._t.device
    stream = torch.cuda.Stream(dev)
    if snap.ready is not None:
        stream.wait_event(snap.ready)
    bases = {}
    for a in cuda:
        base = a._t._base if a._t._base is not None else a._t
        bases.setdefault(id(base), base)
    host = {}
    with torch.cuda.stream(stream):
        for key, base in bases.items():
            h = torch.empty(base.shape, dtype=base.dtype, pin_memory=True)
            h.copy_(base, non_blocking=True)
            host[key] = (base, h)
    stream.synchronize()

    def _moved(a):
        t = a._t
        if not t.is_cuda:
            return a
        base, h = host[id(t._base if t._base is not None else t)]
        return NDArray(h.as_strided(t.size(), t.stride(),
                                    t.storage_offset()
                                    - base.storage_offset()))

    snap.arg_params = {k: _moved(v) for k, v in snap.arg_params.items()}
    snap.aux_params = {k: _moved(v) for k, v in snap.aux_params.items()}
    if snap.opt_states is not None:
        snap.opt_states = {i: map_state(_moved, s)
                           for i, s in snap.opt_states.items()}
    snap.ready = None


def write_snapshot(prefix, snap, logger=logging, keep_last=None):
    """Write ``snap`` under ``prefix`` (blocking; the device-to-host copy
    happens here): the payload files first, each atomic, then the
    manifest entry with their sha256s, then the retention pass.  Returns
    the params path."""
    from . import model as _model
    from . import ndarray as nd

    t0 = time.perf_counter()
    _to_host(snap)
    params_path = snapshot_path(prefix, snap.epoch, snap.nbatch, "params")
    save_dict = {("arg:%s" % k): v for k, v in snap.arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in snap.aux_params.items()})
    # durable=False: atomic against the death of the process (the
    # preemption case) without the fsync stalls; the epoch checkpoint is
    # durable
    atomic_write(params_path, lambda tmp: nd.save(tmp, save_dict),
                 durable=False)
    entry = {"epoch": snap.epoch, "nbatch": snap.nbatch,
             "params": os.path.basename(params_path),
             "sha256": _model._sha256_file(params_path),
             "states": None, "states_sha256": None}
    if snap.opt_states is not None:
        states_path = snapshot_path(prefix, snap.epoch, snap.nbatch,
                                    "states")
        blob = dumps_states(snap.opt_states)
        atomic_write_bytes(states_path, blob, durable=False)
        entry["states"] = os.path.basename(states_path)
        entry["states_sha256"] = hashlib.sha256(blob).hexdigest()
    entry.update({"opt_counts": snap.opt_counts,
                  "rng_state": snap.rng_state,
                  "metric_state": snap.metric_state,
                  "iter_state": snap.iter_state})
    if snap.iter_state is not None:
        blob = json.dumps(snap.iter_state).encode()
        if len(blob) > ITER_STATE_INLINE_BYTES:
            iter_path = snapshot_path(prefix, snap.epoch, snap.nbatch,
                                      "iter.json")
            atomic_write_bytes(iter_path, blob, durable=False)
            entry["iter_state"] = None
            entry["iter_state_file"] = os.path.basename(iter_path)
            entry["iter_state_sha256"] = hashlib.sha256(blob).hexdigest()
    # the commit point: a crash before it leaves orphan files for a later
    # collection, never a manifest entry without its bytes
    _model._manifest_add_snapshot(prefix, entry)
    gc_snapshots(prefix, keep_last=keep_last, logger=logger)
    _telemetry.inc("resilience.checkpoint.saves")
    _telemetry.observe("resilience.checkpoint.async_write_seconds",
                       time.perf_counter() - t0)
    _telemetry.event("checkpoint.snapshot", epoch=snap.epoch,
                     nbatch=snap.nbatch, path=params_path)
    return params_path


#: manifest keys naming the files of one snapshot generation
_PAYLOAD_KEYS = ("params", "states", "iter_state_file")


def _entry_payload_names(entry):
    return [entry[k] for k in _PAYLOAD_KEYS if entry.get(k)]


def _unlink_victims(victims, prefix, logger):
    removed = 0
    for path in victims:
        try:
            os.unlink(path)
            removed += 1
        except OSError:
            pass
    if removed:
        _telemetry.inc("resilience.checkpoint.pruned", removed)
        logger.debug("checkpoint GC: removed %d pruned snapshot files "
                     "under %r", removed, prefix)
    return removed


def gc_snapshots(prefix, keep_last=None, logger=logging):
    """Prune snapshot generations beyond the newest ``keep_last``: their
    manifest entries first, then their files, then any ``-snap-`` file
    the manifest does not name (left by a crash between the two)."""
    from . import model as _model

    if keep_last is None:
        keep_last = keep_last_default()
    keep_last = max(1, keep_last)
    pruned = _model._manifest_prune_snapshots(prefix, keep_last)
    if not pruned:
        return 0
    base_dir = os.path.dirname(os.path.abspath(prefix)) or "."
    victims = [os.path.join(base_dir, name)
               for entry in pruned for name in _entry_payload_names(entry)]
    live = set()
    for entry in (_model.checkpoint_manifest(prefix) or {}).get(
            "snapshots", []):
        live.update(_entry_payload_names(entry))
    marker = "%s-snap-" % os.path.basename(prefix)
    try:
        for name in os.listdir(base_dir):
            if name.startswith(marker) and name not in live and \
                    name.endswith((".params", ".states", ".iter.json")):
                victims.append(os.path.join(base_dir, name))
    except OSError:
        pass
    return _unlink_victims(victims, prefix, logger)


def discard_snapshots_from(prefix, epoch, logger=logging):
    """Drop every snapshot generation of loop epoch ``epoch`` or later,
    manifest first like :func:`gc_snapshots`."""
    from . import model as _model

    snaps = (_model.checkpoint_manifest(prefix) or {}).get("snapshots", [])
    doomed = [s for s in snaps if int(s.get("epoch", -1)) >= epoch]
    if not doomed:
        return 0
    keys = {_model._snap_key(s) for s in doomed}

    def _drop(man):
        man["snapshots"] = [s for s in man.get("snapshots", [])
                            if _model._snap_key(s) not in keys]

    _model._manifest_mutate(prefix, _drop, durable=False)
    base_dir = os.path.dirname(os.path.abspath(prefix)) or "."
    logger.info("discarded %d snapshot generation(s) under %r",
                len(doomed), prefix)
    return _unlink_victims([os.path.join(base_dir, name) for s in doomed
                            for name in _entry_payload_names(s)],
                           prefix, logger)


def _verified(path, want_sha, logger, what):
    """True when ``path`` exists and hashes to ``want_sha``."""
    from . import model as _model

    if not os.path.exists(path):
        logger.warning("resume: %s %s is missing; falling back", what, path)
        return False
    got = _model._sha256_file(path)
    if want_sha and got != want_sha:
        logger.warning(
            "resume: %s %s failed sha256 verification (manifest %s..., "
            "file %s...); falling back to the previous generation",
            what, path, want_sha[:12], got[:12])
        return False
    return True


def _generation_candidates(prefix, manifest):
    """Every resumable generation as ``(key, kind, payload)``: epoch
    checkpoint E at key ``(E, -1)``, so a snapshot of epoch E sorts newer;
    snapshots at ``(epoch, nbatch)`` (malformed entries skipped)."""
    from . import model as _model

    candidates = []
    for entry in manifest.get("snapshots", []):
        try:
            key = (int(entry["epoch"]), int(entry["nbatch"]))
        except (KeyError, TypeError, ValueError):
            continue
        candidates.append((key, "snapshot", entry))
    for epoch in _model.list_checkpoints(prefix):
        candidates.append(((epoch, -1), "epoch", epoch))
    return candidates


def latest_generation_summary(prefix):
    """``{"epoch", "nbatch", "kind"}`` of the newest generation by the
    manifest alone (no file read or verified), or None: where
    ``resume="auto"`` would land if every file verifies."""
    from . import model as _model

    candidates = _generation_candidates(
        prefix, _model.checkpoint_manifest(prefix) or {})
    if not candidates:
        return None
    (epoch, nbatch), kind, _ = max(candidates, key=lambda c: c[0])
    return {"epoch": epoch, "nbatch": None if nbatch < 0 else nbatch,
            "kind": "checkpoint" if kind == "epoch" else "snapshot"}


def _split_params(save_dict):
    arg, aux = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg[name] = v
        elif tp == "aux":
            aux[name] = v
    return arg, aux


def load_latest_state(prefix, logger=logging):
    """The newest verified :class:`TrainingState` under ``prefix``, or
    None: epoch checkpoints and snapshots in one order, each file's sha256
    checked (and each epoch checkpoint loaded) before it is trusted; a
    corrupt generation is skipped, counted in
    ``resilience.checkpoint.corrupt_skipped``, and the next older one
    tried."""
    from . import model as _model
    from . import ndarray as nd

    m = _model.checkpoint_manifest(prefix) or {}
    base_dir = os.path.dirname(os.path.abspath(prefix)) or "."
    candidates = sorted(_generation_candidates(prefix, m),
                        key=lambda c: c[0], reverse=True)

    def skip():
        _telemetry.inc("resilience.checkpoint.corrupt_skipped")

    for _key, kind, payload in candidates:
        if kind == "epoch":
            epoch = payload
            params = "%s-%04d.params" % (prefix, epoch)
            sha = (m.get("payload_sha256") or {}).get(str(epoch))
            if sha and not _verified(params, sha, logger,
                                     "epoch checkpoint"):
                skip()
                continue
            try:
                _sym, arg, aux = _model.load_checkpoint(prefix, epoch)
            except (MXNetError, OSError, ValueError) as e:
                logger.warning(
                    "checkpoint %s failed load verification (%s); "
                    "falling back to the previous generation", params, e)
                skip()
                continue
            states = "%s-%04d.states" % (prefix, epoch)
            return TrainingState(
                epoch=epoch, nbatch=None, arg_params=arg, aux_params=aux,
                states_path=states if os.path.exists(states) else None,
                path=params)
        entry = payload
        params = os.path.join(base_dir, entry["params"])
        if not _verified(params, entry.get("sha256"), logger,
                         "snapshot payload"):
            skip()
            continue
        states_bytes = None
        if entry.get("states"):
            states = os.path.join(base_dir, entry["states"])
            if not _verified(states, entry.get("states_sha256"), logger,
                             "snapshot optimizer states"):
                skip()
                continue
            with open(states, "rb") as f:
                states_bytes = f.read()
        iter_state = entry.get("iter_state")
        if entry.get("iter_state_file"):
            iter_path = os.path.join(base_dir, entry["iter_state_file"])
            if not _verified(iter_path, entry.get("iter_state_sha256"),
                             logger, "snapshot iterator state"):
                skip()
                continue
            try:
                with open(iter_path, "rb") as f:
                    iter_state = json.loads(f.read())
            except (OSError, ValueError) as e:
                logger.warning("snapshot iterator state %s failed to "
                               "parse (%s); falling back", iter_path, e)
                skip()
                continue
        try:
            arg, aux = _split_params(nd.load(params))
        except (MXNetError, OSError, ValueError) as e:
            logger.warning("snapshot %s failed load verification (%s); "
                           "falling back", params, e)
            skip()
            continue
        return TrainingState(
            epoch=int(entry["epoch"]), nbatch=int(entry["nbatch"]),
            arg_params=arg, aux_params=aux, states_bytes=states_bytes,
            rng_state=entry.get("rng_state"),
            metric_state=entry.get("metric_state"), iter_state=iter_state,
            opt_counts=entry.get("opt_counts"), path=params)
    return None


class AsyncSnapshotWriter:
    """One background thread writing the snapshots of one ``fit``.

    :meth:`submit` hands a captured :class:`Snapshot` over without
    blocking; while the writer is busy (writing, or one already queued)
    a new snapshot is dropped and counted, since each pending snapshot
    holds a full set of device copies.  :meth:`close` writes what is
    queued (unless ``drain=False``) and joins the thread.  ``sync=True``
    writes inline in :meth:`submit` (``MXNET_CKPT_ASYNC=0``)."""

    def __init__(self, prefix, keep_last=None, logger=logging, sync=False):
        self.prefix = prefix
        self.keep_last = keep_last
        self.logger = logger
        self.sync = sync
        self._cv = threading.Condition()
        self._slot = None
        self._busy = False
        self._closed = False
        self._error = None
        self._thread = None
        self._warned_drop = False
        if not sync:
            self._thread = threading.Thread(
                target=self._run, name="ckpt-writer", daemon=True)
            self._thread.start()

    def submit(self, snap):
        """Queue ``snap``; False (and a counted drop) when busy."""
        if self.sync:
            self._write(snap)
            return True
        with self._cv:
            if self._closed:
                return False
            if self._busy or self._slot is not None:
                _telemetry.inc("resilience.checkpoint.async_dropped")
                log = self.logger.debug if self._warned_drop \
                    else self.logger.warning
                self._warned_drop = True
                log("async checkpoint: writer busy at epoch %d batch %d; "
                    "snapshot dropped (at most one in flight)",
                    snap.epoch, snap.nbatch)
                return False
            self._slot = (snap, time.perf_counter())
            self._cv.notify_all()
        return True

    def _write(self, snap):
        _telemetry.set_gauge("resilience.checkpoint.async_inflight", 1)
        try:
            write_snapshot(self.prefix, snap, logger=self.logger,
                           keep_last=self.keep_last)
        finally:
            _telemetry.set_gauge("resilience.checkpoint.async_inflight", 0)

    def _run(self):
        while True:
            with self._cv:
                while self._slot is None and not self._closed:
                    self._cv.wait()
                item, self._slot = self._slot, None
                if item is None:  # closed with nothing queued
                    return
                self._busy = True
            snap, t_submit = item
            _telemetry.observe("resilience.checkpoint.queue_wait_seconds",
                               time.perf_counter() - t_submit)
            try:
                self._write(snap)
            except BaseException as e:  # noqa: BLE001 - raised by drain()
                with self._cv:
                    self._error = e
                self.logger.warning("async checkpoint write failed: %s", e)
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def drain(self, timeout=None):
        """Wait until nothing is queued or being written; raise (once) an
        error of the writer thread."""
        if not self.sync:
            with self._cv:
                self._cv.wait_for(
                    lambda: self._slot is None and not self._busy,
                    timeout=timeout)
        with self._cv:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def close(self, drain=True):
        """Stop and join the writer (idempotent); ``drain=True`` writes
        what is still queued first."""
        if self.sync:
            return
        try:
            if drain:
                self.drain()
        finally:
            with self._cv:
                self._closed = True
                if not drain:
                    self._slot = None
                self._cv.notify_all()
            if self._thread is not None:
                self._thread.join(timeout=30)
                self._thread = None

    @property
    def alive(self):
        return self._thread is not None and self._thread.is_alive()
