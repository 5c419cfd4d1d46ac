"""Training-loop plumbing and checkpoint files (counterpart of
``mxnet_tpu/model.py``): :class:`BatchEndParam`, :func:`_create_kvstore`,
and the epoch checkpoints ``prefix-symbol.json`` + ``prefix-%04d.params``
(``arg:``/``aux:`` keys, the dmlc format both packages read) with their
manifest ``prefix-manifest.json``.

The manifest (format 2, the JAX package's keys) records each epoch whose
params file completed its atomic rename, with the file's sha256, and the
retained mid-epoch snapshot generations of :mod:`.checkpoint`.  Every
read-modify-write of it holds one process lock: the snapshot writer
thread and fit's epoch-boundary save share a prefix.  The key-value store
and distributed training are not ported yet.
"""

from __future__ import annotations

import glob as _glob
import hashlib as _hashlib
import json
import logging
import os
import re as _re
import threading as _threading

from . import ndarray as nd
from . import symbol as sym
from . import telemetry as _telemetry
from .base import MXNetError, atomic_write, atomic_write_bytes

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "checkpoint_manifest", "list_checkpoints",
           "load_latest_checkpoint"]


class BatchEndParam:
    """What a batch-end callback receives."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)``: one device and a non-distributed
    store need none, as in the JAX package; anything else is not ported
    yet."""
    if kvstore is None:
        return None, False
    if isinstance(kvstore, str) and num_device == 1 \
            and "dist" not in kvstore and kvstore != "mesh":
        return None, False
    raise MXNetError("kvstore %r on %d device(s) is not ported yet"
                     % (kvstore, num_device))


def _manifest_path(prefix):
    return "%s-manifest.json" % prefix


def _sha256_file(path):
    """Hex sha256 of a file, read in 1 MiB pieces."""
    h = _hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


_MANIFEST_LOCK = _threading.Lock()


def checkpoint_manifest(prefix):
    """``prefix-manifest.json`` as a dict, or None when absent or corrupt.

    Format 2::

        {"format": 2, "prefix": "<basename>", "epochs": [1, 2, 3],
         "latest": 3, "payload_sha256": {"3": "<hex>"},
         "snapshots": [{"epoch": 2, "nbatch": 17,
                        "params": "<basename>-snap-0002-000017.params",
                        "sha256": "<hex>", "states": ..., "rng_state": ...,
                        "metric_state": ..., "iter_state": ...}]}"""
    try:
        with open(_manifest_path(prefix)) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(m, dict) or not isinstance(m.get("epochs"), list) \
            or not all(isinstance(e, int) for e in m["epochs"]):
        return None
    if not isinstance(m.get("snapshots", []), list):
        return None
    return m


def _manifest_mutate(prefix, fn, durable=True):
    """Atomic read-modify-write of the manifest under the process lock:
    ``fn(m)`` edits the dict in place; readers see the old or the new
    file, never a torn one."""
    with _MANIFEST_LOCK:
        m = checkpoint_manifest(prefix) or {
            "format": 2, "prefix": os.path.basename(prefix), "epochs": []}
        m["format"] = 2
        fn(m)
        blob = json.dumps(m, indent=2, sort_keys=True)
        atomic_write_bytes(_manifest_path(prefix), blob, mode="w",
                           durable=durable)
        return m


def _manifest_add_epoch(prefix, epoch, sha256=None):
    def _add(m):
        epochs = sorted(set(int(e) for e in m["epochs"]) | {int(epoch)})
        m["epochs"] = epochs
        m["latest"] = epochs[-1]
        if sha256 is not None:
            m.setdefault("payload_sha256", {})[str(int(epoch))] = sha256

    _manifest_mutate(prefix, _add)


def _snap_key(entry):
    return (int(entry.get("epoch", -1)), int(entry.get("nbatch", -1)))


def _manifest_add_snapshot(prefix, entry):
    def _add(m):
        snaps = [s for s in m.get("snapshots", [])
                 if _snap_key(s) != _snap_key(entry)]
        snaps.append(entry)
        m["snapshots"] = sorted(snaps, key=_snap_key)

    _manifest_mutate(prefix, _add, durable=False)


def _manifest_prune_snapshots(prefix, keep_last):
    """Drop all but the newest ``keep_last`` snapshot entries; returns the
    pruned entries, whose files the caller unlinks after this commit."""
    with _MANIFEST_LOCK:
        m = checkpoint_manifest(prefix)
    if m is None or len(m.get("snapshots", [])) <= keep_last:
        return []
    pruned = []

    def _prune(m):
        snaps = sorted(m.get("snapshots", []), key=_snap_key)
        if len(snaps) > keep_last:
            pruned.extend(snaps[:-keep_last])
            snaps = snaps[-keep_last:]
        m["snapshots"] = snaps

    _manifest_mutate(prefix, _prune, durable=False)
    return pruned


def list_checkpoints(prefix):
    """Epochs with a params file on disk, newest first: the manifest's,
    and files it does not name (older or hand-copied checkpoints)."""
    found = set()
    m = checkpoint_manifest(prefix)
    if m is not None:
        found.update(int(e) for e in m["epochs"])
    # the prefix may hold glob metacharacters, and epochs past 9999 take
    # five digits: escape the prefix and let the regex decide
    pat = _re.compile(_re.escape(os.path.basename(prefix)) +
                      r"-(\d{4,})\.params$")
    for path in _glob.glob("%s-*.params" % _glob.escape(prefix)):
        mt = pat.search(os.path.basename(path))
        if mt:
            found.add(int(mt.group(1)))
    return sorted((e for e in found
                   if os.path.exists("%s-%04d.params" % (prefix, e))),
                  reverse=True)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """``prefix-symbol.json`` + ``prefix-%04d.params``, each written
    atomically; the manifest records the epoch and the params file's
    sha256 only after its rename."""
    if symbol is not None:
        atomic_write("%s-symbol.json" % prefix, symbol.save)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    atomic_write(param_name, lambda tmp: nd.save(tmp, save_dict))
    _manifest_add_epoch(prefix, epoch, sha256=_sha256_file(param_name))
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of an epoch checkpoint of
    either package; the arrays on the CPU."""
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return (symbol, arg_params, aux_params)


def load_latest_checkpoint(prefix, logger=logging):
    """``(epoch, symbol, arg_params, aux_params)`` of the newest epoch
    checkpoint whose params file matches the sha256 the manifest recorded
    and loads; a corrupt one is skipped with a warning and counted in
    ``resilience.checkpoint.corrupt_skipped``.  None when there is none."""
    m = checkpoint_manifest(prefix) or {}
    shas = m.get("payload_sha256") or {}
    for epoch in list_checkpoints(prefix):
        params = "%s-%04d.params" % (prefix, epoch)
        want = shas.get(str(epoch))
        if want is not None and _sha256_file(params) != want:
            logger.warning(
                "checkpoint %s failed sha256 verification against the "
                "manifest; falling back to the previous epoch", params)
            _telemetry.inc("resilience.checkpoint.corrupt_skipped")
            continue
        try:
            symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        except (MXNetError, OSError, ValueError) as e:
            logger.warning(
                "checkpoint %s failed verification (%s); falling back to "
                "the previous epoch", params, e)
            _telemetry.inc("resilience.checkpoint.corrupt_skipped")
            continue
        return (epoch, symbol, arg_params, aux_params)
    return None
