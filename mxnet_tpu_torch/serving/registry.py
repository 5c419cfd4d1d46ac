"""Versioned multi-model registry — atomic publish, load/reload and
per-bucket warm-up (counterpart of ``mxnet_tpu/serving/registry.py``).

:func:`save_model` writes the JAX package's directory format: the
version-qualified ``symbol-v<N>.json`` and ``model-v<N>.params`` first, the
checksummed ``manifest.json`` last, so a model directory published by
either package loads in the other.  :class:`ModelRegistry` builds and
warms a new version off-registry, then swaps it in under its lock; a
failed load leaves the previous version serving.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time

import numpy as np

from .. import predict as _predict
from .. import telemetry as _telemetry
from ..base import MXNetError, atomic_write, atomic_write_bytes
from ..context import as_context, gpu
from .batcher import DynamicBatcher

__all__ = ["UnknownModel", "ServedModel", "ModelRegistry", "save_model",
           "MANIFEST"]

#: the publish marker: readers only trust a directory carrying one
MANIFEST = "manifest.json"


class UnknownModel(MXNetError):
    """Request for a model name the registry has not loaded."""


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_model(model_dir, symbol_json, param_blob, input_shape,
               data_name="data", buckets=(1, 8, 32), version=1, name=None):
    """Publish a servable model directory atomically; returns the manifest.

    ``input_shape`` is the per-sample shape (no batch dim); ``buckets``
    declares the batch sizes the server binds.  Payload files go first, the
    manifest last; payloads of superseded versions are then removed
    best-effort."""
    os.makedirs(model_dir, exist_ok=True)
    if hasattr(symbol_json, "tojson"):  # a Symbol
        symbol_json = symbol_json.tojson()
    sym_bytes = symbol_json.encode() if isinstance(symbol_json, str) \
        else bytes(symbol_json)
    version = int(version)
    sym_name = "symbol-v%d.json" % version
    par_name = "model-v%d.params" % version
    atomic_write_bytes(os.path.join(model_dir, sym_name), sym_bytes)
    atomic_write_bytes(os.path.join(model_dir, par_name), bytes(param_blob))
    manifest = {
        "name": name or os.path.basename(os.path.abspath(model_dir)),
        "version": version,
        "symbol": sym_name,
        "params": par_name,
        "data_name": data_name,
        "input_shape": [int(d) for d in input_shape],
        "buckets": sorted({int(b) for b in buckets}),
        "sha256": {
            sym_name: _sha256(os.path.join(model_dir, sym_name)),
            par_name: _sha256(os.path.join(model_dir, par_name)),
        },
    }

    def _write(tmp):
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)

    # a publisher dying here leaves the previous manifest (and the payloads
    # it names) whole: readers keep loading the old version
    atomic_write(os.path.join(model_dir, MANIFEST), _write,
                 fault_point="serving.model.write")
    for fname in os.listdir(model_dir):
        if fname in (sym_name, par_name, MANIFEST):
            continue
        if fname.startswith(("symbol-v", "model-v")) \
                and ".tmp-" not in fname:
            try:
                os.unlink(os.path.join(model_dir, fname))
            except OSError:  # best-effort: the publish is already durable
                pass
    return manifest


def per_row(out, rows):
    """Give a dispatch output a leading axis of ``rows``.  A graph that
    folds (batch, seq) into its first axis — ``build_lm``'s
    ``Reshape(-1, E)`` gives (batch*seq, vocab) — is split back to
    (batch, seq, ...), so the batcher hands each request its own samples.
    Outputs already aligned with the rows pass through unchanged."""
    if out.ndim and out.shape[0] != rows and out.shape[0] % rows == 0:
        return out.reshape((rows, out.shape[0] // rows) + out.shape[1:])
    return out


class ServedModel:
    """One loaded, warm model version: a :class:`~mxnet_tpu_torch.predict.
    Predictor` cycled across the declared batch buckets plus its
    :class:`~mxnet_tpu_torch.serving.batcher.DynamicBatcher`.  Runs on the
    card unless ``ctx`` says otherwise."""

    def __init__(self, name, symbol_json, param_blob, input_shape,
                 data_name="data", buckets=(1, 8, 32), version=1,
                 ctx=None, batch_timeout_us=2000, max_queue_depth=128,
                 autostart=True):
        self.name = name
        self.version = int(version)
        self.data_name = data_name
        self.input_shape = tuple(int(d) for d in input_shape)
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        #: warm-up compile accounting: this port has no compile cache, so
        #: both stay None (the JAX package's value with its cache disabled)
        self.warmup_entries = []
        self.warmup_cold_compiles = None
        self.warmup_cache_loads = None
        self._pred = _predict.Predictor(
            symbol_json, param_blob,
            {data_name: (self.buckets[-1],) + self.input_shape},
            ctx=as_context(ctx, gpu(0)))
        if self._pred._cache_cap < len(self.buckets):
            raise MXNetError(
                "MXNET_PRED_CACHE_SIZE=%d holds fewer executors than the "
                "%d declared buckets of model %r: bucket round-robin would "
                "rebind every dispatch"
                % (self._pred._cache_cap, len(self.buckets), name))
        # the predictor is stateful (set_input/forward): one dispatch at a
        # time per model
        self._run_lock = threading.Lock()
        self.batcher = DynamicBatcher(
            self._dispatch, buckets=self.buckets,
            batch_timeout_us=batch_timeout_us,
            max_queue_depth=max_queue_depth, name=name,
            feature_shape=self.input_shape)
        self.warmup()
        if autostart:
            self.batcher.start()

    def warmup(self):
        """Bind and run every declared bucket now, at load time."""
        for b in self.buckets:
            t0 = time.perf_counter()
            self._dispatch(np.zeros((b,) + self.input_shape, np.float32))
            _telemetry.observe("serving.warmup.seconds",
                               time.perf_counter() - t0,
                               model=self.name, bucket=b)
        _telemetry.event("serving.model.warm", model=self.name,
                         version=self.version, buckets=len(self.buckets),
                         cold_compiles=None, cache_loads=None)

    def _dispatch(self, rows):
        """One device dispatch: reshape to the rows' bucket (a cache hit
        after warm-up), forward, copy out."""
        with self._run_lock:
            shape = (int(rows.shape[0]),) + self.input_shape
            if self._pred._input_shapes[self.data_name] != shape:
                self._pred.reshape({self.data_name: shape})
            self._pred.set_input(self.data_name, rows)
            self._pred.forward()
            return per_row(self._pred.get_output(0), shape[0])

    def describe(self):
        return {"name": self.name, "version": self.version,
                "kind": "predict", "buckets": list(self.buckets),
                "input_shape": list(self.input_shape),
                "data_name": self.data_name,
                "pending_rows": self.batcher.pending_rows(),
                "warmup": {"entries": len(self.warmup_entries),
                           "cold_compiles": self.warmup_cold_compiles,
                           "cache_loads": self.warmup_cache_loads}}

    def predict(self, data, deadline_ms=None,
                timeout=DynamicBatcher.DEFAULT_TIMEOUT):
        """Serve ``data`` through the batcher.  A single sample (ndim ==
        len(input_shape)) is wrapped and unwrapped; a row batch goes
        through as-is."""
        data = np.asarray(data, np.float32)
        if data.ndim == len(self.input_shape):
            return self.batcher.predict(data[None], deadline_ms=deadline_ms,
                                        timeout=timeout)[0]
        return self.batcher.predict(data, deadline_ms=deadline_ms,
                                    timeout=timeout)

    def close(self, drain=True):
        """Drain (by default), then fail further submits fast."""
        self.batcher.close(drain=drain)
        self._pred.free()


class ModelRegistry:
    """``name -> servable`` with atomic swap semantics: a
    :class:`ServedModel` (``/predict``) or a decode servable
    (:class:`~mxnet_tpu_torch.serving.pool.ReplicaPool` or a bare
    :class:`~mxnet_tpu_torch.serving.decode.DecodeEngine`, ``/generate``).
    Models run on the card unless ``ctx`` says otherwise."""

    def __init__(self, ctx=None, batch_timeout_us=2000,
                 max_queue_depth=128):
        self._ctx = as_context(ctx, gpu(0))
        self._serve_opts = {"batch_timeout_us": batch_timeout_us,
                            "max_queue_depth": max_queue_depth}
        self._models = {}
        self._lock = threading.Lock()
        #: the attached :class:`~mxnet_tpu_torch.serving.controller.
        #: FleetController` (None while the registry runs uncontrolled);
        #: the frontend's ``/fleet`` route and ``/healthz`` block read it
        self.controller = None

    def attach_controller(self, controller):
        """Attach the fleet controller that manages this registry's
        decode pools (the controller's constructor calls this); the
        frontend reads it as ``registry.controller``."""
        self.controller = controller
        return controller

    def load(self, name, symbol_json, param_blob, input_shape,
             data_name="data", buckets=(1, 8, 32), version=None):
        """Load (or reload) ``name``: build and warm the new version
        off-registry, then swap it in.  On a failed build the previous
        version keeps serving."""
        prev = self.get(name, default=None)
        if version is None:
            version = 1 if prev is None else prev.version + 1
        model = ServedModel(name, symbol_json, param_blob, input_shape,
                            data_name=data_name, buckets=buckets,
                            version=version, ctx=self._ctx,
                            **self._serve_opts)
        with self._lock:
            prev = self._models.get(name)
            self._models[name] = model
        if prev is not None:
            prev.close()
        _telemetry.inc("serving.model.loads", model=name)
        _telemetry.event("serving.model.load", model=name, version=version)
        logging.info("serving: model %r v%d loaded (buckets %s)",
                     name, model.version, list(model.buckets))
        return model

    def register(self, name, servable, version=None):
        """Pointer-flip swap of an ALREADY-BUILT servable (a
        :class:`~mxnet_tpu_torch.serving.pool.ReplicaPool`, a bare
        :class:`~mxnet_tpu_torch.serving.decode.DecodeEngine`, a
        :class:`ServedModel` built off-registry, or anything exposing
        ``version``/``close``/``describe``): the caller builds and warms
        the new version outside the registry, this swaps it in under the
        registry lock and retires the old one.  A decode POOL's in-flight
        generations MIGRATE onto the new servable (``close(successor=)``:
        each straggler re-prefills its transcript, the same stream as an
        uninterrupted run when both versions serve the same params)
        instead of being errored out."""
        if version is not None:
            servable.version = int(version)
        # healthz/models key by servable.name: the registration name is
        # authoritative
        servable.name = name
        with self._lock:
            prev = self._models.get(name)
            if version is None:
                # bare engines carry no version of their own: the registry
                # stamps one so every servable answers .version uniformly
                servable.version = prev.version + 1 if prev is not None \
                    else int(getattr(servable, "version", 1))
            self._models[name] = servable
        if prev is not None:
            if hasattr(prev, "replicas") and (
                    hasattr(servable, "adopt")
                    or hasattr(servable, "resume")):
                # old decode pool -> new decode servable: migrate the
                # stragglers instead of draining/erroring them
                prev.close(successor=servable)
            else:
                prev.close()
        _telemetry.inc("serving.model.loads", model=name)
        _telemetry.event("serving.model.load", model=name,
                         version=servable.version)
        controller = self.controller
        if controller is not None:
            # the pointer flip replaced the pool object: the controller
            # drops the old pool's autoscale and placement state and
            # adopts the successor at its next tick.  A controller bug
            # must not fail the swap.
            try:
                controller.on_register(name, servable)
            except Exception:  # noqa: broad-except — the swap is done
                logging.warning("serving: fleet controller on_register "
                                "hook failed for %r", name, exc_info=True)
        logging.info("serving: servable %r v%d registered (%s)",
                     name, servable.version, type(servable).__name__)
        return servable

    @staticmethod
    def _read_manifest(model_dir):
        man_path = os.path.join(model_dir, MANIFEST)
        if not os.path.exists(man_path):
            raise MXNetError("no %s in %r: directory was never fully "
                             "published" % (MANIFEST, model_dir))
        with open(man_path) as f:
            return json.load(f)

    @staticmethod
    def _read_payload(model_dir, man):
        """Read and checksum every manifest-listed file once."""
        blobs = {}
        for fname, digest in man.get("sha256", {}).items():
            path = os.path.join(model_dir, fname)
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError as e:
                raise MXNetError("model file %r listed in the manifest is "
                                 "unreadable (torn publish?): %s" % (path, e))
            got = hashlib.sha256(blob).hexdigest()
            if got != digest:
                raise MXNetError("model file %r does not match its manifest "
                                 "checksum (torn publish?): %s != %s"
                                 % (path, got, digest))
            blobs[fname] = blob
        return blobs

    def load_dir(self, model_dir, name=None, version=None):
        """Load/reload from a :func:`save_model` directory (written by
        either package), verifying the manifest checksums first."""
        man = self._read_manifest(model_dir)
        for attempt in (0, 1):
            try:
                blobs = self._read_payload(model_dir, man)
                break
            except MXNetError:
                if attempt == 1:
                    raise
                # a concurrent publish may have removed the payloads this
                # manifest names: retry once against the newer manifest
                new_man = self._read_manifest(model_dir)
                if new_man == man:
                    raise
                man = new_man
        return self.load(name or man["name"], blobs[man["symbol"]].decode(),
                         blobs[man["params"]], man["input_shape"],
                         data_name=man.get("data_name", "data"),
                         buckets=man.get("buckets", (1, 8, 32)),
                         version=man["version"] if version is None
                         else version)

    def get(self, name, **kw):
        with self._lock:
            model = self._models.get(name)
            loaded = sorted(self._models) if model is None else None
        if model is None:
            if "default" in kw:
                return kw["default"]
            raise UnknownModel("model %r is not loaded (have %s)"
                               % (name, loaded))
        return model

    def models(self):
        """Loaded servables, sorted by name."""
        with self._lock:
            return sorted(self._models.values(), key=lambda m: m.name)

    def close(self):
        """Unload everything (server shutdown)."""
        with self._lock:
            models, self._models = list(self._models.values()), {}
        for m in models:
            m.close()
