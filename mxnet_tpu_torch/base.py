"""Core shared plumbing: the error type, symbol name management and
crash-safe file writes (counterpart of ``mxnet_tpu/base.py``)."""

from __future__ import annotations

import os
import threading

__all__ = ["MXNetError", "NameManager", "Registry", "atomic_write",
           "atomic_write_bytes", "env_int", "env_float"]


class MXNetError(RuntimeError):
    """Error raised by the framework."""


def env_int(name, default):
    """Integer environment setting; ``default`` when unset or malformed."""
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def env_float(name, default):
    """Float environment setting; ``default`` when unset or malformed."""
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return float(default)


class Registry:
    """Named classes by lower-cased name, with aliases (optimizers,
    metrics, initializers).  A name the JAX package knows but this package
    does not raises "not ported yet"."""

    def __init__(self, kind):
        self._kind = kind
        self._entries = {}

    def register(self, obj=None, name=None):
        def _do(o):
            self._entries[(name or o.__name__).lower()] = o
            return o

        return _do if obj is None else _do(obj)

    def alias(self, obj, *names):
        for n in names:
            self._entries[n.lower()] = obj
        return obj

    def get(self, name):
        key = str(name).lower()
        if key not in self._entries:
            raise MXNetError("%s %r is not ported yet (have %s)"
                             % (self._kind, name, sorted(self._entries)))
        return self._entries[key]

    def create(self, name, *args, **kwargs):
        return self.get(name)(*args, **kwargs)


def _fsync_dir(path):
    """fsync the directory entry so a completed rename survives a crash."""
    d = os.path.dirname(os.path.abspath(path))
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return  # some filesystems refuse O_RDONLY on a directory
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path, write_fn, fault_point=None, durable=True):
    """Crash-safe file write: ``write_fn(tmp_path)`` -> fsync -> atomic
    rename onto ``path``.  A reader sees the old content (or nothing) or
    the complete new content, never a half-written file.  ``fault_point``
    names a :mod:`~mxnet_tpu_torch.faults` point: when it fires, the temp
    file is truncated to half and :class:`~mxnet_tpu_torch.faults.
    FaultInjected` raised, the state a host dying mid-write leaves (the
    rename never happens, the previous ``path`` stays whole).
    ``durable=False`` skips the fsyncs: the rename stays atomic against
    process death."""
    from . import faults as _faults  # lazy: faults imports base

    tmp = "%s.tmp-%d" % (path, os.getpid())
    try:
        write_fn(tmp)
        if fault_point is not None and _faults.should_fire(fault_point):
            size = os.path.getsize(tmp)
            with open(tmp, "r+b") as f:
                f.truncate(max(0, size // 2))
            raise _faults.FaultInjected(
                "fault %r: write of %s killed mid-file"
                % (fault_point, path))
        if durable:
            fd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        os.replace(tmp, path)
        if durable:
            _fsync_dir(path)
    except _faults.FaultInjected:
        raise  # a simulated crash leaves the truncated temp file behind
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_bytes(path, data, mode="wb", fault_point=None,
                       durable=True):
    """:func:`atomic_write` of a ready blob."""
    def _write(tmp):
        with open(tmp, mode) as f:
            f.write(data)
    atomic_write(path, _write, fault_point=fault_point, durable=durable)


class NameManager:
    """Auto-naming for symbols: a thread-local stack of managers, the
    current one assigns ``hint + running count`` to anonymous symbols."""

    _tls = threading.local()

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return "%s%d" % (hint, n)

    def __enter__(self):
        NameManager._stack().append(self)
        return self

    def __exit__(self, *exc):
        NameManager._stack().pop()

    @staticmethod
    def _stack():
        if not hasattr(NameManager._tls, "stack"):
            NameManager._tls.stack = [NameManager()]
        return NameManager._tls.stack

    @staticmethod
    def current():
        return NameManager._stack()[-1]
