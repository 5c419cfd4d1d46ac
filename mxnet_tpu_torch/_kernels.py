"""Builds and loads the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at first use, never at import, into
``build/mxnet_tpu_torch/`` beside the package, keyed by a hash of the
source and the flags, so a changed source rebuilds and an unchanged one
loads.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from .base import MXNetError

__all__ = ["SOURCES", "build_all", "load", "build_log"]

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mxnet_tpu_torch")

#: kernel library name -> source file under csrc/
SOURCES = {"flash_attention": "flash_attention.cu",
           "batch_norm": "batch_norm.cu", "lstm": "lstm.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise MXNetError("nvcc not found: the CUDA kernels of "
                         "mxnet_tpu_torch are built at first use on a "
                         "machine with the CUDA toolkit")
    return path


def _paths(name):
    src = os.path.join(CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.join(BUILD_DIR, "%s-%s" % (name, digest.hexdigest()[:16]))
    return src, stem + ".so", stem + ".log"


def build_all(names=None):
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all started together.  Returns ``{name: so_path}``."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    out = {}
    try:
        for name in names:
            src, so, log = _paths(name)
            out[name] = so
            if os.path.exists(so):
                continue
            tmp = "%s.tmp-%d" % (so, os.getpid())
            logf = open(log, "w")
            procs[name] = (subprocess.Popen(
                [_nvcc()] + NVCC_FLAGS + ["-o", tmp, src], stdout=logf,
                stderr=subprocess.STDOUT), logf, tmp, so, log)
        failed = []
        for name, (proc, logf, tmp, so, log) in procs.items():
            rc = proc.wait()
            logf.close()
            if rc != 0:
                failed.append(name)
            else:
                os.replace(tmp, so)
    finally:
        for proc, logf, *_ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()
    if failed:
        raise MXNetError("nvcc failed for %s:\n%s" % (failed, "\n".join(
            build_log(n) for n in failed)))
    return out


def build_log(name):
    """What nvcc printed for ``name`` (register and spill report)."""
    _src, _so, log = _paths(name)
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def load(name):
    """The loaded ``ctypes`` library for kernel ``name``, built first if
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build_all([name])[name])
        return lib
