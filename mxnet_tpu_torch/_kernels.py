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

__all__ = ["SOURCES", "build_all", "build_variants", "load", "build_log"]

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mxnet_tpu_torch")

#: kernel library name -> source file under csrc/
SOURCES = {"flash_attention": "flash_attention.cu",
           "batch_norm": "batch_norm.cu", "lstm": "lstm.cu",
           "nms": "nms.cu", "roi_pooling": "roi_pooling.cu"}

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


def _compile(jobs):
    """Runs ``nvcc`` on every ``(name, source, library, log)`` of ``jobs``,
    all started together.  A library appears only when its build
    succeeded; a failed build raises with what ``nvcc`` printed."""
    if not jobs:
        return
    nvcc = _nvcc()
    procs = {}
    failed = []
    try:
        for name, src, so, log in jobs:
            tmp = "%s.tmp-%d" % (so, os.getpid())
            logf = open(log, "w")
            procs[name] = (subprocess.Popen(
                [nvcc] + NVCC_FLAGS + ["-o", tmp, src], stdout=logf,
                stderr=subprocess.STDOUT), logf, tmp, so, log)
        for name, (proc, logf, tmp, so, log) in procs.items():
            rc = proc.wait()
            logf.close()
            if rc != 0:
                with open(log) as f:
                    failed.append("%s:\n%s" % (name, f.read()))
            else:
                os.replace(tmp, so)
    finally:
        for proc, logf, *_ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()
    if failed:
        raise MXNetError("nvcc failed for " + "\n".join(failed))


def build_all(names=None):
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all started together.  Returns ``{name: so_path}``."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = {}
    jobs = []
    for name in names:
        src, so, log = _paths(name)
        out[name] = so
        if not os.path.exists(so):
            jobs.append((name, src, so, log))
    _compile(jobs)
    return out


def build_variants(subdir, sources):
    """Builds each ``(name, CUDA source text)`` of ``sources`` with the
    port's flags into ``build/<subdir>/``, all ``nvcc`` runs started
    together, and returns ``{name: loaded ctypes library}``; the i-th
    build's ``nvcc`` report is ``build/<subdir>/v<i>.log``.  For the card
    scripts that time variants of a kernel source, or an older copy of
    one, beside the port's own build."""
    out = os.path.join(os.path.dirname(BUILD_DIR), subdir)
    os.makedirs(out, exist_ok=True)
    jobs = []
    for i, (name, text) in enumerate(sources):
        stem = os.path.join(out, "v%d" % i)
        with open(stem + ".cu", "w") as f:
            f.write(text)
        jobs.append((name, stem + ".cu", stem + ".so", stem + ".log"))
    _compile(jobs)
    return {name: ctypes.CDLL(so) for name, _src, so, _log in jobs}


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
