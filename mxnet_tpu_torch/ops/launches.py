"""Launch counts of the hand-written kernels' wrappers.

Each wrapper calls :func:`count` with itself where it launches its
kernel, and nowhere else; ``wrapper.launches`` holds the count (reset
freely).  :func:`route` picks a wrapper or its plain version by device.
A launch made while the calling thread's stream captures a CUDA
graph runs nothing: inside :func:`recording` it goes into the recording
instead, and :func:`replayed` adds it to the counts each time the graph
replays it.  The recording is not per thread: autograd runs a captured
backward on its own worker thread, on the capturing stream.
"""

from __future__ import annotations

import contextlib

import torch

from ..base import MXNetError

__all__ = ["count", "recording", "replayed", "route"]

_recording = None


def route(x, cuda_fn, plain_fn, what):
    """``cuda_fn`` for a CUDA tensor ``x``, ``plain_fn`` for a CPU one;
    raises for any other device (``what`` names the op)."""
    dev = x.device.type
    if dev == "cuda":
        return cuda_fn
    if dev == "cpu":
        return plain_fn
    raise MXNetError("%s: no implementation for device %s" % (what, x.device))


def count(wrapper):
    """One launch of ``wrapper``'s kernel."""
    rec = _recording
    if rec is not None and torch.cuda.is_current_stream_capturing():
        rec[wrapper] = rec.get(wrapper, 0) + 1
    else:
        wrapper.launches += 1


@contextlib.contextmanager
def recording():
    """Collects in the yielded ``{wrapper: launches}`` the launches made
    on a capturing stream, in any thread, until the block ends."""
    global _recording
    prev, _recording = _recording, {}
    try:
        yield _recording
    finally:
        _recording = prev


def replayed(rec):
    """Counts the launches of one replay of a graph captured under
    ``rec``."""
    for wrapper, n in rec.items():
        wrapper.launches += n
