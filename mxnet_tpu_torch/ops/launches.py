"""Launch counts of the hand-written kernels' wrappers.

Each wrapper calls :func:`count` with itself where it launches its
kernel, and nowhere else; ``wrapper.launches`` holds the count (reset
freely).  A launch made while the calling thread's stream captures a CUDA
graph runs nothing: inside :func:`recording` it goes into the recording
instead, and :func:`replayed` adds it to the counts each time the graph
replays it.  The recording is not per thread: autograd runs a captured
backward on its own worker thread, on the capturing stream.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["count", "recording", "replayed"]

_recording = None


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
