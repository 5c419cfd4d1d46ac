"""Data iterators (counterpart of ``mxnet_tpu/io.py``): :class:`DataDesc`,
:class:`DataBatch`, :class:`DataIter`, :class:`NDArrayIter`,
:class:`MNISTIter`, :class:`PrefetchingIter` and
:class:`DevicePrefetchIter`.

Batches are NDArrays on the host; ``Module`` copies each onto its device,
unless a :class:`DevicePrefetchIter` (``fit(prefetch_to_device=True)``)
has already placed it there on a side stream.  ``shuffle`` permutes with
numpy's global generator, as the JAX package does, so the same numpy seed
gives the same batches in both.  ``state_dict``/``load_state_dict``
(the JAX package's iterator-state protocol) let ``fit`` resume in the
middle of an epoch.
"""

from __future__ import annotations

import contextlib
import gzip
import struct
import threading

import numpy as np
import torch

from .base import MXNetError
from .context import Context, cpu
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "MNISTIter", "PrefetchingIter", "DevicePrefetchIter"]


class DataDesc:
    """(name, shape, dtype, layout)."""

    def __init__(self, name, shape, dtype=np.float32, layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layout = layout

    def __iter__(self):
        yield self.name
        yield self.shape

    def __getitem__(self, i):
        return (self.name, self.shape)[i]

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    def __eq__(self, other):
        return tuple(self) == tuple(other)


class DataBatch:
    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label if label is not None else []
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()

    # -- the iterator-state protocol (exact mid-epoch resume) --------------
    def state_dict(self):
        """JSON-able position of the iterator: :meth:`load_state_dict` of
        it on a freshly made equal iterator makes ``next()`` yield the
        batch that would have come next.  An iterator without the
        protocol raises, and ``fit`` then resumes at the epoch
        boundary."""
        raise NotImplementedError(
            "%s does not implement the iterator-state protocol "
            "(state_dict/load_state_dict); mid-epoch checkpoint resume "
            "degrades to the epoch boundary" % type(self).__name__)

    def load_state_dict(self, state):
        """Restore a :meth:`state_dict`."""
        raise NotImplementedError(
            "%s does not implement the iterator-state protocol"
            % type(self).__name__)


def _init_data(data, allow_empty, default_name):
    """Normalize to a sorted list of (name, numpy array)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    out = {k: v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)
           for k, v in data.items()}
    return list(sorted(out.items()))


class NDArrayIter(DataIter):
    """Batching, shuffling and padding over in-memory arrays.
    ``last_batch_handle``: ``"pad"`` (wrap around, ``pad`` counts the
    filler rows), ``"discard"`` (drop the ragged tail) or ``"roll_over"``
    (the tail starts the next epoch)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        if shuffle:
            idx = np.arange(self.num_data)
            np.random.shuffle(idx)
            self.data = [(k, v[idx]) for k, v in self.data]
            self.label = [(k, v[idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            new_n = self.num_data - self.num_data % batch_size
            self.data = [(k, v[:new_n]) for k, v in self.data]
            self.label = [(k, v[:new_n]) for k, v in self.label]
            self.num_data = new_n
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size."
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) \
                % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if self.cursor + self.batch_size <= self.num_data:
            return [array(v[self.cursor:self.cursor + self.batch_size],
                          ctx=cpu()) for _, v in data_source]
        pad = self.batch_size - self.num_data + self.cursor
        return [array(np.concatenate([v[self.cursor:], v[:pad]], axis=0),
                      ctx=cpu()) for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def state_dict(self):
        # shuffle and discard act on the arrays at construction, so an
        # equally made iterator at the same cursor yields the same batch
        return {"type": "NDArrayIter", "cursor": self.cursor,
                "num_data": self.num_data, "batch_size": self.batch_size}

    def load_state_dict(self, state):
        if state.get("type", "NDArrayIter") != "NDArrayIter":
            raise MXNetError("iterator state of type %r cannot restore "
                             "onto NDArrayIter" % (state.get("type"),))
        if state.get("num_data", self.num_data) != self.num_data or \
                state.get("batch_size", self.batch_size) != self.batch_size:
            raise MXNetError(
                "NDArrayIter state (num_data=%s, batch_size=%s) does not "
                "match this iterator (num_data=%d, batch_size=%d)"
                % (state.get("num_data"), state.get("batch_size"),
                   self.num_data, self.batch_size))
        self.cursor = int(state["cursor"])


def _read_idx(path):
    """An MNIST idx file (raw, or gzipped when the name ends in ``.gz``)
    as a uint8 array of its dims (``src/io/iter_mnist.cc``'s format)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


class MNISTIter(DataIter):
    """MNIST idx files as batches, the JAX package's ``MNISTIter``
    (reference ``src/io/iter_mnist.cc:241``): pixels scaled by 1/255,
    shuffled once by ``RandomState(seed)`` when ``shuffle``, cut to part
    ``part_index`` of ``num_parts`` equal parts, ``(N, 1, H, W)`` images
    (``(N, H*W)`` with ``flat``), the ragged last batch discarded."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, seed=0, silent=False,
                 num_parts=1, part_index=0, **kwargs):
        super().__init__(batch_size)
        img = _read_idx(image).astype(np.float32) / 255.0
        lab = _read_idx(label).astype(np.float32)
        if shuffle:
            idx = np.random.RandomState(seed).permutation(img.shape[0])
            img, lab = img[idx], lab[idx]
        n = img.shape[0] // num_parts
        img = img[part_index * n:(part_index + 1) * n]
        lab = lab[part_index * n:(part_index + 1) * n]
        img = img.reshape(img.shape[0], -1) if flat \
            else img.reshape(img.shape[0], 1, img.shape[1], img.shape[2])
        self._inner = NDArrayIter(
            {"data": img}, {"softmax_label": lab}, batch_size,
            shuffle=False, last_batch_handle="discard")

    provide_data = property(lambda s: s._inner.provide_data)
    provide_label = property(lambda s: s._inner.provide_label)

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()

    def state_dict(self):
        return {"type": "MNISTIter", "inner": self._inner.state_dict()}

    def load_state_dict(self, state):
        if state.get("type", "MNISTIter") != "MNISTIter":
            raise MXNetError("iterator state of type %r cannot restore "
                             "onto MNISTIter" % (state.get("type"),))
        self._inner.load_state_dict(state["inner"])


class PrefetchingIter(DataIter):
    """Produces the next batch of each sub-iterator on a daemon thread of
    its own while the caller works on the current one.  ``close()`` (or
    the iterator as a context manager) stops and joins the threads.  An
    error in a producer is raised by ``next()``; a producer thread that
    has died raises there too, instead of leaving ``next()`` waiting.

    Before each batch a producer records its sub-iterator's
    ``state_dict()``, so :meth:`state_dict` gives the position of the
    batch buffered but not yet taken: restored, that batch is made
    again."""

    #: seconds between checks that a producer is alive while waiting
    _POLL = 0.05

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = None
        self.next_batch = [None] * self.n_iter
        self._errors = [None] * self.n_iter
        # each sub-iterator's state before the batch its producer made;
        # None once a sub-iterator has shown it has no state protocol
        self._pending_state = [None] * self.n_iter
        self.prefetch_threads = [
            threading.Thread(target=self._producer, args=(i,), daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def _producer(self, i):
        while True:
            self.data_taken[i].wait()
            # take the signal before producing: a close() that sets it
            # while the batch is made must not be cleared away after it
            self.data_taken[i].clear()
            if not self.started:
                break
            try:
                if self._pending_state is not None:
                    try:
                        self._pending_state[i] = self.iters[i].state_dict()
                    except NotImplementedError:
                        self._pending_state = None
                self.next_batch[i] = self._produce(i)
            except StopIteration:
                self.next_batch[i] = None
            except BaseException as e:  # noqa: BLE001 - raised by next()
                self._errors[i] = e
                self.next_batch[i] = None
            self.data_ready[i].set()

    def _produce(self, i):
        """Sub-iterator ``i``'s next batch, on its producer thread."""
        return self.iters[i].next()

    def _consume(self, batches):
        """Hook on the consumer thread, before the producers re-arm."""

    def _wait_ready(self):
        for i, e in enumerate(self.data_ready):
            while not e.wait(self._POLL):
                if not self.prefetch_threads[i].is_alive():
                    raise MXNetError(
                        "PrefetchingIter: the producer thread of "
                        "sub-iterator %d has died%s" % (
                            i, "" if self.started else " (closed)"))

    def close(self):
        """Stop the producer threads and join them (idempotent); the
        iterator is not used after this."""
        self.started = False
        for e in self.data_taken:
            e.set()
        for t in self.prefetch_threads:
            if t is not threading.current_thread():
                t.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def _rearm(self):
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def reset(self):
        self._wait_ready()
        for i in self.iters:
            i.reset()
        self._errors = [None] * self.n_iter
        self._rearm()

    def state_dict(self):
        """The position of the consumer: waits for the producers, then
        gives each sub-iterator's state before its buffered batch."""
        self._wait_ready()
        pending = self._pending_state
        if pending is None or any(s is None for s in pending):
            raise NotImplementedError(
                "%s cannot snapshot: a wrapped iterator lacks the state "
                "protocol" % type(self).__name__)
        return {"type": type(self).__name__,
                "inner": [dict(s) for s in pending]}

    def load_state_dict(self, state):
        """Wait for the producers, restore each sub-iterator, drop the
        buffered batches and re-arm: the next batch comes from the
        restored positions."""
        inner = state["inner"]
        if len(inner) != self.n_iter:
            raise MXNetError(
                "prefetch state has %d sub-iterators, wrapper has %d"
                % (len(inner), self.n_iter))
        self._wait_ready()
        for it, st in zip(self.iters, inner):
            it.load_state_dict(st)
        self._errors = [None] * self.n_iter
        self._rearm()

    def iter_next(self):
        self._wait_ready()
        err = next((e for e in self._errors if e is not None), None)
        if err is not None:
            # clear every producer's error and re-arm, so a caller that
            # catches it can go on iterating
            self._errors = [None] * self.n_iter
            self.next_batch = [None] * self.n_iter
            self._rearm()
            raise err
        if self.next_batch[0] is None:
            for b in self.next_batch:
                assert b is None, "Number of entry mismatches between iters"
            return False
        for b in self.next_batch:
            assert b.pad == self.next_batch[0].pad, \
                "Different pad number in the data batches"
        self._consume(self.next_batch)
        self.current_batch = DataBatch(
            sum([b.data for b in self.next_batch], []),
            sum([b.label for b in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index)
        self._rearm()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration


def _as_tensor(a):
    if isinstance(a, NDArray):
        return a._t
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


class DevicePrefetchIter(PrefetchingIter):
    """:class:`PrefetchingIter` that also places each batch on ``device``
    from its producer thread, so the host-to-device copy of batch N runs
    while the card computes batch N-1.

    On a CUDA device each host array is pinned and copied with
    ``non_blocking=True`` on a side stream of the iterator's; an event
    recorded after the batch's copies is waited on by the consumer's
    current stream in ``next()``, and each placed tensor is marked as used
    by that stream (``record_stream``), so its memory is not handed out
    again before the consumer's work on it is done.  On the CPU the
    batches stay where they are.  ``placer(name, tensor) -> tensor`` does
    the placement of one pinned host array (``Module`` passes its
    ``_device_put_batch``, which takes the bound array's dtype); by
    default it is ``tensor.to(device, non_blocking=True)``.
    ``fit(prefetch_to_device=True)`` (or ``MXNET_DEVICE_PREFETCH=1``)
    wraps ``train_data`` in one and closes it when fit ends.  Its
    ``load_state_dict`` drops the batches already placed and rewinds the
    sub-iterators."""

    def __init__(self, iters, device=None, placer=None, rename_data=None,
                 rename_label=None):
        if device is None:
            raise MXNetError("DevicePrefetchIter needs a device")
        if isinstance(device, Context):
            device = device.torch_device()
        self._device = torch.device(device)
        self._placer = placer or (lambda _name, t: t.to(
            self._device, non_blocking=True))
        # made before the producer threads start, which use it at once
        self._stream = torch.cuda.Stream(self._device) \
            if self._device.type == "cuda" else None
        super().__init__(iters, rename_data=rename_data,
                         rename_label=rename_label)

    def _place(self, name, a):
        t = _as_tensor(a)
        if self._stream is not None and t.device.type == "cpu":
            t = t.pin_memory()
        return NDArray(self._placer(name, t))

    def _produce(self, i):
        batch = self.iters[i].next()
        inner = self.iters[i]
        names = ([d.name for d in inner.provide_data],
                 [d.name for d in inner.provide_label])
        with torch.cuda.stream(self._stream) if self._stream is not None \
                else contextlib.nullcontext():
            batch.data = [self._place(n, a)
                          for n, a in zip(names[0], batch.data)]
            batch.label = [self._place(n, a)
                           for n, a in zip(names[1], batch.label or [])]
            if self._stream is not None:
                batch.ready = torch.cuda.Event()
                batch.ready.record(self._stream)
        return batch

    def _consume(self, batches):
        if self._stream is None:
            return
        stream = torch.cuda.current_stream(self._device)
        for b in batches:
            stream.wait_event(b.ready)
            for a in list(b.data) + list(b.label):
                a._t.record_stream(stream)
