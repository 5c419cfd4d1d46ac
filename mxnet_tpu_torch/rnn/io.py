"""Bucketing data iterator for variable-length sequences, counterpart of
``mxnet_tpu/rnn/io.py``: :func:`encode_sentences` and
:class:`BucketSentenceIter`.  Each batch carries a ``bucket_key`` so that
``BucketingModule`` picks (or binds) the executor for its length.

``reset`` shuffles with Python's global ``random`` and numpy's global
generator, as the JAX package does, so the same seeds give both packages
the same batches.  Batches are host NDArrays; the module copies them onto
its device.
"""

from __future__ import annotations

import bisect
import logging
import random

import numpy as np

from .. import ndarray
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Encode tokenized sentences into integer id lists, building (or
    extending) ``vocab``.  Returns (encoded, vocab)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                assert new_vocab, "Unknown token %s" % word
                if idx == invalid_label:
                    idx += 1
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Bucketed LM iterator: pads each sentence up to its bucket length;
    the label is the input shifted one step left (next-token
    prediction)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NTC"):
        super().__init__(batch_size)
        if not buckets:
            counts = np.bincount([len(s) for s in sentences])
            buckets = [i for i, j in enumerate(counts) if j >= batch_size]
        buckets = sorted(buckets)

        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = bisect.bisect_left(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        # keep every bucket 2-D, an empty one included
        self.data = [np.asarray(b, dtype=dtype).reshape(-1, n)
                     for b, n in zip(self.data, buckets)]
        if ndiscard:
            logging.warning("discarded %d sentences longer than the largest "
                            "bucket.", ndiscard)

        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(buckets)

        if self.major_axis == 0:
            shape = (batch_size, self.default_bucket_key)
        elif self.major_axis == 1:
            shape = (self.default_bucket_key, batch_size)
        else:
            raise ValueError("invalid layout %s" % layout)
        self.provide_data = [DataDesc(data_name, shape, layout=layout)]
        self.provide_label = [DataDesc(label_name, shape, layout=layout)]

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend(
                (i, j) for j in range(0, len(buck) - batch_size + 1,
                                      batch_size))
        self.curr_idx = 0
        self.labels = []
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)
        self.labels = []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.labels.append(label)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.data[i][j:j + self.batch_size]
        label = self.labels[i][j:j + self.batch_size]
        if self.major_axis == 1:
            data, label = data.T, label.T
        data = ndarray.array(data, dtype=self.dtype)
        label = ndarray.array(label, dtype=self.dtype)
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[i],
            provide_data=[DataDesc(self.data_name, data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, label.shape,
                                    layout=self.layout)])
