"""Symbolic RNN cells (``mx.rnn``), counterpart of
``mxnet_tpu/rnn/rnn_cell.py``: :class:`RNNParams`, :class:`BaseRNNCell`,
:class:`FusedRNNCell` (``unroll``, ``unpack_weights``/``pack_weights``),
:class:`SequentialRNNCell` and :class:`DropoutCell`.

``FusedRNNCell`` maps to the ``RNN`` op (``ops/rnn.py``): on the card its
LSTM recurrence runs kernels K4-K6.  Its blob layout and the names
``unpack_weights`` gives (``lstm_l0_i2h_weight``, ...) are the JAX
package's, so blobs and unpacked weights carry across as they are.
``begin_state()`` with no ``batch_size`` returns ``None``; ``unroll`` then
derives zero states from the data symbol through ``_rnn_begin_state``.

Not ported yet: the unfused cells (``RNNCell``, ``LSTMCell``,
``GRUCell``), ``FusedRNNCell.unfuse``, ``BidirectionalCell``, the
modifier cells, and merging a list of step outputs (``Concat``).
"""

from __future__ import annotations

import numpy as np

from .. import ndarray
from .. import symbol
from ..base import MXNetError
from ..ops.rnn import _GATES, _layer_param_slices, rnn_param_size

__all__ = ["RNNParams", "BaseRNNCell", "FusedRNNCell", "SequentialRNNCell",
           "DropoutCell"]


class RNNParams:
    """Container holding one Variable per parameter, shared across steps."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """Returns (inputs, axis): inputs as a list of step symbols when
    ``merge is False``, one merged symbol when ``merge is True``, as
    given when ``merge is None``."""
    assert inputs is not None
    axis = layout.find("T")
    in_axis = (in_layout or layout).find("T")
    if isinstance(inputs, symbol.Symbol):
        if merge is False:
            if length is None:
                raise MXNetError("length must be given to split a merged "
                                 "input sequence")
            inputs = list(symbol.SliceChannel(
                inputs, axis=in_axis, num_outputs=length, squeeze_axis=1))
        elif axis != in_axis:
            inputs = symbol.SwapAxis(inputs, dim1=axis, dim2=in_axis)
    elif merge is True:
        raise MXNetError("merging a list of step outputs (Concat) is not "
                         "ported yet")
    return inputs, axis


class BaseRNNCell:
    """Abstract RNN cell."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        """One step: (output_symbol, new_states)."""
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_shape(self):
        """List of state shapes; 0 marks the batch dimension."""
        raise NotImplementedError()

    def begin_state(self, func=None, batch_size=None, **kwargs):
        """Initial states: with ``func``, ``func(name=, shape=)`` symbols;
        without ``func`` or ``batch_size``, ``None`` (``unroll`` then
        derives the states from the data symbol)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called"
        if func is None:
            if batch_size is None:
                return None
            raise MXNetError("begin_state(batch_size=...) needs the _zeros "
                             "op, which is not ported yet: pass func=")
        states = []
        for shape in self.state_shape:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            states.append(func(name=name, shape=shape, **kwargs))
        return states

    def _derived_begin_state(self, data_sym, batch_axis=0):
        """States derived from a data symbol via ``_rnn_begin_state``."""
        states = []
        for shape in self.state_shape:
            self._init_counter += 1
            states.append(getattr(symbol, "_rnn_begin_state")(
                data_sym, shape=shape, batch_axis=batch_axis,
                name="%sbegin_state_%d" % (self._prefix, self._init_counter)))
        return states

    def unpack_weights(self, args):
        """Fused blobs -> per-cell matrices; plain cells already store
        per-cell matrices (an identity copy)."""
        return dict(args)

    def pack_weights(self, args):
        return dict(args)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll the cell ``length`` steps: (outputs, final states)."""
        raise NotImplementedError()


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN backed by the ``RNN`` op."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        from ..initializer import FusedRNN

        self._parameter = self.params.get(
            "parameters", init=FusedRNN(None, num_hidden, num_layers, mode,
                                        bidirectional, forget_bias))
        self._directions = 2 if bidirectional else 1

    @property
    def state_shape(self):
        n = self._num_layers * self._directions
        h = self._num_hidden
        if self._mode == "lstm":
            return [(n, 0, h), (n, 0, h)]
        return [(n, 0, h)]

    def _blob_layout(self, input_size):
        return _layer_param_slices(input_size, self._num_hidden,
                                   self._num_layers, self._mode,
                                   self._bidirectional)

    def unpack_weights(self, args):
        """Split ``<prefix>parameters`` into ``<prefix>{l,r}<layer>_``
        ``i2h_weight``, ``h2h_weight``, ``i2h_bias`` and ``h2h_bias``."""
        args = dict(args)
        blob = args.pop(self._prefix + "parameters")
        arr = blob.asnumpy() if isinstance(blob, ndarray.NDArray) else \
            np.asarray(blob)
        input_size = self._infer_input_size(arr)
        for layer, direction, sl in self._blob_layout(input_size):
            pre = "%s%s%d_" % (self._prefix, "lr"[direction], layer)
            for key, nm in (("wx", "i2h_weight"), ("wh", "h2h_weight"),
                            ("bx", "i2h_bias"), ("bh", "h2h_bias")):
                off, shape = sl[key]
                n = int(np.prod(shape))
                args[pre + nm] = ndarray.array(
                    arr[off:off + n].reshape(shape))
        return args

    def pack_weights(self, args):
        args = dict(args)
        first = args["%sl0_i2h_weight" % self._prefix]
        input_size = first.shape[1]
        total = rnn_param_size(input_size, self._num_hidden,
                               self._num_layers, self._mode,
                               self._bidirectional)
        arr = np.zeros((total,), dtype=np.float32)
        for layer, direction, sl in self._blob_layout(input_size):
            pre = "%s%s%d_" % (self._prefix, "lr"[direction], layer)
            for key, nm in (("wx", "i2h_weight"), ("wh", "h2h_weight"),
                            ("bx", "i2h_bias"), ("bh", "h2h_bias")):
                off, shape = sl[key]
                n = int(np.prod(shape))
                w = args.pop(pre + nm)
                w = w.asnumpy() if isinstance(w, ndarray.NDArray) else \
                    np.asarray(w)
                arr[off:off + n] = w.reshape(-1)
        args[self._prefix + "parameters"] = ndarray.array(arr)
        return args

    def _infer_input_size(self, arr):
        """Solve the blob length for the layer-0 input width."""
        g, h = _GATES[self._mode], self._num_hidden
        d = self._directions
        rest = rnn_param_size(1, h, self._num_layers, self._mode,
                              self._bidirectional) - d * g * h
        return (arr.size - rest) // (d * g * h)

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped — use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, True,
                                        in_layout=layout)
        if layout == "NTC":  # the RNN op is time-major
            inputs = symbol.SwapAxis(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self._derived_begin_state(inputs, batch_axis=1)
        states = begin_state
        state_kw = {"state": states[0]}
        if self._mode == "lstm":
            state_kw["state_cell"] = states[1]
        rnn = getattr(symbol, "RNN")(
            data=inputs, parameters=self._parameter,
            state_size=self._num_hidden, num_layers=self._num_layers,
            bidirectional=self._bidirectional, p=self._dropout,
            state_outputs=self._get_next_state, mode=self._mode,
            name=self._prefix + "rnn", **state_kw)
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if layout == "NTC":
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs, in_layout=layout)
        return outputs, states

    def unfuse(self):
        raise MXNetError("FusedRNNCell.unfuse is not ported yet (the "
                         "unfused cells come with a later slice)")


class SequentialRNNCell(BaseRNNCell):
    """Sequentially stacked cells."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, \
                "Either specify params for SequentialRNNCell or child " \
                "cells, not both."
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_shape(self):
        return sum([c.state_shape for c in self._cells], [])

    def begin_state(self, func=None, batch_size=None, **kwargs):
        assert not self._modified
        if batch_size is None and func is None:
            return None
        return sum([c.begin_state(func=func, batch_size=batch_size,
                                  **kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_shape)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        if begin_state is None:
            first, _ = _normalize_sequence(length, inputs, layout, False)
            begin_state = []
            for cell in self._cells:
                begin_state.extend(cell._derived_begin_state(first[0]))
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_shape)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Applies dropout on the input."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_shape(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout,
                                        merge_outputs)
        if isinstance(inputs, symbol.Symbol):
            return self(inputs, [])
        return [self(i, [])[0] for i in inputs], []
