"""Symbolic RNN cells (``mx.rnn``), counterpart of
``mxnet_tpu/rnn/rnn_cell.py``: :class:`RNNParams`, :class:`BaseRNNCell`,
the unfused :class:`RNNCell`, :class:`LSTMCell` and :class:`GRUCell`,
:class:`FusedRNNCell` (``unroll``, ``unpack_weights``/``pack_weights``,
``unfuse``), :class:`SequentialRNNCell`, :class:`BidirectionalCell`,
:class:`DropoutCell` and the modifier cells :class:`ModifierCell` and
:class:`ZoneoutCell`.

``FusedRNNCell`` maps to the ``RNN`` op (``ops/rnn.py``): on the card its
LSTM recurrence runs kernels K4-K6.  The unfused cells build the graph of
FullyConnected, SliceChannel, Activation and elementwise ops that the JAX
package builds (cuBLAS and torch ops on the card, no kernel of this
port), node name for node name: ``unroll`` hoists the input projection
of all steps into one product (``%si2h_cat`` Concat on the batch axis,
``%si2h_seq`` FullyConnected, ``%si2h_split`` SliceChannel) and steps
only the recurrence (``%st%d_``), so graphs and checkpoints cross between
the packages.  The fused blob layout and the names ``unpack_weights``
gives (``lstm_l0_i2h_weight``, ...) are the JAX package's, and are the
unfused cells' own argument names, so ``unfuse()`` reads a fused
checkpoint as it is.

``begin_state()`` with no ``func`` or ``batch_size`` returns ``None``;
``unroll`` then derives zero states from the data symbol through
``_rnn_begin_state``.  ``begin_state(batch_size=N)`` gives ``_zeros``
symbols.  Gate orders (shared with the fused op): LSTM ``i, f, g, o``;
GRU ``r, z, n``.  ``DropoutCell`` and ``ZoneoutCell`` draw their masks
through ``Dropout`` from ``mx.random``'s generator.
"""

from __future__ import annotations

import numpy as np

from .. import ndarray
from .. import symbol
from ..base import MXNetError
from ..ops.rnn import _GATES, _layer_param_slices, rnn_param_size

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell"]


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
        inputs = [symbol.expand_dims(i, axis=axis) for i in inputs]
        inputs = symbol.Concat(*inputs, dim=axis)
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
        with ``batch_size``, ``_zeros`` symbols of that batch; with
        neither, ``None`` (``unroll`` then derives the states from the
        data symbol)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called"
        if batch_size is None and func is None:
            return None
        states = []
        for shape in self.state_shape:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            if func is not None:
                states.append(func(name=name, shape=shape, **kwargs))
                continue
            full = tuple(batch_size if s == 0 else s for s in shape)
            states.append(getattr(symbol, "_zeros")(name=name, shape=full))
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
        """Unroll the cell ``length`` steps: (outputs, final states), the
        outputs one merged symbol when ``merge_outputs=True``, else a
        list of step symbols.  A gated cell projects the inputs of all
        steps at once (:meth:`_hoisted_i2h`) and steps the recurrence."""
        self.reset()
        inputs_list, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self._derived_begin_state(inputs_list[0])
        states = begin_state
        i2h_seq = self._hoisted_i2h(inputs_list)
        outputs = []
        for i in range(length):
            if i2h_seq is None:
                output, states = self(inputs_list[i], states)
            else:
                self._counter += 1
                name = "%st%d_" % (self._prefix, self._counter)
                output, states = self._step(i2h_seq[i], states, name)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    def _hoisted_i2h(self, inputs_list):
        """Per-step input projections from one whole-sequence product, or
        None (``unroll`` then steps ``self(...)``)."""
        return None

    def _i2h_seq(self, inputs_list, num_hidden_total):
        """Concat the T step inputs on the batch axis, project once, slice
        back into per-step ``(N, G*H)`` blocks."""
        cat = symbol.Concat(*inputs_list, dim=0,
                            name="%si2h_cat" % self._prefix)
        proj = symbol.FullyConnected(
            data=cat, weight=self._iW, bias=self._iB,
            num_hidden=num_hidden_total, name="%si2h_seq" % self._prefix)
        return list(symbol.SliceChannel(
            proj, num_outputs=len(inputs_list), axis=0,
            name="%si2h_split" % self._prefix))

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class _GatedCell(BaseRNNCell):
    """A cell of ``gates`` blocks of ``num_hidden``: its four weights, a
    step from an input projection (:meth:`_step`), and the hoisted
    projection for ``unroll``."""

    _gates = 1

    def __init__(self, num_hidden, prefix, params, i2h_bias_init=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias") if i2h_bias_init is None \
            else self.params.get("i2h_bias", init=i2h_bias_init)
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * self._gates,
                                    name="%si2h" % name)
        return self._step(i2h, states, name)

    def _hoisted_i2h(self, inputs_list):
        if len(inputs_list) < 2:
            return None
        return self._i2h_seq(inputs_list, self._num_hidden * self._gates)

    def _h2h(self, h, name):
        return symbol.FullyConnected(data=h, weight=self._hW, bias=self._hB,
                                     num_hidden=self._num_hidden
                                     * self._gates, name="%sh2h" % name)

    def _step(self, i2h, states, name):
        raise NotImplementedError()


class RNNCell(_GatedCell):
    """Vanilla RNN cell: h' = act(W_x x + b_x + W_h h + b_h)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(num_hidden, prefix, params)
        self._activation = activation

    @property
    def state_shape(self):
        return [(0, self._num_hidden)]

    def _step(self, i2h, states, name):
        output = self._get_activation(i2h + self._h2h(states[0], name),
                                      self._activation, name="%sout" % name)
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM cell; gate order ``i, f, g, o`` (shared with the fused op);
    ``i2h_bias`` initialized by ``LSTMBias(forget_bias)``."""

    _gates = 4

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        from ..initializer import LSTMBias

        super().__init__(num_hidden, prefix, params,
                         LSTMBias(forget_bias=forget_bias))

    @property
    def state_shape(self):
        return [(0, self._num_hidden), (0, self._num_hidden)]

    def _step(self, i2h, states, name):
        gates = i2h + self._h2h(states[0], name)
        sliced = symbol.SliceChannel(gates, num_outputs=4, axis=1,
                                     name="%sslice" % name)
        in_gate = symbol.Activation(sliced[0], act_type="sigmoid")
        forget_gate = symbol.Activation(sliced[1], act_type="sigmoid")
        in_transform = symbol.Activation(sliced[2], act_type="tanh")
        out_gate = symbol.Activation(sliced[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh",
                                              name="%sout" % name)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU cell; gate order ``r, z, n``; the candidate takes ``r * (W_h h
    + b_h)``, as the fused op does."""

    _gates = 3

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(num_hidden, prefix, params)

    @property
    def state_shape(self):
        return [(0, self._num_hidden)]

    def _step(self, i2h, states, name):
        prev_h = states[0]
        h2h = self._h2h(prev_h, name)
        i2h_r, i2h_z, i2h_n = symbol.SliceChannel(
            i2h, num_outputs=3, axis=1, name="%si2h_slice" % name)
        h2h_r, h2h_z, h2h_n = symbol.SliceChannel(
            h2h, num_outputs=3, axis=1, name="%sh2h_slice" % name)
        reset = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = symbol.Activation(i2h_n + reset * h2h_n,
                                       act_type="tanh")
        ones = next_h_tmp * 0.0 + 1.0
        next_h = (ones - update) * next_h_tmp + update * prev_h
        return next_h, [next_h]


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
        """The equivalent stack of unfused cells, named after this blob's
        unpacked weights (``<prefix>l0_``, ``<prefix>r0_``, ...), with a
        ``DropoutCell`` between layers where the fused op drops out."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden,
                                       forget_bias=self._forget_bias,
                                       prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_"
                                      % (self._prefix, i)))
        return stack


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


class ModifierCell(BaseRNNCell):
    """Base of the cells that wrap another cell: the wrapped cell can no
    longer be called on its own."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_shape(self):
        return self.base_cell.state_shape

    def begin_state(self, func=None, batch_size=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, batch_size=batch_size,
                                           **kwargs)
        self.base_cell._modified = True
        return begin

    def _derived_begin_state(self, data_sym, batch_axis=0):
        return self.base_cell._derived_begin_state(data_sym, batch_axis)

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError()


class ZoneoutCell(ModifierCell):
    """Zoneout: each unit keeps its previous output (state) with
    probability ``zoneout_outputs`` (``zoneout_states``); the masks are
    ``Dropout(ones_like(x)) * (1 - p)``, 0 or 1."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell does not support zoneout; unfuse() first"
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p) * (1.0 - p)

        prev_output = self.prev_output if self.prev_output is not None \
            else next_output * 0.0
        output = next_output
        if p_outputs != 0.0:
            m = mask(p_outputs, next_output)
            output = m * next_output + (1.0 - m) * prev_output
        if p_states != 0.0:
            new_states = []
            for new_s, old_s in zip(next_states, states):
                m = mask(p_states, new_s)
                new_states.append(m * new_s + (1.0 - m) * old_s)
        else:
            new_states = next_states
        self.prev_output = output
        return output, new_states


class BidirectionalCell(BaseRNNCell):
    """Runs ``l_cell`` forward and ``r_cell`` over the reversed sequence
    and concatenates their step outputs (``<output_prefix>t%d``)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped — use unroll")

    @property
    def state_shape(self):
        return sum([c.state_shape for c in self._cells], [])

    def begin_state(self, func=None, batch_size=None, **kwargs):
        assert not self._modified
        if batch_size is None and func is None:
            return None
        return sum([c.begin_state(func=func, batch_size=batch_size,
                                  **kwargs) for c in self._cells], [])

    def _derived_begin_state(self, data_sym, batch_axis=0):
        states = []
        for c in self._cells:
            states.extend(c._derived_begin_state(data_sym, batch_axis))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs_list, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self._derived_begin_state(inputs_list[0])
        states = begin_state
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_shape)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs_list, begin_state=states[:n_l],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs_list)),
            begin_state=states[n_l:], layout=layout, merge_outputs=False)
        outputs = [
            symbol.Concat(l_o, r_o, dim=1,
                          name="%st%d" % (self._output_prefix, i))
            for i, (l_o, r_o) in enumerate(zip(l_outputs,
                                               reversed(r_outputs)))]
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, l_states + r_states
