"""Symbolic graph API (``mx.sym``), counterpart of ``mxnet_tpu/symbol.py``.

A Symbol is a lightweight DAG of op nodes over the single op registry.
The graph JSON is the JAX package's format, so a graph written by either
package loads in the other.  Shape inference walks the graph in
topological order, filling parameter shapes with the per-op backward rules
(``ops/infer.py``) and propagating outputs by running each op on ``meta``
tensors.  ``simple_bind`` allocates the arrays (and gradients for
``grad_req`` other than "null") and returns an
:class:`~mxnet_tpu_torch.executor.Executor`.
"""

from __future__ import annotations

import ast
import json
import sys

import torch

from .attribute import AttrScope
from .base import MXNetError, NameManager
from .ops import registry as _reg

__all__ = ["Symbol", "Variable", "Group", "load", "load_json"]


class _Node:
    __slots__ = ["op", "name", "attrs", "inputs", "misc_attr"]

    def __init__(self, op, name, attrs, inputs, misc_attr=None):
        self.op = op  # OpDef, or None for variables
        self.name = name
        self.attrs = attrs or {}
        self.inputs = inputs or []  # list of (node, out_index)
        self.misc_attr = dict(misc_attr or {})

    @property
    def is_variable(self):
        return self.op is None

    def num_args(self):
        return len(self.op.list_arguments(self.attrs)) if self.op else 0


def _topo(heads):
    """Post-order DFS over the head entries (nnvm IndexedGraph order)."""
    order, seen = [], set()
    stack = [(n, False) for n, _ in reversed(heads)]
    while stack:
        node, done = stack.pop()
        if done:
            order.append(node)
            continue
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.append((node, True))
        for child, _ in reversed(node.inputs):
            if id(child) not in seen:
                stack.append((child, False))
    return order


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _infer_sweep(nodes, var_shape, var_dtype, expected):
    """One forward pass of shape inference in topological order.  Fills
    ``var_shape``/``var_dtype`` through the ops' backward rules and
    ``expected`` with the shapes rules ask of op-node outputs.  Returns
    (entry -> meta tensor, [(node, missing input names)])."""
    entry, missing = {}, []
    for node in nodes:
        if node.is_variable:
            if var_shape.get(node.name) is not None:
                entry[(id(node), 0)] = _meta(
                    var_shape[node.name],
                    var_dtype.get(node.name) or torch.float32)
            continue
        op = node.op
        na = node.num_args()
        in_entries, aux_entries = node.inputs[:na], node.inputs[na:]
        ins = [entry.get((id(c), ci)) for c, ci in in_entries]
        auxs = [entry.get((id(c), ci)) for c, ci in aux_entries]
        if op.infer_inputs is not None and (
                any(t is None for t in ins) or any(t is None for t in auxs)):
            in_shapes, aux_shapes = op.infer_inputs(
                node.attrs,
                [None if t is None else tuple(t.shape) for t in ins],
                [None if t is None else t.dtype for t in ins],
                [None if t is None else tuple(t.shape) for t in auxs])
            base_dt = next((t.dtype for t in ins if t is not None),
                           torch.float32)
            for group, shapes, dflt in ((in_entries, in_shapes, base_dt),
                                        (aux_entries, aux_shapes,
                                         torch.float32)):
                for (child, ci), s in zip(group, shapes):
                    if s is None or (id(child), ci) in entry:
                        continue
                    if not child.is_variable:
                        expected[(id(child), ci)] = tuple(s)
                        continue
                    dt = var_dtype.get(child.name) or dflt
                    var_shape[child.name] = tuple(s)
                    var_dtype[child.name] = dt
                    entry[(id(child), ci)] = _meta(s, dt)
            ins = [entry.get((id(c), ci)) for c, ci in in_entries]
            auxs = [entry.get((id(c), ci)) for c, ci in aux_entries]
        if any(t is None for t in ins) or any(t is None for t in auxs):
            missing.append((node, [c.name for (c, _ci), t in
                                   zip(node.inputs, ins + auxs) if t is None]))
            continue
        for i, out in enumerate(op.infer(node.attrs, ins, auxs)):
            entry[(id(node), i)] = out
    return entry, missing


def _reverse_fill(nodes, var_shape, expected, entry):
    """Give unknown variables feeding an op the input shapes the op's
    reverse rule derives from its expected output shape and its known
    inputs.  True when a variable shape was filled (another sweep can
    then go further)."""
    filled = False
    for node in reversed(nodes):
        want = expected.get((id(node), 0))
        if node.is_variable or want is None \
                or node.op.infer_from_output is None:
            continue
        ins = node.inputs[:node.num_args()]
        known = [None if (id(c), ci) not in entry
                 else tuple(entry[(id(c), ci)].shape) for c, ci in ins]
        shapes = node.op.infer_from_output(node.attrs, want, known)
        for (child, _ci), s in zip(ins, shapes or ()):
            if s is not None and child.is_variable \
                    and var_shape.get(child.name) is None:
                var_shape[child.name] = tuple(s)
                filled = True
    return filled


def _attr_str(v):
    if isinstance(v, (tuple, list)):
        return str(tuple(v))
    return str(v)


class Symbol:
    """A multi-output symbolic graph handle."""

    __slots__ = ["_outputs"]

    def __init__(self, outputs):
        self._outputs = list(outputs)  # list of (node, out_index)

    def _entry(self):
        if len(self._outputs) != 1:
            raise MXNetError("operation requires a single-output symbol; "
                             "use sym[i] to pick an output")
        return self._outputs[0]

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("no output named %r (have %s)"
                                 % (index, names))
            index = names.index(index)
        return Symbol([self._outputs[index]])

    @property
    def name(self):
        return self._outputs[0][0].name if len(self._outputs) == 1 else None

    # -- introspection ----------------------------------------------------
    def _nodes(self):
        return _topo(self._outputs)

    def _arg_aux_vars(self):
        """Variables split into (args, auxs) by the op slot consuming them."""
        nodes = self._nodes()
        aux_ids = set()
        for node in nodes:
            if not node.is_variable:
                for child, _ in node.inputs[node.num_args():]:
                    aux_ids.add(id(child))
        args, auxs = [], []
        for node in nodes:
            if node.is_variable:
                (auxs if id(node) in aux_ids else args).append(node)
        return args, auxs

    def list_arguments(self):
        return [n.name for n in self._arg_aux_vars()[0]]

    def list_auxiliary_states(self):
        return [n.name for n in self._arg_aux_vars()[1]]

    def list_outputs(self):
        names = []
        for node, idx in self._outputs:
            if node.is_variable:
                names.append(node.name)
            else:
                outs = node.op.list_outputs(node.attrs)
                names.append("%s_%s" % (node.name, outs[idx]))
        return names

    def attr_dict(self):
        """{node name: {attr: str}} for every node with attributes (the
        initializer's ``__init__`` and the optimizer's ``__lr_mult__``/
        ``__wd_mult__`` are read from here)."""
        out = {}
        for node in self._nodes():
            d = dict(node.misc_attr)
            if not node.is_variable:
                d.update({k: _attr_str(v) for k, v in node.attrs.items()})
            if d:
                out[node.name] = d
        return out

    def get_internals(self):
        """Every intermediate output as one multi-output Symbol."""
        entries = []
        for node in self._nodes():
            n_out = 1 if node.is_variable \
                else len(node.op.list_outputs(node.attrs))
            entries.extend((node, i) for i in range(n_out))
        return Symbol(entries)

    # -- shape / type inference ------------------------------------------
    def _infer_shapes_full(self, shape_kwargs, type_kwargs=None):
        """Topological forward propagation with per-op backward filling.
        Returns (var_shape, var_dtype, entry_meta): variable name -> shape
        tuple / torch dtype, and (id(node), index) -> meta tensor."""
        type_kwargs = type_kwargs or {}
        args, auxs = self._arg_aux_vars()
        var_shape, var_dtype = {}, {}
        for n in args + auxs:
            s = shape_kwargs.get(n.name)
            if s is None and "__shape__" in n.misc_attr:
                s = ast.literal_eval(n.misc_attr["__shape__"])
            var_shape[n.name] = tuple(s) if s is not None else None
            dt = type_kwargs.get(n.name)
            var_dtype[n.name] = _reg.torch_dtype(dt) if dt is not None \
                else None
        nodes = self._nodes()
        # shapes a consumer's rule asked of op-node outputs (SoftmaxOutput
        # fixes its label input even when that input is a Reshape)
        expected = {}
        while True:
            entry, missing = _infer_sweep(nodes, var_shape, var_dtype,
                                          expected)
            if not missing or not _reverse_fill(nodes, var_shape, expected,
                                                 entry):
                break
        if missing:
            node, names = missing[0]
            raise MXNetError("infer_shape: cannot infer inputs %s of node %s"
                             % (names, node.name))
        for n in args + auxs:
            if var_shape[n.name] is not None and var_dtype[n.name] is None:
                var_dtype[n.name] = torch.float32
        return var_shape, var_dtype, entry

    def infer_shape(self, *args, **kwargs):
        """-> (arg_shapes, out_shapes, aux_shapes), each ordered like the
        respective ``list_*()`` call."""
        if args:
            kwargs = dict(zip(self.list_arguments(), args), **kwargs)
        shape_kwargs = {k: v for k, v in kwargs.items() if v is not None}
        var_shape, _vd, entry = self._infer_shapes_full(shape_kwargs)
        arg_shapes = [var_shape.get(n) for n in self.list_arguments()]
        aux_shapes = [var_shape.get(n) for n in self.list_auxiliary_states()]
        out_shapes = [tuple(entry[(id(n), i)].shape) for n, i in self._outputs]
        return arg_shapes, out_shapes, aux_shapes

    # -- binding ----------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="null", type_dict=None,
                    **kwargs):
        """Infer every shape from ``kwargs`` and allocate an executor on
        ``ctx`` (default: the card, ``gpu(0)``); ``grad_req`` ("null",
        "write" or "add", or a per-argument list or dict) allocates the
        gradients of a training executor."""
        from .executor import Executor

        return Executor.simple_bind(self, ctx, grad_req=grad_req,
                                    type_dict=type_dict, **kwargs)

    # -- serialization ----------------------------------------------------
    def tojson(self):
        nodes = self._nodes()
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jn = {"op": "null" if n.is_variable else n.op.name,
                  "name": n.name,
                  "attrs": {k: _attr_str(v) for k, v in n.attrs.items()},
                  "misc_attrs": n.misc_attr,
                  "inputs": [[nid[id(c)], ci] for c, ci in n.inputs]}
            if n.is_variable:
                jn.pop("attrs")
            jnodes.append(jn)
        payload = {
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_variable],
            "heads": [[nid[id(n)], i] for n, i in self._outputs],
            # the format marker the JAX package writes and reads
            "mxnet_tpu_version": 1,
        }
        return json.dumps(payload, indent=2)

    def save(self, fname):
        """Write :meth:`tojson` to ``fname`` (``prefix-symbol.json``)."""
        with open(fname, "w") as f:
            f.write(self.tojson())

    def __repr__(self):
        return "<Symbol %s>" % (self.name or self.list_outputs())

    # -- operators --------------------------------------------------------
    def __add__(self, other):
        return _binop(self, other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return _binop(self, other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return _binop(self, other, None, "_rminus_scalar")

    def __mul__(self, other):
        return _binop(self, other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _binop(self, other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _binop(self, other, None, "_rdiv_scalar")

    def __neg__(self):
        return _binop(self, -1.0, None, "_mul_scalar")


def _binop(lhs, rhs, arr_op, scalar_op):
    """``lhs <op> rhs``: the elementwise op on two symbols, the scalar op
    (``scalar=float(rhs)``) otherwise."""
    mod = sys.modules[__name__]
    if isinstance(rhs, Symbol):
        if arr_op is None:
            raise MXNetError("unsupported symbol-symbol op")
        return getattr(mod, arr_op)(lhs, rhs)
    return getattr(mod, scalar_op)(lhs, scalar=float(rhs))


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs):
    """A graph input; ``shape``, ``lr_mult``, ``wd_mult``, ``dtype`` and
    ``init`` (an initializer, or its JSON ``dumps()``) are recorded as the
    ``__shape__``, ``__lr_mult__``, ``__wd_mult__``, ``__dtype__`` and
    ``__init__`` attrs."""
    misc = AttrScope.current().get(attr)
    if shape is not None:
        misc["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        misc["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        misc["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        misc["__dtype__"] = str(dtype)
    if init is not None:
        misc["__init__"] = init if isinstance(init, str) else init.dumps()
    misc.update({k: str(v) for k, v in kwargs.items()})
    return Symbol([(_Node(None, name, {}, [], misc), 0)])


def Group(symbols):
    """One symbol whose outputs are those of ``symbols``, in order."""
    entries = []
    for s in symbols:
        entries.extend(s._outputs)
    return Symbol(entries)


def load_json(json_str):
    payload = json.loads(json_str)
    if "mxnet_tpu_version" not in payload:
        raise MXNetError("load_json: not a graph written by this framework "
                         "(the 0.9.x legacy upgrade is not ported yet)")
    nodes = []
    for jn in payload["nodes"]:
        if jn["op"] == "null":
            nodes.append(_Node(None, jn["name"], {}, [],
                               jn.get("misc_attrs", {})))
            continue
        op = _reg.get(jn["op"])
        attrs = op.canonicalize_attrs(jn.get("attrs", {}))
        inputs = [(nodes[i], ci) for i, ci, *_ in jn["inputs"]]
        nodes.append(_Node(op, jn["name"], attrs, inputs,
                           jn.get("misc_attrs", {})))
    return Symbol([(nodes[i], ci) for i, ci, *_ in payload["heads"]])


def load(fname):
    """The graph a :meth:`Symbol.save` of either package wrote."""
    with open(fname) as f:
        return load_json(f.read())


# -- generated sym.<op> composition functions ------------------------------
def _compose(op, args, kwargs):
    name = kwargs.pop("name", None)
    attr = kwargs.pop("attr", None)
    sym_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
    attr_kwargs = {k: v for k, v in kwargs.items()
                   if not isinstance(v, Symbol)}
    for a in args:
        if not isinstance(a, Symbol):
            raise MXNetError("%s: positional args must be Symbols" % op.name)
    if op.key_var_num_args and op.key_var_num_args not in attr_kwargs:
        attr_kwargs[op.key_var_num_args] = len(args) + len(sym_kwargs)
    attrs = op.canonicalize_attrs(attr_kwargs)
    name = NameManager.current().get(name, op.hint)
    inputs = []
    pos = iter(args)
    for nm in op.list_arguments(attrs):
        if nm in sym_kwargs:
            inputs.append(sym_kwargs.pop(nm)._entry())
            continue
        nxt = next(pos, None)
        # a missing argument becomes a variable named <node>_<arg>
        inputs.append(nxt._entry() if nxt is not None
                      else Variable("%s_%s" % (name, nm))._outputs[0])
    for nm in op.list_aux_states(attrs):
        inputs.append(sym_kwargs.pop(nm)._entry() if nm in sym_kwargs
                      else Variable("%s_%s" % (name, nm))._outputs[0])
    if sym_kwargs:
        raise MXNetError("%s: unknown symbol inputs %s"
                         % (op.name, sorted(sym_kwargs)))
    node = _Node(op, name, attrs, inputs, AttrScope.current().get(attr))
    return Symbol([(node, i) for i in range(len(op.list_outputs(attrs)))])


def _make_sym_func(op_name):
    op = _reg.get(op_name)

    def fn(*args, **kwargs):
        return _compose(op, args, kwargs)

    fn.__name__ = op_name
    fn.__doc__ = "Symbolic op %r" % op_name
    return fn


def _init_symbol_module():
    mod = sys.modules[__name__]
    for op_name in _reg.list_ops():
        if not hasattr(mod, op_name):
            setattr(mod, op_name, _make_sym_func(op_name))


_init_symbol_module()
