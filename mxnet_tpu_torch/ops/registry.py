"""The single operator registry (counterpart of
``mxnet_tpu/ops/registry.py``).

An :class:`OpDef` bundles an op's named inputs/outputs, its typed attribute
spec (values parse from python values *or* strings, so graph JSON round
trips) and ``apply``, a plain function on tensors
``(attrs, inputs, aux, is_train) -> outputs`` (or ``(outputs, new_aux)``
for an op registered with ``updates_aux=True``, like BatchNorm's moving
statistics).  Forward shape and dtype
inference is derived from ``apply`` by running it on ``meta`` tensors,
where the JAX package uses ``jax.eval_shape``.

An op with no inputs (``_zeros``) makes its output on
:func:`scope_device`: the executor's device while it walks a graph,
``meta`` during shape inference, the CPU otherwise.  An op registered
with ``draws=True`` (``Dropout``, the ``RNN`` op) draws from
``mx.random``'s run-time generator of its device.
"""

from __future__ import annotations

import ast
import contextlib
import threading

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["OpDef", "register", "simple", "get", "list_ops", "REQUIRED",
           "pbool", "pint", "pfloat", "pstr", "ptuple", "pdtype",
           "torch_dtype", "device_scope", "scope_device"]

_REGISTRY: dict[str, "OpDef"] = {}
_ALIASES: dict[str, str] = {}

REQUIRED = object()
_scope = threading.local()


@contextlib.contextmanager
def device_scope(device):
    """Within the block, ops with no inputs make their outputs on
    ``device`` (this thread only)."""
    prev = getattr(_scope, "device", None)
    _scope.device = torch.device(device)
    try:
        yield
    finally:
        _scope.device = prev


def scope_device():
    """The device of :func:`device_scope`, the CPU outside one."""
    return getattr(_scope, "device", None) or torch.device("cpu")


# -- attr parsers (strings from graph JSON / user kwargs -> python) --------
def pbool(v):
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1", "yes")
    return bool(v)


def pint(v):
    return int(v)


def pfloat(v):
    return float(v)


def pstr(v):
    return str(v)


def ptuple(v):
    """Parse '(2, 2)' / '[2,2]' / (2,2) / 2 -> tuple of ints."""
    if isinstance(v, str):
        v = ast.literal_eval(v.strip())
    if isinstance(v, (int, float)):
        return (int(v),)
    return tuple(int(x) for x in v)


_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int32": torch.int32, "int8": torch.int8,
    "int64": torch.int64, "bool": torch.bool,
}


def pdtype(v):
    """dtype attr -> canonical string name."""
    if v is None:
        return None
    if isinstance(v, str):
        if v in _TORCH_DTYPES:
            return v
        raise MXNetError("unknown dtype %r" % v)
    return np.dtype(v).name


def torch_dtype(v):
    """Any dtype spelling (name, numpy dtype, torch dtype) -> torch dtype."""
    if isinstance(v, torch.dtype):
        return v
    return _TORCH_DTYPES[pdtype(v)]


# -- OpDef ------------------------------------------------------------------
def _as_fn(x):
    return x if callable(x) else (lambda attrs, _x=x: list(_x))


class OpDef:
    def __init__(self, name, apply_fn, *, arguments=("data",), aux_states=(),
                 outputs=("output",), params=None, hint=None,
                 updates_aux=False, key_var_num_args=None, draws=False):
        self.name = name
        self._apply = apply_fn
        #: apply_fn returns (outputs, new aux values or None)
        self.updates_aux = updates_aux
        self._arguments = _as_fn(arguments)
        self._aux_states = _as_fn(aux_states)
        self._outputs = _as_fn(outputs)
        self.params = params or {}
        self.hint = hint or name.lower().lstrip("_")
        #: the attr that counts a variadic op's inputs (Concat's
        #: ``num_args``), filled from the positional inputs when omitted
        self.key_var_num_args = key_var_num_args
        #: apply draws from ``mx.random``'s run-time generator in training
        self.draws = draws
        #: optional backward shape rule, attached by ops/infer.py:
        #: (attrs, in_shapes, in_dtypes, aux_shapes) -> (in_shapes, aux_shapes)
        self.infer_inputs = None
        #: optional reverse rule for an op whose output shape a consumer's
        #: rule fixed: (attrs, out_shape, in_shapes) -> in_shapes or None,
        #: ``in_shapes`` holding None where an input is unknown
        self.infer_from_output = None

    def list_arguments(self, attrs):
        return list(self._arguments(attrs))

    def list_aux_states(self, attrs):
        return list(self._aux_states(attrs))

    def list_outputs(self, attrs):
        return list(self._outputs(attrs))

    def canonicalize_attrs(self, kwargs):
        """kwargs -> plain dict with parsed values; rejects unknown keys."""
        out = {}
        for k, (parser, default) in self.params.items():
            if k in kwargs and kwargs[k] is not None:
                out[k] = parser(kwargs[k])
            elif default is REQUIRED:
                raise MXNetError("op %s: required param %r missing"
                                 % (self.name, k))
            else:
                out[k] = default
        unknown = set(kwargs) - set(self.params)
        if unknown:
            raise MXNetError("op %s: unknown params %s"
                             % (self.name, sorted(unknown)))
        return out

    def apply(self, attrs, inputs, aux, is_train):
        """Returns the list of output tensors."""
        return self.apply_with_aux(attrs, inputs, aux, is_train)[0]

    def apply_with_aux(self, attrs, inputs, aux, is_train):
        """Returns ``(outputs, new_aux)``; ``new_aux`` is None unless the
        op updates its auxiliary states (train-mode BatchNorm)."""
        outs = self._apply(attrs, list(inputs), list(aux), is_train)
        new_aux = None
        if self.updates_aux:
            outs, new_aux = outs
        n = len(self.list_outputs(attrs))
        if len(outs) != n:
            raise MXNetError("op %s: apply returned %d outputs, declared %d"
                             % (self.name, len(outs), n))
        return outs, new_aux

    def infer(self, attrs, in_metas, aux_metas):
        """Output ``meta`` tensors (shape + dtype, no data) for ``meta``
        inputs — the InferShape/InferType pass."""
        with torch.inference_mode(), device_scope("meta"):
            return self.apply(attrs, in_metas, aux_metas, False)


# -- registration / lookup -------------------------------------------------
def register(name, apply_fn, *, aliases=(), **kw):
    if name in _REGISTRY:
        raise MXNetError("op %s registered twice" % name)
    _REGISTRY[name] = OpDef(name, apply_fn, **kw)
    for a in aliases:
        _ALIASES[a] = name
    return apply_fn


def simple(name, fn, *, arguments=("data",), params=None, aliases=(), **kw):
    """Register ``fn(*inputs, **attrs) -> tensor`` as a one-output op."""

    def apply(attrs, inputs, aux, is_train):
        return [fn(*inputs, **attrs)]

    register(name, apply, arguments=arguments, params=params,
             aliases=aliases, **kw)
    return fn


def get(name) -> OpDef:
    name = _ALIASES.get(name, name)
    if name not in _REGISTRY:
        raise MXNetError("unknown op %r" % name)
    return _REGISTRY[name]


def list_ops():
    return sorted(_REGISTRY) + sorted(_ALIASES)
