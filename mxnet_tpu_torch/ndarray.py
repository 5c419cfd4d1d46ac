"""NDArray over a ``torch.Tensor`` (counterpart of
``mxnet_tpu/ndarray.py``), with the dmlc ``save``/``load`` format.

The on-disk bytes are the dmlc magic-header stream (uint64 magic 0x112 +
reserved, vector<NDArray> [u32 ndim + u32 dims, Context (i32 type, i32
id), i32 dtype flag, raw bytes], vector<string> names), byte-compatible in
both directions with ``mxnet_tpu.ndarray.save``/``load``.  An NDArray
pickles as the JAX package's does (``{"data", "ctx_type", "ctx_id"}``),
which the optimizer-state files use.  ``nd.<op>`` runs a registered op
imperatively (``nd.concat(a, b, dim=0)``).
"""

from __future__ import annotations

import io
import os
import struct
import sys

import numpy as np
import torch

from .base import MXNetError
from .context import Context, cpu, current_context
from .ops import registry as _reg
from .ops.registry import torch_dtype

__all__ = ["NDArray", "array", "zeros", "save", "load", "save_bytes"]


class NDArray:
    """A tensor on one context.  ``_t`` is the backing ``torch.Tensor``."""

    __slots__ = ["_t"]

    def __init__(self, tensor):
        self._t = tensor

    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def dtype(self):
        """numpy dtype (bfloat16 has none: reported as the torch dtype)."""
        if self._t.dtype == torch.bfloat16:
            return torch.bfloat16
        return torch.empty((), dtype=self._t.dtype).numpy().dtype

    @property
    def context(self):
        dev = self._t.device
        return cpu() if dev.type == "cpu" else Context("gpu", dev.index or 0)

    def asnumpy(self):
        """An independent numpy copy (bfloat16 is widened to float32)."""
        t = self._t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.device.type != "cpu":
            return t.cpu().numpy()  # the host copy is already a new buffer
        return t.numpy().copy()

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            src = value._t
        elif isinstance(value, torch.Tensor):
            src = value
        else:
            src = torch.tensor(np.asarray(value))
        with torch.no_grad():
            self._t[key] = src.to(device=self._t.device, dtype=self._t.dtype)

    def __getitem__(self, key):
        return NDArray(self._t[key])

    def copy(self):
        return NDArray(self._t.detach().clone())

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)

    # -- pickling (optimizer-state files) ---------------------------------
    def __getstate__(self):
        """The JAX package's keys: the data as numpy and the context."""
        ctx = self.context
        return {"data": self.asnumpy(), "ctx_type": ctx.device_typeid,
                "ctx_id": ctx.device_id}

    def __setstate__(self, st):
        """Onto the pickled device, or the CPU where that device is absent
        (a file written on a card, or by the JAX package on a TPU)."""
        try:
            dev = Context(st["ctx_type"], st["ctx_id"]).torch_device()
        except (KeyError, MXNetError):
            dev = torch.device("cpu")
        self._t = torch.from_numpy(np.array(st["data"])).to(dev)


def _device(ctx):
    return (ctx if isinstance(ctx, Context) else current_context()) \
        .torch_device()


def array(source, ctx=None, dtype=None):
    if isinstance(source, NDArray):
        source = source._t
    if isinstance(source, torch.Tensor):
        t = source.detach().clone()
    else:
        src = np.asarray(source)
        if dtype is None and src.dtype == np.float64:
            dtype = np.float32  # MXNet's default dtype
        t = torch.from_numpy(np.array(src, order="C"))  # 0-d stays 0-d
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return NDArray(t.to(_device(ctx)))


def zeros(shape, ctx=None, dtype=np.float32):
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


# -- dmlc save / load -------------------------------------------------------
_DMLC_MAGIC = 0x112
# mshadow type flags; 5 is the bfloat16 extension the JAX package claims
_FLAG_TO_DTYPE = {0: "float32", 1: "float64", 2: "float16", 3: "uint8",
                  4: "int32", 5: "bfloat16"}
_DTYPE_TO_FLAG = {v: k for k, v in _FLAG_TO_DTYPE.items()}


def _raw(a):
    """(dtype name, numpy array with the raw element bytes) of an array."""
    if isinstance(a, NDArray):
        a = a._t
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
        return str(t.dtype).replace("torch.", ""), t.numpy()
    arr = np.asarray(a)
    return arr.dtype.name, arr


def _write_array_segment(f, a):
    dname, arr = _raw(a)
    if dname not in _DTYPE_TO_FLAG:
        raise MXNetError("save: dtype %r has no dmlc type flag" % dname)
    f.write(struct.pack("<I", arr.ndim))
    f.write(struct.pack("<%dI" % arr.ndim, *arr.shape))
    f.write(struct.pack("<ii", 1, 0))           # Context: cpu(0)
    f.write(struct.pack("<i", _DTYPE_TO_FLAG[dname]))
    f.write(np.ascontiguousarray(arr).tobytes())


def _save_dmlc(f, names, arrays):
    f.write(struct.pack("<QQ", _DMLC_MAGIC, 0))
    f.write(struct.pack("<Q", len(arrays)))
    for a in arrays:
        _write_array_segment(f, a)
    f.write(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode()
        f.write(struct.pack("<Q", len(b)) + b)


def _read_array_segment(rd, rdbytes):
    (ndim,) = rd("<I")
    shape = rd("<%dI" % ndim) if ndim else ()
    rd("<ii")  # saved Context: arrays load onto the CPU
    (flag,) = rd("<i")
    dname = _FLAG_TO_DTYPE.get(flag)
    if dname is None:
        raise MXNetError("unknown dtype flag %d" % flag)
    n = int(np.prod(shape)) if shape else 1
    if dname == "bfloat16":
        raw = np.frombuffer(rdbytes(2 * n), np.int16).reshape(shape)
        return NDArray(torch.from_numpy(raw.copy()).view(torch.bfloat16))
    dt = np.dtype(dname)
    raw = np.frombuffer(rdbytes(dt.itemsize * n), dt).reshape(shape)
    return NDArray(torch.from_numpy(raw.copy()))


def _load_dmlc(f):
    def rdbytes(size):
        buf = f.read(size)
        if len(buf) != size:
            raise MXNetError("truncated params file")
        return buf

    def rd(fmt):
        return struct.unpack(fmt, rdbytes(struct.calcsize(fmt)))

    magic, _reserved = rd("<QQ")
    if magic != _DMLC_MAGIC:
        raise MXNetError("bad params magic 0x%x" % magic)
    (count,) = rd("<Q")
    arrays = [_read_array_segment(rd, rdbytes) for _ in range(count)]
    (n_names,) = rd("<Q")
    if n_names and n_names != len(arrays):
        raise MXNetError("malformed params file: %d names for %d arrays"
                         % (n_names, len(arrays)))
    names = []
    for _ in range(n_names):
        (ln,) = rd("<Q")
        names.append(rdbytes(ln).decode())
    return names, arrays


def _split(data):
    if isinstance(data, (NDArray, torch.Tensor, np.ndarray)):
        data = [data]
    if isinstance(data, dict):
        return list(data.keys()), list(data.values())
    if isinstance(data, (list, tuple)):
        return [], list(data)
    raise MXNetError("save: need NDArray, list, or dict")


def save_bytes(data):
    """The bytes :func:`save` would write (a params blob)."""
    f = io.BytesIO()
    _save_dmlc(f, *_split(data))
    return f.getvalue()


def save(fname, data):
    with open(str(fname), "wb") as f:
        _save_dmlc(f, *_split(data))


def _load_path(fname):
    # np.savez appends .npz; accept either spelling on load
    for cand in (fname, str(fname) + ".npz"):
        if os.path.exists(cand):
            return cand
    raise IOError("no such file: %r" % fname)


def load(fname):
    """A dmlc params file -> dict name -> NDArray (a list when saved
    without names), on the CPU."""
    with open(_load_path(fname), "rb") as f:
        names, arrays = _load_dmlc(f)
    if not names:
        return arrays if arrays else {}
    return dict(zip(names, arrays))


# -- imperative op functions (``nd.<op>``) -----------------------------------
def _invoke(op, args, kwargs):
    """Run ``op`` on NDArrays now, as the JAX package's ``nd.<op>`` does:
    positional NDArray (or numpy) arguments, then the keyword ones named
    after inputs, fill the op's inputs in declaration order, other keyword
    values are its params; a variadic op's count (Concat's ``num_args``)
    is the number of inputs when omitted; auxiliary states an op updates
    are written back."""
    kwargs.pop("name", None)

    def is_tensor(v):
        return isinstance(v, (NDArray, np.ndarray))

    named = {k: v for k, v in kwargs.items() if is_tensor(v)}
    attr_kwargs = {k: v for k, v in kwargs.items() if not is_tensor(v)}
    if not all(is_tensor(a) for a in args):
        raise MXNetError("%s: positional arguments must be arrays; pass "
                         "params by name" % op.name)
    if op.key_var_num_args and op.key_var_num_args not in attr_kwargs:
        attr_kwargs[op.key_var_num_args] = len(args) + len(named)
    attrs = op.canonicalize_attrs(attr_kwargs)
    it = iter(args)
    slots = []
    for group in (op.list_arguments(attrs), op.list_aux_states(attrs)):
        taken = []
        for nm in group:
            v = named.pop(nm, None)
            if v is None:
                v = next(it, None)
            if v is None:
                raise MXNetError("%s: missing input %r" % (op.name, nm))
            taken.append(v)
        slots.append(taken)
    if named or next(it, None) is not None:
        raise MXNetError("%s: surplus inputs %s" % (op.name, sorted(named)))
    dev = next((v._t.device for v in slots[0] + slots[1]
                if isinstance(v, NDArray)), torch.device("cpu"))
    inputs, aux = ([v if isinstance(v, NDArray)
                    else NDArray(torch.from_numpy(np.array(v)).to(dev))
                    for v in group] for group in slots)
    with torch.no_grad():
        outs, new_aux = op.apply_with_aux(attrs, [v._t for v in inputs],
                                          [v._t for v in aux], True)
    for arr, new in zip(aux, new_aux or ()):
        arr._t = new
    results = [NDArray(o) for o in outs]
    return results[0] if len(results) == 1 else results


def _make_op_func(op_name):
    op = _reg.get(op_name)

    def fn(*args, **kwargs):
        return _invoke(op, args, kwargs)

    fn.__name__ = op_name
    fn.__doc__ = "Imperative op %r" % op_name
    return fn


def _init_ndarray_module():
    mod = sys.modules[__name__]
    for op_name in _reg.list_ops():
        if not hasattr(mod, op_name):
            setattr(mod, op_name, _make_op_func(op_name))


_init_ndarray_module()
