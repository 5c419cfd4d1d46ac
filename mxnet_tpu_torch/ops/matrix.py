"""Shape ops (counterpart of ``mxnet_tpu/ops/matrix.py``): ``Reshape``
with MXNet's special codes, ``Flatten``, ``SwapAxis``,
``expand_dims`` and ``transpose``."""

from __future__ import annotations

from ..base import MXNetError
from .registry import REQUIRED, pbool, pint, ptuple, simple

simple("expand_dims", lambda data, axis: data.unsqueeze(axis),
       params={"axis": (pint, REQUIRED)})

simple("Flatten", lambda data: data.reshape(data.shape[0], -1),
       aliases=("flatten",))


def _infer_reshape(shape, src):
    """MXNet reshape codes: 0=keep dim, -1=infer, -2=copy rest, -3=merge
    next two, -4=split (next 2 entries)."""
    out, i = [], 0
    src = list(src)
    k = 0
    while k < len(shape):
        s = shape[k]
        if s > 0:
            out.append(s)
            i += 1
        elif s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = shape[k + 1], shape[k + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            k += 2
        else:
            raise MXNetError("reshape: bad code %d" % s)
        k += 1
    return tuple(out)


def _reshape(data, shape, target_shape, keep_highest, reverse):
    if not shape and target_shape:
        # legacy ReshapeParam.target_shape
        tgt = list(target_shape)
        if keep_highest:
            tgt[0] = data.shape[0]
        return data.reshape(tuple(tgt))
    if reverse:
        rs = _infer_reshape(tuple(reversed(shape)),
                            tuple(reversed(data.shape)))
        return data.reshape(tuple(reversed(rs)))
    return data.reshape(_infer_reshape(shape, data.shape))


simple("Reshape", _reshape,
       params={"shape": (ptuple, ()), "target_shape": (ptuple, ()),
               "keep_highest": (pbool, False), "reverse": (pbool, False)},
       aliases=("reshape",))

simple("SwapAxis", lambda data, dim1, dim2: data.transpose(dim1, dim2),
       params={"dim1": (pint, 0), "dim2": (pint, 0)}, aliases=("swapaxes",))


def _opt_tuple(v):
    if v in (None, "None"):
        return None
    return ptuple(v)


def _transpose(data, axes):
    return data.permute(axes if axes else tuple(reversed(range(data.ndim))))


simple("transpose", _transpose, params={"axes": (_opt_tuple, None)})
