"""The executor (counterpart of ``mxnet_tpu/executor.py``).

``simple_bind`` infers every shape, allocates the arguments (and, for
``grad_req`` other than ``"null"``, their gradients) on the bound device
and returns an :class:`Executor`.

* ``forward(is_train=False)`` walks the DAG once under
  ``torch.inference_mode()``.
* ``forward(is_train=True)`` walks it under autograd, with each argument
  whose ``grad_req`` is not ``"null"`` as a leaf, and commits the
  auxiliary-state updates (BatchNorm's moving statistics) at once, as the
  JAX package does.  BatchNorm nodes whose only consumer is a relu
  ``Activation`` run as one kernel with the ReLU fused (the BN->ReLU
  peephole, ``mxnet_tpu/executor.py:177-259``).
* ``backward(out_grads=None)`` differentiates the outputs of that forward
  (head gradients default to ones; ``SoftmaxOutput`` ignores them unless
  ``out_grad``) and writes or adds into ``grad_dict`` per ``grad_req``.
  The graph is freed: one backward per training forward.
"""

from __future__ import annotations

import torch

from .base import MXNetError
from .context import as_context, gpu
from .ndarray import NDArray, zeros
from .ops.nn import _batch_norm

__all__ = ["Executor"]

#: ops whose backward is not ported yet: a training bind through them
#: raises instead of handing back gradients that stop there
_NO_BACKWARD = ("_contrib_FlashAttention", "_contrib_MultiHeadAttention")


def _bn_relu_peephole(symbol, nodes):
    """BatchNorm nodes whose SOLE consumer is a relu ``Activation`` fuse
    into one kernel launch.  Returns ({id(bn)}, {id(act): bn_node})."""
    count = {}
    for node in nodes:
        for c, ci in node.inputs:
            count[(id(c), ci)] = count.get((id(c), ci), 0) + 1
    for n, i in symbol._outputs:
        count[(id(n), i)] = count.get((id(n), i), 0) + 1  # outputs stay
    bn_defer, act_fuse = set(), {}
    for node in nodes:
        if node.is_variable or node.op.name != "Activation" \
                or node.attrs.get("act_type") != "relu":
            continue
        child, ci = node.inputs[0]
        if ci != 0 or child.is_variable or child.op.name != "BatchNorm":
            continue
        a = child.attrs
        if a.get("use_global_stats") or a.get("output_mean_var"):
            continue
        if count.get((id(child), 0), 0) != 1:
            continue
        bn_defer.add(id(child))
        act_fuse[id(node)] = child
    return bn_defer, act_fuse


def _grad_req_map(grad_req, arg_names):
    if isinstance(grad_req, str):
        req = {n: grad_req for n in arg_names}
    elif isinstance(grad_req, (list, tuple)):
        req = dict(zip(arg_names, grad_req))
    else:
        req = dict(grad_req)
    req = {n: req.get(n, "null") for n in arg_names}
    bad = sorted({r for r in req.values()} - {"null", "write", "add"})
    if bad:
        raise MXNetError("grad_req must be 'null', 'write' or 'add', got %s"
                         % bad)
    return req


class Executor:
    def __init__(self, symbol, ctx, arg_dict, grad_dict, grad_req, aux_dict):
        self._symbol = symbol
        self._ctx = ctx
        self._nodes = symbol._nodes()
        self._peephole = _bn_relu_peephole(symbol, self._nodes)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.arg_dict = arg_dict
        self.grad_dict = grad_dict
        self.aux_dict = aux_dict
        self.grad_req = _grad_req_map(grad_req, self.arg_names)
        self.outputs = []
        self._pending = None  # (output tensors, {name: leaf}) for backward

    arg_arrays = property(lambda s: [s.arg_dict[n] for n in s.arg_names])
    grad_arrays = property(lambda s: [s.grad_dict.get(n)
                                      for n in s.arg_names])
    aux_arrays = property(lambda s: [s.aux_dict[n] for n in s.aux_names])

    def _diff_names(self):
        return [n for n in self.arg_names if self.grad_req[n] != "null"]

    @staticmethod
    def simple_bind(symbol, ctx=None, grad_req="null", type_dict=None,
                    shared_exec=None, **shapes):
        """Bind ``symbol`` on ``ctx`` with every shape inferred from
        ``shapes``.  With ``shared_exec`` (bucketing), each argument,
        gradient and auxiliary state whose name and shape match one of
        ``shared_exec``'s is that very NDArray: the executors train one
        set of weights."""
        ctx = as_context(ctx, gpu(0))
        ctx.torch_device()  # raises here when the card is missing
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        req = _grad_req_map(grad_req, arg_names)
        if any(r != "null" for r in req.values()):
            for node in symbol._nodes():
                if not node.is_variable and node.op.name in _NO_BACKWARD:
                    raise MXNetError(
                        "simple_bind(grad_req=%r): training through %s "
                        "(node %s) is not ported yet: its kernel has no "
                        "backward" % (grad_req, node.op.name, node.name))
        type_dict = dict(type_dict or {})
        for node in symbol._nodes():
            if node.is_variable and "__dtype__" in node.misc_attr:
                type_dict.setdefault(node.name, node.misc_attr["__dtype__"])
        var_shape, var_dtype, _ = symbol._infer_shapes_full(shapes, type_dict)
        unknown = [n for n in arg_names + aux_names if var_shape.get(n) is None]
        if unknown:
            raise MXNetError("simple_bind: cannot infer shapes for %s — "
                             "provide them as kwargs" % unknown)
        arg_dict = {n: zeros(var_shape[n], ctx, var_dtype[n])
                    for n in arg_names}
        grad_dict = {n: zeros(var_shape[n], ctx, var_dtype[n])
                     for n in arg_names if req[n] != "null"}
        aux_dict = {n: zeros(var_shape[n], ctx, var_dtype[n])
                    for n in aux_names}
        if shared_exec is not None:
            for n in arg_names:
                src = shared_exec.arg_dict.get(n)
                if src is not None and src.shape == arg_dict[n].shape:
                    arg_dict[n] = src
                    if n in shared_exec.grad_dict and n in grad_dict:
                        grad_dict[n] = shared_exec.grad_dict[n]
            for n in aux_names:
                src = shared_exec.aux_dict.get(n)
                if src is not None and src.shape == aux_dict[n].shape:
                    aux_dict[n] = src
        return Executor(symbol, ctx, arg_dict, grad_dict, req, aux_dict)

    def _walk(self, is_train, leaves):
        """Apply every op in topological order; returns (outputs, {aux
        name: new value})."""
        vals, new_aux, bn_stash = {}, {}, {}
        bn_defer, act_fuse = self._peephole if is_train else (set(), {})
        for node in self._nodes:
            if node.is_variable:
                t = leaves.get(node.name)
                if t is None:
                    arr = self.arg_dict.get(node.name)
                    if arr is None:
                        arr = self.aux_dict.get(node.name)
                    if arr is None:
                        raise MXNetError("unbound variable %r" % node.name)
                    t = arr._t
                vals[(id(node), 0)] = t
                continue
            aux_node = node
            if id(node) in act_fuse:
                aux_node = act_fuse[id(node)]
                outs, aux_up = _batch_norm(aux_node.attrs,
                                           *bn_stash.pop(id(aux_node)), True,
                                           act_type="relu")
            else:
                na = node.num_args()
                ins = [vals[(id(c), ci)] for c, ci in node.inputs[:na]]
                auxs = [vals[(id(c), ci)] for c, ci in node.inputs[na:]]
                if id(node) in bn_defer:
                    # computed inside the consuming relu Activation's slot
                    bn_stash[id(node)] = (ins, auxs)
                    continue
                outs, aux_up = node.op.apply_with_aux(node.attrs, ins, auxs,
                                                      is_train)
            for i, o in enumerate(outs):
                vals[(id(node), i)] = o
            if aux_up is not None:
                na_aux = aux_node.num_args()
                for (child, _ci), new in zip(aux_node.inputs[na_aux:],
                                             aux_up):
                    new_aux[child.name] = new
        return [vals[(id(n), i)] for n, i in self._symbol._outputs], new_aux

    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("forward: unknown input %r" % k)
            self.arg_dict[k][:] = v
        self._pending = None
        if not is_train:
            with torch.inference_mode():
                outs, _ = self._walk(False, {})
        else:
            diff = self._diff_names()
            leaves = {n: self.arg_dict[n]._t.detach().requires_grad_(True)
                      for n in diff}
            with torch.set_grad_enabled(bool(diff)):
                outs, new_aux = self._walk(True, leaves)
            if diff:
                self._pending = (outs, leaves)
            with torch.no_grad():
                for name, new in new_aux.items():
                    self.aux_dict[name]._t.copy_(new)
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None):
        diff = self._diff_names()
        if not diff:
            return
        if self._pending is None:
            raise MXNetError("backward called before forward(is_train=True) "
                             "(one backward per training forward)")
        outs, leaves = self._pending
        self._pending = None
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            heads = [(g._t if isinstance(g, NDArray) else torch.as_tensor(g))
                     .to(device=o.device, dtype=o.dtype)
                     for g, o in zip(out_grads, outs)]
        pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        grads = [None] * len(diff)
        if pairs:
            grads = torch.autograd.grad([o for o, _ in pairs],
                                        [leaves[n] for n in diff],
                                        [h for _, h in pairs],
                                        allow_unused=True)
        with torch.no_grad():
            for name, g in zip(diff, grads):
                dst = self.grad_dict.get(name)
                if dst is None:
                    continue
                if g is None:
                    # an argument no output depends on
                    if self.grad_req[name] != "add":
                        dst._t.zero_()
                elif self.grad_req[name] == "add":
                    dst._t.add_(g)
                else:
                    dst._t.copy_(g)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for src, dst, kind in ((arg_params, self.arg_dict, "arg"),
                               (aux_params or {}, self.aux_dict, "aux")):
            for k, v in src.items():
                if k in dst:
                    dst[k][:] = v
                elif not allow_extra_params:
                    raise MXNetError("unknown %s %r" % (kind, k))
