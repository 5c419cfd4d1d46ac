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
* ``train_sgd(...)`` is the fused step of ``MXNET_FUSE_TRAIN_STEP=1``:
  forward, backward and the SGD update in one.  On a card its first call
  runs the step eagerly on a side stream (the warm-up, which also makes
  every kernel's one-time set-up) and captures it into a
  ``torch.cuda.CUDAGraph``, cached under ``("train_sgd", names, momentum,
  rescale, clip, lr/wd groups)``; every later call with that key replays
  the graph (``graph_replays`` counts them).  The graph reads and writes
  the bound arrays in place; a call whose arrays are no longer the
  tensors it was captured on, or with another key, captures anew and
  frees the old graph (its memory pool is held while it lives).  A
  capture or replay that fails raises.  On the CPU the same step runs
  eagerly.  A graph holding an op that draws (``Dropout``, the ``RNN``
  op) registers ``mx.random``'s generator of the device with the
  capture: each replay advances its offset, so no replay repeats a
  captured mask, and ``mx.random.get_state`` after it is that of as many
  eager steps.
* An op with no inputs (``_zeros``) makes its output on the bound device
  (``registry.device_scope``).
"""

from __future__ import annotations

import time

import torch

from . import random as _random
from .base import MXNetError
from .context import as_context, gpu
from .ndarray import NDArray, zeros
from .ops import launches
from .ops.registry import device_scope
from .ops.nn import _batch_norm
from .optimizer import hyper_tensor, lr_wd_groups, sgd_step_math

__all__ = ["Executor"]

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


class _StepGraph:
    """One captured fused step: the graph, the tensors it was captured on,
    its static outputs, its lr/wd tensor and the kernel launches it
    replays."""

    def __init__(self, graph, bound, outputs, hyper, hyper_values,
                 recorded):
        self.graph = graph
        self.bound = bound
        self.outputs = outputs
        self.hyper = hyper
        self.hyper_values = hyper_values
        self.launches = recorded

    def current(self, tensors):
        return len(tensors) == len(self.bound) and all(
            a is b for a, b in zip(tensors, self.bound))


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
        self._device = ctx.torch_device()
        #: the graph holds an op that draws from ``mx.random.generator``
        self._draws = any(not n.is_variable and n.op.draws
                          for n in self._nodes)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.arg_dict = arg_dict
        self.grad_dict = grad_dict
        self.aux_dict = aux_dict
        self.grad_req = _grad_req_map(grad_req, self.arg_names)
        self.outputs = []
        self._pending = None  # (output tensors, {name: leaf}) for backward
        self._graphs = {}
        #: replays of captured fused steps
        self.graph_replays = 0
        #: host seconds of the last capture (the warm-up step apart)
        self.capture_seconds = None

    # run_bulk(return_outputs=False) keeps neither outputs nor gradients:
    # reading them raises until the next step
    @property
    def outputs(self):
        if self._dropped:
            raise MXNetError("the outputs of run_bulk(return_outputs=False) "
                             "are not kept; pass return_outputs=True or "
                             "'device'")
        return self._outputs

    @outputs.setter
    def outputs(self, value):
        self._outputs = value
        self._dropped = False

    @property
    def grad_dict(self):
        if self._dropped:
            raise MXNetError("the gradients of run_bulk(return_outputs="
                             "False) are not kept")
        return self._grad_dict

    @grad_dict.setter
    def grad_dict(self, value):
        self._grad_dict = value

    def drop_results(self):
        """Mark outputs and gradients as not kept (``run_bulk``)."""
        self._dropped = True

    arg_arrays = property(lambda s: [s.arg_dict[n] for n in s.arg_names])
    grad_arrays = property(lambda s: [s.grad_dict.get(n)
                                      for n in s.arg_names])
    aux_arrays = property(lambda s: [s.aux_dict[n] for n in s.aux_names])

    def _diff_names(self):
        return [n for n in self.arg_names if self.grad_req[n] != "null"]

    # -- the fused step -----------------------------------------------------
    def _sgd_body(self, names, moms, groups, hyper, momentum, rescale, clip):
        """Forward, backward and the SGD update; returns the output
        tensors.  Nothing in it reads a value back to the host."""
        self.forward(is_train=True)
        outs = [o._t for o in self._outputs]
        self.backward()
        with torch.no_grad():
            sgd_step_math([self.arg_dict[n]._t for n in names],
                          [self._grad_dict[n]._t for n in names],
                          [m._t for m in moms], groups, hyper, momentum,
                          rescale, clip)
        return outs

    def _bound_tensors(self, names, moms):
        """Every tensor a captured step reads or writes in place."""
        return ([self.arg_dict[n]._t for n in self.arg_names]
                + [self._grad_dict[n]._t for n in names]
                + [self.aux_dict[n]._t for n in self.aux_names]
                + [m._t for m in moms])

    def train_sgd(self, names, moms, lrs, wds, momentum, rescale, clip):
        """One fused step: forward, backward (every gradient ``write``)
        and SGD(-momentum) on the parameters ``names`` with momenta
        ``moms`` (NDArrays, empty without momentum) and per-parameter
        ``lrs``/``wds`` (floats).  The inputs are the bound arrays.  On a
        card the step is a CUDA-graph replay after its first call (see
        the module docstring)."""
        groups, values = lr_wd_groups(lrs, wds)
        dev = self.arg_dict[names[0]]._t.device
        if dev.type != "cuda":
            self._sgd_body(names, moms, groups, hyper_tensor(values, dev),
                           momentum, rescale, clip)
            return
        key = ("train_sgd", tuple(names), momentum, rescale, clip, groups)
        bound = self._bound_tensors(names, moms)
        step = self._graphs.get(key)
        if step is not None and not step.current(bound):
            step = None  # an array was replaced: never replay
        stream = torch.cuda.current_stream(dev)
        if step is None:
            # one graph at a time: each holds its memory pool for good
            self._graphs.clear()
            self._graphs[key] = self._capture(
                names, moms, groups, values, momentum, rescale, clip, bound,
                stream)
            return
        if step.hyper_values != values:
            # one small copy from pinned memory, before the replay on the
            # same stream; the pinned block is not reused before it ran
            step.hyper.copy_(torch.tensor(values, dtype=torch.float32)
                             .pin_memory(), non_blocking=True)
            step.hyper_values = values
        try:
            with torch.cuda.stream(stream):
                step.graph.replay()
        except Exception as e:  # noqa: BLE001 - no eager fallback
            raise MXNetError("replay of the captured train step failed: %s"
                             % e) from e
        self.graph_replays += 1
        launches.replayed(step.launches)
        # outputs the caller may keep: the graph's own are overwritten by
        # the next replay
        self.outputs = [NDArray(o.clone()) for o in step.outputs]

    def _capture(self, names, moms, groups, values, momentum, rescale, clip,
                 bound, stream):
        """The warm-up step (this call's step, run eagerly on a side
        stream), then the capture of the step on that stream."""
        dev = stream.device
        side = torch.cuda.Stream(dev)
        hyper = hyper_tensor(values, dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            outs = self._sgd_body(names, moms, groups, hyper, momentum,
                                  rescale, clip)
        for o in outs:
            o.record_stream(stream)
        graph = torch.cuda.CUDAGraph()
        if self._draws:
            # a fresh offset each replay: never the captured mask again
            graph.register_generator_state(_random.generator(dev))
        t = time.perf_counter()
        # thread_local: a DevicePrefetchIter's producer thread may pin and
        # copy the next batch on its own stream meanwhile, which a
        # "global" capture would take as an error of its own
        try:
            with launches.recording() as recorded, torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                static = self._sgd_body(names, moms, groups, hyper,
                                        momentum, rescale, clip)
        except Exception as e:  # noqa: BLE001 - no eager fallback
            self._pending = None
            raise MXNetError("capture of the fused train step failed: %s"
                             % e) from e
        self.capture_seconds = time.perf_counter() - t
        stream.wait_stream(side)
        self.outputs = [NDArray(o) for o in outs]
        return _StepGraph(graph, bound, static, hyper, values, recorded)

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
                    if n in shared_exec._grad_dict and n in grad_dict:
                        grad_dict[n] = shared_exec._grad_dict[n]
            for n in aux_names:
                src = shared_exec.aux_dict.get(n)
                if src is not None and src.shape == aux_dict[n].shape:
                    aux_dict[n] = src
        return Executor(symbol, ctx, arg_dict, grad_dict, req, aux_dict)

    def _walk(self, is_train, leaves):
        """Apply every op in topological order; returns (outputs, {aux
        name: new value})."""
        with device_scope(self._device):
            return self._walk_ops(is_train, leaves)

    def _walk_ops(self, is_train, leaves):
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
        return self._outputs

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
                dst = self._grad_dict.get(name)
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
