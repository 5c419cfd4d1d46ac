"""Weight initializers (``mx.init``), counterpart of
``mxnet_tpu/initializer.py``.

Dispatch by the ending of a name, as the JAX package's: ``*_weight`` ->
the initializer's rule; ``*upsampling`` -> bilinear weights; ``*_bias``,
``*_beta``, the moving means and RNN states -> 0; ``*_gamma`` and the
moving variances -> 1; a node attribute ``__init__`` (JSON ``[name,
kwargs]``) overrides the rule.  :class:`Load` and :class:`Mixed` pick an
initializer by name instead.  Random draws come from an explicit
:class:`torch.Generator`: the one passed as ``generator=``, else this
module's default, reseeded by :func:`seed`.  Draws are made on the CPU and copied to the array's device,
so a seed gives the same weights on every device (never the JAX
package's: its draws come from numpy's global generator).
"""

from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from .base import Registry

__all__ = ["InitDesc", "Initializer", "Uniform", "Normal", "Zero", "One",
           "Constant", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "FusedRNN", "Load", "Mixed", "create", "seed",
           "registry"]

registry = Registry("initializer")

_default_gen = torch.Generator().manual_seed(0)


def seed(value):
    """Reseed the default generator of the random initializers."""
    _default_gen.manual_seed(int(value))


class InitDesc(str):
    """A parameter name with its attributes."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    def __init__(self, generator=None, **kwargs):
        self._kwargs = kwargs
        self._gen = generator

    @property
    def generator(self):
        return self._gen if self._gen is not None else _default_gen

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be str/InitDesc")
        attrs = getattr(desc, "attrs", {})
        if "__init__" in attrs:
            klass, kwargs = json.loads(attrs["__init__"])
            registry.create(klass, generator=self._gen,
                            **kwargs)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("upsampling"):
            self._init_bilinear(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith(("state", "state_cell", "moving_mean",
                            "running_mean", "moving_inv_var",
                            "moving_avg")):
            self._init_zero(desc, arr)
        elif name.endswith(("moving_var", "running_var")):
            self._init_one(desc, arr)
        else:
            self._init_default(desc, arr)

    # -- the slots, by the ending of a parameter's name ----------------------
    def _init_bilinear(self, _, arr):
        """An upsampling kernel: bilinear interpolation weights over the
        last two axes, the same for every (out, in) pair."""
        shape = arr.shape
        n = math.prod(shape)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(n)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        arr[:] = weight.astype(np.float32).reshape(shape)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    _init_bias = _init_zero
    _init_beta = _init_zero
    _init_gamma = _init_one

    def _init_weight(self, name, arr):
        raise NotImplementedError()

    def _init_default(self, name, arr):
        raise ValueError("Unknown initialization pattern for %s" % name)


@registry.register
class Uniform(Initializer):
    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator, scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = torch.empty(arr.shape).uniform_(
            -self.scale, self.scale, generator=self.generator)


@registry.register
class Normal(Initializer):
    def __init__(self, sigma=0.01, generator=None):
        super().__init__(generator, sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = torch.empty(arr.shape).normal_(0.0, self.sigma,
                                                generator=self.generator)


@registry.register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


@registry.register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


registry.alias(Zero, "zeros")
registry.alias(One, "ones")


@registry.register
class Constant(Initializer):
    def __init__(self, value=0.0, generator=None):
        super().__init__(generator, value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


@registry.register
class Orthogonal(Initializer):
    """An orthogonal matrix times ``scale`` (Saxe et al.), from the SVD of
    a (out, prod(rest)) draw, uniform in [-1, 1] or (``rand_type=
    "normal"``) standard normal."""

    def __init__(self, scale=1.414, rand_type="uniform", generator=None):
        super().__init__(generator, scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        tmp = torch.empty((nout, nin), dtype=torch.float64)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=self.generator)
        else:
            tmp.normal_(0.0, 1.0, generator=self.generator)
        u, _s, q = torch.linalg.svd(tmp, full_matrices=False)
        res = u if tuple(u.shape) == (nout, nin) else q
        arr[:] = (self.scale * res).reshape(arr.shape).float()


@registry.register
class Xavier(Initializer):
    """Scale ``sqrt(magnitude / factor)``, factor the fan in, out or their
    mean, drawn uniform in ``[-scale, scale]`` or normal with std
    ``scale``."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 generator=None):
        super().__init__(generator, rnd_type=rnd_type,
                         factor_type=factor_type, magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, _, arr):
        shape = arr.shape
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale if len(shape) > 1 else shape[0]
        fan_out = shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        else:
            factor = fan_out
        scale = math.sqrt(self.magnitude / factor)
        t = torch.empty(shape)
        if self.rnd_type == "uniform":
            t.uniform_(-scale, scale, generator=self.generator)
        else:
            t.normal_(0.0, scale, generator=self.generator)
        arr[:] = t


@registry.register
class MSRAPrelu(Xavier):
    """He initialization for a PReLU of ``slope``: Gaussian Xavier of
    magnitude ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25, generator=None):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2),
                         generator)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@registry.register
class Bilinear(Initializer):
    """Bilinear upsampling weights (:meth:`Initializer._init_bilinear`)."""

    def _init_weight(self, name, arr):
        self._init_bilinear(name, arr)


@registry.register
class LSTMBias(Initializer):
    """Zero, but ``forget_bias`` on the second quarter (the forget gate of
    the i, f, c, o layout): for a bias and for a weight slot alike."""

    def __init__(self, forget_bias=1.0, generator=None):
        super().__init__(generator, forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        num_hidden = arr.shape[0] // 4
        v = np.zeros(arr.shape, dtype=np.float32)
        v[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = v

    _init_bias = _init_weight


@registry.register
class FusedRNN(Initializer):
    """Initialize a fused RNN parameter blob: unpack it with the cell's own
    layout, give each weight matrix ``init`` (else the surrounding global
    initializer, else ``Uniform(0.07)``), each bias zero and each LSTM
    forget-gate bias ``forget_bias``, and pack it back."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0, generator=None):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = registry.create(klass, generator=generator, **kwargs)
        super().__init__(generator,
                         init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from .rnn.rnn_cell import FusedRNNCell

        global_init = getattr(desc, "global_init", None)
        inner = self._init
        if inner is None:
            # the surrounding global initializer; if that is itself a
            # FusedRNN, its inner one (a piece must not be unpacked again)
            fallback = global_init
            while isinstance(fallback, FusedRNN):
                fallback = fallback._init
            inner = fallback or Uniform(0.07)
        cell = FusedRNNCell(self._num_hidden, num_layers=self._num_layers,
                            mode=self._mode,
                            bidirectional=self._bidirectional,
                            forget_bias=self._forget_bias, prefix="")
        args = cell.unpack_weights({"parameters": arr})
        h = self._num_hidden
        for name, value in args.items():
            # a fresh desc per piece: dispatch by the piece's name, no
            # __init__ attr, so no recursion
            piece = InitDesc(name, global_init=global_init)
            if name.endswith("weight"):
                if hasattr(inner, "_init_weight"):
                    inner._init_weight(piece, value)
                else:
                    inner(piece, value)
            else:
                value[:] = 0.0
                if self._mode == "lstm":
                    value[h:2 * h] = self._forget_bias
        arr[:] = cell.pack_weights(args)["parameters"]


@registry.register
class Load:
    """Parameters from a saved dict (or a params file of either package):
    each name found there is copied (``arg:``/``aux:`` prefixes dropped,
    shapes must agree), any other goes to ``default_init``, else
    raises."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .ndarray import load

            param = load(param)
        self.param = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(arr.shape):
                raise ValueError("Load: shape mismatch for %s" % name)
            arr[:] = src
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise ValueError("Load: no init for %s" % name)


@registry.register
class Mixed:
    """The initializer of the first of ``patterns`` (regular expressions,
    matched at the start of the name) that matches a parameter."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("Mixed: %d patterns for %d initializers"
                             % (len(patterns), len(initializers)))
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise ValueError("Mixed: no pattern matches %s" % name)


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    return registry.create(name, **kwargs)
