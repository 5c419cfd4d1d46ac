"""Weight initializers (``mx.init``), counterpart of
``mxnet_tpu/initializer.py``.

Dispatch by name: ``*_weight`` -> the initializer's rule; ``*_bias``,
``*_beta`` and ``*moving_mean`` -> 0; ``*_gamma`` and ``*moving_var`` ->
1; a node attribute ``__init__`` (JSON ``[name, kwargs]``) overrides the
rule.  Random draws come from an explicit :class:`torch.Generator`: the
one passed as ``generator=``, else this module's default, reseeded by
:func:`seed`.  Draws are made on the CPU and copied to the array's device,
so a seed gives the same weights on every device (never the JAX
package's: its draws come from numpy's global generator).
"""

from __future__ import annotations

import json
import math

import torch

from .base import Registry

__all__ = ["InitDesc", "Initializer", "Uniform", "Normal", "Zero", "One",
           "Constant", "Xavier", "FusedRNN", "create", "seed", "registry"]

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
        if name.endswith("bias") or name.endswith("beta") \
                or name.endswith("moving_mean"):
            arr[:] = 0.0
        elif name.endswith("gamma") or name.endswith("moving_var"):
            arr[:] = 1.0
        elif name.endswith("weight"):
            self._init_weight(desc, arr)
        else:
            raise ValueError("Unknown initialization pattern for %s" % name)

    def _init_weight(self, name, arr):
        raise NotImplementedError()


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


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    return registry.create(name, **kwargs)
