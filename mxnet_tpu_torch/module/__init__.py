"""Module API (``mx.mod``), counterpart of ``mxnet_tpu/module/``: the
training harness ``Module(sym).fit(...)``."""

from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
