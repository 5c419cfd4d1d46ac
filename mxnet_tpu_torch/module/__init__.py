"""Module API (``mx.mod``), counterpart of ``mxnet_tpu/module/``: the
training harness ``Module(sym).fit(...)`` and ``BucketingModule``."""

from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module

__all__ = ["BaseModule", "BucketingModule", "Module"]
