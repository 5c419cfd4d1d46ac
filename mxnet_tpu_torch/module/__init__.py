"""Module API (``mx.mod``), counterpart of ``mxnet_tpu/module/``: the
training harness ``Module(sym).fit(...)``, ``BucketingModule``,
``SequentialModule`` and the Python modules ``PythonModule`` and
``PythonLossModule``."""

from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "BucketingModule", "Module", "SequentialModule",
           "PythonModule", "PythonLossModule"]
