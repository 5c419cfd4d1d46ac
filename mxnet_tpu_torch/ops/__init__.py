"""Operator registry and the ported ops.  Importing this
package registers every op; ``mx.sym`` is generated from the registry."""

from . import registry
from .registry import OpDef, get, list_ops, register

# registration side effects
from . import elemwise  # noqa: F401
from . import broadcast_reduce  # noqa: F401
from . import matrix  # noqa: F401
from . import indexing  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import attention  # noqa: F401
from . import rnn  # noqa: F401
from . import contrib  # noqa: F401
from . import spatial  # noqa: F401
from . import infer  # noqa: F401  (attaches backward shape rules)

__all__ = ["registry", "OpDef", "get", "list_ops", "register"]
