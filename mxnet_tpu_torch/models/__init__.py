"""Model definitions built through ``mxnet_tpu_torch.symbol``."""

from . import lstm_lm, resnet
from .long_context_lm import build_lm

__all__ = ["build_lm", "get_symbol", "lstm_lm", "resnet"]

_BUILDERS = {"resnet": resnet.get_symbol}


def get_symbol(network, num_classes=1000, **kwargs):
    """Like ``example/image-classification/train_*.py --network``; the
    JAX package's other networks are not ported yet."""
    if network not in _BUILDERS:
        raise ValueError("network %r is not ported yet (have %s)"
                         % (network, sorted(_BUILDERS)))
    return _BUILDERS[network](num_classes=num_classes, **kwargs)
