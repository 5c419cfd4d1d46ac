"""Model definitions built through ``mxnet_tpu_torch.symbol``."""

from . import (alexnet, googlenet, inception_bn, inception_resnet_v2,
               inception_v3, lenet, lstm_lm, mlp, rcnn, resnet, ssd_detect,
               ssd_vgg16, transformer_lm, vgg)
from .long_context_lm import build_lm, copy_task

__all__ = ["alexnet", "build_lm", "copy_task", "get_symbol", "googlenet",
           "inception_bn", "inception_resnet_v2", "inception_v3", "lenet",
           "lstm_lm", "mlp", "rcnn", "resnet", "ssd_detect", "ssd_vgg16",
           "transformer_lm", "vgg"]

_BUILDERS = {
    "lenet": lenet.get_symbol,
    "mlp": mlp.get_symbol,
    "alexnet": alexnet.get_symbol,
    "vgg": vgg.get_symbol,
    "resnet": resnet.get_symbol,
    "inception-bn": inception_bn.get_symbol,
    "inception-v3": inception_v3.get_symbol,
    "googlenet": googlenet.get_symbol,
    "inception-resnet-v2": inception_resnet_v2.get_symbol,
}


def get_symbol(network, num_classes=1000, **kwargs):
    """Like ``example/image-classification/train_*.py --network``; the
    JAX package's other networks are not ported yet."""
    if network not in _BUILDERS:
        raise ValueError("network %r is not ported yet (have %s)"
                         % (network, sorted(_BUILDERS)))
    return _BUILDERS[network](num_classes=num_classes, **kwargs)
