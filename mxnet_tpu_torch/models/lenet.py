"""LeNet (counterpart of ``mxnet_tpu/models/lenet.py``; reference
``example/image-classification/symbols/lenet.py``), and
:func:`synth_mnist`, the synthetic MNIST that ``train_mnist.py`` trains on
here."""

import os
import struct

import numpy as np

from .. import symbol as sym


def get_symbol(num_classes=10, **kwargs):
    data = sym.Variable("data")
    # first conv
    conv1 = sym.Convolution(data, kernel=(5, 5), num_filter=20)
    tanh1 = sym.Activation(conv1, act_type="tanh")
    pool1 = sym.Pooling(tanh1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    # second conv
    conv2 = sym.Convolution(pool1, kernel=(5, 5), num_filter=50)
    tanh2 = sym.Activation(conv2, act_type="tanh")
    pool2 = sym.Pooling(tanh2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    # first fullc
    flatten = sym.Flatten(pool2)
    fc1 = sym.FullyConnected(flatten, num_hidden=500)
    tanh3 = sym.Activation(fc1, act_type="tanh")
    # second fullc
    fc2 = sym.FullyConnected(tanh3, num_hidden=num_classes)
    return sym.SoftmaxOutput(fc2, name="softmax")


def _write_idx(path, magic, array):
    with open(path, "wb") as f:
        f.write(struct.pack(">" + "I" * (1 + array.ndim), magic,
                            *array.shape))
        f.write(array.astype(np.uint8).tobytes())


def synth_mnist(data_dir, num_train=2048, num_val=512, num_classes=10,
                side=28, seed=7):
    """Class patterns plus noise written as MNIST idx files under
    ``data_dir`` (``train-``/``t10k-images-idx3-ubyte``, ``...-labels-
    idx1-ubyte``), byte for byte what
    ``example/image-classification/common/data.py``'s ``synth_mnist``
    writes (that module imports the JAX package); learnable by LeNet and
    the MLP in an epoch or two.  Returns the four paths by
    ``train_img``/``train_lab``/``val_img``/``val_lab``."""
    os.makedirs(data_dir, exist_ok=True)
    paths = {
        "train_img": os.path.join(data_dir, "train-images-idx3-ubyte"),
        "train_lab": os.path.join(data_dir, "train-labels-idx1-ubyte"),
        "val_img": os.path.join(data_dir, "t10k-images-idx3-ubyte"),
        "val_lab": os.path.join(data_dir, "t10k-labels-idx1-ubyte"),
    }
    if all(os.path.exists(p) for p in paths.values()):
        return paths
    rs = np.random.RandomState(seed)
    protos = (rs.rand(num_classes, side, side) > 0.5) * 200.0
    for split, n in (("train", num_train), ("val", num_val)):
        lab = rs.randint(0, num_classes, n)
        img = protos[lab] * (0.6 + 0.4 * rs.rand(n, 1, 1)) \
            + rs.rand(n, side, side) * 55.0
        _write_idx(paths[split + "_img"], 0x00000803, np.clip(img, 0, 255))
        _write_idx(paths[split + "_lab"], 0x00000801, lab)
    return paths
