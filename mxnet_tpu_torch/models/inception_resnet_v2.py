"""Inception-ResNet-v2 (counterpart of
``mxnet_tpu/models/inception_resnet_v2.py``; reference
``example/image-classification/symbols/inception-resnet-v2.py``, Szegedy
et al., "Inception-v4, Inception-ResNet and the Impact of Residual
Connections on Learning"), built through this package's ``mx.sym`` with
the JAX package's layer names.  Every convolution is followed by a
BatchNorm (``fix_gamma=False``), so on the card each runs through kernels
K1/K2, with the ReLU fused where one follows.
"""

from .. import symbol as sym


def ConvFactory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                act_type="relu", name=None):
    conv = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, name="conv_%s" % name)
    bn = sym.BatchNorm(conv, fix_gamma=False, name="bn_%s" % name)
    if act_type is None:
        return bn
    return sym.Activation(bn, act_type=act_type, name="relu_%s" % name)


def block35(net, scale=1.0, name=None):
    """Inception-ResNet-A (35x35 grid)."""
    tower_conv = ConvFactory(net, 32, (1, 1), name="%s_b0_1x1" % name)
    t1 = ConvFactory(net, 32, (1, 1), name="%s_b1_1x1" % name)
    t1 = ConvFactory(t1, 32, (3, 3), pad=(1, 1), name="%s_b1_3x3" % name)
    t2 = ConvFactory(net, 32, (1, 1), name="%s_b2_1x1" % name)
    t2 = ConvFactory(t2, 48, (3, 3), pad=(1, 1), name="%s_b2_3x3a" % name)
    t2 = ConvFactory(t2, 64, (3, 3), pad=(1, 1), name="%s_b2_3x3b" % name)
    mixed = sym.Concat(tower_conv, t1, t2, name="%s_concat" % name)
    up = ConvFactory(mixed, 320, (1, 1), act_type=None,
                     name="%s_up" % name)
    net = net + up * scale
    return sym.Activation(net, act_type="relu", name="%s_relu" % name)


def block17(net, scale=1.0, name=None):
    """Inception-ResNet-B (17x17 grid)."""
    t0 = ConvFactory(net, 192, (1, 1), name="%s_b0_1x1" % name)
    t1 = ConvFactory(net, 128, (1, 1), name="%s_b1_1x1" % name)
    t1 = ConvFactory(t1, 160, (1, 7), pad=(0, 3), name="%s_b1_1x7" % name)
    t1 = ConvFactory(t1, 192, (7, 1), pad=(3, 0), name="%s_b1_7x1" % name)
    mixed = sym.Concat(t0, t1, name="%s_concat" % name)
    up = ConvFactory(mixed, 1088, (1, 1), act_type=None, name="%s_up" % name)
    net = net + up * scale
    return sym.Activation(net, act_type="relu", name="%s_relu" % name)


def block8(net, scale=1.0, with_act=True, name=None):
    """Inception-ResNet-C (8x8 grid)."""
    t0 = ConvFactory(net, 192, (1, 1), name="%s_b0_1x1" % name)
    t1 = ConvFactory(net, 192, (1, 1), name="%s_b1_1x1" % name)
    t1 = ConvFactory(t1, 224, (1, 3), pad=(0, 1), name="%s_b1_1x3" % name)
    t1 = ConvFactory(t1, 256, (3, 1), pad=(1, 0), name="%s_b1_3x1" % name)
    mixed = sym.Concat(t0, t1, name="%s_concat" % name)
    up = ConvFactory(mixed, 2080, (1, 1), act_type=None, name="%s_up" % name)
    net = net + up * scale
    if with_act:
        net = sym.Activation(net, act_type="relu", name="%s_relu" % name)
    return net


def get_symbol(num_classes=1000, num_35=10, num_17=20, num_8=9, **kwargs):
    """The full net; the repeat counts ``num_35``, ``num_17`` and ``num_8``
    default to the paper's 10/20/9 (trim them for quick tests)."""
    data = sym.Variable("data")
    # stem
    net = ConvFactory(data, 32, (3, 3), stride=(2, 2), name="stem_1a")
    net = ConvFactory(net, 32, (3, 3), name="stem_2a")
    net = ConvFactory(net, 64, (3, 3), pad=(1, 1), name="stem_2b")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                      name="stem_pool1")
    net = ConvFactory(net, 80, (1, 1), name="stem_3b")
    net = ConvFactory(net, 192, (3, 3), name="stem_4a")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                      name="stem_pool2")
    # mixed 5b
    t0 = ConvFactory(net, 96, (1, 1), name="m5b_b0")
    t1 = ConvFactory(net, 48, (1, 1), name="m5b_b1a")
    t1 = ConvFactory(t1, 64, (5, 5), pad=(2, 2), name="m5b_b1b")
    t2 = ConvFactory(net, 64, (1, 1), name="m5b_b2a")
    t2 = ConvFactory(t2, 96, (3, 3), pad=(1, 1), name="m5b_b2b")
    t2 = ConvFactory(t2, 96, (3, 3), pad=(1, 1), name="m5b_b2c")
    t3 = sym.Pooling(net, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg", name="m5b_pool")
    t3 = ConvFactory(t3, 64, (1, 1), name="m5b_b3")
    net = sym.Concat(t0, t1, t2, t3, name="mixed_5b")
    for i in range(num_35):
        net = block35(net, scale=0.17, name="irA_%d" % i)
    # reduction A
    t0 = ConvFactory(net, 384, (3, 3), stride=(2, 2), name="redA_b0")
    t1 = ConvFactory(net, 256, (1, 1), name="redA_b1a")
    t1 = ConvFactory(t1, 256, (3, 3), pad=(1, 1), name="redA_b1b")
    t1 = ConvFactory(t1, 384, (3, 3), stride=(2, 2), name="redA_b1c")
    t2 = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name="redA_pool")
    net = sym.Concat(t0, t1, t2, name="reduction_a")
    for i in range(num_17):
        net = block17(net, scale=0.10, name="irB_%d" % i)
    # reduction B
    t0 = ConvFactory(net, 256, (1, 1), name="redB_b0a")
    t0 = ConvFactory(t0, 384, (3, 3), stride=(2, 2), name="redB_b0b")
    t1 = ConvFactory(net, 256, (1, 1), name="redB_b1a")
    t1 = ConvFactory(t1, 288, (3, 3), stride=(2, 2), name="redB_b1b")
    t2 = ConvFactory(net, 256, (1, 1), name="redB_b2a")
    t2 = ConvFactory(t2, 288, (3, 3), pad=(1, 1), name="redB_b2b")
    t2 = ConvFactory(t2, 320, (3, 3), stride=(2, 2), name="redB_b2c")
    t3 = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name="redB_pool")
    net = sym.Concat(t0, t1, t2, t3, name="reduction_b")
    for i in range(num_8):
        net = block8(net, scale=0.20, name="irC_%d" % i)
    net = block8(net, with_act=False, name="irC_final")
    net = ConvFactory(net, 1536, (1, 1), name="final_conv")
    net = sym.Pooling(net, kernel=(8, 8), global_pool=True, pool_type="avg",
                      name="global_pool")
    net = sym.Flatten(net, name="flatten")
    net = sym.Dropout(net, p=0.2, name="dropout")
    fc = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")
