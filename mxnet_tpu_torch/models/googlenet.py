"""GoogLeNet / Inception-v1 (counterpart of ``mxnet_tpu/models/googlenet.py``; reference ``example/image-classification/
symbols/googlenet.py`` — "Going Deeper with Convolutions", Szegedy et al.)."""

from .. import symbol as sym


def ConvFactory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                name=None, suffix=""):
    conv = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad,
                           name="conv_%s%s" % (name, suffix))
    act = sym.Activation(conv, act_type="relu",
                         name="relu_%s%s" % (name, suffix))
    return act


def InceptionFactory(data, num_1x1, num_3x3red, num_3x3, num_d5x5red,
                     num_d5x5, pool, proj, name):
    c1x1 = ConvFactory(data, num_1x1, (1, 1), name="%s_1x1" % name)
    c3x3r = ConvFactory(data, num_3x3red, (1, 1), name="%s_3x3" % name,
                        suffix="_reduce")
    c3x3 = ConvFactory(c3x3r, num_3x3, (3, 3), pad=(1, 1),
                       name="%s_3x3" % name)
    cd5x5r = ConvFactory(data, num_d5x5red, (1, 1), name="%s_5x5" % name,
                         suffix="_reduce")
    cd5x5 = ConvFactory(cd5x5r, num_d5x5, (5, 5), pad=(2, 2),
                        name="%s_5x5" % name)
    pooling = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                          pool_type=pool,
                          name="%s_pool_%s_pool" % (pool, name))
    cproj = ConvFactory(pooling, proj, (1, 1), name="%s_proj" % name)
    return sym.Concat(c1x1, c3x3, cd5x5, cproj,
                      name="ch_concat_%s_chconcat" % name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    conv1 = ConvFactory(data, 64, kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                        name="conv1")
    pool1 = sym.Pooling(conv1, kernel=(3, 3), stride=(2, 2), pool_type="max",
                        name="pool1")
    conv2 = ConvFactory(pool1, 64, kernel=(1, 1), name="conv2")
    conv3 = ConvFactory(conv2, 192, kernel=(3, 3), pad=(1, 1), name="conv3")
    pool3 = sym.Pooling(conv3, kernel=(3, 3), stride=(2, 2), pool_type="max",
                        name="pool3")

    in3a = InceptionFactory(pool3, 64, 96, 128, 16, 32, "max", 32, "in3a")
    in3b = InceptionFactory(in3a, 128, 128, 192, 32, 96, "max", 64, "in3b")
    pool4 = sym.Pooling(in3b, kernel=(3, 3), stride=(2, 2), pool_type="max",
                        name="pool4")
    in4a = InceptionFactory(pool4, 192, 96, 208, 16, 48, "max", 64, "in4a")
    in4b = InceptionFactory(in4a, 160, 112, 224, 24, 64, "max", 64, "in4b")
    in4c = InceptionFactory(in4b, 128, 128, 256, 24, 64, "max", 64, "in4c")
    in4d = InceptionFactory(in4c, 112, 144, 288, 32, 64, "max", 64, "in4d")
    in4e = InceptionFactory(in4d, 256, 160, 320, 32, 128, "max", 128, "in4e")
    pool5 = sym.Pooling(in4e, kernel=(3, 3), stride=(2, 2), pool_type="max",
                        name="pool5")
    in5a = InceptionFactory(pool5, 256, 160, 320, 32, 128, "max", 128, "in5a")
    in5b = InceptionFactory(in5a, 384, 192, 384, 48, 128, "max", 128, "in5b")
    pool6 = sym.Pooling(in5b, kernel=(7, 7), stride=(1, 1), pool_type="avg",
                        name="global_pool")
    flatten = sym.Flatten(pool6, name="flatten0")
    fc1 = sym.FullyConnected(flatten, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")
