"""The classic image classifiers of the port's model zoo against the JAX
package: ``alexnet`` (with ``LRN``), ``vgg`` (16 layers, with and
without ``batch_norm``), ``googlenet``, ``inception-bn`` and
``inception-resnet-v2`` (its repeats trimmed to 1/1/1, full widths, at
75x75, the smallest image its stem and reductions take), each
registered under the JAX name, with the JAX package's node names and
parameter shapes, and each fitted for two SGD steps from the JAX
package's Xavier weights.

``Dropout`` (AlexNet's and VGG's classifiers) draws another mask in each
package, so both packages' op is replaced here by one that applies the
same numpy mask (a function of the shape alone).  The smallest input each
network takes: GoogLeNet's fixed 7x7 average pool needs 256x256 (at
224x224 its last map is 6x6, in both packages).

Tolerance: each parameter and moving statistic within 3x the ulp floor,
the distance that one ulp of the initial weights moves a fit (the
largest over both packages, every weight one ulp up or down).  These
full-width nets at b2 are chaotic at the first steps: f32 sums taken in
another order move a pre-activation across zero (a ReLU) or a max-pool
winner, and the gradients below it by 1-2% (VGG-16's conv1_1 gradient
2.0%, GoogLeNet's 0.45%, Inception-BN's 2.0%, one step from the same
weights), as far as one ulp of the weights moves either package's own
fit; AlexNet's fit stays within ``rtol=1e-4, atol=1e-5``.
"""

import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

CASES = [
    ("alexnet", 67, {}),
    ("vgg", 32, {}),
    ("vgg", 32, {"batch_norm": True}),
    ("googlenet", 256, {}),
    ("inception-bn", 96, {}),
    ("inception-resnet-v2", 75, {"num_35": 1, "num_17": 1, "num_8": 1}),
]
IDS = ["alexnet", "vgg16", "vgg16-bn", "googlenet", "inception-bn",
       "inception-resnet-v2"]
BATCH, STEPS, CLASSES = 2, 2, 10


def _mask(shape, p):
    rs = np.random.RandomState(sum(shape) * 7 + len(shape))
    return (rs.rand(*shape) >= p).astype(np.float32) / np.float32(1 - p)


@pytest.fixture
def shared_dropout(monkeypatch):
    """Both packages' ``Dropout`` multiplies by the same numpy mask."""
    import jax.numpy as jnp

    def jax_dropout(attrs, inputs, aux, is_train, rng):
        x = inputs[0]
        if not is_train or attrs["p"] <= 0:
            return [x]
        return [x * jnp.asarray(_mask(tuple(x.shape), attrs["p"]))]

    def torch_dropout(attrs, inputs, aux, is_train):
        x = inputs[0]
        if not is_train or attrs["p"] <= 0:
            return [x]
        return [x * torch.from_numpy(_mask(tuple(x.shape), attrs["p"]))]

    monkeypatch.setattr(jreg.get("Dropout"), "_apply", jax_dropout)
    monkeypatch.setattr(treg.get("Dropout"), "_apply", torch_dropout)


def _net(mx, network, kw):
    with mx.name.NameManager():
        return mx.models.get_symbol(network, num_classes=CLASSES, **kw)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_graph_matches_jax(case):
    network, size, kw = case
    want, got = _net(jmx, network, kw), _net(tmx, network, kw)
    nodes = [[(n["op"], n["name"]) for n in json.loads(s.tojson())["nodes"]]
             for s in (got, want)]
    assert nodes[0] == nodes[1]
    shapes = dict(data=(BATCH, 3, size, size))
    for g, w in zip(got.infer_shape(**shapes), want.infer_shape(**shapes)):
        assert [tuple(s) for s in g] == [tuple(s) for s in w]


def _fit(mx, network, kw, init, data, label):
    it = mx.io.NDArrayIter(data, label, batch_size=BATCH)
    mod = mx.mod.Module(_net(mx, network, kw), context=mx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    arg, aux = init
    if mx is tmx:
        tmx.convert.set_module_params(mod, arg, aux)
    else:
        mod.set_params({k: jmx.nd.array(v) for k, v in arg.items()},
                       {k: jmx.nd.array(v) for k, v in aux.items()})
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.01, "momentum": 0.9,
                              "wd": 1e-4})
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fit_matches_jax(case, shared_dropout, monkeypatch):
    """Two steps of SGD (lr 0.01, momentum 0.9, wd 1e-4) at b2 from the
    JAX package's Xavier weights: every parameter and auxiliary state
    within 3x its ulp floor; every parameter moved but the fixed gammas
    of BatchNorm (``fix_gamma``)."""
    monkeypatch.setenv("MXNET_DEVICE_METRIC", "0")
    network, size, kw = case
    rs = np.random.RandomState(4)
    data = rs.rand(BATCH * STEPS, 3, size, size).astype(np.float32)
    label = rs.randint(0, CLASSES, BATCH * STEPS).astype(np.float32)
    mod = jmx.mod.Module(_net(jmx, network, kw), context=jmx.cpu())
    mod.bind(data_shapes=[("data", data[:BATCH].shape)],
             label_shapes=[("softmax_label", (BATCH,))])
    jmx.random.seed(2)
    mod.init_params(jmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    arg, aux = mod.get_params()
    init = ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})
    fits = {mx: _fit(mx, network, kw, init, data, label)
            for mx in (jmx, tmx)}
    floor = {}
    for direction in (np.inf, -np.inf):
        moved = ({k: np.nextafter(v, np.float32(direction))
                  for k, v in init[0].items()}, init[1])
        for mx in (jmx, tmx):
            fit = _fit(mx, network, kw, moved, data, label)
            for part, ref in zip(fit, fits[mx]):
                for k, v in part.items():
                    floor[k] = max(floor.get(k, 0.0),
                                   float(np.abs(v - ref[k]).max()))
    for w, g in zip(fits[jmx], fits[tmx]):
        assert sorted(g) == sorted(w)
        for k in w:
            gap = float(np.abs(g[k] - w[k]).max())
            assert gap <= 3 * floor[k], (k, gap, floor[k])
    still = [k for k in fits[jmx][0]
             if np.array_equal(fits[jmx][0][k], init[0][k])]
    assert all(k.endswith("_gamma") for k in still), still
