"""The optimizers and initializers of ``common/fit.py`` in the PyTorch port
against the JAX package.

NAG, DCASGD, ccSGD, AdaGrad, RMSProp (plain and centered), AdaDelta and
Test take the same weights and gradients (numpy, seeded) in both
packages, through each package's ``Updater``, over five updates with a
scheduler, weight decay, ``rescale_grad`` and ``clip_gradient``: weights
and states agree at ``rtol=1e-6, atol=1e-7`` (the same f32 arithmetic in
the same order).  The JAX side runs op by op (``jax.disable_jit()``):
compiled together, XLA contracts a multiply and an add of the fused
RMSProp ops into one FMA, and the centered denominator ``n - g^2``
amplifies that rounding to 2e-6 of a weight.  SGLD's
noise comes from a seeded ``torch.Generator`` and never matches the JAX
package's threefry draws, so its step less its own noise is held to the
JAX step with the noise set to zero (``atol=1e-6``: adding and taking
away a noise of scale ``sqrt(lr)`` rounds at ~3e-8), and the noise's
spread to ``sqrt(lr)``.  The ``.states`` files cross between the packages.
The initializers: Bilinear, LSTMBias, Load and Mixed exactly; Orthogonal
and MSRAPrelu by their defining properties (their draws differ); the
``dumps()`` strings equal.
"""

import json

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import optimizer as jopt

SHAPES = [(6, 5), (7,), (3, 2, 4)]
UPDATES = 5

#: (registry name, constructor arguments): every deterministic path
CASES = [
    ("nag", dict(momentum=0.9)),
    ("nag", dict(momentum=0.0)),
    ("dcasgd", dict(momentum=0.9, lamda=0.1)),
    ("dcasgd", dict()),
    ("ccsgd", dict(momentum=0.9)),
    ("adagrad", dict(eps=1e-6)),
    ("rmsprop", dict()),
    ("rmsprop", dict(centered=True, clip_weights=0.9)),
    ("rmsprop", dict(clip_weights=0.05)),
    ("adadelta", dict(rho=0.8)),
    ("test", dict()),
]


def _tensors(seed):
    rs = np.random.RandomState(seed)
    ws = [rs.normal(0, 1, s).astype(np.float32) for s in SHAPES]
    gs = [[rs.normal(0, 2, s).astype(np.float32) for s in SHAPES]
          for _ in range(UPDATES)]
    return ws, gs


def _run(mx, name, kw, seed=0, generator=None):
    """Five updates of every tensor through ``mx``'s Updater: (weights,
    states as numpy, the updater)."""
    extra = dict(generator=generator) if generator is not None else {}
    opt = mx.optimizer.create(
        name, learning_rate=0.1, wd=0.01, rescale_grad=0.5,
        clip_gradient=1.5,
        lr_scheduler=mx.lr_scheduler.FactorScheduler(step=2, factor=0.5),
        **kw, **extra)
    upd = mx.optimizer.get_updater(opt)
    ws, gs = _tensors(seed)
    weights = [mx.nd.array(w) for w in ws]
    for step in gs:
        for i, (w, g) in enumerate(zip(weights, step)):
            upd(i, mx.nd.array(g), w)
    return [w.asnumpy() for w in weights], _states_np(upd.states), upd


def _states_np(states):
    def walk(s):
        if s is None:
            return None
        if isinstance(s, (tuple, list)):
            return tuple(walk(a) for a in s)
        return s.asnumpy()
    return {i: walk(s) for i, s in states.items()}


def _assert_states(got, want, **tol):
    assert sorted(got) == sorted(want)
    for i in want:
        a, b = got[i], want[i]
        if isinstance(b, tuple):
            assert isinstance(a, tuple) and len(a) == len(b)
            for x, y in zip(a, b):
                if y is None:
                    assert x is None
                else:
                    np.testing.assert_allclose(x, y, **tol)
        elif b is None:
            assert a is None
        else:
            np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("name,kw", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in enumerate(CASES)])
def test_optimizer_matches_jax(name, kw):
    with jax.disable_jit():
        jw, js, jupd = _run(jmx, name, kw)
    tw, ts, tupd = _run(tmx, name, kw)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    _assert_states(ts, js, rtol=1e-6, atol=1e-7)
    assert tupd.optimizer.num_update == jupd.optimizer.num_update
    # the weights did move
    ws, _ = _tensors(0)
    assert not np.allclose(tw[0], ws[0])


def test_registry_has_the_jax_names():
    for name in ("sgd", "nag", "dcasgd", "sgld", "ccsgd", "adam",
                 "adagrad", "rmsprop", "adadelta", "test"):
        assert type(tmx.optimizer.create(name)).__name__ == \
            type(jopt.create(name)).__name__


def test_sgld_is_the_jax_step_plus_its_own_seeded_noise(monkeypatch):
    """Five updates of every tensor with the scheduler: at each, the
    port's step less the noise a second generator of the same seed draws
    equals the JAX step from the same weight with its noise set to zero
    (the deterministic part)."""
    monkeypatch.setattr(
        jopt, "_random_normal",
        lambda loc, scale, shape, ctx: jmx.nd.zeros(shape, ctx))
    kw = dict(learning_rate=0.1, wd=0.01, rescale_grad=0.5,
              clip_gradient=1.5)
    o_t = tmx.optimizer.create(
        "sgld", generator=torch.Generator().manual_seed(5),
        lr_scheduler=tmx.lr_scheduler.FactorScheduler(step=2, factor=0.5),
        **kw)
    o_j = jopt.create(
        "sgld", lr_scheduler=jmx.lr_scheduler.FactorScheduler(
            step=2, factor=0.5), **kw)
    replay = torch.Generator().manual_seed(5)
    ws, gs = _tensors(0)
    weights = [tmx.nd.array(w) for w in ws]
    for n, step in enumerate(gs):
        for i, (w, g) in enumerate(zip(weights, step)):
            before = w.asnumpy()
            o_t.update(i, w, tmx.nd.array(g), None)
            w_j = jmx.nd.array(before)
            o_j.update(i, w_j, jmx.nd.array(g), None)
            lr = o_t._get_lr(i)
            assert lr == o_j._get_lr(i)
            drawn = torch.empty(SHAPES[i]).normal_(
                0.0, np.sqrt(lr), generator=replay).numpy()
            np.testing.assert_allclose(w.asnumpy() - drawn, w_j.asnumpy(),
                                       rtol=0, atol=1e-6)
    assert o_t.num_update == o_j.num_update == UPDATES


def test_sgld_noise_has_std_sqrt_lr():
    """A zero gradient without weight decay: the step is the noise alone.
    Over 200000 draws the sample std lies within 1% of sqrt(lr) (its
    standard error is 0.16%) and the mean within 5 standard errors of 0."""
    n, lr = 200000, 0.04
    w = tmx.nd.array(np.zeros(n, np.float32))
    o = tmx.optimizer.create("sgld", learning_rate=lr,
                             generator=torch.Generator().manual_seed(3))
    o.update(0, w, tmx.nd.array(np.zeros(n, np.float32)), None)
    step = w.asnumpy().astype(np.float64)
    assert abs(step.std() / np.sqrt(lr) - 1) < 0.01
    assert abs(step.mean()) < 5 * np.sqrt(lr / n)


@pytest.mark.parametrize("name,kw", [
    ("nag", dict(momentum=0.9)), ("dcasgd", dict(momentum=0.9)),
    ("dcasgd", dict()), ("ccsgd", dict(momentum=0.9)), ("sgld", dict()),
    ("adagrad", dict()), ("rmsprop", dict()),
    ("rmsprop", dict(centered=True)), ("adadelta", dict()),
    ("test", dict())])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_states_files_cross_between_packages(name, kw, writer):
    """``Updater.get_states`` of one package, ``set_states`` of the other:
    the same states, with DCASGD's ``(None, weight)``, RMSProp's 1-tuple
    and 3-tuple kept as they are."""
    mxs = {"jax": jmx, "torch": tmx}
    wmx, rmx = mxs[writer], mxs["torch" if writer == "jax" else "jax"]
    _, want, wupd = _run(wmx, name, kw)
    blob = wupd.get_states()
    assert b"mxnet_tpu_torch" not in blob
    # SGLD keeps no state: a dict of None
    assert (b"mxnet_tpu.ndarray" in blob) == (name != "sgld")
    rupd = rmx.optimizer.get_updater(rmx.optimizer.create(name, **kw))
    rupd.set_states(blob)
    got = _states_np(rupd.states)
    _assert_states(got, want, rtol=0, atol=0)
    for i, s in rupd.states.items():
        assert type(s).__name__ == type(wupd.states[i]).__name__


def _arr(mx, shape):
    return mx.nd.array(np.full(shape, 7.0, np.float32))


@pytest.mark.parametrize("init,name,shape", [
    ("Bilinear", "up_weight", (2, 3, 4, 4)),
    ("Bilinear", "up_weight", (1, 1, 5, 3)),
    ("LSTMBias", "lstm_i2h_bias", (16,)),
    ("LSTMBias", "lstm_i2h_weight", (8, 3)),
    ("Zero", "deconv_upsampling", (2, 2, 4, 4)),
    ("Zero", "lstm_begin_state", (2, 3)),
    ("Zero", "bn_moving_inv_var", (3,)),
    ("Zero", "bn_running_var", (3,)),
])
def test_initializer_is_exact_against_jax(init, name, shape):
    got, want = _arr(tmx, shape), _arr(jmx, shape)
    getattr(tmx.init, init)()(tmx.init.InitDesc(name), got)
    getattr(jmx.init, init)()(jmx.init.InitDesc(name), want)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_load_and_mixed_are_exact_against_jax(tmp_path):
    rs = np.random.RandomState(0)
    params = {"arg:fc_weight": rs.normal(0, 1, (4, 3)).astype(np.float32),
              "aux:bn_moving_var": rs.uniform(1, 2, 3).astype(np.float32)}
    path = str(tmp_path / "p.params")
    jmx.nd.save(path, {k: jmx.nd.array(v) for k, v in params.items()})
    names = [("fc_weight", (4, 3)), ("bn_moving_var", (3,)),
             ("fc2_weight", (4,)), ("other_weight", (2, 2)),
             ("bn_gamma", (3,))]
    out = {}
    for tag, mx in (("jax", jmx), ("torch", tmx)):
        load = mx.init.Load(path, default_init=mx.init.Constant(0.25))
        mixed = mx.init.Mixed(["fc2_", ".*"],
                              [mx.init.Constant(3.0), load])
        got = {}
        for n, s in names:
            a = _arr(mx, s)
            mixed(mx.init.InitDesc(n), a)
            got[n] = a.asnumpy()
        out[tag] = got
        with pytest.raises(ValueError, match="no init"):
            mx.init.Load(path)(mx.init.InitDesc("other_weight"),
                               _arr(mx, (2,)))
        with pytest.raises(ValueError, match="shape mismatch"):
            load(mx.init.InitDesc("fc_weight"), _arr(mx, (2, 3)))
    for n, _ in names:
        np.testing.assert_array_equal(out["torch"][n], out["jax"][n])
    np.testing.assert_array_equal(out["torch"]["fc_weight"],
                                  params["arg:fc_weight"])
    assert (out["torch"]["fc2_weight"] == 3.0).all()
    assert (out["torch"]["other_weight"] == 0.25).all()
    # a default initializer still dispatches by name: gamma -> 1
    assert (out["torch"]["bn_gamma"] == 1.0).all()


@pytest.mark.parametrize("shape,rand_type", [((6, 10), "uniform"),
                                             ((10, 6), "normal"),
                                             ((4, 2, 3, 3), "uniform")])
def test_orthogonal_is_orthonormal_times_scale(shape, rand_type):
    a = _arr(tmx, shape)
    tmx.init.Orthogonal(scale=1.5, rand_type=rand_type,
                        generator=torch.Generator().manual_seed(0))(
        tmx.init.InitDesc("w_weight"), a)
    m = a.asnumpy().reshape(shape[0], -1).astype(np.float64) / 1.5
    gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
    np.testing.assert_allclose(gram, np.eye(gram.shape[0]), atol=1e-6)


@pytest.mark.parametrize("factor_type,slope", [("avg", 0.25), ("in", 0.0),
                                               ("out", 1.0)])
def test_msraprelu_magnitude(factor_type, slope):
    """Gaussian Xavier of magnitude 2 / (1 + slope^2): over a (400, 300,
    3, 3) weight the sample std lies within 1% of sqrt(magnitude /
    factor)."""
    shape = (400, 300, 3, 3)
    a = _arr(tmx, shape)
    init = tmx.init.MSRAPrelu(factor_type, slope,
                              generator=torch.Generator().manual_seed(1))
    init(tmx.init.InitDesc("c_weight"), a)
    assert init.magnitude == 2.0 / (1 + slope ** 2)
    fan_in, fan_out = 300 * 9, 400 * 9
    factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
              "out": fan_out}[factor_type]
    std = a.asnumpy().astype(np.float64).std()
    assert abs(std / np.sqrt(init.magnitude / factor) - 1) < 0.01


@pytest.mark.parametrize("name,kw", [
    ("Orthogonal", {}), ("Orthogonal", dict(scale=2.0, rand_type="normal")),
    ("MSRAPrelu", {}), ("MSRAPrelu", dict(factor_type="in", slope=0.1)),
    ("Bilinear", {}), ("LSTMBias", {}), ("LSTMBias", dict(forget_bias=2.0)),
    ("Xavier", dict(rnd_type="gaussian", factor_type="in", magnitude=2))])
def test_dumps_equal_jax(name, kw):
    got = getattr(tmx.init, name)(**kw).dumps()
    assert got == getattr(jmx.init, name)(**kw).dumps()
    klass, kwargs = json.loads(got)
    # the attribute form re-creates the initializer in the port
    assert type(tmx.init.create(klass, **kwargs)).__name__ == name


def test_init_attribute_reaches_the_new_initializers():
    """A variable's ``__init__`` attribute (an initializer's ``dumps()``)
    overrides the name rule: LSTMBias on a ``_bias`` through the global
    initializer, as in the JAX package."""
    net = tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), num_hidden=8, name="fc",
        bias=tmx.sym.Variable("fc_bias", init=tmx.init.LSTMBias(2.0)))
    mod = tmx.mod.Module(net, label_names=None, context=tmx.cpu())
    mod.bind([("data", (2, 3))])
    mod.init_params(tmx.init.Uniform(0.1))
    bias = mod.get_params()[0]["fc_bias"].asnumpy()
    np.testing.assert_array_equal(bias, [0, 0, 2, 2, 0, 0, 0, 0])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_resumed_sgld_draws_the_uninterrupted_noise(pkg):
    """Seed 7 and three SGLD updates of two tensors, against the same run
    resumed before its third update through ``get_state`` -> ``seed(123)``
    -> ``set_state`` -> a new ``SGLD``: the weights end equal, in either
    package, as the generator that draws the noise is ``mx.random``'s."""
    mx = jmx if pkg == "jax" else tmx
    ws, gs = _tensors(0)

    def run(resume_at=None):
        mx.random.seed(7)
        opt = mx.optimizer.create("sgld", learning_rate=0.1, wd=0.01)
        weights = [mx.nd.array(w) for w in ws[:2]]
        for n, step in enumerate(gs[:3]):
            if n == resume_at:
                state = json.loads(json.dumps(mx.random.get_state()))
                mx.random.seed(123)
                mx.random.set_state(state)
                opt = mx.optimizer.create("sgld", learning_rate=0.1, wd=0.01)
            for i, (w, g) in enumerate(zip(weights, step[:2])):
                opt.update(i, w, mx.nd.array(g), None)
        return [w.asnumpy() for w in weights]

    for got, want in zip(run(resume_at=2), run()):
        np.testing.assert_array_equal(got, want)
