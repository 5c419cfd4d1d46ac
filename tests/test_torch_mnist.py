"""BASELINE #1 in the PyTorch port against the JAX package: ``MNISTIter``
over the synthetic MNIST idx files of ``train_mnist.py`` (written by the
port's copy of ``synth_mnist``, byte for byte the example's), and LeNet
and the MLP through ``Module.fit`` with ``train_mnist.py``'s settings
(b64, SGD lr 0.05 momentum 0.9 wd 1e-4, ``lr_step_epochs="10"``), from
the JAX package's Xavier weights carried across through
``mxnet_tpu_torch.convert``.

Tolerances: the iterator's batches bit for bit; one LeNet step
``rtol=atol=1e-5``; the SGD fits each parameter within 3x the distance
that one ulp of the initial weights moves a fit (LeNet's fit crosses a
max-pool near-tie, where f32 sums in another order route a gradient to
the other element); the other optimizers of ``common/fit.py`` through
``fit`` ``rtol=1e-4, atol=1e-5`` (f32 sums through products in another
order).
"""

import contextlib
import gzip
import shutil

import jax
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.module.base_module import _PreemptGuard
from mxnet_tpu_torch import checkpoint as tck

from torch_deadline import deadline  # noqa: F401 (autouse)

BATCH, TRAIN, VAL = 64, 320, 128


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    """The idx files, and gzipped copies of the training pair."""
    d = str(tmp_path_factory.mktemp("mnist"))
    paths = tmx.models.lenet.synth_mnist(d, num_train=TRAIN, num_val=VAL)
    for k in ("train_img", "train_lab"):
        with open(paths[k], "rb") as src, \
                gzip.open(paths[k] + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
    return paths


def _iter(mx, paths, gz=False, split="train", **kw):
    kw.setdefault("batch_size", BATCH)
    ext = ".gz" if gz else ""
    return mx.io.MNISTIter(image=paths[split + "_img"] + ext,
                           label=paths[split + "_lab"] + ext, **kw)


def _batches(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
@pytest.mark.parametrize("kw", [
    dict(shuffle=True),
    dict(shuffle=False, flat=True),
    dict(shuffle=True, seed=3, num_parts=3, part_index=1),
    dict(shuffle=True, flat=True, num_parts=2, part_index=1, batch_size=48),
], ids=["shuffle", "flat", "part1of3", "flat-part1of2-b48"])
def test_mnistiter_batches_match_jax(mnist, gz, kw):
    """The same batches bit for bit, twice over (after ``reset``), with
    the same descriptions; the ragged tail is discarded."""
    got_it, want_it = _iter(tmx, mnist, gz, **kw), _iter(jmx, mnist, gz, **kw)
    for g, w in ((got_it.provide_data, want_it.provide_data),
                 (got_it.provide_label, want_it.provide_label)):
        assert [(d.name, tuple(d.shape)) for d in g] == \
            [(d.name, tuple(d.shape)) for d in w]
    for _ in range(2):
        got, want = _batches(got_it), _batches(want_it)
        assert len(got) == len(want) == \
            TRAIN // kw.get("num_parts", 1) // kw.get("batch_size", BATCH)
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
            assert gp == wp == 0
        got_it.reset()
        want_it.reset()
    scale = got[0][0]
    assert scale.dtype == np.float32 and 0 <= scale.min() \
        and scale.max() <= 1
    assert scale.shape[1:] == ((784,) if kw.get("flat") else (1, 28, 28))


def test_mnistiter_state_round_trips_and_crosses(mnist):
    """After two batches, the state of either package's iterator, loaded
    into a fresh iterator of either package, yields the third batch; a
    state of another iterator type is refused."""
    states = {}
    for tag, mx in (("jax", jmx), ("torch", tmx)):
        it = _iter(mx, mnist)
        next(it), next(it)
        states[tag] = it.state_dict()
    assert states["torch"] == states["jax"]
    third = _batches(_iter(tmx, mnist))[2]
    for tag, mx in (("jax", jmx), ("torch", tmx)):
        for state in states.values():
            it = _iter(mx, mnist)
            it.load_state_dict(state)
            b = next(it)
            np.testing.assert_array_equal(b.data[0].asnumpy(), third[0])
            np.testing.assert_array_equal(b.label[0].asnumpy(), third[1])
    with pytest.raises(tmx.MXNetError, match="NDArrayIter"):
        _iter(tmx, mnist).load_state_dict({"type": "NDArrayIter",
                                           "cursor": 0})


def _net(mx, network):
    """LeNet names its layers by count (``convolution0``, ...): a fresh
    name manager gives every build the same names."""
    with mx.name.NameManager():
        return mx.models.get_symbol(network, num_classes=10)


@pytest.fixture(scope="module")
def inits(mnist):
    """The JAX package's Xavier (gaussian, in, 2) weights of LeNet and the
    MLP, as numpy."""
    out = {}
    for network, shape in (("lenet", (BATCH, 1, 28, 28)),
                           ("mlp", (BATCH, 784))):
        mod = jmx.mod.Module(_net(jmx, network), context=jmx.cpu())
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (BATCH,))])
        np.random.seed(1)
        mod.init_params(jmx.init.Xavier(rnd_type="gaussian",
                                        factor_type="in", magnitude=2))
        arg, aux = mod.get_params()
        out[network] = ({k: v.asnumpy() for k, v in arg.items()},
                        {k: v.asnumpy() for k, v in aux.items()})
    return out


def _fit(mx, network, paths, init, optimizer="sgd", params=None, **kw):
    """One epoch of ``train_mnist.py``'s fit from ``init``: (params as
    numpy, validation accuracy, module)."""
    flat = network == "mlp"
    train = _iter(mx, paths, flat=flat)
    val = _iter(mx, paths, split="val", shuffle=False, flat=flat)
    mod = mx.mod.Module(_net(mx, network), context=mx.cpu())
    mod.bind(data_shapes=train.provide_data,
             label_shapes=train.provide_label)
    mod.init_params()
    arg, aux = init
    if mx is tmx:
        tmx.convert.set_module_params(mod, arg, aux)
    else:
        mod.set_params({k: jmx.nd.array(v) for k, v in arg.items()},
                       {k: jmx.nd.array(v) for k, v in aux.items()})
    epoch_size = TRAIN // BATCH
    if params is None:
        params = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
                  "lr_scheduler": mx.lr_scheduler.MultiFactorScheduler(
                      step=[10 * epoch_size], factor=0.1)}
    mod.fit(train, num_epoch=1, eval_metric="acc", optimizer=optimizer,
            optimizer_params=params, force_init=False, **kw)
    (_, acc), = mod.score(val, "acc")
    p_arg, p_aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in p_arg.items()}, acc, mod)


def _ulp_floor(network, mnist, inits, ref):
    """The distance, per parameter, that one ulp of the initial weights
    moves a fit: the largest over both packages and both directions
    (every weight one ulp up, every weight one ulp down) of each
    perturbed fit against that package's own fit in ``ref``."""
    arg, aux = inits[network]
    floor = {k: 0.0 for k in arg}
    for direction in (np.inf, -np.inf):
        moved = {k: np.nextafter(v, np.float32(direction))
                 for k, v in arg.items()}
        for mx in (jmx, tmx):
            fit, _, _ = _fit(mx, network, mnist, (moved, aux))
            for k in floor:
                floor[k] = max(floor[k],
                               float(np.abs(fit[k] - ref[mx][k]).max()))
    return floor


@pytest.mark.parametrize("network", ["lenet", "mlp"])
def test_fit_matches_jax(mnist, inits, network, monkeypatch):
    """One epoch (5 steps) of each package's fit from the same weights,
    each parameter within 3x the ulp floor (``_ulp_floor``).  LeNet's
    fit sits at a near-tie of a 2x2 max-pool window (two tanh values
    2e-7 apart): f32 sums taken in another order route that window's
    gradient to the other element from the third step on, and one ulp of
    the initial weights moves either package's fit by as much.  The
    steps themselves agree at 1e-5
    (``test_one_lenet_step_matches_jax``)."""
    monkeypatch.setenv("MXNET_DEVICE_METRIC", "0")
    want, want_acc, _ = _fit(jmx, network, mnist, inits[network])
    got, got_acc, mod = _fit(tmx, network, mnist, inits[network])
    assert mod._optimizer.num_update == TRAIN // BATCH
    floor = _ulp_floor(network, mnist, inits, {jmx: want, tmx: got})
    for k in want:
        assert not np.allclose(want[k], inits[network][0][k]), k
        gap = float(np.abs(got[k] - want[k]).max())
        assert gap <= 3 * floor[k], (k, gap, floor[k])
    assert got_acc == pytest.approx(want_acc, abs=1.0 / VAL)


def test_one_lenet_step_matches_jax(mnist, inits):
    """One SGD step of LeNet from ``inits["lenet"]`` on the first batch:
    every gradient and every updated parameter equal to the JAX step's
    at ``rtol=atol=1e-5`` (the JAX side without jit, so that XLA does
    not contract the update's multiply-add into one FMA)."""
    arg, aux = inits["lenet"]
    out = {}
    for mx in (jmx, tmx):
        it = _iter(mx, mnist)
        mod = mx.mod.Module(_net(mx, "lenet"), context=mx.cpu())
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params()
        if mx is tmx:
            tmx.convert.set_module_params(mod, arg, aux)
        else:
            mod.set_params({k: jmx.nd.array(v) for k, v in arg.items()},
                           {k: jmx.nd.array(v) for k, v in aux.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})
        with (jax.disable_jit() if mx is jmx else contextlib.nullcontext()):
            mod.forward_backward(next(iter(it)))
            grads = {k: mod._exec.grad_dict[k].asnumpy() for k in arg}
            mod.update()
        out[mx] = grads, {k: v.asnumpy()
                          for k, v in mod.get_params()[0].items()}
    for want, got in zip(out[jmx], out[tmx]):
        for k in arg:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


#: each optimizer of common/fit.py's --optimizer at a learning rate it
#: trains the MLP at (fit.py passes momentum to sgd and nag only)
OPTIMIZERS = [
    ("nag", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
    ("dcasgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
    ("ccsgd", {"learning_rate": 0.05, "wd": 1e-4}),
    ("adagrad", {"learning_rate": 0.01, "wd": 1e-4}),
    ("rmsprop", {"learning_rate": 0.001, "wd": 1e-4}),
    ("rmsprop", {"learning_rate": 0.001, "wd": 1e-4, "centered": True,
                 "clip_weights": 1.0}),
    ("adadelta", {"wd": 1e-4}),
    ("test", {"wd": 1e-4}),
]


@pytest.mark.parametrize("name,params", OPTIMIZERS,
                         ids=["%s-%d" % (o[0], i)
                              for i, o in enumerate(OPTIMIZERS)])
def test_fit_with_each_optimizer_matches_jax(mnist, inits, name, params,
                                             monkeypatch):
    """``fit(optimizer=name)`` of the MLP, one epoch, against the JAX fit;
    the states stay tuples where the optimizer's are."""
    monkeypatch.setenv("MXNET_DEVICE_METRIC", "0")
    want, _, jmod = _fit(jmx, "mlp", mnist, inits["mlp"], name,
                         dict(params))
    got, _, mod = _fit(tmx, "mlp", mnist, inits["mlp"], name, dict(params))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for i, s in mod._updater.states.items():
        assert type(s).__name__ == type(jmod._updater.states[i]).__name__


def test_fit_with_sgld_trains_to_finite_weights(mnist, inits):
    got, acc, mod = _fit(tmx, "mlp", mnist, inits["mlp"], "sgld",
                         {"learning_rate": 1e-3, "wd": 1e-4})
    assert all(np.isfinite(v).all() for v in got.values())
    assert 0 <= acc <= 1 and type(mod._optimizer).__name__ == "SGLD"


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", None),
    ("dcasgd", {"learning_rate": 0.05}),
    ("rmsprop", {"learning_rate": 1e-3, "centered": True}),
], ids=["sgd", "dcasgd-none-and-weight", "rmsprop-3-tuple"])
def test_fit_resumes_mid_epoch_on_mnistiter(tmp_path, mnist, inits,
                                            optimizer, params):
    """A SIGTERM at the third batch of a LeNet fit with a snapshot every
    batch, then ``resume="auto"`` from the iterator's state and the
    optimizer's (DCASGD's ``(None, weight)``, centered RMSProp's three
    arrays): the same parameters as the uninterrupted fit, bit for
    bit."""
    import signal

    def fit(prefix, callbacks=None, resume=None):
        return _fit(tmx, "lenet", mnist, inits["lenet"], optimizer,
                    None if params is None else dict(params),
                    checkpoint_prefix=prefix, checkpoint_every_n_batches=1,
                    batch_end_callback=callbacks, resume=resume)[0]

    ref = fit(str(tmp_path / "ref"))
    seen = [0]

    def kill(_param):
        seen[0] += 1
        if seen[0] == 3:
            assert isinstance(signal.getsignal(signal.SIGTERM),
                              _PreemptGuard)
            signal.raise_signal(signal.SIGTERM)

    prefix = str(tmp_path / "victim")
    with pytest.raises(tck.TrainingPreempted) as err:
        fit(prefix, [kill])
    assert err.value.nbatch == 2
    got = fit(prefix, resume="auto")
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
