"""Resume and graceful preemption in the PyTorch port's ``Module.fit``.

The behaviours of ``tests/test_preemption.py`` and of the checkpoint half
of ``tests/test_resilience.py``, on the port, on the CPU.  A preemption is
a real SIGTERM (or SIGINT) raised from a batch-end callback on the main
thread, where ``fit`` has installed its handler (the port has no fault
points).  The kill-and-resume runs train the small ResNet of
``test_torch_module.py`` from the JAX package's initialization: the
resumed run must equal the uninterrupted one bit for bit, in the classic
loop, with the fused step in chunks of two (``MXNET_FUSE_TRAIN_STEP=1``,
``MXNET_BULK_TRAIN_STEPS=2``) and with device prefetch, and lie within
``rtol=1e-4, atol=1e-5`` of the JAX package's uninterrupted fit (f32 sums
in another order).  The other behaviours use a two-layer perceptron.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu_torch import checkpoint as tck
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.model import checkpoint_manifest, load_latest_checkpoint
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.module.base_module import _PreemptGuard

from torch_deadline import deadline  # noqa: F401 (autouse)

N, DIM, CLASSES, BATCH, EPOCHS = 64, 8, 3, 16, 2
RESNET = dict(units=[1, 1], num_stages=2, filter_list=[8, 16, 32],
              num_classes=4, image_shape=(3, 40, 40), bottle_neck=True)
R_BATCH, R_BATCHES = 4, 4  # the ResNet runs: 2 epochs of 4 batches of 4
_ENV = ("MXNET_CKPT_EVERY_N_BATCHES", "MXNET_CKPT_KEEP_LAST",
        "MXNET_CKPT_ASYNC", "MXNET_FUSE_TRAIN_STEP",
        "MXNET_BULK_TRAIN_STEPS", "MXNET_DEVICE_PREFETCH",
        "MXNET_DEVICE_METRIC")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    telemetry.enable()


def _no_writer_threads():
    return not [t for t in threading.enumerate()
                if t.name == "ckpt-writer" and t.is_alive()]


def _raise(signum=signal.SIGTERM):
    """Deliver ``signum`` to this process from a callback of a fit that
    holds the handlers (never to a process that would die of it)."""
    assert threading.current_thread() is threading.main_thread()
    assert isinstance(signal.getsignal(signum), _PreemptGuard)
    signal.raise_signal(signum)


def _kill_at(hit, signum=signal.SIGTERM):
    """A batch-end callback raising ``signum`` at its ``hit``-th call."""
    seen = [0]

    def cb(_param):
        seen[0] += 1
        if seen[0] == hit:
            _raise(signum)
    return cb


# -- the two-layer perceptron ------------------------------------------------
def _toy_data(seed=7):
    rs = np.random.RandomState(seed)
    return (rs.rand(N, DIM).astype(np.float32),
            rs.randint(0, CLASSES, N).astype(np.float32))


def _toy_iter():
    x, y = _toy_data()
    return tmx.io.NDArrayIter(x, y, batch_size=BATCH)


def _toy_module():
    data = tmx.sym.Variable("data")
    h = tmx.sym.Activation(tmx.sym.FullyConnected(data, num_hidden=16,
                                                  name="fc1"),
                           act_type="relu")
    return tmx.mod.Module(tmx.sym.SoftmaxOutput(
        tmx.sym.FullyConnected(h, num_hidden=CLASSES, name="fc2"),
        name="softmax"), context=tmx.cpu())


def _toy_fit(prefix, num_epoch=EPOCHS, callbacks=None, **kw):
    mod = _toy_module()
    tmx.random.seed(11)
    mod.fit(_toy_iter(), num_epoch=num_epoch, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=tmx.init.Xavier(), checkpoint_prefix=prefix,
            batch_end_callback=callbacks, **kw)
    return mod


def _params(mod):
    arg, aux = mod.get_params()
    out = {k: v.asnumpy() for k, v in arg.items()}
    out.update({"aux:" + k: v.asnumpy() for k, v in aux.items()})
    return out


def _assert_identical(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- the iterator-state protocol ---------------------------------------------
def test_dataiter_base_state_protocol_raises():
    it = tmx.io.DataIter()
    with pytest.raises(NotImplementedError, match="state"):
        it.state_dict()
    with pytest.raises(NotImplementedError):
        it.load_state_dict({})


def test_ndarrayiter_state_roundtrip_and_mismatch():
    x, y = _toy_data()
    it = tmx.io.NDArrayIter(x, y, batch_size=BATCH)
    it.next()
    it.next()
    st = it.state_dict()
    want = it.next()
    it2 = tmx.io.NDArrayIter(x, y, batch_size=BATCH)
    it2.load_state_dict(st)
    got = it2.next()
    np.testing.assert_array_equal(want.data[0].asnumpy(),
                                  got.data[0].asnumpy())
    np.testing.assert_array_equal(want.label[0].asnumpy(),
                                  got.label[0].asnumpy())
    with pytest.raises(tmx.MXNetError, match="does not match"):
        tmx.io.NDArrayIter(x[:32], y[:32],
                           batch_size=BATCH).load_state_dict(st)
    with pytest.raises(tmx.MXNetError, match="cannot restore"):
        it2.load_state_dict({"type": "ImageIter"})


@pytest.mark.parametrize("device", [False, True])
def test_prefetching_iter_state_accounts_for_buffered_batch(device):
    """The wrapper holds one batch made but not taken; its state is the
    consumer's position, so restored the buffered batch comes again."""
    x, y = _toy_data()

    def wrap(it):
        return tmx.io.DevicePrefetchIter(it, tmx.cpu()) if device \
            else tmx.io.PrefetchingIter(it)

    with wrap(tmx.io.NDArrayIter(x, y, batch_size=BATCH)) as it:
        it.next()
        st = it.state_dict()
        assert st["type"] == ("DevicePrefetchIter" if device
                              else "PrefetchingIter")
        assert st["inner"][0]["cursor"] == 0  # the cursor of batch 0
        want = [it.next().data[0].asnumpy() for _ in range(3)]
        with pytest.raises(StopIteration):
            it.next()
    with wrap(tmx.io.NDArrayIter(x, y, batch_size=BATCH)) as it2:
        it2.next()
        it2.next()
        it2.load_state_dict(st)
        got = [it2.next().data[0].asnumpy() for _ in range(3)]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_prefetching_iter_without_inner_protocol_raises():
    class Plain(tmx.io.DataIter):
        def __init__(self):
            super().__init__(2)
            self.left = 2
            self.provide_data = [tmx.io.DataDesc("data", (2, 3))]
            self.provide_label = []

        def next(self):
            if not self.left:
                raise StopIteration
            self.left -= 1
            return tmx.io.DataBatch([tmx.nd.zeros((2, 3), tmx.cpu())], [])

    with tmx.io.PrefetchingIter(Plain()) as it:
        it.next()
        with pytest.raises(NotImplementedError, match="state protocol"):
            it.state_dict()


# -- kill and resume: bit for bit, and against the JAX package -----------------
def _r_data():
    rs = np.random.RandomState(5)
    n = R_BATCH * R_BATCHES
    return (rs.uniform(0, 255, (n,) + RESNET["image_shape"])
            .astype(np.float32),
            rs.randint(0, RESNET["num_classes"], n).astype(np.float32))


def _r_opt(mx):
    return {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
            # lr halves after 4 updates: a chunk of two reads the lr of
            # its last step, the same lr a step of its own reads here
            "lr_scheduler": mx.lr_scheduler.FactorScheduler(step=4,
                                                            factor=0.5)}


@pytest.fixture(scope="module")
def r_init():
    """The JAX package's Xavier initialization of the small ResNet."""
    mod = jmx.mod.Module(jresnet.resnet(**RESNET), context=jmx.cpu())
    mod.bind(data_shapes=[("data", (R_BATCH,) + RESNET["image_shape"])],
             label_shapes=[("softmax_label", (R_BATCH,))])
    np.random.seed(7)
    mod.init_params(jmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


@pytest.fixture(scope="module")
def jax_fit(r_init):
    """The JAX package's uninterrupted two-epoch fit, as numpy."""
    x, y = _r_data()
    mod = jmx.mod.Module(jresnet.resnet(**RESNET), context=jmx.cpu())
    mod.fit(jmx.io.NDArrayIter(x, y, batch_size=R_BATCH), num_epoch=2,
            optimizer="sgd", optimizer_params=_r_opt(jmx),
            arg_params={k: jmx.nd.array(v) for k, v in r_init[0].items()},
            aux_params={k: jmx.nd.array(v) for k, v in r_init[1].items()},
            force_init=True)
    arg, aux = mod.get_params()
    out = {k: v.asnumpy() for k, v in arg.items()}
    out.update({"aux:" + k: v.asnumpy() for k, v in aux.items()})
    return out


MODES = {"classic": ({}, {}),
         "fused_bulk2": ({"MXNET_FUSE_TRAIN_STEP": "1",
                          "MXNET_BULK_TRAIN_STEPS": "2"}, {}),
         "prefetch": ({}, {"prefetch_to_device": True})}


def _r_fit(prefix, params, env, kw, trace, callbacks=(), resume=None):
    x, y = _r_data()
    mod = tmx.mod.Module(tresnet.resnet(**RESNET), context=tmx.cpu())
    cbs = [lambda p: trace.append((p.epoch, p.nbatch,
                                   p.eval_metric.get()[1]))]
    cbs += list(callbacks)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=R_BATCH), num_epoch=2,
                optimizer="sgd", optimizer_params=_r_opt(tmx),
                arg_params=None if params is None else
                {k: tmx.nd.array(v) for k, v in params[0].items()},
                aux_params=None if params is None else
                {k: tmx.nd.array(v) for k, v in params[1].items()},
                force_init=params is not None, checkpoint_prefix=prefix,
                checkpoint_every_n_batches=1, batch_end_callback=cbs,
                resume=resume, **kw)
    return mod


@pytest.fixture(scope="module")
def port_fits(r_init, tmp_path_factory):
    """``get(mode)``: the port's uninterrupted fit and its metric trace."""
    made = {}

    def get(mode):
        if mode not in made:
            trace = []
            mod = _r_fit(str(tmp_path_factory.mktemp(mode) / "ref"), r_init,
                         *MODES[mode], trace)
            made[mode] = (_params(mod), trace)
        return made[mode]

    return get


def test_resnet_fit_tracks_jax_through_step_four(r_init):
    """One epoch of the four ResNet batches, SGD without a scheduler, the
    port's fit against the JAX package's, ``rtol=1e-4, atol=1e-5`` (f32
    sums in another order).  At the fourth step one ReLU input of
    ``stage2_unit1_bn1`` lies 4e-6 below zero in the JAX fit.  With
    two-pass f32 BatchNorm statistics the port put it 4.5e-7 above zero
    and left the JAX fit (1.27e-4 in ``conv0_weight`` after the step);
    with exact statistics (``bn_kernel.batch_stats``, summed in f64) it
    lands on zero, where the ReLU passes no gradient either."""
    x, y = _r_data()
    opt = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
    fits = []
    for mx, res in ((jmx, jresnet), (tmx, tresnet)):
        mod = mx.mod.Module(res.resnet(**RESNET), context=mx.cpu())
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=R_BATCH), num_epoch=1,
                optimizer="sgd", optimizer_params=dict(opt),
                arg_params={k: mx.nd.array(v) for k, v in r_init[0].items()},
                aux_params={k: mx.nd.array(v) for k, v in r_init[1].items()},
                force_init=True)
        fits.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    want, got = fits
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("kill_at", [1, 2, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_kill_resume_bit_identical(tmp_path, r_init, jax_fit, port_fits,
                                   mode, kill_at):
    """A SIGTERM at batch ``kill_at`` (counted from 1 over the run; 4 is
    the last batch of the first epoch), then ``resume="auto"``: the same
    parameters and metric trace as the uninterrupted run, bit for bit."""
    env, kw = MODES[mode]
    ref, ref_trace = port_fits(mode)
    prefix = str(tmp_path / "victim")
    trace = []
    with pytest.raises(tck.TrainingPreempted) as err:
        _r_fit(prefix, r_init, env, kw, trace, [_kill_at(kill_at)])
    assert _no_writer_threads()
    assert os.path.exists(err.value.checkpoint_path)
    assert not isinstance(signal.getsignal(signal.SIGTERM), _PreemptGuard)
    done = len(trace)
    # bulk mode drains at the end of the chunk of the kill
    assert err.value.nbatch == done - 1
    res = _r_fit(prefix, None, env, kw, trace, resume="auto")
    assert _no_writer_threads()
    got = _params(res)
    _assert_identical(got, ref)
    assert trace[done:] == ref_trace[done:]
    assert checkpoint_manifest(prefix)["latest"] == 2
    for k, want in jax_fit.items():
        np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_signal_during_epoch_end_is_honored(tmp_path):
    """A signal during the epoch's wrap-up drains at the boundary: the
    checkpoint of the completed epoch is the resume point."""
    ref = _params(_toy_fit(str(tmp_path / "ref")))

    def poke(epoch, sym, arg, aux):
        if epoch == 0:
            _raise()

    prefix = str(tmp_path / "victim")
    with pytest.raises(tck.TrainingPreempted) as err:
        _toy_fit(prefix, epoch_end_callback=poke)
    assert err.value.nbatch is None and err.value.epoch == 0
    assert err.value.checkpoint_path.endswith("-0001.params")
    assert os.path.exists(err.value.checkpoint_path)
    _assert_identical(_params(_toy_fit(prefix, resume="auto")), ref)


def test_sigint_also_drains_gracefully(tmp_path):
    before = telemetry.counter_total("resilience.preemptions")
    with pytest.raises(tck.TrainingPreempted) as err:
        _toy_fit(str(tmp_path / "v"), callbacks=_kill_at(2, signal.SIGINT))
    assert err.value.signum == signal.SIGINT
    assert (err.value.epoch, err.value.nbatch) == (0, 1)
    assert telemetry.counter_total("resilience.preemptions") == before + 1


def test_fit_without_prefix_leaves_signal_handlers_alone():
    seen = []
    before = (signal.getsignal(signal.SIGTERM),
              signal.getsignal(signal.SIGINT))
    _toy_fit(None, num_epoch=1, callbacks=lambda p: seen.append(
        (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))))
    assert seen and all(s == before for s in seen)


def test_handlers_restored_after_clean_fit(tmp_path):
    before = (signal.getsignal(signal.SIGTERM),
              signal.getsignal(signal.SIGINT))
    _toy_fit(str(tmp_path / "ck"), num_epoch=1)
    assert signal.getsignal(signal.SIGTERM) is before[0]
    assert signal.getsignal(signal.SIGINT) is before[1]


def test_handlers_restored_after_a_fit_that_raised(tmp_path):
    before = (signal.getsignal(signal.SIGTERM),
              signal.getsignal(signal.SIGINT))

    def boom(p):
        raise ValueError("callback failed")

    with pytest.raises(ValueError, match="callback failed"):
        _toy_fit(str(tmp_path / "ck"), callbacks=boom,
                 checkpoint_every_n_batches=1)
    assert signal.getsignal(signal.SIGTERM) is before[0]
    assert signal.getsignal(signal.SIGINT) is before[1]
    assert _no_writer_threads()


def test_nested_fit_refuses_double_install(tmp_path):
    def nested(p):
        _toy_fit(str(tmp_path / "inner"), num_epoch=1)

    with pytest.raises(tmx.MXNetError, match="double-install"):
        _toy_fit(str(tmp_path / "ck"), callbacks=nested)
    # the outer fit released the handlers: a fresh fit installs them
    _toy_fit(str(tmp_path / "ck2"), num_epoch=1)
    assert _no_writer_threads()


# -- files on disk -------------------------------------------------------------
def _damage(path, how):
    blob = bytearray(open(path, "rb").read())
    if how == "truncate":
        blob = blob[:len(blob) // 2]
    else:
        blob[len(blob) // 2] ^= 0xFF  # same length: only the sha sees it
    with open(path, "wb") as f:
        f.write(bytes(blob))


@pytest.mark.parametrize("how", ["truncate", "bitflip"])
def test_resume_skips_corrupt_snapshot_generation(tmp_path, monkeypatch,
                                                  how):
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "0")  # every generation written
    prefix = str(tmp_path / "ck")
    with pytest.raises(tck.TrainingPreempted):
        _toy_fit(prefix, callbacks=_kill_at(6), checkpoint_every_n_batches=1)
    snaps = checkpoint_manifest(prefix)["snapshots"]
    assert [(s["epoch"], s["nbatch"]) for s in snaps] == \
        [(0, 3), (1, 0), (1, 1)]
    _damage(str(tmp_path / snaps[-1]["params"]), how)
    before = telemetry.counter_total("resilience.checkpoint.corrupt_skipped")
    st = tck.load_latest_state(prefix)
    assert (st.epoch, st.nbatch) == (1, 0)
    assert telemetry.counter_total(
        "resilience.checkpoint.corrupt_skipped") == before + 1
    _damage(str(tmp_path / snaps[-2]["states"]), how)
    st = tck.load_latest_state(prefix)
    # the checkpoint of epoch 1 sorts after every snapshot of epoch 0
    assert (st.epoch, st.nbatch) == (1, None)


@pytest.mark.parametrize("how", ["truncate", "bitflip"])
def test_epoch_checkpoint_sha_verified_on_resume(tmp_path, how):
    prefix = str(tmp_path / "ck")
    _toy_fit(prefix)
    _damage("%s-%04d.params" % (prefix, EPOCHS), how)
    before = telemetry.counter_total("resilience.checkpoint.corrupt_skipped")
    found = load_latest_checkpoint(prefix)
    assert found is not None and found[0] == EPOCHS - 1
    st = tck.load_latest_state(prefix)
    assert (st.epoch, st.nbatch) == (EPOCHS - 1, None)
    assert telemetry.counter_total(
        "resilience.checkpoint.corrupt_skipped") == before + 2


def test_resume_auto_without_any_checkpoint_starts_fresh(tmp_path):
    prefix = str(tmp_path / "none")
    _assert_identical(_params(_toy_fit(prefix, resume="auto")),
                      _params(_toy_fit(str(tmp_path / "plain"))))
    assert checkpoint_manifest(prefix)["latest"] == EPOCHS


def test_snapshot_retention_gc_glob_unsafe_prefix(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "0")
    monkeypatch.setenv("MXNET_CKPT_KEEP_LAST", "2")
    prefix = str(tmp_path / "ck[1]*x")
    before = telemetry.counter_total("resilience.checkpoint.pruned")
    _toy_fit(prefix, checkpoint_every_n_batches=1)
    m = checkpoint_manifest(prefix)
    assert m["latest"] == EPOCHS and len(m["snapshots"]) == 2
    for entry in m["snapshots"]:
        assert os.path.exists(str(tmp_path / entry["params"]))
    on_disk = [f for f in os.listdir(str(tmp_path))
               if "-snap-" in f and f.endswith(".params")]
    assert len(on_disk) == 2  # 8 generations written, 2 kept
    assert telemetry.counter_total("resilience.checkpoint.pruned") > before
    assert tmx.model.list_checkpoints(prefix) == [2, 1]


def test_gc_sweeps_orphan_payloads_never_breaks_manifest(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "0")
    prefix = str(tmp_path / "ck")
    _toy_fit(prefix, checkpoint_every_n_batches=2)
    orphan = tck.snapshot_path(prefix, 7, 123456, "params")
    with open(orphan, "wb") as f:
        f.write(b"leftover")
    tck.gc_snapshots(prefix, keep_last=1)
    assert not os.path.exists(orphan)
    m = checkpoint_manifest(prefix)
    assert len(m["snapshots"]) == 1
    assert os.path.exists(str(tmp_path / m["snapshots"][0]["params"]))


def test_corrupt_iter_state_degrades_not_crashes(tmp_path, caplog):
    prefix = str(tmp_path / "ck")
    with pytest.raises(tck.TrainingPreempted):
        _toy_fit(prefix, callbacks=_kill_at(6), checkpoint_every_n_batches=1)
    m = checkpoint_manifest(prefix)
    m["snapshots"][-1]["iter_state"] = {"type": "PrefetchingIter",
                                        "inner": [{}, {}]}
    with open("%s-manifest.json" % prefix, "w") as f:
        f.write(json.dumps(m))
    trace = []
    res = _toy_fit(prefix, resume="auto",
                   callbacks=lambda p: trace.append((p.epoch, p.nbatch)))
    assert "could not restore the iterator position" in caplog.text
    # the epoch of the snapshot starts again at batch 0
    assert trace == [(1, b) for b in range(4)]
    assert all(np.isfinite(v).all() for v in _params(res).values())


def test_atomic_write_crash_leaves_old_content(tmp_path):
    path = str(tmp_path / "f.bin")
    tmx.base.atomic_write_bytes(path, b"old content")

    def crash(tmp):
        with open(tmp, "wb") as f:
            f.write(b"half")
        raise OSError("killed mid-write")

    with pytest.raises(OSError, match="mid-write"):
        tmx.base.atomic_write(path, crash)
    assert open(path, "rb").read() == b"old content"
    assert os.listdir(str(tmp_path)) == ["f.bin"]


# -- the writer ----------------------------------------------------------------
def test_async_writer_backpressure_drops_and_joins(tmp_path, monkeypatch):
    gate = threading.Event()
    wrote = []

    def slow_write(self, snap):
        gate.wait(10)
        wrote.append((snap.epoch, snap.nbatch))

    monkeypatch.setattr(tck.AsyncSnapshotWriter, "_write", slow_write)
    before = telemetry.counter_total("resilience.checkpoint.async_dropped")
    w = tck.AsyncSnapshotWriter(str(tmp_path / "ck"))
    assert w.submit(tck.Snapshot(0, 0, {}, {}))
    deadline = time.time() + 5
    while not w._busy and time.time() < deadline:
        time.sleep(0.01)
    assert not w.submit(tck.Snapshot(0, 1, {}, {}))
    assert telemetry.counter_total(
        "resilience.checkpoint.async_dropped") == before + 1
    gate.set()
    w.close()
    assert wrote == [(0, 0)]
    assert not w.alive and _no_writer_threads()


def test_writer_error_surfaces_on_fit_exit(tmp_path, monkeypatch):
    def boom(self, snap):
        raise OSError("disk full")

    monkeypatch.setattr(tck.AsyncSnapshotWriter, "_write", boom)
    with pytest.raises(OSError, match="disk full"):
        _toy_fit(str(tmp_path / "ck"), checkpoint_every_n_batches=1)
    assert _no_writer_threads()


# -- options --------------------------------------------------------------------
def test_fit_validates_period_and_cadence(tmp_path):
    with pytest.raises(tmx.MXNetError, match="checkpoint_prefix"):
        _toy_fit(None, checkpoint_every_n_batches=1)
    with pytest.raises(tmx.MXNetError, match=">= 1"):
        _toy_fit(str(tmp_path / "ck"), checkpoint_every_n_batches=0)
    with pytest.raises(tmx.MXNetError, match="checkpoint_period"):
        _toy_fit(str(tmp_path / "ck"), checkpoint_period=0)
    with pytest.raises(tmx.MXNetError, match="needs checkpoint_prefix"):
        _toy_fit(None, resume="auto")
    with pytest.raises(tmx.MXNetError, match="resume must be"):
        _toy_fit(str(tmp_path / "ck"), resume="newest")
    assert _no_writer_threads()


def test_env_cadence(tmp_path, monkeypatch, caplog):
    """``MXNET_CKPT_EVERY_N_BATCHES`` without a prefix is ignored with a
    warning; with one it sets the cadence."""
    monkeypatch.setenv("MXNET_CKPT_EVERY_N_BATCHES", "2")
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "0")
    _toy_fit(None, num_epoch=1)
    assert "MXNET_CKPT_EVERY_N_BATCHES=2 ignored" in caplog.text
    assert _no_writer_threads()
    prefix = str(tmp_path / "ck")
    _toy_fit(prefix, num_epoch=1)
    assert [s["nbatch"] for s in checkpoint_manifest(prefix)["snapshots"]] \
        == [1, 3]


def test_unported_options_raise_naming_them(tmp_path):
    for kw in ({"nan_policy": "raise"}, {"anomaly_policy": "raise"},
               {"audit_every_n_batches": 2}, {"elastic": True},
               {"monitor": object()}, {"nan_check_period": 2}):
        with pytest.raises(tmx.MXNetError,
                           match="%s=.*not ported yet" % next(iter(kw))):
            _toy_fit(str(tmp_path / "ck"), **kw)
    with pytest.raises(tmx.MXNetError, match="kvstore 'dist_sync'"):
        _toy_fit(str(tmp_path / "ck"), kvstore="dist_sync")


def test_numpy_scalar_metric_state_snapshots_cleanly(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "0")

    class NpScalar(tmx.metric.EvalMetric):
        def __init__(self):
            super().__init__("npscalar")

        def update(self, labels, preds):
            self.sum_metric += np.float64(0.5)
            self.num_inst += np.int64(1)

    _toy_fit(str(tmp_path / "ck"), num_epoch=1, eval_metric=NpScalar(),
             checkpoint_every_n_batches=1)
    snaps = checkpoint_manifest(str(tmp_path / "ck"))["snapshots"]
    assert snaps[-1]["metric_state"] == {"sum_metric": 2.0, "num_inst": 4}


def test_big_iter_state_goes_to_sidecar(tmp_path):
    prefix = str(tmp_path / "ck")
    big = {"type": "ImageIter", "cursor": 5, "seq": list(range(200000))}
    tck.write_snapshot(prefix, tck.Snapshot(
        0, 4, {"w": tmx.nd.array(np.ones(3, np.float32))}, {},
        iter_state=big))
    entry = checkpoint_manifest(prefix)["snapshots"][-1]
    assert entry["iter_state"] is None
    assert entry["iter_state_file"].endswith(".iter.json")
    assert os.path.getsize("%s-manifest.json" % prefix) < 4096
    assert tck.load_latest_state(prefix).iter_state == big
    assert tck.latest_generation_summary(prefix) == \
        {"epoch": 0, "nbatch": 4, "kind": "snapshot"}
    _damage(str(tmp_path / entry["iter_state_file"]), "bitflip")
    assert tck.load_latest_state(prefix) is None


def test_discard_snapshots_from_an_epoch(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "0")
    prefix = str(tmp_path / "ck")
    _toy_fit(prefix, checkpoint_every_n_batches=1)
    assert tck.discard_snapshots_from(prefix, 1) == 6  # 3 x params, states
    assert checkpoint_manifest(prefix)["snapshots"] == []
    st = tck.load_latest_state(prefix)
    assert (st.epoch, st.nbatch) == (EPOCHS, None)


def test_random_state_roundtrip():
    tmx.random.seed(5)
    st = json.loads(json.dumps(tmx.random.get_state()))
    a = (tmx.init._default_gen.initial_seed(), np.random.rand(3),
         tmx.nd.zeros((4, 4), tmx.cpu()))
    tmx.init.Xavier()(tmx.init.InitDesc("fc_weight"), a[2])
    tmx.random.set_state(st)
    b = (np.random.rand(3), tmx.nd.zeros((4, 4), tmx.cpu()))
    tmx.init.Xavier()(tmx.init.InitDesc("fc_weight"), b[1])
    np.testing.assert_array_equal(a[1], b[0])
    np.testing.assert_array_equal(a[2].asnumpy(), b[1].asnumpy())
    assert tmx.random.get_seed() == 5


def test_bucketing_fit_snapshots_and_resumes_at_the_epoch_boundary(
        tmp_path, caplog):
    """``BucketingModule`` goes through the same code: its snapshot takes
    copies of ``get_params``; ``BucketSentenceIter`` has no state
    protocol, so resume restarts the snapshot's epoch (with a warning)."""
    from mxnet_tpu_torch.models import lstm_lm

    def fit(prefix, callbacks=None, resume=None):
        np.random.seed(3)
        it = tmx.rnn.BucketSentenceIter(
            lstm_lm.synth_corpus(60, 30, seed=4, buckets=(5, 10)), 4,
            buckets=[5, 10], invalid_label=0, layout="TN")
        mod = tmx.mod.BucketingModule(
            lstm_lm.make_sym_gen(lstm_lm.build_cell(8, 1), 30, 8, 8),
            default_bucket_key=10, context=tmx.cpu())
        tmx.random.seed(2)
        mod.fit(it, eval_metric=tmx.metric.Perplexity(0), num_epoch=1,
                optimizer_params={"learning_rate": 0.1},
                initializer=tmx.init.Xavier(), checkpoint_prefix=prefix,
                checkpoint_every_n_batches=2, batch_end_callback=callbacks,
                resume=resume)
        return mod

    prefix = str(tmp_path / "lm")
    with pytest.raises(tck.TrainingPreempted) as err:
        fit(prefix, callbacks=_kill_at(3))
    assert "no iterator-state protocol" in caplog.text
    st = tck.load_latest_state(prefix)
    assert (st.epoch, st.nbatch) == (0, err.value.nbatch)
    assert st.iter_state is None and st.states_bytes is None
    params_before = {k: v.asnumpy() for k, v in st.arg_params.items()}
    trace = []
    fit(prefix, callbacks=lambda p: trace.append(p.nbatch), resume="auto")
    assert "restarting epoch 0 from batch 0" in caplog.text
    assert trace[0] == 0
    assert params_before  # the snapshot held the trained parameters
