"""Training the long-context LM through the PyTorch port, against the JAX
package.

The slice: the flash-attention backward (the port's plain
``flash_attention_bwd_plain`` on the CPU, the counterpart of the JAX
package's ``_flash_bwd_core``; kernel K3b takes its place on the card and
is held against it in ``tests/test_torch_cuda.py``), the training bind of
the attention ops, ``Adam``, ``Module.fit`` of ``build_lm`` with the
example's copy task, and Adam's tuple states through snapshots,
preemption, resume and the ``.states`` files of both packages.  The JAX
side runs on the CPU; data and weights come from numpy seeds and cross
through numpy.

Tolerances: the attention gradients ``rtol=atol=1e-5`` (f32 sums in
another order); the executor gradients of the ops and of ``build_lm``
``rtol=1e-4, atol=1e-5`` (products of several layers); one Adam step
``rtol=1e-6, atol=1e-7`` (the same f32 arithmetic in the same order,
up to the rounding of its constants); the fits ``rtol=1e-4, atol=1e-5``
on parameters and perplexity; states, snapshots and resumes exact.
"""

import importlib.util
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu_torch import checkpoint as tck
from mxnet_tpu_torch.model import checkpoint_manifest
from mxnet_tpu_torch.models import build_lm as t_build_lm
from mxnet_tpu_torch.models import copy_task
from mxnet_tpu_torch.module.base_module import _PreemptGuard
from mxnet_tpu_torch.ops import attention as tatt

from torch_deadline import deadline  # noqa: F401 (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, EMBED, HEADS, SEQ, BATCH = 50, 32, 2, 16, 4
ATT_TOL = dict(rtol=1e-5, atol=1e-5)
FIT_TOL = dict(rtol=1e-4, atol=1e-5)
_ENV = ("MXNET_CKPT_EVERY_N_BATCHES", "MXNET_CKPT_KEEP_LAST",
        "MXNET_CKPT_ASYNC", "MXNET_FUSE_TRAIN_STEP",
        "MXNET_BULK_TRAIN_STEPS", "MXNET_DEVICE_PREFETCH",
        "MXNET_DEVICE_METRIC")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "long_context_train_lm",
        os.path.join(_ROOT, "example", "long-context", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nets():
    with jmx.name.NameManager():
        jnet = _jax_example().build_lm(VOCAB, EMBED, HEADS, SEQ)
    with tmx.name.NameManager():
        tnet = t_build_lm(VOCAB, EMBED, HEADS, SEQ)
    return jnet, tnet


# -- the attention backward ----------------------------------------------------
def _attn_inputs(lq, lk, d, seed):
    rs = np.random.RandomState(seed)
    q, k, v = [rs.normal(0, 1, (2, 3, n, d)).astype(np.float32)
               for n in (lq, lk, lk)]
    do = rs.normal(0, 1, (2, 3, lq, d)).astype(np.float32)
    dlse = rs.normal(0, 1, (2, 3, lq)).astype(np.float32)
    return q, k, v, do, dlse


SHAPES = [(48, 48, 16), (40, 70, 8), (70, 40, 16), (33, 129, 8)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk,d", SHAPES)
def test_plain_backward_matches_jax_vjp(causal, lq, lk, d):
    """``flash_attention_bwd_plain`` against ``jax.vjp`` of the JAX
    package's ``flash_attention`` (out only: no dlse) and of
    ``flash_attention_with_lse`` (a nonzero dlse), at ragged lengths off
    every block (the JAX side in blocks of 16 keys, the port in 32)."""
    q, k, v, do, dlse = _attn_inputs(lq, lk, d, lq + lk + d)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: jatt.flash_attention(
        a, b, c, causal=causal, block_k=16), jq, jk, jv)
    want_out = vjp(jnp.asarray(do))
    _, vjp = jax.vjp(lambda a, b, c: jatt.flash_attention_with_lse(
        a, b, c, causal=causal, block_k=16), jq, jk, jv)
    want_pair = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = tatt.flash_attention_plain(tq, tk, tv, causal, scale)
    for dl, want in ((None, want_out), (dlse, want_pair)):
        got = tatt.flash_attention_bwd_plain(
            tq, tk, tv, out, lse, torch.from_numpy(do),
            None if dl is None else torch.from_numpy(dl), causal, scale,
            block_k=32)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATT_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_takes_the_plain_backward(causal, monkeypatch):
    """On the CPU, autograd through ``flash_attention_with_lse`` calls the
    plain backward once (not autograd of the plain forward), hands it the
    lse cotangent only when lse is used, and matches JAX's gradients."""
    q, k, v, do, dlse = _attn_inputs(40, 56, 16, 3)
    calls = []
    real = tatt.flash_attention_bwd_plain

    def spy(*args, **kw):
        calls.append(args[6] is not None)
        return real(*args, **kw)

    monkeypatch.setattr(tatt, "flash_attention_bwd_plain", spy)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for with_lse in (False, True):
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        out, lse = tatt.flash_attention_with_lse(*leaves, causal=causal)
        if with_lse:
            got = torch.autograd.grad((out, lse), leaves,
                                      (torch.from_numpy(do),
                                       torch.from_numpy(dlse)))
            _, vjp = jax.vjp(lambda a, b, c: jatt.flash_attention_with_lse(
                a, b, c, causal=causal), jq, jk, jv)
            want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
        else:
            got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
            _, vjp = jax.vjp(lambda a, b, c: jatt.flash_attention(
                a, b, c, causal=causal), jq, jk, jv)
            want = vjp(jnp.asarray(do))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATT_TOL)
    assert calls == [False, True]
    assert tatt.flash_attention_bwd_cuda.launches == 0


def test_lse_only_cotangent(monkeypatch):
    """A loss on lse alone: the backward gets a zero ``do`` and the dlse
    term, as ``_flash_pair``'s backward does with a zero out cotangent."""
    q, k, v, _do, dlse = _attn_inputs(24, 24, 8, 5)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    _out, lse = tatt.flash_attention_with_lse(*leaves, causal=True)
    got = torch.autograd.grad(lse, leaves, torch.from_numpy(dlse))
    _, vjp = jax.vjp(lambda a, b, c: jatt.flash_attention_with_lse(
        a, b, c, causal=True)[1], *map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(dlse))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATT_TOL)


# -- the ops through a training bind -------------------------------------------
def _bind_grads(mx, sym, values, out_grad):
    shapes = {k: v.shape for k, v in values.items()}
    ex = sym.simple_bind(mx.cpu(), grad_req="write", **shapes)
    for k, v in values.items():
        ex.arg_dict[k][:] = v
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward(out_grads=[mx.nd.array(out_grad)])
    return out, {k: ex.grad_dict[k].asnumpy() for k in values}


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_op_gradients_match_jax(causal):
    rs = np.random.RandomState(4)
    b, l, e = 2, 20, 32
    values = {"q": rs.normal(0, 1, (b, l, e)), "kv": rs.normal(0, 1, (b, l, e)),
              "w_qkv": rs.normal(0, 0.2, (3 * e, e)),
              "w_out": rs.normal(0, 0.2, (e, e)),
              "b_qkv": rs.normal(0, 0.2, (3 * e,)),
              "b_out": rs.normal(0, 0.2, (e,))}
    values = {k: v.astype(np.float32) for k, v in values.items()}
    head = rs.normal(0, 1, (b, l, e)).astype(np.float32)
    res = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        v = {n: mx.sym.Variable(n) for n in values}
        sym = mx.sym.MultiHeadAttention(
            v["q"], v["kv"], v["w_qkv"], v["w_out"], v["b_qkv"], v["b_out"],
            num_heads=4, causal=causal, name="att")
        res[name] = _bind_grads(mx, sym, values, head)
    np.testing.assert_allclose(res["torch"][0], res["jax"][0], **FIT_TOL)
    for k in values:
        np.testing.assert_allclose(res["torch"][1][k], res["jax"][1][k],
                                   err_msg=k, **FIT_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_op_gradients_match_jax(causal):
    q, k, v, do, _ = _attn_inputs(24, 40, 16, 6)
    values = {"q": q, "k": k, "v": v}
    res = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        sym = mx.sym.FlashAttention(mx.sym.Variable("q"), mx.sym.Variable("k"),
                                    mx.sym.Variable("v"), causal=causal,
                                    name="fa")
        res[name] = _bind_grads(mx, sym, values, do)
    np.testing.assert_allclose(res["torch"][0], res["jax"][0], **ATT_TOL)
    for key in values:
        np.testing.assert_allclose(res["torch"][1][key], res["jax"][1][key],
                                   err_msg=key, **ATT_TOL)


@pytest.fixture(scope="module")
def lm_init():
    """The JAX package's initialization of the small LM (its draws from
    numpy's global generator), as numpy."""
    jnet, _ = _nets()
    mod = jmx.mod.Module(jnet, context=jmx.cpu())
    mod.bind(data_shapes=[("data", (BATCH, SEQ))],
             label_shapes=[("softmax_label", (BATCH, SEQ))])
    np.random.seed(3)
    mod.init_params(jmx.init.Xavier())
    arg, _ = mod.get_params()
    rs = np.random.RandomState(4)
    arg = {k: v.asnumpy() for k, v in arg.items()}
    # biases and the positional table away from 0, so each term shows
    for k in arg:
        if k.endswith("_bias") or k == "pos_weight":
            arg[k] = rs.normal(0, 0.1, arg[k].shape).astype(np.float32)
    return arg


def test_build_lm_training_bind_gradients_match_jax(lm_init):
    """Every parameter gradient of one training bind of ``build_lm``
    (Embedding, broadcast_add, MultiHeadAttention, FullyConnected with
    flatten=False, Reshape, SoftmaxOutput) against the JAX package's."""
    x, y = copy_task(BATCH, SEQ, VOCAB, np.random.RandomState(1))
    res = {}
    for (name, mx), net in zip((("jax", jmx), ("torch", tmx)), _nets()):
        ex = net.simple_bind(mx.cpu(), grad_req="write", data=x.shape,
                             softmax_label=y.shape)
        for k, v in lm_init.items():
            ex.arg_dict[k][:] = v
        ex.arg_dict["data"][:] = x
        ex.arg_dict["softmax_label"][:] = y
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        res[name] = dict(out=out, **{k: ex.grad_dict[k].asnumpy()
                                     for k in lm_init})
    assert sorted(res["torch"]) == sorted(res["jax"])
    for k in res["jax"]:
        assert np.abs(res["jax"][k]).max() > 0, k
        np.testing.assert_allclose(res["torch"][k], res["jax"][k],
                                   err_msg=k, **FIT_TOL)


# -- Adam ---------------------------------------------------------------------
@pytest.mark.parametrize("opts", [
    {},
    {"wd": 1e-3, "rescale_grad": 0.25, "clip_gradient": 0.5},
    {"wd": 1e-4, "beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6,
     "clip_gradient": 2.0, "sched": (2, 0.5)}])
def test_adam_matches_jax_step_by_step(opts):
    """The port's ``Adam`` against the JAX ``Adam`` over five steps of two
    parameters (one with an lr multiplier), with weight decay, gradient
    rescaling, clipping and an lr scheduler."""
    opts = dict(opts)
    rs = np.random.RandomState(2)
    shapes = {0: (6, 5), 1: (7,)}
    w0 = {i: rs.normal(0, 1, s).astype(np.float32) for i, s in shapes.items()}
    grads = [{i: rs.normal(0, 2, s).astype(np.float32)
              for i, s in shapes.items()} for _ in range(5)]
    res = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        kw = dict(opts)
        sched = kw.pop("sched", None)
        if sched is not None:
            kw["lr_scheduler"] = mx.lr_scheduler.FactorScheduler(*sched)
        opt = mx.optimizer.create("adam", learning_rate=0.01,
                                  param_idx2name={0: "a_weight",
                                                  1: "b_bias"}, **kw)
        opt.set_lr_mult({"b_bias": 0.5})
        upd = mx.optimizer.get_updater(opt)
        w = {i: mx.nd.array(v) for i, v in w0.items()}
        trace = []
        for g in grads:
            for i in shapes:
                upd(i, mx.nd.array(g[i]), w[i])
            trace.append({i: w[i].asnumpy().copy() for i in shapes})
        res[name] = (trace, {i: tuple(s.asnumpy() for s in upd.states[i])
                             for i in shapes})
    for step, (tw, jw) in enumerate(zip(res["torch"][0], res["jax"][0])):
        for i in shapes:
            np.testing.assert_allclose(tw[i], jw[i], rtol=1e-6, atol=1e-7,
                                       err_msg="step %d param %d" % (step, i))
    for i in shapes:
        for ts, js in zip(res["torch"][1][i], res["jax"][1][i]):
            np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-7)


def test_adam_is_a_registered_optimizer_with_tuple_states():
    opt = tmx.optimizer.create("adam", learning_rate=0.1)
    assert isinstance(opt, tmx.optimizer.Adam)
    state = opt.create_state(0, tmx.nd.array(np.ones((2, 3), np.float32)))
    assert isinstance(state, tuple) and len(state) == 2
    assert [a.shape for a in tmx.optimizer.state_arrays(state)] == \
        [(2, 3), (2, 3)]
    doubled = tmx.optimizer.map_state(
        lambda a: tmx.nd.NDArray(a._t + 2), [state[0], None])
    assert isinstance(doubled, list) and doubled[1] is None
    np.testing.assert_array_equal(doubled[0].asnumpy(), 2)


# -- Module.fit ---------------------------------------------------------------
def _lm_data(n=3 * BATCH, seed=0):
    return copy_task(n, SEQ, VOCAB, np.random.RandomState(seed))


def _lm_fit(mx, net, params, num_epoch=1):
    x, y = _lm_data()
    it = mx.io.NDArrayIter(x, y, batch_size=BATCH,
                           label_name="softmax_label")
    mod = mx.mod.Module(net, context=mx.cpu())
    metric = mx.metric.Perplexity(ignore_label=None)
    mod.fit(it, num_epoch=num_epoch, optimizer="adam",
            optimizer_params={"learning_rate": 1e-2}, eval_metric=metric,
            arg_params={k: mx.nd.array(v) for k, v in params.items()},
            force_init=True)
    (_, ppl), = metric.get_name_value()
    (_, score), = mod.score(it, mx.metric.Perplexity(ignore_label=None))
    arg, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}, ppl, score, mod


def test_lm_fit_matches_jax(lm_init):
    """``Module.fit`` of the small LM with Adam (the example's lr 1e-2)
    over two epochs of three batches of the copy task, then ``score``:
    parameters and perplexities against the JAX package's."""
    jnet, tnet = _nets()
    jarg, jppl, jscore, _ = _lm_fit(jmx, jnet, lm_init, num_epoch=2)
    targ, tppl, tscore, tmod = _lm_fit(tmx, tnet, lm_init, num_epoch=2)
    assert sorted(targ) == sorted(jarg)
    for k in jarg:
        np.testing.assert_allclose(targ[k], jarg[k], err_msg=k, **FIT_TOL)
    np.testing.assert_allclose(tppl, jppl, **FIT_TOL)
    np.testing.assert_allclose(tscore, jscore, **FIT_TOL)
    assert tscore < VOCAB
    assert all(isinstance(s, tuple) for s in tmod._updater.states.values())


# -- Adam's tuple states through checkpoints -----------------------------------
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_adam_states_files_cross_between_packages(tmp_path, lm_init, writer):
    """A ``.states`` file with Adam's ``(mean, var)`` tuples, written by one
    package's ``fit`` checkpoint and loaded by the other's
    ``Module.load``: the same moments, and the next epoch from them agrees
    with the writer's own next epoch."""
    mxs = {"jax": jmx, "torch": tmx}
    wmx = mxs[writer]
    rmx = mxs["torch" if writer == "jax" else "jax"]
    prefix = str(tmp_path / "lm")
    net = _nets()[0 if writer == "jax" else 1]
    wmod = _lm_fit(wmx, net, lm_init)[3]
    wmod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    with open("%s-0001.states" % prefix, "rb") as f:
        blob = f.read()
    wanted = {i: tuple(a.asnumpy() for a in s)
              for i, s in wmod._updater.states.items()}
    x, y = _lm_data()

    def cont(mx, check_states):
        m = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                               context=mx.cpu())
        it = mx.io.NDArrayIter(x, y, batch_size=BATCH,
                               label_name="softmax_label")
        if check_states:
            m.bind(it.provide_data, it.provide_label)
            m.init_optimizer(optimizer="adam",
                             optimizer_params={"learning_rate": 1e-2})
            assert sorted(m._updater.states) == sorted(wanted)
            for i, s in m._updater.states.items():
                assert isinstance(s, tuple) and len(s) == 2
                for a, w in zip(s, wanted[i]):
                    np.testing.assert_array_equal(a.asnumpy(), w)
        m.fit(it, begin_epoch=1, num_epoch=2, optimizer="adam",
              optimizer_params={"learning_rate": 1e-2}, force_init=False)
        arg, _ = m.get_params()
        return {k: v.asnumpy() for k, v in arg.items()}

    # both packages name the JAX package's NDArray class
    assert b"mxnet_tpu.ndarray" in blob and b"mxnet_tpu_torch" not in blob
    got, want = cont(rmx, True), cont(wmx, False)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **FIT_TOL)


def _moments(mod):
    return {i: tuple(a.asnumpy().copy() for a in s)
            for i, s in mod._updater.states.items()}


def _lm_ck_fit(prefix, params, callbacks=(), resume=None):
    """Two epochs of four batches with Adam and a snapshot every batch;
    returns the module (a preemption raises).  Each callback is called
    with the module and the batch-end parameter."""
    x, y = _lm_data(4 * BATCH, 5)
    mod = tmx.mod.Module(t_build_lm(VOCAB, EMBED, HEADS, SEQ),
                         context=tmx.cpu())
    callbacks = [lambda p, f=f: f(mod, p) for f in callbacks]
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=BATCH,
                               label_name="softmax_label"),
            num_epoch=2, optimizer="adam",
            optimizer_params={"learning_rate": 1e-2},
            eval_metric=tmx.metric.Perplexity(ignore_label=None),
            arg_params=None if params is None else
            {k: tmx.nd.array(v) for k, v in params.items()},
            force_init=params is not None, checkpoint_prefix=prefix,
            checkpoint_every_n_batches=1, batch_end_callback=list(callbacks),
            resume=resume)
    return mod


def _kill_at(hit):
    seen = [0]

    def cb(_mod, _param):
        seen[0] += 1
        if seen[0] == hit:
            assert threading.current_thread() is threading.main_thread()
            assert isinstance(signal.getsignal(signal.SIGTERM),
                              _PreemptGuard)
            signal.raise_signal(signal.SIGTERM)
    return cb


def _arrays(mod):
    arg, _ = mod.get_params()
    out = {k: v.asnumpy() for k, v in arg.items()}
    for i, s in _moments(mod).items():
        out["mean:%d" % i], out["var:%d" % i] = s
    return out


@pytest.mark.parametrize("kill_at", [2, 5])
def test_preempted_adam_fit_resumes_bit_identical(tmp_path, lm_init,
                                                  kill_at):
    """A SIGTERM at batch ``kill_at`` of a ``fit`` with Adam and a
    snapshot every batch, then ``resume="auto"``: the parameters and both
    moments of every parameter equal the uninterrupted fit's bit for
    bit, and the preempted generation's states file holds the moments of
    its own batch."""
    ref = _arrays(_lm_ck_fit(str(tmp_path / "ref"), lm_init))
    prefix = str(tmp_path / "victim")
    mods = []
    with pytest.raises(tck.TrainingPreempted) as err:
        _lm_ck_fit(prefix, lm_init, [_kill_at(kill_at),
                                     lambda m, p: mods.append(_moments(m))])
    snap = checkpoint_manifest(prefix)["snapshots"][-1]
    assert (snap["epoch"], snap["nbatch"]) == (err.value.epoch,
                                               err.value.nbatch)
    with open(os.path.join(str(tmp_path), snap["states"]), "rb") as f:
        states = tmx.optimizer.load_states(f.read())
    # the generation holds the moments of its own batch, the last one run
    assert sorted(states) == sorted(mods[-1])
    for i, st in states.items():
        assert isinstance(st, tuple)
        for a, w in zip(st, mods[-1][i]):
            np.testing.assert_array_equal(a.asnumpy(), w)
    got = _arrays(_lm_ck_fit(prefix, None, resume="auto"))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_async_snapshot_holds_the_moments_of_its_batch(tmp_path, lm_init,
                                                       monkeypatch):
    """The writer thread writes a generation only after the next step has
    updated the live moments: every generation's states still equal the
    moments at its own batch end (the capture copies each array of
    Adam's tuples, not the live tuple)."""
    monkeypatch.setenv("MXNET_CKPT_KEEP_LAST", "50")
    at_batch = {}
    ends = [0]
    fit_done = threading.Event()

    def record(mod, param):
        at_batch[(param.epoch, param.nbatch)] = _moments(mod)
        ends[0] += 1

    real = tck.write_snapshot

    def late_write(prefix, snap, **kw):
        # wait for the next batch end: its update has run by then
        seen = ends[0]
        deadline = time.time() + 1.0
        while ends[0] == seen and not fit_done.is_set() \
                and time.time() < deadline:
            time.sleep(0.002)
        return real(prefix, snap, **kw)

    monkeypatch.setattr(tck, "write_snapshot", late_write)
    prefix = str(tmp_path / "ck")
    try:
        _lm_ck_fit(prefix, lm_init, [record])
    finally:
        fit_done.set()
    snaps = checkpoint_manifest(prefix)["snapshots"]
    written = [(s["epoch"], s["nbatch"]) for s in snaps]
    assert written and written[0] == (0, 0)
    for s in snaps:
        with open(os.path.join(str(tmp_path), s["states"]), "rb") as f:
            states = tmx.optimizer.load_states(f.read())
        want = at_batch[(s["epoch"], s["nbatch"])]
        assert sorted(states) == sorted(want)
        for i, st in states.items():
            for a, w in zip(st, want[i]):
                np.testing.assert_array_equal(a.asnumpy(), w)


@pytest.mark.parametrize("bad,match", [
    ("do", "do must be"), ("lse", "lse must be"), ("dlse", "dlse must be"),
    ("head_dim", "head_dim"), ("dtype", "float32"),
    ("out", "contiguous last dim")])
def test_k3b_wrapper_checks_before_any_launch(bad, match):
    """The K3b wrapper's checks run before the kernel is built or
    launched, so they hold on CPU tensors here."""
    d = 160 if bad == "head_dim" else 16
    dt = torch.float64 if bad == "dtype" else torch.float32
    q = torch.zeros((1, 2, 8, d), dtype=dt)
    lse = torch.zeros((1, 2, 8))
    do = q[:, :, :4] if bad == "do" else q
    if bad == "lse":
        lse = lse[:, :1]
    dlse = lse[..., :3] if bad == "dlse" else None
    out = torch.zeros((1, 2, d, 8)).transpose(-1, -2) if bad == "out" else q
    with pytest.raises(tmx.MXNetError, match=match):
        tatt.flash_attention_bwd_cuda(q, q, q, out, lse, do, dlse, True,
                                      0.25)
