"""Train-mode BatchNorm of the PyTorch port against the JAX package.

* The plain versions of kernels K1/K2 (``mxnet_tpu_torch.ops.bn_kernel``,
  reached through its autograd Function on the CPU) against the JAX
  package's ``bn_pallas.bn_train``, whose Pallas kernels run in interpret
  mode on the CPU, and its ``jax.vjp``: y, mean, var, dx, dgamma, dbeta.
* The ``BatchNorm`` op through both packages' executors with
  ``is_train=True`` (the port's BN->ReLU peephole included): outputs,
  every gradient and the moving statistics.
* Inference mode, ``use_global_stats`` and ``output_mean_var``.

Inputs are made by numpy from a seed.  f32 throughout.  Tolerance
``rtol=1e-4, atol=1e-5``: the sums run in another order (pairwise in
torch, a sequential grid in the JAX kernel, XLA's own in its executor),
the JAX kernel's statistics take two passes where the port, like the JAX
executor, takes a shifted single pass, and ``rsqrt`` is not rounded like
``1 / sqrt``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import bn_pallas
from mxnet_tpu.ops.registry import get as jget
from mxnet_tpu_torch.ops import bn_kernel
from mxnet_tpu_torch.ops.registry import get as tget

RTOL, ATOL = 1e-4, 1e-5


def _inputs(shape, seed, scale=1.0, offset=0.0):
    rs = np.random.RandomState(seed)
    c = shape[1]
    x = (rs.normal(0, 1, shape) * scale + offset).astype(np.float32)
    gamma = rs.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rs.normal(0, 0.5, c).astype(np.float32)
    gy = rs.normal(0, 1, shape).astype(np.float32)
    return x, gamma, beta, gy


# the shapes of tests/test_bn_pallas.py plus raw-pixel-like input (mean
# >> std, as bn_data sees); each passes the JAX kernel's _admissible gate
CASES = [
    ((8, 6, 5, 7), False, True, 1.0, 0.0),     # odd spatial, fused ReLU
    ((8, 16, 4, 4), True, True, 1.0, 0.0),     # fix_gamma
    ((8, 12), False, False, 1.0, 0.0),         # 2D
    ((4, 8, 3, 2, 2), False, True, 1.0, 0.0),  # 5D
    ((4, 3, 16, 16), True, False, 50.0, 120.0),  # raw pixels, bn_data
]


@pytest.mark.parametrize("shape,fix_gamma,relu,scale,offset", CASES)
def test_plain_kernels_match_jax_bn_train(shape, fix_gamma, relu, scale,
                                          offset):
    x, gamma, beta, gy = _inputs(shape, 0, scale, offset)
    eps = 1e-3
    assert bn_pallas._admissible(shape[0], shape[1],
                                 int(np.prod(shape[2:])), 4) is not None

    def jf(x_, g_, b_):
        return bn_pallas.bn_train(x_, g_, b_, eps, fix_gamma, relu=relu)

    (jy, jmean, jvar), vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(gamma),
                                     jnp.asarray(beta))
    c = shape[1]
    jdx, jdg, jdb = vjp((jnp.asarray(gy), jnp.zeros(c), jnp.zeros(c)))

    tx = torch.from_numpy(x).requires_grad_(True)
    tg = torch.from_numpy(gamma).requires_grad_(True)
    tb = torch.from_numpy(beta).requires_grad_(True)
    ty, tmean, tvar = bn_kernel.bn_train(tx, tg, tb, eps, fix_gamma, relu)
    tdx, tdg, tdb = torch.autograd.grad(ty, (tx, tg, tb),
                                        torch.from_numpy(gy))
    for name, t, j in (("y", ty, jy), ("mean", tmean, jmean),
                       ("var", tvar, jvar), ("dx", tdx, jdx),
                       ("dgamma", tdg, jdg), ("dbeta", tdb, jdb)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    if fix_gamma:
        assert not tdg.any()


def test_plain_backward_recomputes_the_forward_relu_mask():
    """K2's plain version masks exactly where K1's plain version clamped:
    the mask comes from the same rounded expression and saved stats."""
    x, gamma, beta, gy = _inputs((6, 5, 9, 3), 3)
    tx, tg, tb = map(torch.from_numpy, (x, gamma, beta))
    y, mean, var = bn_kernel.bn_fwd_plain(tx, tg, tb, 1e-3, False, True)
    dx, _dg, dbeta = bn_kernel.bn_bwd_plain(
        tx, torch.from_numpy(gy), mean, var, tg, tb, 1e-3, False, True)
    masked = (y == 0).numpy()
    want = np.where(masked, 0, gy).sum(axis=(0, 2, 3))
    np.testing.assert_allclose(dbeta.numpy(), want, rtol=1e-5, atol=1e-5)


def _net(mx, relu, two_consumers=False, **bn_kw):
    data = mx.sym.Variable("data")
    h = mx.sym.BatchNorm(data, name="bn", **bn_kw)
    if relu:
        a = mx.sym.Activation(h, act_type="relu", name="act")
        # a second consumer of the BN output keeps the peephole off
        h = a + h if two_consumers else a
    h = mx.sym.Flatten(h)
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(h, num_hidden=3, name="fc"), name="softmax")


def _run_executor(mx, net, shape, is_train, seed=0):
    rs = np.random.RandomState(seed)
    ex = net.simple_bind(mx.cpu(), grad_req="write", data=shape,
                         softmax_label=(shape[0],))
    for n in sorted(ex.arg_dict):
        if n == "data":
            ex.arg_dict[n][:] = rs.uniform(0, 3, shape).astype(np.float32)
        elif n == "softmax_label":
            ex.arg_dict[n][:] = rs.randint(0, 3, shape[0]).astype(
                np.float32)
        else:
            ex.arg_dict[n][:] = rs.normal(
                1.0 if n.endswith("gamma") else 0.0, 0.5,
                ex.arg_dict[n].shape).astype(np.float32)
    ex.aux_dict["bn_moving_mean"][:] = rs.normal(0, 1, shape[1]).astype(
        np.float32)
    ex.aux_dict["bn_moving_var"][:] = rs.uniform(0.5, 2, shape[1]).astype(
        np.float32)
    out = ex.forward(is_train=is_train)[0].asnumpy()
    res = {"out": out}
    if is_train:
        ex.backward()
        res.update({"g_" + n: g.asnumpy() for n, g in ex.grad_dict.items()
                    if g is not None and n != "softmax_label"})
    res.update({"a_" + n: a.asnumpy() for n, a in ex.aux_dict.items()})
    return res


@pytest.mark.parametrize("shape,kw,relu,two,is_train", [
    ((8, 6, 5, 7), {"fix_gamma": False}, True, False, True),   # peephole
    ((8, 16, 4, 4), {}, True, False, True),    # fix_gamma default, fused
    ((8, 6, 5, 7), {"fix_gamma": False}, True, True, True),    # not fused
    ((8, 12), {"fix_gamma": False, "eps": 2e-5, "momentum": 0.8}, False,
     False, True),
    ((8, 6, 5, 7), {"fix_gamma": False}, True, False, False),  # inference
    ((8, 6, 5, 7), {"fix_gamma": False, "use_global_stats": True}, True,
     False, True),
])
def test_batchnorm_through_both_executors(shape, kw, relu, two, is_train,
                                          monkeypatch):
    calls = []
    real = bn_kernel.bn_train

    def spy(x, gamma, beta, eps, fix_gamma, relu=False):
        calls.append(relu)
        return real(x, gamma, beta, eps, fix_gamma, relu)

    monkeypatch.setattr(bn_kernel, "bn_train", spy)
    want = _run_executor(jmx, _net(jmx, relu, two, **kw), shape, is_train)
    got = _run_executor(tmx, _net(tmx, relu, two, **kw), shape, is_train)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    batch_stats = is_train and not kw.get("use_global_stats")
    # train-mode BN is one kernel call, with the ReLU fused when the
    # activation is the BN's only consumer
    assert calls == ([relu and not two] if batch_stats else [])


@pytest.mark.parametrize("is_train,kw", [
    (True, {"output_mean_var": True}),
    (False, {"output_mean_var": True}),
    (True, {"use_global_stats": True, "fix_gamma": False}),
    (False, {"fix_gamma": False}),
])
def test_batchnorm_op_modes_match_jax(is_train, kw):
    x, gamma, beta, _gy = _inputs((6, 4, 3, 5), 5, 2.0, 1.0)
    rs = np.random.RandomState(6)
    mm = rs.normal(0, 1, 4).astype(np.float32)
    mv = rs.uniform(0.5, 2, 4).astype(np.float32)
    jop, top = jget("BatchNorm"), tget("BatchNorm")
    jouts, jaux = jop.apply(jop.canonicalize_attrs(dict(kw)),
                            [jnp.asarray(a) for a in (x, gamma, beta)],
                            [jnp.asarray(mm), jnp.asarray(mv)], is_train,
                            None)
    touts, taux = top.apply_with_aux(
        top.canonicalize_attrs(dict(kw)),
        [torch.from_numpy(a) for a in (x, gamma, beta)],
        [torch.from_numpy(mm), torch.from_numpy(mv)], is_train)
    assert len(touts) == len(jouts) and (taux is None) == (jaux is None)
    for t, j in zip(touts + (taux or []), list(jouts) + list(jaux or [])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)


def test_kernel_wrappers_route_cpu_tensors_to_the_plain_versions():
    """On the CPU no kernel launches; the counters stay at zero."""
    bn_kernel.bn_fwd_cuda.launches = 0
    bn_kernel.bn_bwd_cuda.launches = 0
    x, gamma, beta, gy = _inputs((4, 3, 5, 5), 1)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _m, _v = bn_kernel.bn_train(tx, torch.from_numpy(gamma),
                                   torch.from_numpy(beta), 1e-3, False, True)
    y.backward(torch.from_numpy(gy))
    assert bn_kernel.bn_fwd_cuda.launches == 0
    assert bn_kernel.bn_bwd_cuda.launches == 0


@pytest.mark.parametrize("make,match", [
    (lambda: (torch.zeros(2, 3, 4, dtype=torch.bfloat16), 3), "float32"),
    (lambda: (torch.zeros(2, 3, 4, 5).transpose(2, 3), 3), "contiguous"),
    (lambda: (torch.zeros(2, 3, 4), 4), "shape"),
    (lambda: (torch.zeros(3), 3), r"\(N, C, ...\)"),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(make, match):
    """The checks run before any launch, so they hold on CPU tensors."""
    x, c = make()
    vec = torch.zeros(c)
    with pytest.raises(tmx.MXNetError, match=match):
        bn_kernel._check_inputs(x, (("gamma", vec), ("beta", vec)))


def test_bn_plan_needs_a_cuda_device():
    """The layout report is of a card; for the CPU it raises before it
    would build the kernels."""
    with pytest.raises(tmx.MXNetError, match="CUDA device"):
        bn_kernel.bn_plan(128, 64, 56 * 56, False, "cpu")


def test_batch_stats_are_exact_on_raw_pixels():
    """The plain BatchNorm's statistics are the float64 ones rounded once
    to f32, bit for bit, on the inputs where two-pass f32 sums went wrong:
    the fourth batch of ``test_torch_preemption.py``'s raw 0-255 pixels
    (``bn_data``; there two-pass f32 sums put the mean two ulps off, and
    the fit left the JAX fit at that step)."""
    rs = np.random.RandomState(5)
    x = rs.uniform(0, 255, (16, 3, 40, 40)).astype(np.float32)[12:16]
    mean, var = bn_kernel.batch_stats(torch.from_numpy(x))
    x64 = x.astype(np.float64)
    np.testing.assert_array_equal(mean.numpy(),
                                  x64.mean(axis=(0, 2, 3)).astype(np.float32))
    np.testing.assert_array_equal(var.numpy(),
                                  x64.var(axis=(0, 2, 3)).astype(np.float32))
    _y, fmean, fvar = bn_kernel.bn_fwd_plain(
        torch.from_numpy(x), torch.ones(3), torch.zeros(3), 2e-5, True)
    assert torch.equal(fmean, mean) and torch.equal(fvar, var)
