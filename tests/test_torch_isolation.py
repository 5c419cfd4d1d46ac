"""The PyTorch port stands alone: it imports neither JAX nor
``mxnet_tpu``, and its entry points run on the card or raise."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import build_lm
from mxnet_tpu_torch.ops import attention as tatt

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _forbidden(module):
    """Exact package match: ``mxnet_tpu`` is a prefix of ``mxnet_tpu_torch``."""
    return module.split(".")[0] in _FORBIDDEN


def test_import_loads_no_jax_and_no_mxnet_tpu():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serving, "
            "mxnet_tpu_torch.models, mxnet_tpu_torch.io, "
            "mxnet_tpu_torch.metric, mxnet_tpu_torch.executor, "
            "mxnet_tpu_torch.module.module, "
            "mxnet_tpu_torch.module.base_module, "
            "mxnet_tpu_torch.checkpoint, mxnet_tpu_torch.random, "
            "mxnet_tpu_torch.rnn.rnn, mxnet_tpu_torch.models.inception_v3, "
            "mxnet_tpu_torch.models.lenet, mxnet_tpu_torch.models.mlp, "
            "mxnet_tpu_torch.optimizer, mxnet_tpu_torch.initializer, "
            "mxnet_tpu_torch.models.transformer_lm, "
            "mxnet_tpu_torch.serving.kvblocks, "
            "mxnet_tpu_torch.serving.decode, mxnet_tpu_torch.serving.pool, "
            "mxnet_tpu_torch.serving.frontend, mxnet_tpu_torch.faults, "
            "mxnet_tpu_torch.serving.controller, "
            "mxnet_tpu_torch.serving.batcher, "
            "mxnet_tpu_torch.serving.registry, "
            "mxnet_tpu_torch.rnn.rnn_cell, mxnet_tpu_torch.models.lstm_lm, "
            "mxnet_tpu_torch.module.sequential_module, "
            "mxnet_tpu_torch.module.python_module, "
            "mxnet_tpu_torch.ops.contrib, mxnet_tpu_torch.ops.nms_kernel, "
            "mxnet_tpu_torch.models.ssd_vgg16, "
            "mxnet_tpu_torch.models.ssd_detect, mxnet_tpu_torch.models.vgg, "
            "mxnet_tpu_torch.models.googlenet, "
            "mxnet_tpu_torch.models.inception_bn, "
            "mxnet_tpu_torch.models.alexnet, mxnet_tpu_torch.models.rcnn, "
            "mxnet_tpu_torch.models.inception_resnet_v2, "
            "mxnet_tpu_torch.ops.spatial, "
            "mxnet_tpu_torch.ops.roi_pool_kernel\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in %r)\n"
            "print(bad)\nsys.exit(1 if bad else 0)" % (_FORBIDDEN,))
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _py_files():
    pkg = os.path.join(_ROOT, "mxnet_tpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(_ROOT, "chip_smoke.py")
    yield os.path.join(_ROOT, "chip_lstm_costs.py")
    yield os.path.join(_ROOT, "chip_bn_costs.py")
    yield os.path.join(_ROOT, "chip_sync_free_runs.py")
    yield os.path.join(_ROOT, "chip_k8_costs.py")


def test_sources_import_no_jax_and_no_mxnet_tpu():
    found = []
    for path in _py_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += ["%s: %s" % (path, n) for n in names if _forbidden(n)]
    assert not found


def _tiny():
    net = build_lm(20, 8, 2, 4)
    shapes, _, _ = net.infer_shape(data=(1, 4))
    params = {n: np.zeros(s, np.float32)
              for n, s in zip(net.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    return net, mx.nd.save_bytes(params)


def test_entry_points_default_to_the_card_and_raise_without_one(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net, blob = _tiny()
    with pytest.raises(mx.MXNetError, match="CUDA"):
        mx.Predictor(net.tojson(), blob, {"data": (1, 4)})
    with pytest.raises(mx.MXNetError, match="CUDA"):
        net.simple_bind(data=(1, 4))
    mx.serving.save_model(str(tmp_path), net, blob, (4,), buckets=(1,))
    with pytest.raises(mx.MXNetError, match="CUDA"):
        mx.serving.ModelRegistry().load_dir(str(tmp_path))
    with pytest.raises(mx.MXNetError, match="CUDA"):
        mx.serving.ServedModel("m", net.tojson(), blob, (4,), buckets=(1,))
    tlm = mx.models.transformer_lm
    cfg = tlm.LMConfig(16, 8, 2, 1, 8, 16, 16)
    with pytest.raises(mx.MXNetError, match="CUDA"):
        mx.serving.DecodeEngine(cfg, tlm.init_params(cfg), slots=1,
                                prefill_buckets=(4,))
    with pytest.raises(mx.MXNetError, match="CUDA"):
        mx.serving.lm_pool(cfg, tlm.init_params(cfg), n_replicas=1,
                           engine_opts={"slots": 1,
                                        "prefill_buckets": (4,)})
    assert mx.gpu(0).device_type == "gpu" and mx.current_context() == mx.cpu()


def test_rnn_toolkit_entry_points_default_to_the_card(monkeypatch):
    """The unfused LM's ``BucketingModule`` and a ``SequentialModule``'s
    ``Module`` stage default to the card and raise without one; the
    unfused cells' graphs bind on the card by default too."""
    from mxnet_tpu_torch.models import lstm_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sym_gen = lstm_lm.make_sym_gen(lstm_lm.build_stack(4, 2), 10, 4, 4,
                                   layout="NTC")
    with pytest.raises(mx.MXNetError, match="CUDA"):
        mx.mod.BucketingModule(sym_gen, default_bucket_key=5)
    with pytest.raises(mx.MXNetError, match="CUDA"):
        mx.mod.SequentialModule().add(mx.mod.Module(
            mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=2)))
    out, _ = mx.rnn.GRUCell(3).unroll(2, mx.sym.Variable("x"),
                                      merge_outputs=True)
    with pytest.raises(mx.MXNetError, match="CUDA"):
        out.simple_bind(x=(2, 2, 3))


def test_ssd_and_classic_model_entry_points_default_to_the_card(
        monkeypatch, tmp_path):
    """SSD's training ``Module``, its ``Detector`` over the deploy graph,
    the deploy graph's executor and the classic models' ``Module`` default
    to the card and raise without one; K7's wrapper raises on a CPU
    tensor, and the routed NMS takes the plain version there."""
    from mxnet_tpu_torch.models import ssd_detect, ssd_vgg16
    from mxnet_tpu_torch.ops import nms_kernel

    train = ssd_vgg16.get_symbol_train(num_classes=2)
    prefix = str(tmp_path / "ssd")
    mx.model.save_checkpoint(prefix, 1, train, {}, {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mx.MXNetError, match="CUDA"):
        mx.mod.Module(train, label_names=("label",))
    deploy = ssd_vgg16.get_symbol(num_classes=2)
    with pytest.raises(mx.MXNetError, match="CUDA"):
        ssd_detect.Detector(deploy, prefix, 1, 64, (0, 0, 0))
    with pytest.raises(mx.MXNetError, match="CUDA"):
        deploy.simple_bind(data=(1, 3, 64, 64))
    for network in ("alexnet", "vgg", "googlenet", "inception-bn"):
        with pytest.raises(mx.MXNetError, match="CUDA"):
            mx.mod.Module(mx.models.get_symbol(network, num_classes=4))
    boxes = torch.zeros((1, 3, 4))
    with pytest.raises(mx.MXNetError, match="CUDA"):
        nms_kernel.greedy_nms_cuda(boxes, torch.zeros(1, 3),
                                   torch.arange(3)[None], 0.5, True)
    assert nms_kernel.greedy_nms_cuda.launches == 0


@pytest.mark.parametrize("boxes,cls,order,match", [
    ((2, 5, 3), (2, 5), (2, 5), r"\(B, A, 4\)"),
    ((2, 5, 4), (2, 4), (2, 5), "must be"),
    ((2, 5, 4), (2, 5), (5,), "must be"),
    ((0, 5, 4), (0, 5), (0, 5), "no boxes"),
])
def test_nms_wrapper_rejects_what_k7_does_not_take(boxes, cls, order, match):
    from mxnet_tpu_torch.ops import nms_kernel

    with pytest.raises(mx.MXNetError, match=match):
        nms_kernel._check_inputs(torch.zeros(boxes), torch.zeros(cls),
                                 torch.zeros(order, dtype=torch.int32))
    with pytest.raises(mx.MXNetError, match="float32"):
        nms_kernel._check_inputs(torch.zeros((1, 2, 4), dtype=torch.float64),
                                 torch.zeros(1, 2), torch.zeros(1, 2))


def test_cpu_path_leaves_the_kernel_count_at_zero():
    tatt.flash_attention_cuda.launches = 0
    net, blob = _tiny()
    pred = mx.Predictor(net.tojson(), blob, {"data": (2, 4)}, ctx=mx.cpu())
    pred.set_input("data", np.ones((2, 4), np.float32))
    pred.forward()
    assert pred.get_output(0).shape == (8, 20)
    assert tatt.flash_attention_cuda.launches == 0


def test_kernel_source_and_loader_are_lazy():
    """Importing the package builds nothing; the kernel source is there
    for the loader."""
    from mxnet_tpu_torch import _kernels

    assert _kernels._libs == {}
    for src in _kernels.SOURCES.values():
        assert os.path.exists(os.path.join(_kernels.CSRC, src))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from mxnet_tpu_torch import _kernels

    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(_kernels.os.path, "exists", lambda path: False)
    with pytest.raises(mx.MXNetError, match="nvcc not found"):
        _kernels.build_all()


def test_variant_build_without_nvcc_raises_and_loads_nothing(monkeypatch,
                                                             tmp_path):
    """The card scripts' builds of kernel variants need ``nvcc`` as the
    port's own kernels do; the source is written, no library appears."""
    from mxnet_tpu_torch import _kernels

    monkeypatch.setattr(_kernels, "BUILD_DIR",
                        str(tmp_path / "mxnet_tpu_torch"))
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(_kernels.os.path, "exists", lambda path: False)
    with pytest.raises(mx.MXNetError, match="nvcc not found"):
        _kernels.build_variants("variants", [("as built", "// empty\n")])
    assert (tmp_path / "variants" / "v0.cu").read_text() == "// empty\n"
    assert not list((tmp_path / "variants").glob("*.so*"))


@pytest.mark.parametrize("shapes,dtype,match", [
    (((1, 2, 8, 160),) * 3, torch.float32, "head_dim"),
    (((1, 2, 8, 64),) * 3, torch.float16, "float32"),
    (((1, 2, 8, 64), (1, 2, 9, 64), (1, 2, 10, 64)), torch.float32,
     "disagree"),
    (((1, 2, 8, 64), (1, 3, 8, 64), (1, 3, 8, 64)), torch.float32,
     "disagree"),
    (((2, 8, 64),) * 3, torch.float32, r"\(B, H, L, D\)"),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(
        shapes, dtype, match):
    """The checks run before any launch, so they hold on CPU tensors."""
    ts = [torch.zeros(s, dtype=dtype) for s in shapes]
    with pytest.raises(mx.MXNetError, match=match):
        tatt._check_cuda_inputs(*ts)


def test_rcnn_entry_points_default_to_the_card(monkeypatch):
    """Faster R-CNN's ``Module`` over each of its three graphs and the
    Inception-ResNet-v2 ``Module`` default to the card and raise without
    one; K8's and K8b's wrappers raise on CPU tensors, and the routed ROI
    pooling takes the plain versions there without counting a launch."""
    from mxnet_tpu_torch.models import rcnn
    from mxnet_tpu_torch.ops import roi_pool_kernel as rk

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for net in (rcnn.get_symbol_rpn(), rcnn.get_symbol_train(),
                rcnn.get_symbol_test(),
                mx.models.get_symbol("inception-resnet-v2", num_classes=4)):
        with pytest.raises(mx.MXNetError, match="CUDA"):
            mx.mod.Module(net)
    x = torch.ones((1, 2, 4, 4))
    rois = torch.tensor([[0.0, 0, 0, 48, 48]])
    with pytest.raises(mx.MXNetError, match="CUDA"):
        rk.roi_pool_fwd_cuda(x, rois, (2, 2), 1 / 16.0)
    out, _bounds, xt = rk.roi_pool_fwd_plain(x, rois, (2, 2), 1 / 16.0)
    with pytest.raises(mx.MXNetError, match="CUDA"):
        rk.roi_pool_bwd_cuda(xt, torch.zeros(9, dtype=torch.int32),
                             torch.ones_like(out), (2, 2))
    before = (rk.roi_pool_fwd_cuda.launches, rk.roi_pool_bwd_cuda.launches)
    assert torch.equal(rk.roi_pool(x, rois, (2, 2), 1 / 16.0), out)
    assert (rk.roi_pool_fwd_cuda.launches,
            rk.roi_pool_bwd_cuda.launches) == before
