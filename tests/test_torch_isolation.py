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
            "mxnet_tpu_torch.module.base_module\n"
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
    assert mx.gpu(0).device_type == "gpu" and mx.current_context() == mx.cpu()


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
