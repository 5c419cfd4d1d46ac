"""What the card scripts at the repository root compute without a card:
their source edits and their sums.  ``chip_smoke.py``,
``chip_bn_costs.py`` and ``chip_lstm_costs.py`` run only on an NVIDIA
card; these checks keep the parts that do not need one from failing
there first."""

import importlib.util
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_ROOT, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _edits(name):
    mod = _script(name)
    src = "batch_norm.cu" if name == "chip_bn_costs" else "lstm.cu"
    edits = [(v, e) for v, es in mod.VARIANTS.items() for e in es]
    edits += [("every variant", e) for e in getattr(mod, "SMID", [])]
    return src, edits


@pytest.mark.parametrize("name", ["chip_bn_costs", "chip_lstm_costs"])
def test_variant_edits_match_the_kernel_source_once(name):
    """Each variant is the committed source with edits that must each
    match exactly once, or the script stops before it times anything."""
    src, edits = _edits(name)
    with open(os.path.join(_ROOT, "mxnet_tpu_torch", "csrc", src)) as f:
        text = f.read()
    bad = [(variant, old) for variant, (old, _new) in edits
           if text.count(old) != 1]
    assert not bad


def test_bn_step_total_weights_rows_and_leaves_unmeasured_out():
    smoke = _script("chip_smoke")
    rows = [dict(shape=(128, 3, 224, 224), count=1, ms=2.0, parent_ms=None),
            dict(shape=(128, 64, 56, 56), count=7, ms=0.5, parent_ms=None)]
    assert smoke.bn_step_total(rows, "ms") == 2.0 + 7 * 0.5
    assert smoke.bn_step_total(rows, "ms", lambda r: r["shape"][1] != 3) \
        == 7 * 0.5
    assert smoke.bn_step_total(rows, "parent_ms") is None


def _event(name, start, end, device="CUDA"):
    from types import SimpleNamespace as NS

    return NS(name=name, device_type=NS(name=device),
              time_range=NS(start=start, end=end))


def test_device_timeline_merges_kernels_and_measures_copies_under_them():
    """Kernels at 0-100 and 50-150 us and 300-400 us: busy 250 of a 400 us
    span; a 1 ms-sized copy at 100-350 us runs under kernels for 100 us
    of its 250; small copies, memsets and host events do not count."""
    from types import SimpleNamespace as NS

    smoke = _script("chip_smoke")
    events = [_event("k1", 0, 100), _event("k2", 50, 150),
              _event("k3", 300, 400),
              _event("Memcpy HtoD (Pinned -> Device)", 100, 350),
              _event("Memcpy HtoD (Pinned -> Device)", 10, 12),
              _event("Memset (Device)", 150, 300),
              _event("aten::copy_", 0, 1000, device="CPU")]
    tl = smoke._device_timeline(NS(events=lambda: events))
    assert tl["span"] == 0.4 and tl["busy"] == 0.25
    assert tl["idle"] == 1 - 250 / 400
    assert tl["copies"] == 1 and tl["copy_ms"] == 0.25
    assert tl["covered"] == 100 / 250
    assert smoke._device_timeline(NS(events=lambda: events[3:])) is None


def test_environment_sets_and_restores(monkeypatch):
    import os

    smoke = _script("chip_smoke")
    monkeypatch.setenv("MXNET_FUSE_TRAIN_STEP", "0")
    monkeypatch.delenv("MXNET_BULK_TRAIN_STEPS", raising=False)
    with pytest.raises(KeyError):
        with smoke.environment(smoke.SYNC_FREE_ENV):
            assert os.environ["MXNET_FUSE_TRAIN_STEP"] == "1"
            assert os.environ["MXNET_BULK_TRAIN_STEPS"] == "2"
            raise KeyError
    assert os.environ["MXNET_FUSE_TRAIN_STEP"] == "0"
    assert "MXNET_BULK_TRAIN_STEPS" not in os.environ
