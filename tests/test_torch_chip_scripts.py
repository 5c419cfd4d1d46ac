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
