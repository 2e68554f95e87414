"""The port's dry run held against the reference's on one cut cell:
qwen3-8b ``train_4k`` at its production widths and shapes, cut to one
layer, on each production mesh.  The reference is ``repro.launch.dryrun``
on XLA:CPU in an interpreter of its own (``tests/torch_dryrun_reference.py``);
the port is ``repro_torch.launch.dryrun`` on ``meta`` tensors.  The two
give the same argument bytes a device, and the port's peak a device stays
within 1.5x of the reference's.  Needs ``jax`` (skipped without it);
about 15 s a mesh."""
import importlib.util
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

HELPER = Path(__file__).resolve().parent / "torch_dryrun_reference.py"


def helper():
    spec = importlib.util.spec_from_file_location("torch_dryrun_reference",
                                                  HELPER)
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault(spec.name, mod)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_port_peak_is_within_1_5x_of_the_reference(multi_pod):
    R = helper()
    ref = R.reference_cell("qwen3-8b", "train_4k", multi_pod, 1)
    port = R.port_cell("qwen3-8b", "train_4k", multi_pod, 1, "meta")
    assert port["status"] == ref["status"] == "OK"
    line = R.row(port, ref)
    assert port["per_device"]["argument_bytes"] == \
        ref["per_device"]["argument_bytes"] > 0
    assert 0 < line["peak_ratio"] <= 1.5, line
