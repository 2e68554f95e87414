"""The port's fleet panels at full size on the port's PySim against the
reference's checked-in results (``results/{fleet_scale,net_scale,
stall_attribution,migration}.json``, written by full-size runs of the
reference's panels): every modelled number equal, tolerance 0.  The same
comparison ``chip_smoke.py``'s ``fleet_panels`` phase makes on the card.
The panels write into a temporary directory."""
import importlib
import json
from pathlib import Path

import pytest

from repro_torch import bench
from repro_torch.bench import panels

RESULTS = Path(__file__).resolve().parent.parent / "results"


@pytest.mark.parametrize("name", bench.FLEET_PANELS)
def test_fleet_twin_at_full_size_equals_the_checked_in_file(name, tmp_path):
    with open(RESULTS / f"{name}.json") as fh:
        want = json.load(fh)
    assert want["quick"] is False
    twin = importlib.import_module(f"repro_torch.bench.{name}")
    got = twin.run(quick=False, target="pysim", out_dir=str(tmp_path))
    assert panels.differences(got, want) == []
    assert panels.check_against([str(tmp_path / f"torch_{name}.json")],
                                str(RESULTS)) == 0


def test_a_changed_modelled_number_fails_the_comparison(tmp_path):
    """The comparison's planted fault: one tick more in one row of the
    checked-in file is found, and ``--against`` on a file of the same
    name exits 1."""
    with open(RESULTS / "net_scale.json") as fh:
        want = json.load(fh)
    bad = json.loads(json.dumps(want))
    bad["pacing"]["auto"]["round_waits"][0] += 1
    assert panels.differences(bad, want) == [
        ".pacing.auto.round_waits[0]: "
        f"{bad['pacing']['auto']['round_waits'][0]} != "
        f"{want['pacing']['auto']['round_waits'][0]}"]
    mine = panels.save_json("net_scale", bad, "pysim", False,
                            str(tmp_path / "mine"))
    (tmp_path / "theirs").mkdir()
    (tmp_path / "theirs" / "torch_net_scale.json").write_text(
        json.dumps(want))
    assert panels.check_against([mine], str(tmp_path / "theirs")) == 1
