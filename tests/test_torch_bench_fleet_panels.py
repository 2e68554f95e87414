"""The port's fleet panels (``repro_torch.bench``: fleet_scale, net_scale,
stall_attribution, migration) against the reference's panels
(``benchmarks/*.py``), on the CPU: each twin at ``quick`` on the port's
PySim equals the reference panel's ``run(quick=True)`` on every modelled
field (tolerance 0; only wall seconds are left out), with both panels
writing their files into a temporary directory, never over the
checked-in ``results/``.  migration's serving panel runs the port's own
seeded ``qwen3-8b.smoke()``: at the panels' sizes no request emits its
eos early, so the reference's serve fault (its requests outside slot 0
decode token 0) reaches no field the panel records.  The two identity
rows (a 1-board UART fleet against a plain async runtime) also run on
``TorchTarget(device="cpu")`` boards."""
import importlib
import json

import pytest

from repro_torch import bench
from repro_torch.bench import fleet_scale, migration, panels


def test_the_fleet_panels_are_registered():
    assert bench.FLEET_PANELS == ("fleet_scale", "net_scale",
                                  "stall_attribution", "migration")
    assert set(bench.FLEET_PANELS) <= set(bench.SCRIPTS)
    assert not set(bench.FLEET_PANELS) & set(bench.PANELS)
    bench.audit()


@pytest.mark.parametrize("name", bench.FLEET_PANELS)
def test_fleet_twin_on_pysim_equals_the_reference_panel(name, tmp_path,
                                                        monkeypatch):
    import benchmarks.common as common
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path / "reference"))
    reference = importlib.import_module(f"benchmarks.{name}")
    twin = importlib.import_module(f"repro_torch.bench.{name}")
    want = reference.run(quick=True)
    got = twin.run(quick=True, target="pysim", out_dir=str(tmp_path))
    assert panels.differences(got, want) == []
    assert panels.modelled(got) == panels.modelled(want)
    with open(tmp_path / f"torch_{name}.json") as fh:
        saved = json.load(fh)
    with open(tmp_path / "reference" / f"{name}.json") as fh:
        assert panels.differences(saved, json.load(fh)) == []
    assert saved["target"] == "pysim" and saved["quick"] is True
    assert saved["card"] is None
    walls = panels.walls(got)
    assert walls and all(isinstance(w, float) and w > 0 for w in walls)


@pytest.mark.parametrize("panel", [fleet_scale.uart_identity_check,
                                   migration.identity_panel],
                         ids=["fleet_scale", "migration"])
def test_identity_row_on_the_cpu_target_equals_pysim(panel):
    """The 1-board UART fleet and the plain runtime on
    ``TorchTarget(device="cpu")`` boards (the eager loop): identical to
    each other and to the row on PySim."""
    cpu, sim = panel("cpu"), panel("pysim")
    assert cpu["identical"] is True
    assert panels.modelled(cpu) == panels.modelled(sim)
    assert cpu["fleet_ticks"] == 6_554_780


def test_migration_pause_lands_on_the_milestone():
    """``_pause_at_instret`` stops a job exactly at the instruction
    milestone on PySim and on a CPU ``TorchTarget``: never past it, one
    slice bounded by the instructions still missing."""
    from repro_torch.core.fleet import Job
    got = {}
    for target in ("pysim", "cpu"):
        fr = migration._fleet(["pcie"], target)
        h = fr.start_job(Job("hello"), fr.devices[0])
        migration._pause_at_instret(fr, h, 80)
        got[target] = (h.runtime.target.get_instret(0),
                       h.runtime.target.get_ticks())
    assert got["cpu"] == got["pysim"] and got["cpu"][0] == 80
