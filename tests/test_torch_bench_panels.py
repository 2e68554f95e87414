"""The port's twins of the paper's FASE panels (``repro_torch.bench``:
htp_vs_direct, stall_breakdown, gapbs_accuracy, coremark_accuracy,
baud_sweep, hfutex_bench, scale_sweep, arg_prefetch) against the
reference's panels (``benchmarks/*.py``), on the CPU: each twin at
``quick`` on the port's PySim equals the reference panel's
``run(quick=True)`` row for row on every modelled field (tolerance 0;
only wall seconds are left out), with both panels writing their files
into a temporary directory, never over the checked-in ``results/``.
One hello row runs through ``TorchTarget(device="cpu")``; gapbs and
CoreMark do not (the eager loop on the CPU is some 450x slower than
PySim there: the card runs them, ``chip_smoke.py``'s ``panels`` phase).
The two example twins run at their own argv on PySim."""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import bench
from repro_torch.bench import htp_vs_direct, panels

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")

#: the files each twin writes, by panel (the reference's names after
#: ``torch_``)
FILES = {"stall_breakdown": ["stall_breakdown", "cq_overlap"],
         "hfutex_bench": ["hfutex"]}


def test_the_panels_are_the_papers_eight_in_order():
    assert bench.PANELS == (
        "htp_vs_direct", "stall_breakdown", "gapbs_accuracy",
        "coremark_accuracy", "baud_sweep", "hfutex_bench", "scale_sweep",
        "arg_prefetch")


@pytest.mark.parametrize("name", bench.PANELS)
def test_twin_on_pysim_equals_the_reference_panel(name, tmp_path,
                                                  monkeypatch):
    import benchmarks.common as common
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path / "reference"))
    reference = importlib.import_module(f"benchmarks.{name}")
    twin = importlib.import_module(f"repro_torch.bench.{name}")
    want = reference.run(quick=True)
    got = twin.run(quick=True, target="pysim", out_dir=str(tmp_path))
    assert panels.differences(got, want) == []
    assert panels.modelled(got) == panels.modelled(want)
    for f in FILES.get(name, [name]):
        with open(tmp_path / f"torch_{f}.json") as fh:
            saved = json.load(fh)
        with open(tmp_path / "reference" / f"{f}.json") as fh:
            assert panels.differences(saved, json.load(fh)) == []
        assert saved["target"] == "pysim" and saved["quick"] is True
        assert saved["card"] is None
    rows = got[0] if name == "stall_breakdown" else \
        got["rows"] if name == "arg_prefetch" else got
    assert all("wall_s" in r for r in rows)
    assert any(isinstance(r["wall_s"], float) and r["wall_s"] > 0
               for r in rows)


def test_hello_row_on_the_cpu_target_equals_pysim():
    """The end-to-end hello row, HTP and direct, through
    ``TorchTarget(device="cpu")`` (the eager loop): the same link bytes
    as on PySim."""
    cpu, _ = htp_vs_direct.end_to_end(None, ["hello"], "uart", "cpu")
    sim, _ = htp_vs_direct.end_to_end(None, ["hello"], "uart", "pysim")
    assert cpu == sim and cpu[False] < cpu[True]


def test_modelled_numbers_leave_out_only_the_wall():
    a = {"panel": "x", "result": [{"ticks": 5, "wall_s": 1.0,
                                   "res": {"wall": 2.0, "bytes": 3}}]}
    b = [{"ticks": 5, "wall_s": 9.0, "res": {"wall": 0.5, "bytes": 3}}]
    assert panels.differences(a, b) == []
    b[0]["res"]["bytes"] = 4
    assert panels.differences(a, b) == ["[0].res.bytes: 3 != 4"]


def test_against_compares_the_written_files(tmp_path, capsys):
    """``--against DIR``: a file of the same name must hold the same
    modelled numbers (exit 1 if not); the reference's file of the panel
    is compared and reported."""
    mine = tmp_path / "mine"
    other = tmp_path / "other"
    other.mkdir()
    path = panels.save_json("p", [{"ticks": 1, "wall_s": 0.1}], "pysim",
                            True, str(mine))
    (other / "p.json").write_text(json.dumps([{"ticks": 2}]))
    assert panels.check_against([path], str(other)) == 0
    (other / "torch_p.json").write_text(json.dumps(
        {"panel": "p", "result": [{"ticks": 1, "wall_s": 7.0}]}))
    assert panels.check_against([path], str(other)) == 0
    (other / "torch_p.json").write_text(json.dumps([{"ticks": 3}]))
    assert panels.check_against([path], str(other)) == 1
    out = capsys.readouterr().out
    assert "p.json: DIFFERS" in out and "modelled numbers equal" in out


@pytest.mark.parametrize("example,argv,expect", [
    ("torch_fase_coremark.py", ["2"], "coremark_crc"),
    ("torch_gapbs_on_fase.py", [], "hfutex hits")])
def test_example_twin_runs_on_pysim_as_the_reference_example(example, argv,
                                                             expect):
    """The example twin with ``--target pysim`` prints what the
    reference's example prints on PySim, line for line but the wall."""
    ref = ["fase_coremark.py", *argv, "pysim"] if "coremark" in example \
        else ["gapbs_on_fase.py"]
    env = dict(os.environ, PYTHONPATH=SRC)
    twin = subprocess.run([sys.executable, f"examples/{example}", *argv,
                           "--target", "pysim"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert twin.returncode == 0, twin.stderr
    want = subprocess.run([sys.executable, f"examples/{ref[0]}", *ref[1:]],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert want.returncode == 0, want.stderr

    def body(out):
        return [line for line in out.splitlines() if "wall" not in line]
    assert body(twin.stdout) == body(want.stdout)
    assert expect in twin.stdout
