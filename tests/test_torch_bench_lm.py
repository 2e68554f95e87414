"""The port's LM-side twins (``repro_torch.bench``: serving_traffic,
roofline, hillclimb) against the reference's panels, on the CPU:

* ``serving_traffic``'s ``poll_every`` sweep (the port's own seeded
  ``qwen3-8b.smoke()`` on the host) and ``co_residency`` at ``quick`` on
  the port's PySim equal the reference's ``run()`` and
  ``co_residency(quick=True)`` on every modelled field (tolerance 0; the
  reference writes into a temporary directory); ``co_residency`` at full
  size equals the checked-in ``results/serving_coresidency.json``.  At
  the sweep's size no request emits its eos early, so the reference's
  serve fault (its requests outside slot 0 decode token 0) reaches no
  recorded field;
* ``roofline``: ``model_flops_per_step`` equal to the reference's for
  every arch x shape, and the table's derived columns equal to the
  reference's over the same cells;
* ``hillclimb``'s quick pair cut to one layer on ``meta`` tensors: every
  variant ``OK``, and each variant's direction read from the counts;
* every new twin refuses to run without a card unless asked for the
  host."""
import json
import sys
from pathlib import Path

import pytest

from repro_torch import bench
from repro_torch.bench import hillclimb, panels, roofline, serving_traffic

RESULTS = Path(__file__).resolve().parent.parent / "results"


def test_the_lm_twins_are_registered():
    assert bench.LM_PANELS == ("serving_traffic", "roofline", "hillclimb")
    assert bench.SCRIPTS[-7:] == bench.FLEET_PANELS + bench.LM_PANELS
    bench.audit()


def test_serving_traffic_on_the_host_equals_the_reference(tmp_path,
                                                          monkeypatch):
    import benchmarks.common as common
    import benchmarks.serving_traffic as reference
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path / "reference"))
    want = reference.run()
    want_co = reference.co_residency(quick=True)
    got = serving_traffic.run(quick=True, target="pysim",
                              out_dir=str(tmp_path))
    assert panels.differences(got, want) == []
    assert [r["finished"] for r in got] == [4, 4]
    for name, rows in (("serving_traffic", want),
                       ("serving_coresidency", want_co)):
        with open(tmp_path / f"torch_{name}.json") as fh:
            saved = json.load(fh)
        assert panels.differences(saved, rows) == []
        assert saved["target"] == "pysim" and saved["card"] is None
    for r in got:
        assert r["wall_s"] > 0 and r["host_poll_s"] > 0
        assert r["host_schedule_s"] > 0 and r["host_enqueue_s"] > 0


def test_co_residency_at_full_size_equals_the_checked_in_file(tmp_path):
    rows = serving_traffic.co_residency(quick=False, target="pysim",
                                        out_dir=str(tmp_path))
    with open(RESULTS / "serving_coresidency.json") as fh:
        assert panels.differences(rows, json.load(fh)) == []


def test_the_whole_model_sweep_runs_on_the_card_only():
    with pytest.raises(ValueError, match="card only"):
        serving_traffic.model("qwen3-8b", "pysim")


@pytest.mark.parametrize("arch", sorted(
    __import__("repro_torch.configs", fromlist=["CONFIGS"]).CONFIGS))
def test_model_flops_per_step_equal_the_reference(arch):
    from benchmarks import roofline as reference
    from repro_torch.launch.steps import SHAPES
    for shape in SHAPES:
        assert roofline.model_flops_per_step(arch, shape) == \
            reference.model_flops_per_step(arch, shape)


def _cells():
    """Two dry-run reports as the port's dry run writes them (an ``OK``
    cell and a skipped one)."""
    ok = {"arch": "qwen3-8b", "shape": "decode_32k", "mesh": "16x16",
          "status": "OK", "n_chips": 256,
          "hlo_flops_per_device": 3.5e9,
          "per_device": {"argument_bytes": 6e9, "temp_bytes": 1e9,
                         "peak_bytes": 7e9},
          "roofline": {"compute_s": 3.5e9 / 989e12,
                       "memory_s": 7e9 / 3.35e12,
                       "collective_s": 2e8 / 450e9,
                       "dominant": "memory_s"}}
    skip = {"arch": "qwen3-8b", "shape": "long_500k",
            "status": "SKIP(full-attn)"}
    return [ok, skip]


def test_roofline_table_equals_the_references_over_the_same_cells(
        tmp_path, monkeypatch):
    import benchmarks.common as common
    from benchmarks import roofline as reference
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path / "reference"))
    common.save_json("dryrun_all.json", _cells())
    want = reference.run()
    rates = {"bf16_gemm_flop_per_s": 7e14, "hbm_copy_bytes_per_s": 3e12}
    got = roofline.run(target="pysim", out_dir=str(tmp_path),
                       cells=_cells(), measured=rates)
    assert panels.differences(got, want) == []
    assert got[0]["roofline_measured"]["memory_s"] == 7e9 / 3e12
    with open(tmp_path / "torch_roofline_table.json") as fh:
        saved = json.load(fh)["result"]
    assert saved["data_sheet"]["bf16_flop_per_s"] == 989e12
    assert saved["measured"] == rates
    # the same cells from a directory of per-cell reports
    cells = tmp_path / "cells"
    cells.mkdir()
    for i, c in enumerate(_cells()):
        (cells / f"{i}.json").write_text(json.dumps([c]))
    assert panels.differences(roofline.run(
        target="pysim", out_dir=str(tmp_path), cells=str(cells)), want) == []


def test_hillclimb_quick_pair_at_one_layer(tmp_path):
    """The quick pair (qwen3-8b decode_32k, baseline and tp_serve) cut to
    one layer on the production mesh: every variant ``OK``; the
    variant's direction is the sign of its dominant term's change."""
    rows = hillclimb.run(quick=True, out_dir=str(tmp_path), n_layers=1)
    assert [r["variant"] for r in rows] == ["baseline", "tp_serve"]
    assert all(r["status"] == "OK" for r in rows)
    v = rows[1]["vs_baseline"]
    base = rows[0]["roofline"][v["term"]]
    assert v["term"] == rows[0]["roofline"]["dominant"]
    assert v["baseline_s"] == base
    assert v["variant_s"] == rows[1]["roofline"][v["term"]]
    assert v["moved"] == ("down" if v["variant_s"] < base else
                          "up" if v["variant_s"] > base else "same")
    # tp_serve gathers no parameters: its collective term falls
    assert rows[1]["roofline"]["collective_s"] < \
        rows[0]["roofline"]["collective_s"]
    with open(tmp_path / "torch_hillclimb.json") as fh:
        saved = json.load(fh)
    # lowered on the host: the file names no card
    assert saved["target"] == "host" and saved["card"] is None


def _run_as_main(name, monkeypatch, *argv):
    """``python -m repro_torch.bench.<name> argv``: its exit code."""
    import runpy
    monkeypatch.setattr(sys, "argv", [name, *argv])
    # run as __main__ from a fresh import, as ``python -m`` does
    monkeypatch.delitem(sys.modules, f"repro_torch.bench.{name}",
                        raising=False)
    with pytest.raises(SystemExit) as exit_:
        runpy.run_module(f"repro_torch.bench.{name}", run_name="__main__")
    return exit_.value.code


@pytest.mark.parametrize("name", [n for n in bench.FLEET_PANELS +
                                  bench.LM_PANELS if n != "hillclimb"])
def test_new_twins_refuse_to_run_without_a_card(name, monkeypatch, capsys):
    """``python -m repro_torch.bench.<name>`` with no arguments asks for
    the card and exits 1 without one, before it runs anything."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert _run_as_main(name, monkeypatch) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_hillclimb_takes_no_target(monkeypatch, capsys):
    """``hillclimb`` lowers its cells on the host whatever the card: its
    command line has no ``--target`` (argparse refuses one, exit 2,
    before anything runs)."""
    assert _run_as_main("hillclimb", monkeypatch, "--target", "card") == 2
    assert "unrecognized arguments: --target" in capsys.readouterr().err
