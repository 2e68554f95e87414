"""The port's two speed panels (``repro_torch.bench.target_speed`` and
``speedup``) against the reference's (``benchmarks/target_speed.py`` and
``speedup.py``) on the CPU, and the port's runner of all twins (``python -m
repro_torch.bench --run``) against the reference's runner.

``target_speed`` runs at a cut (rmat(5,8), 3 000 warm ticks, 8 000-tick
windows for every row) with ``target="cpu"``: its rows ``kernel``,
``kernel_nocache`` and ``eager`` all run the eager loop there.  Each row's
modelled fields equal the reference's ``_measure`` at the same cut on the
reference's PySim (and its ``JaxTarget`` fast row), and the fleet row the
reference's ``_measure_fleet``, tolerance 0.  The reference's ``run()`` is
never called: it runs the scalar loop and may ``sys.exit``.  The quick
gate is checked on planted rows; ``speedup`` at ``--quick`` runs both rows
on PySim against the reference's ``run(quick=True)``, with
``benchmarks.common.RESULTS_DIR`` pointed into a temporary directory."""
import ast
import json
import sys
import types
from pathlib import Path

import pytest

from repro_torch import bench
from repro_torch.bench import __main__ as runner
from repro_torch.bench import panels, speedup, target_speed as T

ROOT = Path(__file__).resolve().parent.parent

#: the cut: every window 8 000 ticks
CUT = dict(scale=5, warm_ticks=3_000, fast_ticks=8_000, slow_ticks=8_000,
           pysim_ticks=8_000)


@pytest.fixture(scope="module")
def cut_runs(tmp_path_factory):
    """The port's run at :data:`CUT` on ``target="cpu"`` and the
    reference's ``_measure`` (PySim, and its JaxTarget fast row) and
    ``_measure_fleet`` at the same cut."""
    from benchmarks import target_speed as R
    from repro.core.interface import JaxTarget
    from repro.core.target.pysim import PySim
    from repro.core.workloads import graphgen
    out = T.run(quick=True, target="cpu",
                out_dir=str(tmp_path_factory.mktemp("cut")), **CUT)
    g = graphgen.rmat(CUT["scale"], 8, weights=True)
    warm, meas = CUT["warm_ticks"], CUT["fast_ticks"]
    ref = dict(
        pysim=R._measure("pysim", lambda: PySim(R.N_CORES, R.MEM), g, warm,
                         meas),
        jax_fast=R._measure("jax_fast",
                            lambda: JaxTarget(R.N_CORES, R.MEM, **R.CFG), g,
                            warm, meas),
        fleet=R._measure_fleet(g, warm, meas))
    return out, ref


@pytest.mark.parametrize("name", ["kernel", "kernel_nocache", "eager",
                                  "pysim"])
def test_row_at_the_cut_equals_the_reference_pysim_row(cut_runs, name):
    out, ref = cut_runs
    row = next(r for r in out["rows"] if r["name"] == name)
    want = ref["pysim"]
    assert {k: row[k] for k in T.ROW_KEYS if k in row} == \
        {k: want[k] for k in T.ROW_KEYS if k in want}
    assert row["instructions"] > 0 and row["finished"] is False
    if name != "pysim":        # the eager loop on the host launches nothing
        assert row["substeps"] > 0 and not any(row["launches"].values())


def test_kernel_row_equals_the_reference_jax_fast_row(cut_runs):
    out, ref = cut_runs
    row = next(r for r in out["rows"] if r["name"] == "kernel")
    assert row["reference_row"] == "jax_fast"
    assert {k: row[k] for k in T.ROW_KEYS if k in row} == \
        {k: ref["jax_fast"][k] for k in T.ROW_KEYS if k in ref["jax_fast"]}


def test_torch_rows_run_the_same_chunks_as_pysim(cut_runs):
    out, _ = cut_runs
    by = {r["name"]: r for r in out["rows"]}
    assert by["kernel"]["runs"] == by["kernel_nocache"]["runs"] == \
        by["eager"]["runs"] == by["pysim"]["runs"] > 0
    assert by["kernel"]["substeps"] == by["kernel_nocache"]["substeps"] == \
        by["eager"]["substeps"]
    assert out["workload"] == "bc rmat5 4T" and out["n_cores"] == 4


def test_fleet_row_equals_the_reference_fleet_row(cut_runs):
    out, ref = cut_runs
    row = out["rows"][-1]
    assert (row["name"], row["reference_row"]) == ("fleet_x4",
                                                   "fleet_vmap_x4")
    assert {k: row[k] for k in T.ROW_KEYS} == \
        {k: ref["fleet"][k] for k in T.ROW_KEYS}
    assert row["dispatches"] > 0 and not any(row["launches"].values())


def test_fleet_row_is_four_boards_of_one(cut_runs):
    """Four identical boards: four times one board's instructions over
    the same ticks (one board run alone over the fleet row's ticks)."""
    out, _ = cut_runs
    fleet = out["rows"][-1]
    from repro_torch.core.target.pysim import PySim
    from repro_torch.core.workloads import graphgen
    g = graphgen.rmat(CUT["scale"], 8, weights=True)
    one = T._measure("one", "one", lambda: PySim(T.N_CORES, T.MEM), g,
                     CUT["warm_ticks"], fleet["ticks"], "pysim")
    assert fleet["instructions"] == 4 * one["instructions"]
    assert fleet["ticks"] == one["ticks"]


def test_a_row_leaves_the_kernels_launch_counters_as_they_were():
    """A row reads each kernel's launch counter before and after its window
    and never sets it back: a caller may be counting the whole run."""
    from repro_torch.core.target.pysim import PySim
    from repro_torch.core.workloads import graphgen
    counters = T._counters()
    for c in counters.values():
        c.launches = 7
    row = T._measure("pysim", "pysim", lambda: PySim(T.N_CORES, T.MEM),
                     graphgen.rmat(4, 4, weights=True), 1_000, 2_000,
                     "pysim")
    assert {name: c.launches for name, c in counters.items()} == \
        dict.fromkeys(counters, 7)
    assert row["instructions"] > 0 and "launches" not in row
    for c in counters.values():
        c.launches = 0


def test_against_holds_rows_against_the_reference_file(cut_runs, tmp_path,
                                                       capsys):
    """``--against DIR``: each row against the reference's row it names
    (exit 1 on a difference, here the cut against the full-size file) and
    against the port's own file of the same name."""
    out, _ = cut_runs
    mine = panels.save_json("target_speed", out, "cpu", True, str(tmp_path))
    assert T.check_rows([mine], str(ROOT / "results")) == 1
    assert "DIFFERS" in capsys.readouterr().out
    ref = tmp_path / "ref"
    ref.mkdir()
    (ref / "target_speed.json").write_text(json.dumps(dict(
        {k: out[k] for k in T.TOP_KEYS},
        rows=[dict(r, name=r["reference_row"], wall_s=9.0, ips=1.0)
              for r in out["rows"]])))
    assert T.check_rows([mine], str(ref)) == 0
    (ref / "torch_target_speed.json").write_text(Path(mine).read_text())
    assert T.check_rows([mine], str(ref)) == 0
    assert capsys.readouterr().out.count("modelled numbers equal") == 3


def planted_rows(kernel_ips, eager_ips, kernel_launches=None):
    """Rows as the card would write them, with the given rates."""
    def row(name, ips, **kw):
        return dict(name=name, reference_row=name, instructions=10,
                    wall_s=1.0, ips=ips, ticks=100, finished=False, runs=3,
                    substeps=7, **kw)
    zero = dict(run_chunk=0, run_chunk_fleet=0, walk_fetch_block=0)
    return [
        row("kernel", kernel_ips, launches=dict(
            zero, run_chunk=3 if kernel_launches is None else
            kernel_launches)),
        row("kernel_nocache", kernel_ips, launches=dict(zero, run_chunk=3)),
        row("eager", eager_ips, launches=dict(zero, walk_fetch_block=7)),
        row("pysim", 50.0),
        dict(row("fleet_x4", 80.0, launches=dict(zero, run_chunk_fleet=5)),
             dispatches=5, n_devices=4, finished=True)]


@pytest.mark.parametrize("case,kernel_ips,baseline,launches,rc", [
    ("kernel slower than eager", 90.0, None, None, 1),
    ("under a quick baseline's floor", 300.0, (True, 10.0), None, 1),
    ("over a full baseline's floor", 300.0, (False, 10.0), None, 0),
    ("a launch per run missing", 300.0, None, 2, 1),
    ("healthy", 300.0, (True, 4.0), None, 0)])
def test_quick_gate_on_the_card(case, kernel_ips, baseline, launches, rc,
                                tmp_path, monkeypatch, capsys):
    """``--quick`` on the card exits 1 on a planted regression: the kernel
    row slower than the eager row, the speedup under the floor of the
    card's baseline (0.5x a quick one), or a kernel row's launches not one
    a ``run``."""
    rows = planted_rows(kernel_ips, 100.0, launches)
    monkeypatch.setattr(panels, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(panels, "card_line", lambda target: "planted")
    monkeypatch.setattr(T, "_measure", lambda name, *a: next(
        r for r in rows if r["name"] == name))
    monkeypatch.setattr(T, "_measure_fleet", lambda *a: rows[-1])
    if baseline:
        (tmp_path / "torch_target_speed.json").write_text(json.dumps(dict(
            panel="target_speed", target="card", result=dict(
                quick=baseline[0], kernel_vs_eager_speedup=baseline[1]))))
    if rc:
        with pytest.raises(SystemExit) as e:
            T.run(quick=True, target="card", out_dir=str(tmp_path / "o"))
        assert e.value.code == 1
    else:
        out = T.run(quick=True, target="card", out_dir=str(tmp_path / "o"))
        assert out["kernel_vs_eager_speedup"] == 3.0
    printed = capsys.readouterr().out
    assert ("SLOWER" in printed) == (kernel_ips < 100)
    assert ("REGRESSED" in printed) == (case.startswith("under"))
    assert ("launched" in printed) == (launches is not None)


def test_gate_is_off_the_card(tmp_path, monkeypatch):
    """On the host every torch row is the eager loop: no gate there."""
    rows = planted_rows(1.0, 100.0)
    monkeypatch.setattr(T, "_measure", lambda name, *a: next(
        r for r in rows if r["name"] == name))
    monkeypatch.setattr(T, "_measure_fleet", lambda *a: rows[-1])
    out = T.run(quick=True, target="cpu", out_dir=str(tmp_path))
    assert out["kernel_vs_eager_speedup"] == 0.01


def test_speedup_quick_on_pysim_equals_the_reference(tmp_path, monkeypatch):
    import benchmarks.common as common
    from benchmarks import speedup as reference
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path / "reference"))
    want = reference.run(quick=True)
    got = speedup.run(quick=True, target="pysim", out_dir=str(tmp_path))
    assert [r["target"] for r in got] == ["PK/pysim", "FASE/pysim", "ratio"]
    assert [r.get("reference_row") for r in got] == \
        [r["target"] for r in want[:2]] + [None]
    for g, w in zip(got[:2], want[:2]):
        assert (g["instret"], g["model_s"]) == (w["instret"], w["model_s"])
        assert g["wall_per_iter"] == g["wall_s"] / 2
    with open(tmp_path / "torch_speedup.json") as f:
        saved = json.load(f)
    assert saved["target"] == "pysim" and saved["quick"] is True
    assert panels.differences(saved, got) == []


def test_speedup_exits_1_when_the_rows_differ(tmp_path, monkeypatch):
    """The two rows run one guest: a planted instret on the second exits
    1."""
    real = panels.run_workload
    calls = []

    def planted(name, argv, target, **kw):
        rt, rep, wall = real(name, argv, "pysim", **kw)
        calls.append(target)
        if len(calls) == 2:
            rep.instret = [n + 1 for n in rep.instret]
        return rt, rep, wall
    monkeypatch.setattr(panels, "run_workload", planted)
    with pytest.raises(SystemExit) as e:
        speedup.run(quick=True, target="pysim", out_dir=str(tmp_path))
    assert e.value.code == 1 and calls == ["pysim", "pysim"]


def reference_run_order():
    """The module names of ``benchmarks/run.py::main``'s ``modules`` list,
    in order, read from its source."""
    tree = ast.parse((ROOT / "benchmarks" / "run.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    modules = next(n.value for n in ast.walk(main)
                   if isinstance(n, ast.Assign) and
                   getattr(n.targets[0], "id", None) == "modules")
    return [t.elts[1].id for t in modules.elts]


def test_run_order_is_the_reference_runners():
    assert list(bench.RUN_ORDER) == reference_run_order()
    assert len(bench.RUN_ORDER) == 17
    assert set(bench.RUN_ORDER) <= set(bench.SCRIPTS)
    assert bench.SPEED_PANELS == ("target_speed", "speedup")


def fake_twins(monkeypatch, calls):
    """Two cheap twins, a host-only one, and one that fails (by raising and
    by ``sys.exit``), registered as modules of ``repro_torch.bench``."""
    def twin(name, fail=None):
        def run(quick, out_dir, **kw):
            calls.append((name, quick, out_dir, kw))
            if fail is not None:
                raise fail
            print(f"{name},1,ok", flush=True)
        mod = types.ModuleType(f"repro_torch.bench.{name}")
        mod.run = run
        monkeypatch.setitem(sys.modules, mod.__name__, mod)
    twin("cheap_a")
    twin("cheap_b")
    twin("hillclimb")
    twin("planted", RuntimeError("planted fault"))
    twin("gated", SystemExit(1))


def test_run_all_reports_each_twin_and_exits_1_on_a_failure(
        monkeypatch, capsys, tmp_path):
    calls = []
    fake_twins(monkeypatch, calls)
    rc = runner.run_all(True, "pysim", str(tmp_path),
                        names=["cheap_a", "planted", "gated", "hillclimb",
                               "cheap_b"])
    assert rc == 1
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    marks = [ln.split(" in ")[0] if "done" in ln else ln for ln in lines
             if ln.startswith("# ")]
    assert marks[:5] == ["# cheap_a done",
                         "# planted FAILED: RuntimeError: planted fault",
                         "# gated FAILED: SystemExit: 1",
                         "# hillclimb done", "# cheap_b done"]
    assert [c[0] for c in calls] == ["cheap_a", "planted", "gated",
                                     "hillclimb", "cheap_b"]
    assert all(c[1] is True and c[2] == str(tmp_path) for c in calls)
    kws = {c[0]: c[3] for c in calls}
    assert kws["hillclimb"] == {} and kws["cheap_a"] == {"target": "pysim"}
    assert runner.run_all(True, "pysim", str(tmp_path),
                          names=["cheap_a", "cheap_b"]) == 0


def test_run_writes_into_a_fresh_directory_not_results(monkeypatch, capsys):
    """``--run`` without ``--out`` writes into a fresh temporary directory,
    printed; the runner runs RUN_ORDER in order."""
    calls = []
    fake_twins(monkeypatch, calls)
    monkeypatch.setattr(runner, "RUN_ORDER", ("cheap_a", "cheap_b"))
    assert runner.main(["--run", "--quick", "--target", "pysim"]) == 0
    out = capsys.readouterr().out
    where = calls[0][2]
    assert [c[0] for c in calls] == ["cheap_a", "cheap_b"]
    assert calls[1][2] == where and f"# results in {where}" in out
    assert Path(where).resolve() != (ROOT / "results").resolve()
    assert Path(where).is_dir()


def test_run_on_the_card_refuses_without_one(monkeypatch, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    calls = []
    fake_twins(monkeypatch, calls)
    monkeypatch.setattr(runner, "RUN_ORDER", ("cheap_a",))
    assert runner.main(["--run", "--quick"]) == 1
    assert calls == [] and "--target pysim" in capsys.readouterr().err
