"""The port's benchmark scripts live in their own package
(``repro_torch.bench``), so the reference's benchmark runner passes its
audit again: ``benchmarks/run.py`` asserts that every module of the
``benchmarks`` package is one of its registered panels before it runs
any.  Here its ``_audit`` runs over stand-ins for the modules its
``main`` registers (no panel runs, no JAX is imported), the port's
package passes its own audit, and each script answers ``--help``
without a card."""
import ast
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")


def registered_panels():
    """The module names ``benchmarks/run.py::main`` imports and runs, read
    from its source: the names of its ``from . import (...)``."""
    tree = ast.parse((ROOT / "benchmarks" / "run.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    return sorted(a.name for n in ast.walk(main)
                  if isinstance(n, ast.ImportFrom) and n.level == 1
                  for a in n.names)


def test_reference_runner_registers_seventeen_panels():
    assert len(registered_panels()) == 17


def test_reference_benchmark_audit_passes_without_importing_jax():
    """``benchmarks.run._audit`` over stand-in modules named as run.py's
    registered panels, in a fresh interpreter: it passes, and neither
    JAX nor any panel was imported."""
    code = (
        "import sys, types\n"
        "from benchmarks import run\n"
        f"names = {registered_panels()!r}\n"
        "run._audit([(n, types.ModuleType('benchmarks.' + n)) "
        "for n in names])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') or (m.startswith('benchmarks.') and "
        "m != 'benchmarks.run'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_reference_audit_still_catches_an_unregistered_module():
    """The audit is live: one registered name left out fails it."""
    from benchmarks import run
    names = registered_panels()
    with pytest.raises(AssertionError, match=names[0]):
        run._audit([(n, types.ModuleType("benchmarks." + n))
                    for n in names[1:]])


def test_no_port_script_is_left_in_the_reference_package():
    assert sorted(p.name for p in (ROOT / "benchmarks").glob("torch_*")) \
        == []


def test_port_bench_package_passes_its_own_audit():
    from repro_torch import bench
    bench.audit()
    assert set(bench.SCRIPTS) == {"decode_kernels", "dryrun_sweep",
                                  "paged_attention_timeline",
                                  "port_kernels", "profile_drop",
                                  *bench.PANELS,
                                  *bench.FLEET_PANELS, *bench.LM_PANELS,
                                  *bench.SPEED_PANELS}
    assert len(bench.PANELS) == 8 and "panels" in bench.EXCLUDED
    assert len(bench.FLEET_PANELS) == 4 and len(bench.LM_PANELS) == 3
    assert bench.SPEED_PANELS == ("target_speed", "speedup")


def test_port_bench_runner_lists_every_script():
    out = subprocess.run([sys.executable, "-m", "repro_torch.bench"],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    from repro_torch import bench
    assert [line.split()[0] for line in out.stdout.splitlines()] == \
        list(bench.SCRIPTS)


@pytest.mark.parametrize("name", ["decode_kernels", "dryrun_sweep",
                                  "paged_attention_timeline",
                                  "port_kernels", "htp_vs_direct",
                                  "stall_breakdown", "gapbs_accuracy",
                                  "coremark_accuracy", "baud_sweep",
                                  "hfutex_bench", "scale_sweep",
                                  "arg_prefetch", "fleet_scale",
                                  "net_scale", "stall_attribution",
                                  "migration", "serving_traffic",
                                  "roofline", "hillclimb", "target_speed",
                                  "speedup", "profile_drop"])
def test_each_script_runs_as_a_module_of_the_port(name):
    """``python -m repro_torch.bench.<name>``: ``--help`` where the script
    takes flags, else the refusal without a card (exit 1, no result).
    The FASE panels, the fleet panels, the LM-side twins and the speed
    panels take ``--quick``, ``--out`` and ``--against``, and each but
    ``hillclimb`` ``--target card|pysim`` (``target_speed`` also ``cpu``)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    flags = name != "paged_attention_timeline"
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.bench.{name}"] +
        (["--help"] if flags else []), cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=120)
    if flags:
        assert out.returncode == 0 and "usage:" in out.stdout, out.stderr
        if name in bench_panels():
            # hillclimb lowers its cells on the host: it takes no target
            assert ("--target {card,pysim}" in out.stdout) == \
                (name not in ("hillclimb", "target_speed"))
            assert ("--target {card,cpu,pysim}" in out.stdout) == \
                (name == "target_speed")
            assert "--against" in out.stdout
    else:
        assert out.returncode == 1 and "no CUDA device" in out.stderr
        assert out.stdout == ""


def bench_panels():
    from repro_torch import bench
    return bench.PANELS + bench.FLEET_PANELS + bench.LM_PANELS + \
        bench.SPEED_PANELS


def test_a_panel_on_the_card_refuses_without_one(tmp_path):
    """A FASE panel runs on the card by default: with no CUDA device it
    exits 1, names ``--target pysim`` and writes nothing."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.htp_vs_direct", "--quick",
         "--out", str(tmp_path)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 1 and "--target pysim" in out.stderr
    assert out.stdout == "" and list(tmp_path.iterdir()) == []


def test_dryrun_sweep_lists_every_cell_of_both_meshes():
    """64 cells: 11 configurations, 3 shapes each on both meshes, and
    long_500k only where the attention is sub-quadratic."""
    from repro_torch.bench import dryrun_sweep
    cells = dryrun_sweep.cells(False)
    assert len(cells) == len(set(cells)) == 64
    assert {mp for _, _, mp in cells} == {False, True}


def test_use_tree_loads_the_port_from_another_directory(tmp_path):
    """``--src DIR``: after ``use_tree(DIR)`` the port's modules come from
    ``DIR`` (here a stand-in package that records its path)."""
    pkg = tmp_path / "repro_torch"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("WHERE = 'other tree'\n")
    code = (
        "import repro_torch, sys\n"
        "from repro_torch.bench import timing\n"
        "timing.use_tree(timing.OWN_SRC)\n"
        "assert not hasattr(repro_torch, 'WHERE')\n"
        f"timing.use_tree({str(tmp_path)!r})\n"
        "import repro_torch\n"
        "print(repro_torch.WHERE)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "other tree"


def test_a_profile_window_opens_with_the_lead_in_and_reads_past_it():
    """``lead_in`` launches ``LEAD_IN_LAUNCHES`` empty kernels (here on a
    stand-in ``torch``), and ``device_events`` keeps the device's kernels
    and copies but the lead-in's kernel, CUPTI's overhead records and the
    host's events."""
    from torch.autograd import DeviceType
    from repro_torch.bench import timing
    sleeps = []
    fake = types.SimpleNamespace(
        cuda=types.SimpleNamespace(_sleep=sleeps.append))
    timing.lead_in(fake)
    assert sleeps == [0] * timing.LEAD_IN_LAUNCHES
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [types.SimpleNamespace(key=k, device_type=d) for k, d in (
        ("at::cuda::(anonymous namespace)::spin_kernel(long)", cuda),
        ("void (anonymous namespace)::run_chunk_fleet_kernel<false, "
         "false>((anonymous namespace)::Params, long long const*, "
         "long long)", cuda),
        ("Memcpy HtoD (Pageable -> Device)", cuda),
        ("Activity Buffer Request", cuda),
        ("cudaLaunchKernel", cpu))]
    assert [e.key for e in timing.device_events(events)] == [
        events[1].key, events[2].key]
