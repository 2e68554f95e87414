"""Golden-tick pins on the PyTorch target (CPU tensors here; the same
pins run on the GPU in ``chip_smoke.py``), per-category traffic equal to
the JAX package's run, and the full-width constants ``chip_smoke.py``
holds the card to.  Integer results; tolerance 0."""
import importlib.util
from pathlib import Path

import pytest

from benchmarks.common import run_workload as jax_run_workload
from repro.core.workloads import graphgen as jgraphgen
from repro_torch.core.workloads import graphgen
from repro_torch.run import run_workload

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _report_key(rep):
    return dict(ticks=rep.ticks, instret=list(rep.instret),
                uticks=list(rep.uticks), stdout=rep.stdout,
                traffic=dict(rep.traffic), traffic_total=rep.traffic_total,
                stall=dict(rep.stall), sched=dict(rep.sched))


def test_torch_hello_uart_golden():
    cs = _chip_smoke()
    rt, rep, _ = run_workload("hello", [], mode="fase", n_cores=1,
                              mem=1 << 22, device="cpu")
    assert rep.ticks == cs.HELLO_UART["ticks"] == 6_554_780
    assert rep.stdout == cs.HELLO_UART["stdout"]
    _, jrep, _ = jax_run_workload("hello", [], mode="fase", n_cores=1,
                                  mem=1 << 22, target="pysim")
    assert _report_key(rep) == _report_key(jrep)
    assert rt.target.substeps > 0


def test_torch_bc_pcie_golden():
    cs = _chip_smoke()
    g = graphgen.rmat(4, 4, weights=True)
    assert g == jgraphgen.rmat(4, 4, weights=True)
    rt, rep, _ = run_workload("bc", ["g.bin", "2", "1"], mode="fase",
                              link="pcie", n_cores=2, mem=1 << 22,
                              device="cpu", files={"g.bin": g})
    assert cs.BC_PCIE == dict(ticks=775_078, instret=11_876, traffic=24_681)
    assert rep.ticks == cs.BC_PCIE["ticks"]
    assert sum(rep.instret) == cs.BC_PCIE["instret"]
    assert rep.traffic_total == cs.BC_PCIE["traffic"]
    # per-category traffic bytes (and the rest of the report) equal the
    # JAX package's run of the same workload
    _, jrep, _ = jax_run_workload("bc", ["g.bin", "2", "1"], mode="fase",
                                  link="pcie", n_cores=2, mem=1 << 22,
                                  target="jax", files={"g.bin": g})
    assert dict(rep.traffic) == dict(jrep.traffic)
    assert _report_key(rep) == _report_key(jrep)


def test_torch_registry_matches_reference_target_entries():
    from repro.configs import registry as jreg
    from repro_torch.configs import fase_rocket, registry as treg
    for name in ("FASE_ROCKET", "FASE_ROCKET_PCIE", "FASE_FLEET",
                 "FASE_FLEET_VMAP", "FASE_FLEET_PROVISION",
                 "FASE_FLEET_NET"):
        want = dict(getattr(jreg, name))
        want.pop("target_fast_path")            # the port has one path
        want["target_fetch_kernel"] = "kernel"  # CUDA kernel on a CUDA image
        assert getattr(treg, name) == want, name
    assert fase_rocket.target_kwargs(treg.FASE_ROCKET_PCIE) == dict(
        issue_width=8, block_words=16, block_cache=True,
        fetch_kernel="kernel", dtlb_ways=8)
    assert fase_rocket.runtime_kwargs(treg.FASE_ROCKET_PCIE) == dict(
        link="pcie", baud=921600, session="async", queue_depth=16,
        coalesce_ticks=100)


@pytest.mark.parametrize("scale", [5, 8, 10])
def test_full_width_constants_come_from_pysim(scale):
    """``chip_smoke.py`` pins the full-width run (FASE_ROCKET_PCIE, bc
    with 4 threads on rmat(scale, 4)) to what the reference package's
    pure-Python simulator yields."""
    from repro.configs.fase_rocket import runtime_kwargs
    from repro.configs.registry import FASE_ROCKET_PCIE as cfg
    cs = _chip_smoke()
    g = jgraphgen.rmat(scale, 4, weights=True)
    _, rep, _ = jax_run_workload(
        "bc", ["g.bin", "4", "1"], mode="fase", n_cores=cfg["n_cores"],
        mem=cfg["mem_bytes"], target="pysim", files={"g.bin": g},
        **runtime_kwargs(cfg))
    assert dict(ticks=rep.ticks, instret=sum(rep.instret),
                traffic=rep.traffic_total) == cs.FULL_WIDTH[scale]
    assert cs.DEFAULT_SCALE in cs.FULL_WIDTH


def test_coremark_constants_come_from_pysim():
    """``chip_smoke.py``'s CoreMark phase (``coremark 1``, 1 core, 4 MiB,
    UART, the chunk kernel) is held to what the reference package's
    pure-Python simulator yields."""
    cs = _chip_smoke()
    _, rep, _ = jax_run_workload("coremark", ["1"], mode="fase", n_cores=1,
                                 mem=1 << 22, target="pysim")
    out = dict(line.split() for line in rep.stdout.decode().splitlines())
    assert dict(ticks=rep.ticks, instret=sum(rep.instret),
                crc=int(out["coremark_crc"])) == cs.COREMARK
    assert cs.COREMARK["crc"] == 16356


def test_chip_smoke_refuses_to_run_without_a_card():
    import subprocess
    import sys
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
