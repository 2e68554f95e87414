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


def test_fleet_full_width_constants_come_from_pysim():
    """``chip_smoke.py``'s full-width fleet runs are held to what the
    reference package's fleet yields over pure-Python simulator boards:
    FASE_FLEET_NET's 4-board gang (4 cores and 64 MiB a board, bc with 4
    threads a board on partition(rmat(10, 4), 4)), and FASE_FLEET_VMAP's
    run_synchronous jobs (bc 4T on rmat(10, 4, seed)), each job equal to
    its solo run; the gang pin is tests/test_golden_ticks.py's."""
    from repro.configs.fase_rocket import (FASE_FLEET_NET, fleet_kwargs,
                                           net_kwargs)
    from repro.configs.registry import FASE_FLEET_VMAP
    from repro.core.fleet import FleetRuntime, Job
    from repro.core.net import GangJob, Switch
    from repro.core.target.pysim import PySim
    from test_golden_ticks import (GANG_BC_EXCHANGES, GANG_BC_FABRIC_BYTES,
                                   GANG_BC_INSTRET, GANG_BC_MAKESPAN,
                                   GANG_BC_SUPERSTEPS)
    cs = _chip_smoke()
    assert cs.GANG_PIN == dict(
        makespan=GANG_BC_MAKESPAN, supersteps=GANG_BC_SUPERSTEPS,
        exchanges=GANG_BC_EXCHANGES, instret=GANG_BC_INSTRET,
        fabric_bytes=GANG_BC_FABRIC_BYTES)
    cfg = FASE_FLEET_NET
    kw = fleet_kwargs(cfg)
    kw.pop("links", None)
    fleet = FleetRuntime(
        make_target=lambda: PySim(cfg["n_cores"], cfg["mem_bytes"]),
        fabric=Switch(**net_kwargs(cfg)), **kw)
    parts = jgraphgen.partition(jgraphgen.rmat(10, 4, weights=False), 4)
    rep = fleet.run_gang(fleet.start_gang(GangJob(
        [Job("bc", ["part.bin", "4", "1"], files={"part.bin": p})
         for p in parts], superstep_ticks=40_000, halo_pages=4)))
    assert dict(makespan=rep.makespan_ticks, supersteps=rep.supersteps,
                exchanges=rep.exchanges,
                instret=sum(sum(r.instret) for r in rep.reports),
                fabric_bytes=rep.fabric["total_bytes"]) == cs.GANG_FULL
    vk = fleet_kwargs(FASE_FLEET_VMAP)
    tc = vk.pop("target_cfg")
    vk.pop("fleet_vmap")
    vk.pop("links", None)
    fleet = FleetRuntime(
        make_target=lambda: PySim(tc["n_cores"], tc["mem_bytes"]), **vk)
    got = []
    for d, seed in enumerate(cs.SYNC_SEEDS):
        g = jgraphgen.rmat(10, 4, seed=seed, weights=True)
        r = fleet.run_job(fleet.devices[d],
                          Job("bc", ["g.bin", "4", "1"], files={"g.bin": g}))
        got.append((r.report.ticks, sum(r.report.instret),
                    r.report.traffic_total))
    assert tuple(got) == cs.SYNC_FULL
    # seed 42 is the full-width FASE_ROCKET_PCIE run
    assert dict(zip(("ticks", "instret", "traffic"), got[0])) == \
        cs.FULL_WIDTH[10]


def test_fleet_artifact_constants_match_the_results():
    """``chip_smoke.py``'s fleet_scale and migration pins are the numbers
    of the checked-in ``results/fleet_scale.json`` and
    ``results/migration.json``."""
    import json
    cs = _chip_smoke()
    with open(ROOT / "results" / "fleet_scale.json") as f:
        rows = json.load(f)["scale"]
    assert {(r["link"], r["n_devices"]): r["makespan_ticks"]
            for r in rows} == cs.FLEET_SCALE
    assert {r["jobs"] for r in rows} == {8}
    with open(ROOT / "results" / "migration.json") as f:
        row = next(r for r in json.load(f)["migration"]
                   if r["link"] == "pcie")
    assert cs.MIGRATION_PCIE == dict(
        baseline=row["baseline_ticks"], migrated=row["migrated_ticks"],
        pages=row["full"]["pages"], src_bytes=row["full"]["src_bytes"],
        dst_bytes=row["full"]["dst_bytes"])
