"""Golden bc@PCIe 2T with both telemetry bridges armed on
``TorchTarget(device="cpu")`` (the eager loop): the twin of the
reference's ``test_bc_pcie_golden_and_traffic_with_bridges_armed``
(``tests/test_telemetry.py``).  The ticks, the instructions and the
traffic pin hold exactly, and the telemetry report equals the port's
PySim's but for the backend model counters of each counter sample."""
from repro_torch.core.workloads import graphgen
from repro_torch.run import run_workload
from repro_torch.telemetry import without_backend_counters

from test_torch_telemetry import ARMED

BC_PCIE_TICKS = 775_078
BC_PCIE_INSTRET = 11_876
BC_PCIE_TRAFFIC = 24_681


def test_bc_pcie_golden_and_traffic_with_bridges_armed():
    g = graphgen.rmat(4, 4, weights=True)
    reps = {}
    for target, opts in (("torch", dict(device="cpu")), ("pysim", {})):
        _, reps[target], _ = run_workload(
            "bc", ["g.bin", "2", "1"], mode="fase", link="pcie", n_cores=2,
            mem=1 << 22, files={"g.bin": g}, target=target,
            telemetry=dict(ARMED), **opts)
    rep = reps["torch"]
    assert rep.ticks == BC_PCIE_TICKS
    assert sum(rep.instret) == BC_PCIE_INSTRET
    # telemetry bytes are timed on their own lane and never appear in the
    # channel accounting
    assert rep.traffic_total == BC_PCIE_TRAFFIC
    tel = rep.telemetry
    assert tel["stream"]["frames"] > 0
    assert tel["counters"]["samples"], "pcie lane must deliver samples"
    assert sum(tel["commit_trace"]["records"]) > 0
    assert without_backend_counters(tel) == \
        without_backend_counters(reps["pysim"].telemetry)
