"""Golden bc@PCIe 2T with a PC-window trigger active on both bridges, on
``TorchTarget(device="cpu")`` (the eager loop): the twin of the
reference's ``test_bc_pcie_golden_with_pc_window_trigger``
(``tests/test_telemetry.py``).  Windowed capture is as non-perturbing as
unwindowed: the ticks, the instructions and the traffic pin hold, and
the captured records equal the port's PySim's record for record."""
from repro_torch.core.workloads import graphgen
from repro_torch.run import run_workload

from test_torch_telemetry import ARMED
from test_torch_telemetry_bc import (BC_PCIE_INSTRET, BC_PCIE_TICKS,
                                     BC_PCIE_TRAFFIC)


def test_bc_pcie_golden_with_pc_window_trigger():
    g = graphgen.rmat(4, 4, weights=True)
    trig = ("pc", 0x10000, None)
    got = {}
    for target, opts in (("torch", dict(device="cpu")), ("pysim", {})):
        rt, rep, _ = run_workload(
            "bc", ["g.bin", "2", "1"], mode="fase", link="pcie", n_cores=2,
            mem=1 << 22, files={"g.bin": g}, target=target,
            telemetry=dict(ARMED, trigger=trig), **opts)
        got[target] = (rt.telemetry.commit.records, rep)
    records, rep = got["torch"]
    assert rep.ticks == BC_PCIE_TICKS
    assert sum(rep.instret) == BC_PCIE_INSTRET
    assert rep.traffic_total == BC_PCIE_TRAFFIC
    assert sum(rep.telemetry["commit_trace"]["records"]) > 0
    assert records == got["pysim"][0]
    assert rep.telemetry["commit_trace"] == \
        got["pysim"][1].telemetry["commit_trace"]
