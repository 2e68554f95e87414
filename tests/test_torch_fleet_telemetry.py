"""The fleet with telemetry armed on the port's own targets: every
scenario runs through the reference's fleet over its ``PySim`` boards
and through the port's fleet over ``TorchTarget(device="cpu")`` boards
(the eager loop), and the results are equal as plain data
(``test_torch_fleet.both``), the backend model counters of each counter
sample (``fetch_hits``, ``tlb_walks``, which differ between PySim and
an interpreter with fetch-block and data-TLB caches) aside:

* the twin of ``tests/test_net.py::
  test_counter_bridge_samples_carry_nic_port_counters``: the gang over
  the switch fabric, the NIC port counters in every sample;
* a live migration with both bridges armed: ``TelemetryHub.rebind``
  re-arms the commit-trace ring on the destination board, and the
  records continue there;
* ``least_loaded_adaptive`` placement fed by live counter samples (each
  board's ``LoadEstimator``).

Every comparison is exact."""
from repro.core.target.pysim import PySim as RefSim
from repro.core.workloads import graphgen
from repro_torch.core.interface import TorchTarget
from repro_torch.telemetry import without_backend_counters

from test_torch_fleet import PORT, REF, both

ARMED = dict(counters=True, commit_trace=True, interval_ticks=50_000,
             trace_slots=256)


def board(p, n_cores=1, mem=1 << 22):
    """The board factory of either side: the reference's PySim, or the
    port's tensor target on the CPU."""
    if p is REF:
        return lambda: RefSim(n_cores, mem)
    assert p is PORT
    return lambda: TorchTarget(n_cores, mem, device="cpu")


def test_counter_bridge_samples_carry_nic_port_counters():
    def scenario(p):
        fleet = p.FleetRuntime(
            n_devices=2, make_target=board(p), link="pcie",
            fabric=p.net.Switch(**p.fase_rocket.net_kwargs()),
            runtime_kwargs={"telemetry": dict(interval_ticks=50_000)})
        parts = graphgen.partition(graphgen.rmat(4, 4, weights=False), 2)
        rg = fleet.start_gang(p.net.GangJob(
            [p.Job("bc", ["part.bin", "1", "1"], files={"part.bin": q})
             for q in parts], superstep_ticks=40_000, halo_pages=4))
        rep = fleet.run_gang(rg)
        return rep.makespan_ticks, [without_backend_counters(m.telemetry)
                                    for m in rep.reports]
    makespan, telemetry = both(scenario)
    assert makespan == 526_792
    for tel in telemetry:
        samples = tel["counters"]["samples"]
        assert samples and all("nic" in s for s in samples)
        last = samples[-1]["nic"]
        assert last["tx_flits"] > 0 and last["credit_stalls"] >= 0
        assert 0 <= last["link_util"] <= 1


def test_migration_with_both_bridges_armed():
    def scenario(p):
        base = p.FleetRuntime(n_devices=2, make_target=board(p),
                              link="pcie")
        ref = base.run_job(base.devices[0], p.Job("hello"))
        fr = p.FleetRuntime(n_devices=2, make_target=board(p), link="pcie",
                            runtime_kwargs={"telemetry": dict(ARMED)})
        h = fr.start_job(p.Job("hello"), fr.devices[0])
        fr.step_job(h, pause_ticks=ref.report.ticks // 2)
        src = h.runtime.target
        mig = fr.migrate(h, fr.devices[1])
        dst = h.runtime.target
        res = fr.finish_job(h)
        rep = res.report
        return (ref.report.ticks, rep.ticks, rep.stdout, sum(rep.instret),
                mig.pages_shipped, without_backend_counters(rep.telemetry),
                dst is not src, dst.trace_slots, sum(dst.trace_n) if p is
                REF else int(dst.st.trace_n.sum()))
    (base_ticks, ticks, stdout, instret, pages, tel, moved, slots,
     dst_n) = both(scenario)
    assert stdout == b"hello from FASE target\nanswer 42\n"
    assert ticks > base_ticks and pages > 0 and moved
    # the destination's ring was re-armed and recorded the rest of the run
    assert slots == ARMED["trace_slots"] and 0 < dst_n < instret
    ct = tel["commit_trace"]
    assert sum(ct["records"]) == instret
    assert sum(ct["ring_dropped"]) == 0


def test_least_loaded_adaptive_fed_by_live_counter_samples():
    def scenario(p):
        fr = p.FleetRuntime(
            n_devices=2, make_target=board(p), links=["pcie", "uart"],
            placement="least_loaded_adaptive",
            runtime_kwargs={"telemetry": dict(counters=True,
                                              interval_ticks=20_000)})
        for _ in range(4):
            fr.submit(p.Job("hello"))
        rep = fr.run()
        return ([j.device_id for j in rep.jobs], rep.makespan_ticks,
                [(d.stats.load_samples, d.stats.load_stall_frac)
                 for d in fr.devices])
    placed, makespan, load = both(scenario)
    assert all(n > 0 for n, _ in load), "every board fed its estimator"
    assert any(frac > 0 for _, frac in load)
    assert len(placed) == 4 and makespan > 0
