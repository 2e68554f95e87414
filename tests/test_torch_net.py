"""The port's switch fabric and gang scheduling (``repro_torch.core.net``):
twin of ``tests/test_net.py``.

Each scenario runs through the reference package and through the port
over the reference's ``PySim`` boards, and the results must be equal as
plain data (``test_torch_fleet.both``): flit framing and credit timing,
the NIC's page push, the fabric-vs-island identity, gang placement, the
BSP gang run with its fabric report, its dependence on the switch knobs,
and whole-gang migration.  Then the main path's gang pin — a 2-board bc
gang over the registry fabric, makespan 526 792 — on the port's own
targets: ``TorchTarget(device="cpu")`` boards and a stacked CPU
``FleetTarget`` (the eager flat form).  Integer results; tolerance 0."""
import pytest

from repro.core.target.pysim import PySim
from repro.core.workloads import graphgen
from repro_torch.configs.fase_rocket import net_kwargs
from repro_torch.core.fleet import FleetRuntime, Job
from repro_torch.core.interface import TorchTarget
from repro_torch.core.net import GangJob, Switch

from test_torch_fleet import PORT, both

MEM = 1 << 23
#: tests/test_golden_ticks.py's gang pin
GANG = dict(makespan=526_792, supersteps=6, exchanges=10, instret=4_319,
            fabric_bytes=164_460)


def _fleet(p, n, fabric=None, **kw):
    return p.FleetRuntime(n_devices=n, make_target=lambda: PySim(1, MEM),
                          link="pcie", fabric=fabric, **kw)


def _switch(p, **over):
    cfg = {**p.fase_rocket.FASE_FLEET_NET, **over}
    return p.net.Switch(**p.fase_rocket.net_kwargs(cfg))


def _gang_jobs(p, parts, **kw):
    return p.net.GangJob([p.Job("bc", ["part.bin", "1", "1"],
                                files={"part.bin": q}) for q in parts],
                         **{"superstep_ticks": 40_000, "halo_pages": 4,
                            **kw})


def _gang(p, boards, graph=None, fabric=None):
    g = graph if graph is not None \
        else graphgen.rmat(4, 4, seed=42, weights=False)
    fleet = _fleet(p, boards, fabric=fabric or _switch(p))
    rg = fleet.start_gang(_gang_jobs(p, graphgen.partition(g, boards)))
    return fleet, rg


def _summary(rep):
    return dict(makespan=rep.makespan_ticks, supersteps=rep.supersteps,
                exchanges=rep.exchanges,
                instret=sum(sum(r.instret) for r in rep.reports),
                fabric_bytes=rep.fabric["total_bytes"])


# ---------------------------------------------------------------------------
# the switch
# ---------------------------------------------------------------------------
def test_flits_credits_bandwidth_and_latency():
    def scenario(p):
        sw = p.net.Switch(flit_bytes=64, header_bytes=16)
        flits = [(f.seq, f.nbytes, f.kind) for f in sw.flits_of(4096)]

        def delivered(gbits, lat, credits=8):
            s = p.net.Switch(gbits_per_s=gbits, latency_ticks=lat,
                             credits=credits)
            a, b = s.connect("a"), s.connect("b")
            out = [s.transfer(a, b, 4096, at=0, kind="data")
                   for _ in range(4)]
            big = s.transfer(a, b, 1 << 14, at=out[-1], kind="data")
            return out, big, s.report(horizon=100_000)
        runs = [delivered(g, 500) for g in (1, 4, 16, 64)] + \
            [delivered(16, lat) for lat in (100, 500, 2000)] + \
            [delivered(16, 1000, credits=c) for c in (2, 1 << 10)]
        return flits, runs
    flits, runs = both(scenario)
    assert sum(n for _, n, _ in flits) == 4096 + 16
    bw = [r[0][-1] for r in runs[:4]]
    assert all(x >= y for x, y in zip(bw, bw[1:])) and bw[0] > bw[-1]
    lat = [r[0][-1] for r in runs[4:7]]
    assert all(x <= y for x, y in zip(lat, lat[1:])) and lat[-1] > lat[0]
    starved, rich = runs[7][2]["ports"][0], runs[8][2]["ports"][0]
    assert starved["credit_stalls"] > 0 and rich["credit_stalls"] == 0
    assert 0 < runs[0][2]["ports"][0]["link_util"] <= 1


def test_place_gang_and_nic_push_pages():
    def scenario(p):
        fleet = _fleet(p, 4, fabric=p.net.Switch())
        fleet.devices[0].stats.busy_ticks = 500
        fleet.devices[1].stats.busy_ticks = 300
        placed = [d.id for d in p.net.place_gang(fleet, 2)]
        fleet = _fleet(p, 2, fabric=_switch(p))
        d0, d1 = fleet.devices
        s0, s1 = d0.provision("a"), d1.provision("b")
        words = tuple((i * 2654435761) & 0xFFFFFFFFFFFFFFFF
                      for i in range(512))
        w = s0.submit(p.session.HtpTransaction().page_write(0, 3, words), 0)
        b0, b1 = s0.channel.total_bytes, s1.channel.total_bytes
        res = d0.nic.push_pages(d1.nic, [(3, 7)], at=w.done,
                                shootdown=(0,), wake=(0,))
        moved = (s0.channel.total_bytes - b0, s1.channel.total_bytes - b1)
        got = s1.submit(p.session.HtpTransaction().page_read(0, 7),
                        res.done)
        return (placed, w.done, res.done, *moved,
                tuple(got.values[0]) == words,
                d0.nic.report(), d1.nic.report(), fleet.fabric.report())
    placed, wdone, rdone, db0, db1, same, r0, r1, fabric = both(scenario)
    assert placed == [2, 3]
    assert (db0, db1) == (0, 0) and same and rdone > wdone
    assert r0["frames_tx"] == 1 and r1["frames_rx"] == 1
    assert "NicTx" in r0["bytes_by_op"] and fabric["total_bytes"] > 4096


def test_fabric_attached_fleet_tick_identical_when_nics_idle():
    g = graphgen.rmat(4, 8, weights=True)

    def scenario(p):
        out = []
        for fabric in (None, _switch(p)):
            fr = _fleet(p, 2, fabric=fabric)
            fr.submit(p.Job("bc", ["g.bin", "1", "1"], files={"g.bin": g}))
            fr.submit(p.Job("hello"))
            out.append(fr.run())
        return out
    island, fabric = both(scenario)
    assert (island.makespan_ticks, island.total_bytes) == \
        (fabric.makespan_ticks, fabric.total_bytes)


# ---------------------------------------------------------------------------
# gang scheduling
# ---------------------------------------------------------------------------
def test_gang_report_equal_to_the_reference():
    def scenario(p):
        fleet, rg = _gang(p, 2)
        return fleet.run_gang(rg)
    rep = both(scenario)
    assert _summary(rep) == GANG
    assert rep.device_ids == [0, 1]
    assert all(r.exit_code == 0 for r in rep.reports)
    assert rep.makespan_ticks == max(r.ticks for r in rep.reports)
    assert all(q["frames_tx"] > 0 and q["frames_rx"] > 0
               for q in rep.fabric["ports"])
    assert rep.wait_ticks > 0


def test_gang_auto_pacing_and_three_boards_equal_to_the_reference():
    g = graphgen.rmat(5, 4, seed=7, weights=False)

    def scenario(p):
        fleet = _fleet(p, 3, fabric=_switch(p))
        rg = fleet.start_gang(_gang_jobs(p, graphgen.partition(g, 3),
                                         superstep_ticks="auto"))
        return fleet.run_gang(rg)
    rep = both(scenario)
    assert rep.n_members == 3 and len(rep.rounds) == rep.supersteps


def test_gang_makespan_tracks_fabric_not_host_link():
    g = graphgen.rmat(4, 4, seed=42, weights=False)

    def scenario(p):
        out = {}
        for gbits, lat in ((1, 500), (16, 500), (16, 4000)):
            fleet, rg = _gang(p, 2, graph=g,
                              fabric=_switch(p, net_gbits_per_s=gbits,
                                             net_latency_ticks=lat))
            out[(gbits, lat)] = fleet.run_gang(rg).makespan_ticks
        return out
    mk = both(scenario)
    assert mk[(1, 500)] > mk[(16, 500)]
    assert mk[(16, 4000)] > mk[(16, 500)]


def test_migrate_gang_equal_to_the_reference():
    g = graphgen.rmat(4, 4, seed=42, weights=False)

    def scenario(p):
        fleet = _fleet(p, 4, fabric=_switch(p))
        rg = fleet.start_gang(_gang_jobs(p, graphgen.partition(g, 2)))
        before = [h.device.id for h in rg.handles]
        migs = fleet.migrate_gang(rg, 2)
        rep = fleet.run_gang(rg)
        small = _fleet(p, 3, fabric=_switch(p))
        rg2 = small.start_gang(_gang_jobs(p, graphgen.partition(g, 2)))
        with pytest.raises(AssertionError, match="overlaps"):
            p.net.migrate_gang(small, rg2, 1)
        return before, migs, rep
    before, migs, rep = both(scenario)
    assert before == [0, 1]
    assert [(m.src, m.dst) for m in migs] == [(0, 2), (1, 3)]
    assert rep.device_ids == [2, 3]
    assert rep.makespan_ticks > GANG["makespan"]


# ---------------------------------------------------------------------------
# the gang pin on the port's own targets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("form", ["torch-target", "stacked-fleet"])
def test_gang_pin_on_the_port_targets(form):
    """The 2-board gang of ``tests/test_golden_ticks.py`` (bc on
    partition(rmat(4, 4), 2), one core and 4 MiB a board, PCIe queue
    pairs, the registry fabric, 40k-tick supersteps, 4-page halos) on
    ``TorchTarget(device="cpu")`` boards and on a stacked CPU
    ``FleetTarget`` (each board's ``run`` a one-hot global chunk of the
    eager flat form)."""
    parts = graphgen.partition(graphgen.rmat(4, 4, weights=False), 2)
    if form == "stacked-fleet":
        fleet = FleetRuntime(n_devices=2, fleet_vmap=True,
                             target_cfg=dict(n_cores=1, mem_bytes=1 << 22,
                                             device="cpu"),
                             link="pcie", fabric=Switch(**net_kwargs()))
    else:
        fleet = FleetRuntime(
            n_devices=2, link="pcie", fabric=Switch(**net_kwargs()),
            make_target=lambda: TorchTarget(1, 1 << 22, device="cpu"))
    rg = fleet.start_gang(GangJob(
        [Job("bc", ["part.bin", "1", "1"], files={"part.bin": q})
         for q in parts], superstep_ticks=40_000, halo_pages=4))
    assert _summary(fleet.run_gang(rg)) == GANG
    if form == "stacked-fleet":
        assert fleet.fleet_target.dispatch_count > 0


def test_port_gang_pin_with_pysim_boards():
    fleet, rg = _gang(PORT, 2)
    assert _summary(fleet.run_gang(rg)) == GANG
