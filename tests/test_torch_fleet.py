"""The port's fleet layer (``repro_torch.core.fleet``): twin of
``tests/test_fleet.py``.

Every scenario is driven twice, through the reference package's fleet
and through the port's, both over the reference's ``PySim`` boards (the
host layers are what is compared; the targets are the same), and every
report must be equal field for field (``plain``): routing, placement,
provisioning, the fleet runtime's reports, live migration with and
without a delta pre-copy, and fleet-sharded serving with slot migration
(the engines at smoke width, the port's with the reference's parameters).
The reference test's own assertions are then made on the port's result.
The fleet_scale and migration pins of ``results/`` hold on the port's
fleet too.  Integer results; tolerance 0."""
import dataclasses
import functools
import importlib
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.core.target.pysim import PySim
from repro.core.workloads import graphgen

ROOT = Path(__file__).resolve().parents[1]


def _pkg(root):
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    fleet = m("core.fleet")
    return SimpleNamespace(
        root=root, fleet=fleet, Device=fleet.Device,
        FleetRouter=fleet.FleetRouter, FleetRuntime=fleet.FleetRuntime,
        Job=fleet.Job, make_policy=fleet.make_policy,
        placement=m("core.fleet.placement"), cq=m("core.cq"),
        channel=m("core.channel"), session=m("core.session"),
        runtime=m("core.runtime"), workloads=m("core.workloads"),
        net=m("core.net"), fase_rocket=m("configs.fase_rocket"))


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def plain(x):
    """A report of either package as plain data: dataclasses as dicts of
    their fields, containers element by element, numpy as lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)
                if f.name != "resident_session"}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def both(scenario):
    """``scenario`` through the reference and through the port; their
    results equal as plain data.  Returns the port's."""
    want, got = scenario(REF), scenario(PORT)
    assert plain(got) == plain(want)
    return got


def _ctx_save(p, cpu):
    txn = p.session.HtpTransaction()
    for i in range(1, 32):
        txn.reg_read(cpu, i, "ctxsw")
    return txn


def _mk_devices(p, n, link="pcie", n_cores=2, mem=1 << 20):
    return [p.Device(i, lambda: PySim(n_cores, mem), link=link)
            for i in range(n)]


def _fleet(p, n=2, mem=1 << 22, **kw):
    kw.setdefault("link", "pcie")
    return p.FleetRuntime(n_devices=n, make_target=lambda: PySim(1, mem),
                          **kw)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------
def test_router_single_device_tick_identical_to_session():
    def scenario(p):
        def trace(submit):
            out, at = [], 0
            for cpu in (0, 1):
                r = submit(_ctx_save(p, cpu), at, cpu)
                out.append((tuple(r.ticks), r.done))
                at = r.done
            r = submit(p.session.HtpTransaction().tick().utick(0), at, 0)
            out.append((tuple(r.ticks), r.done))
            return out
        router = p.FleetRouter(_mk_devices(p, 1, link="uart"))
        sess = p.cq.AsyncHtpSession(PySim(2, 1 << 20),
                                    p.channel.UartChannel())
        fleet = trace(lambda txn, at, cpu:
                      router.submit(txn, at, stream=(0, cpu)))
        plain_ = trace(lambda txn, at, cpu:
                       sess.submit(txn, at, stream=cpu))
        r = router.submit(p.session.HtpTransaction().reg_read(0, 1), 0,
                          stream=0)
        return fleet, plain_, router.stats(), sess.channel.total_bytes, \
            r.done
    fleet, plain_, stats, total, done = both(scenario)
    assert fleet == plain_
    assert stats["total_bytes"] >= total and done > 0


def test_device_hart_stream_isolation_and_dependency_tokens():
    def scenario(p):
        router = p.FleetRouter(_mk_devices(p, 2))
        r0 = router.submit(_ctx_save(p, 0), 0, stream=(0, 0))
        r1 = router.submit(_ctx_save(p, 0), 0, stream=(1, 0))
        one = p.FleetRouter(_mk_devices(p, 1))
        a = one.submit(_ctx_save(p, 0), 0, stream=(0, 0))
        b = one.submit(_ctx_save(p, 1), 0, stream=(0, 1))
        r2 = router.submit(p.session.HtpTransaction().reg_read(0, 1), 0,
                           stream=(1, 0), deps=(r0.token,))
        with pytest.raises(KeyError):
            router.submit(p.session.HtpTransaction().reg_read(0, 1), 0,
                          stream=(5, 0))
        return (r0.done, r1.done, a.done, b.done, r2.done,
                len(router.tail_tokens()), router.quiesce_tick(),
                router.stats())
    r0, r1, a, b, r2, ntok, quiesce, stats = both(scenario)
    assert r0 == r1 and b > a and r2 >= r0
    assert ntok == 2 and quiesce >= max(r0, r2)
    assert stats["per_device"][0]["transactions"] == 1


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def test_placement_policy_correctness():
    def scenario(p):
        devs = _mk_devices(p, 4)
        rr = p.make_policy("round_robin")
        order = [rr.place(None, devs).id for _ in range(6)]
        devs[0].stats.busy_ticks = 100
        devs[1].stats.busy_ticks = 5
        devs[2].stats.busy_ticks = 50
        ll = p.make_policy("least_loaded")
        first = ll.place(None, devs).id
        devs[3].stats.busy_ticks = 500
        second = ll.place(None, devs).id
        af = p.make_policy("affinity")
        sticky = [af.place(p.Job("hello", affinity_key=k), devs).id
                  for k in ("tenant-a", "tenant-a", "tenant-b", 42)]
        keyless = [af.place(p.Job("hello"), devs).id for _ in range(4)]
        with pytest.raises(KeyError):
            p.make_policy("nope")
        return order, first, second, sticky, keyless, \
            sorted(p.placement.POLICIES), \
            p.placement.stable_hash("tenant-a")
    order, first, second, sticky, keyless, names, h = both(scenario)
    assert order == [0, 1, 2, 3, 0, 1]
    assert (first, second) == (3, 1)
    assert sticky[0] == sticky[1] and keyless == [0, 1, 2, 3]
    assert h == 0xC2EF8128E3EB9EFB


def test_provisioning_charges_and_provision_aware_placement():
    def scenario(p):
        d = p.Device(0, lambda: PySim(1, 1 << 20), provision_us=100.0)
        seen = [d.provision_ticks_for("a")]
        for key in ("a", "a", "b"):
            d.provision(key)
            seen.append((d.stats.provisions, d.stats.provision_ticks,
                         d.clock, d.provision_ticks_for("a")))
        devs = [p.Device(i, lambda: PySim(1, 1 << 20), provision_us=100.0)
                for i in range(2)]
        devs[0].provision("hello")
        devs[0].stats.busy_ticks = 1_000
        job_a, job_b = p.Job("hello"), p.Job("coremark")
        aware = p.make_policy("least_loaded")
        blind = p.make_policy("least_loaded_blind")
        adaptive = p.make_policy("least_loaded_adaptive")
        return seen, aware.place(job_a, devs).id, \
            blind.place(job_a, devs).id, aware.place(job_b, devs).id, \
            adaptive.place(job_a, devs).id, \
            p.placement.image_key_of(job_a), d.stats.as_dict()
    seen, aware_a, blind_a, aware_b, adaptive_a, key, stats = \
        both(scenario)
    assert seen[0] == 10_000
    assert seen[1:] == [(1, 10_000, 10_000, 0), (1, 10_000, 10_000, 0),
                        (2, 20_000, 20_000, 10_000)]
    assert (aware_a, blind_a, aware_b, adaptive_a) == (0, 1, 1, 0)
    assert key == "hello"


# ---------------------------------------------------------------------------
# the fleet runtime
# ---------------------------------------------------------------------------
def test_single_device_fleet_tick_identical_to_async_runtime():
    def scenario(p):
        fr = p.FleetRuntime(n_devices=1, make_target=lambda: PySim(2, 1 << 22),
                            link="uart")
        fr.submit(p.Job("hello"))
        fleet_rep = fr.run()
        rt = p.runtime.FaseRuntime(PySim(2, 1 << 22), mode="fase",
                                   link="uart", session="async")
        rt.load(p.workloads.build("hello"), ["hello"])
        return fleet_rep, rt.run(max_ticks=1 << 40)
    fleet_rep, plain_rep = both(scenario)
    jr = fleet_rep.jobs[0].report
    assert (jr.ticks, jr.traffic_total, jr.stall, jr.traffic,
            jr.stdout) == (plain_rep.ticks, plain_rep.traffic_total,
                           plain_rep.stall, plain_rep.traffic,
                           plain_rep.stdout)
    assert fleet_rep.makespan_ticks == plain_rep.ticks


def test_fleet_runs_report_equal_to_the_reference():
    """Placement, scaling, determinism, warm fleets, mixed links, billed
    provisioning: the reports and the boards' stats, field for field."""
    g = graphgen.rmat(4, 8, weights=True)

    def scenario(p):
        out = []
        fr = _fleet(p, 2, mem=1 << 23, placement="least_loaded")
        fr.submit(p.Job("bc", ["g.bin", "1", "1"], files={"g.bin": g}))
        fr.submit(p.Job("hello"), replicas=2)
        out.append(fr.run())
        for n in (1, 4):
            fr = _fleet(p, n)
            fr.submit(p.Job("hello"), replicas=4)
            out.append(fr.run())
        fr = _fleet(p, 2)
        for extra in (0, 0, 1):
            if extra:
                fr.devices[0].stats.busy_ticks += 10 * out[-1].makespan_ticks
            fr.submit(p.Job("hello"), replicas=2)
            out.append(fr.run())
        router = fr.router()
        out.append((router.stats(), router.tail_tokens(),
                    router.quiesce_tick(),
                    [d.provisioned for d in fr.devices]))
        fr = _fleet(p, 2, links=["uart", "pcie"])
        fr.submit(p.Job("hello"), replicas=2)
        out.append(fr.run())
        fr = _fleet(p, 2, placement="least_loaded", provision_us=50.0)
        fr.submit(p.Job("hello"), replicas=4)
        out.append(fr.run())
        out.append([d.stats.as_dict() for d in fr.devices])
        return out
    out = both(scenario)
    mixed, r1, r4 = out[1], out[1], out[2]
    assert r4.makespan_ticks * 4 == r1.makespan_ticks
    assert r4.balance == 1.0 and r4.total_bytes == r1.total_bytes
    assert out[4].makespan_ticks == out[3].makespan_ticks == \
        out[5].makespan_ticks
    stats, tokens, quiesce, provisioned = out[6]
    assert stats["total_bytes"] > 0 and tokens == () and quiesce == 0
    assert not any(provisioned)
    mixed = {r.device_id: r.report for r in out[7].jobs}
    assert mixed[0].ticks > mixed[1].ticks
    assert 2 <= sum(d["provisions"] for d in out[9]) < 4


# ---------------------------------------------------------------------------
# live migration
# ---------------------------------------------------------------------------
def _migration(p, kind):
    base = _fleet(p)
    ref = base.run_job(base.devices[0], p.Job("hello"))
    fr = _fleet(p)
    h = fr.start_job(p.Job("hello"), fr.devices[0])
    snap = None
    if kind != "full":
        fr.step_job(h, pause_ticks=ref.report.ticks // 4)
        snap = fr.prepare_migration(h, fr.devices[1])
        if kind == "stale":
            fr.run_job(fr.devices[1], p.Job("hello"))
    fr.step_job(h, pause_ticks=ref.report.ticks // 2)
    mig = fr.migrate(h, fr.devices[1], base=snap)
    res = fr.finish_job(h)
    return ref, mig, res, [d.stats.as_dict() for d in fr.devices], \
        h.device.id, len(h.migrations)


@pytest.mark.parametrize("kind", ["full", "delta", "stale"])
def test_migration_reports_equal_to_the_reference(kind):
    ref, mig, res, stats, dev, n = both(
        functools.partial(_migration, kind=kind))
    assert res.report.stdout == ref.report.stdout
    assert res.report.ticks > ref.report.ticks
    assert mig.downtime_ticks > 0 and (dev, n) == (1, 1)
    if kind == "delta":
        assert mig.delta and mig.pages_shipped < mig.pages_total
        assert mig.dst_bytes < 4096 * mig.pages_total
    else:
        assert not mig.delta and mig.pages_shipped == mig.pages_total
        assert mig.dst_bytes > 4096 * mig.pages_total


def test_migrate_requires_distinct_destination():
    fr = _fleet(PORT)
    h = fr.start_job(PORT.Job("hello"), fr.devices[0])
    fr.step_job(h, pause_ticks=1000)
    with pytest.raises(AssertionError):
        fr.migrate(h, fr.devices[0])


# ---------------------------------------------------------------------------
# the pins of results/fleet_scale.json and results/migration.json
# ---------------------------------------------------------------------------
def test_fleet_scale_pins_on_the_port():
    """``benchmarks/fleet_scale.py``'s scale panel (8 replicas of bc 1T on
    rmat(5, 8), one core and 8 MiB a board, FASE_FLEET's queue pairs)
    through the port's fleet: the makespans of ``results/fleet_scale.json``
    at N = 1, 2, 4 on both links."""
    with open(ROOT / "results" / "fleet_scale.json") as f:
        rows = json.load(f)["scale"]
    fk = PORT.fase_rocket.fleet_kwargs(PORT.fase_rocket.FASE_FLEET)
    g = graphgen.rmat(5, 8, weights=True)
    for row in rows:
        kw = dict(fk, n_devices=row["n_devices"], link=row["link"],
                  placement="round_robin")
        kw.pop("links", None)
        fr = PORT.FleetRuntime(make_target=lambda: PySim(1, 1 << 23), **kw)
        fr.submit(PORT.Job("bc", ["g.bin", "1", "1"], files={"g.bin": g}),
                  replicas=row["jobs"])
        rep = fr.run()
        assert (rep.makespan_ticks, rep.total_job_ticks,
                rep.total_bytes) == (row["makespan_ticks"],
                                     row["total_job_ticks"],
                                     row["total_bytes"]), row


def test_migration_pins_on_the_port():
    """``benchmarks/migration.py``'s PCIe row (bc 1T, 48 trials on rmat(5,
    8), full migration at 70 % of the instructions) through the port's
    fleet: the baseline and migrated ticks, pages and bytes of
    ``results/migration.json``."""
    with open(ROOT / "results" / "migration.json") as f:
        row = next(r for r in json.load(f)["migration"]
                   if r["link"] == "pcie")
    from benchmarks.migration import _pause_at_instret
    g = graphgen.rmat(5, 8, weights=True)

    def fleet(n):
        return PORT.FleetRuntime(make_target=lambda: PySim(1, 1 << 23),
                                 n_devices=n, links=["pcie"] * n)
    job = functools.partial(PORT.Job, "bc", ["g.bin", "1", "48"],
                            files={"g.bin": g})
    base = fleet(1)
    b = base.run_job(base.devices[0], job())
    fr = fleet(2)
    h = fr.start_job(job(), fr.devices[0])
    _pause_at_instret(fr, h, int(b.report.instret[0] * 0.7))
    mig = fr.migrate(h, fr.devices[1])
    res = fr.finish_job(h)
    assert (b.report.ticks, res.report.ticks, mig.pages_shipped,
            mig.src_bytes, mig.dst_bytes) == (
        row["baseline_ticks"], row["migrated_ticks"], row["full"]["pages"],
        row["full"]["src_bytes"], row["full"]["dst_bytes"])


# ---------------------------------------------------------------------------
# fleet-sharded serving
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _serve_params():
    from repro.configs import CONFIGS
    from repro.models import core as JM
    from repro_torch.models.convert import params_from_jax
    jp = JM.init_params(CONFIGS["qwen3-8b"].smoke(), 0)
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _serve(p, links, policy):
    """The reference test's slot-migration run at smoke width, with a
    ``max_seq`` that keeps every page id below ``pages_per_seq`` (where
    the reference engine is well defined, tests/test_torch_serving.py)."""
    jp, tp = _serve_params()
    cfgs = importlib.import_module(f"{p.root}.configs").CONFIGS
    engine = importlib.import_module(f"{p.root}.serving.engine")
    kw = {} if p is REF else dict(device="cpu")
    fr = p.FleetRuntime(make_target=lambda: PySim(1, 1 << 20),
                        n_devices=len(links), links=list(links))
    eng = engine.ServeEngine(cfgs["qwen3-8b"].smoke(),
                             jp if p is REF else tp, slots=4, max_seq=512,
                             poll_every=2, fleet=fr, slot_policy=policy,
                             rebalance_every=2, **kw)
    for i in range(6):
        eng.submit(engine.Request(rid=i, prompt=[3 + i, 7, 11], max_new=12,
                                  eos=1))
    done = eng.run()
    out = sorted((r.rid, tuple(r.out)) for r in done)
    return (out, eng.steps, eng.step_spans, eng.link_tick,
            eng.slot_migrations, dict(eng.traffic.by_cat),
            eng.traffic.h2d_bytes, eng.traffic.d2h_bytes,
            [(d, list(s)) for d, s in eng._dev_slots],
            eng.router.stats())


@pytest.mark.parametrize("links", [("pcie", "pcie_far"), ("pcie", "pcie")],
                         ids=["skewed", "balanced"])
def test_fleet_sharded_serving_equals_the_reference(links):
    """Streams, steps, per-step spans, slot moves and the traffic per
    category and per board equal the reference engine's, for sticky and
    least_loaded slot placement; sticky and least_loaded give the same
    tokens; on the skewed fleet slots move off the slow board and are
    billed, on the balanced one nothing moves."""
    sticky = both(functools.partial(_serve, links=links, policy="sticky"))
    ll = both(functools.partial(_serve, links=links,
                                policy="least_loaded"))
    assert sticky[0] == ll[0]
    stats = sticky[9]
    assert stats["per_device"][0]["wire_bytes"] > 0
    assert stats["per_device"][1]["wire_bytes"] > 0
    if links[1] == "pcie_far":
        assert ll[4] > 0 and ll[5]["slot_migrate"] > 0
        assert sum(ll[2]) / len(ll[2]) < sum(sticky[2]) / len(sticky[2])
        assert dict(ll[8])[1] == []
    else:
        assert ll[4] == 0 and "slot_migrate" not in ll[5]
        assert ll[3] == sticky[3]


def test_serving_command_batches_shard_across_devices():
    """A command batch split by board keeps the byte totals and the
    categories of the single-session batch."""
    def scenario(p):
        htp = importlib.import_module(f"{p.root}.serving.htp")
        router = p.FleetRouter(_mk_devices(p, 2))
        single = p.cq.AsyncHtpSession(None, p.channel.PcieChannel())
        cb = htp.CommandBatch.empty(slots=4, pages=8)
        cb.override[:] = 7
        cb.page_zeros = [3, 5]
        for k in range(2):
            slots = [k, k + 2]
            sub = htp.CommandBatch(
                override=cb.override[slots], eos=cb.eos[slots],
                max_lens=cb.max_lens[slots],
                block_tables=cb.block_tables[slots],
                page_zeros=list(cb.page_zeros[k::2]))
            router.submit(sub.to_transaction(), 0, stream=(k, "serve"))
        single.submit(cb.to_transaction(), 0, stream="serve")
        return router.stats(), single.channel.total_bytes, \
            dict(single.channel.bytes_by_cat)
    st, total, by_cat = both(scenario)
    assert st["total_bytes"] == total and st["bytes_by_cat"] == by_cat
    assert st["per_device"][0]["wire_bytes"] == \
        st["per_device"][1]["wire_bytes"]
