"""Fleet-wide stall attribution on the port, from the out-of-band counter
bridge, every board a target on the card by default.

The twin of the reference's ``benchmarks/stall_attribution.py``: 2-core
boards with the counter bridge armed (``telemetry_kwargs(FASE_FLEET)``)
behind the fabric, a 2-member gang first, then a skewed mix of bc and
hello jobs.  Each job's final counter sample splits each hart's ticks
into ``compute`` (``uticks``), ``link_stall`` (``stall_ticks``) and
``idle`` (the rest, asserted ``>= 0``).  The tables are the fleet-wide
(device, core, reason) breakdown, the roofline-style per-device rows, the
telemetry lane's health per job and the per-port fabric rows.  The same
sizes and ``--quick`` cut; the gang and the mix each carry their
``wall_s``.  Writes ``results/torch_stall_attribution.json``.
"""
from __future__ import annotations

from . import panels
from ..configs.fase_rocket import (FASE_FLEET, FASE_FLEET_NET, fleet_kwargs,
                                   net_kwargs, telemetry_kwargs)
from ..core.consts import CLOCK_HZ
from ..core.fleet import FleetRuntime, Job
from ..core.net import GangJob, Switch
from ..core.workloads import graphgen

N_CORES = 2
MEM = 1 << 23
REASONS = ("compute", "link_stall", "idle")


def _fleet(quick: bool, target: str) -> FleetRuntime:
    kw = fleet_kwargs(FASE_FLEET)
    kw.pop("links", None)
    tel = telemetry_kwargs(FASE_FLEET)
    if quick:
        tel["interval_ticks"] = 20_000
    return FleetRuntime(
        make_target=lambda: panels.make_target(target, N_CORES, MEM),
        runtime_kwargs={"telemetry": tel},
        fabric=Switch(**net_kwargs(FASE_FLEET_NET)), **kw)


def _job_core_rows(result) -> list[dict]:
    """Per-hart reason decomposition of one finished job, from its
    final (forced) counter sample."""
    tel = result.report.telemetry
    sample = tel["counters"]["samples"][-1]
    ticks = sample["tick"]
    rows = []
    for c, ctr in enumerate(sample["cores"]):
        compute = ctr["uticks"]
        link_stall = ctr["stall_ticks"]
        idle = ticks - compute - link_stall
        assert idle >= 0, (result.job.job_id, c, ticks, ctr)
        rows.append(dict(device=result.device_id, job=result.job.job_id,
                         workload=result.job.name, core=c, ticks=ticks,
                         instret=ctr["instret"], compute=compute,
                         link_stall=link_stall, idle=idle))
    return rows


def run(quick=False, target="card", out_dir=None):
    g = graphgen.rmat(4 if quick else 5, 8, weights=True)
    fr = _fleet(quick, target)
    # a gang-scheduled multi-board job first: its halo traffic loads the
    # switch ports whose counters the fabric panel attributes below
    parts = graphgen.partition(graphgen.rmat(4, 4, weights=False), 2)
    rg = fr.start_gang(GangJob(
        [Job("bc", ["part.bin", "1", "1"], files={"part.bin": p})
         for p in parts], superstep_ticks=40_000, halo_pages=4))
    gang, gang_wall = panels.timed(target, lambda: fr.run_gang(rg))
    n_jobs = 4 if quick else 8
    for i in range(n_jobs):
        if i % 4 == 3:        # skew the mix: every 4th job is tiny
            fr.submit(Job("hello"))
        else:
            fr.submit(Job("bc", ["g.bin", str(N_CORES), "1"],
                          files={"g.bin": g}))
    rep, mix_wall = panels.timed(target, fr.run)

    job_rows = [r for res in rep.jobs for r in _job_core_rows(res)]

    # fleet-wide (device, core, reason) aggregation
    agg: dict = {}
    for r in job_rows:
        key = (r["device"], r["core"])
        a = agg.setdefault(key, dict.fromkeys(
            REASONS + ("ticks", "instret"), 0))
        for reason in REASONS:
            a[reason] += r[reason]
        a["ticks"] += r["ticks"]
        a["instret"] += r["instret"]
    breakdown = []
    for (dev, core), a in sorted(agg.items()):
        total = max(a["ticks"], 1)
        for reason in REASONS:
            breakdown.append(dict(device=dev, core=core, reason=reason,
                                  ticks=a[reason],
                                  frac=a[reason] / total))
        print(f"stall_attribution,dev{dev}/core{core},{a['ticks']},"
              + " ".join(f"{reason}={a[reason] / total:.3f}"
                         for reason in REASONS), flush=True)

    # roofline-style per-device panel: modelled instruction throughput
    # against wire traffic intensity
    roofline = []
    for dev, stats in sorted(rep.devices.items()):
        instret = sum(a["instret"] for (d, _), a in agg.items()
                      if d == dev)
        busy_s = stats["busy_ticks"] / CLOCK_HZ
        roofline.append(dict(
            device=dev, jobs=stats["jobs"], busy_ticks=stats["busy_ticks"],
            instret=instret, wire_bytes=stats["wire_bytes"],
            instr_per_s=instret / max(busy_s, 1e-12),
            bytes_per_instr=stats["wire_bytes"] / max(instret, 1)))

    # telemetry-lane health across the fleet (drops are allowed — the
    # lane is lossy by design — but must be visible)
    lane = [dict(device=res.device_id, job=res.job.job_id,
                 **res.report.telemetry["stream"])
            for res in rep.jobs]

    # per-port fabric attribution: where the gang's exchange time went
    # on the switch (same counters every telemetry sample carries)
    fab = fr.fabric.report(horizon=gang.makespan_ticks)
    fabric_rows = []
    for p in fab["ports"]:
        fabric_rows.append(dict(
            device=p["port"], label=p["label"],
            link_util=p["link_util"], credit_stalls=p["credit_stalls"],
            credit_stall_ticks=p["credit_stall_ticks"],
            tx_bytes=p["tx_bytes"], rx_bytes=p["rx_bytes"]))
        print(f"stall_attribution,port{p['port']}/{p['label']},"
              f"{p['credit_stall_ticks']},"
              f"util={p['link_util']:.4f} stalls={p['credit_stalls']} "
              f"tx={p['tx_bytes']}", flush=True)

    out = dict(quick=quick, clock_hz=CLOCK_HZ,
               n_devices=rep.n_devices, n_jobs=n_jobs,
               makespan_ticks=rep.makespan_ticks,
               breakdown=breakdown, per_job_cores=job_rows,
               roofline=roofline, telem_lane=lane,
               gang=dict(makespan_ticks=gang.makespan_ticks,
                         supersteps=gang.supersteps,
                         exchanges=gang.exchanges,
                         wait_ticks=gang.wait_ticks, wall_s=gang_wall),
               fabric=fabric_rows, wall_s=mix_wall)
    panels.save_json("stall_attribution", out, target, quick, out_dir)
    devs = {r["device"] for r in breakdown}
    fleet_total = sum(r["ticks"] for r in breakdown)
    stall_frac = sum(r["ticks"] for r in breakdown
                     if r["reason"] == "link_stall") / max(fleet_total, 1)
    print(f"stall_attribution,summary,{rep.makespan_ticks},"
          f"devices={len(devs)} rows={len(breakdown)} "
          f"fleet_link_stall={stall_frac:.3f} "
          f"({target} {gang_wall + mix_wall:.2f}s)", flush=True)
    return out


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, ["stall_attribution"]))
