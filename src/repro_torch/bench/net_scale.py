"""Inter-board fabric scale on the port: gang makespan against switch
bandwidth and latency, every board a target on the card by default.

The twin of the reference's ``benchmarks/net_scale.py``: a gang of 1-D
partitioned bc members with BSP halo exchange over
``Switch(**net_kwargs(FASE_FLEET_NET))``, swept over port bandwidth
(makespan must fall), crossbar latency (makespan must rise), board count
(2 and 4, with the per-port counters) and superstep pacing
(``superstep_ticks="auto"`` against the fixed 200k quantum).  The same
rows, sizes and ``--quick`` cut, each row with its ``wall_s``; the three
verdicts (``bandwidth_monotone``, ``latency_monotone``,
``pacing_improves``) are modelled numbers too.  Writes
``results/torch_net_scale.json``.
"""
from __future__ import annotations

from . import panels
from ..configs.fase_rocket import FASE_FLEET_NET, net_kwargs
from ..core.consts import CLOCK_HZ
from ..core.fleet import FleetRuntime, Job
from ..core.net import GangJob, Switch
from ..core.workloads import graphgen

N_CORES = 1
MEM = 1 << 23

#: BSP quantum / halo depth chosen so fabric time is visible against
#: compute: ~40k-tick supersteps with 4-page halos put each exchange's
#: delivery on the critical path of the next barrier.
SUPERSTEP_TICKS = 40_000
HALO_PAGES = 4


def _gang(boards: int, graph: bytes, cfg: dict, target: str,
          superstep_ticks=SUPERSTEP_TICKS, iters: int = 1):
    parts = graphgen.partition(graph, boards)
    fleet = FleetRuntime(
        n_devices=boards,
        make_target=lambda: panels.make_target(target, N_CORES, MEM),
        link="pcie", fabric=Switch(**net_kwargs(cfg)))
    gang = GangJob([Job("bc", ["part.bin", "1", str(iters)],
                        files={"part.bin": p}) for p in parts],
                   superstep_ticks=superstep_ticks,
                   halo_pages=HALO_PAGES)
    return fleet, fleet.start_gang(gang)


def _run_gang(boards, graph, cfg, target, **kw):
    """The gang's report and wall seconds."""
    fleet, rg = _gang(boards, graph, cfg, target, **kw)
    return panels.timed(target, lambda: fleet.run_gang(rg))


def _row(cfg: dict, boards: int, graph: bytes, target: str) -> dict:
    rep, wall = _run_gang(boards, graph, cfg, target)
    fab = rep.fabric
    return dict(
        boards=boards,
        gbits_per_s=cfg["net_gbits_per_s"],
        latency_ticks=cfg["net_latency_ticks"],
        makespan_ticks=rep.makespan_ticks,
        makespan_s=rep.makespan_seconds,
        supersteps=rep.supersteps, exchanges=rep.exchanges,
        wait_ticks=rep.wait_ticks,
        fabric_bytes=fab["total_bytes"], fabric_frames=fab["frames"],
        credit_stalls=sum(p["credit_stalls"] for p in fab["ports"]),
        link_util=max(p["link_util"] for p in fab["ports"]),
        wall_s=wall)


def bandwidth_panel(graph: bytes, quick: bool,
                    target: str = "card") -> tuple[list, bool]:
    sweep = (1.0, 16.0) if quick else (1.0, 4.0, 16.0, 64.0)
    rows = []
    for gbits in sweep:
        cfg = {**FASE_FLEET_NET, "net_gbits_per_s": gbits}
        r = _row(cfg, 2, graph, target)
        rows.append(r)
        print(f"net_scale,bc-gang2@{gbits}gbit,{r['makespan_ticks']},"
              f"stalls={r['credit_stalls']} util={r['link_util']:.4f} "
              f"({target} {r['wall_s']:.2f}s)", flush=True)
    mk = [r["makespan_ticks"] for r in rows]
    mono = all(a >= b for a, b in zip(mk, mk[1:])) and mk[0] > mk[-1]
    return rows, mono


def latency_panel(graph: bytes, quick: bool,
                  target: str = "card") -> tuple[list, bool]:
    sweep = (500, 2000) if quick else (100, 500, 2000, 8000)
    rows = []
    for lat in sweep:
        cfg = {**FASE_FLEET_NET, "net_latency_ticks": lat}
        r = _row(cfg, 2, graph, target)
        rows.append(r)
        print(f"net_scale,bc-gang2@lat{lat},{r['makespan_ticks']},"
              f"wait={r['wait_ticks']} ({target} {r['wall_s']:.2f}s)",
              flush=True)
    mk = [r["makespan_ticks"] for r in rows]
    mono = all(a <= b for a, b in zip(mk, mk[1:])) and mk[-1] > mk[0]
    return rows, mono


def boards_panel(graph: bytes, quick: bool, target: str = "card") -> list:
    rows = []
    for boards in (2,) if quick else (2, 4):
        rep, wall = _run_gang(boards, graph, FASE_FLEET_NET, target)
        rows.append(dict(
            boards=boards, devices=rep.device_ids,
            makespan_ticks=rep.makespan_ticks,
            supersteps=rep.supersteps, exchanges=rep.exchanges,
            member_ticks=[r.ticks for r in rep.reports],
            ports=rep.fabric["ports"], wall_s=wall))
        print(f"net_scale,bc-gang{boards}@default,{rep.makespan_ticks},"
              f"supersteps={rep.supersteps} exchanges={rep.exchanges} "
              f"({target} {wall:.2f}s)", flush=True)
    return rows


def pacing_panel(graph: bytes, quick: bool,
                 target: str = "card") -> tuple[dict, bool]:
    """Counter-driven superstep pacing vs the fixed 200k default: same
    gang, same fabric — the ``"auto"`` controller must cut barrier wait
    ticks against the fixed quantum."""
    iters = 8 if quick else 16
    rows = {}
    for mode in ("fixed", "auto"):
        rep, wall = _run_gang(
            2, graph, FASE_FLEET_NET, target,
            superstep_ticks=200_000 if mode == "fixed" else "auto",
            iters=iters)
        rows[mode] = dict(
            makespan_ticks=rep.makespan_ticks,
            supersteps=rep.supersteps, exchanges=rep.exchanges,
            wait_ticks=rep.wait_ticks,
            quanta=[r["quantum"] for r in rep.rounds],
            round_waits=[r["wait_ticks"] for r in rep.rounds],
            wall_s=wall)
        print(f"net_scale,bc-gang2@pacing-{mode},{rep.makespan_ticks},"
              f"wait={rep.wait_ticks} supersteps={rep.supersteps} "
              f"({target} {wall:.2f}s)", flush=True)
    improves = rows["auto"]["wait_ticks"] < rows["fixed"]["wait_ticks"]
    rows["pacing_improves"] = improves
    return rows, improves


def run(quick=False, target="card", out_dir=None):
    graph = graphgen.rmat(4 if quick else 5, 4, seed=42, weights=False)
    bw_rows, bw_mono = bandwidth_panel(graph, quick, target)
    lat_rows, lat_mono = latency_panel(graph, quick, target)
    boards = boards_panel(graph, quick, target)
    pacing, pacing_improves = pacing_panel(graph, quick, target)
    out = dict(quick=quick, clock_hz=CLOCK_HZ,
               superstep_ticks=SUPERSTEP_TICKS, halo_pages=HALO_PAGES,
               bandwidth=bw_rows, bandwidth_monotone=bw_mono,
               latency=lat_rows, latency_monotone=lat_mono,
               boards=boards, pacing=pacing,
               pacing_improves=pacing_improves)
    panels.save_json("net_scale", out, target, quick, out_dir)
    print(f"net_scale,summary,{int(bw_mono and lat_mono)},"
          f"makespan monotone in bandwidth({bw_mono}) and "
          f"latency({lat_mono})", flush=True)
    return out


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, ["net_scale"]))
