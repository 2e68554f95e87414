"""Fleet scale-out on the port: aggregate throughput against board count,
link and placement, every board a target on the card by default.

The twin of the reference's ``benchmarks/fleet_scale.py``: the same three
panels (``scale``: replicated bc jobs, round-robin, over board count and
link; ``placement``: a skewed big/small mix under three policies;
``uart_identical``: a 1-board UART fleet against a plain async
``FaseRuntime`` on the same kind of target), sizes and ``--quick`` cut,
each row with its ``wall_s``.  Each board comes from
:func:`panels.make_target`.  Writes ``results/torch_fleet_scale.json``.
"""
from __future__ import annotations

from . import panels
from ..configs.fase_rocket import FASE_FLEET, fleet_kwargs
from ..core.consts import CLOCK_HZ
from ..core.fleet import FleetRuntime, Job
from ..core.runtime import FaseRuntime
from ..core.workloads import build, graphgen

N_CORES = 1
MEM = 1 << 23


def _fleet(n: int, link: str, placement: str, target: str) -> FleetRuntime:
    kw = fleet_kwargs(FASE_FLEET)
    kw.update(n_devices=n, link=link, placement=placement)
    kw.pop("links", None)
    return FleetRuntime(
        make_target=lambda: panels.make_target(target, N_CORES, MEM), **kw)


def scale_panel(quick: bool, target: str = "card") -> tuple[list, float]:
    g = graphgen.rmat(4 if quick else 5, 8, weights=True)
    replicas = 4 if quick else 8
    counts = (1, 4) if quick else (1, 2, 4)
    rows = []
    base = {}
    scaling_n4_pcie = 0.0
    for link in ("uart", "pcie"):
        for n in counts:
            fr = _fleet(n, link, "round_robin", target)
            fr.submit(Job("bc", ["g.bin", "1", "1"], files={"g.bin": g}),
                      replicas=replicas)
            rep, wall = panels.timed(target, fr.run)
            if n == 1:
                base[link] = rep.makespan_ticks
            speedup = base[link] / rep.makespan_ticks
            if link == "pcie" and n == counts[-1]:
                scaling_n4_pcie = speedup
            rows.append(dict(
                link=link, n_devices=n, placement="round_robin",
                jobs=replicas, makespan_ticks=rep.makespan_ticks,
                total_job_ticks=rep.total_job_ticks,
                jobs_per_s=rep.jobs_per_second, speedup_vs_1dev=speedup,
                balance=rep.balance, total_bytes=rep.total_bytes,
                wall_s=wall))
            print(f"fleet_scale,bc-x{replicas}@{link}/n{n},"
                  f"{rep.makespan_ticks},"
                  f"{rep.jobs_per_second:.2f} jobs/s "
                  f"speedup={speedup:.2f}x balance={rep.balance:.3f} "
                  f"({target} {wall:.2f}s)", flush=True)
    return rows, scaling_n4_pcie


def placement_panel(quick: bool, target: str = "card") -> list:
    """Skewed mix: big/small jobs alternating — round-robin piles the big
    jobs onto one board, least-loaded levels the fleet online."""
    g = graphgen.rmat(4 if quick else 5, 8, weights=True)
    rows = []
    for policy in ("round_robin", "least_loaded", "affinity"):
        fr = _fleet(2, "pcie", policy, target)
        for i in range(2):
            fr.submit(Job("bc", ["g.bin", "1", "2"], files={"g.bin": g},
                          affinity_key=f"tenant-{2 * i}"))
            fr.submit(Job("hello", affinity_key=f"tenant-{2 * i + 1}"))
        rep, wall = panels.timed(target, fr.run)
        rows.append(dict(
            policy=policy, n_devices=2, link="pcie",
            makespan_ticks=rep.makespan_ticks, balance=rep.balance,
            per_device_busy={k: v["busy_ticks"]
                             for k, v in rep.devices.items()},
            assignment=[(r.job.job_id, r.device_id) for r in rep.jobs],
            wall_s=wall))
        print(f"fleet_placement,{policy},{rep.makespan_ticks},"
              f"balance={rep.balance:.3f} ({target} {wall:.2f}s)",
              flush=True)
    return rows


def identity_row(tag: str, fleet_report, target: str) -> dict:
    """The degenerate contract: ``fleet_report()`` (hello on a 1-board
    UART fleet) against a plain async ``FaseRuntime`` on a board of the
    same kind, tick for tick, both on ``target``; ``tag`` names the
    printed line."""
    fleet_rep, w0 = panels.timed(target, fleet_report)
    rt = FaseRuntime(panels.make_target(target, N_CORES, MEM), mode="fase",
                     link="uart", session="async")
    rt.load(build("hello"), ["hello"])
    plain_rep, w1 = panels.run_runtime(rt, target, max_ticks=1 << 40)
    identical = (fleet_rep.ticks == plain_rep.ticks and
                 fleet_rep.traffic_total == plain_rep.traffic_total and
                 fleet_rep.stdout == plain_rep.stdout)
    print(f"{tag},hello,{int(identical)},"
          f"fleet={fleet_rep.ticks} plain={plain_rep.ticks}", flush=True)
    return dict(workload="hello", identical=identical,
                fleet_ticks=fleet_rep.ticks, plain_ticks=plain_rep.ticks,
                wall_s=w0 + w1)


def uart_identity_check(target: str = "card") -> dict:
    """1-board UART fleet ≡ plain async FaseRuntime, tick for tick, both
    on ``target``."""
    fr = _fleet(1, "uart", "round_robin", target)
    fr.submit(Job("hello"))
    return identity_row("fleet_uart_identity",
                        lambda: fr.run().jobs[0].report, target)


def run(quick=False, target="card", out_dir=None):
    scale, scaling_n4_pcie = scale_panel(quick, target)
    placement = placement_panel(quick, target)
    identity = uart_identity_check(target)
    out = dict(quick=quick, clock_hz=CLOCK_HZ, scale=scale,
               placement=placement, scaling_n4_pcie=scaling_n4_pcie,
               uart_identical=identity)
    panels.save_json("fleet_scale", out, target, quick, out_dir)
    print(f"fleet_scale,summary,{scaling_n4_pcie:.2f},"
          f"x aggregate throughput at N=4 on pcie "
          f"(uart_identical={identity['identical']})", flush=True)
    return out


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, ["fleet_scale"]))
