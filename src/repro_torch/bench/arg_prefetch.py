"""Speculative syscall-argument prefetch on the port: bytes against round
trips, per link, on the card by default.

The twin of the reference's ``benchmarks/arg_prefetch.py`` (lazy RegR
reads against one a7 + a0..a5 transaction at ``Next`` time, under the
full host-latency model and the link-isolated one): the same rows, sizes
and ``--quick`` cut, each row with its ``wall_s`` (lazy and prefetch runs).
Writes ``results/torch_arg_prefetch.json``.
"""
from __future__ import annotations

from . import panels


def _measure(wl, argv, files, link, prefetch, host_us_per_req, target):
    rt, rep, wall = panels.run_workload(
        wl, argv, target, mode="fase", n_cores=1, files=files, link=link,
        host_us_per_req=host_us_per_req, arg_prefetch=prefetch)
    return dict(ticks=rep.ticks, bytes=rep.traffic_total,
                link_stall=rep.stall["uart_ticks"],
                transactions=rt.session.stats.transactions), wall


def run(quick: bool = False, target="card", out_dir=None):
    from ..core.workloads import graphgen
    g = graphgen.rmat(4, 8, weights=True)
    workloads = [("hello", [], None)]
    if not quick:
        workloads.append(("bc", ["g.bin", "1", "1"], {"g.bin": g}))
    rows = []
    for wl, argv, files in workloads:
        for link in ("uart", "pcie"):
            for model, per_req in (("host_full", 12.0), ("link_only", 0.0)):
                lazy, w0 = _measure(wl, argv, files, link, False, per_req,
                                    target)
                pf, w1 = _measure(wl, argv, files, link, True, per_req,
                                  target)
                row = dict(
                    workload=wl, link=link, model=model,
                    lazy=lazy, prefetch=pf,
                    ticks_saved=lazy["ticks"] - pf["ticks"],
                    extra_bytes=pf["bytes"] - lazy["bytes"],
                    round_trips_saved=(lazy["transactions"]
                                       - pf["transactions"]),
                    prefetch_wins=pf["ticks"] < lazy["ticks"],
                    wall_s=w0 + w1)
                rows.append(row)
                print(f"arg_prefetch,{wl}@{link}/{model},"
                      f"{row['ticks_saved']},ticks saved "
                      f"(+{row['extra_bytes']}B, "
                      f"-{row['round_trips_saved']} round trips, "
                      f"wins={row['prefetch_wins']}) "
                      f"({target} {w0 + w1:.2f}s)", flush=True)
    # the crossover verdict: on pure link timing, prefetch trades
    # bytes (loses on uart) for round trips (wins on pcie)
    verdict = {
        link: all(r["prefetch_wins"] == (link == "pcie") for r in rows
                  if r["link"] == link and r["model"] == "link_only")
        for link in ("uart", "pcie")}
    out = dict(quick=quick, rows=rows, link_only_crossover=dict(
        uart_prefetch_loses=verdict["uart"],
        pcie_prefetch_wins=verdict["pcie"]))
    panels.save_json("arg_prefetch", out, target, quick, out_dir)
    print(f"arg_prefetch,crossover,1,uart_loses={verdict['uart']} "
          f"pcie_wins={verdict['pcie']}", flush=True)
    return out


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, ["arg_prefetch"]))
