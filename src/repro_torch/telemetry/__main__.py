"""``python -m repro_torch.telemetry`` — timeline export + validation.

Subcommands:

  * ``timeline <workload>`` — run a canonical workload (``hello`` /
    ``bc``) with the transaction trace hook and both telemetry bridges
    armed, merge every footprint into Chrome trace-event JSON
    (:mod:`repro_torch.telemetry.timeline`) and write it out.
    ``--gang N`` runs the 1-D partitioned bc gang on an N-board
    fabric-attached fleet instead — the export then carries per-device
    tracks plus the gang superstep track.
  * ``validate <file>`` — the minimal schema check CI runs over
    exported artifacts; exits non-zero on any problem.

Runs go through :class:`~repro_torch.core.interface.TorchTarget` on the
card (``--device cpu`` runs the eager loop on the CPU instead).  The
timeline records protocol/lane ordering and modelled time, which are
target-independent: only the backend model counters of a counter sample
(``fetch_hits``, ``tlb_walks``) differ from a PySim run's.
"""
from __future__ import annotations

import argparse
import json
import sys

from .timeline import build_timeline, save_timeline, validate_timeline

#: both bridges armed, the tier-1 golden-run telemetry config
TELEMETRY = dict(counters=True, commit_trace=True,
                 interval_ticks=50_000, trace_slots=256)


def _timeline_solo(workload: str, link, quick: bool,
                   device: str = "cuda") -> dict:
    from ..analysis.trace import attach_trace
    from ..core.interface import TorchTarget
    from ..core.runtime import FaseRuntime
    from ..core.workloads import build, graphgen
    argv_tail, files, n_cores = [], {}, 1
    if workload == "bc":
        g = graphgen.rmat(4, 4, seed=42, weights=True)
        argv_tail, files, n_cores = ["g.bin", "1", "1"], {"g.bin": g}, 1
    rt = FaseRuntime(TorchTarget(n_cores, 1 << 23, device=device),
                     mode="fase", link=link,
                     session="async", telemetry=dict(TELEMETRY))
    trace = attach_trace(rt.session)
    rt.load(build(workload), [workload] + argv_tail, files=files)
    rep = rt.run()
    return build_timeline(
        trace=trace, telemetry=rep.telemetry,
        metadata=dict(workload=workload, link=link or "uart",
                      ticks=rep.ticks))


def _timeline_gang(boards: int, quick: bool, pacing: str,
                   device: str = "cuda") -> dict:
    from ..analysis.trace import attach_trace
    from ..configs.fase_rocket import FASE_FLEET_NET, net_kwargs
    from ..core.fleet import FleetRuntime, Job
    from ..core.interface import TorchTarget
    from ..core.net import GangJob, Switch
    from ..core.workloads import graphgen
    graph = graphgen.rmat(4 if quick else 5, 4, seed=42, weights=False)
    parts = graphgen.partition(graph, boards)
    fleet = FleetRuntime(
        n_devices=boards,
        make_target=lambda: TorchTarget(1, 1 << 23, device=device),
        link="pcie", fabric=Switch(**net_kwargs(FASE_FLEET_NET)),
        runtime_kwargs=dict(telemetry=dict(TELEMETRY)))
    trace = attach_trace(fleet)
    gang = GangJob([Job("bc", ["part.bin", "1", "1"],
                        files={"part.bin": p}) for p in parts],
                   superstep_ticks="auto" if pacing == "auto" else 40_000,
                   halo_pages=4)
    rg = fleet.start_gang(gang)
    rep = fleet.run_gang(rg)
    telem = {dev: r.telemetry for dev, r in
             zip(rep.device_ids, rep.reports) if r.telemetry}
    migs = [m for h in rg.handles for m in h.migrations]
    return build_timeline(
        trace=trace, telemetry=telem, gang=rep, migrations=migs,
        metadata=dict(workload="bc", gang=boards, pacing=pacing,
                      makespan_ticks=rep.makespan_ticks,
                      wait_ticks=rep.wait_ticks))


def cmd_timeline(args) -> int:
    if args.gang:
        doc = _timeline_gang(args.gang, args.quick, args.pacing,
                             args.device)
    else:
        doc = _timeline_solo(args.workload, args.link, args.quick,
                             args.device)
    problems = validate_timeline(doc)
    if problems:                      # never expected from our builder
        for p in problems:
            print(p, file=sys.stderr)
        return 1
    out = args.out or f"timeline_{args.workload}.json"
    save_timeline(doc, out)
    n = len(doc["traceEvents"])
    tracks = {(e["pid"], e.get("tid", "")) for e in doc["traceEvents"]
              if e["ph"] != "M"}
    print(f"timeline,{args.workload}"
          f"{'-gang%d' % args.gang if args.gang else ''},"
          f"{n} events,{len(tracks)} tracks -> {out}", flush=True)
    return 0


def cmd_validate(args) -> int:
    with open(args.file) as f:
        doc = json.load(f)
    problems = validate_timeline(doc)
    for p in problems:
        print(p, file=sys.stderr)
    print(f"validate,{args.file},"
          f"{'FAIL' if problems else 'PASS'},{len(problems)} problem(s)")
    return 1 if problems else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry",
        description="unified Perfetto timeline export + validation")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("timeline", help="run + export a timeline")
    pt.add_argument("workload", choices=("hello", "bc"))
    pt.add_argument("--gang", type=int, default=0, metavar="N",
                    help="run an N-board bc gang instead of a solo run")
    pt.add_argument("--pacing", choices=("fixed", "auto"),
                    default="fixed",
                    help="gang superstep pacing (default: fixed 40k)")
    pt.add_argument("--link", choices=("uart", "pcie"), default="pcie")
    pt.add_argument("--quick", action="store_true",
                    help="smaller graph for the gang run (CI smoke)")
    pt.add_argument("--out", default=None, help="output JSON path")
    pt.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the targets' device (default: the card)")
    pt.set_defaults(fn=cmd_timeline)

    pv = sub.add_parser("validate", help="schema-check an exported file")
    pv.add_argument("file")
    pv.set_defaults(fn=cmd_validate)

    args = p.parse_args(argv)
    if getattr(args, "link", None) == "uart":
        args.link = None
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
