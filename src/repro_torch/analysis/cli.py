"""``python -m repro_torch.analysis`` — the hazard analyzer CLI.

Subcommands:

  * ``lint``        — the static protocol linter over the shipped tree;
  * ``race``        — run the canonical workloads with the trace hook
    armed and report every happens-before race the detector finds;
  * ``footprints``  — print the declarative read/write sets (all ops, or
    the ones named on the command line);
  * ``gate``        — ``lint`` + ``race`` (the CI ``analysis-gate`` job:
    exits non-zero on any finding).

The ``race``/``gate`` workloads mirror the tier-1 golden runs plus a
quick fleet live-migration, so the traces cover the serial path, the
pipelined queue-pair path, multi-hart streams, snapshot barriers and
cross-device migration fences.  All run on
:class:`~repro_torch.core.interface.TorchTarget` on the card (``--device
cpu`` runs the eager loop on the CPU instead); the analyzer checks
protocol ordering, which is target-independent.
"""
from __future__ import annotations

import argparse
import sys

from .detector import detect, summarize
from .footprints import ARG_SPECS, footprint
from .lint import lint_all
from .trace import attach_trace


def _run_runtime_trace(name, argv_tail, link, n_cores, files=None,
                       mem=1 << 22, telemetry=None, device="cuda"):
    from ..core.interface import TorchTarget
    from ..core.runtime import FaseRuntime
    from ..core.workloads import build
    rt = FaseRuntime(TorchTarget(n_cores, mem, device=device), mode="fase",
                     link=link, session="async", telemetry=telemetry)
    trace = attach_trace(rt.session)
    rt.load(build(name), [name] + list(argv_tail), files=files or {})
    rt.run()
    return trace


def _run_fleet_trace(quick: bool, device="cuda"):
    """A live migration under trace: job starts on device 0, pauses
    mid-compute, migrates to device 1 (checkpoint + restore + retarget)
    and finishes — the snapshot barriers and migration fences must leave
    the combined two-device trace race-free."""
    from ..core.fleet import FleetRuntime, Job
    from ..core.interface import TorchTarget
    from ..core.workloads import graphgen
    g = graphgen.rmat(4, 4, weights=True)
    fr = FleetRuntime(make_target=lambda: TorchTarget(1, 1 << 23,
                                                      device=device),
                      n_devices=2, links=["pcie", "pcie"])
    trace = attach_trace(fr)
    h = fr.start_job(Job("bc", ["g.bin", "1", "2" if quick else "8"],
                         files={"g.bin": g}), fr.devices[0])
    rt = h.runtime
    # pause mid-compute (by instructions retired, like the migration
    # benchmark: most of the timeline is stall, where nothing dirties
    # memory) then migrate and run to completion
    target_instret = 4000
    res = None
    while res is None and rt.target.get_instret(0) < target_instret:
        missing = target_instret - rt.target.get_instret(0)
        res = fr.step_job(h, pause_ticks=rt.target.get_ticks() + missing)
    if res is None:
        fr.migrate(h, fr.devices[1])
        fr.finish_job(h)
    return trace


def _workloads(quick: bool, device="cuda"):
    from ..core.workloads import graphgen
    yield "hello@uart(serial)", lambda: _run_runtime_trace(
        "hello", [], link=None, n_cores=1, device=device)
    yield "hello@pcie(pipelined)", lambda: _run_runtime_trace(
        "hello", [], link="pcie", n_cores=1, device=device)
    g = graphgen.rmat(4, 4, weights=True)
    yield "bc-2T@pcie(multi-stream)", lambda: _run_runtime_trace(
        "bc", ["g.bin", "2", "1"], link="pcie", n_cores=2,
        files={"g.bin": g}, device=device)
    # both telemetry bridges armed: the telem lane's reads must be
    # race-free against ordinary traffic (always-concurrent domain)
    yield "bc-2T@pcie(telemetry-armed)", lambda: _run_runtime_trace(
        "bc", ["g.bin", "2", "1"], link="pcie", n_cores=2,
        files={"g.bin": g},
        telemetry=dict(counters=True, commit_trace=True,
                       interval_ticks=50_000, trace_slots=256),
        device=device)
    yield "migrate@pcie(fleet)", lambda: _run_fleet_trace(quick, device)


def cmd_lint(args) -> int:
    findings = lint_all(root=args.root)
    for f in findings:
        print(f)
    print(f"lint: {len(findings)} finding(s)")
    return 1 if findings else 0


def cmd_race(args) -> int:
    total = 0
    for label, run in _workloads(args.quick, args.device):
        trace = run()
        findings = detect(trace, time_fences=not args.no_time_fences)
        print(f"{label}: {len(trace)} transactions, "
              f"{len(trace.streams())} domains, "
              f"{len(findings)} race(s)")
        for f in findings:
            print(f"  {f}")
        if findings:
            print(f"  summary: {summarize(findings)}")
        total += len(findings)
    print(f"race: {total} finding(s)")
    return 1 if total else 0


def cmd_footprints(args) -> int:
    ops = args.ops or sorted(ARG_SPECS)
    for op in ops:
        if op not in ARG_SPECS:
            print(f"{op}: not a Table II request", file=sys.stderr)
            return 2
        sig = ARG_SPECS[op]
        reads, writes = footprint(op, 0, tuple(range(1, len(sig) + 1)))
        print(f"{op}({', '.join(sig)})")
        print(f"  reads:  {list(reads)}")
        print(f"  writes: {list(writes)}")
    return 0


def cmd_gate(args) -> int:
    rc = cmd_lint(args)
    rc |= cmd_race(args)
    print("analysis-gate:", "FAIL" if rc else "PASS")
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="HTP hazard analyzer: protocol linter + "
                    "happens-before race detector")
    sub = p.add_subparsers(dest="cmd", required=True)

    pl = sub.add_parser("lint", help="static protocol linter")
    pl.add_argument("--root", default=None,
                    help="repo root to scan (default: this checkout)")
    pl.set_defaults(fn=cmd_lint)

    pr = sub.add_parser("race", help="trace workloads + race detector")
    pr.add_argument("--quick", action="store_true",
                    help="smaller workload configs (CI smoke)")
    pr.add_argument("--no-time-fences", action="store_true",
                    help="audit pure token/stream discipline (ignore "
                         "modelled-time ordering)")
    pr.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the targets' device (default: the card)")
    pr.set_defaults(fn=cmd_race)

    pf = sub.add_parser("footprints", help="print per-op read/write sets")
    pf.add_argument("ops", nargs="*", help="Table II request names")
    pf.set_defaults(fn=cmd_footprints)

    pg = sub.add_parser("gate", help="lint + race; non-zero on findings")
    pg.add_argument("--quick", action="store_true")
    pg.add_argument("--root", default=None)
    pg.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the targets' device (default: the card)")
    pg.set_defaults(fn=cmd_gate, no_time_fences=False)

    args = p.parse_args(argv)
    return args.fn(args)
