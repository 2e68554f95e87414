"""Paper Fig 12 on the port: GAPBS score and user-CPU-time accuracy,
FASE against the full-system oracle, across 1/2/4 threads (also Fig 13's
traffic composition), on the card by default.

The twin of the reference's ``benchmarks/gapbs_accuracy.py``: the same
rows, sizes and ``--quick`` cut (each mode keeps the reference's
``wall``), each row with its ``wall_s``.  Writes
``results/torch_gapbs_accuracy.json``.
"""
from __future__ import annotations

from . import panels
from ..core.workloads import graphgen

WORKLOADS = ["bc", "bfs", "cc", "pr", "sssp", "tc"]
THREADS = [1, 2, 4]
SCALE, DEG, TRIALS = 7, 8, 2


def run(quick=False, target="card", out_dir=None):
    scale = 5 if quick else SCALE
    g = graphgen.rmat(scale, DEG, weights=True)
    rows = []
    for name in (WORKLOADS[:2] if quick else WORKLOADS):
        for t in ([1, 2] if quick else THREADS):
            res = {}
            for mode in ("oracle", "fase"):
                rt, rep, wall = panels.run_workload(
                    name, ["g.bin", str(t), str(TRIALS)], target, mode=mode,
                    files={"g.bin": g})
                res[mode] = dict(
                    score_ns=panels.trial_mean_ns(rep.stdout),
                    uticks=sum(rep.uticks), ticks=rep.ticks,
                    traffic=rep.traffic, traffic_total=rep.traffic_total,
                    syscalls=rep.syscalls, stall=rep.stall,
                    sched=rep.sched, hfutex=rep.hfutex, wall=wall)
            e_score = (res["fase"]["score_ns"] - res["oracle"]["score_ns"]) \
                / max(res["oracle"]["score_ns"], 1)
            e_utime = (res["fase"]["uticks"] - res["oracle"]["uticks"]) \
                / max(res["oracle"]["uticks"], 1)
            rows.append(dict(workload=name, threads=t,
                             score_err=e_score, utime_err=e_utime, **res,
                             wall_s=res["oracle"]["wall"] +
                             res["fase"]["wall"]))
            print(f"gapbs_accuracy,{name}-{t}T,"
                  f"{res['fase']['score_ns']/1e3:.0f},"
                  f"score_err={e_score*100:+.1f}% "
                  f"utime_err={e_utime*100:+.2f}% "
                  f"({target} {rows[-1]['wall_s']:.2f}s)", flush=True)
    panels.save_json("gapbs_accuracy", rows, target, quick, out_dir)
    return rows


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, ["gapbs_accuracy"]))
