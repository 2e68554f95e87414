"""Paper Fig 17 on the port: HFutex's impact on UART traffic (BC/CC/PR, 2
threads), on the card by default.

The twin of the reference's ``benchmarks/hfutex_bench.py``: the same
rows, sizes and ``--quick`` cut, each row with its ``wall_s`` (both
runs).  Writes ``results/torch_hfutex.json``.
"""
from __future__ import annotations

from . import panels
from ..core.workloads import graphgen


def run(quick=False, target="card", out_dir=None):
    g = graphgen.rmat(5 if quick else 7, 8, weights=True)
    rows = []
    for name in (["bc"] if quick else ["bc", "cc", "pr"]):
        res, wall = {}, 0.0
        for hf in (False, True):
            rt, rep, w = panels.run_workload(
                name, ["g.bin", "2", "2"], target, mode="fase", hfutex=hf,
                files={"g.bin": g})
            res[hf] = dict(traffic=rep.traffic_total,
                           futex_sys=rep.syscalls.get("futex", 0),
                           hits=rep.hfutex["hits"])
            wall += w
        redu = 1 - res[True]["traffic"] / max(res[False]["traffic"], 1)
        rows.append(dict(workload=name, nhf=res[False], hf=res[True],
                         traffic_reduction=redu, wall_s=wall))
        print(f"hfutex,{name}-2T,{res[True]['hits']},"
              f"traffic-{redu*100:.1f}% ({target} {wall:.2f}s)", flush=True)
    panels.save_json("hfutex", rows, target, quick, out_dir)
    return rows


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, ["hfutex"]))
