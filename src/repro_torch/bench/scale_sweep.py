"""Paper Fig 14/15 on the port: score error against data scale for BFS
and TC, on the card by default.

The twin of the reference's ``benchmarks/scale_sweep.py``: the same rows,
scales and ``--quick`` cut, each row with its ``wall_s`` (oracle and
FASE).  Writes ``results/torch_scale_sweep.json``.
"""
from __future__ import annotations

from . import panels
from ..core.workloads import graphgen


def run(quick=False, target="card", out_dir=None):
    rows = []
    scales = [5, 6] if quick else [6, 7, 8]
    for name in (["bfs"] if quick else ["bfs", "tc"]):
        for scale in scales:
            g = graphgen.rmat(scale, 8, weights=True)
            _, rep0, w0 = panels.run_workload(
                name, ["g.bin", "2", "2"], target, mode="oracle",
                files={"g.bin": g})
            _, rep1, w1 = panels.run_workload(
                name, ["g.bin", "2", "2"], target, mode="fase",
                files={"g.bin": g})
            base = panels.trial_mean_ns(rep0.stdout)
            err = (panels.trial_mean_ns(rep1.stdout) - base) / base
            rows.append(dict(workload=name, scale=scale, err=err,
                             wall_s=w0 + w1))
            print(f"scale_sweep,{name}-2^{scale},{err*100:.1f},score-err% "
                  f"({target} {w0 + w1:.2f}s)", flush=True)
    panels.save_json("scale_sweep", rows, target, quick, out_dir)
    return rows


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, ["scale_sweep"]))
