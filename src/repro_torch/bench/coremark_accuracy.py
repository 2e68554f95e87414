"""Paper Fig 18 on the port: CoreMark accuracy, FASE against the
full-system oracle, as iterations grow, on the card by default.

The twin of the reference's ``benchmarks/coremark_accuracy.py``: the same
rows, iterations and ``--quick`` cut, each row with its ``wall_s`` (both
modes).  Writes ``results/torch_coremark_accuracy.json``.
"""
from __future__ import annotations

from . import panels


def run(quick=False, target="card", out_dir=None):
    rows = []
    for iters in ([2, 5] if quick else [5, 10, 20, 40]):
        res, wall = {}, 0.0
        for mode in ("oracle", "fase"):
            rt, rep, w = panels.run_workload("coremark", [str(iters)],
                                             target, mode=mode, n_cores=1)
            res[mode] = panels.parse_kv(rep.stdout)["coremark_ns"][0]
            wall += w
        err = (res["fase"] - res["oracle"]) / res["oracle"]
        rows.append(dict(iters=iters, fase_ns=res["fase"],
                         oracle_ns=res["oracle"], err=err, wall_s=wall))
        print(f"coremark_accuracy,iters={iters},{res['fase']/1e3:.0f},"
              f"err={err*100:+.2f}% ({target} {wall:.2f}s)", flush=True)
    panels.save_json("coremark_accuracy", rows, target, quick, out_dir)
    return rows


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, ["coremark_accuracy"]))
