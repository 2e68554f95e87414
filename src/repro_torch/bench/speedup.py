"""Paper Fig 19 on the port: validation efficiency, PK-style execution on
the port's pure-Python PySim against FASE on the card: wall seconds a
CoreMark iteration, instructions per second and modelled seconds.

The twin of the reference's ``benchmarks/speedup.py``: CoreMark of 5
iterations (2 under ``--quick``) on 1 core in ``fase`` mode over the
default link, twice: ``PK/pysim`` on the port's PySim and ``FASE/card``
on ``TorchTarget`` on the CUDA device (the reference's ``FASE/xla``,
named in ``reference_row``; ``FASE/pysim`` with ``--target pysim``), then
the ``ratio`` row (PySim's wall an iteration over the card's).  Each row
carries ``wall_s``, ``instret``, ``inst_per_s``, ``model_s`` (ticks /
1e8, as the reference computes it) and ``wall_per_iter``.  Both rows run
the same guest, so their ``instret`` and ``model_s`` must be equal: the
run exits 1 where they are not.  Writes ``results/torch_speedup.json``
(the reference checks in no ``speedup.json``: ``--against DIR`` compares
the port's own file).
"""
from __future__ import annotations

import sys

from . import panels


def run(quick=False, target="card", out_dir=None):
    iters = 2 if quick else 5
    rows = []
    for tgt, label, ref in (("pysim", "PK/pysim", "PK/pysim"),
                            (target, f"FASE/{target}", "FASE/xla")):
        rt, rep, wall = panels.run_workload("coremark", [str(iters)], tgt,
                                            mode="fase", n_cores=1)
        inst = sum(rep.instret)
        rows.append(dict(target=label, reference_row=ref, wall_s=wall,
                         instret=inst, inst_per_s=inst / wall,
                         model_s=rep.ticks / 1e8,
                         wall_per_iter=wall / iters))
        print(f"speedup,{label},{wall / iters * 1e6:.0f},"
              f"{inst / wall:.0f} inst/s", flush=True)
    ratio = rows[0]["wall_per_iter"] / rows[1]["wall_per_iter"]
    print(f"speedup,ratio,{ratio:.2f},{target}-vs-python per-iteration",
          flush=True)
    rows.append(dict(target="ratio", value=ratio))
    panels.save_json("speedup", rows, target, quick, out_dir)
    pk, fase = ((r["instret"], r["model_s"]) for r in rows[:2])
    if pk != fase:
        print(f"speedup: THE TWO ROWS RAN DIFFERENT GUESTS: (instret, "
              f"model_s) {pk} on PySim, {fase} on {target}", flush=True)
        sys.exit(1)
    return rows


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, ["speedup"]))
