"""Paper Fig 16 on the port: GAPBS score error against the UART's baud
rate, with a ``--link`` axis for the PCIe/AXI-DMA backend, on the card by
default.

The twin of the reference's ``benchmarks/baud_sweep.py``: the same rows,
sizes and ``--quick`` cut, each row with its ``wall_s`` (its FASE run;
the oracle run a workload shares is in ``oracle_wall_s``).  Writes
``results/torch_baud_sweep.json``.
"""
from __future__ import annotations

from . import panels
from ..core.workloads import graphgen

BAUDS = [115200, 460800, 921600, 3_000_000]


def run(quick=False, link="uart", target="card", out_dir=None):
    g = graphgen.rmat(5 if quick else 7, 8, weights=True)
    rows = []
    for name in (["bc"] if quick else ["bc", "sssp"]):
        _, rep0, wall0 = panels.run_workload(
            name, ["g.bin", "2", "2"], target, mode="oracle",
            files={"g.bin": g})
        base = panels.trial_mean_ns(rep0.stdout)
        if link == "uart":
            sweep = BAUDS[:2] if quick else BAUDS
        else:
            sweep = [0]       # non-UART links have no baud axis
        for baud in sweep:
            _, rep, wall = panels.run_workload(
                name, ["g.bin", "2", "2"], target, mode="fase", link=link,
                baud=baud or 921600, files={"g.bin": g})
            err = (panels.trial_mean_ns(rep.stdout) - base) / base
            tag = f"{name}@{baud}" if link == "uart" else f"{name}@{link}"
            rows.append(dict(workload=name, link=link, baud=baud, err=err,
                             wall_s=wall, oracle_wall_s=wall0))
            print(f"baud_sweep,{tag},{err*100:.1f},score-err% "
                  f"({target} {wall:.2f}s)", flush=True)
    panels.save_json("baud_sweep", rows, target, quick, out_dir)
    return rows


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, ["baud_sweep"], links=True))
