"""``python -m repro_torch.bench``: audit the package (:func:`audit`) and
list its scripts with the first line of each one's description.  Each
script runs as ``python -m repro_torch.bench.NAME``.

``python -m repro_torch.bench --run [--quick] [--target card|pysim]
[--out DIR]`` runs the seventeen twins of the reference's panels in the
order of the reference's runner (:data:`RUN_ORDER`, ``benchmarks/run.py``),
each through its ``run`` on ``--target`` (``hillclimb`` lowers its cells
on the host and takes none), writing every ``torch_*.json`` into ``--out``
(default a fresh temporary directory, printed; never ``results/``).  It
prints the reference runner's ``name,us_per_call,derived`` header, each
twin's own lines, and after each twin ``# NAME done in Xs`` or ``# NAME
FAILED: ...``; unlike the reference's runner it exits 1 if any twin
failed.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import tempfile
import time

from . import HOST_ONLY, RUN_ORDER, SCRIPTS, audit


def run_all(quick: bool, target: str, out_dir: str, names=None) -> int:
    """Each twin of ``names`` (default :data:`RUN_ORDER`) in order;
    returns 1 if any failed, else 0."""
    names = RUN_ORDER if names is None else names
    print("name,us_per_call,derived", flush=True)
    failed = []
    for name in names:
        t0 = time.time()
        try:
            mod = importlib.import_module(f"{__package__}.{name}")
            kw = {} if name in HOST_ONLY else dict(target=target)
            mod.run(quick=quick, out_dir=out_dir, **kw)
            print(f"# {name} done in {time.time() - t0:.1f}s", flush=True)
        except (Exception, SystemExit) as e:  # noqa: BLE001 - report all
            failed.append(name)
            print(f"# {name} FAILED: {type(e).__name__}: {e}", flush=True)
    if failed:
        print(f"# {len(failed)} of {len(names)} failed: "
              f"{' '.join(failed)}", flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", action="store_true",
                    help="run the seventeen twins in the reference "
                         "runner's order (default: list the scripts)")
    ap.add_argument("--quick", action="store_true",
                    help="with --run: each twin's quick cut")
    ap.add_argument("--target", default="card", choices=("card", "pysim"),
                    help="with --run: card (default) or the port's PySim")
    ap.add_argument("--out", default=None,
                    help="with --run: directory for the torch_*.json "
                         "files (default a fresh temporary directory)")
    a = ap.parse_args(argv)
    audit()
    if not a.run:
        for name in SCRIPTS:
            mod = importlib.import_module(f"{__package__}.{name}")
            print(f"{name:26s} {mod.__doc__.strip().splitlines()[0]}")
        return 0
    if a.target == "card":
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device (torch.cuda.is_available() is False): "
                  "pass --target pysim to run on the host", file=sys.stderr)
            return 1
    out = a.out or tempfile.mkdtemp(prefix="repro_torch_bench_")
    rc = run_all(a.quick, a.target, out)
    print(f"# results in {out}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
