"""Every cell of the port's dry run (``repro_torch.launch.dryrun``) at
production size, on both production meshes: each (arch × shape × mesh)
cell is one ``python -m repro_torch.launch.dryrun`` process, ``--jobs`` of
them at once, the longest cells first.
Each cell's report and log go under ``--out``; one line a cell (status
and wall seconds) goes to standard output, and a cell still running when
``--limit`` seconds have passed since the start is stopped and reported
``UNFINISHED``.  CPU only (``meta`` tensors); a few hundred MB a process::

    PYTHONPATH=src python -m repro_torch.bench.dryrun_sweep --out DIR
        [--jobs 5] [--limit 780] [--dense-only]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from ..configs import CONFIGS
from ..launch import steps as st
from .timing import OWN_SRC as SRC

ROOT = os.path.dirname(SRC)


def cells(dense_only: bool):
    """``(arch, shape, multi_pod)`` of every supported cell, in run order:
    by a rough cost (layers, times 24 for a train cell's 8 microbatches of
    forward, recompute and backward, and 8 for the many small operators
    of a Mamba or xLSTM layer)."""
    out = []
    for arch, cfg in CONFIGS.items():
        dense = cfg.arch_type == "dense"
        if dense_only and not dense:
            continue
        for shape in st.SHAPES:
            if not st.cell_supported(cfg, shape)[0]:
                continue
            kind = st.SHAPES[shape]["kind"]
            cost = cfg.n_layers * {"train": 24, "prefill": 3}.get(kind, 1)
            if cfg.arch_type in ("hybrid", "ssm"):
                cost *= 8
            for multi_pod in (False, True):
                out.append((-cost, arch, shape, multi_pod))
    return [c[1:] for c in sorted(out)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--jobs", type=int, default=5)
    ap.add_argument("--limit", type=float, default=780.0)
    ap.add_argument("--dense-only", action="store_true")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    t_start = time.time()

    def run(cell):
        arch, shape, multi_pod = cell
        name = f"{arch}_{shape}_{'2x16x16' if multi_pod else '16x16'}"
        left = args.limit - (time.time() - t_start)
        if left < 30:
            return name, "NOT RUN (time)", 0.0
        path = os.path.join(args.out, name)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", path + ".json"] + \
            (["--multi-pod"] if multi_pod else [])
        t0 = time.time()
        with open(path + ".log", "w") as log:
            try:
                subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                               timeout=left, cwd=ROOT,
                               env=dict(os.environ, PYTHONPATH=SRC))
            except subprocess.TimeoutExpired:
                return name, "UNFINISHED (time)", time.time() - t0
        try:
            with open(path + ".json") as f:
                status = json.load(f)[0]["status"]
        except (OSError, ValueError, KeyError, IndexError):
            status = "no report"
        return name, status[:400], time.time() - t0

    with ThreadPoolExecutor(args.jobs) as ex:
        for name, status, secs in ex.map(run, cells(args.dense_only)):
            print(f"{name:48s} {secs:7.1f}s {status}", flush=True)
    print(f"sweep wall {time.time() - t_start:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
