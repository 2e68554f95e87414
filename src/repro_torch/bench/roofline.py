"""The port's dry-run table with its three roofline terms, the dominant
one, and the model FLOPs over the counted FLOPs.

The twin of the reference's ``benchmarks/roofline.py``, over the port's
dry run: the cells are the JSON reports of ``python -m
repro_torch.bench.dryrun_sweep --out DIR`` (one file a cell) or of
``python -m repro_torch.launch.dryrun --all --out FILE`` (one list),
given by ``--cells``.  ``model_flops_per_step`` counts the model's
FLOPs from the port's ``configs`` and ``launch/steps.SHAPES`` (6·N·T for
training, 2·N·T otherwise, N the active parameters).  The roofline's
rates are ``launch/dryrun.py``'s (NVIDIA's H100 SXM data sheet:
``PEAK_FLOPS``, ``HBM_BW``, ``LINK_BW``); with ``--target card`` the
card's measured bf16 GEMM and HBM copy rates stand beside them, with the
card's name and power limit.  Writes
``results/torch_roofline_table.json``.
"""
from __future__ import annotations

import glob
import json
import os

from . import panels
from ..configs import CONFIGS
from ..launch import dryrun as DR
from ..launch.steps import SHAPES

#: the cells read when ``--cells`` is not given
DEFAULT_CELLS = os.path.join(panels.RESULTS_DIR, "torch_dryrun_all.json")


def model_flops_per_step(arch, shape):
    cfg = CONFIGS[arch]
    n = cfg.active_param_count()
    sh = SHAPES[shape]
    if sh["kind"] == "train":
        tokens = sh["batch"] * sh["seq"]
        return 6.0 * n * tokens
    if sh["kind"] == "prefill":
        return 2.0 * n * sh["batch"] * sh["seq"]
    return 2.0 * n * sh["batch"]            # decode: one token / seq


def load_cells(path):
    """The dry-run reports under ``path``: a directory of per-cell JSON
    files (each a list of one cell, as ``launch/dryrun.py --out`` writes
    them) or one JSON list."""
    if os.path.isdir(path):
        cells = []
        for f in sorted(glob.glob(os.path.join(path, "*.json"))):
            with open(f) as fh:
                got = json.load(fh)
            cells.extend(got if isinstance(got, list) else [got])
        return cells
    with open(path) as fh:
        return json.load(fh)


def measured_rates(torch, dev):
    """The card's bf16 GEMM rate (8192^3, CUDA events) and HBM copy rate
    (a 2 GiB device-to-device copy: read and write counted)."""
    from .timing import time_ms
    n = 8192
    a = torch.randn((n, n), device=dev).to(torch.bfloat16)
    b = torch.randn((n, n), device=dev).to(torch.bfloat16)
    gemm_ms = time_ms(torch, lambda: a @ b, 20, warmup=5)
    src = torch.empty(1 << 30, dtype=torch.int16, device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_ms(torch, lambda: dst.copy_(src), 20, warmup=3)
    return {"bf16_gemm_flop_per_s": 2 * n ** 3 / (gemm_ms / 1e3),
            "hbm_copy_bytes_per_s": 2 * src.numel() * 2 / (copy_ms / 1e3)}


def table(cells, measured=None):
    """The roofline rows of ``cells`` (a cell that is not ``OK`` is kept
    as it is): each ``OK`` cell with its ``model_flops``, its
    ``useful_flop_frac`` (model FLOPs over the FLOPs the dry run counted
    on every device) and its ``roofline_frac`` (compute term over the
    largest term); with ``measured`` (the card's rates), the compute and
    memory terms at those rates too."""
    rows = []
    for c in cells:
        c = dict(c)
        if c.get("status") != "OK":
            rows.append(c)
            continue
        mf = model_flops_per_step(c["arch"], c["shape"])
        hlo_total = c["hlo_flops_per_device"] * c["n_chips"]
        r = c["roofline"]
        bound = max(r["compute_s"], r["memory_s"], r["collective_s"])
        c["model_flops"] = mf
        c["useful_flop_frac"] = mf / hlo_total if hlo_total else 0.0
        c["roofline_frac"] = r["compute_s"] / bound if bound else 0.0
        if measured:
            c["roofline_measured"] = {
                "compute_s": c["hlo_flops_per_device"] /
                measured["bf16_gemm_flop_per_s"],
                "memory_s": c["per_device"]["peak_bytes"] /
                measured["hbm_copy_bytes_per_s"]}
        rows.append(c)
        print(f"roofline,{c['arch']}|{c['shape']}|{c['mesh']},"
              f"{bound*1e6:.0f},dom={r['dominant']} "
              f"frac={c['roofline_frac']*100:.1f}% "
              f"useful={c['useful_flop_frac']*100:.0f}%", flush=True)
    return rows


def run(quick=False, target="card", out_dir=None, cells=None,
        measured=None):
    """The table of ``cells`` (a list of reports, or a path for
    :func:`load_cells`; default ``results/torch_dryrun_all.json``),
    written with the data sheet's rates and, on the card, its measured
    ones (``measured``, or measured here)."""
    if cells is None or isinstance(cells, str):
        path = cells or DEFAULT_CELLS
        if not os.path.exists(path):
            print(f"roofline,skipped,0,no cells at {path}: run "
                  "python -m repro_torch.bench.dryrun_sweep --out DIR "
                  "first and pass --cells DIR", flush=True)
            return []
        cells = load_cells(path)
    if target == "card" and measured is None:
        import torch
        measured = measured_rates(torch, torch.device("cuda"))
    rows = table(cells, measured)
    panels.save_json("roofline_table", dict(
        data_sheet={"bf16_flop_per_s": DR.PEAK_FLOPS,
                    "hbm_bytes_per_s": DR.HBM_BW,
                    "link_bytes_per_s": DR.LINK_BW},
        measured=measured, cells=rows), target, quick, out_dir)
    return rows


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, ["roofline_table"], options=(
        ("--cells", dict(default=None,
                         help="a directory of per-cell reports or one "
                              "JSON list (default "
                              "results/torch_dryrun_all.json)")),)))
