"""Times of the port's flash_attention and chunk kernels on one NVIDIA GPU,
for comparing two trees inside one call: ``flash_attention`` without a
window at the train run's shape of ``chip_smoke.py`` (qwen3-8b's heads,
q (1, 4096, 32, 128), K/V 8 heads, bf16, causal), and with jamba's 8192
window at its prefill shape (q (1, 16 384, 32, 128)) where the tree's
kernel takes a window; the chunk kernel at the full-width run's shape
(``FASE_ROCKET_PCIE``: 4 cores, 64 MiB, issue width 8) on a loop
without system calls (``timing.loop_target``), and on boards of 40,
64 and 384 cores (one CTA) and of 500, 1 025, 3 072 and 6 144 cores (a
cluster of 2, 3, 8 and 16 CTAs of 384) where the tree's kernel takes
them.  With ``--src DIR`` it
times the ``repro_torch`` package under ``DIR`` (for instance an unpacked
earlier commit, whose kernels it builds into ``DIR/build``)::

    PYTHONPATH=src python -m repro_torch.bench.port_kernels [--src DIR]
        [--label NAME]

It prints the card's name and power limit and one JSON line.  Times:
``ms`` by CUDA events over back-to-back calls (``timing.time_ms``);
the chunk kernel's from ``torch.profiler`` over 50 chunks of
``CHUNK_CYCLES`` ticks: the kernel's own device time a launch and a
substep (what the kernel computes, without the host's work between
launches), and beside it ``host_paced_us_per_substep``, CUDA events
around the same 50 chunks as the host drives them.  Exits non-zero
without a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import timing as S

TRAIN_SHAPE = (1, 4096, 32, 8, 128)
WINDOW_SHAPE, WINDOW = (1, 16384, 32, 8, 128), 8192
WIDE = (40, 64, 384, 500, 1025, 3072, 6144)
CHUNKS = 50


def chunk_times(torch, tgt):
    """``tgt``'s chunk kernel on its loop, over ``CHUNKS`` chunks after two
    warm ones: the kernel's device µs a substep and a launch from the
    profiler, and the host-paced µs a substep from CUDA events."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        tgt.run(max_cycles=S.CHUNK_CYCLES)
    torch.cuda.synchronize()
    sub0 = tgt.substeps
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(CHUNKS):
        tgt.run(max_cycles=S.CHUNK_CYCLES)
    b.record()
    torch.cuda.synchronize()
    paced = a.elapsed_time(b) * 1e3 / (tgt.substeps - sub0)
    sub0 = tgt.substeps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        S.lead_in(torch)
        for _ in range(CHUNKS):
            tgt.run(max_cycles=S.CHUNK_CYCLES)
        torch.cuda.synchronize()
    kern = [e for e in S.device_events(prof.key_averages())
            if "run_chunk" in e.key]
    us = sum(e.self_device_time_total for e in kern)
    n = sum(e.count for e in kern)
    sub = tgt.substeps - sub0
    return {"us_per_substep": us / sub if n else None,
            "us_per_launch": us / n if n else None, "launches": n,
            "substeps": sub, "host_paced_us_per_substep": paced}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=S.OWN_SRC,
                    help="directory holding the repro_torch package")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("port_kernels: no CUDA device", file=sys.stderr)
        return 1
    S.use_tree(args.src)
    from repro_torch.configs.fase_rocket import target_kwargs
    from repro_torch.configs.registry import FASE_ROCKET_PCIE
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    smi = S.nvidia_smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda")
    t0 = time.time()
    _build.load_all(["flash_attention", "run_chunk"])
    res = {"label": args.label, "src": args.src, "nvidia_smi": smi,
           "build_s": time.time() - t0}
    q, k, v = S.flash_inputs(torch, dev, *TRAIN_SHAPE, torch.bfloat16, 9)
    res["flash_train_ms"] = S.time_ms(torch, lambda: ops.flash_mha(q, k, v),
                                      50, warmup=5)
    del q, k, v
    q, k, v = S.flash_inputs(torch, dev, *WINDOW_SHAPE, torch.bfloat16, 21)
    try:
        res["flash_window_ms"] = S.time_ms(
            torch, lambda: ops.flash_mha(q, k, v, window=WINDOW), 10,
            warmup=2)
    except NotImplementedError as e:          # a tree without the window
        res["flash_window_ms"] = f"refused: {e}"[:120]
    del q, k, v
    opts = target_kwargs(FASE_ROCKET_PCIE)
    tgt = S.loop_target(torch, FASE_ROCKET_PCIE["n_cores"],
                        FASE_ROCKET_PCIE["mem_bytes"], **opts)
    res[f"chunk_{tgt.nc}"] = chunk_times(torch, tgt)
    del tgt
    for nc in WIDE:
        try:
            tgt = S.loop_target(torch, nc, 1 << 21, **opts)
            res[f"chunk_{nc}"] = chunk_times(torch, tgt)
        except ValueError as e:   # a tree of one warp, or of one CTA
            res[f"chunk_{nc}"] = f"refused: {e}"[:160]
        except RuntimeError as e:               # a launch the card refused
            res[f"chunk_{nc}"] = f"failed: {e}"[:160]
        tgt = None
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
