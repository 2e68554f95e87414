"""How many device records ``torch.profiler`` drops at the start of a
window, by the age of the process, with and without the lead-in that
``chip_smoke.py`` opens every window with (``timing.lead_in``)::

    PYTHONPATH=src python -m repro_torch.bench.profile_drop [--age S]
        [--windows N]

The fleet chunk kernel at ``FASE_FLEET_VMAP``'s shape (4 boards of 4
cores and 64 MiB, each running the guest loop of ``timing.loop_target``),
20 global chunks of ``CHUNK_CYCLES`` ticks a window, ``--windows``
windows of each opening (:data:`OPENINGS`: none, a 50 ms pause on the
host, a 50 ms kernel, the lead-in) at the process's start, and again
once the process is ``--age`` seconds old (the kernel runs 50 chunks
every 5 s in between).  Each window gives the fleet kernel's launches
traced, the host-to-device copies traced (one a chunk) and the spin
kernels traced (the lead-in's, or the long kernel).  It prints the card's name and power limit and
one JSON line; exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import timing as S

#: global chunks a window, as in ``chip_smoke.py``'s fleet window
CHUNKS = 20
#: what a window runs before its chunks
OPENINGS = ("none", "pause", "long_kernel", "lead_in")
#: the long kernel's cycles: about 50 ms at the H100's clock
LONG_KERNEL_CYCLES = 100_000_000


def fleet_chunk(torch):
    """A stacked fleet at ``FASE_FLEET_VMAP``'s shape, every board on the
    guest loop, and a function that runs one global chunk of it on the
    fleet kernel."""
    from repro_torch.configs.fase_rocket import target_kwargs
    from repro_torch.configs.registry import FASE_FLEET_VMAP as cfg
    from repro_torch.core.fleet.vmap import FleetTarget
    from repro_torch.core.target import cpu
    ft = FleetTarget(cfg["n_devices"], cfg["n_cores"], cfg["mem_bytes"],
                     **target_kwargs(cfg))
    loop = S.loop_target(torch, cfg["n_cores"], 1 << 20)
    for d in range(ft.n_devices):
        board = ft.view(d).st
        for name in cpu.STATE_FIELDS:
            v = getattr(loop.st, name)
            if name == "mem":
                board.mem[:v.shape[0]].copy_(v)
            else:
                getattr(board, name).copy_(v)
    budgets = [S.CHUNK_CYCLES] * ft.n_devices

    def chunk():
        return cpu.run_chunk_fleet(ft.sts, ft.n_cores, ft.mem_bytes,
                                   budgets, ft.issue_width, ft.block_words,
                                   ft.block_cache, ft.fetch_kernel,
                                   ft.dtlb_ways, "kernel")
    return chunk


def window(torch, chunk, opening):
    """One profile window of ``CHUNKS`` global chunks after ``opening``
    (one of :data:`OPENINGS`): the records it traced."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if opening == "pause":
            time.sleep(0.05)
        elif opening == "long_kernel":
            torch.cuda._sleep(LONG_KERNEL_CYCLES)
        elif opening == "lead_in":
            S.lead_in(torch)
        for _ in range(CHUNKS):
            chunk()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA"]
    return {"fleet_kernel": sum("run_chunk_fleet" in n for n in names),
            "copies_in": sum("HtoD" in n for n in names),
            "spin": sum(S.LEAD_IN_KERNEL in n for n in names)}


def battery(torch, chunk, n):
    return {"age_s": round(time.time() - T0, 1),
            **{o: [window(torch, chunk, o) for _ in range(n)]
               for o in OPENINGS}}


T0 = time.time()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--age", type=float, default=420.0,
                    help="the process's age at the second battery, s")
    ap.add_argument("--windows", type=int, default=4,
                    help="windows each way in a battery")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_drop: no CUDA device", file=sys.stderr)
        return 1
    smi = S.nvidia_smi_line()
    print(smi, flush=True)
    chunk = fleet_chunk(torch)
    for _ in range(5):                               # build, warm
        chunk()
    torch.cuda.synchronize()
    res = {"nvidia_smi": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "chunks": CHUNKS,
           "lead_in_launches": S.LEAD_IN_LAUNCHES,
           "batteries": [battery(torch, chunk, args.windows)]}
    while time.time() - T0 < args.age:
        for _ in range(50):
            chunk()
        torch.cuda.synchronize()
        time.sleep(5)
    res["batteries"].append(battery(torch, chunk, args.windows))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
