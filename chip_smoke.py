#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU and the
CUDA toolkit::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds
each kernel against its plain PyTorch version on the card, reproduces the
two reference pins (hello@UART, bc@PCIe) on ``TorchTarget(device="cuda")``
and then drives the main path at full width — the registry's
``FASE_ROCKET_PCIE`` deployment (4 cores, 64 MiB target image resident on
the card, PCIe async queue pair) running GAPBS ``bc`` with 4 threads —
against constants pinned from the pure-Python reference simulator.  Every
phase prints one JSON line; any mismatch, build failure or launch error
ends the run with a non-zero exit code, and nothing runs on the CPU when
no GPU is found.  The last line is ``{"ok": true, "device": {...}}``.

Options (none are needed for the full check): ``--scale N`` picks the
R-MAT scale of the full-width graph (one of ``FULL_WIDTH``), ``--only``
limits the run to some phases, ``--profile`` adds a ``torch.profiler``
window over the interpreter loop and writes its tables to ``--out``
(default ``smoke_out/``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: hello, 1 core, 4 MiB image, 921600-baud UART, async queue pair
HELLO_UART = dict(ticks=6_554_780,
                  stdout=b"hello from FASE target\nanswer 42\n")
#: bc on rmat(4,4), 2 threads, 2 cores, 4 MiB image, PCIe async queue pair
BC_PCIE = dict(ticks=775_078, instret=11_876, traffic=24_681)
#: the full-width run: FASE_ROCKET_PCIE, ``bc g.bin 4 1`` on
#: ``graphgen.rmat(scale, 4, weights=True)``; constants from the reference
#: package's pure-Python simulator (tests/test_torch_golden.py re-derives
#: them), keyed by scale
FULL_WIDTH = {
    5: dict(ticks=1_346_268, instret=34_530, traffic=46_676),
    8: dict(ticks=1_684_458, instret=71_269, traffic=69_810),
    10: dict(ticks=1_606_494, instret=181_583, traffic=125_900),
}
#: scale 5 keeps the whole script near a quarter of its 1200 s limit on
#: a slow host (the interpreter loop is launch-bound: ~10 ms a substep)
DEFAULT_SCALE = 5

#: published peak of one H100 SXM: HBM bytes per second
HBM_BYTES_PER_S = 3.35e12
#: the TPU kernel each port kernel replaces (file:line of its pallas_call)
REPLACES = {"walk_fetch_block":
            "src/repro/kernels/page_walk/page_walk.py:126"}

PHASES = ("kernel", "hello", "bc", "full")


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


# ---------------------------------------------------------------------------
# kernel vs plain version, on the card
# ---------------------------------------------------------------------------
def build_walk_image(torch, mem_bytes, seed, dev):
    """A seeded word image with a 3-level Sv39 table (root/l1/l0 at pages
    2/3/4): 4 KiB leaves for vpn 16..64 (vpn 50 read-only, vpn 51 without
    X), a non-U leaf at vpn 65, nothing above, a 2 MiB superpage at
    vpn1 = 1, random words everywhere else."""
    import numpy as np
    V, R, W, X, U, A, D = 1, 2, 4, 8, 16, 64, 128
    flags = V | R | W | X | U | A | D
    n = mem_bytes // 8
    rng = np.random.RandomState(seed)
    mem = rng.randint(0, 1 << 62, n).astype(np.uint64) << np.uint64(2)
    mem[:16 * 512] = 0
    root, l1, l0 = 2, 3, 4
    mem[root * 512] = (l1 << 10) | V
    mem[l1 * 512] = (l0 << 10) | V
    mem[l1 * 512 + 1] = (0x80 << 10) | flags
    for vpn0 in range(16, 65):
        mem[l0 * 512 + vpn0] = (vpn0 << 10) | flags
    mem[l0 * 512 + 50] = (50 << 10) | (flags & ~W)
    mem[l0 * 512 + 51] = (51 << 10) | (flags & ~X)
    mem[l0 * 512 + 65] = (65 << 10) | (flags & ~U)
    return torch.from_numpy(mem.view(np.int64)).to(dev), (8 << 60) | root


def i64(torch, vals, dev):
    from repro_torch.core.target.u64 import to_signed
    return torch.tensor([to_signed(int(v)) for v in vals],
                        dtype=torch.int64, device=dev)


def compare_outputs(torch, got, want, what):
    """Array-equal on all five outputs and all slots; returns the largest
    absolute difference seen (0 when equal) and fails when it is not 0."""
    names = ("pa", "fault", "walk_words", "insts", "nbytes")
    worst = 0
    for name, g, w in zip(names, got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{what}: {name} shape/dtype {g.shape}/{g.dtype} != "
              f"{w.shape}/{w.dtype}")
        if not torch.equal(g, w):
            diff = (g.to(torch.float64) - w.to(torch.float64)).abs().max()
            worst = max(worst, float(diff))
            bad = (g != w).nonzero()[:4].tolist()
            fail(f"{what}: kernel != plain version in {name} at {bad} "
                 f"(max abs diff {worst})")
    return worst


def time_ms(torch, fn, iters, warmup=10):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def walk_fetch_bound_ms(torch, out, lanes, block_words, active=None,
                        base=False):
    """Least time for one call on these inputs: every input read once and
    every output written once at the HBM rate.  The PTE words are counted
    as the walk really read them (levels reached), the block as the
    distinct 8-byte words its slots cover."""
    pa, fault, walk_words, insts, nbytes = out
    pte_reads = int((walk_words != -1).sum())
    lane_on = active if active is not None else torch.ones_like(fault)
    block_words_read = int(((block_words // 2) + ((pa >> 2) & 1))[lane_on]
                           .sum())
    in_bytes = 16 * lanes + (lanes if active is not None else 0) + \
        (8 * lanes if base else 0) + 8 * (pte_reads + block_words_read)
    out_bytes = lanes * (8 + 1 + 24 + 4 * block_words + 8)
    return (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3


def phase_kernel(torch, dev):
    from repro_torch.kernels import _build
    from repro_torch.kernels.page_walk import ops, page_walk

    t0 = time.time()
    _build.load_all(["page_walk"])
    emit({"phase": "build", "kernels": ["page_walk"],
          "seconds": round(time.time() - t0, 3)})

    mem_bytes = 1 << 20
    mask = mem_bytes - 1
    mem, satp_v = build_walk_image(torch, mem_bytes, 1, dev)
    n = mem_bytes // 8
    both = torch.cat([mem, mem ^ 0x5A5A_0000_0000_A5A5])
    # the reference test's cases: 4 KiB leaf mid-page, block clamped at the
    # page end, 2 MiB superpage, no-U fault, invalid leaf, out of table
    vas = [16 * 4096 + 8, 40 * 4096 + 4092, 0x200000 + 0x1234 * 4,
           65 * 4096, 66 * 4096, 0x7000_0000]
    cases = 0
    worst = 0.0
    for bw in (8, 16):
        for with_base in (False, True):
            m = both if with_base else mem
            for bare in (False, True):
                va_l = [0x10000, 0x10002 * 4 + 2] if bare else vas
                reps = 2 if with_base else 1
                va = i64(torch, va_l * reps, dev)
                satp = i64(torch, [0 if bare else satp_v] * len(va), dev)
                base = None
                if with_base:
                    base = i64(torch, [0] * len(va_l) + [n] * len(va_l), dev)
                got = ops.walk_fetch_block(m, satp, va, mask, bw, base)
                want = ops.walk_fetch_block(m, satp, va, mask, bw, base,
                                            impl="ref")
                torch.cuda.synchronize()
                worst = max(worst, compare_outputs(
                    torch, got, want,
                    f"directed bw={bw} base={with_base} bare={bare}"))
                if not bare:
                    check(got[1].tolist()[:6] ==
                          [False, False, False, True, True, True],
                          "directed faults are not F,F,F,T,T,T")
                cases += 1
    # a few thousand random lanes over the seeded table, with a mask
    import numpy as np
    rng = np.random.RandomState(5)
    lanes = 4096
    va_np = rng.randint(0, 80 * 4096, lanes).astype(np.uint64)
    va_np[::7] = (0x200000 + rng.randint(0, 1 << 21, len(va_np[::7]))) \
        .astype(np.uint64)
    va_np[::11] |= np.uint64(1) << np.uint64(rng.randint(39, 64))
    satp_np = np.where(rng.rand(lanes) < 0.85, np.uint64(satp_v),
                       np.uint64(0)).astype(np.uint64)
    va = torch.from_numpy(va_np.view(np.int64)).to(dev)
    satp = torch.from_numpy(satp_np.view(np.int64)).to(dev)
    active = torch.from_numpy(rng.rand(lanes) < 0.7).to(dev)
    base = torch.from_numpy(
        (rng.randint(0, 2, lanes) * n).astype(np.int64)).to(dev)
    for bw in (8, 16):
        for b, a in ((None, None), (base, None), (None, active),
                     (base, active)):
            m = both if b is not None else mem
            got = ops.walk_fetch_block(m, satp, va, mask, bw, b, a)
            want = ops.walk_fetch_block(m, satp, va, mask, bw, b, a,
                                        impl="ref")
            torch.cuda.synchronize()
            worst = max(worst, compare_outputs(
                torch, got, want, f"random bw={bw} base={b is not None} "
                f"active={a is not None}"))
            cases += 1
    nf = int(got[1].sum())
    check(0 < nf < lanes, "random lanes: faults are all or none")
    # the wrapper refuses what the kernel does not take
    for bad in (lambda: page_walk.walk_fetch_block(mem.cpu(), satp, va,
                                                   mask, 16),
                lambda: page_walk.walk_fetch_block(mem, satp, va, mask, 12),
                lambda: page_walk.walk_fetch_block(mem, satp.to(torch.int32),
                                                   va, mask, 16)):
        try:
            bad()
        except ValueError:
            continue
        fail("the kernel wrapper accepted an input it must refuse")
    emit({"phase": "kernel_vs_plain", "kernel": "walk_fetch_block",
          "cases": cases, "random_lanes": lanes, "tolerance": 0,
          "max_abs_err": worst, "equal": True})
    return worst


def time_walk_fetch(torch, tgt, worst):
    """The kernel and its plain version at the main path's shape, on the
    image, ``satp`` and program counters the full-width run left behind."""
    from repro_torch.kernels.page_walk import ops

    st = tgt.st
    mask = tgt.mem_bytes - 1
    bw = tgt.block_words
    lanes = tgt.nc
    active = torch.ones((lanes,), dtype=torch.bool, device=st.device)
    args = (st.mem, st.satp, st.pc, mask, bw, None, active)
    got = ops.walk_fetch_block(*args)
    want = ops.walk_fetch_block(*args, impl="ref")
    torch.cuda.synchronize()
    worst = max(worst, compare_outputs(torch, got, want, "main-path shape"))
    check(not bool(got[1].any()), "main-path shape: a final pc faults")
    ms = time_ms(torch, lambda: ops.walk_fetch_block(*args), 2000)
    plain_ms = time_ms(torch, lambda: ops.walk_fetch_block(*args,
                                                           impl="ref"), 100)
    return dict(shape=dict(W=int(st.mem.shape[0]), L=lanes, block_words=bw),
                ms=ms, plain_ms=plain_ms,
                bound_ms=walk_fetch_bound_ms(torch, got, lanes, bw, active),
                max_abs_err=worst)


# ---------------------------------------------------------------------------
# end-to-end phases
# ---------------------------------------------------------------------------
def phase_hello(torch):
    from repro_torch.run import run_workload
    rt, rep, wall = run_workload("hello", [], mode="fase", n_cores=1,
                                 mem=1 << 22, device="cuda")
    emit({"phase": "hello_uart", "ticks": rep.ticks,
          "stdout": rep.stdout.decode(), "substeps": rt.target.substeps,
          "wall_s": round(wall, 3)})
    check(rep.ticks == HELLO_UART["ticks"],
          f"hello@UART ticks {rep.ticks} != {HELLO_UART['ticks']}")
    check(rep.stdout == HELLO_UART["stdout"], "hello@UART stdout differs")


def phase_bc(torch):
    from repro_torch.core.workloads import graphgen
    from repro_torch.run import run_workload
    g = graphgen.rmat(4, 4, weights=True)
    rt, rep, wall = run_workload("bc", ["g.bin", "2", "1"], mode="fase",
                                 link="pcie", n_cores=2, mem=1 << 22,
                                 device="cuda", files={"g.bin": g})
    got = dict(ticks=rep.ticks, instret=sum(rep.instret),
               traffic=rep.traffic_total)
    emit({"phase": "bc_pcie", **got, "substeps": rt.target.substeps,
          "wall_s": round(wall, 3)})
    check(got == BC_PCIE, f"bc@PCIe {got} != {BC_PCIE}")


def profile_window(torch, tgt, s_per_substep, out_dir, substeps=256):
    """A ``torch.profiler`` window over the interpreter loop alone: a
    guest loop without system calls (load, add, store, multiply, jump on
    a private line per core), ``substeps`` ticks.  Writes the by-operator
    tables under ``out_dir`` and reports the kernel launches and the
    device time per substep; the device-busy share sets that device time
    against ``s_per_substep``, the full-width run's unprofiled pace (the
    profiler itself slows the host several times over)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.interface import TorchTarget
    from repro_torch.core.target import asm
    img = asm.assemble("""
_start:
    li s1, 0x20000
    slli t0, a0, 6
    add s1, s1, t0
1:
    ld t1, 0(s1)
    addi t1, t1, 3
    sd t1, 0(s1)
    mul t2, t1, t1
    j 1b
""")
    t = TorchTarget(tgt.nc, tgt.mem_bytes, device="cuda")
    for seg in img.segments:
        data = bytes(seg.data).ljust((len(seg.data) + 7) // 8 * 8, b"\0")
        for i in range(0, len(data), 8):
            t.mem_write_word(seg.vaddr + i,
                             int.from_bytes(data[i:i + 8], "little"))
    for c in range(t.nc):
        t.reg_write(c, 10, c)
        t.redirect(c, img.entry)
    t.run(max_cycles=64)                                   # warm-up
    before = t.substeps
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t.run(max_cycles=substeps)
        torch.cuda.synchronize()
    wall = time.time() - t0
    ka = prof.key_averages()
    on_dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in on_dev)
    walk = [e for e in on_dev if "walk_fetch_block" in e.key]
    check(len(walk) == 1, "profile: walk_fetch_block kernel not traced")
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    ran = t.substeps - before
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "substep_profile.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=40))
        f.write("\n")
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    # the kernel alone, every lane walking, at the main path's shape: its
    # device time without the wrapper's host cost
    from repro_torch.kernels.page_walk import ops
    st = tgt.st
    args = (st.mem, st.satp, st.pc, tgt.mem_bytes - 1, tgt.block_words,
            None, torch.ones_like(st.pending))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as kprof:
        for _ in range(200):
            ops.walk_fetch_block(*args)
        torch.cuda.synchronize()
    alone = [e for e in kprof.key_averages()
             if e.device_type == DeviceType.CUDA and
             "walk_fetch_block" in e.key]
    n_alone = sum(e.count for e in alone)
    # the tracer may miss a few launches at the start of its window
    check(n_alone >= 100, f"profile: only {n_alone} of 200 "
          f"walk_fetch_block launches traced")
    out = {"phase": "profile", "substeps": ran,
           "wall_s_under_profiler": round(wall, 4),
           "kernel_launches_per_substep": launches / ran,
           "device_us_per_substep": dev_us / ran,
           "device_busy_share": dev_us / ran / (s_per_substep * 1e6),
           "walk_fetch_block_device_us_in_loop":
           walk[0].self_device_time_total / walk[0].count,
           "walk_fetch_block_device_us_all_lanes":
           sum(e.self_device_time_total for e in alone) / n_alone}
    emit(out)
    return out


def phase_full(torch, scale, worst, profile_dir):
    from repro_torch.configs.fase_rocket import (runtime_kwargs,
                                                 target_kwargs)
    from repro_torch.configs.registry import FASE_ROCKET_PCIE as cfg
    from repro_torch.core.workloads import graphgen
    from repro_torch.kernels.page_walk import page_walk
    from repro_torch.run import run_workload

    pins = FULL_WIDTH[scale]
    g = graphgen.rmat(scale, 4, weights=True)
    torch.cuda.reset_peak_memory_stats()
    page_walk.walk_fetch_block.launches = 0          # just before the path
    rt, rep, wall = run_workload(
        "bc", ["g.bin", "4", "1"], mode="fase", n_cores=cfg["n_cores"],
        mem=cfg["mem_bytes"], device="cuda", files={"g.bin": g},
        target_opts=target_kwargs(cfg), **runtime_kwargs(cfg))
    launches = page_walk.walk_fetch_block.launches   # just after it
    tgt = rt.target
    got = dict(ticks=rep.ticks, instret=sum(rep.instret),
               traffic=rep.traffic_total)
    sub = tgt.substeps
    walks = int(tgt.st.fetch_walks.sum())
    emit({"phase": "full_width", "config": "FASE_ROCKET_PCIE",
          "workload": f"bc 4T rmat({scale},4)", "n_cores": tgt.nc,
          "mem_bytes": tgt.mem_bytes, "image_on": str(tgt.st.mem.device),
          **got, "substeps": sub, "wall_s": round(wall, 3),
          "instr_per_s": got["instret"] / wall,
          "s_per_substep": wall / sub,
          "walk_fetch_block_launches": launches,
          "fetch_lanes_walked": walks,
          "fetch_hits": int(tgt.st.fetch_hits.sum()),
          "tlb_walks": int(tgt.st.tlb_walks.sum()),
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    check(got == pins, f"full-width run {got} != pinned {pins}")
    check(b"bc_delta0" in rep.stdout, "full-width run: bc printed no result")
    check(tgt.st.mem.is_cuda and tgt.st.mem.shape[0] == 1 << 23,
          "full-width image is not 8 Mi words on the card")
    check(launches > 0,
          "the main path never launched the walk_fetch_block kernel")
    check(launches == sub, f"launches {launches} != substeps {sub}")
    check(0 < walks <= launches * tgt.nc, "fetch_walks out of range")
    timing = time_walk_fetch(torch, tgt, worst)
    if profile_dir:
        profile_window(torch, tgt, wall / sub, profile_dir)
    return launches, timing


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=DEFAULT_SCALE,
                    choices=sorted(FULL_WIDTH))
    ap.add_argument("--only", nargs="+", choices=PHASES, default=PHASES,
                    help="run only these phases (the final ok line needs "
                         "all of them)")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"),
                    help="directory for the --profile tables")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check runs on a GPU only", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here when run outside the repo)

    t_start = time.time()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    worst = 0.0
    kernels = []
    if "kernel" in args.only:
        worst = phase_kernel(torch, dev)
    if "hello" in args.only:
        phase_hello(torch)
    if "bc" in args.only:
        phase_bc(torch)
    if "full" in args.only:
        launches, t = phase_full(torch, args.scale, worst,
                                 args.out if args.profile else None)
        kernels.append({
            "name": "walk_fetch_block", "route": "cuda",
            "source": "src/repro_torch/csrc/page_walk.cu",
            "replaces": REPLACES["walk_fetch_block"],
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shape": t["shape"]})
    if set(args.only) != set(PHASES):
        emit({"phase": "partial", "ran": list(args.only),
              "seconds": round(time.time() - t_start, 1)})
        print("chip_smoke: partial run, no verdict", file=sys.stderr)
        return 4
    emit({"phase": "total", "seconds": round(time.time() - t_start, 1)})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
