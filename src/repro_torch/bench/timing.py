"""Timing helpers and seeded inputs shared by the port's benchmark
scripts and ``chip_smoke.py``: CUDA-event and CUDA-graph timers, the
profiler's device events, the card's name and power limit, the seeded
attention inputs, and a target running a guest loop.

Nothing here is imported at module level but the standard library: every
helper takes the ``torch`` module, and imports the port inside itself, so
that a script can point ``sys.path`` at another tree's ``repro_torch``
first (:func:`use_tree`).
"""
from __future__ import annotations

import os
import subprocess
import sys

#: the chunk kernel's timed chunk: ``CHUNK_CYCLES`` ticks of a guest loop
#: without system calls on the full-width target, back to back
CHUNK_CYCLES = 64
#: paged_attention at qwen3-8b's native context (Qwen3 model card: 32 768
#: tokens) on 4 slots: B, H, Hkv, D, page, P; each pool 2 048 pages of
#: 64 x 8 x 128 bf16 (268 MB).  Timed full
LONG_SHAPE = (4, 32, 8, 128, 64, 512)
LONG_TIMED_LENS = (32768, 32768, 32768, 32768)

#: the ``src`` directory this package lies in
OWN_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def use_tree(src):
    """Make ``import repro_torch`` load the package under ``src`` (for
    instance an unpacked earlier commit's ``src``) from here on: the
    port's modules already imported are dropped from ``sys.modules`` and
    ``src`` goes first on ``sys.path``.  The helpers of this module keep
    working (they import the port inside each call).  Nothing changes when
    ``src`` is this package's own tree."""
    src = os.path.abspath(src)
    if src == OWN_SRC:
        return
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, src)


def nvidia_smi_line():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def time_ms(torch, fn, iters, warmup=10):
    """Wall ms of one ``fn()`` on the card: ``iters`` calls back to back
    between two CUDA events, after ``warmup`` calls."""
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


def graph_ms(torch, fn, iters):
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph, replayed, timed by CUDA events, divided by ``iters`` — the
    kernels back to back without the host's launch cost."""
    fn()                                   # warm: build, workspace, plan
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # capture warms a side stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / iters


#: CUPTI's overhead records as the profiler names them: spans on the host
#: (a launch waiting for room in the device's command queue, the
#: tracer's own buffers), not work of the device
CUPTI_OVERHEAD = frozenset((
    "Unknown", "Driver Compiler", "Buffer Flush", "Instrumentation",
    "Resource", "Runtime Triggered Module Loading", "Lazy Function Loading",
    "Command Buffer Full", "Activity Buffer Request", "UVM Activity Init"))


#: empty kernels that open a profile window (:func:`lead_in`)
LEAD_IN_LAUNCHES = 1024
#: the lead-in's kernel, ``torch.cuda._sleep``'s, as the profiler names it
LEAD_IN_KERNEL = "spin_kernel"


def lead_in(torch):
    """Open a ``torch.profiler`` window with ``LEAD_IN_LAUNCHES`` empty
    kernels.  With torch 2.11 and CUDA 12.8 on an H100 the tracer drops
    the device records of a window's first launches, more the longer the
    process has run, whether the launches start at once, after a pause
    on the host or after a long kernel (``bench/profile_drop.py``
    measures it).  The drop falls on these; :func:`device_events` leaves
    them out."""
    for _ in range(LEAD_IN_LAUNCHES):
        torch.cuda._sleep(0)


def device_events(ka):
    """The kernels, copies and memsets of a profile's ``key_averages()``:
    its events on the CUDA device, CUPTI's overhead records and the
    lead-in's kernels left out."""
    from torch.autograd import DeviceType
    return [e for e in ka if e.device_type == DeviceType.CUDA and
            e.key not in CUPTI_OVERHEAD and LEAD_IN_KERNEL not in e.key]


def attention_inputs(torch, dev, B, H, Hkv, D, page, P, dtype, seed,
                     lens=None, pages=None):
    """Seeded q, pools of ``pages`` (default B * P) pages and a table of
    distinct random pages; lens random in [1, P * page] unless given."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    NP = pages or B * P
    q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
    kp = torch.randn((NP, page, Hkv, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((NP, page, Hkv, D), generator=g, device=dev).to(dtype)
    bt = torch.randperm(NP, generator=g, device=dev)[:B * P] \
        .reshape(B, P).to(torch.int32)
    if lens is None:
        lens = torch.randint(1, P * page + 1, (B,), generator=g, device=dev)
    lens = torch.as_tensor(lens, device=dev).to(torch.int32)
    return q, kp, vp, bt, lens


def flash_inputs(torch, dev, B, S, H, Hkv, D, dtype, seed):
    """Seeded q ``(B, S, H, D)``, k and v ``(B, S, Hkv, D)`` on the card."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def draw(h):
        return torch.randn((B, S, h, D), generator=g, device=dev).to(dtype)
    return draw(H), draw(Hkv), draw(Hkv)


def loop_target(torch, nc, mem_bytes, **opts):
    """A target at the full-width run's shape running a guest loop
    without system calls (load, add, store, multiply, jump on a private
    line per core): every chunk of it is the same work."""
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
    t = TorchTarget(nc, mem_bytes, device="cuda", **opts)
    for seg in img.segments:
        data = bytes(seg.data).ljust((len(seg.data) + 7) // 8 * 8, b"\0")
        for i in range(0, len(data), 8):
            t.mem_write_word(seg.vaddr + i,
                             int.from_bytes(data[i:i + 8], "little"))
    for c in range(t.nc):
        t.reg_write(c, 10, c)
        t.redirect(c, img.entry)
    return t
