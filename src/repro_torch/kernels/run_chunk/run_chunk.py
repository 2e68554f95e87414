"""Launching wrapper of the CUDA chunk kernel.

The kernel (``repro_torch/csrc/run_chunk.cu``) runs the FASE target's
whole chunk loop — every substep of
:func:`repro_torch.core.target.cpu.run_chunk_fast` up to the loop
predicate — in one launch of one CTA, thread ``l`` core ``l``, with the
Sv39 walk and the fetch-block fill as device functions
(``csrc/page_walk.cuh``).  Its plain
version is the eager loop ``cpu._run_chunk_eager``.  The library is built
and loaded at the first call, never at import (the CPU tests import this
module).

Contract: a board of at most :data:`WARP_LANES` cores runs on one warp
(the cross-lane steps are warp ballots and shuffles); a board of up to
:data:`LANES_MAX` cores, one CTA's threads, on the CTA-wide instantiation
(``ceil(n / 32)`` warps, the same steps through shared memory and
``__syncthreads``).  The wrapper raises ``ValueError`` past
:data:`LANES_MAX` cores, or where the board's register files, data TLB and
fetch slots (:func:`smem_bytes`, the source's own count) exceed the
:data:`SMEM_MAX` bytes of shared memory one CTA may hold.

With ``trace_on`` the wrapper launches the kernel's traced instantiation
(``run_chunk_kernel<true>``), which also records the commit-trace ring
(``tracebuf``/``trace_n``/``trace_armed``) at the retire point under the
capture-window ``trigger``; its plain version is the eager loop with the
ring (``cpu._trace_record``).  Its launches count in
``run_chunk.trace_launches``, the untraced ones in ``run_chunk.launches``.

:func:`run_chunk_fleet` launches the same loop for a fleet: one CTA per
board of a stacked state (``cpu.make_fleet_state``), with the same limits
a board, for any number of boards.  Its plain
version is ``cpu._run_chunk_fleet_eager``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

#: most cores one launch takes: the threads of one CTA
LANES_MAX = 1024
#: boards up to this many cores run on one warp; larger ones CTA-wide
WARP_LANES = 32
#: dynamic shared memory one CTA may hold on Hopper (227 KiB)
SMEM_MAX = 232_448

#: the ``CpuState`` fields the kernel reads or writes, in the order of
#: ``run_chunk_launch``'s pointers, with their dtype and per-core shape
#: (``ticks`` is the 0-d global clock)
FIELDS = (("regs", torch.int64, (32,)), ("pc", torch.int64, ()),
          ("priv", torch.int32, ()), ("pending", torch.bool, ()),
          ("stall_until", torch.int64, ()), ("satp", torch.int64, ()),
          ("mcause", torch.int64, ()), ("mepc", torch.int64, ()),
          ("mtval", torch.int64, ()), ("res", torch.int64, ()),
          ("ticks", torch.int64, None), ("uticks", torch.int64, ()),
          ("instret", torch.int64, ()), ("stall_ticks", torch.int64, ()),
          ("fetch_hits", torch.int64, ()), ("fetch_walks", torch.int64, ()),
          ("tlb_walks", torch.int64, ()))

#: ``run_chunk_launch``: the image, the fields, out, the mask, the limit,
#: lanes and the four knobs, the ring's three tensors, slots, trace_on,
#: the trigger's kind, disarm flag and two values, the stream
_ARGS = [ctypes.c_void_p] * (2 + len(FIELDS)) + [
    ctypes.c_uint64, ctypes.c_longlong] + [ctypes.c_int] * 5 + [
    ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
    ctypes.c_uint64] * 2 + [ctypes.c_void_p]
#: the trigger kinds of ``repro_torch.telemetry.triggers`` as the kernel
#: numbers them (``TRIG_*`` in the source); 0 is no gate
TRIGGER_KINDS = {"tick": 1, "instret": 2, "pc": 3, "inst": 4}
_M64 = (1 << 64) - 1
#: ``run_chunk_fleet_launch``: the image, the fields, budgets and out, the
#: mask, the words a board, lanes, boards and the four knobs, the stream
FLEET_ARGS = [ctypes.c_void_p] * (3 + len(FIELDS)) + [
    ctypes.c_uint64, ctypes.c_longlong] + [ctypes.c_int] * 6 + [
    ctypes.c_void_p]


def smem_bytes(n_cores, block_words, dtlb_ways, lib=None):
    """Shared memory of one launch as the kernel source counts it
    (``run_chunk_smem_bytes``): the register files, the data TLB and the
    fetch blocks' slots, and past :data:`WARP_LANES` cores the CTA-wide
    scratch.  Asks the built library, or ``lib`` (another build of the
    same source, loaded with ctypes)."""
    f = (lib or _build.load("run_chunk")).run_chunk_smem_bytes
    f.argtypes = [ctypes.c_int] * 3
    f.restype = ctypes.c_size_t
    return f(n_cores, block_words, dtlb_ways)


def check_smem(op, n_cores, block_words, dtlb_ways, lib=None):
    """Raise ``ValueError`` where one launch needs more shared memory than
    the :data:`SMEM_MAX` bytes one CTA may hold."""
    need = smem_bytes(n_cores, block_words, dtlb_ways, lib)
    if need > SMEM_MAX:
        raise ValueError(f"{op}: {n_cores} cores with block_words "
                         f"{block_words} and dtlb_ways {dtlb_ways} need "
                         f"{need} bytes of shared memory, over the "
                         f"{SMEM_MAX} one CTA may hold")


def check_state(st, n_cores, mem_bytes, block_words, dtlb_ways,
                boards=None):
    """Raise ``ValueError`` unless the kernel takes this state and these
    knobs: ``n_cores`` within :data:`LANES_MAX`, every field a contiguous
    tensor of its dtype and shape on the image's device, the image
    ``mem_bytes // 8`` words.  With ``boards`` the state is a fleet's
    stack: every shape gains a leading axis of ``boards``."""
    op = "run_chunk" if boards is None else "run_chunk_fleet"
    if not 0 < n_cores <= LANES_MAX:
        raise ValueError(f"{op}: the kernel runs one core per thread of one "
                         f"CTA, at most {LANES_MAX} cores (a CTA's thread "
                         f"limit){'' if boards is None else ' a board'}; "
                         f"got {n_cores}")
    lead = () if boards is None else (boards,)
    dev = st.mem.device
    _build.check_tensor(op, "mem", st.mem, torch.int64,
                        lead + (mem_bytes // 8,), dev)
    for name, dtype, tail in FIELDS:
        shape = () if tail is None else (n_cores, *tail)
        _build.check_tensor(op, name, getattr(st, name), dtype,
                            lead + shape, dev)
    if block_words <= 0 or block_words & (block_words - 1):
        raise ValueError(f"{op}: block_words must be a power of two, got "
                         f"{block_words}")
    if dtlb_ways < 0 or dtlb_ways & (dtlb_ways - 1):
        raise ValueError(f"{op}: dtlb_ways must be a power of two or 0, "
                         f"got {dtlb_ways}")


def trigger_args(trigger):
    """``(kind, disarm flag, a, b)`` of a trigger spec for the kernel:
    tick ``(t0, t1)``, instret ``(n, 0)``, pc/inst ``(arm, disarm)``."""
    if trigger is None:
        return 0, 0, 0, 0
    kind = trigger[0]
    if kind not in TRIGGER_KINDS:
        raise ValueError(f"run_chunk: unknown trigger kind {kind!r}")
    b = trigger[2] if len(trigger) > 2 else None
    return (TRIGGER_KINDS[kind], int(b is not None), int(trigger[1]) & _M64,
            0 if b is None else int(b) & _M64)


def check_trace(st, n_cores):
    """Raise ``ValueError`` unless the state carries an armed ring the
    traced instantiation takes: ``tracebuf`` int64 ``(nc, slots, 4)``
    with ``slots > 0``, ``trace_n`` int64 and ``trace_armed`` bool
    ``(nc,)``, contiguous on the image's device."""
    dev = st.mem.device
    slots = st.tracebuf.shape[1] if st.tracebuf.dim() == 3 else 0
    if slots <= 0:
        raise ValueError("run_chunk: trace_on needs an armed ring "
                         "(TorchTarget.trace_arm)")
    _build.check_tensor("run_chunk", "tracebuf", st.tracebuf, torch.int64,
                        (n_cores, slots, 4), dev)
    _build.check_tensor("run_chunk", "trace_n", st.trace_n, torch.int64,
                        (n_cores,), dev)
    _build.check_tensor("run_chunk", "trace_armed", st.trace_armed,
                        torch.bool, (n_cores,), dev)


def launch_args(st, out, n_cores, mem_bytes, max_cycles, issue_width,
                block_words, block_cache, dtlb_ways, stream, trace_on=False,
                trigger=None):
    """The arguments of ``run_chunk_launch`` for this state, in order."""
    kind, disarm, a, b = trigger_args(trigger if trace_on else None)
    return (st.mem.data_ptr(),
            *(getattr(st, name).data_ptr() for name, _, _ in FIELDS),
            out.data_ptr(), (mem_bytes - 1) & _M64,
            int(max_cycles), n_cores, issue_width, block_words,
            int(bool(block_cache)), dtlb_ways, st.tracebuf.data_ptr(),
            st.trace_n.data_ptr(), st.trace_armed.data_ptr(),
            st.tracebuf.shape[1] if st.tracebuf.dim() == 3 else 0,
            int(bool(trace_on)), kind, disarm, a, b, stream)


def run_chunk(st, n_cores, mem_bytes, max_cycles, issue_width=8,
              block_words=16, block_cache=True, dtlb_ways=8,
              trace_on=False, trigger=None) -> int:
    """Advance the CUDA state ``st`` in place by up to ``max_cycles``
    ticks in one launch; returns the substeps issued (a whole
    ``issue_width`` group per predicate test), read back once with the
    launch's round-trip count.  ``trace_on`` launches the traced
    instantiation, which records the commit-trace ring under
    ``trigger``."""
    check_state(st, n_cores, mem_bytes, block_words, dtlb_ways)
    if trace_on:
        check_trace(st, n_cores)
    if not st.mem.is_cuda:
        raise ValueError("run_chunk: the kernel needs a CUDA state; the "
                         "eager loop runs a CPU state")
    if issue_width <= 0:
        raise ValueError(f"run_chunk: issue_width must be positive, got "
                         f"{issue_width}")
    check_smem("run_chunk", n_cores, block_words, dtlb_ways)
    dev = st.mem.device
    out = torch.empty((2,), dtype=torch.int64, device=dev)
    args = launch_args(st, out, n_cores, mem_bytes, max_cycles,
                       issue_width, block_words, block_cache, dtlb_ways,
                       torch.cuda.current_stream(dev).cuda_stream, trace_on,
                       trigger)
    _build.launch("run_chunk", _build.entry(
        "run_chunk", "run_chunk_launch", _ARGS), args, dev)
    if trace_on:
        run_chunk.trace_launches += 1
    else:
        run_chunk.launches += 1
    substeps, trips = out.tolist()
    run_chunk.trips += trips
    return substeps


def fleet_launch_args(sts, budgets, out, n_cores, mem_bytes, issue_width,
                      block_words, block_cache, dtlb_ways, stream):
    """The arguments of ``run_chunk_fleet_launch`` for this stack, in
    order (``budgets`` an int64 tensor of one limit a board)."""
    return (sts.mem.data_ptr(),
            *(getattr(sts, name).data_ptr() for name, _, _ in FIELDS),
            budgets.data_ptr(), out.data_ptr(),
            (mem_bytes - 1) & ((1 << 64) - 1), mem_bytes // 8, n_cores,
            sts.pc.shape[0], issue_width, block_words,
            int(bool(block_cache)), dtlb_ways, stream)


def run_chunk_fleet(sts, n_cores, mem_bytes, budgets, issue_width=8,
                    block_words=16, block_cache=True, dtlb_ways=8) -> list:
    """One global chunk of the fleet ``sts`` (a CUDA stack of D boards) in
    one launch: board ``d`` advances in place by up to ``budgets[d]``
    ticks; a board of budget 0 is untouched.  Returns the substeps issued
    for each board, read back once with the round trips."""
    boards = sts.pc.shape[0]
    check_state(sts, n_cores, mem_bytes, block_words, dtlb_ways, boards)
    if not sts.mem.is_cuda:
        raise ValueError("run_chunk_fleet: the kernel needs a CUDA stack; "
                         "the eager flat form runs a CPU stack")
    if issue_width <= 0:
        raise ValueError(f"run_chunk_fleet: issue_width must be positive, "
                         f"got {issue_width}")
    if len(budgets) != boards or min(budgets) < 0:
        raise ValueError(f"run_chunk_fleet: need {boards} budgets >= 0, "
                         f"got {list(budgets)}")
    check_smem("run_chunk_fleet", n_cores, block_words, dtlb_ways)
    dev = sts.mem.device
    limits = torch.tensor(budgets, dtype=torch.int64).to(dev)
    out = torch.empty((boards, 2), dtype=torch.int64, device=dev)
    args = fleet_launch_args(sts, limits, out, n_cores, mem_bytes,
                             issue_width, block_words, block_cache,
                             dtlb_ways, _build.current_stream(dev))
    _build.launch("run_chunk_fleet", _build.entry(
        "run_chunk", "run_chunk_fleet_launch", FLEET_ARGS), args, dev)
    run_chunk_fleet.launches += 1
    got = out.tolist()
    run_chunk_fleet.trips += sum(t for _, t in got)
    return [s for s, _ in got]


#: launches of the CUDA kernel's untraced instantiation since the counter
#: was last set to 0
run_chunk.launches = 0
#: launches of its traced instantiation (``trace_on``) since last set to 0
run_chunk.trace_launches = 0
#: dependent round trips to global memory on the kernel's critical path
#: (the longest chain of each substep, summed) since last set to 0
run_chunk.trips = 0
#: launches of the fleet kernel (one a global chunk) since last set to 0
run_chunk_fleet.launches = 0
#: the boards' dependent round trips, summed, since last set to 0
run_chunk_fleet.trips = 0
