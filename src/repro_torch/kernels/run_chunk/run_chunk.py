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
``cta_lanes`` cores on the CTA-wide instantiation (``ceil(n / 32)``
warps, the same steps through shared memory and ``__syncthreads``); a
board past ``cta_lanes`` on a thread-block cluster of ``ceil(n /
cta_lanes)`` CTAs (the same steps with a second level through
distributed shared memory and the cluster barrier).  ``cta_lanes``
defaults to the most whole warps whose cluster rank fits the
:data:`SMEM_MAX` bytes of shared memory one CTA may hold
(:func:`default_cta_lanes`, the source's own count: 384 at 8 TLB ways and
16-word blocks); a test may pass a smaller one.  The wrapper raises
``ValueError`` only past the largest cluster the card schedules
(:func:`max_cluster`: the largest of 16, 8, 4 and 2 CTAs it finds room
for, else 1), naming that limit; a cluster launch the card refuses
raises with its CUDA error.

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

#: most cores one CTA takes: its threads
LANES_MAX = 1024
#: boards up to this many cores run on one warp; larger ones CTA-wide
WARP_LANES = 32
#: dynamic shared memory one CTA may hold on Hopper (227 KiB)
SMEM_MAX = 232_448
#: the most CTAs of a cluster the source launches (past 8, with the
#: non-portable cluster size allowed)
CLUSTER_MAX = 16

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
#: lanes, the four knobs and cta_lanes, the ring's three tensors, slots,
#: trace_on, the trigger's kind, disarm flag and two values, the stream
_ARGS = [ctypes.c_void_p] * (2 + len(FIELDS)) + [
    ctypes.c_uint64, ctypes.c_longlong] + [ctypes.c_int] * 6 + [
    ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
    ctypes.c_uint64] * 2 + [ctypes.c_void_p]
#: the trigger kinds of ``repro_torch.telemetry.triggers`` as the kernel
#: numbers them (``TRIG_*`` in the source); 0 is no gate
TRIGGER_KINDS = {"tick": 1, "instret": 2, "pc": 3, "inst": 4}
_M64 = (1 << 64) - 1
#: ``run_chunk_fleet_launch``: the image, the fields, budgets and out, the
#: mask, the words a board, lanes, boards, the four knobs and cta_lanes,
#: the stream
FLEET_ARGS = [ctypes.c_void_p] * (3 + len(FIELDS)) + [
    ctypes.c_uint64, ctypes.c_longlong] + [ctypes.c_int] * 7 + [
    ctypes.c_void_p]


def _c(lib, fn, restype, n_ints=3):
    """The C entry ``fn`` of ``n_ints`` int arguments, from ``lib`` or the
    built library."""
    f = getattr(lib or _build.load("run_chunk"), fn)
    f.argtypes = [ctypes.c_int] * n_ints
    f.restype = restype
    return f


def smem_bytes(n_cores, block_words, dtlb_ways, lib=None):
    """Shared memory of one CTA holding ``n_cores`` cores as the kernel
    source counts it (``run_chunk_smem_bytes``): the register files, the
    data TLB and the fetch blocks' slots, and past :data:`WARP_LANES`
    cores the CTA-wide scratch.  Asks the built library, or ``lib``
    (another build of the same source, loaded with ctypes)."""
    return _c(lib, "run_chunk_smem_bytes", ctypes.c_size_t)(
        n_cores, block_words, dtlb_ways)


def cluster_smem_bytes(cta_lanes, block_words, dtlb_ways, lib=None):
    """Shared memory of each CTA of a cluster of ``cta_lanes`` threads a
    CTA (``run_chunk_cluster_smem_bytes``): :func:`smem_bytes`' count at
    ``cta_lanes`` plus the ranks' summary slots."""
    return _c(lib, "run_chunk_cluster_smem_bytes", ctypes.c_size_t)(
        cta_lanes, block_words, dtlb_ways)


_asked: dict = {}


def default_cta_lanes(block_words, dtlb_ways, lib=None):
    """The most whole warps, at most :data:`LANES_MAX`, whose cluster rank
    fits :data:`SMEM_MAX` (``run_chunk_cta_lanes``; 0 if not one warp
    does)."""
    key = ("cta_lanes", block_words, dtlb_ways)
    if lib is None and key in _asked:
        return _asked[key]
    n = _c(lib, "run_chunk_cta_lanes", ctypes.c_int, 2)(block_words,
                                                        dtlb_ways)
    if lib is None:
        _asked[key] = n
    return n


def max_cluster(cta_lanes, block_words, dtlb_ways, lib=None, device=None):
    """The most CTAs of ``cta_lanes`` threads a cluster that ``device``
    schedules (``run_chunk_max_cluster``: the largest of 16
    (:data:`CLUSTER_MAX`), 8, 4 and 2 CTAs for which
    ``cudaOccupancyMaxActiveClusters`` finds room for one cluster, else
    1); asked once a device and knobs.  With
    ``lib`` (a host build of the source) nothing is cached."""
    if lib is None:
        import torch
        device = torch.device("cuda" if device is None else device)
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        key = ("cluster", index, cta_lanes, block_words, dtlb_ways)
        if key not in _asked:
            with torch.cuda.device(index):
                _asked[key] = _ask_max_cluster(cta_lanes, block_words,
                                               dtlb_ways, None)
        return _asked[key]
    return _ask_max_cluster(cta_lanes, block_words, dtlb_ways, lib)


def _ask_max_cluster(cta_lanes, block_words, dtlb_ways, lib):
    most = _c(lib, "run_chunk_max_cluster", ctypes.c_int)(
        cta_lanes, block_words, dtlb_ways)
    if most < 1:
        raise RuntimeError(f"run_chunk: asking the device for its largest "
                           f"cluster failed with CUDA error {-most}")
    return most


def layout(op, n_cores, block_words, dtlb_ways, cta_lanes=None, lib=None,
           device=None):
    """``(cta_lanes, ranks)`` of a board: the cores a CTA and the CTAs of
    its cluster (1: one warp or one CTA).  Raises ``ValueError`` for a
    ``cta_lanes`` the kernel cannot take and past the largest cluster the
    device schedules, naming that limit."""
    default = default_cta_lanes(block_words, dtlb_ways, lib)
    if cta_lanes is None:
        cta_lanes = default
    elif not WARP_LANES <= cta_lanes <= default or cta_lanes % WARP_LANES:
        raise ValueError(
            f"{op}: cta_lanes must be whole warps from {WARP_LANES} up to "
            f"{default}, the most whose cluster rank fits the {SMEM_MAX} "
            f"bytes of shared memory one CTA may hold at block_words "
            f"{block_words} and dtlb_ways {dtlb_ways}; got {cta_lanes}")
    if n_cores <= WARP_LANES or not cta_lanes:
        need = smem_bytes(min(n_cores, LANES_MAX), block_words, dtlb_ways,
                          lib)
        if n_cores > WARP_LANES or need > SMEM_MAX:
            raise ValueError(
                f"{op}: {n_cores} cores with block_words {block_words} and "
                f"dtlb_ways {dtlb_ways} need {need} bytes of shared memory "
                f"in one CTA, over the {SMEM_MAX} one CTA may hold")
        return cta_lanes, 1
    if n_cores <= cta_lanes:
        return cta_lanes, 1
    ranks = -(-n_cores // cta_lanes)
    most = max_cluster(cta_lanes, block_words, dtlb_ways, lib, device)
    if ranks > most:
        raise ValueError(
            f"{op}: {n_cores} cores need a cluster of {ranks} CTAs of "
            f"cta_lanes {cta_lanes} cores, and the device schedules at "
            f"most {most} a cluster: at most {most * cta_lanes} cores a "
            f"board (the eager route, chunk_kernel='ref', runs any width)")
    return cta_lanes, ranks


def check_state(st, n_cores, mem_bytes, block_words, dtlb_ways,
                boards=None):
    """Raise ``ValueError`` unless the kernel takes this state and these
    knobs: at least one core, every field a contiguous tensor of its dtype
    and shape on the image's device, the image ``mem_bytes // 8`` words.
    With ``boards`` the state is a fleet's stack: every shape gains a
    leading axis of ``boards``.  How many cores one launch takes is
    :func:`layout`'s to say."""
    op = "run_chunk" if boards is None else "run_chunk_fleet"
    if n_cores <= 0:
        raise ValueError(f"{op}: the kernel runs one core a thread, at "
                         f"least one{'' if boards is None else ' a board'};"
                         f" got {n_cores}")
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
                block_words, block_cache, dtlb_ways, cta_lanes, stream,
                trace_on=False, trigger=None):
    """The arguments of ``run_chunk_launch`` for this state, in order."""
    kind, disarm, a, b = trigger_args(trigger if trace_on else None)
    return (st.mem.data_ptr(),
            *(getattr(st, name).data_ptr() for name, _, _ in FIELDS),
            out.data_ptr(), (mem_bytes - 1) & _M64,
            int(max_cycles), n_cores, issue_width, block_words,
            int(bool(block_cache)), dtlb_ways, cta_lanes,
            st.tracebuf.data_ptr(),
            st.trace_n.data_ptr(), st.trace_armed.data_ptr(),
            st.tracebuf.shape[1] if st.tracebuf.dim() == 3 else 0,
            int(bool(trace_on)), kind, disarm, a, b, stream)


def run_chunk(st, n_cores, mem_bytes, max_cycles, issue_width=8,
              block_words=16, block_cache=True, dtlb_ways=8,
              trace_on=False, trigger=None, cta_lanes=None) -> int:
    """Advance the CUDA state ``st`` in place by up to ``max_cycles``
    ticks in one launch; returns the substeps issued (a whole
    ``issue_width`` group per predicate test), read back once with the
    launch's round-trip count.  ``trace_on`` launches the traced
    instantiation, which records the commit-trace ring under
    ``trigger``.  A board past ``cta_lanes`` cores (default
    :func:`default_cta_lanes`) runs on a cluster, counted also in
    ``run_chunk.cluster_launches`` (``cluster_trace_launches`` traced)."""
    check_state(st, n_cores, mem_bytes, block_words, dtlb_ways)
    if trace_on:
        check_trace(st, n_cores)
    if not st.mem.is_cuda:
        raise ValueError("run_chunk: the kernel needs a CUDA state; the "
                         "eager loop runs a CPU state")
    if issue_width <= 0:
        raise ValueError(f"run_chunk: issue_width must be positive, got "
                         f"{issue_width}")
    dev = st.mem.device
    cta_lanes, ranks = layout("run_chunk", n_cores, block_words, dtlb_ways,
                              cta_lanes, device=dev)
    out = torch.empty((2,), dtype=torch.int64, device=dev)
    args = launch_args(st, out, n_cores, mem_bytes, max_cycles,
                       issue_width, block_words, block_cache, dtlb_ways,
                       cta_lanes, torch.cuda.current_stream(dev).cuda_stream,
                       trace_on, trigger)
    _build.launch("run_chunk", _build.entry(
        "run_chunk", "run_chunk_launch", _ARGS), args, dev)
    if trace_on:
        run_chunk.trace_launches += 1
        run_chunk.cluster_trace_launches += ranks > 1
    else:
        run_chunk.launches += 1
        run_chunk.cluster_launches += ranks > 1
    substeps, trips = out.tolist()
    run_chunk.trips += trips
    return substeps


def fleet_launch_args(sts, budgets, out, n_cores, mem_bytes, issue_width,
                      block_words, block_cache, dtlb_ways, cta_lanes,
                      stream):
    """The arguments of ``run_chunk_fleet_launch`` for this stack, in
    order (``budgets`` an int64 tensor of one limit a board)."""
    return (sts.mem.data_ptr(),
            *(getattr(sts, name).data_ptr() for name, _, _ in FIELDS),
            budgets.data_ptr(), out.data_ptr(),
            (mem_bytes - 1) & ((1 << 64) - 1), mem_bytes // 8, n_cores,
            sts.pc.shape[0], issue_width, block_words,
            int(bool(block_cache)), dtlb_ways, cta_lanes, stream)


def run_chunk_fleet(sts, n_cores, mem_bytes, budgets, issue_width=8,
                    block_words=16, block_cache=True, dtlb_ways=8,
                    cta_lanes=None) -> list:
    """One global chunk of the fleet ``sts`` (a CUDA stack of D boards) in
    one launch: board ``d`` advances in place by up to ``budgets[d]``
    ticks; a board of budget 0 is untouched.  Returns the substeps issued
    for each board, read back once with the round trips.  Boards past
    ``cta_lanes`` cores run one cluster a board, counted also in
    ``run_chunk_fleet.cluster_launches``."""
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
    dev = sts.mem.device
    cta_lanes, ranks = layout("run_chunk_fleet", n_cores, block_words,
                              dtlb_ways, cta_lanes, device=dev)
    limits = torch.tensor(budgets, dtype=torch.int64).to(dev)
    out = torch.empty((boards, 2), dtype=torch.int64, device=dev)
    args = fleet_launch_args(sts, limits, out, n_cores, mem_bytes,
                             issue_width, block_words, block_cache,
                             dtlb_ways, cta_lanes, _build.current_stream(dev))
    _build.launch("run_chunk_fleet", _build.entry(
        "run_chunk", "run_chunk_fleet_launch", FLEET_ARGS), args, dev)
    run_chunk_fleet.launches += 1
    run_chunk_fleet.cluster_launches += ranks > 1
    got = out.tolist()
    run_chunk_fleet.trips += sum(t for _, t in got)
    return [s for s, _ in got]


#: launches of the CUDA kernel's untraced instantiation since the counter
#: was last set to 0
run_chunk.launches = 0
#: launches of its traced instantiation (``trace_on``) since last set to 0
run_chunk.trace_launches = 0
#: of ``launches`` and of ``trace_launches``, those on a cluster (a board
#: past ``cta_lanes`` cores: the cluster instantiations), since last set
#: to 0
run_chunk.cluster_launches = 0
run_chunk.cluster_trace_launches = 0
#: dependent round trips to global memory on the kernel's critical path
#: (the longest chain of each substep, summed) since last set to 0
run_chunk.trips = 0
#: launches of the fleet kernel (one a global chunk) since last set to 0
run_chunk_fleet.launches = 0
#: of those, the launches on clusters (boards past ``cta_lanes``) since
#: last set to 0
run_chunk_fleet.cluster_launches = 0
#: the boards' dependent round trips, summed, since last set to 0
run_chunk_fleet.trips = 0
