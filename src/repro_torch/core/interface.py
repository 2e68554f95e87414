"""The FASE CPU interface (paper Table I) and its PyTorch implementation.

The paper's target core exposes exactly three signal bundles:

  * ``Priv``   — current privilege level (exception detection),
  * ``Reg``    — handshaked GPR read/write,
  * ``Inject`` — StopFetch + non-branch instruction injection + InjectBusy,

plus an optional ``Interrupt``.  Everything the controller does (Table II)
is a composition of these.  The composition is modelled *behaviourally*:
each HTP execution pattern is applied as a direct state update, while
:mod:`repro_torch.core.session` accounts its cycle/byte cost from the
very same Table II instruction sequences.

:class:`TorchTarget` wraps the PyTorch target model
(:mod:`repro_torch.core.target.cpu`) behind the :class:`Target` protocol.
"""
from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from .target import cpu as _cpu
from .target.u64 import M64


class Target(Protocol):
    """Host-visible surface of a FASE-instrumented target processor."""

    n_cores: int

    # Inst-stream control ------------------------------------------------
    def run(self, max_cycles: int = 1 << 62) -> None: ...
    def redirect(self, c: int, pc: int, resume_tick: int = 0) -> None: ...
    def park(self, c: int) -> None: ...
    def pending_cores(self) -> list[int]: ...
    def clear_pending(self, c: int) -> None: ...
    # Priv / CSR ----------------------------------------------------------
    def csr_read(self, c: int, name: str) -> int: ...
    def csr_write(self, c: int, name: str, v: int) -> None: ...
    def set_satp(self, c: int, v: int) -> None: ...
    def sfence(self, c: int) -> None: ...
    # Reg bundle ----------------------------------------------------------
    def reg_read(self, c: int, idx: int) -> int: ...
    def reg_write(self, c: int, idx: int, v: int) -> None: ...
    # Batched host reads (one device sync for any mix of reads) ------------
    def fetch_batch(self, regs=(), csrs=(), words=()) -> tuple: ...
    # Batched host writes (one device update for a staged transaction) -----
    def commit_batch(self, regs=(), csrs=(), words=()) -> None: ...
    # Word / page data access (via injected ld/sd — behavioural) ----------
    def mem_read_word(self, pa: int) -> int: ...
    def mem_write_word(self, pa: int, v: int) -> None: ...
    def page_read(self, ppn: int) -> np.ndarray: ...
    def page_write(self, ppn: int, words) -> None: ...
    def page_set(self, ppn: int, val: int) -> None: ...
    def page_copy(self, src_ppn: int, dst_ppn: int) -> None: ...
    # Perf ------------------------------------------------------------------
    def get_ticks(self) -> int: ...
    def get_uticks(self, c: int) -> int: ...
    def get_instret(self, c: int) -> int: ...
    # Commit-trace ring ------------------------------------------------------
    def trace_arm(self, slots: int) -> None: ...
    def trace_trigger(self, spec: tuple | None) -> None: ...
    def trace_drain(self, c: int | None = None,
                    limit: int | None = None): ...


class TorchTarget:
    """The PyTorch target ("FPGA") behind the FASE CPU interface.

    State lives in tensors on ``device`` (default ``"cuda"``; a missing
    card raises — pass ``device="cpu"`` to ask for the CPU, as the tests
    do).  ``run`` steps the interpreter
    (:func:`repro_torch.core.target.cpu.run_chunk_fast`): on the card one
    launch of the chunk kernel per call, on the CPU the lane-vectorized
    eager loop; host-side
    accesses are small in-place updates and batched gathers, so the
    memory image is never copied wholesale.  The knobs trade speed,
    never semantics:

      * ``issue_width`` — ticks issued per read-back of the loop predicate,
      * ``block_words`` — fetch-block size in 32-bit slots (power of 2),
      * ``block_cache=False`` — re-walk every instruction fetch,
      * ``chunk_kernel`` — ``"kernel"`` (the CUDA chunk kernel for a
        CUDA image, the eager loop for a CPU image) or ``"ref"`` (the
        eager loop, asked for by name),
      * ``fetch_kernel`` — inside the eager loop, ``"kernel"`` (the CUDA
        ``walk_fetch_block`` for a CUDA image, its plain version for a
        CPU image) or ``"ref"`` (the plain version, asked for by name),
      * ``dtlb_ways`` — per-lane data-translation cache ways (power of
        2; 0 disables and re-walks every load/store).

    The commit-trace ring (``trace_arm`` / ``trace_trigger`` /
    ``trace_drain``) is recorded at the retire point by either route —
    on the card by the traced instantiation of the chunk kernel — and
    drained on the host from a mirror fetched in one transfer per chunk.
    """

    def __init__(self, n_cores: int, mem_bytes: int,
                 chunk_cycles: int = 1 << 30, issue_width: int = 8,
                 block_words: int = 16, block_cache: bool = True,
                 fetch_kernel: str = "kernel", dtlb_ways: int = 8,
                 chunk_kernel: str = "kernel", device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchTarget(device='cuda'): no CUDA device is available; "
                "pass device='cpu' to run the target on the CPU")
        if fetch_kernel not in ("kernel", "ref"):
            raise ValueError("fetch_kernel must be 'kernel' or 'ref', got "
                             f"{fetch_kernel!r}")
        if chunk_kernel not in _cpu.CHUNK_IMPLS:
            raise ValueError(f"chunk_kernel must be one of "
                             f"{_cpu.CHUNK_IMPLS}, got {chunk_kernel!r}")
        if block_words <= 0 or block_words & (block_words - 1):
            raise ValueError(f"block_words must be a power of two, got "
                             f"{block_words}")
        if dtlb_ways < 0 or dtlb_ways & (dtlb_ways - 1):
            raise ValueError(f"dtlb_ways must be a power of two or 0, got "
                             f"{dtlb_ways}")
        if mem_bytes <= 0 or mem_bytes & (mem_bytes - 1):
            raise ValueError(f"mem_bytes must be a power of two, got "
                             f"{mem_bytes}")
        self.nc = n_cores
        self.mem_bytes = mem_bytes
        self.chunk_cycles = chunk_cycles
        self.issue_width = issue_width
        self.block_words = block_words
        self.block_cache = block_cache
        self.fetch_kernel = fetch_kernel
        self.dtlb_ways = dtlb_ways
        self.chunk_kernel = chunk_kernel
        self.substeps = 0            # interpreter substeps issued so far
        self.trace_slots = 0         # commit-trace ring, off by default
        self._trace_base: list = []  # records drained so far, per hart
        self._trigger: tuple | None = None   # capture-window predicate
        #: host copy of the ring (:meth:`_trace_mirror`): the trace_n
        #: tensor and the substep count it was taken at, trace_n as ints,
        #: the ring as a ``(nc, slots, 4)`` uint64 array
        self._trace_host = None
        self.st = _cpu.make_state(n_cores, mem_bytes, device=self.device)

    # -- inst stream ------------------------------------------------------
    @property
    def n_cores(self):
        return self.nc

    def run(self, max_cycles: int = 1 << 62):
        budget = min(max_cycles, self.chunk_cycles)
        trace_on = self.trace_slots > 0
        self.substeps += _cpu.run_chunk_fast(
            self.st, self.nc, self.mem_bytes, budget, self.issue_width,
            self.block_words, self.block_cache, self.fetch_kernel,
            trace_on, self._trigger if trace_on else None,
            dtlb_ways=self.dtlb_ways, chunk_kernel=self.chunk_kernel)

    def redirect(self, c, pc, resume_tick=0):
        _cpu.redirect_op(self.st, c, pc, max(resume_tick, 0))

    def park(self, c):
        _cpu.park_op(self.st, c)

    def pending_cores(self):
        return [c for c, p in enumerate(self.st.pending.tolist()) if p]

    def clear_pending(self, c):
        _cpu.clear_pending_op(self.st, c)

    # -- priv / csr ---------------------------------------------------------
    def csr_read(self, c, name):
        return self.fetch_batch(csrs=[(c, name)])[1][0]

    def get_priv(self, c):
        return int(self.st.priv[c])

    def csr_write(self, c, name, v):
        """Host-side CSR/core-state write (CsrW's device half).  Each
        field keeps its device dtype; ``ticks`` is the global clock."""
        _cpu.csr_write_op(self.st, name, c, v & M64)

    def set_satp(self, c, v):
        _cpu.csr_write_op(self.st, "satp", c, v)

    def sfence(self, c):
        # nothing is cached across chunks: the fetch-block cache and the
        # data-translation cache both live only inside one run_chunk_fast
        # call, so any host-driven PTE change is visible by construction
        pass

    # -- regs -----------------------------------------------------------------
    def reg_read(self, c, idx):
        return self.fetch_batch(regs=[(c, idx)])[0][0]

    def fetch_batch(self, regs=(), csrs=(), words=()):
        """Batched host reads: ONE device->host transfer for any mix of
        GPRs (``(core, idx)`` pairs), CSR/core-state fields
        (``(core, name)`` pairs) and physical words (byte addresses).
        Returns three int lists in input order, value-identical to the
        per-element accessors."""
        return _cpu.fetch_read_batch(self.st, regs, csrs, words)

    def reg_write(self, c, idx, v):
        if idx != 0:
            _cpu.reg_write_op(self.st, c, idx, v & M64)

    def commit_batch(self, regs=(), csrs=(), words=()):
        """Batched host writes: ONE batched device update for any mix of
        GPRs (``(core, idx, val)``), CSR/core-state fields
        (``(core, name, val)``) and physical memory words
        (``(word_index, val)``).  Callers guarantee unique indices per
        kind, 64-bit-masked values, and that ``x0``/``ticks`` never
        appear.  Value-identical to replaying the per-element accessors
        in order."""
        _cpu.apply_write_batch(self.st, regs, csrs, words)

    # -- memory ---------------------------------------------------------------
    def mem_read_word(self, pa):
        return self.fetch_batch(words=[pa])[2][0]

    def mem_write_word(self, pa, v):
        _cpu.mem_write_words(self.st, [pa >> 3], [v])

    def page_read(self, ppn):
        """A host copy of the page (numpy ``uint64``, 512 words); it does
        not alias device state."""
        return _cpu.page_read_words(self.st, (ppn << 12) >> 3)

    def page_write(self, ppn, words):
        w = np.ascontiguousarray(words, dtype=np.uint64)
        _cpu.page_write_words(self.st, (ppn << 12) >> 3,
                              torch.from_numpy(w.view(np.int64)))

    def page_set(self, ppn, val):
        _cpu.page_set_words(self.st, (ppn << 12) >> 3, val)

    def page_copy(self, src_ppn, dst_ppn):
        _cpu.page_copy_words(self.st, (src_ppn << 12) >> 3,
                             (dst_ppn << 12) >> 3)

    # -- perf --------------------------------------------------------------
    def get_ticks(self):
        return int(self.st.ticks) & M64

    def get_uticks(self, c):
        return int(self.st.uticks[c]) & M64

    def get_instret(self, c):
        return int(self.st.instret[c]) & M64

    # -- telemetry: commit-trace ring (repro_torch.telemetry) ----------------
    def trace_arm(self, slots):
        """Arm per-core commit-trace capture: a fresh ``(nc, slots, 4)``
        ring on the state's device, ``trace_n`` and ``trace_armed`` at
        0, so the next ``run`` records every retirement (on the card
        through the kernel's traced instantiation)."""
        if slots <= 0:
            raise ValueError(f"trace_arm: slots must be positive, got "
                             f"{slots}")
        self.trace_slots = slots
        dev = self.st.device
        self.st.tracebuf = torch.zeros((self.nc, slots, 4),
                                       dtype=torch.int64, device=dev)
        self.st.trace_n = torch.zeros((self.nc,), dtype=torch.int64,
                                      device=dev)
        self.st.trace_armed = torch.zeros((self.nc,), dtype=torch.bool,
                                          device=dev)
        self._trace_base = [0] * self.nc
        self._trace_host = None

    def trace_trigger(self, spec):
        """Install (or clear, ``None``) the capture-window predicate — a
        trigger spec tuple (:mod:`repro_torch.telemetry.triggers`) that
        gates which retirements enter the ring, never the step.
        Arm/disarm state rewinds to disarmed."""
        self._trigger = None if spec is None else tuple(spec)
        self.st.trace_armed = torch.zeros_like(self.st.trace_armed)

    def trace_drain(self, c=None, limit=None):
        """Drain commit-trace rings, mirroring
        :meth:`repro_torch.core.target.pysim.PySim.trace_drain` bit for
        bit: ``(records, ring_dropped)`` per hart (a list over the harts
        for ``c=None``).  ``limit`` caps the records taken per hart: the
        rest stay in the ring (a stalled bridge leaves records behind,
        and later overwrites surface as ``ring_dropped``).  Drops are
        derived from the monotone ``trace_n``.  Every drain between two
        chunks is served from one host copy of ``trace_n`` and the ring,
        fetched in one transfer at the first drain after a chunk."""
        if self.trace_slots == 0:     # unarmed: nothing to drain
            return ([], 0) if c is not None else [([], 0)] * self.nc
        totals, ring = self._trace_mirror()
        if c is None:
            return [self._drain_host(ring[i], totals[i], i, limit)
                    for i in range(self.nc)]
        return self._drain_host(ring[c], totals[c], c, limit)

    def _trace_mirror(self):
        """``trace_n`` (ints) and the ring (a ``(nc, slots, 4)`` uint64
        array) as of the last chunk, fetched at most once a chunk, in one
        transfer of ``trace_n`` and the whole ring."""
        st = self.st
        h = self._trace_host
        if h is not None and h["n"] is st.trace_n and \
                h["substeps"] == self.substeps:
            return h["totals"], h["ring"]
        nc = self.nc
        flat = torch.cat([st.trace_n, st.tracebuf.reshape(-1)]) \
            .cpu().numpy().view(np.uint64)
        totals = flat[:nc].tolist()
        ring = flat[nc:].reshape(nc, self.trace_slots, 4)
        self._trace_host = dict(n=st.trace_n, substeps=self.substeps,
                                totals=totals, ring=ring)
        return totals, ring

    def _drain_host(self, ring, total, c, limit=None):
        slots = self.trace_slots
        base = self._trace_base[c]
        n_new = total - base
        dropped = max(0, n_new - slots)
        avail_start = base + dropped      # oldest record still in the ring
        take = total - avail_start
        if limit is not None:
            take = min(take, limit)
        rows = np.arange(avail_start, avail_start + take) % slots
        recs = list(zip(*ring[rows].T.tolist()))
        self._trace_base[c] = avail_start + take
        return recs, dropped
