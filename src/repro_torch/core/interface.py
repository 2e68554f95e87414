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

_TRACE_MSG = "the commit-trace ring is not ported to repro_torch yet"


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
    do).  ``run`` steps the lane-vectorized interpreter
    (:func:`repro_torch.core.target.cpu.run_chunk_fast`); host-side
    accesses are small in-place updates and batched gathers, so the
    memory image is never copied wholesale.  The knobs trade speed,
    never semantics:

      * ``issue_width`` — ticks issued per read-back of the loop predicate,
      * ``block_words`` — fetch-block size in 32-bit slots (power of 2),
      * ``block_cache=False`` — re-walk every instruction fetch,
      * ``fetch_kernel`` — ``"kernel"`` (the CUDA ``walk_fetch_block``
        for a CUDA image, its plain version for a CPU image) or ``"ref"``
        (the plain version, asked for by name),
      * ``dtlb_ways`` — per-lane data-translation cache ways (power of
        2; 0 disables and re-walks every load/store).
    """

    def __init__(self, n_cores: int, mem_bytes: int,
                 chunk_cycles: int = 1 << 30, issue_width: int = 8,
                 block_words: int = 16, block_cache: bool = True,
                 fetch_kernel: str = "kernel", dtlb_ways: int = 8,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchTarget(device='cuda'): no CUDA device is available; "
                "pass device='cpu' to run the target on the CPU")
        if fetch_kernel not in ("kernel", "ref"):
            raise ValueError("fetch_kernel must be 'kernel' or 'ref', got "
                             f"{fetch_kernel!r}")
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
        self.substeps = 0            # interpreter substeps issued so far
        self.st = _cpu.make_state(n_cores, mem_bytes, device=self.device)

    # -- inst stream ------------------------------------------------------
    @property
    def n_cores(self):
        return self.nc

    def run(self, max_cycles: int = 1 << 62):
        budget = min(max_cycles, self.chunk_cycles)
        self.substeps += _cpu.run_chunk_fast(
            self.st, self.nc, self.mem_bytes, budget, self.issue_width,
            self.block_words, self.block_cache, self.fetch_kernel,
            dtlb_ways=self.dtlb_ways)

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

    # -- commit-trace ring: waits for the telemetry slice ---------------------
    def trace_arm(self, slots):
        raise NotImplementedError(_TRACE_MSG)

    def trace_trigger(self, spec):
        raise NotImplementedError(_TRACE_MSG)

    def trace_drain(self, c=None, limit=None):
        raise NotImplementedError(_TRACE_MSG)
