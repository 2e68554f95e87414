"""Pure-Python twin of the tensor target (:mod:`repro_torch.core.target.cpu`).

The port's own copy of the reference's ``repro.core.target.pysim`` (the
port imports nothing of the reference package): the oracle of commit-trace
replay (:mod:`repro_torch.telemetry.replay`).

Implements the same RV64IMA multicore model behind the same host-visible
interface as :class:`repro_torch.core.interface.TorchTarget`: 1-IPC
in-order cores stepped in core-index order every global tick, Sv39
translation with page-fault exceptions delivered through
``pending``/``mcause``/``mepc``/``mtval``, LR/SC reservations with
cross-core invalidation, and the ``stall_until`` throttle the FASE
channel model drives.

The two implementations must stay bit-identical — that is enforced by
``tests/test_torch_cpu_differential.py`` and, against the reference's
PySim, ``tests/test_torch_pysim.py``.  Keep any semantic change mirrored
in :mod:`repro_torch.core.target.cpu`.
"""
from __future__ import annotations

from struct import pack_into, unpack_from

import numpy as np

from . import isa

CLOCK_HZ = 100_000_000

MASK64 = (1 << 64) - 1
_ACC_LOAD, _ACC_STORE, _ACC_FETCH = 0, 1, 2
_PF_CAUSE = {_ACC_LOAD: 13, _ACC_STORE: 15, _ACC_FETCH: 12}
_MA_CAUSE = {_ACC_LOAD: 4, _ACC_STORE: 6}
_ACC_PTE = {_ACC_LOAD: isa.PTE_R, _ACC_STORE: isa.PTE_W,
            _ACC_FETCH: isa.PTE_X}


class _Trap(Exception):
    def __init__(self, cause, tval):
        self.cause = cause
        self.tval = tval


def _s64(x: int) -> int:
    return x - (1 << 64) if x >> 63 else x


def _s32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >> 31 else x


def _sx32(x: int) -> int:
    """Sign-extend the low 32 bits of x into a u64."""
    return _s32(x) & MASK64


def _decode(inst: int):
    op = inst & 0x7F
    rd = (inst >> 7) & 0x1F
    f3 = (inst >> 12) & 7
    rs1 = (inst >> 15) & 0x1F
    rs2 = (inst >> 20) & 0x1F
    f7 = inst >> 25
    imm_i = (inst >> 20) - ((inst >> 19) & 0x1000)
    imm_s = (((inst >> 25) << 5) | rd) - ((inst >> 19) & 0x1000)
    b = (((inst >> 8) & 0xF) << 1) | (((inst >> 25) & 0x3F) << 5) | \
        (((inst >> 7) & 1) << 11) | ((inst >> 31) << 12)
    imm_b = b - ((inst >> 18) & 0x2000)
    j = (((inst >> 21) & 0x3FF) << 1) | (((inst >> 20) & 1) << 11) | \
        (((inst >> 12) & 0xFF) << 12) | ((inst >> 31) << 20)
    imm_j = j - ((inst >> 10) & 0x200000)
    return (op, rd, f3, rs1, rs2, f7, imm_i, imm_s, imm_b,
            inst & 0xFFFFF000, imm_j)


_DECODE_CACHE: dict = {}


class PySim:
    """Pure-Python FASE target (same interface as ``TorchTarget``)."""

    def __init__(self, n_cores: int, mem_bytes: int,
                 chunk_cycles: int = 1 << 62):
        assert mem_bytes & (mem_bytes - 1) == 0, "mem_bytes must be pow2"
        self.nc = n_cores
        self.mem_bytes = mem_bytes
        self.chunk_cycles = chunk_cycles
        self.mask = mem_bytes - 1
        self.mem = bytearray(mem_bytes)
        n = n_cores
        self.regs = [[0] * 32 for _ in range(n)]
        self.pc = [0] * n
        self.priv = [3] * n           # 3 = parked, 0 = user
        self.pending = [False] * n
        self.stall_until = [0] * n
        self.satp = [0] * n
        self.mcause = [0] * n
        self.mepc = [0] * n
        self.mtval = [0] * n
        self.res = [-1] * n           # LR reservation (pa), -1 = invalid
        self.ticks = 0
        self.uticks = [0] * n
        self.instret = [0] * n
        # Telemetry counters (repro_torch.telemetry).  stall_ticks is
        # architectural (mirrored bit-for-bit by the tensor target);
        # tlb_walks is this backend's model counter (the tensor target
        # counts the walks of its own data-TLB, a different model);
        # fetch_hits/fetch_walks are the tensor target's fetch-block-cache
        # model counters and stay 0 here.
        self.stall_ticks = [0] * n
        self.fetch_hits = [0] * n
        self.fetch_walks = [0] * n
        self.tlb_walks = [0] * n
        # Commit-trace ring (armed via trace_arm): per-core fixed-size
        # ring of (tick, pc, inst, priv) retirement records plus the
        # monotone produced-count the host derives overflow drops from.
        self.trace_slots = 0
        self.tracebuf = [[] for _ in range(n)]
        self.trace_n = [0] * n
        self._trace_base = [0] * n
        # Capture-window trigger (trace_trigger): spec tuple + per-core
        # sticky arm state, mirroring the tensor target's trace path bit
        # for bit.
        self._trigger = None
        self.trace_armed = [False] * n
        # Two-level host-side translation cache (pure speed, no modelled
        # cost; the tensor target's caches are chunk-local, so nothing to
        # mirror).  L1 is per-core and dropped on set_satp — i.e. every
        # context switch; the shared L2 is keyed by (satp, vpn) so hot
        # pages survive context switches without re-walking.  Any sfence
        # (a real PTE change) conservatively drops the whole L2, keeping
        # the existing delayed-shootdown semantics: only per-core L1
        # entries may serve stale until that core's owed flush, exactly
        # as the old per-core dicts did.
        self.tlb = [dict() for _ in range(n)]
        self.stlb: dict = {}          # (satp, vpn) -> (ppn, perms)

    # ------------------------------------------------------------------
    @property
    def n_cores(self):
        return self.nc

    # -- inst stream ----------------------------------------------------
    def run(self, max_cycles: int = 1 << 62):
        limit = min(max_cycles, self.chunk_cycles)
        nc = self.nc
        priv, pending, stall = self.priv, self.pending, self.stall_until
        cycles = 0
        while cycles < limit:
            if True in pending:
                break
            active = [c for c in range(nc) if priv[c] != 3]
            if not active:
                break
            now = self.ticks
            ran = 0
            for c in active:
                if stall[c] <= now:
                    self._step(c)
                    ran += 1
            if ran:
                if ran != len(active):
                    # active-but-stalled cores accrue one stall tick
                    st_t = self.stall_ticks
                    for c in active:
                        if stall[c] > now:
                            st_t[c] += 1
                self.ticks = now + 1
                cycles += 1
            else:
                # every live core is stalled: fast-forward to the next
                # wake-up (nothing can change state in between); the gap
                # is the minimum remaining stall, so every active core
                # accrues all of it
                gap = min(stall[c] for c in active) - now
                gap = min(gap, limit - cycles)
                for c in active:
                    self.stall_ticks[c] += gap
                self.ticks = now + gap
                cycles += gap

    def redirect(self, c, pc, resume_tick=0):
        self.pc[c] = pc & MASK64
        self.priv[c] = 0
        self.pending[c] = False
        self.stall_until[c] = max(resume_tick, 0)

    def park(self, c):
        self.priv[c] = 3
        self.pending[c] = False

    def pending_cores(self):
        return [c for c in range(self.nc) if self.pending[c]]

    def clear_pending(self, c):
        self.pending[c] = False

    # -- priv / csr -----------------------------------------------------
    def csr_read(self, c, name):
        return getattr(self, name)[c]

    def csr_write(self, c, name, v):
        """Host-side CSR/core-state write (the CsrW request's device
        half; snapshot restore).  ``ticks`` addresses the global clock;
        ``pending``/``priv`` keep their native representations.  A satp
        write through here does NOT flush translation caches — restore
        batches end with explicit FlushTLB requests, like any other
        host-driven PTE change."""
        if name == "ticks":
            self.ticks = v & MASK64
        elif name == "pending":
            self.pending[c] = bool(v)
        elif name == "priv":
            self.priv[c] = int(v)
        else:
            getattr(self, name)[c] = v & MASK64

    def get_priv(self, c):
        return self.priv[c]

    def set_satp(self, c, v):
        self.satp[c] = v & MASK64
        self.tlb[c].clear()           # L2 keyed by satp stays valid

    def sfence(self, c):
        self.tlb[c].clear()
        self.stlb.clear()             # PTEs changed: drop the shared map

    # -- regs -----------------------------------------------------------
    def reg_read(self, c, idx):
        return self.regs[c][idx]

    def fetch_batch(self, regs=(), csrs=(), words=()):
        """Batched host reads, mirroring
        :meth:`repro_torch.core.interface.TorchTarget.fetch_batch` (same values
        as the per-element accessors); pure-Python state makes it a
        plain gather."""
        return ([self.reg_read(c, i) for c, i in regs],
                [self.csr_read(c, n) for c, n in csrs],
                [self.mem_read_word(pa) for pa in words])

    def reg_write(self, c, idx, v):
        if idx != 0:
            self.regs[c][idx] = v & MASK64

    def commit_batch(self, regs=(), csrs=(), words=()):
        """Batched host writes, mirroring
        :meth:`repro_torch.core.interface.TorchTarget.commit_batch`: GPRs as
        ``(core, idx, val)``, CSR/core-state as ``(core, name, val)``,
        memory words as ``(word_index, val)``.  Pure-Python state makes
        it a plain replay of the per-element accessors in order."""
        for c, idx, v in regs:
            self.reg_write(c, idx, v)
        for c, name, v in csrs:
            self.csr_write(c, name, v)
        for w, v in words:
            self.mem_write_word(w << 3, v)

    # -- memory (host-side word/page access) ----------------------------
    def mem_read_word(self, pa):
        return unpack_from("<Q", self.mem, pa & self.mask & ~7)[0]

    def mem_write_word(self, pa, v):
        pack_into("<Q", self.mem, pa & self.mask & ~7, v & MASK64)

    def page_read(self, ppn):
        off = (ppn << 12) & self.mask
        return np.frombuffer(bytes(self.mem[off:off + 4096]),
                             dtype=np.uint64)

    def page_write(self, ppn, words):
        off = (ppn << 12) & self.mask
        self.mem[off:off + 4096] = \
            np.ascontiguousarray(words, dtype=np.uint64).tobytes()

    def page_set(self, ppn, val):
        off = (ppn << 12) & self.mask
        self.mem[off:off + 4096] = \
            (int(val) & MASK64).to_bytes(8, "little") * 512

    def page_copy(self, src_ppn, dst_ppn):
        s = (src_ppn << 12) & self.mask
        d = (dst_ppn << 12) & self.mask
        self.mem[d:d + 4096] = self.mem[s:s + 4096]

    # -- perf -----------------------------------------------------------
    def get_ticks(self):
        return self.ticks

    def get_uticks(self, c):
        return self.uticks[c]

    def get_instret(self, c):
        return self.instret[c]

    # -- telemetry: commit-trace ring (repro_torch.telemetry) ------------
    def trace_arm(self, slots: int):
        """Arm per-core commit-trace capture with a ``slots``-record
        ring per hart (resets any previous capture)."""
        assert slots > 0
        self.trace_slots = slots
        self.tracebuf = [[None] * slots for _ in range(self.nc)]
        self.trace_n = [0] * self.nc
        self._trace_base = [0] * self.nc
        self.trace_armed = [False] * self.nc

    def trace_trigger(self, spec):
        """Install (or clear) the capture-window predicate — a trigger
        spec tuple (see :mod:`repro_torch.telemetry.triggers`) evaluated
        at the retire point, the semantic twin of the tensor target's
        trace-path predicate.  Arm/disarm state rewinds to disarmed."""
        self._trigger = spec
        self.trace_armed = [False] * self.nc

    def trace_drain(self, c=None, limit=None):
        """Drain one hart's ring (``c=None``: every hart, bundled):
        returns ``(records, ring_dropped)`` — the surviving
        ``(tick, pc, inst, priv)`` records since the previous drain in
        commit order, and how many older records the ring overwrote.
        ``limit`` caps the records taken: the rest stay in the ring
        (a stalled streaming bridge leaves them behind; overwrites show
        up as ``ring_dropped`` on a later drain)."""
        if c is None:
            return [self.trace_drain(i, limit) for i in range(self.nc)]
        total = self.trace_n[c]
        base = self._trace_base[c]
        n_new = total - base
        dropped = max(0, n_new - self.trace_slots)
        avail_start = base + dropped    # oldest record still in the ring
        take = total - avail_start
        if limit is not None:
            take = min(take, limit)
        ring = self.tracebuf[c]
        recs = [ring[i % self.trace_slots]
                for i in range(avail_start, avail_start + take)]
        self._trace_base[c] = avail_start + take
        return recs, dropped

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _translate(self, c, va, acc) -> int:
        satp = self.satp[c]
        if satp >> 60 != 8:
            return va & self.mask
        vpn = va >> 12
        hit = self.tlb[c].get(vpn)
        if hit is not None and hit[1] & _ACC_PTE[acc]:
            return (hit[0] << 12 | (va & 0xFFF)) & self.mask
        # shared second-level map: refill the per-core L1 without a walk
        hit = self.stlb.get((satp, vpn))
        if hit is not None and hit[1] & _ACC_PTE[acc]:
            self.tlb[c][vpn] = hit
            return (hit[0] << 12 | (va & 0xFFF)) & self.mask
        self.tlb_walks[c] += 1        # both cache levels missed: real walk
        a = (satp & ((1 << 44) - 1)) << 12
        for level in (2, 1, 0):
            idx = (va >> (12 + 9 * level)) & 0x1FF
            pte = unpack_from("<Q", self.mem, (a + idx * 8) & self.mask)[0]
            if not pte & isa.PTE_V:
                raise _Trap(_PF_CAUSE[acc], va)
            if pte & (isa.PTE_R | isa.PTE_X):
                need = _ACC_PTE[acc] | isa.PTE_U
                if (pte & need) != need:
                    raise _Trap(_PF_CAUSE[acc], va)
                off_mask = (1 << (12 + 9 * level)) - 1
                pa = (((pte >> 10) << 12) | (va & off_mask)) & self.mask
                if level == 0:
                    entry = (pa >> 12, pte & 0xFF)
                    self.tlb[c][vpn] = entry
                    self.stlb[(satp, vpn)] = entry
                return pa
            a = (pte >> 10) << 12
        raise _Trap(_PF_CAUSE[acc], va)

    def _load(self, c, va, size, acc=_ACC_LOAD) -> int:
        if va & (size - 1):
            raise _Trap(_MA_CAUSE[acc], va)
        pa = self._translate(c, va & MASK64, acc)
        if size == 8:
            return unpack_from("<Q", self.mem, pa)[0]
        if size == 4:
            return unpack_from("<I", self.mem, pa)[0]
        if size == 2:
            return unpack_from("<H", self.mem, pa)[0]
        return self.mem[pa]

    def _store(self, c, va, size, val):
        if va & (size - 1):
            raise _Trap(6, va)
        pa = self._translate(c, va & MASK64, _ACC_STORE)
        if size == 8:
            pack_into("<Q", self.mem, pa, val & MASK64)
        elif size == 4:
            pack_into("<I", self.mem, pa, val & 0xFFFFFFFF)
        elif size == 2:
            pack_into("<H", self.mem, pa, val & 0xFFFF)
        else:
            self.mem[pa] = val & 0xFF
        # cross-core reservation invalidation (8-byte granularity)
        line = pa & ~7
        for o in range(self.nc):
            if o != c and self.res[o] != -1 and self.res[o] & ~7 == line:
                self.res[o] = -1

    def _trap(self, c, cause, pc, tval):
        self.pending[c] = True
        self.mcause[c] = cause
        self.mepc[c] = pc & MASK64
        self.mtval[c] = tval & MASK64

    def _step(self, c):
        pc = self.pc[c]
        regs = self.regs[c]
        try:
            ipa = self._translate(c, pc, _ACC_FETCH)
            inst = unpack_from("<I", self.mem, ipa & ~3)[0]
            dec = _DECODE_CACHE.get(inst)
            if dec is None:
                dec = _DECODE_CACHE.setdefault(inst, _decode(inst))
            (op, rd, f3, rs1, rs2, f7, imm_i, imm_s, imm_b, imm_u,
             imm_j) = dec
            a = regs[rs1]
            b = regs[rs2]
            next_pc = (pc + 4) & MASK64
            wval = None

            if op == 0x13:                                   # OP-IMM
                wval = self._alu(f3, f7, a, imm_i & MASK64, False,
                                 imm=True)
            elif op == 0x33:                                 # OP
                wval = self._alu(f3, f7, a, b, f7 == 1)
            elif op == 0x03:                                 # LOAD
                va = (a + imm_i) & MASK64
                if f3 == 0:
                    wval = _s64(0) | self._load(c, va, 1)
                    wval = (wval - (1 << 8) if wval >> 7 else wval) & MASK64
                elif f3 == 1:
                    v = self._load(c, va, 2)
                    wval = (v - (1 << 16) if v >> 15 else v) & MASK64
                elif f3 == 2:
                    wval = _sx32(self._load(c, va, 4))
                elif f3 == 3:
                    wval = self._load(c, va, 8)
                elif f3 == 4:
                    wval = self._load(c, va, 1)
                elif f3 == 5:
                    wval = self._load(c, va, 2)
                elif f3 == 6:
                    wval = self._load(c, va, 4)
                else:
                    raise _Trap(2, inst)
            elif op == 0x23:                                 # STORE
                va = (a + imm_s) & MASK64
                if f3 > 3:
                    raise _Trap(2, inst)
                self._store(c, va, 1 << f3, b)
            elif op == 0x63:                                 # BRANCH
                if f3 == 0:
                    t = a == b
                elif f3 == 1:
                    t = a != b
                elif f3 == 4:
                    t = _s64(a) < _s64(b)
                elif f3 == 5:
                    t = _s64(a) >= _s64(b)
                elif f3 == 6:
                    t = a < b
                elif f3 == 7:
                    t = a >= b
                else:
                    raise _Trap(2, inst)
                if t:
                    next_pc = (pc + imm_b) & MASK64
            elif op == 0x6F:                                 # JAL
                wval = (pc + 4) & MASK64
                next_pc = (pc + imm_j) & MASK64
            elif op == 0x67:                                 # JALR
                wval = (pc + 4) & MASK64
                next_pc = (a + imm_i) & MASK64 & ~1
            elif op == 0x37:                                 # LUI
                wval = imm_u if imm_u < (1 << 31) else \
                    imm_u | 0xFFFFFFFF00000000
            elif op == 0x17:                                 # AUIPC
                u = imm_u if imm_u < (1 << 31) else \
                    imm_u | 0xFFFFFFFF00000000
                wval = (pc + u) & MASK64
            elif op == 0x1B:                                 # OP-IMM-32
                wval = self._alu32(f3, f7, a, imm_i & MASK64, False,
                                   imm=True)
            elif op == 0x3B:                                 # OP-32
                wval = self._alu32(f3, f7, a, b, f7 == 1)
            elif op == 0x2F:                                 # AMO
                wval = self._amo(c, f3, f7 >> 2, a, b)
            elif op == 0x0F:                                 # FENCE
                pass
            elif op == 0x73:                                 # SYSTEM
                if inst == isa.INST_ECALL:
                    raise _Trap(8, 0)
                if inst == isa.INST_EBREAK:
                    raise _Trap(3, 0)
                raise _Trap(2, inst)
            else:
                raise _Trap(2, inst)

            if wval is not None and rd != 0:
                regs[rd] = wval & MASK64
            self.pc[c] = next_pc
            self.instret[c] += 1
            self.uticks[c] += 1
            if self.trace_slots and self._trace_capture(c, pc, inst):
                # commit-trace record: mirrors the tensor target's ring bit
                # for bit (tick at retirement, pre-exec pc, raw instruction,
                # privilege)
                self.tracebuf[c][self.trace_n[c] % self.trace_slots] = \
                    (self.ticks, pc, inst, self.priv[c])
                self.trace_n[c] += 1
        except _Trap as t:
            self._trap(c, t.cause, pc, t.tval)

    def _trace_capture(self, c, pc, inst) -> bool:
        """Capture-window gate at the retire point — the semantic twin
        of the tensor target's trace path's trigger predicate.  ``pc`` is
        the pre-exec pc and ``inst`` the raw word of the retirement
        being considered; sticky arm/disarm state lives in
        ``trace_armed``."""
        t = self._trigger
        if t is None:
            return True
        kind = t[0]
        if kind == "tick":
            return t[1] <= self.ticks < t[2]
        if kind == "instret":
            # instret was incremented above; the gate compares the
            # pre-retirement count, exactly as the tensor target does
            return self.instret[c] > t[1]
        val = pc if kind == "pc" else inst
        armed = self.trace_armed[c] or val == t[1]
        self.trace_armed[c] = armed and not (
            t[2] is not None and val == t[2])
        return armed

    # -- ALU -------------------------------------------------------------
    def _alu(self, f3, f7, a, b, mext, imm=False):
        if mext:
            sa, sb = _s64(a), _s64(b)
            if f3 == 0:
                return (a * b) & MASK64
            if f3 == 1:
                return ((sa * sb) >> 64) & MASK64
            if f3 == 2:
                return ((sa * b) >> 64) & MASK64
            if f3 == 3:
                return ((a * b) >> 64) & MASK64
            if f3 == 4:
                if b == 0:
                    return MASK64
                q = abs(sa) // abs(sb)
                return (-q if (sa < 0) != (sb < 0) else q) & MASK64
            if f3 == 5:
                return MASK64 if b == 0 else a // b
            if f3 == 6:
                if b == 0:
                    return a
                q = abs(sa) // abs(sb)
                q = -q if (sa < 0) != (sb < 0) else q
                return (sa - q * sb) & MASK64
            if f3 == 7:
                return a if b == 0 else a % b
        if f3 == 0:
            if not imm and f7 == 0x20:
                return (a - b) & MASK64
            return (a + b) & MASK64
        if f3 == 1:
            return (a << (b & 63)) & MASK64
        if f3 == 2:
            return 1 if _s64(a) < _s64(b) else 0
        if f3 == 3:
            return 1 if a < b else 0
        if f3 == 4:
            return a ^ b
        if f3 == 5:
            if (imm and b & 0x400) or (not imm and f7 == 0x20):
                return (_s64(a) >> (b & 63)) & MASK64
            return a >> (b & 63)
        if f3 == 6:
            return a | b
        return a & b

    def _alu32(self, f3, f7, a, b, mext, imm=False):
        a32, b32 = _s32(a), _s32(b)
        if mext:
            if f3 == 0:
                return _sx32(a32 * b32)
            if f3 == 4:
                if b32 == 0:
                    return MASK64
                if a32 == -(1 << 31) and b32 == -1:
                    return _sx32(a32)
                q = abs(a32) // abs(b32)
                return _sx32(-q if (a32 < 0) != (b32 < 0) else q)
            if f3 == 5:
                au, bu = a & 0xFFFFFFFF, b & 0xFFFFFFFF
                return MASK64 if bu == 0 else _sx32(au // bu)
            if f3 == 6:
                if b32 == 0:
                    return _sx32(a32)
                if a32 == -(1 << 31) and b32 == -1:
                    return 0
                q = abs(a32) // abs(b32)
                q = -q if (a32 < 0) != (b32 < 0) else q
                return _sx32(a32 - q * b32)
            if f3 == 7:
                au, bu = a & 0xFFFFFFFF, b & 0xFFFFFFFF
                return _sx32(au) if bu == 0 else _sx32(au % bu)
            raise _Trap(2, 0)
        if f3 == 0:
            if not imm and f7 == 0x20:
                return _sx32(a32 - b32)
            return _sx32(a32 + b32)
        if f3 == 1:
            return _sx32((a & 0xFFFFFFFF) << (b & 31))
        if f3 == 5:
            if (imm and b & 0x400) or (not imm and f7 == 0x20):
                return _sx32(a32 >> (b & 31))
            return _sx32((a & 0xFFFFFFFF) >> (b & 31))
        raise _Trap(2, 0)

    # -- A extension -----------------------------------------------------
    def _amo(self, c, f3, funct5, a, b):
        if f3 == 2:
            size, sext = 4, True
        elif f3 == 3:
            size, sext = 8, False
        else:
            raise _Trap(2, 0)
        va = a & MASK64
        if funct5 == isa.AMO_LR:
            if va & (size - 1):
                raise _Trap(4, va)
            pa = self._translate(c, va, _ACC_LOAD)
            v = self._load_pa(pa, size)
            self.res[c] = pa
            return _sx32(v) if sext else v
        if funct5 == isa.AMO_SC:
            if va & (size - 1):
                raise _Trap(6, va)
            pa = self._translate(c, va, _ACC_STORE)
            ok = self.res[c] == pa
            self.res[c] = -1
            if ok:
                self._store(c, va, size, b)
            return 0 if ok else 1
        if va & (size - 1):
            raise _Trap(6, va)
        pa = self._translate(c, va, _ACC_STORE)
        old = self._load_pa(pa, size)
        if sext:
            olds, bs = _s32(old), _s32(b)
            bv = b & 0xFFFFFFFF
        else:
            olds, bs = _s64(old), _s64(b)
            bv = b
        if funct5 == isa.AMO_SWAP:
            new = bv
        elif funct5 == isa.AMO_ADD:
            new = old + bv
        elif funct5 == isa.AMO_XOR:
            new = old ^ bv
        elif funct5 == isa.AMO_AND:
            new = old & bv
        elif funct5 == isa.AMO_OR:
            new = old | bv
        elif funct5 == isa.AMO_MIN:
            new = old if olds < bs else bv
        elif funct5 == isa.AMO_MAX:
            new = old if olds > bs else bv
        elif funct5 == isa.AMO_MINU:
            new = old if old < bv else bv
        elif funct5 == isa.AMO_MAXU:
            new = old if old > bv else bv
        else:
            raise _Trap(2, 0)
        self._store(c, va, size, new)
        return _sx32(old) if sext else old

    def _load_pa(self, pa, size):
        if size == 8:
            return unpack_from("<Q", self.mem, pa)[0]
        return unpack_from("<I", self.mem, pa)[0]
