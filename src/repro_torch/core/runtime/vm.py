"""Virtual memory management (paper §V-C).

Dual software/hardware page tables: the runtime keeps a complete software
view of every mapping (segments, software PTEs, refcounted physical pages,
file page-cache) and mirrors only the minimum into the target's Sv39 tables
through HTP — ``MemW`` for PTEs, ``PageS`` for zeroing, ``PageCP`` for COW,
``PageW`` for file content.  The mechanisms reproduced from the paper:

  * refcounted physical-page allocator;
  * lazy ``mmap`` initialisation + page-fault driven materialisation with
    16-page preload per fault (§VI-C3);
  * copy-on-write for private file mappings;
  * file preloading (page cache) so shared mappings of the same file hit
    identical physical pages;
  * delayed remote TLB shootdown: a munmap marks every *other* core for a
    flush that is issued only when that core next traps, while VA ranges
    are never reused (non-overlapping allocation guarantee).

HTP flows as native transactions: every fault, munmap and brk path
*builds* one :class:`~repro_torch.core.session.HtpTransaction` (all its PageS /
PageW / PageCP materialisations, MemW PTE updates and the trailing
FlushTLB) and submits it once on the faulting hart's stream — a 16-page
preload fault is one wire batch, not ~50 round trips.  Read paths
(``read_bytes``) batch their PageR/MemR requests per call and pick the
values out of the request-ordered result.  The submitting session may be
the synchronous :class:`~repro_torch.core.session.HtpSession` or the pipelined
:class:`~repro_torch.core.cq.AsyncHtpSession`; ``last_token`` after each submit
is the dependency token the runtime chains its Redirect on.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..session import HtpTransaction
from ..target import isa

PAGE = 4096
PAGE_WORDS = 512
SV39_MODE = 8 << 60
# User VA layout
MMAP_TOP = 0x3F_0000_0000
STACK_TOP = 0x3E_0000_0000

PROT_READ, PROT_WRITE, PROT_EXEC = 1, 2, 4
MAP_SHARED, MAP_PRIVATE, MAP_ANON = 1, 2, 0x20


class OutOfMemory(Exception):
    pass


class SegFault(Exception):
    def __init__(self, va, access):
        super().__init__(f"target segfault at {va:#x} ({access})")
        self.va = va
        self.access = access


class PageAllocator:
    """Refcounted physical-page allocator.  PPN 0 = controller scratch."""

    def __init__(self, mem_bytes: int, reserved_low: int = 1):
        self.n_pages = mem_bytes // PAGE
        self.free = list(range(self.n_pages - 1, reserved_low - 1, -1))
        self.refcnt: dict[int, int] = {}

    def alloc(self) -> int:
        if not self.free:
            raise OutOfMemory("no free target pages")
        ppn = self.free.pop()
        self.refcnt[ppn] = 1
        return ppn

    def ref(self, ppn: int):
        self.refcnt[ppn] += 1

    def unref(self, ppn: int) -> bool:
        """Returns True when the page was actually freed."""
        self.refcnt[ppn] -= 1
        if self.refcnt[ppn] == 0:
            del self.refcnt[ppn]
            self.free.append(ppn)
            return True
        return False

    @property
    def n_free(self):
        return len(self.free)


@dataclass
class FileImage:
    """Host-side file with a target page cache (paper's file preloading)."""
    name: str
    data: bytearray
    pages: dict = field(default_factory=dict)   # page index -> ppn

    @property
    def size(self):
        return len(self.data)


@dataclass
class Mapping:
    start: int
    end: int
    prot: int
    kind: str                 # "anon" | "file"
    file: FileImage | None = None
    offset: int = 0
    shared: bool = False

    def contains(self, va):
        return self.start <= va < self.end


@dataclass
class SwPte:
    ppn: int
    prot: int
    cow: bool = False


class VirtualMemory:
    """One address space (FASE runs a single multi-threaded process)."""

    def __init__(self, session, alloc: PageAllocator, cpu0: int = 0,
                 fault_preload: int = 16):
        self.sess = session
        self.alloc = alloc
        self.fault_preload = fault_preload
        self.pt: dict[int, SwPte] = {}       # vpn -> software PTE
        self.segments: list[Mapping] = []
        self.mmap_cursor = MMAP_TOP
        self.brk_base = 0
        self.brk = 0
        self.pending_flush: set[int] = set()  # cores owing a TLB flush
        # hardware table pages: vpn-prefix -> ppn of table page
        self.root_ppn = alloc.alloc()
        self._tables: dict[tuple, int] = {}
        self.stats = {"faults": 0, "cow_copies": 0, "pages_mapped": 0,
                      "fault_txn_requests": 0}
        self.last_token = None               # dep token of the last submit
        # zero the root table
        self._last = self._submit(
            HtpTransaction().page_set(cpu0, self.root_ppn, 0, "load"),
            0, cpu0).done

    @property
    def satp(self) -> int:
        return SV39_MODE | self.root_ppn

    def _submit(self, txn: HtpTransaction, at: int, cpu: int):
        """Submit one built batch on the hart's stream."""
        res = self.sess.submit(txn, at, stream=cpu)
        if res.token is not None:
            self.last_token = res.token
        return res

    # ---------------- hardware table maintenance ----------------------
    def _table_for(self, vpn: int, cpu: int, txn: HtpTransaction,
                   category: str) -> tuple[int, int]:
        """Ensure L1/L0 tables exist for vpn (appending the PageS zeroing
        and MemW pointer writes to ``txn``); returns (l0_ppn, idx0)."""
        vpn2, vpn1, vpn0 = (vpn >> 18) & 0x1FF, (vpn >> 9) & 0x1FF, vpn & 0x1FF
        l1_key = (vpn2,)
        if l1_key not in self._tables:
            ppn = self.alloc.alloc()
            self._tables[l1_key] = ppn
            txn.page_set(cpu, ppn, 0, category)
            txn.mem_write(cpu, self.root_ppn * PAGE + vpn2 * 8,
                          (ppn << 10) | isa.PTE_V, category)
        l0_key = (vpn2, vpn1)
        if l0_key not in self._tables:
            ppn = self.alloc.alloc()
            self._tables[l0_key] = ppn
            txn.page_set(cpu, ppn, 0, category)
            l1 = self._tables[l1_key]
            txn.mem_write(cpu, l1 * PAGE + vpn1 * 8,
                          (ppn << 10) | isa.PTE_V, category)
        return self._tables[l0_key], vpn0

    def _write_hw_pte(self, vpn: int, pte_val: int, cpu: int,
                      txn: HtpTransaction, category: str) -> None:
        l0, idx = self._table_for(vpn, cpu, txn, category)
        txn.mem_write(cpu, l0 * PAGE + idx * 8, pte_val, category)

    def _pte_bits(self, prot: int, cow: bool) -> int:
        b = isa.PTE_V | isa.PTE_U | isa.PTE_A | isa.PTE_D
        if prot & PROT_READ:
            b |= isa.PTE_R
        if (prot & PROT_WRITE) and not cow:
            b |= isa.PTE_W
        if prot & PROT_EXEC:
            b |= isa.PTE_X
        return b

    def _install(self, vpn: int, ppn: int, prot: int, cow: bool,
                 cpu: int, txn: HtpTransaction, category: str) -> None:
        self.pt[vpn] = SwPte(ppn, prot, cow)
        self.stats["pages_mapped"] += 1
        self._write_hw_pte(vpn, (ppn << 10) | self._pte_bits(prot, cow),
                           cpu, txn, category)

    # ---------------- segment management -------------------------------
    def find_segment(self, va: int) -> Mapping | None:
        for m in self.segments:
            if m.contains(va):
                return m
        return None

    def map_segment(self, start: int, size: int, prot: int, kind: str,
                    file: FileImage | None = None, offset: int = 0,
                    shared: bool = False) -> Mapping:
        end = (start + size + PAGE - 1) & ~(PAGE - 1)
        m = Mapping(start & ~(PAGE - 1), end, prot, kind, file, offset,
                    shared)
        self.segments.append(m)
        return m

    def mmap(self, length: int, prot: int, flags: int,
             file: FileImage | None, offset: int) -> int:
        length = (length + PAGE - 1) & ~(PAGE - 1)
        self.mmap_cursor -= length + PAGE   # guard page; VAs never reused
        start = self.mmap_cursor
        self.map_segment(start, length, prot,
                         "anon" if file is None else "file",
                         file, offset, bool(flags & MAP_SHARED))
        return start

    def munmap(self, start: int, length: int, cpu: int, at: int) -> int:
        end = (start + length + PAGE - 1) & ~(PAGE - 1)
        for m in list(self.segments):
            if m.start >= start and m.end <= end:
                self.segments.remove(m)
        txn = HtpTransaction()
        for vpn in range(start >> 12, end >> 12):
            pte = self.pt.pop(vpn, None)
            if pte is not None:
                self.alloc.unref(pte.ppn)
                self._write_hw_pte(vpn, 0, cpu, txn, "munmap")
        # local flush now; remote cores flushed lazily at their next trap
        txn.flush_tlb(cpu, "munmap")
        t = self._submit(txn, at, cpu).done
        self.pending_flush.update(c for c in range(self.sess.t.n_cores)
                                  if c != cpu)
        return t

    def shootdown_delivered(self, cpus) -> None:
        """Remote-shootdown routing (fabric path): the given cores'
        owed TLB flushes were just delivered out-of-band — a gang
        exchange carries them as ``FlushTLB`` rows of the NIC receive
        transaction over the modelled switch — so the lazy host-link
        flush at their next trap is no longer owed."""
        self.pending_flush.difference_update(cpus)

    def set_brk(self, new_brk: int, cpu: int, at: int) -> tuple[int, int]:
        if new_brk == 0 or new_brk < self.brk_base:
            return self.brk, at
        t = at
        if new_brk < self.brk:   # shrink: release whole pages
            txn = HtpTransaction()
            for vpn in range((new_brk + PAGE - 1) >> 12,
                             (self.brk + PAGE - 1) >> 12):
                pte = self.pt.pop(vpn, None)
                if pte is not None:
                    self.alloc.unref(pte.ppn)
                    self._write_hw_pte(vpn, 0, cpu, txn, "brk")
            txn.flush_tlb(cpu, "brk")
            t = self._submit(txn, t, cpu).done
            self.pending_flush.update(c for c in range(self.sess.t.n_cores)
                                      if c != cpu)
        else:
            seg = next((m for m in self.segments if m.kind == "anon" and
                        m.start == self.brk_base), None)
            if seg is None:
                seg = self.map_segment(self.brk_base,
                                       new_brk - self.brk_base,
                                       PROT_READ | PROT_WRITE, "anon")
            seg.end = (new_brk + PAGE - 1) & ~(PAGE - 1)
        self.brk = new_brk
        return self.brk, t

    # ---------------- faults -------------------------------------------
    def translate(self, va: int) -> int | None:
        pte = self.pt.get(va >> 12)
        if pte is None:
            return None
        return (pte.ppn << 12) | (va & (PAGE - 1))

    def _file_page_ppn(self, f: FileImage, page_idx: int, cpu: int,
                       txn: HtpTransaction, category: str) -> int:
        """Materialise a file page in the target page cache."""
        if page_idx not in f.pages:
            ppn = self.alloc.alloc()
            lo = page_idx * PAGE
            chunk = bytes(f.data[lo:lo + PAGE]).ljust(PAGE, b"\0")
            import numpy as np
            words = np.frombuffer(chunk, dtype=np.uint64)
            txn.page_write(cpu, ppn, words, category)
            f.pages[page_idx] = ppn
        return f.pages[page_idx]

    def fault_in(self, vpn: int, m: Mapping, want_write: bool, cpu: int,
                 txn: HtpTransaction, category: str) -> None:
        """Append the materialisation of one page of ``m`` to ``txn``."""
        va = vpn << 12
        if m.kind == "anon":
            ppn = self.alloc.alloc()
            txn.page_set(cpu, ppn, 0, category)
            self._install(vpn, ppn, m.prot, False, cpu, txn, category)
            return
        page_idx = (m.offset + (va - m.start)) >> 12
        cache_ppn = self._file_page_ppn(m.file, page_idx, cpu, txn,
                                        category)
        if m.shared:
            self.alloc.ref(cache_ppn)
            self._install(vpn, cache_ppn, m.prot, False, cpu, txn,
                          category)
            return
        if want_write:
            # private write: copy now
            ppn = self.alloc.alloc()
            txn.page_copy(cpu, cache_ppn, ppn, category)
            self.stats["cow_copies"] += 1
            self._install(vpn, ppn, m.prot, False, cpu, txn, category)
            return
        # private read: share the cache page copy-on-write
        self.alloc.ref(cache_ppn)
        self._install(vpn, cache_ppn, m.prot, True, cpu, txn, category)

    def handle_fault(self, va: int, access: str, cpu: int, at: int,
                     enforce: bool = True) -> int:
        """Page-fault entry point; raises SegFault on invalid access.
        ``enforce=False`` is the host path (loader/syscall buffers), which
        materialises pages without the user-mode permission check.

        The whole fault — preload included — is built as **one native
        transaction** (PageS/PageW/PageCP + MemW PTE updates + FlushTLB)
        and submitted once on the faulting hart's stream."""
        self.stats["faults"] += 1
        m = self.find_segment(va)
        if m is None:
            raise SegFault(va, access)
        need = {"r": PROT_READ, "w": PROT_WRITE, "x": PROT_EXEC}[access]
        if enforce and not (m.prot & need):
            raise SegFault(va, access)
        vpn = va >> 12
        pte = self.pt.get(vpn)
        cat = "pagefault"
        txn = HtpTransaction()
        if pte is not None and pte.cow and access == "w":
            # COW break
            if self.alloc.refcnt.get(pte.ppn, 1) > 1:
                new_ppn = self.alloc.alloc()
                txn.page_copy(cpu, pte.ppn, new_ppn, cat)
                self.alloc.unref(pte.ppn)
                self.stats["cow_copies"] += 1
                self._install(vpn, new_ppn, pte.prot, False, cpu, txn, cat)
            else:
                self._install(vpn, pte.ppn, pte.prot, False, cpu, txn, cat)
            txn.flush_tlb(cpu, cat)
        elif pte is not None:
            # spurious (e.g. raced with preload): just flush
            txn.flush_tlb(cpu, cat)
        else:
            self.fault_in(vpn, m, access == "w", cpu, txn, cat)
            # preload next pages of the same segment (paper: 16 per fault)
            for nvpn in range(vpn + 1, vpn + self.fault_preload):
                if (nvpn << 12) >= m.end or nvpn in self.pt:
                    break
                self.fault_in(nvpn, m, False, cpu, txn, cat)
        self.stats["fault_txn_requests"] += len(txn)
        return self._submit(txn, at, cpu).done

    # ---------------- byte-granular host access ------------------------
    def ensure_mapped(self, va: int, size: int, cpu: int, at: int,
                      want_write: bool = False) -> int:
        """Materialise every page backing [va, va+size) (host access)."""
        t = at
        for vpn in range(va >> 12, (va + max(size, 1) - 1 >> 12) + 1):
            pte = self.pt.get(vpn)
            if pte is None or (want_write and pte.cow):
                t = self.handle_fault(vpn << 12, "w" if want_write else "r",
                                      cpu, t, enforce=False)
        return t

    def read_bytes(self, va: int, size: int, cpu: int, at: int,
                   category: str) -> tuple[bytes, int]:
        import numpy as np
        t = self.ensure_mapped(va, size, cpu, at)
        # one read batch per call: PageR for whole pages, MemR otherwise
        txn = HtpTransaction()
        plan = []                      # mirrors txn: how to slice values
        pos = va
        remaining = size
        while remaining > 0:
            pa = self.translate(pos)
            in_page = min(remaining, PAGE - (pos & (PAGE - 1)))
            if in_page == PAGE and (pa & (PAGE - 1)) == 0:
                txn.page_read(cpu, pa >> 12, category)
                plan.append(("page", 0, PAGE))
            else:
                w0, w1 = pa & ~7, (pa + in_page + 7) & ~7
                for wa in range(w0, w1, 8):
                    txn.mem_read(cpu, wa, category)
                lo = pa - w0
                plan.append(("words", lo, (w1 - w0, lo + in_page)))
            pos += in_page
            remaining -= in_page
        res = self._submit(txn, t, cpu)
        out = bytearray()
        vi = 0
        for kind, lo, ext in plan:
            if kind == "page":
                out += np.asarray(res.values[vi],
                                  dtype=np.uint64).tobytes()
                vi += 1
            else:
                nwords, hi = ext[0] // 8, ext[1]
                buf = bytearray()
                for w in res.values[vi:vi + nwords]:
                    buf += int(w).to_bytes(8, "little")
                vi += nwords
                out += buf[lo:hi]
        return bytes(out), res.done

    def write_bytes(self, va: int, data: bytes, cpu: int, at: int,
                    category: str) -> int:
        import numpy as np
        t = self.ensure_mapped(va, len(data), cpu, at, want_write=True)
        # one write batch per call; sub-word RMW peeks the target's
        # current words host-side (each word is written at most once per
        # call, so build-time peeks match submit-time application order).
        # Pass 1 plans the chunks so every RMW peek lands in ONE batched
        # device fetch (session.peek_words) instead of a blocking
        # per-word round trip; pass 2 builds the transaction.
        spans = []                     # (pa, in_page, offset into data)
        rmw = []                       # word addresses needing a peek
        pos = va
        idx = 0
        remaining = len(data)
        while remaining > 0:
            pa = self.translate(pos)
            in_page = min(remaining, PAGE - (pos & (PAGE - 1)))
            if not (in_page == PAGE and (pa & (PAGE - 1)) == 0):
                w0, w1 = pa & ~7, (pa + in_page + 7) & ~7
                rmw.extend(range(w0, w1, 8))
            spans.append((pa, in_page, idx))
            pos += in_page
            idx += in_page
            remaining -= in_page
        old_words = dict(zip(rmw, self.sess.peek_words(rmw))) if rmw \
            else {}
        txn = HtpTransaction()
        for pa, in_page, off in spans:
            if in_page == PAGE and (pa & (PAGE - 1)) == 0:
                words = np.frombuffer(data[off:off + PAGE],
                                      dtype=np.uint64)
                txn.page_write(cpu, pa >> 12, words, category)
            else:
                w0, w1 = pa & ~7, (pa + in_page + 7) & ~7
                for wa in range(w0, w1, 8):
                    b = bytearray(int(old_words[wa]).to_bytes(8, "little"))
                    for k in range(8):
                        p = wa + k
                        if pa <= p < pa + in_page:
                            b[k] = data[off + (p - pa)]
                    txn.mem_write(cpu, wa,
                                  int.from_bytes(bytes(b), "little"),
                                  category)
        return self._submit(txn, t, cpu).done

    def read_cstr(self, va: int, cpu: int, at: int,
                  category: str, maxlen: int = 4096) -> tuple[str, int]:
        out = bytearray()
        t = at
        while len(out) < maxlen:
            chunk, t = self.read_bytes(va + len(out), 32, cpu, t, category)
            z = chunk.find(b"\0")
            if z >= 0:
                out += chunk[:z]
                break
            out += chunk
        return out.decode("latin1"), t
