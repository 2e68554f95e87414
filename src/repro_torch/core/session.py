"""Transaction-oriented HTP session layer (paper §IV-B/§IV-C, scaled).

FASE's survival trick on a low-bandwidth, high-latency link is
*consolidation*: many per-port operations become one HTP request, and many
HTP requests become one wire transaction.  This module is the host-side
API for the second half, and the **synchronous base** of a two-layer
session stack:

  * :class:`HtpRequest`     — one typed request from Table II,
  * :class:`HtpTransaction` — an ordered batch of requests built by the
    runtime/serving layers (31 RegR of a context save, RegW×31 + Redirect
    of a context switch, a page fault's PageS/PageW + MemW PTE batch),
  * :class:`HtpSession`     — the synchronous session: submits a
    transaction, coalesces its wire bytes, models channel occupancy
    **once per batch** through the pluggable
    :class:`~repro_torch.core.channel.Channel` backend, applies each request's
    documented execution pattern to the target, and returns per-request
    completion ticks.

Timing model (synchronous layer): a transaction's bytes stream
back-to-back from ``channel.begin(at)``; request *i* completes after its
byte prefix has serialised and the controller has executed patterns 1..i
(``ctrl_cycles`` accumulate).  On a UART this is tick-identical to
issuing the requests one by one (the link is the bottleneck and the old
per-method API serialised everything anyway), while on a
latency-dominated link (PCIe) the per-transaction setup cost is paid once
per batch — which is exactly why the API is transaction-shaped.

Sync → async layering: :class:`~repro_torch.core.cq.AsyncHtpSession`
(:mod:`repro_torch.core.cq`) subclasses this session with a queue-pair front
end — per-hart :class:`~repro_torch.core.cq.SubmissionStream`\\ s plus one for
Layer-B serving traffic, a :class:`~repro_torch.core.cq.CompletionQueue`, and
explicit dependency tokens.  Every ``submit`` here accepts the async
signature (``stream=``/``deps=``): the synchronous session honours
``deps`` by delaying the transaction start (so call sites are written
once) and ignores ``stream`` (one serial link has a single implicit
stream).  On non-pipelined channels the async engine delegates to this
class's arithmetic verbatim, which is what keeps the UART tick-identical
across the two layers.

Requests flagged ``virtual`` are accounting/timing-only analogues (the
serving layer's pod-scale command batches): they occupy the channel and
charge controller cycles but are never applied to a target, so a session
over a real FASE target and the Layer-B serving engine can share one
modelled link.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from . import htp
from .channel import Channel, UartChannel
from .hfutex import HFutexCache

#: sentinel distinguishing "not prefetched" from a prefetched 0/None
_MISS = object()

_MASK64 = (1 << 64) - 1


class _WriteStage:
    """Host-side staging area for one transaction's writes (the write
    half of ROADMAP item 1, mirroring :meth:`HtpSession._prefetch_reads`
    on the read side): RegW/CsrW/MemW and full-page writes accumulate in
    dicts and commit as ONE ``Target.commit_batch`` device update at the
    end of the ``submit`` that created the stage.

    Dict keying does the intra-transaction dirty tracking: a later write
    to the same location overwrites in place (program-order last-wins)
    and guarantees the commit scatter sees unique indices.  Reads that
    fall back past the prefetch batch consult the stage first, so a
    read→write→read of one location inside a transaction observes the
    staged value, never the stale device copy.  Values are 64-bit-masked
    at stage time; ``x0`` and the global ``ticks`` scalar are never
    staged (both keep their eager per-element semantics)."""

    __slots__ = ("regs", "csrs", "words")

    def __init__(self):
        self.regs: dict = {}      # (cpu, idx)  -> value
        self.csrs: dict = {}      # (cpu, name) -> value
        self.words: dict = {}     # word index  -> value

    def __bool__(self):
        return bool(self.regs or self.csrs or self.words)


@dataclass(frozen=True)
class HtpRequest:
    """One typed HTP request (Table II row) inside a transaction."""

    op: str                       # key into htp.SPECS
    cpu: int = 0
    args: tuple = ()
    category: str = ""            # secondary "sys:<cat>" accounting
    nbytes: int | None = None     # wire-size override (serving analogues)
    virtual: bool = False         # timing/accounting only, never applied

    def wire_bytes(self, direct: bool = False) -> int:
        if self.nbytes is not None:
            return self.nbytes
        return htp.DIRECT_BYTES[self.op] if direct \
            else htp.SPECS[self.op].total_bytes

    @property
    def ctrl_cycles(self) -> int:
        return htp.SPECS[self.op].ctrl_cycles


class HtpTransaction:
    """An ordered list of HTP requests submitted as one wire batch.

    Chaining methods append a typed request and return ``self`` so call
    sites can chain; ``submit`` through an :class:`HtpSession` returns a
    :class:`TransactionResult` aligned with the request order.
    """

    def __init__(self, requests: list[HtpRequest] | None = None):
        self.requests: list[HtpRequest] = list(requests or ())

    def __len__(self):
        return len(self.requests)

    def __iter__(self):
        return iter(self.requests)

    def add(self, req: HtpRequest) -> "HtpTransaction":
        self.requests.append(req)
        return self

    # -- typed builders (Table II) --------------------------------------
    def redirect(self, cpu, pc, category=""):
        return self.add(HtpRequest("Redirect", cpu, (pc,), category))

    def next_info(self, cpu):
        return self.add(HtpRequest("Next", cpu))

    def set_mmu(self, cpu, satp, category=""):
        return self.add(HtpRequest("SetMMU", cpu, (satp,), category))

    def flush_tlb(self, cpu, category=""):
        return self.add(HtpRequest("FlushTLB", cpu, (), category))

    def synci(self, cpu, category=""):
        return self.add(HtpRequest("SyncI", cpu, (), category))

    def hfutex_update(self, cpu):
        return self.add(HtpRequest("HFutex", cpu, (), "futex"))

    def reg_read(self, cpu, idx, category=""):
        return self.add(HtpRequest("RegR", cpu, (idx,), category))

    def reg_write(self, cpu, idx, val, category=""):
        return self.add(HtpRequest("RegW", cpu, (idx, val), category))

    def csr_read(self, cpu, name, category=""):
        return self.add(HtpRequest("CsrR", cpu, (name,), category))

    def csr_write(self, cpu, name, val, category=""):
        return self.add(HtpRequest("CsrW", cpu, (name, val), category))

    def mem_read(self, cpu, pa, category=""):
        return self.add(HtpRequest("MemR", cpu, (pa,), category))

    def mem_write(self, cpu, pa, val, category=""):
        return self.add(HtpRequest("MemW", cpu, (pa, val), category))

    def page_set(self, cpu, ppn, val, category=""):
        return self.add(HtpRequest("PageS", cpu, (ppn, val), category))

    def page_copy(self, cpu, src, dst, category=""):
        return self.add(HtpRequest("PageCP", cpu, (src, dst), category))

    def page_read(self, cpu, ppn, category=""):
        return self.add(HtpRequest("PageR", cpu, (ppn,), category))

    def page_write(self, cpu, ppn, words, category=""):
        return self.add(HtpRequest("PageW", cpu, (ppn, words), category))

    def page_hash(self, cpu, ppn, category=""):
        return self.add(HtpRequest("PageH", cpu, (ppn,), category))

    def tick(self):
        return self.add(HtpRequest("Tick"))

    def utick(self, cpu):
        return self.add(HtpRequest("UTick", cpu))

    def ctr_sample(self, cpu):
        """Out-of-band counter frame of one hart (telemetry stream)."""
        return self.add(HtpRequest("CtrSample", cpu))

    def trace_burst(self, cpu):
        """One commit-trace frame drained from one hart's ring
        (telemetry stream; fixed ``htp.TRACE_FRAME_RECORDS`` records)."""
        return self.add(HtpRequest("TraceB", cpu))

    def nic_tx(self, cpu, ppn, category="nic"):
        """DMA one page out of board DRAM into the NIC egress FIFO
        (fabric frame — timed on the switch port, never the host link)."""
        return self.add(HtpRequest("NicTx", cpu, (ppn,), category))

    def nic_rx(self, cpu, ppn, words, category="nic"):
        """Drain one ingress fabric frame into a DRAM page."""
        return self.add(HtpRequest("NicRx", cpu, (ppn, words), category))

    def nic_ctl(self, cpu, kind, val=0, category="nic"):
        """Small fabric control frame (remote wake / shootdown doorbell)."""
        return self.add(HtpRequest("NicCtl", cpu, (kind, val), category))

    # -- wire size -------------------------------------------------------
    def wire_bytes(self, direct: bool = False) -> int:
        return sum(r.wire_bytes(direct) for r in self.requests)


@dataclass
class TransactionResult:
    """Per-request completion ticks + response values, request-ordered.

    ``token`` is filled by the async layer (:mod:`repro_torch.core.cq`): a
    dependency handle later transactions can wait on via ``deps=``.
    """

    done: int                    # completion tick of the whole batch
    ticks: list = field(default_factory=list)
    values: list = field(default_factory=list)
    token: object = None         # CompletionToken under AsyncHtpSession

    def __iter__(self):
        return iter(zip(self.ticks, self.values))


@dataclass
class SessionStats:
    """Table IV stall decomposition (controller vs link)."""

    requests: dict = field(default_factory=dict)
    transactions: int = 0
    controller_cycles: int = 0
    uart_ticks: int = 0          # historical name: link wait+wire ticks
    #: Layer-B serving analogues on a shared session.  They occupy the
    #: link but are never processed by the Layer-A host runtime loop, so
    #: the runtime's host-latency model must not bill them (a plain FASE
    #: run has zero — existing golden ticks are unaffected).
    virtual_requests: int = 0

    def count(self, name, virtual: bool = False):
        self.requests[name] = self.requests.get(name, 0) + 1
        if virtual:
            self.virtual_requests += 1


class HtpSession:
    """Host endpoint of the Host-Target Protocol over one channel."""

    def __init__(self, target, channel: Channel | None = None,
                 hfutex: HFutexCache | None = None,
                 direct_mode: bool = False, ctrl_serialize: bool = False):
        self.t = target              # None = timing/accounting-only session
        self.channel = channel or UartChannel()
        self.hfutex = hfutex or HFutexCache(
            target.n_cores if target is not None else 0)
        self.direct_mode = direct_mode   # per-port baseline (no HTP)
        # ``ctrl_serialize`` backports the async engine's per-hart
        # controller slice (``ctrl_free``) into the synchronous
        # arithmetic: controller cycles of different transactions can no
        # longer overlap unphysically on one hart.  Off by default — the
        # historical arithmetic is the UART golden-tick contract.
        self.ctrl_serialize = ctrl_serialize
        self._ctrl_free: dict = {}       # hart -> controller-slice free tick
        self.stats = SessionStats()
        # analysis trace hook (repro.analysis.trace.TraceRecorder).  None
        # by default: the only cost of the disabled hook is one
        # ``is not None`` test per submit, so golden ticks and wall-clock
        # are untouched.  ``_trace_suspend`` lets the async layer delegate
        # to this submit without double-recording.
        self.trace = None
        self._trace_suspend = False
        # write stage of the submit in flight (None outside one); see
        # _WriteStage — direct accessor calls between transactions (the
        # hfutex fast path, fleet migration) never see a live stage
        self._stage: _WriteStage | None = None

    # ------------------------------------------------------------------
    def submit(self, txn: HtpTransaction, at: int, stream=0,
               deps: tuple = ()) -> TransactionResult:
        """Send ``txn`` no earlier than tick ``at`` and no earlier than
        any dependency token in ``deps``; apply every request's execution
        pattern to the target in order.  ``stream`` is accepted for
        signature compatibility with the async layer and ignored here (a
        synchronous session is one implicit stream)."""
        ready = at
        for dep in deps:
            if dep is not None:
                ready = max(ready, dep.tick)
        if not txn.requests:          # nothing crosses the wire
            return TransactionResult(done=ready)
        ch = self.channel
        self.stats.transactions += 1
        start = ch.begin(ready)
        enabled = ch.enabled
        cum_bytes = 0
        cum_cycles = 0
        reads = self._prefetch_reads(txn)
        self._stage_begin(txn)
        result = TransactionResult(done=ready)
        try:
            for i, req in enumerate(txn.requests):
                nbytes = req.wire_bytes(self.direct_mode)
                ch.account(nbytes, f"htp:{req.op}")
                if req.category:
                    ch.bytes_by_cat[f"sys:{req.category}"] += nbytes
                self.stats.count(req.op, req.virtual)
                self.stats.controller_cycles += req.ctrl_cycles
                cum_bytes += nbytes
                if not enabled:
                    done = ready
                elif self.ctrl_serialize:
                    # per-hart controller slice: the request executes when
                    # its byte prefix has arrived AND the hart's controller
                    # is free — transactions on one hart never overlap
                    # their controller cycles (the async engine's
                    # discipline).
                    arrive = start + ch.ticks_for_bytes(cum_bytes)
                    done = max(arrive, self._ctrl_free.get(req.cpu, 0)) \
                        + req.ctrl_cycles
                    self._ctrl_free[req.cpu] = done
                else:
                    cum_cycles += req.ctrl_cycles
                    done = start + ch.ticks_for_bytes(cum_bytes) \
                        + cum_cycles
                result.ticks.append(done)
                result.values.append(self._apply(req, done, reads, i))
        finally:
            self._stage_end()
        ch.end(start, cum_bytes)
        if enabled:
            wire_done = start + ch.ticks_for_bytes(cum_bytes)
            self.stats.uart_ticks += max(0, wire_done - ready)
        if not result.ticks:
            result.done = ready
        elif self.ctrl_serialize:
            # multi-hart batches may retire per-slice out of request
            # order; the transaction is done when its last slice is
            result.done = max(result.ticks)
        else:
            result.done = result.ticks[-1]
        if self.trace is not None and not self._trace_suspend:
            self.trace.on_submit(stream, txn, deps, at, ready, result)
        return result

    # ------------------------------------------------------------------
    # Table II execution patterns a Redirect/Next apply beyond their args
    # (shared with the prefetch write-set tracking below)
    _REDIRECT_WRITES = ("pc", "priv", "pending", "stall_until")
    _NEXT_READS = ("mcause", "mepc", "mtval")

    def _prefetch_reads(self, txn: HtpTransaction):
        """Gather every register/CSR/word read of ``txn`` into ONE device
        fetch (``Target.fetch_batch``) instead of one blocking round trip
        per element — the first step of ROADMAP item 1 (a RegR×31 context
        save is one transfer, not 31).  Values are bit-identical to the
        per-element accessors; a read whose location an *earlier* request
        of the same transaction writes is excluded and falls back to a
        direct read at apply time.  Returns a dict keyed by request
        index (``(index, csr_name)`` for a Next's fields) — per-request,
        not per-location, so a location that is read, then written, then
        read again never serves the first read's value to the second —
        or None when there is nothing worth batching (fewer than two
        reads, or a target without the batch surface)."""
        t = self.t
        if t is None or not hasattr(t, "fetch_batch"):
            return None
        regs, csrs, words = [], [], []
        rkeys, ckeys, wkeys = [], [], []
        dirty = set()
        n = 0
        for i, req in enumerate(txn.requests):
            if req.virtual:
                continue
            op, cpu, a = req.op, req.cpu, req.args
            if op == "RegR":
                if ("reg", cpu, a[0]) not in dirty:
                    regs.append((cpu, a[0]))
                    rkeys.append(i)
                    n += 1
            elif op == "CsrR":
                if ("csr", cpu, a[0]) not in dirty:
                    csrs.append((cpu, a[0]))
                    ckeys.append(i)
                    n += 1
            elif op == "Next":
                for name in self._NEXT_READS:
                    if ("csr", cpu, name) not in dirty:
                        csrs.append((cpu, name))
                        ckeys.append((i, name))
                        n += 1
                dirty.add(("csr", cpu, "pending"))   # clear_pending
            elif op == "MemR":
                if ("mem", a[0] >> 3) not in dirty and \
                        ("page", a[0] >> 12) not in dirty:
                    words.append(a[0])
                    wkeys.append(i)
                    n += 1
            elif op == "RegW":
                dirty.add(("reg", cpu, a[0]))
            elif op == "CsrW":
                dirty.add(("csr", cpu, a[0]))
            elif op == "MemW":
                dirty.add(("mem", a[0] >> 3))
            elif op in ("PageS", "PageW", "NicRx"):
                dirty.add(("page", a[0]))
            elif op == "PageCP":
                dirty.add(("page", a[1]))
            elif op == "Redirect":
                dirty.update(("csr", cpu, f)
                             for f in self._REDIRECT_WRITES)
            elif op == "SetMMU":
                dirty.add(("csr", cpu, "satp"))
        if n < 2:
            return None          # a single read is already one fetch
        rv, cv, wv = t.fetch_batch(regs, csrs, words)
        out = {}
        out.update(zip(rkeys, rv))
        out.update(zip(ckeys, cv))
        out.update(zip(wkeys, wv))
        return out

    def peek_words(self, pas) -> list:
        """Untimed host-side peeks of physical memory words, batched into
        one device fetch — read-modify-write staging for sub-word stores
        (host knowledge, like the loader's image prep: no wire traffic,
        no ticks)."""
        t = self.t
        if hasattr(t, "fetch_batch"):
            return list(t.fetch_batch((), (), tuple(pas))[2])
        return [t.mem_read_word(pa) for pa in pas]

    # ------------------------------------------------------------------
    # Staged write batching (ROADMAP item 1, write side): see _WriteStage
    # ------------------------------------------------------------------
    #: ops whose effects the stage can defer into one commit_batch
    _STAGEABLE = frozenset({"RegW", "CsrW", "MemW",
                            "PageW", "PageS", "NicRx"})

    def _stage_begin(self, txn: HtpTransaction) -> None:
        """Open a write stage for one ``submit`` if the target has the
        batched-commit surface and ``txn`` stages anything at all."""
        t = self.t
        if t is None or not hasattr(t, "commit_batch"):
            return
        if any(r.op in self._STAGEABLE and not r.virtual
               for r in txn.requests):
            self._stage = _WriteStage()

    def _stage_flush(self) -> None:
        """Commit everything staged so far in ONE device update, keeping
        the stage open.  Called mid-transaction before any request that
        reads device state wholesale (PageR/PageCP/PageH/NicTx, Tick,
        counter/trace drains) and at transaction end."""
        s = self._stage
        if s:
            self.t.commit_batch(
                regs=[(c, i, v) for (c, i), v in s.regs.items()],
                csrs=[(c, n, v) for (c, n), v in s.csrs.items()],
                words=list(s.words.items()))
            s.regs.clear()
            s.csrs.clear()
            s.words.clear()

    def _stage_end(self) -> None:
        try:
            self._stage_flush()
        finally:
            self._stage = None

    # ------------------------------------------------------------------
    def _apply(self, req: HtpRequest, done: int, reads: dict | None = None,
               idx: int = 0):
        """Apply one request's documented effect; returns its response.
        ``reads`` is the transaction's prefetched read batch, keyed by
        request index (:meth:`_prefetch_reads`); reads missing from it
        (their location written earlier in the same transaction) fall
        back to the write stage, then to direct accessors.  When a stage
        is open (:meth:`_stage_begin`), RegW/CsrW/MemW and full-page
        writes stage instead of dispatching; requests that overwrite the
        same locations eagerly (Redirect, Next's clear-pending, SetMMU)
        pop the dead staged keys so program order survives the deferred
        commit, and requests that read device state wholesale flush the
        stage first."""
        if req.virtual:
            return None           # serving analogue: wire/ctrl time only
        t = self.t
        s = self._stage
        op, cpu, a = req.op, req.cpu, req.args
        if op == "Redirect":
            if s is not None:     # redirect overwrites these eagerly
                for f in self._REDIRECT_WRITES:
                    s.csrs.pop((cpu, f), None)
            t.redirect(cpu, a[0], resume_tick=done)
        elif op == "Next":
            vals = []
            for name in self._NEXT_READS:
                v = _MISS if reads is None else \
                    reads.get((idx, name), _MISS)
                if v is _MISS and s is not None:
                    v = s.csrs.get((cpu, name), _MISS)
                if v is _MISS:    # dirtied earlier in this transaction
                    v = t.csr_read(cpu, name)  # analysis: allow-host-sync
                vals.append(v)
            if s is not None:     # clear_pending overwrites it eagerly
                s.csrs.pop((cpu, "pending"), None)
            t.clear_pending(cpu)
            return tuple(vals)
        elif op == "SetMMU":
            if s is not None:     # set_satp overwrites it eagerly
                s.csrs.pop((cpu, "satp"), None)
            t.set_satp(cpu, a[0])
        elif op == "FlushTLB":
            t.sfence(cpu)
        elif op in ("SyncI", "HFutex"):
            pass                      # mask/ifence effects are host-side
        elif op == "RegR":
            if reads is not None:
                v = reads.get(idx, _MISS)
                if v is not _MISS:
                    return v
            if s is not None:
                v = s.regs.get((cpu, a[0]), _MISS)
                if v is not _MISS:
                    return v
            return t.reg_read(cpu, a[0])
        elif op == "RegW":
            if s is not None:
                if a[0] != 0:     # x0 is a no-op on every backend
                    s.regs[(cpu, a[0])] = a[1] & _MASK64
            else:
                t.reg_write(cpu, a[0], a[1])
        elif op == "CsrR":
            if reads is not None:
                v = reads.get(idx, _MISS)
                if v is not _MISS:
                    return v
            if s is not None:
                v = s.csrs.get((cpu, a[0]), _MISS)
                if v is not _MISS:
                    return v
            return t.csr_read(cpu, a[0])
        elif op == "CsrW":
            if s is not None and a[0] != "ticks":
                # the global clock scalar keeps eager semantics
                s.csrs[(cpu, a[0])] = int(a[1]) & _MASK64
            else:
                t.csr_write(cpu, a[0], a[1])
        elif op == "MemR":
            if reads is not None:
                v = reads.get(idx, _MISS)
                if v is not _MISS:
                    return v
            if s is not None:
                v = s.words.get(a[0] >> 3, _MISS)
                if v is not _MISS:
                    return v
            return t.mem_read_word(a[0])
        elif op == "MemW":
            if s is not None:
                s.words[a[0] >> 3] = a[1] & _MASK64
            else:
                t.mem_write_word(a[0], a[1])
        elif op == "PageS":
            if s is not None:
                base = (a[0] << 12) >> 3
                v = a[1] & _MASK64
                for j in range(512):
                    s.words[base + j] = v
            else:
                t.page_set(a[0], a[1])
        elif op == "PageCP":
            self._stage_flush()   # the copy reads the src page wholesale
            t.page_copy(a[0], a[1])
        elif op == "PageR":
            self._stage_flush()
            return t.page_read(a[0])
        elif op == "PageW":
            if s is not None:
                base = (a[0] << 12) >> 3
                for j, v in enumerate(a[1]):
                    s.words[base + j] = int(v) & _MASK64
            else:
                t.page_write(a[0], a[1])
        elif op == "PageH":
            self._stage_flush()
            return htp.page_hash(t.page_read(a[0]))
        elif op == "Tick":
            self._stage_flush()
            return t.get_ticks()
        elif op == "UTick":
            self._stage_flush()
            return t.get_uticks(cpu)
        elif op == "CtrSample":
            # one bundled device fetch for the whole counter frame
            self._stage_flush()
            return tuple(t.fetch_batch(
                csrs=[(cpu, n) for n in htp.TELEM_COUNTERS])[1])
        elif op == "TraceB":
            # drain the hart's commit-trace ring (records, ring_dropped);
            # the telemetry bridge normally drains host-side and ships
            # the frames pre-filled — this path serves direct submission
            self._stage_flush()
            return t.trace_drain(cpu)
        elif op == "NicTx":
            self._stage_flush()
            return t.page_read(a[0])      # page words into the egress FIFO
        elif op == "NicRx":
            if s is not None:
                base = (a[0] << 12) >> 3
                for j, v in enumerate(a[1]):
                    s.words[base + j] = int(v) & _MASK64
            else:
                t.page_write(a[0], a[1])
        elif op == "NicCtl":
            pass   # doorbell only: effects ride as HFutex/FlushTLB rows
        else:
            raise KeyError(f"unknown HTP request {op!r}")
        return None

    # ------------------------------------------------------------------
    # Hardware futex-wake filter (Next FSM fast path, §V-B).  Peeks the
    # syscall registers through the Reg ports (controller-local, no link
    # traffic) and short-circuits a masked FUTEX_WAKE.
    # ------------------------------------------------------------------
    FUTEX_NR = 98
    FUTEX_WAKE_OPS = (1, 129)   # FUTEX_WAKE, | FUTEX_PRIVATE_FLAG

    def try_hfutex_fast_path(self, cpu: int, cause: int, epc: int,
                             at: int) -> int | None:
        """Returns completion tick if handled locally, else None."""
        if not self.hfutex.enabled or cause != 8:   # ecall from U only
            return None
        a7 = self.t.reg_read(cpu, 17)
        if a7 != self.FUTEX_NR:
            return None
        op = self.t.reg_read(cpu, 11) & 0xFF
        if op not in self.FUTEX_WAKE_OPS:
            return None
        va = self.t.reg_read(cpu, 10)
        if not self.hfutex.lookup(cpu, va):
            return None
        # local handling: a0 = 0 (nobody woken), resume at epc + 4
        self.t.reg_write(cpu, 10, 0)
        self.t.clear_pending(cpu)
        cycles = 16  # reg peeks + FSM, controller-local
        self.stats.controller_cycles += cycles
        done = at + (cycles if self.channel.enabled else 0)
        self.t.redirect(cpu, epc + 4, resume_tick=done)
        return done
