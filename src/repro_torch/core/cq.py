"""Async completion-queue session engine — the pipelined layer over
:class:`~repro_torch.core.session.HtpSession` (ROADMAP: "async/pipelined
sessions").

FASE's Host-Target Protocol exists to hide a low-bandwidth, high-latency
link.  The synchronous session consolidates *within* one transaction; on
a latency-dominated link (PCIe) the remaining stall is *between*
transactions: every submission pays the full descriptor/doorbell setup
latency serially, even when it belongs to an independent per-core
exception chain.  This module decouples submission from completion the
way co-emulation frameworks (ZynqParrot, FERIVer) decouple host and
device — with queue pairs:

  * :class:`SubmissionStream` — one FIFO per hart, plus named streams
    (the Layer-B serving engine submits on ``"serve"``).  A stream is an
    ordering domain: its transactions issue in FIFO order and execute on
    its controller slice serially, so per-stream completions are
    monotone.  Different streams only contend on the shared wire.
  * :class:`CompletionQueue` — the record of retired transactions.  Each
    ``submit`` pushes a :class:`Completion` carrying a
    :class:`CompletionToken`; tokens are the *explicit dependency* handle:
    ``submit(txn, at, deps=(tok,))`` will not issue before ``tok.tick``.
  * :class:`AsyncHtpSession` — the engine.  Functionally it applies
    requests to the target exactly like the synchronous session (host
    program order — determinism is preserved); only the *timing model*
    changes, per :class:`~repro_torch.core.channel.Channel` backend:

      - non-pipelined links (UART 8N2, oracle, disabled channels)
        delegate to the synchronous arithmetic verbatim — tick-identical
        to :class:`~repro_torch.core.session.HtpSession` for the same
        transaction trace;
      - pipelined links (PCIe) overlap independent streams: at most
        ``depth`` transactions are in flight, doorbells raised within
        ``coalesce_ticks`` of the last one share its setup latency, the
        wire serialises globally, and each request then executes on its
        stream's controller slice (``ctrl_free``) as its bytes arrive.

Queue-pair timing, one transaction on a pipelined link::

    ready  = max(at, deps..., stream FIFO tail)
    ready  = max(ready, oldest in-flight completion)   # depth gate
    door   = ready > last_doorbell + coalesce ? ready : last_doorbell
    wire0  = max(ready, door + latency, wire_free)     # link serialises
    arrive_i = wire0 + ticks_for_bytes(cum_bytes_i)
    exec_i   = max(arrive_i, stream.ctrl_free)         # per-hart slice
    done_i   = exec_i + ctrl_cycles_i

Hidden latency (`sync start - wire0`, when positive) is what the
``results/cq_overlap.json`` benchmark artifact reports.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from .session import (HtpSession, HtpTransaction, TransactionResult)

#: default bound on retained completions (older entries are dropped; the
#: counters in :class:`CqStats` keep the full totals)
CQ_CAPACITY = 4096

#: submission-stream key for snapshot/restore traffic
#: (:mod:`repro.core.snapshot`).  Checkpoints are whole-target operations,
#: not per-hart work, so they ride their own named stream — like the
#: serving engine's ``"serve"`` — and barrier on every per-hart stream's
#: tail token (``tail_tokens()``) before capturing, so an in-flight fault
#: batch is never snapshotted half-applied.
SNAPSHOT_STREAM = "snap"


@dataclass(frozen=True)
class CompletionToken:
    """Dependency handle for one submitted transaction.

    ``tick`` is the modelled completion tick of the whole transaction;
    a later ``submit(..., deps=(token,))`` will not issue before it.
    """

    stream: object               # stream key (hart index or name)
    seq: int                     # per-stream submission sequence number
    tick: int                    # completion tick of the transaction


@dataclass
class Completion:
    """One retired transaction as seen on the completion queue."""

    token: CompletionToken
    issue: int                   # tick the engine accepted the txn
    wire_start: int              # first byte on the wire
    done: int                    # last request's completion tick
    n_requests: int
    nbytes: int


class SubmissionStream:
    """One submission FIFO + controller slice of a queue pair."""

    def __init__(self, engine: "AsyncHtpSession", key):
        self.engine = engine
        self.key = key
        self.seq = 0                 # submissions accepted so far
        self.last_issue = 0          # FIFO order point
        self.ctrl_free = 0           # this hart's controller slice
        self.last_token: CompletionToken | None = None

    def submit(self, txn: HtpTransaction, at: int,
               deps: tuple = ()) -> TransactionResult:
        return self.engine.submit(txn, at, stream=self.key, deps=deps)


@dataclass
class CqStats:
    """Pipelined-engine counters (beyond SessionStats)."""

    submitted: int = 0
    doorbells: int = 0
    coalesced: int = 0           # submissions that shared a doorbell
    latency_hidden: int = 0      # setup ticks overlapped away vs sync
    depth_stalls: int = 0        # submissions gated by the in-flight cap
    max_inflight: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class CompletionQueue:
    """Bounded record of retired transactions, oldest first."""

    def __init__(self, capacity: int = CQ_CAPACITY):
        self.entries: deque[Completion] = deque(maxlen=capacity)
        self.retired = 0

    def push(self, c: Completion):
        self.entries.append(c)
        self.retired += 1

    def drain(self, upto: int | None = None) -> list[Completion]:
        """Pop completions with ``done <= upto`` (all when ``upto`` is
        None), oldest first."""
        out = []
        while self.entries and (upto is None or
                                self.entries[0].done <= upto):
            out.append(self.entries.popleft())
        return out

    def __len__(self):
        return len(self.entries)


class AsyncHtpSession(HtpSession):
    """Queue-pair HTP session: per-stream submission, modelled overlap.

    Drop-in for :class:`~repro_torch.core.session.HtpSession` — same
    ``submit(txn, at, stream=, deps=)`` surface, same accounting — with
    the pipelined timing engine engaged only on channels that declare
    ``pipelined`` (PCIe).  Serial links keep the synchronous arithmetic,
    so switching a UART runtime to this session changes no tick.
    """

    def __init__(self, target, channel=None, hfutex=None,
                 direct_mode: bool = False, depth: int = 8,
                 coalesce_ticks: int = 50,
                 cq_capacity: int = CQ_CAPACITY,
                 ctrl_serialize: bool = False):
        # ctrl_serialize only reaches the delegated (serial-link) path:
        # the pipelined engine already serialises per-stream ctrl slices
        super().__init__(target, channel, hfutex, direct_mode,
                         ctrl_serialize)
        assert depth >= 1
        self.depth = depth
        self.coalesce_ticks = max(coalesce_ticks, 0)
        self.streams: dict = {}
        self.cq = CompletionQueue(cq_capacity)
        self.cqstats = CqStats()
        self._inflight: deque[int] = deque()    # done ticks, issue order
        self._wire_free = 0
        self._doorbell = None                   # tick of the last doorbell

    # -- queue-pair surface ---------------------------------------------
    def stream(self, key) -> SubmissionStream:
        s = self.streams.get(key)
        if s is None:
            s = self.streams[key] = SubmissionStream(self, key)
        return s

    def tail_tokens(self) -> tuple:
        """Last token of every stream — a full barrier when passed as
        ``deps`` (the final counter harvest depends on them all)."""
        return tuple(s.last_token for s in self.streams.values()
                     if s.last_token is not None)

    def quiesce_tick(self) -> int:
        """Tick by which every submitted transaction has completed."""
        t = self.channel.busy_until
        for s in self.streams.values():
            if s.last_token is not None:
                t = max(t, s.last_token.tick)
        return t

    # -- engine ----------------------------------------------------------
    def submit(self, txn: HtpTransaction, at: int, stream=0,
               deps: tuple = ()) -> TransactionResult:
        s = self.stream(stream)
        ready = at
        for dep in deps:
            if dep is not None:
                ready = max(ready, dep.tick)
        if not txn.requests:          # nothing crosses the wire
            return TransactionResult(done=ready)
        ch = self.channel
        if not (ch.enabled and ch.pipelined):
            # serial link: the synchronous arithmetic is the model, and
            # staying byte-for-byte on it is the UART timing contract.
            if self.trace is None:
                res = super().submit(txn, ready)
            else:
                # record once, below, with the completion token attached
                self._trace_suspend = True
                try:
                    res = super().submit(txn, ready)
                finally:
                    self._trace_suspend = False
            issue = wire_start = ready
        else:
            res, issue, wire_start = self._submit_pipelined(txn, ready, s)
        s.seq += 1
        s.last_issue = max(s.last_issue, issue)
        res.token = CompletionToken(stream, s.seq, res.done)
        s.last_token = res.token
        self.cq.push(Completion(res.token, issue, wire_start, res.done,
                                len(txn), txn.wire_bytes(self.direct_mode)))
        if self.trace is not None:
            self.trace.on_submit(stream, txn, deps, at, ready, res)
        return res

    def _submit_pipelined(self, txn, ready, s: SubmissionStream):
        ch = self.channel
        self.stats.transactions += 1
        self.cqstats.submitted += 1
        # FIFO within the stream: a stream never reorders its doorbells
        ready = max(ready, s.last_issue)
        # in-flight depth gate: wait for the oldest completion to retire
        while self._inflight and self._inflight[0] <= ready:
            self._inflight.popleft()
        if len(self._inflight) >= self.depth:
            ready = max(ready, self._inflight.popleft())
            self.cqstats.depth_stalls += 1
        # doorbell coalescing: submissions within the window share the
        # setup latency already being paid
        if self._doorbell is None or \
                ready > self._doorbell + self.coalesce_ticks:
            self._doorbell = ready
            self.cqstats.doorbells += 1
        else:
            self.cqstats.coalesced += 1
        wire_start = max(ready, self._doorbell + ch.latency_ticks,
                         self._wire_free)
        # what the synchronous session would have charged from here
        sync_start = max(ready, self._wire_free) + ch.latency_ticks
        self.cqstats.latency_hidden += max(0, sync_start - wire_start)

        result = TransactionResult(done=ready)
        cum_bytes = 0
        reads = self._prefetch_reads(txn)
        self._stage_begin(txn)
        try:
            for i, req in enumerate(txn.requests):
                nbytes = req.wire_bytes(self.direct_mode)
                ch.account(nbytes, f"htp:{req.op}")
                if req.category:
                    ch.bytes_by_cat[f"sys:{req.category}"] += nbytes
                self.stats.count(req.op, req.virtual)
                self.stats.controller_cycles += req.ctrl_cycles
                cum_bytes += nbytes
                arrive = wire_start + ch.ticks_for_bytes(cum_bytes)
                done = max(arrive, s.ctrl_free) + req.ctrl_cycles
                s.ctrl_free = done
                result.ticks.append(done)
                result.values.append(self._apply(req, done, reads, i))
        finally:
            self._stage_end()
        self._wire_free = wire_start + ch.ticks_for_bytes(cum_bytes)
        ch.busy_until = max(ch.busy_until, self._wire_free)
        self.stats.uart_ticks += max(0, self._wire_free - ready)
        result.done = result.ticks[-1] if result.ticks else ready
        self._inflight.append(result.done)
        self.cqstats.max_inflight = max(self.cqstats.max_inflight,
                                        len(self._inflight))
        return result, ready, wire_start
