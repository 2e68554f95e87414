"""The dedicated low-priority "telem" stream.

A :class:`TelemStream` is a side-band lane of one session's link: it
shares the channel's *rate model* (a telemetry byte takes
``1 / bandwidth_frac`` times the channel's per-byte time — the fraction
of link bandwidth provisioned for telemetry) but keeps its **own**
occupancy clock and its own byte counters.  It never touches

  * ``channel.busy_until`` / ``total_bytes`` / ``bytes_by_cat`` (the
    Layer-A/Layer-B wire accounting and the traffic pins),
  * ``SessionStats`` (Table IV stall decomposition, host billing),
  * the async engine's doorbell/wire state,

so arming telemetry cannot move a golden tick by construction — the
stream is *timed but non-perturbing*.

Backpressure is modelled FIFO-style, the way a real TracerV bridge
behaves: a bridge first asks :meth:`TelemStream.accepts` whether the
lane's backlog is within budget and, when it is not, **stalls** — it
leaves its records where they are (the target ring, the sampler's
deferral slot) and retries at the next pump, accruing ``stall_ticks``
via :meth:`note_stall`.  Loss then happens only where the hardware
loses data (ring overwrites, accounted per record by the bridge), never
by silently discarding a whole submitted frame.  The drop path in
:meth:`submit` remains as a last resort for callers that do not
pre-check, and every drop is now attributed: ``dropped_bytes`` rides
next to ``dropped_frames``, globally and per bridge.

Submitted frames are recorded into the session's hazard trace under a
dedicated always-live ordering domain (``"telem"``, device-prefixed in
a fleet) so the happens-before race detector sees telemetry reads
against ordinary traffic — the telem lane is genuinely concurrent even
on serial links, where ordinary transactions collapse onto the serial
domain.
"""
from __future__ import annotations

from math import ceil

from ..core.session import TransactionResult

#: ordering-domain / stream key of the telemetry lane
TELEM_STREAM = "telem"

#: per-bridge accounting template (see ``TelemStream.report()``)
_BRIDGE_KEYS = ("frames", "bytes", "dropped_frames", "dropped_bytes",
                "stall_ticks")


class TelemStream:
    """Side-band telemetry lane over one session's channel."""

    def __init__(self, session, bandwidth_frac: float = 0.1,
                 max_backlog_ticks: int | None = 1 << 20):
        assert 0.0 < bandwidth_frac <= 1.0
        assert session.t is not None, \
            "telemetry needs a live target behind the session"
        self.session = session
        self.bandwidth_frac = bandwidth_frac
        self.max_backlog_ticks = max_backlog_ticks  # None = lossless
        self.busy_until = 0
        self.frames = 0
        self.dropped_frames = 0
        self.dropped_bytes = 0
        self.stall_ticks = 0
        self.bytes_total = 0
        self.bytes_by_op: dict = {}
        self.per_bridge: dict[str, dict] = {}

    def rebind(self, session):
        """Follow the runtime onto a new session (job migration); the
        lane's occupancy clock and counters carry over."""
        assert session.t is not None
        self.session = session

    def _bridge(self, name: str | None) -> dict:
        key = name or "anon"
        b = self.per_bridge.get(key)
        if b is None:
            b = self.per_bridge[key] = dict.fromkeys(_BRIDGE_KEYS, 0)
        return b

    def ticks_for_bytes(self, nbytes: int) -> int:
        """Wire time of a telemetry payload on this lane: the channel's
        rate scaled down to the telemetry bandwidth fraction."""
        ch = self.session.channel
        if not ch.enabled:
            return 0
        return ceil(ch.ticks_for_bytes(nbytes) / self.bandwidth_frac)

    def backlog(self, at: int) -> int:
        """Ticks of queued lane occupancy ahead of a frame submitted
        at tick ``at``."""
        return max(0, self.busy_until - at)

    def accepts(self, at: int) -> bool:
        """Whether the lane would take a frame at tick ``at`` without
        tripping the backlog budget — bridges poll this and *stall*
        (retain records, retry next pump) when it is ``False``."""
        return self.max_backlog_ticks is None or \
            self.backlog(at) <= self.max_backlog_ticks

    def note_stall(self, bridge: str, at: int):
        """Account one bridge FIFO stall at tick ``at``: the bridge had
        records ready but the lane's backlog exceeded budget, so it
        held them.  Accrues the current backlog as stall time."""
        stalled = self.backlog(at)
        self.stall_ticks += stalled
        self._bridge(bridge)["stall_ticks"] += stalled

    def submit(self, txn, at: int, values: list | None = None,
               bridge: str | None = None, force: bool = False):
        """Emit one telemetry frame transaction at tick ``at``.

        Returns a :class:`TransactionResult` (completion tick on the
        telem lane + per-request values), or ``None`` if the frame was
        dropped by backpressure.  ``values`` pre-fills the per-request
        responses (the commit-trace bridge drains host-side and ships
        frames already filled); when omitted each request is applied
        through the session's normal device half.  ``bridge`` names the
        submitter for per-bridge accounting; ``force=True`` queues the
        frame behind any backlog instead of dropping it (final-flush
        frames wait out the FIFO rather than vanish).
        """
        nbytes = txn.wire_bytes()
        acct = self._bridge(bridge)
        start = max(at, self.busy_until)
        if not force and not self.accepts(at):
            self.dropped_frames += 1
            self.dropped_bytes += nbytes
            acct["dropped_frames"] += 1
            acct["dropped_bytes"] += nbytes
            return None
        ch = self.session.channel
        done = start + ch.latency_ticks + self.ticks_for_bytes(nbytes)
        self.busy_until = done
        self.frames += 1
        self.bytes_total += nbytes
        acct["frames"] += 1
        acct["bytes"] += nbytes
        if values is None:
            values = [self.session._apply(r, done) for r in txn.requests]
        for r in txn.requests:
            self.bytes_by_op[r.op] = \
                self.bytes_by_op.get(r.op, 0) + r.wire_bytes()
        result = TransactionResult(done=done,
                                   ticks=[done] * len(txn.requests),
                                   values=list(values))
        tr = self.session.trace
        if tr is not None:
            dom = TELEM_STREAM if tr.device is None \
                else (tr.device, TELEM_STREAM)
            tr.trace.record(dom, txn, (), at, start, result,
                            device=tr.device)
        return result

    def report(self) -> dict:
        return {
            "bandwidth_frac": self.bandwidth_frac,
            "frames": self.frames,
            "dropped_frames": self.dropped_frames,
            "dropped_bytes": self.dropped_bytes,
            "stall_ticks": self.stall_ticks,
            "bytes": self.bytes_total,
            "bytes_by_op": dict(self.bytes_by_op),
            "per_bridge": {k: dict(v)
                           for k, v in sorted(self.per_bridge.items())},
            "busy_until": self.busy_until,
        }
