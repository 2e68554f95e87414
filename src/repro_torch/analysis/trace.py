"""Transaction trace capture for the HTP hazard analyzer.

:class:`~repro_torch.core.session.HtpSession` (and therefore the async
queue-pair engine and every fleet device) carries a ``trace`` attribute,
``None`` by default: the only cost of the hook when disabled is one
``is not None`` test per submitted transaction, so golden ticks and
wall-clock are untouched.  :func:`attach_trace` arms it — on a session,
or fleet-wide on a :class:`~repro_torch.core.fleet.FleetRouter` /
:class:`~repro_torch.core.fleet.FleetRuntime` (stream keys are then
namespaced ``(device_id, local)``, and devices re-attach automatically
when they re-provision a fresh queue pair).

What is recorded per submit is exactly what the happens-before
reconstruction needs and nothing more:

  * the **ordering domain** the engine really used: the submission
    stream key on a pipelined channel, or a single per-session serial
    domain when the engine delegated to the synchronous arithmetic
    (UART / oracle / disabled links serialise every transaction on one
    wire, so distinct stream keys are *not* concurrent there);
  * the dependency tokens (by identity — token objects are retained, so
    cross-session deps in a fleet resolve unambiguously);
  * the submit tick after dependency resolution (``ready``) and the
    modelled completion tick (``done``) — the analyzer's optional
    modelled-time fence;
  * per request: opcode, hart, the footprint's key scalars
    (:func:`repro_torch.analysis.footprints.key_args` — bulk payloads are
    never retained), and the ``virtual`` flag.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from . import footprints

#: ordering-domain key used for transactions the engine executed with
#: the synchronous (serial-wire) arithmetic
SERIAL_DOMAIN = "__serial__"


def _trace_kargs(r) -> tuple:
    """Footprint-relevant scalars of one live request.  Virtual
    Redirect/SetMMU analogues footprint at slot granularity and may
    carry bulk args (a whole block-table row), so nothing is kept."""
    if r.virtual and r.op in ("Redirect", "SetMMU"):
        return ()
    return footprints.key_args(r.op, r.args)


@dataclass(frozen=True)
class TraceRequest:
    """One request of a traced transaction (payload-free)."""

    op: str
    cpu: int
    kargs: tuple
    virtual: bool = False

    def footprint(self):
        return footprints.footprint(self.op, self.cpu, self.kargs,
                                    self.virtual)


@dataclass
class TraceEvent:
    """One submitted transaction as the analyzer sees it."""

    eid: int                      # global record order (host order)
    stream: object                # ordering-domain key (device-prefixed)
    seq: int                      # position within the domain (0-based)
    at: int                       # caller's submit tick
    ready: int                    # after dependency resolution
    done: int                     # modelled completion tick
    requests: tuple               # TraceRequest, in order
    token_id: int | None          # id() of the completion token
    dep_ids: tuple                # id() of each dependency token
    dep_ticks: tuple              # their ticks (unresolvable deps still
                                  # order by modelled time)
    device: object = None         # owning device in a fleet trace —
                                  # physical locations are per-board
    advisory: bool = False        # reads may race (live pre-copy: a
                                  # later fenced capture supersedes them)

    def __repr__(self):
        ops = ",".join(r.op for r in self.requests[:4])
        if len(self.requests) > 4:
            ops += f",+{len(self.requests) - 4}"
        return (f"<evt {self.eid} {self.stream}#{self.seq} "
                f"[{ops}] @{self.ready}->{self.done}>")


class HtpTrace:
    """An append-only record of submitted transactions, possibly fed by
    several sessions (a fleet).  Token objects are retained so ``id()``
    keys stay stable for the trace's lifetime."""

    def __init__(self):
        self.events: list[TraceEvent] = []
        self._seq: dict = {}          # domain key -> next seq
        self._tokens: list = []       # keep token objects alive

    def __len__(self):
        return len(self.events)

    def record(self, stream, txn, deps: tuple, at: int, ready: int,
               result, device=None, advisory: bool = False) -> TraceEvent:
        reqs = tuple(
            TraceRequest(r.op, r.cpu, _trace_kargs(r), r.virtual)
            for r in txn.requests)
        dep_ids, dep_ticks = [], []
        for d in deps:
            if d is None:
                continue
            dep_ids.append(id(d))
            dep_ticks.append(d.tick)
            self._tokens.append(d)
        token = getattr(result, "token", None)
        if token is not None:
            self._tokens.append(token)
        seq = self._seq.get(stream, 0)
        self._seq[stream] = seq + 1
        ev = TraceEvent(len(self.events), stream, seq, at, ready,
                        result.done, reqs,
                        None if token is None else id(token),
                        tuple(dep_ids), tuple(dep_ticks),
                        device=device, advisory=advisory)
        self.events.append(ev)
        return ev

    def streams(self) -> list:
        return list(self._seq)


class TraceRecorder:
    """Per-session feed into a (possibly shared) :class:`HtpTrace`.

    Maps the session's local stream keys into the trace's ordering
    domains: a serial-arithmetic session collapses every key onto one
    :data:`SERIAL_DOMAIN` chain; a fleet recorder prefixes the owning
    device id so two boards' hart-0 streams stay distinct.
    """

    def __init__(self, trace: HtpTrace, serial: bool, device=None):
        self.trace = trace
        self.serial = serial
        self.device = device
        # armed by snapshot.capture(advisory=True) around a live
        # pre-copy: the capture's reads are allowed to race traffic the
        # job submits afterwards — a later fenced capture supersedes
        # every value read here (pages by PageH divergence, core state
        # wholesale)
        self.advisory = False

    def domain(self, stream):
        key = SERIAL_DOMAIN if self.serial else stream
        if self.device is not None:
            return (self.device, key)
        return key

    def on_submit(self, stream, txn, deps, at, ready, result):
        self.trace.record(self.domain(stream), txn, deps, at, ready,
                          result, device=self.device,
                          advisory=self.advisory)


def session_is_serial(session) -> bool:
    """Did/will this session use the synchronous (one-wire-serialised)
    arithmetic for every submit?  Mirrors the dispatch in
    :meth:`repro_torch.core.cq.AsyncHtpSession.submit`."""
    from ..core.cq import AsyncHtpSession   # local: avoid import cycle
    ch = session.channel
    return not isinstance(session, AsyncHtpSession) or \
        not (ch.enabled and ch.pipelined)


def attach_trace(obj, trace: HtpTrace | None = None) -> HtpTrace:
    """Arm the trace hook on a session, a FleetRouter, or a
    FleetRuntime; returns the (new or shared) :class:`HtpTrace`.

    Fleet attachment also arms each :class:`~repro_torch.core.fleet.Device`,
    so queue pairs provisioned *later* (per-job re-imaging, migration
    destinations) feed the same trace automatically.
    """
    trace = trace if trace is not None else HtpTrace()
    devices = None
    if hasattr(obj, "devices"):           # FleetRouter / FleetRuntime
        devices = obj.devices.values() if isinstance(obj.devices, dict) \
            else obj.devices
    if devices is not None:
        for d in devices:
            d.trace = trace               # provision() re-attaches
            if d.provisioned:
                d.session.trace = TraceRecorder(
                    trace, session_is_serial(d.session), device=d.id)
        return trace
    obj.trace = TraceRecorder(trace, session_is_serial(obj))
    return trace
