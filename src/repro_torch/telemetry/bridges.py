"""The two out-of-band telemetry bridges and their hub.

Both bridges follow the same discipline: harvest target-side state
**host-side at chunk boundaries** with bundled reads (one
``fetch_batch`` / one ``trace_drain`` device sync per drain step, never
per-element round trips), package it into fixed HTP telemetry frames
(``CtrSample`` / ``TraceB``), and emit the frames on the session's
:class:`~repro_torch.telemetry.stream.TelemStream`.

Backpressure is FIFO-stall, like the hardware being modelled: a bridge
whose lane backlog exceeds budget **holds its data where it is** — the
counter bridge defers the sample to the next pump, the commit-trace
bridge leaves records in the target ring and drains only what the lane
will take (``trace_drain(limit=...)``).  Nothing submitted is silently
discarded; the only loss is the ring overwriting records a stalled
bridge could not drain in time, accounted per record as
``ring_dropped`` — exactly a real TracerV's failure mode.  Stall time
and any residual drops are attributed per bridge in
``TelemStream.report()["per_bridge"]``.

Capture can be *windowed* by a :class:`~repro_torch.telemetry.triggers.\
TriggerSelector`: the commit-trace ring only records retirements inside
the trigger window (enforced at the retire point on both backends via
``Target.trace_trigger``), and the counter bridge's periodic sampling
pauses while the window is closed (``host_gate``; forced final samples
bypass the gate).

Counter taxonomy (``htp.TELEM_COUNTERS`` frame order):

  * **architectural** — ``instret``, ``uticks``, ``stall_ticks``,
    ``trace_n``: bit-identical between PySim and the tensor target
    (pinned by ``tests/test_torch_telemetry.py``);
  * **backend model** — ``fetch_hits`` (the tensor target's fetch-block
    cache; 0 on PySim) and ``tlb_walks`` (each backend's own data-TLB
    walks: PySim's host-side TLB, the tensor target's chunk-local one);
  * **host-known link/session counters** — appended to each sample
    from ``SessionStats``/channel accounting at zero wire cost (the
    host already owns them).
"""
from __future__ import annotations

from ..core import htp
from ..core.session import HtpTransaction
from .stream import TelemStream
from .triggers import TriggerSelector


def _as_selector(trigger) -> TriggerSelector | None:
    if trigger is None or isinstance(trigger, TriggerSelector):
        return trigger
    return TriggerSelector(tuple(trigger))


#: the backend model counters of a counter sample: each backend's own
#: caches, so the one part of a report that differs between backends
BACKEND_COUNTERS = ("fetch_hits", "tlb_walks")


def without_backend_counters(report: dict) -> dict:
    """A copy of a :meth:`TelemetryHub.report` with the backend model
    counters of every counter sample set to None; every other field is
    modelled, so it equals the same run's report on any backend."""
    import copy
    out = copy.deepcopy(report)
    for sample in out.get("counters", {}).get("samples", []):
        for core in sample["cores"]:
            for k in BACKEND_COUNTERS:
                core[k] = None
    return out


class CounterBridge:
    """Periodic per-hart performance-counter samples.

    ``pump(now)`` emits at most one sample per call, and only once
    ``interval_ticks`` have elapsed since the previous one — sampling
    happens at chunk boundaries, so the interval is a floor, not an
    exact period.  Each sample is one transaction (Tick + CtrSample per
    hart) on the telem lane.  A sample the lane cannot take is
    *deferred* (FIFO stall — retried at the next pump, counted in
    ``deferred_samples``), and sampling pauses while a configured
    trigger window is closed (``gated_samples``).
    """

    NAME = "counters"

    def __init__(self, stream: TelemStream, interval_ticks: int = 100_000,
                 trigger=None):
        assert interval_ticks > 0
        self.stream = stream
        self.interval = interval_ticks
        self.trigger = _as_selector(trigger)
        self.next_due = 0
        self.samples: list[dict] = []
        self.dropped_samples = 0
        self.deferred_samples = 0
        self.gated_samples = 0

    def pump(self, now: int, force: bool = False):
        if not force and now < self.next_due:
            return
        sess = self.stream.session
        if not force and self.trigger is not None and \
                not self.trigger.host_gate(sess.t, now):
            self.gated_samples += 1
            self.next_due = now + self.interval
            return
        if not force and not self.stream.accepts(now):
            # FIFO stall: hold this sample slot and retry next pump —
            # the sample is delayed, never lost
            self.stream.note_stall(self.NAME, now)
            self.deferred_samples += 1
            return
        self.next_due = now + self.interval
        nc = sess.t.n_cores
        txn = HtpTransaction().tick()
        for c in range(nc):
            txn.ctr_sample(c)
        res = self.stream.submit(txn, now, bridge=self.NAME, force=force)
        if res is None:
            self.dropped_samples += 1
            return
        ch = sess.channel
        sample = {
            "at": now,
            "delivered": res.done,
            "tick": res.values[0],
            "cores": [dict(zip(htp.TELEM_COUNTERS, res.values[1 + c]))
                      for c in range(nc)],
            "session": {
                "transactions": sess.stats.transactions,
                "controller_cycles": sess.stats.controller_cycles,
                "link_ticks": sess.stats.uart_ticks,
                "wire_bytes": ch.total_bytes,
            },
        }
        # fabric-attached device (repro_torch.core.net): the board's switch
        # port counters are host-known state like SessionStats — zero
        # wire cost, per-port link_util / credit_stalls in every sample
        nic = getattr(sess, "nic", None)
        if nic is not None:
            sample["nic"] = nic.port.counters(horizon=now)
        self.samples.append(sample)
        # observability→control: fold the fresh sample into the owning
        # fleet device's online load estimate, if the session has one
        dev = getattr(sess, "device", None)
        if dev is not None and getattr(dev, "load", None) is not None:
            dev.load.note_sample(sample)

    def report(self) -> dict:
        return {
            "interval_ticks": self.interval,
            "samples": self.samples,
            "dropped_samples": self.dropped_samples,
            "deferred_samples": self.deferred_samples,
            "gated_samples": self.gated_samples,
        }


class CommitTraceBridge:
    """Per-hart commit-trace capture, streamed through the lane.

    Arms the target's bounded ring (``trace_arm``) and, when a trigger
    is configured, installs its capture window (``trace_trigger``).
    Each ``pump`` drains **only as many records as the telem lane will
    accept** (a per-hart ``trace_drain(limit=...)`` sized from the
    lane's remaining backlog budget) and ships them as fixed
    ``htp.TRACE_FRAME_RECORDS``-record ``TraceB`` frames.  When the
    lane is saturated the bridge FIFO *stalls*: records stay in the
    target ring and the pump retries later — the ring overwriting
    records the stalled bridge could not drain is the only loss, and it
    is counted per record (``ring_dropped``), identically on both
    backends.  ``frame_dropped`` remains as the legacy last-resort
    counter; under the budgeted drain it stays 0.
    """

    NAME = "commit_trace"

    def __init__(self, stream: TelemStream, slots: int = 4096,
                 trigger=None):
        self.stream = stream
        self.slots = slots
        self.trigger = _as_selector(trigger)
        t = stream.session.t
        t.trace_arm(slots)
        if self.trigger is not None:
            t.trace_trigger(self.trigger.spec())
        nc = t.n_cores
        self.records: list[list] = [[] for _ in range(nc)]
        self.ring_dropped = [0] * nc
        self.frame_dropped = [0] * nc
        self.stalled_pumps = 0
        self._frame_cost = None       # lane ticks per TraceB frame

    def rearm(self):
        """Re-arm capture on the (new) target behind the stream's
        session — a migrated job's restored target starts unarmed."""
        t = self.stream.session.t
        t.trace_arm(self.slots)
        if self.trigger is not None:
            t.trace_trigger(self.trigger.spec())
        self._frame_cost = None       # the link may have changed

    def _frame_budget(self, now: int) -> int | None:
        """How many TraceB frames the lane accepts from ``now`` before
        its backlog budget trips (``None`` = unlimited).  Exact for the
        sequential submits below: frame *j* starts at backlog
        ``backlog(now) + j * frame_cost``."""
        s = self.stream
        if s.max_backlog_ticks is None:
            return None
        if self._frame_cost is None:
            txn = HtpTransaction().trace_burst(0)
            self._frame_cost = s.session.channel.latency_ticks + \
                s.ticks_for_bytes(txn.wire_bytes())
        if self._frame_cost <= 0:
            return None
        room = s.max_backlog_ticks - s.backlog(now)
        return 0 if room < 0 else room // self._frame_cost + 1

    def pump(self, now: int, force: bool = False):
        per = htp.TRACE_FRAME_RECORDS
        s = self.stream
        t = s.session.t
        if force or s.max_backlog_ticks is None:
            # lossless lane / final flush: one bundled drain, every
            # frame queues behind any backlog instead of dropping
            for c, (recs, dropped) in enumerate(t.trace_drain()):
                self.ring_dropped[c] += dropped
                self._ship(c, recs, now, force=True)
            return
        if not s.accepts(now):
            # bridge FIFO stall: leave every record in the target ring
            s.note_stall(self.NAME, now)
            self.stalled_pumps += 1
            return
        for c in range(t.n_cores):
            budget = self._frame_budget(now)
            if budget is not None and budget <= 0:
                s.note_stall(self.NAME, now)
                self.stalled_pumps += 1
                break
            limit = None if budget is None else budget * per
            recs, dropped = t.trace_drain(c, limit=limit)
            self.ring_dropped[c] += dropped
            self._ship(c, recs, now)

    def _ship(self, c: int, recs: list, now: int, force: bool = False):
        per = htp.TRACE_FRAME_RECORDS
        for i in range(0, len(recs), per):
            frame = recs[i:i + per]
            txn = HtpTransaction().trace_burst(c)
            res = self.stream.submit(txn, now, values=[tuple(frame)],
                                     bridge=self.NAME, force=force)
            if res is None:           # unreachable under a budgeted drain
                self.frame_dropped[c] += len(frame)
            else:
                self.records[c].extend(frame)

    def report(self) -> dict:
        return {
            "slots": self.slots,
            "records": [len(r) for r in self.records],
            "ring_dropped": list(self.ring_dropped),
            "frame_dropped": list(self.frame_dropped),
            "stalled_pumps": self.stalled_pumps,
            "trigger": None if self.trigger is None
            else list(self.trigger.spec()),
        }


class TelemetryHub:
    """Both bridges behind one pump/finish/report surface.

    Built by :class:`repro_torch.core.runtime.FaseRuntime` from its
    ``telemetry=`` kwarg (a kwargs dict, or a ready hub); the runtime
    pumps it after every target chunk and flushes it in ``finish`` —
    so a drained record can never straddle a snapshot (the ring is not
    checkpoint state).  ``trigger`` (a :class:`TriggerSelector` or raw
    spec tuple) windows capture on both bridges.
    """

    def __init__(self, session, counters: bool = True,
                 commit_trace: bool = False,
                 interval_ticks: int = 100_000,
                 bandwidth_frac: float = 0.1,
                 trace_slots: int = 4096,
                 backlog_ticks: int | None = 1 << 20,
                 trigger=None):
        trigger = _as_selector(trigger)
        self.stream = TelemStream(session, bandwidth_frac, backlog_ticks)
        self.counters = CounterBridge(self.stream, interval_ticks,
                                      trigger=trigger) \
            if counters else None
        self.commit = CommitTraceBridge(self.stream, trace_slots,
                                        trigger=trigger) \
            if commit_trace else None

    def pump(self, now: int):
        if self.counters is not None:
            self.counters.pump(now)
        if self.commit is not None:
            self.commit.pump(now)

    def finish(self, now: int):
        """Final flush: one forced counter sample + a forced last ring
        drain (frames queue behind any backlog — delayed, not lost)."""
        if self.counters is not None:
            self.counters.pump(now, force=True)
        if self.commit is not None:
            self.commit.pump(now, force=True)

    def rebind(self, session):
        """Follow a runtime retarget (job migration) onto the new
        session; commit capture re-arms on the new target."""
        self.stream.rebind(session)
        if self.commit is not None:
            self.commit.rearm()

    def report(self) -> dict:
        rep = {"stream": self.stream.report()}
        if self.counters is not None:
            rep["counters"] = self.counters.report()
        if self.commit is not None:
            rep["commit_trace"] = self.commit.report()
        return rep
