"""Modelled inter-board switch fabric (ROADMAP item 2).

A FireSim-style *token/flit* switch: every NIC frame is segmented into
fixed-size flits, each flit is serialised on the source port at that
port's bandwidth, propagates through the crossbar with a fixed latency,
and is drained into the destination port's ingress buffer at *its*
bandwidth.  Flow control is credit-based: the receiver grants the sender
one credit per ingress-buffer slot; a flit may only be injected while a
credit is free, and the credit returns when the receiver drains the flit.
A slow or congested receiver therefore back-pressures the sender —
counted per port as ``credit_stalls`` — instead of dropping traffic (the
fabric is lossless).

Timing is pure modelled target time, computed host-side from integer
arithmetic: the fabric never touches a session channel's occupancy or
byte counters, so a fleet with an attached-but-idle switch is
tick-identical to one without (the switch-disabled identity contract in
``tests/test_net.py``).

Per-port counters (``Port.counters``) feed the telemetry satellite:
``link_util`` (serialisation ticks / horizon) and ``credit_stalls``
surface through :class:`repro_torch.telemetry.bridges.CounterBridge`
samples and the per-port rows of ``benchmarks/stall_attribution.py``.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

from ..consts import CLOCK_HZ


@dataclass(frozen=True)
class Flit:
    """One fabric token: ``nbytes`` of one frame, in frame order."""

    seq: int           # flit index within its frame
    nbytes: int        # payload bytes carried (<= flit_bytes)
    kind: str = "data"  # "data" | "ctl" — accounting label only


class CreditState:
    """Receiver-granted flit credits of one port's ingress buffer.

    ``acquire(at)`` returns the earliest tick at which a credit is free
    (possibly ``at`` itself), accumulating the stall; ``hold(release)``
    pins one credit until the receiver drains the flit at ``release``.
    """

    def __init__(self, credits: int):
        assert credits >= 1, "credit-based flow control needs >=1 credit"
        self.credits = credits
        self._outstanding: list[int] = []   # heap of release ticks
        self.stalls = 0                     # flits that had to wait
        self.stall_ticks = 0                # total ticks spent waiting

    def acquire(self, at: int) -> int:
        if len(self._outstanding) < self.credits:
            return at
        free = heapq.heappop(self._outstanding)
        if free > at:
            self.stalls += 1
            self.stall_ticks += free - at
            return free
        return at

    def hold(self, release: int) -> None:
        heapq.heappush(self._outstanding, release)

    @property
    def in_flight(self) -> int:
        return len(self._outstanding)


class Port:
    """One switch port: an attachment point with its own bandwidth,
    egress/ingress occupancy clocks, ingress credits, and counters."""

    def __init__(self, port_id: int, label: str = "",
                 gbits_per_s: float = 16.0, flit_bytes: int = 64,
                 credits: int = 8, clock_hz: int = CLOCK_HZ):
        self.id = port_id
        self.label = label or str(port_id)
        self.gbits_per_s = gbits_per_s
        self.flit_bytes = flit_bytes
        self.clock_hz = clock_hz
        self.credit = CreditState(credits)
        self.tx_busy = 0          # egress lane free tick
        self.rx_busy = 0          # ingress drain free tick
        # counters
        self.tx_bytes = 0
        self.rx_bytes = 0
        self.tx_flits = 0
        self.rx_flits = 0
        self.frames_tx = 0
        self.frames_rx = 0
        self.busy_ticks = 0       # accumulated egress serialisation time
        self.credit_stall_ticks = 0   # egress stalls waiting on dst credits
        self.credit_stalls = 0

    def ticks_for_bytes(self, nbytes: int) -> int:
        """Serialisation ticks for ``nbytes`` at this port's bandwidth
        (ceil — same arithmetic as :class:`~..channel.PcieChannel`)."""
        return int(-(-nbytes * 8 * self.clock_hz //
                     int(self.gbits_per_s * 1e9)))

    @property
    def flit_ticks(self) -> int:
        return max(1, self.ticks_for_bytes(self.flit_bytes))

    def counters(self, horizon: int | None = None) -> dict:
        """Per-port telemetry row (CounterBridge / stall_attribution)."""
        out = {
            "port": self.id, "label": self.label,
            "gbits_per_s": self.gbits_per_s,
            "tx_bytes": self.tx_bytes, "rx_bytes": self.rx_bytes,
            "tx_flits": self.tx_flits, "rx_flits": self.rx_flits,
            "frames_tx": self.frames_tx, "frames_rx": self.frames_rx,
            "busy_ticks": self.busy_ticks,
            "credit_stalls": self.credit_stalls,
            "credit_stall_ticks": self.credit_stall_ticks,
        }
        if horizon:
            out["link_util"] = self.busy_ticks / max(1, horizon)
        return out


class Switch:
    """The crossbar: connect endpoints to ports, move frames as flits.

    ``transfer`` is the whole data plane — it advances both ports'
    occupancy clocks and the receiver's credit state, and returns the
    tick at which the frame's last flit has fully drained into the
    destination ingress buffer (= frame delivery tick).
    """

    def __init__(self, gbits_per_s: float = 16.0, latency_ticks: int = 500,
                 flit_bytes: int = 64, header_bytes: int = 16,
                 credits: int = 8, clock_hz: int = CLOCK_HZ):
        self.gbits_per_s = gbits_per_s
        self.latency_ticks = latency_ticks
        self.flit_bytes = flit_bytes
        self.header_bytes = header_bytes
        self.credits = credits
        self.clock_hz = clock_hz
        self.ports: list[Port] = []
        self.frames = 0
        self.total_bytes = 0

    # -- control plane --------------------------------------------------
    def connect(self, label: str = "", gbits_per_s: float | None = None,
                credits: int | None = None) -> Port:
        """Attach one endpoint; consecutive calls get *adjacent* ports
        (gang placement keys on this ordering)."""
        p = Port(len(self.ports), label,
                 gbits_per_s=self.gbits_per_s if gbits_per_s is None
                 else gbits_per_s,
                 flit_bytes=self.flit_bytes,
                 credits=self.credits if credits is None else credits,
                 clock_hz=self.clock_hz)
        self.ports.append(p)
        return p

    def adjacent(self, a: Port, b: Port) -> bool:
        return abs(a.id - b.id) == 1

    # -- data plane ------------------------------------------------------
    def flits_of(self, nbytes: int, kind: str = "data") -> list[Flit]:
        """Segment one frame (payload + per-frame header) into flits."""
        total = nbytes + self.header_bytes
        n = max(1, -(-total // self.flit_bytes))
        sizes = [self.flit_bytes] * (n - 1) + \
            [total - self.flit_bytes * (n - 1)]
        return [Flit(i, sz, kind) for i, sz in enumerate(sizes)]

    def transfer(self, src: Port, dst: Port, nbytes: int, at: int,
                 kind: str = "data") -> int:
        """Move one ``nbytes`` frame ``src`` → ``dst`` starting no
        earlier than ``at``; returns the delivery tick."""
        assert src is not dst, "fabric loopback is not modelled"
        flits = self.flits_of(nbytes, kind)
        tx_ready = max(at, src.tx_busy)
        delivered = tx_ready
        for flit in flits:
            inject = dst.credit.acquire(tx_ready)      # wait for a credit
            if inject > tx_ready:
                src.credit_stalls += 1
                src.credit_stall_ticks += inject - tx_ready
            tx_done = inject + src.flit_ticks          # serialise on egress
            src.busy_ticks += src.flit_ticks
            arrive = tx_done + self.latency_ticks      # crossbar hop
            drain = max(arrive, dst.rx_busy) + dst.flit_ticks
            dst.rx_busy = drain
            dst.credit.hold(drain)                     # credit returns here
            tx_ready = tx_done
            delivered = drain
            src.tx_flits += 1
            dst.rx_flits += 1
            src.tx_bytes += flit.nbytes
            dst.rx_bytes += flit.nbytes
        src.tx_busy = tx_ready
        src.frames_tx += 1
        dst.frames_rx += 1
        self.frames += 1
        self.total_bytes += nbytes
        return delivered

    # -- reporting -------------------------------------------------------
    def report(self, horizon: int | None = None) -> dict:
        return {
            "gbits_per_s": self.gbits_per_s,
            "latency_ticks": self.latency_ticks,
            "flit_bytes": self.flit_bytes,
            "credits": self.credits,
            "frames": self.frames,
            "total_bytes": self.total_bytes,
            "ports": [p.counters(horizon) for p in self.ports],
        }
