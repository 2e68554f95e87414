"""NIC endpoint: one fleet device's attachment to the switch fabric.

A :class:`NicEndpoint` binds a :class:`~repro_torch.core.fleet.device.Device`
to one switch :class:`~.fabric.Port` and carries *cross-device* traffic
— shared-page transfers, remote hfutex wakes, cross-device TLB
shootdowns — as timed, token-fenced HTP transactions whose wire time is
charged on the fabric (flit serialisation + crossbar latency + credit
stalls), never on the device's host link.

The discipline mirrors the telemetry lane
(:class:`repro_torch.telemetry.stream.TelemStream`): NIC transactions apply
their functional effects through ``session._apply`` and are recorded in
the session's hazard trace under a dedicated always-concurrent ordering
domain (``"nic"``, device-prefixed in a fleet), but they never touch the
session channel's ``busy_until``/byte counters or ``SessionStats`` — a
fleet whose NICs are idle is tick-identical to a fleet without a fabric,
by construction.

Every frame completes with a :class:`~repro_torch.core.cq.CompletionToken` so
downstream transactions (the receiver's resume, a migration capture) can
token-fence against in-flight fabric traffic.
"""
from __future__ import annotations

from ..cq import CompletionToken
from ..session import HtpTransaction, TransactionResult

#: ordering-domain / stream key of the NIC lane
NIC_STREAM = "nic"


class NicEndpoint:
    """Fabric endpoint of one fleet device."""

    def __init__(self, device, switch, **port_opts):
        self.device = device
        self.switch = switch
        self.port = switch.connect(label=f"dev{device.id}", **port_opts)
        self.seq = 0
        self.frames_tx = 0
        self.frames_rx = 0
        self.bytes_by_op: dict[str, int] = {}
        #: completion token of the newest frame this endpoint touched
        #: (tx or rx) — the fence a gang migration captures against
        self.last_token: CompletionToken | None = None
        device.nic = self
        if getattr(device, "provisioned", False):
            device.session.nic = self   # a pair live before attachment

    # ------------------------------------------------------------------
    def _token(self, tick: int) -> CompletionToken:
        self.seq += 1
        tok = CompletionToken((self.device.id, NIC_STREAM), self.seq, tick)
        self.last_token = tok
        return tok

    def _record(self, txn, deps, at, ready, result):
        tr = self.device.session.trace
        if tr is not None:
            dom = NIC_STREAM if tr.device is None \
                else (tr.device, NIC_STREAM)
            tr.trace.record(dom, txn, deps, at, ready, result,
                            device=tr.device)

    def _account(self, txn):
        for r in txn.requests:
            self.bytes_by_op[r.op] = \
                self.bytes_by_op.get(r.op, 0) + r.wire_bytes()

    @staticmethod
    def _ready(at, deps):
        ready = at
        for dep in deps:
            if dep is not None:
                ready = max(ready, dep.tick)
        return ready

    # ------------------------------------------------------------------
    def transmit(self, dst: "NicEndpoint", txn: HtpTransaction, at: int,
                 deps: tuple = (), kind: str = "data"
                 ) -> TransactionResult:
        """Egress one frame onto the fabric towards ``dst``.

        The frame's wire size is the transaction's HTP framing; delivery
        is timed by :meth:`~.fabric.Switch.transfer` (source-port
        serialisation, credits of the destination ingress buffer,
        crossbar latency).  Requests apply on *this* device (a ``NicTx``
        reads the page out of local DRAM).  ``result.done`` is the frame
        delivery tick at ``dst``; the token fences anything that must
        wait for the frame to be off this board and on the far one.
        """
        ready = self._ready(at, deps)
        delivered = self.switch.transfer(self.port, dst.port,
                                         txn.wire_bytes(), ready, kind)
        sess = self.device.session
        values = [sess._apply(r, delivered) for r in txn.requests]
        result = TransactionResult(done=delivered,
                                   ticks=[delivered] * len(txn.requests),
                                   values=values)
        result.token = self._token(delivered)
        self.frames_tx += 1
        self._account(txn)
        self._record(txn, deps, at, ready, result)
        return result

    def deliver(self, txn: HtpTransaction, at: int, deps: tuple = ()
                ) -> TransactionResult:
        """Apply one delivered frame on this (receiving) endpoint: drain
        ingress pages into DRAM (``NicRx``), fire shootdown/wake rows
        (``FlushTLB``/``HFutex``) on the local harts.  ``deps`` must
        carry the transmit token — delivery cannot precede the frame."""
        ready = self._ready(at, deps)
        sess = self.device.session
        values = [sess._apply(r, ready) for r in txn.requests]
        result = TransactionResult(done=ready,
                                   ticks=[ready] * len(txn.requests),
                                   values=values)
        result.token = self._token(ready)
        self.frames_rx += 1
        self._account(txn)
        self._record(txn, deps, at, ready, result)
        return result

    # ------------------------------------------------------------------
    def push_pages(self, dst: "NicEndpoint", pairs, at: int,
                   deps: tuple = (), shootdown: tuple = (),
                   wake: tuple = ()) -> TransactionResult:
        """One complete cross-device exchange: ship pages
        ``[(src_ppn, dst_ppn), ...]`` from this board into ``dst``'s
        DRAM, then deliver TLB shootdowns to ``dst`` harts ``shootdown``
        and hfutex wake doorbells to harts ``wake`` — all carried on the
        fabric, token-fenced tx → rx.  Returns the delivery result on
        ``dst`` (its ``done`` is when the receiver may resume)."""
        tx = HtpTransaction()
        for src_ppn, _ in pairs:
            tx.nic_tx(0, src_ppn)
        for cpu in shootdown:
            tx.nic_ctl(cpu, "shootdown")
        for cpu in wake:
            tx.nic_ctl(cpu, "wake")
        res = self.transmit(dst, tx, at, deps)
        rx = HtpTransaction()
        for (_, dst_ppn), words in zip(pairs, res.values):
            rx.nic_rx(0, dst_ppn, words)
        for cpu in shootdown:
            rx.flush_tlb(cpu, "shootdown")
        for cpu in wake:
            rx.hfutex_update(cpu)
        return dst.deliver(rx, res.done, deps=(res.token,))

    # ------------------------------------------------------------------
    def report(self) -> dict:
        return {
            "device": self.device.id, "port": self.port.id,
            "frames_tx": self.frames_tx, "frames_rx": self.frames_rx,
            "bytes_by_op": dict(self.bytes_by_op),
        }
