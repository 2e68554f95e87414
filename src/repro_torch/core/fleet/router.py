"""FleetRouter: the session-shaped routing front end over N queue pairs.

The single-device engine keys submission streams by hart index (plus
named streams like ``"serve"``).  The fleet re-keys them as
``(device, hart)``: a :class:`FleetRouter` presents the same
``submit(txn, at, stream=, deps=)`` surface as an
:class:`~repro_torch.core.cq.AsyncHtpSession` and forwards each transaction to
the *owning device's* queue pair with the local stream key.  Routing adds
no modelled time — devices are independent boards with independent links,
so nothing serialises across them except explicit dependency tokens
(token ticks are plain modelled time, shared fleet-wide).

Stream keys:
  * ``(device_id, local)`` — routed to ``device_id``, submitted on its
    stream ``local`` (a hart index or a name like ``"serve"``);
  * anything else          — shorthand for the first device (so a
    one-device router is a drop-in, tick-identical session).
"""
from __future__ import annotations

from ..cq import AsyncHtpSession
from .device import Device


class FleetRouter:
    """Route transactions to per-device queue pairs by (device, hart)."""

    def __init__(self, devices: list[Device]):
        assert devices, "a fleet needs at least one device"
        self.devices = {d.id: d for d in devices}
        assert len(self.devices) == len(devices), "duplicate device ids"
        self._first = devices[0].id

    # -- stream keying ---------------------------------------------------
    def split_stream(self, stream):
        """``(device, local)`` pairs route; bare (non-pair) keys mean the
        first device.  A pair naming an unknown device is a routing bug
        — silently landing it on another board would mis-attribute its
        timing and traffic — so it raises."""
        if isinstance(stream, tuple) and len(stream) == 2:
            if stream[0] not in self.devices:
                raise KeyError(f"unknown device {stream[0]!r} in stream "
                               f"key {stream!r} (have "
                               f"{sorted(map(repr, self.devices))})")
            return stream
        return self._first, stream

    # -- session surface -------------------------------------------------
    def submit(self, txn, at: int, stream=0, deps: tuple = ()):
        dev_id, local = self.split_stream(stream)
        return self.devices[dev_id].session.submit(txn, at, stream=local,
                                                   deps=deps)

    def stream(self, device_id, local):
        """The owning device's SubmissionStream for ``(device, hart)``."""
        return self.devices[device_id].session.stream(local)

    def tail_tokens(self) -> tuple:
        """Last token of every stream on every device — a fleet-wide
        barrier when passed as ``deps``.  Read-only: devices without a
        live queue pair are skipped, never provisioned."""
        toks = []
        for d in self.devices.values():
            if d.provisioned and isinstance(d.session, AsyncHtpSession):
                toks.extend(d.session.tail_tokens())
        return tuple(toks)

    def quiesce_tick(self) -> int:
        """Tick by which every device's every submission has completed."""
        t = 0
        for d in self.devices.values():
            if not d.provisioned:
                continue
            sess = d.session
            if isinstance(sess, AsyncHtpSession):
                t = max(t, sess.quiesce_tick())
            else:
                t = max(t, sess.channel.busy_until)
        return t

    # -- aggregation -------------------------------------------------------
    def stats(self) -> dict:
        """Fleet-wide traffic/engine counters + a per-device breakdown.

        Counts retired queue pairs (folded into ``DeviceStats``) plus
        each device's live session, without provisioning anything — so
        it is accurate on a finished fleet (``FleetRuntime.run()``
        retires every pair) and on a live-routed one alike."""
        total_bytes = 0
        transactions = 0
        by_cat: dict = {}
        per_device = {}
        for d in self.devices.values():
            c = d.counters()
            busy_until = 0
            cq = {}
            if d.provisioned:
                sess = d.session
                busy_until = sess.channel.busy_until
                if isinstance(sess, AsyncHtpSession):
                    cq = sess.cqstats.as_dict()
            total_bytes += c.wire_bytes
            transactions += c.transactions
            for cat, n in c.bytes_by_cat.items():
                by_cat[cat] = by_cat.get(cat, 0) + n
            per_device[d.id] = dict(
                link=d.link, transactions=c.transactions,
                wire_bytes=c.wire_bytes, busy_until=busy_until, cq=cq)
        return dict(devices=len(self.devices), transactions=transactions,
                    total_bytes=total_bytes, bytes_by_cat=by_cat,
                    per_device=per_device)
