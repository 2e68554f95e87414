"""Modelled inter-board switch fabric + gang-scheduled multi-board jobs.

  * :mod:`.fabric` — the token/flit :class:`Switch` (per-port bandwidth
    and latency, credit-based flow control, per-port utilisation
    counters);
  * :mod:`.nic` — :class:`NicEndpoint`, one fleet device's fabric
    attachment, carrying cross-device pages / hfutex wakes / TLB
    shootdowns as timed, token-fenced transactions off the host link;
  * :mod:`.gang` — :class:`GangJob` bulk-synchronous execution across
    adjacent ports, fabric-gated resume, whole-gang migration.
"""
from .fabric import CreditState, Flit, Port, Switch
from .gang import (GangJob, GangReport, RunningGang, migrate_gang,
                   place_gang, run_gang)
from .nic import NIC_STREAM, NicEndpoint

__all__ = [
    "CreditState", "Flit", "GangJob", "GangReport", "NIC_STREAM",
    "NicEndpoint", "Port", "RunningGang", "Switch", "migrate_gang",
    "place_gang", "run_gang",
]
