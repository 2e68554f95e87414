"""Pluggable host<->target link models behind the :class:`Channel` ABC.

The link is the FASE bottleneck the paper analyses: every HTP request's
bytes serialise through it, and its occupancy is tracked in *target ticks*
(100 MHz) so stall times compose directly with the jitted target's clock.
Three backends are provided, selected by name through :func:`make_channel`
(and from ``FaseRuntime(link=...)``):

  * ``uart``   — the paper's 921600-bps 8N2 UART (Table III): pure
    serialisation time, no per-transaction latency;
  * ``pcie``   — a modelled PCIe/AXI-DMA link: high bandwidth but a fixed
    per-*transaction* setup latency, which is why the
    :class:`~repro_torch.core.session.HtpSession` transaction batching matters
    (one latency per batch instead of one per request);
  * ``oracle`` — a zero-time link for full-system-reference timing runs
    (bytes are still accounted so traffic composition is always
    reported).

A channel models *occupancy only*: ``begin``/``end`` bracket one
transaction's wire time and advance ``busy_until``; per-category byte
counters reproduce the paper's traffic-composition figures (Fig 13,
Fig 16, Fig 17).  The legacy single-request ``send`` API is kept as a
one-request transaction.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from collections import defaultdict

from .consts import CLOCK_HZ

BITS_PER_BYTE_8N2 = 11  # 1 start + 8 data + 2 stop


class Channel(ABC):
    """Occupancy + accounting model of one host<->target link."""

    name = "channel"
    #: True when the link's per-transaction setup latency can overlap with
    #: other transactions' wire time (descriptor rings / doorbells).  The
    #: :class:`~repro_torch.core.cq.AsyncHtpSession` only engages its pipelined
    #: engine on such links; serial links (UART) keep the synchronous
    #: tick-exact arithmetic.
    pipelined = False

    def __init__(self, clock_hz: int = CLOCK_HZ, enabled: bool = True):
        self.clock_hz = clock_hz
        self.enabled = enabled          # False = no channel time modelled
        self.busy_until = 0             # tick when the line becomes free
        self.total_bytes = 0
        self.bytes_by_cat: dict = defaultdict(int)

    # -- serialisation time --------------------------------------------
    @abstractmethod
    def ticks_for_bytes(self, nbytes: int) -> int:
        """Pure wire time for ``nbytes``, in target ticks."""

    @property
    def latency_ticks(self) -> int:
        """Fixed per-transaction setup cost (0 for a raw UART)."""
        return 0

    # -- accounting -----------------------------------------------------
    def account(self, nbytes: int, category: str) -> None:
        """Count bytes (done even in zero-time/oracle mode)."""
        self.total_bytes += nbytes
        self.bytes_by_cat[category] += nbytes

    # -- transaction occupancy ------------------------------------------
    def begin(self, at_tick: int) -> int:
        """Start a transaction no earlier than ``at_tick``; returns the
        tick at which its first byte is on the wire."""
        if not self.enabled:
            return at_tick
        return max(at_tick, self.busy_until) + self.latency_ticks

    def end(self, start: int, total_bytes: int) -> int:
        """Finish a transaction started at ``start``; returns the wire
        completion tick and marks the line busy until then."""
        if not self.enabled:
            return start
        done = start + self.ticks_for_bytes(total_bytes)
        self.busy_until = done
        return done

    def send(self, nbytes: int, at_tick: int, category: str) -> int:
        """Single-request transaction (legacy API): serialise ``nbytes``
        starting no earlier than ``at_tick``; returns the completion
        tick.  Bytes are accounted either way."""
        self.account(nbytes, category)
        if not self.enabled:
            return at_tick
        return self.end(self.begin(at_tick), nbytes)

    def reset_stats(self):
        self.total_bytes = 0
        self.bytes_by_cat = defaultdict(int)
        self.busy_until = 0


class UartChannel(Channel):
    """921600-bps 8N2 UART (paper §IV, Table III)."""

    name = "uart"

    def __init__(self, baud: int = 921600, clock_hz: int = CLOCK_HZ,
                 bits_per_byte: int = BITS_PER_BYTE_8N2,
                 enabled: bool = True):
        super().__init__(clock_hz, enabled)
        self.baud = baud
        self.bits_per_byte = bits_per_byte

    def ticks_for_bytes(self, nbytes: int) -> int:
        if not self.enabled:
            return 0
        return int(round(nbytes * self.bits_per_byte * self.clock_hz
                         / self.baud))


class PcieChannel(Channel):
    """Modelled PCIe/AXI-DMA link: ~4 GB/s payload bandwidth with a fixed
    per-transaction descriptor/doorbell latency.  Raw throughput makes
    byte counts nearly free; the latency makes *request batching* the
    dominant lever — the scaling direction HtpSession exists for."""

    name = "pcie"
    pipelined = True

    def __init__(self, gbits_per_s: float = 32.0, latency_us: float = 1.0,
                 clock_hz: int = CLOCK_HZ, enabled: bool = True):
        super().__init__(clock_hz, enabled)
        self.gbits_per_s = gbits_per_s
        self.latency_us = latency_us

    def ticks_for_bytes(self, nbytes: int) -> int:
        if not self.enabled:
            return 0
        return int(-(-nbytes * 8 * self.clock_hz //
                     int(self.gbits_per_s * 1e9)))

    @property
    def latency_ticks(self) -> int:
        if not self.enabled:
            return 0
        return int(round(self.latency_us * self.clock_hz / 1e6))


class FarPcieChannel(PcieChannel):
    """A board behind an oversubscribed switch / cable extender hop: the
    same DMA engine as :class:`PcieChannel` but a fraction of the payload
    bandwidth and tens of microseconds of added per-transaction setup.
    This is the *skewed fleet* case the load-aware serving slot-migration
    policy exists for (and what migrating a job off such a board wins)."""

    name = "pcie_far"

    def __init__(self, gbits_per_s: float = 2.0, latency_us: float = 50.0,
                 clock_hz: int = CLOCK_HZ, enabled: bool = True):
        super().__init__(gbits_per_s, latency_us, clock_hz, enabled)


class OracleChannel(Channel):
    """Zero-time link: traffic is accounted, occupancy never modelled."""

    name = "oracle"

    def __init__(self, clock_hz: int = CLOCK_HZ, enabled: bool = False):
        super().__init__(clock_hz, enabled=False)

    def ticks_for_bytes(self, nbytes: int) -> int:
        return 0


CHANNELS = {"uart": UartChannel, "pcie": PcieChannel,
            "pcie_far": FarPcieChannel, "oracle": OracleChannel}


def make_channel(name: str, baud: int = 921600,
                 enabled: bool = True) -> Channel:
    """Instantiate a link backend by registry name; config keys a
    backend does not take (e.g. ``baud`` off-UART) are dropped."""
    import inspect
    try:
        cls = CHANNELS[name]
    except KeyError:
        raise KeyError(
            f"unknown link {name!r} (have {sorted(CHANNELS)})") from None
    accepted = inspect.signature(cls).parameters
    config = {"baud": baud, "enabled": enabled}
    return cls(**{k: v for k, v in config.items() if k in accepted})
