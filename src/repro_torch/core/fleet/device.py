"""One modelled FPGA of the fleet: target + channel + queue pair + stats.

A :class:`Device` bundles everything one emulated board owns in a
sharded deployment: a *target factory* (each job gets a freshly imaged
target, like re-flashing a board between runs), the device's own
:class:`~repro_torch.core.channel.Channel` backend, the
:class:`~repro_torch.core.cq.AsyncHtpSession` queue pair driving it, and
cumulative :class:`DeviceStats`.  The queue pair is provisioned lazily
and re-provisioned per job; the stats — in particular ``busy_ticks``,
the device's serial occupancy "clock" — survive re-provisioning, which
is what the ``least_loaded`` placement policy balances on.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..channel import make_channel
from ..cq import AsyncHtpSession
from ..hfutex import HFutexCache
from ..session import HtpSession
from ..consts import CLOCK_HZ
from ...telemetry.load import LoadEstimator

#: image identity of a device provisioned without an explicit image key
#: (lazy ``.session`` access); distinct from every job image, so the
#: first keyed provision afterwards still re-flashes.
DEFAULT_IMAGE = "<default>"


@dataclass
class DeviceStats:
    """Cumulative per-device counters across every job/queue pair."""

    jobs: int = 0
    busy_ticks: int = 0          # serial occupancy: sum of job makespans
    transactions: int = 0
    wire_bytes: int = 0
    exceptions: int = 0
    provisions: int = 0          # billed re-imagings (bitstream + ELF)
    provision_ticks: int = 0     # total ticks spent re-imaging
    load_stall_frac: float = 0.0  # EWMA stall fraction (LoadEstimator,
    #                               fed by the telemetry counter bridge)
    load_samples: int = 0        # counter samples behind the estimate
    bytes_by_cat: dict = field(default_factory=dict)

    def absorb_session(self, session) -> None:
        """Fold one retired queue pair's counters into the device."""
        self.transactions += session.stats.transactions
        self.wire_bytes += session.channel.total_bytes
        for cat, n in session.channel.bytes_by_cat.items():
            self.bytes_by_cat[cat] = self.bytes_by_cat.get(cat, 0) + n

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        d["bytes_by_cat"] = dict(self.bytes_by_cat)
        return d


class Device:
    """One modelled FPGA: (Target, Channel, AsyncHtpSession) + stats."""

    def __init__(self, device_id, make_target, link: str = "pcie",
                 baud: int = 921600, session: str = "async",
                 queue_depth: int = 8, coalesce_ticks: int = 50,
                 hfutex: bool = True, direct_mode: bool = False,
                 provision_us: float = 0.0, label: str | None = None):
        assert session in ("async", "sync")
        self.id = device_id
        self.make_target = make_target
        self.link = link
        self.baud = baud
        self.session_kind = session
        self.queue_depth = queue_depth
        self.coalesce_ticks = coalesce_ticks
        self.hfutex = hfutex
        self.direct_mode = direct_mode
        # FireSim-style re-imaging cost: bitstream flash + ELF load is
        # wall-clock seconds on real boards.  Charged on every provision
        # that changes the board's resident image (a same-image
        # re-provision is a warm reuse and stays free); 0 keeps the
        # historical free-provisioning behaviour and all golden ticks.
        self.provision_us = provision_us
        self.image_key: object = None     # image resident on the board
        self.label = label or f"dev{device_id}@{link}"
        self.stats = DeviceStats()
        self._session: HtpSession | None = None
        # fabric attachment (repro_torch.core.net.NicEndpoint) — set by the
        # endpoint itself when a FleetRuntime carries a switch; None on
        # island devices.  Propagated onto every queue pair so the
        # telemetry counter bridge can surface per-port fabric counters.
        self.nic = None
        # analysis trace (repro_torch.analysis.trace.HtpTrace) armed
        # fleet-wide by attach_trace; every queue pair this device
        # provisions feeds it under a (device_id, stream)-prefixed ordering
        # domain
        self.trace = None
        # online load signal (repro_torch.telemetry.load): fed by the counter
        # bridge of each job's telemetry hub via the session backref
        self.load = LoadEstimator()

    # -- queue pair -----------------------------------------------------
    def provision_ticks_for(self, image_key=None) -> int:
        """Re-imaging charge provisioning with ``image_key`` would incur
        right now (0 when the image is already resident, or when
        provisioning is modelled free).  The provision-aware
        ``least_loaded`` policy folds this into its clock comparison."""
        key = image_key if image_key is not None else DEFAULT_IMAGE
        if self.provision_us <= 0 or key == self.image_key:
            return 0
        return int(round(self.provision_us * CLOCK_HZ / 1e6))

    def provision(self, image_key=None) -> HtpSession:
        """(Re)image the device: fresh target, channel and queue pair.
        A live queue pair being replaced folds into the device stats
        first, so no traffic is ever dropped.  When the requested image
        differs from the board's resident one (and ``provision_us`` is
        set) the re-imaging cost is charged to the device's serial
        occupancy clock.

        The construction mirrors :class:`~repro_torch.core.runtime.FaseRuntime`
        exactly, which is what keeps a one-device fleet tick-identical to
        a plain runtime (``tests/test_fleet.py`` pins this down)."""
        if self._session is not None:
            self.stats.absorb_session(self._session)
        cost = self.provision_ticks_for(image_key)
        if cost:
            self.stats.provisions += 1
            self.stats.provision_ticks += cost
            self.stats.busy_ticks += cost
        self.image_key = image_key if image_key is not None \
            else DEFAULT_IMAGE
        target = self.make_target()
        ch = make_channel(self.link, baud=self.baud)
        hf = HFutexCache(target.n_cores, enabled=self.hfutex)
        if self.session_kind == "async":
            self._session = AsyncHtpSession(
                target, ch, hf, direct_mode=self.direct_mode,
                depth=self.queue_depth,
                coalesce_ticks=self.coalesce_ticks)
        else:
            self._session = HtpSession(target, ch, hf,
                                       direct_mode=self.direct_mode)
        if self.trace is not None:
            # fleet-wide hazard tracing survives re-provisioning: the
            # fresh queue pair (a migration destination, a re-imaged
            # board) feeds the same trace under this device's prefix
            from ...analysis.trace import TraceRecorder, session_is_serial
            self._session.trace = TraceRecorder(
                self.trace, session_is_serial(self._session),
                device=self.id)
        self._session.nic = self.nic
        # backref for the telemetry counter bridge: samples taken on
        # this queue pair feed the owning device's load estimator
        self._session.device = self
        return self._session

    @property
    def provisioned(self) -> bool:
        return self._session is not None

    def counters(self) -> DeviceStats:
        """Retired-plus-live counters, via the same fold as ``retire``
        (one folding implementation, two consumers), without mutating
        the device or provisioning anything."""
        out = DeviceStats(**self.stats.as_dict())
        if self._session is not None:
            out.absorb_session(self._session)
        return out

    @property
    def session(self) -> HtpSession:
        """The device's current queue pair (provisioned on first use)."""
        if self._session is None:
            self.provision()
        return self._session

    @property
    def clock(self) -> int:
        """Device-serial modelled time: when this board frees up."""
        return self.stats.busy_ticks

    # -- job execution --------------------------------------------------
    def make_runtime(self, image_key=None, **runtime_kwargs):
        """A fresh :class:`~repro_torch.core.runtime.FaseRuntime` over a fresh
        queue pair (the previous pair's counters are folded into the
        device stats first)."""
        from ..runtime import FaseRuntime   # runtime layer sits above us
        sess = self.provision(image_key)
        return FaseRuntime(sess.t, mode="fase", session_obj=sess,
                           **runtime_kwargs)

    def retire(self, report, span: int | None = None) -> None:
        """Account one finished job: the device stays busy for its whole
        modelled makespan (serial occupancy — one job at a time per
        board), and the job's queue-pair counters fold into the device
        stats (and only here — ``provision`` absorbs a pair it replaces,
        so nothing is counted twice).  A migrated-in job passes ``span``
        — only the ticks it actually spent on THIS board (its earlier
        span was charged to the source at migration time)."""
        self.stats.jobs += 1
        self.stats.busy_ticks += report.ticks if span is None else span
        self.stats.exceptions += report.sched.get("exceptions", 0)
        self.load.note_job(report.ticks if span is None else span)
        self.stats.load_stall_frac = self.load.stall_frac
        self.stats.load_samples = self.load.samples
        if self._session is not None:
            self.stats.absorb_session(self._session)
            self._session = None

    def evict(self) -> None:
        """The running job migrated away mid-run: fold the live queue
        pair's counters and drop it.  No job completion is counted and
        the board keeps its resident image (a later same-image job
        re-provisions free)."""
        if self._session is not None:
            self.stats.absorb_session(self._session)
            self._session = None

    def __repr__(self):
        return (f"Device({self.id!r}, link={self.link!r}, "
                f"jobs={self.stats.jobs}, busy={self.stats.busy_ticks})")
