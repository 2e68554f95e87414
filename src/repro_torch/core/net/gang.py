"""Gang scheduling: one job spanning N boards over the switch fabric.

A :class:`GangJob` is a set of member jobs — one per device — that run
as a bulk-synchronous gang: every member executes one superstep quantum
of modelled time, then the gang exchanges halos over the fabric (each
member ships its boundary pages to its ring neighbour's inbound mailbox,
with the TLB shootdowns and the hfutex wake doorbell delivered as rows
of the NIC receive transaction), and every member's resume clock is
floored at its exchange-complete tick.  End-to-end gang ticks therefore
depend on switch bandwidth/latency/credits — not on the host link, which
carries none of the cross-device traffic.

Placement puts the gang on *adjacent switch ports*: devices are
connected to consecutive ports in fleet order, so the placement window
is a contiguous device run chosen by the same load signal the
``least_loaded`` policy uses (min over windows of the max member clock).

Gang migration rebalances the *whole* gang onto another contiguous
window via the existing per-job pre-copy path
(:meth:`~repro_torch.core.fleet.runtime.FleetRuntime.prepare_migration` /
``migrate``), with each member's capture token-fenced against its NIC's
in-flight fabric traffic (``deps=nic.last_token``) — the hazard the
seeded "credit-starved flit vs. migration capture" test exercises.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..consts import CLOCK_HZ

#: adaptive superstep pacing (``superstep_ticks="auto"``): the quantum
#: starts at the historical default and doubles / halves on the EWMA of
#: the per-round halo wait fraction (wait_ticks / quantum).  A round
#: whose barrier cost more than AUTO_HI of the quantum means barriers
#: are too frequent — grow; below AUTO_LO they are nearly free — shrink
#: toward fresher halos.  The EWMA blend matches the telemetry
#: LoadEstimator's (repro_torch.telemetry.load.ALPHA).
AUTO_START = 200_000
AUTO_MIN = 25_000
AUTO_MAX = 1_600_000
AUTO_HI = 0.01
AUTO_LO = 0.002


@dataclass
class GangJob:
    """One multi-board job: member jobs in ring order (member i's halo
    goes to member (i+1) % N each superstep)."""

    jobs: list                     # fleet.Job, one per member/board
    #: compute quantum between barriers, or ``"auto"`` — counter-driven
    #: pacing that grows/shrinks the quantum from the observed halo
    #: wait fraction (see AUTO_* above)
    superstep_ticks: int | str = 200_000
    halo_pages: int = 2            # boundary pages shipped per neighbour
    max_supersteps: int = 256
    gang_id: int = -1


@dataclass
class RunningGang:
    """Handle to a placed gang (member handles in ring order)."""

    gang: GangJob
    handles: list                  # fleet.RunningJob per member
    #: member index -> current inbound-mailbox ppns on that member's
    #: board (double-buffered: re-allocated fresh every superstep, the
    #: previous buffer is freed — lands never alias live guest pages)
    mailbox: dict = field(default_factory=dict)


@dataclass
class GangReport:
    """End-to-end gang completion + fabric accounting."""

    gang_id: int
    n_members: int
    device_ids: list
    reports: list                  # per-member FaseRuntime Report
    supersteps: int = 0
    exchanges: int = 0
    makespan_ticks: int = 0        # max member completion tick
    wait_ticks: int = 0            # summed resume-floor stalls (fabric)
    fabric: dict = field(default_factory=dict)   # Switch.report()
    #: per-round bookkeeping (superstep, quantum, t0, t1, wait_ticks) —
    #: feeds the unified timeline's superstep track and the pacing panel
    rounds: list = field(default_factory=list)

    @property
    def makespan_seconds(self) -> float:
        return self.makespan_ticks / CLOCK_HZ


def place_gang(fleet, k: int):
    """Pick the contiguous k-device window (adjacent switch ports, since
    devices attach to consecutive ports in fleet order) whose *busiest*
    member frees up earliest — the gang starts when its last board is
    free, so this is the least_loaded signal lifted to windows.  Ties
    break on the lowest port index (deterministic)."""
    devs = fleet.devices
    assert k <= len(devs), "gang wider than the fleet"
    best = min(range(len(devs) - k + 1),
               key=lambda i: (max(d.clock for d in devs[i:i + k]), i))
    return devs[best:best + k]


def _quiesce(handle) -> int:
    """The tick by which everything the member submitted has completed —
    the earliest its half of a gang barrier can start."""
    rt = handle.runtime
    now = rt.target.get_ticks()   # analysis: allow-host-sync
    sess = rt.session
    if hasattr(sess, "quiesce_tick"):
        now = max(now, sess.quiesce_tick())
    return now


def _halo_sources(handle, n_pages: int):
    """The member's boundary pages this superstep: the lowest-numbered
    live physical pages of its address space (deterministic; a model —
    what matters is that real DRAM content crosses the fabric)."""
    live = sorted(handle.runtime.alloc.refcnt)
    return live[:n_pages]


def _refresh_mailbox(rg: RunningGang, idx: int, n_pages: int):
    """Double-buffer the member's inbound mailbox: allocate fresh
    landing pages first, then free the previous superstep's (alloc
    before free, so the new buffer never aliases the old one even on a
    LIFO freelist)."""
    alloc = rg.handles[idx].runtime.alloc
    pages = [alloc.alloc() for _ in range(n_pages)]
    for ppn in rg.mailbox.get(idx, ()):
        alloc.unref(ppn)
    rg.mailbox[idx] = pages
    return pages


def run_gang(fleet, rg: RunningGang) -> GangReport:
    """Drive the gang to completion: superstep quanta + fabric halo
    exchanges.  Returns the aggregate :class:`GangReport`; members
    retire onto their devices exactly like solo jobs."""
    gang, handles = rg.gang, rg.handles
    assert all(h.device.nic is not None for h in handles), \
        "gang devices need NIC endpoints (FleetRuntime fabric=)"
    n = len(handles)
    reports: list = [None] * n
    live = [i for i in range(n)]
    supersteps = exchanges = wait_ticks = 0
    horizon = 0
    auto = gang.superstep_ticks == "auto"
    quantum = AUTO_START if auto else gang.superstep_ticks
    wait_ema = 0.0
    rounds: list = []
    while live and supersteps < gang.max_supersteps:
        supersteps += 1
        t0 = horizon
        horizon += quantum
        round_wait = 0
        for i in list(live):
            rep = fleet.step_job(handles[i], pause_ticks=horizon)
            if rep is not None:
                reports[i] = rep
                live.remove(i)
        if len(live) < 2:
            rounds.append(dict(superstep=supersteps, quantum=quantum,
                               t0=t0, t1=horizon, wait_ticks=0))
            continue              # no neighbour left to exchange with
        # ---- gang barrier: all live members quiesce, then exchange ----
        start = max(_quiesce(handles[i]) for i in live)
        arrival = {}
        for pos, i in enumerate(live):
            j = live[(pos + 1) % len(live)]       # ring neighbour
            src_h, dst_h = handles[i], handles[j]
            src_nic = src_h.device.nic
            dst_nic = dst_h.device.nic
            pairs = list(zip(_halo_sources(src_h, gang.halo_pages),
                             _refresh_mailbox(rg, j, gang.halo_pages)))
            dst_vm = dst_h.runtime.vm
            harts = tuple(range(dst_h.runtime.target.n_cores))
            deps = (src_nic.last_token,) if src_nic.last_token else ()
            res = src_nic.push_pages(
                dst_nic, pairs, at=start, deps=deps,
                shootdown=harts,       # DMA'd window: every hart drops it
                wake=(0,))             # doorbell releases the parked main
            # the fabric carried the shootdowns the member still owed
            # remotely — the lazy host-link flush is no longer due
            dst_vm.shootdown_delivered(harts)
            arrival[j] = max(arrival.get(j, 0), res.done)
            # sender blocks until its egress frame is delivered too
            # (send-complete semantics: its NIC reads local DRAM until
            # then, so resuming earlier could race the egress DMA)
            arrival[i] = max(arrival.get(i, 0), res.done)
            exchanges += 1
        # ---- resume floor: members restart at their delivery tick ----
        for i in live:
            h = handles[i]
            now = h.runtime.target.get_ticks()  # analysis: allow-host-sync
            floor = arrival.get(i, now)
            if floor > now:
                # host-side clock alignment, the migrate() idiom: the
                # tick counter is the model's clock, so the fabric wait
                # becomes modelled stall time without wire traffic
                # (a CsrW("ticks") is the write stage's eager special
                # case — one bounded write per member, never batched)
                h.runtime.session.t.csr_write(
                    0, "ticks", floor)  # analysis: allow-host-sync
                wait_ticks += floor - now
                round_wait += floor - now
        horizon = max(horizon, max(arrival.values(), default=horizon))
        rounds.append(dict(superstep=supersteps, quantum=quantum,
                           t0=t0, t1=horizon, wait_ticks=round_wait))
        if auto:
            # counter-driven pacing: EWMA of this round's halo wait
            # fraction steers the next quantum (grow = fewer barriers,
            # shrink = fresher halos); the fixed path never enters here
            frac = round_wait / max(quantum, 1)
            wait_ema += 0.5 * (frac - wait_ema)
            if wait_ema > AUTO_HI:
                quantum = min(quantum * 2, AUTO_MAX)
            elif wait_ema < AUTO_LO:
                quantum = max(quantum // 2, AUTO_MIN)
    assert not live, "gang exceeded max_supersteps"
    makespan = max(r.ticks for r in reports)
    return GangReport(
        gang_id=gang.gang_id, n_members=n,
        device_ids=[h.device.id for h in handles],
        reports=reports, supersteps=supersteps, exchanges=exchanges,
        makespan_ticks=makespan, wait_ticks=wait_ticks,
        fabric=fleet.fabric.report(horizon=makespan), rounds=rounds)


def migrate_gang(fleet, rg: RunningGang, dst_start: int) -> list:
    """Rebalance the whole gang onto the contiguous window starting at
    device index ``dst_start`` (adjacent ports again), via the existing
    pre-copy path.  Members already sitting on their target stay put.
    Every member's final capture is token-fenced against its NIC's
    newest fabric frame so an in-flight (possibly credit-starved) flit
    can never race the migration capture.  Returns the
    :class:`~repro_torch.core.fleet.runtime.MigrationReport` list."""
    k = len(rg.handles)
    devs = fleet.devices[dst_start:dst_start + k]
    assert len(devs) == k, "destination window out of range"
    current = {id(h.device) for h in rg.handles}
    out = []
    for h, dst in zip(rg.handles, devs):
        if dst is h.device:
            continue
        # provisioning the destination would tear down a sibling's live
        # queue pair — rebalance to a disjoint window (or run members
        # down first); overlapping shifts are not supported
        assert id(dst) not in current, \
            "gang destination window overlaps its current one"
        nic = h.device.nic
        fence = (nic.last_token,) if nic and nic.last_token else ()
        base = fleet.prepare_migration(h, dst)
        out.append(fleet.migrate(h, dst, base=base, deps=fence))
    return out
