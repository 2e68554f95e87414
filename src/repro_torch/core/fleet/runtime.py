"""FleetRuntime: shard whole workloads across N modelled FPGAs.

The orchestrator of the fleet layer.  Jobs (replicated or independent
multi-process workloads) queue in submission order; at each placement
the pluggable policy picks the owning :class:`Device`, a fresh
:class:`~repro_torch.core.runtime.FaseRuntime` is built *over that device's
queue pair* (session injection — the runtime's HTP goes through the
device's channel), the job runs to completion in modelled time, and the
device's serial-occupancy clock advances by the job's makespan.  Devices
are independent boards, so fleet makespan is the max device clock and
aggregate throughput on independent workloads scales with device count
(``benchmarks/fleet_scale.py``).

Everything is deterministic: job order, placement (stable hashes only)
and each job's modelled run reproduce tick-for-tick across processes.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import snapshot as snapmod
from ..consts import CLOCK_HZ
from ..workloads import build
from .device import Device
from .placement import image_key_of, make_policy
from .router import FleetRouter


@dataclass
class Job:
    """One schedulable workload instance."""

    name: str                     # workloads.build() key ("hello", "bc", …)
    argv: list = field(default_factory=list)   # argv tail (argv[0] = name)
    files: dict | None = None
    stdin: bytes = b""
    affinity_key: object = None   # placement stickiness (affinity policy)
    max_ticks: int = 1 << 40
    image: object = None          # pre-assembled Image overrides `name`
    job_id: int = -1


@dataclass
class JobResult:
    job: Job
    device_id: object
    start_tick: int               # owning device's clock at placement
    done_tick: int                # … after the job retired
    report: object                # the job's full FaseRuntime Report


@dataclass
class RunningJob:
    """Handle to a placed, loaded, not-yet-finished job — the unit the
    pausable/migratable APIs (:meth:`FleetRuntime.step_job`,
    :meth:`FleetRuntime.migrate`) operate on."""

    job: Job
    device: Device
    runtime: object               # the job's FaseRuntime
    image_key: object
    #: job-relative tick up to which occupancy is already attributed
    #: (to earlier boards, at migration time)
    mark: int = 0
    migrations: list = field(default_factory=list)


@dataclass
class MigrationReport:
    """Cost sheet of one live job migration — every number is billed
    modelled time / wire traffic, not bookkeeping."""

    job_id: int
    src: object                   # source device id
    dst: object                   # destination device id
    delta: bool                   # restore shipped only a dirty delta
    pages_total: int              # pages in the checkpoint's full image
    pages_shipped: int            # pages the destination restore shipped
    src_bytes: int                # capture traffic on the source link
    dst_bytes: int                # restore traffic on the destination
    capture_start: int            # job-relative tick the capture began
    capture_done: int
    provision_ticks: int          # destination re-imaging charge
    restore_done: int             # job-relative resume tick

    @property
    def downtime_ticks(self) -> int:
        """Modelled ticks the job was frozen (capture through resume)."""
        return self.restore_done - self.capture_start


@dataclass
class FleetReport:
    """Aggregate completion/stats view across every device."""

    n_devices: int
    placement: str
    jobs: list = field(default_factory=list)        # JobResult, job order
    devices: dict = field(default_factory=dict)     # id -> DeviceStats dict
    busy_deltas: dict = field(default_factory=dict)  # id -> this-run ticks
    makespan_ticks: int = 0       # this run's completion horizon
    total_job_ticks: int = 0      # sum of per-job makespans
    total_bytes: int = 0
    total_exceptions: int = 0

    @property
    def makespan_seconds(self) -> float:
        return self.makespan_ticks / CLOCK_HZ

    @property
    def jobs_per_second(self) -> float:
        """Aggregate fleet throughput in modelled time."""
        return len(self.jobs) / max(self.makespan_seconds, 1e-12)

    @property
    def balance(self) -> float:
        """mean/max device occupancy this run — 1.0 is a level fleet."""
        if not self.busy_deltas or self.makespan_ticks == 0:
            return 1.0
        mean = sum(self.busy_deltas.values()) / len(self.busy_deltas)
        return mean / self.makespan_ticks


class FleetRuntime:
    """Orchestrate N devices: placement, execution, aggregation."""

    def __init__(self, n_devices: int = 1, make_target=None,
                 devices: list[Device] | None = None,
                 placement="round_robin", link: str = "pcie",
                 links: list | None = None, baud: int = 921600,
                 session: str = "async", queue_depth: int = 8,
                 coalesce_ticks: int = 50, hfutex: bool = True,
                 provision_us: float = 0.0,
                 runtime_kwargs: dict | None = None,
                 fabric=None, fleet_vmap: bool = False,
                 target_cfg: dict | None = None):
        # fleet_vmap=True: every device's target is a view of one board
        # of ONE stacked CpuState (repro_torch.core.fleet.vmap.FleetTarget)
        # — a global chunk across the whole fleet is a single launch of
        # the fleet chunk kernel on the card, and device provisioning
        # resets that board.  ``target_cfg`` carries the FleetTarget
        # kwargs (n_cores, mem_bytes, interpreter knobs, chunk_kernel,
        # device).  Semantics are bit-identical to per-device targets.
        self.fleet_target = None
        if fleet_vmap:
            from .vmap import FleetTarget
            assert devices is None, \
                "fleet_vmap builds its own devices from target_cfg"
            assert target_cfg, \
                "fleet_vmap=True needs target_cfg (n_cores, mem_bytes, …)"
            self.fleet_target = FleetTarget(n_devices, **target_cfg)
            make_target = None
        if devices is None:
            assert make_target is not None or self.fleet_target, \
                "need make_target (device factory) or explicit devices"
            if links is not None:
                assert len(links) == n_devices, "one link per device"

            def factory(i):
                if self.fleet_target is not None:
                    return lambda: self.fleet_target.provision_view(i)
                return make_target

            devices = [Device(i, factory(i),
                              link=links[i] if links else link, baud=baud,
                              session=session, queue_depth=queue_depth,
                              coalesce_ticks=coalesce_ticks, hfutex=hfutex,
                              provision_us=provision_us)
                       for i in range(n_devices)]
        self.devices = devices
        self.policy = make_policy(placement)
        self.runtime_kwargs = dict(runtime_kwargs or {})
        self.queue: list[Job] = []
        self._next_id = 0
        # optional modelled interconnect (repro_torch.core.net.Switch): every
        # device gets a NicEndpoint on consecutive — hence adjacent —
        # switch ports, in fleet order.  Idle NICs charge nothing, so a
        # fabric-attached fleet running only solo jobs stays
        # tick-identical to an island fleet.
        self.fabric = fabric
        if fabric is not None:
            from ..net import NicEndpoint   # net sits beside fleet
            for d in self.devices:
                if d.nic is None:
                    NicEndpoint(d, fabric)
        self._next_gang = 0

    # -- submission ------------------------------------------------------
    def submit(self, job: Job, replicas: int = 1) -> list[Job]:
        """Queue ``job`` (``replicas`` > 1 queues that many independent
        copies — the replicated-workload path)."""
        out = []
        for r in range(replicas):
            j = job if replicas == 1 else Job(
                job.name, list(job.argv), job.files, job.stdin,
                job.affinity_key, job.max_ticks, job.image)
            j.job_id = self._next_id
            self._next_id += 1
            self.queue.append(j)
            out.append(j)
        return out

    # -- orchestration ---------------------------------------------------
    def start_job(self, job: Job, device: Device | None = None
                  ) -> RunningJob:
        """Place (or pin) and load one job without running it — the
        entry point of the pausable/migratable execution path."""
        dev = device if device is not None \
            else self.policy.place(job, self.devices)
        key = image_key_of(job)
        rt = dev.make_runtime(image_key=key, **self.runtime_kwargs)
        image = job.image if job.image is not None else build(job.name)
        rt.load(image, [job.name] + list(job.argv), stdin=job.stdin,
                files=job.files or {})
        return RunningJob(job, dev, rt, key)

    def step_job(self, handle: RunningJob, pause_ticks: int):
        """Run a slice of the job; returns its final Report when it
        finished inside the slice, else None (paused, migratable)."""
        rep = handle.runtime.run_slice(pause_ticks,
                                       max_ticks=handle.job.max_ticks)
        if rep is not None:
            self._retire(handle, rep)
        return rep

    def finish_job(self, handle: RunningJob) -> JobResult:
        """Run the job to completion on its current device and retire."""
        rep = handle.runtime.run(max_ticks=handle.job.max_ticks)
        return self._retire(handle, rep)

    def _retire(self, handle: RunningJob, rep) -> JobResult:
        dev = handle.device
        start = dev.clock
        dev.retire(rep, span=rep.ticks - handle.mark)
        return JobResult(handle.job, dev.id, start, dev.clock, rep)

    def run_job(self, device: Device, job: Job) -> JobResult:
        """Run one job on one device (fresh queue pair, full runtime)."""
        return self.finish_job(self.start_job(job, device))

    def run_synchronous(self, jobs: list[Job],
                        max_ticks: int = 1 << 48) -> list[JobResult]:
        """Fleet-lockstep execution over the stacked state: one job per
        device, and every global chunk advances all live devices in a
        SINGLE launch (:meth:`FleetTarget.run_global`) instead of N
        one-hot ones.

        Each iteration runs every live runtime's pre-chunk host phase
        (:meth:`~repro_torch.core.runtime.FaseRuntime.chunk_begin`), batches
        the per-device cycle budgets into one ``run_global``, then runs
        every post-chunk phase (exception handling).  A device whose
        job exited — or whose host side must idle on async I/O — gets
        budget 0, which leaves its lane bit-exactly untouched, so each
        job's modelled timeline is identical to the solo per-device
        path tick for tick (``tests/test_torch_fleet_vmap.py``)."""
        assert self.fleet_target is not None, \
            "run_synchronous needs fleet_vmap=True"
        assert len(jobs) <= len(self.devices), "one device per job"
        for j in jobs:
            if j.job_id < 0:
                j.job_id = self._next_id
                self._next_id += 1
        handles = [self.start_job(j, d)
                   for j, d in zip(jobs, self.devices)]
        results: list[JobResult | None] = [None] * len(handles)
        budgets = np.zeros(self.fleet_target.n_devices, np.uint64)
        while any(r is None for r in results):
            budgets[:] = 0
            for i, h in enumerate(handles):
                if results[i] is not None:
                    continue
                want = h.runtime.chunk_begin()
                if want is None:
                    results[i] = self._retire(h, h.runtime.finish())
                elif want:
                    budgets[h.runtime.target.d] = \
                        h.runtime.target.chunk_cycles
            if budgets.any():
                self.fleet_target.run_global(budgets)
            for h in handles:
                if budgets[h.runtime.target.d]:
                    tk = h.runtime.target.get_ticks()  # analysis: allow-host-sync
                    if tk > max_ticks:
                        raise TimeoutError(
                            f"device {h.device.id} exceeded {max_ticks}")
                    h.runtime.chunk_end()
        return results

    # -- gang scheduling (requires a fabric) -----------------------------
    def start_gang(self, gang):
        """Place a :class:`~repro_torch.core.net.GangJob` on a contiguous run
        of devices — adjacent switch ports — and load every member.
        Returns the :class:`~repro_torch.core.net.RunningGang` handle."""
        from ..net import RunningGang, place_gang
        assert self.fabric is not None, "gang scheduling needs fabric="
        for j in gang.jobs:
            if j.job_id < 0:
                j.job_id = self._next_id
                self._next_id += 1
        if gang.gang_id < 0:
            gang.gang_id = self._next_gang
            self._next_gang += 1
        devs = place_gang(self, len(gang.jobs))
        handles = [self.start_job(j, d) for j, d in zip(gang.jobs, devs)]
        return RunningGang(gang, handles)

    def run_gang(self, rg):
        """Drive a placed gang to completion (superstep quanta + fabric
        halo exchanges); returns the
        :class:`~repro_torch.core.net.GangReport`."""
        from ..net import run_gang as _run
        return _run(self, rg)

    def migrate_gang(self, rg, dst_start: int) -> list:
        """Rebalance a whole gang onto the contiguous window starting at
        device index ``dst_start``, via the per-member pre-copy path,
        NIC-fenced.  Returns the per-member migration reports."""
        from ..net import migrate_gang as _mig
        return _mig(self, rg, dst_start)

    # -- checkpoint / migration ------------------------------------------
    def checkpoint(self, handle: RunningJob,
                   base: "snapmod.TargetSnapshot | None" = None,
                   advisory: bool = False, deps: tuple = ()):
        """Checkpoint the (paused) job through its device's own queue
        pair — the capture traffic serialises on the source link.  The
        page set is the runtime's allocator view (every referenced
        physical page, hardware page tables included), not a memory
        scan.  Returns ``(snapshot, done_tick)``.  ``advisory`` marks a
        live pre-copy capture for the hazard analyzer: the job will keep
        running while the capture drains, and a later fenced capture
        supersedes everything read here."""
        rt = handle.runtime
        return snapmod.capture(rt.session, at=rt.target.get_ticks(),
                               pages=sorted(rt.alloc.refcnt), base=base,
                               advisory=advisory, deps=deps)

    def prepare_migration(self, handle: RunningJob, dst: Device):
        """Pre-copy: provision ``dst`` and ship a full base checkpoint
        onto it while the job keeps running on its source board.  The
        later :meth:`migrate` then pays only the dirty delta.  Returns
        the base snapshot to pass as ``migrate(..., base=)``."""
        assert dst is not handle.device, "pre-copy needs a distinct board"
        snap, t1 = self.checkpoint(handle, advisory=True)
        sess = dst.provision(handle.image_key)
        snapmod.restore(sess, snap, at=t1, category="migrate")
        snap.resident_session = sess
        return snap

    def migrate(self, handle: RunningJob, dst: Device,
                base: "snapmod.TargetSnapshot | None" = None,
                deps: tuple = ()) -> MigrationReport:
        """Live-migrate a paused job: checkpoint on the source (billed
        on its link), re-image the destination (billed ``provision_us``
        when the board carries a different image), restore over the
        destination link, re-point the job's host runtime at the new
        queue pair and account the source span.  With ``base`` from
        :meth:`prepare_migration` only the dirty delta crosses the
        wires.  The job resumes via :meth:`step_job`/:meth:`finish_job`
        as if nothing happened — host state never moved."""
        src, rt = handle.device, handle.runtime
        assert dst is not src, "migration needs a distinct destination"
        t0 = rt.target.get_ticks()
        src_b0 = rt.session.channel.total_bytes
        # ``deps`` fences the capture behind in-flight out-of-band work
        # (a gang member's newest NIC frame: a credit-starved flit still
        # draining into this board must land before its page is read)
        snap, t1 = self.checkpoint(handle, base=base, deps=deps)
        src_bytes = rt.session.channel.total_bytes - src_b0
        # the span this board actually hosted, incl. the capture stall
        src.stats.busy_ticks += max(0, t1 - handle.mark)
        src.evict()
        # destination: re-image (warm board with the base image is free),
        # then restore — full chain, or just the delta when the base was
        # pre-copied into the queue pair still live on this board (the
        # session identity check matters: a board re-provisioned for
        # another job in between keeps the image key but not the state)
        delta_resident = (base is not None and dst.provisioned
                          and dst.session is base.resident_session)
        prov = 0 if delta_resident \
            else dst.provision_ticks_for(handle.image_key)
        dst_sess = dst.session if delta_resident \
            else dst.provision(handle.image_key)
        dst_b0 = dst_sess.channel.total_bytes
        shipped = snap.wire_pages() if delta_resident \
            else len(snap.effective_pages())
        t2 = snapmod.restore(dst_sess, snap, at=t1 + prov,
                             category="migrate",
                             delta_only=delta_resident, set_ticks=False)
        # align the fresh board's clock with the modelled resume tick —
        # a host-side model adjustment (the tick counter is the model's
        # clock, not shipped state), so it crosses no wire
        dst_sess.t.csr_write(0, "ticks", t2)
        rt.retarget(dst_sess)
        handle.device = dst
        handle.mark = t1 + prov
        mig = MigrationReport(
            job_id=handle.job.job_id, src=src.id, dst=dst.id,
            delta=delta_resident,
            pages_total=len(snap.effective_pages()),
            pages_shipped=shipped,
            src_bytes=src_bytes,
            dst_bytes=dst_sess.channel.total_bytes - dst_b0,
            capture_start=t0, capture_done=t1,
            provision_ticks=prov, restore_done=t2)
        handle.migrations.append(mig)
        return mig

    def run(self) -> FleetReport:
        """Place and run every queued job; aggregate across devices.

        The report covers *this* batch of jobs: on a warm fleet (repeat
        submit/run cycles) byte/exception totals are per-run deltas and
        the makespan is the longest per-device busy span this batch
        added (each board starts the batch from its own clock), so
        throughput is never diluted by earlier batches.  ``devices``
        still carries the cumulative :class:`DeviceStats` (the boards'
        lifetime state)."""
        start = {d.id: (d.clock, d.stats.wire_bytes, d.stats.exceptions)
                 for d in self.devices}
        results = []
        for job in self.queue:
            dev = self.policy.place(job, self.devices)
            results.append(self.run_job(dev, job))
        self.queue = []
        rep = FleetReport(n_devices=len(self.devices),
                          placement=self.policy.name, jobs=results)
        for d in self.devices:
            rep.devices[d.id] = d.stats.as_dict()
            rep.busy_deltas[d.id] = d.clock - start[d.id][0]
            rep.makespan_ticks = max(rep.makespan_ticks,
                                     rep.busy_deltas[d.id])
            rep.total_bytes += d.stats.wire_bytes - start[d.id][1]
            rep.total_exceptions += d.stats.exceptions - start[d.id][2]
        rep.total_job_ticks = sum(r.report.ticks for r in results)
        return rep

    # -- session-level access -------------------------------------------
    def router(self) -> FleetRouter:
        """A (device, hart)-keyed routing front end over this fleet's
        live queue pairs (serving-path integration)."""
        return FleetRouter(self.devices)
