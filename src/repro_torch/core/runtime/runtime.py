"""FASE host runtime (paper §V): the exception loop of Fig 6.

After reset every core is parked in privileged mode.  Execution starts with
a Redirect into user mode; the runtime then blocks on the exception queue
(``Next``), dispatches syscalls / page faults, applies state updates
through HTP, and re-Redirects.  All HTP is native
:class:`~repro_torch.core.session.HtpTransaction` batches (context
save/restore, Next+shootdown, whole page faults, the final counter
harvest), submitted on the trapping hart's submission stream.  The
session is either the synchronous :class:`~repro_torch.core.session.HtpSession`
(``session="sync"``) or the queue-pair
:class:`~repro_torch.core.cq.AsyncHtpSession` (``session="async"``, the
default), which overlaps independent per-core streams on pipelined links
and is tick-identical to the synchronous session on the UART.  Two timing
modes share all functional code:

  * ``mode="fase"``   — every HTP transaction serialises through the
    selected channel backend (``link="uart" | "pcie" | "oracle"``, default
    the paper's 8N2 UART) and each handled exception charges host-runtime
    latency; the trapped core's ``stall_until`` is the completion tick
    (StopFetch until Redirect, §III).
  * ``mode="oracle"`` — the full-system reference ("LiteX" role): no
    channel, instead an in-kernel cost model per syscall (KERNEL_COST).

The relative GAPBS-score / user-CPU-time error between the two modes is
exactly the paper's accuracy metric (§VI-B).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .. import channel as chmod
from ..cq import AsyncHtpSession
from ..hfutex import HFutexCache
from ..session import HtpSession, HtpTransaction
from ..consts import CLOCK_HZ
from . import loader as loader_mod
from . import syscalls as sysmod
from .io import AsyncHostIO, FdTable
from .sched import Scheduler
from .vm import PageAllocator, SegFault, VirtualMemory


class TargetCrash(Exception):
    pass


class Deadlock(Exception):
    pass


@dataclass
class Report:
    ticks: int = 0
    uticks: list = field(default_factory=list)
    instret: list = field(default_factory=list)
    stdout: bytes = b""
    syscalls: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)
    traffic_total: int = 0
    stall: dict = field(default_factory=dict)
    sched: dict = field(default_factory=dict)
    vm: dict = field(default_factory=dict)
    hfutex: dict = field(default_factory=dict)
    cq: dict = field(default_factory=dict)   # queue-pair engine counters
    telemetry: dict = field(default_factory=dict)  # out-of-band bridges
    load_ticks: int = 0
    exit_code: int = 0

    @property
    def seconds(self):
        """Modelled target wall-time at 100 MHz."""
        return self.ticks / CLOCK_HZ

    @property
    def user_seconds(self):
        return sum(self.uticks) / CLOCK_HZ


class FaseRuntime:
    def __init__(self, target, mode: str = "fase", baud: int = 921600,
                 hfutex: bool = True, direct_mode: bool = False,
                 link: str | None = None,
                 host_base_us: float = 35.0, host_us_per_req: float = 12.0,
                 fault_preload: int = 16, session: str = "async",
                 queue_depth: int = 8, coalesce_ticks: int = 50,
                 ctrl_serialize: bool = False, arg_prefetch: bool = False,
                 bill_switch_host: bool = False,
                 session_obj=None, traffic_hook=None, telemetry=None):
        assert mode in ("fase", "oracle")
        assert session in ("async", "sync")
        self.target = target
        self.mode = mode
        if session_obj is not None:
            # fleet path: the runtime drives an externally-provisioned
            # queue pair (a Device's), so its HTP serialises through that
            # device's own channel instead of building one here
            assert mode == "fase", "injected queue pairs model a live link"
            assert session_obj.t is target, \
                "injected session must wrap this runtime's target"
            self.session = session_obj
            self.link = session_obj.channel.name
        else:
            self.link = link or ("uart" if mode == "fase" else "oracle")
            ch = chmod.make_channel(self.link, baud=baud,
                                    enabled=(mode == "fase"))
            hf = HFutexCache(target.n_cores, enabled=hfutex)
            if session == "async":
                self.session = AsyncHtpSession(
                    target, ch, hf, direct_mode=direct_mode,
                    depth=queue_depth, coalesce_ticks=coalesce_ticks,
                    ctrl_serialize=ctrl_serialize)
            else:
                self.session = HtpSession(target, ch, hf,
                                          direct_mode=direct_mode,
                                          ctrl_serialize=ctrl_serialize)
        # speculative syscall-arg prefetch: read a7 + a0..a5 as ONE
        # transaction at Next time instead of lazy per-arg round trips —
        # trades bytes for round trips (wins on latency-dominated links)
        self.arg_prefetch = arg_prefetch
        # non-syscall host latency: since the req0 re-baseline, requests
        # issued outside syscall handling (context-switch save/restore,
        # scheduler redirects) bill no host_us_per_req anywhere.  This
        # flag charges those paths their own host cost; off by default —
        # the free-switch arithmetic is the golden-tick contract.
        self.bill_switch_host = bill_switch_host
        # co-residency hook: called with the modelled time every scheduler
        # iteration so background (e.g. Layer-B serving) traffic can be
        # injected onto this runtime's shared link
        self.traffic_hook = traffic_hook
        # out-of-band telemetry (repro_torch.telemetry): a TelemetryHub
        # kwargs dict (or a ready hub) armed over this runtime's session;
        # pumped after every target chunk, flushed + reported by finish()
        if telemetry is not None and not hasattr(telemetry, "pump"):
            from ...telemetry import TelemetryHub   # local: no cycle
            telemetry = TelemetryHub(self.session, **telemetry)
        self.telemetry = telemetry
        self.alloc = PageAllocator(target.mem_bytes)
        self.vm = VirtualMemory(self.session, self.alloc,
                                fault_preload=fault_preload)
        self.fdt = FdTable()
        self.async_io = AsyncHostIO(self.fdt)
        self.sched = Scheduler(target.n_cores)
        self.host_base_us = host_base_us
        self.host_us_per_req = host_us_per_req
        self.ticks_per_us = CLOCK_HZ // 1_000_000
        self.prng_state = 0x9E3779B97F4A7C15
        self.load_ticks = 0
        self.sigreturn_va = 0
        self.stats = {"syscalls": {}, "futex_waits": 0, "futex_wakes": 0,
                      "futex_wakes_empty": 0, "runtime_ticks": 0,
                      "kernel_ticks": 0, "exceptions": 0, "hfutex_hits": 0,
                      "page_fault_exceptions": 0}
        self.exit_code = 0

    # ------------------------------------------------------------------
    def load(self, image, argv: list[str], stdin: bytes = b"",
             files: dict[str, bytes] | None = None):
        for name, data in (files or {}).items():
            self.fdt.add_file(name, data)
        self.fdt.stdin += stdin
        self.sigreturn_va = image.symbols.get("__fase_sigreturn", 0)
        entry, sp, t = loader_mod.load_image(self, image, argv)
        regs = [0] * 32
        regs[2] = sp
        th = self.sched.new_thread(regs, entry)
        th.ready_at = t
        return th

    # ---------------- timing helpers -----------------------------------
    def tick_ns(self, t: int) -> int:
        return t * (1_000_000_000 // CLOCK_HZ)

    def _total_requests(self) -> int:
        # virtual (Layer-B serving analogue) requests share this link but
        # are processed by the serving engine's own host loop, not the
        # FASE exception loop — they must not bill Layer-A host latency
        s = self.session.stats
        return sum(s.requests.values()) - s.virtual_requests

    def charge(self, t: int, args, kcost_key: str, extra_kcost: int) -> int:
        """Charge host-runtime latency (fase) or kernel cost (oracle)."""
        if self.mode == "oracle":
            kc = sysmod.KERNEL_COST.get(kcost_key,
                                        sysmod.KERNEL_COST["default"])
            kc = int(kc + extra_kcost)
            self.stats["kernel_ticks"] += kc
            return t + kc
        n_req = self._total_requests() - getattr(args, "req0", 0)
        args.req0 = self._total_requests()
        host = int((self.host_base_us + self.host_us_per_req * n_req) *
                   self.ticks_per_us)
        self.stats["runtime_ticks"] += host
        return t + host

    def _charge_switch(self, n_req: int) -> int:
        """Host latency of a non-syscall dispatch path (context-switch
        save/restore, scheduler redirects) — the same per-request model
        :meth:`charge` applies to syscalls, gated behind
        ``bill_switch_host`` (default off: golden ticks)."""
        if self.mode != "fase" or not self.bill_switch_host:
            return 0
        host = int((self.host_base_us + self.host_us_per_req * n_req) *
                   self.ticks_per_us)
        self.stats["runtime_ticks"] += host
        return host

    # ---------------- context management --------------------------------
    # The context paths are the transaction showcase (§IV-B): a save is
    # one 31-RegR batch, a switch-in one RegW*31+Redirect batch — one
    # channel occupancy each instead of 31.
    def save_context(self, cpu: int, thread, pc: int, t: int,
                     keep_running: bool = False) -> int:
        txn = HtpTransaction()
        for i in range(1, 32):
            txn.reg_read(cpu, i, "ctxsw")
        res = self.session.submit(txn, t, stream=cpu)
        thread.regs = [0] + list(res.values)
        thread.pc = pc
        return res.done + self._charge_switch(len(txn.requests))

    def switch_in(self, cpu: int, thread, t: int) -> int:
        txn = HtpTransaction()
        if self.session.hfutex.clear_core(cpu):
            txn.hfutex_update(cpu)
        if thread.wake_value is not None:
            thread.regs[10] = thread.wake_value & ((1 << 64) - 1)
            thread.wake_value = None
        if thread.pending_signals and thread.saved_sigctx is None:
            self._setup_signal_frame(thread)
        for i in range(1, 32):
            txn.reg_write(cpu, i, thread.regs[i], "ctxsw")
        if self.mode == "oracle":
            kc = sysmod.KERNEL_COST["ctx_switch"]
            self.stats["kernel_ticks"] += kc
            t += kc
        txn.redirect(cpu, thread.pc, "ctxsw")
        t += self._charge_switch(len(txn.requests))
        t = self.session.submit(txn, t, stream=cpu).done
        self.sched.assign(cpu, thread.tid)
        self.sched.ctx_switches += 1
        return t

    def _setup_signal_frame(self, thread):
        signum = thread.pending_signals.popleft()
        handler = self.sched.sigactions.get(signum)
        if not handler or not self.sigreturn_va:
            return
        thread.saved_sigctx = (tuple(thread.regs), thread.pc)
        thread.regs = list(thread.regs)
        thread.regs[10] = signum
        thread.regs[1] = self.sigreturn_va    # ra -> sigreturn stub
        thread.regs[2] -= 512                 # red zone
        thread.pc = handler

    def resume(self, cpu: int, thread, pc: int, t: int):
        """Resume the running thread at ``pc`` (signals intercept here)."""
        if thread.pending_signals and thread.saved_sigctx is None and \
                any(s in self.sched.sigactions
                    for s in thread.pending_signals):
            t = self.save_context(cpu, thread, pc, t)
            self._setup_signal_frame(thread)
            txn = HtpTransaction()
            for i in range(1, 32):
                txn.reg_write(cpu, i, thread.regs[i], "signal")
            txn.redirect(cpu, thread.pc, "signal")
            self.session.submit(txn, t, stream=cpu)
            return
        self.session.submit(
            HtpTransaction().redirect(cpu, pc, "redirect"), t, stream=cpu)

    def schedule_onto(self, cpu: int, t: int):
        tid = self.sched.pick_next()
        if tid is None:
            return     # core stays parked (StopFetch held)
        th = self.sched.threads[tid]
        self.switch_in(cpu, th, max(t, th.ready_at))

    def wake_threads(self, tids, t: int):
        for tid in tids:
            self.sched.threads[tid].ready_at = t

    def thread_exit(self, cpu: int, thread, t: int):
        self.sched.exit_current(cpu)
        if thread.clear_child_tid:
            t = self.vm.ensure_mapped(thread.clear_child_tid, 4, cpu, t,
                                      want_write=True)
            pa = self.vm.translate(thread.clear_child_tid)
            old = self.target.mem_read_word(pa & ~7)
            shift = (pa & 4) * 8
            new = (old & ~(0xFFFFFFFF << shift))
            t = self.session.submit(
                HtpTransaction().mem_write(cpu, pa & ~7, new, "exit"), t,
                stream=cpu).done
            woken = self.sched.futex_wake(pa & ~3, 1 << 30)
            self.wake_threads(woken, t)
        self.schedule_onto(cpu, t)

    def block_on_host_read(self, cpu: int, thread, epc: int, args, fd: int,
                           buf: int, count: int):
        t = self.charge(args.t, args, "read", 0)
        t = self.save_context(cpu, thread, epc + 4, t)
        self.sched.block_current(cpu, "hostread")
        rt = self

        def cb(tid, data):
            now = rt.target.get_ticks()
            rt.vm.write_bytes(buf, data, 0, now, "read")
            th = rt.sched.threads[tid]
            th.wake_value = len(data)
            rt.sched.make_ready(tid)
            th.ready_at = now

        self.async_io.submit_read(thread.tid, fd, count, cb)
        self.schedule_onto(cpu, t)

    # ---------------- exception loop ------------------------------------
    def _dispatch_ready(self, now: int):
        idle = [c for c in range(self.target.n_cores)
                if c not in self.sched.running]
        if not idle:
            return
        # one batched device fetch for every idle core's privilege level
        # (switch_in only redirects the core it dispatches, so the other
        # cores' priv values stay valid across the loop)
        _, privs, _ = self.target.fetch_batch(
            csrs=[(c, "priv") for c in idle])
        for cpu, priv in zip(idle, privs):
            if priv != 3:
                continue
            tid = self.sched.pick_next()
            if tid is None:
                return
            th = self.sched.threads[tid]
            self.switch_in(cpu, th, max(now, th.ready_at,
                                        self.session.channel.busy_until))

    def _handle_exception(self, cpu: int, now: int):
        self.stats["exceptions"] += 1
        thread = self.sched.current(cpu)
        if thread is None:
            # spurious trap on an unowned core (e.g. after exit)
            self.target.clear_pending(cpu)
            self.target.park(cpu)
            return
        # controller-internal peek for the HFutex fast path (§V-B):
        # both CSRs in one batched device sync, not two round trips
        _, (cause, epc), _ = self.target.fetch_batch(
            csrs=[(cpu, "mcause"), (cpu, "mepc")])
        done = self.session.try_hfutex_fast_path(cpu, cause, epc, now)
        if done is not None:
            self.stats["hfutex_hits"] += 1
            return
        # Next (+ a lazily-owed TLB shootdown) in one transaction
        txn = HtpTransaction().next_info(cpu)
        flush_owed = cpu in self.vm.pending_flush
        if flush_owed:
            txn.flush_tlb(cpu, "shootdown")
            self.vm.pending_flush.discard(cpu)
        res = self.session.submit(txn, now, stream=cpu)
        t, (cause, epc, tval) = res.done, res.values[0]
        if cause == 8:        # ecall from U
            sysmod.dispatch(self, cpu, thread, epc, t)
            return
        if cause in (12, 13, 15):
            self.stats["page_fault_exceptions"] += 1
            access = {12: "x", 13: "r", 15: "w"}[cause]
            pages_before = self.vm.stats["pages_mapped"]
            try:
                t2 = self.vm.handle_fault(tval, access, cpu, t)
            except SegFault as e:
                raise TargetCrash(
                    f"cpu{cpu} tid{thread.tid}: {e} pc={epc:#x}") from None
            if self.mode == "oracle":
                npages = self.vm.stats["pages_mapped"] - pages_before
                kc = sysmod.KERNEL_COST["page_fault"] + \
                    sysmod.KERNEL_COST["page_fault_per_page"] * max(npages, 1)
                self.stats["kernel_ticks"] += kc
                t2 = t + kc
            else:
                n_req = 0
                host = int((self.host_base_us +
                            self.host_us_per_req * 2) * self.ticks_per_us)
                self.stats["runtime_ticks"] += host
                t2 += host
            # the resume explicitly depends on the fault batch's token
            self.session.submit(
                HtpTransaction().redirect(cpu, epc, "pagefault"), t2,
                stream=cpu, deps=(self.vm.last_token,))
            return
        raise TargetCrash(f"cpu{cpu} tid{thread.tid}: cause={cause} "
                          f"epc={epc:#x} tval={tval:#x}")

    def run(self, max_ticks: int = 1 << 48,
            max_exceptions: int = 1 << 30) -> Report:
        rep = self.run_slice(None, max_ticks=max_ticks,
                             max_exceptions=max_exceptions)
        assert rep is not None
        return rep

    def run_slice(self, pause_ticks: int | None,
                  max_ticks: int = 1 << 48,
                  max_exceptions: int = 1 << 30) -> Report | None:
        """The exception loop, pausable: runs until every thread exits
        (returns the final :class:`Report`) or modelled time reaches
        ``pause_ticks`` (returns None).  A pause lands at a loop
        boundary — every raised exception handled, no half-applied host
        work — so the target is checkpointable
        (:mod:`repro.core.snapshot`) and a later ``run_slice``/``run``
        resumes exactly where it left off.  ``pause_ticks=None`` is the
        plain uninterrupted run."""
        while self.sched.live_threads() > 0:
            # loop clock source: one scalar per slice, not per-element
            now = self.target.get_ticks()  # analysis: allow-host-sync
            if pause_ticks is not None and now >= pause_ticks:
                return None
            self.async_io.poll()
            self._dispatch_ready(now)
            if not self.sched.running:
                if self.async_io.busy or any(
                        th.state == "ready"
                        for th in self.sched.threads.values()):
                    continue
                raise Deadlock(
                    f"no runnable threads; futex queues: "
                    f"{ {k: list(v) for k, v in self.sched.futex_q.items()} }")
            budget = 1 << 62 if pause_ticks is None \
                else max(pause_ticks - now, 1)
            self.target.run(budget)
            now = self.target.get_ticks()  # analysis: allow-host-sync
            if self.traffic_hook is not None:
                self.traffic_hook(now)
            if self.telemetry is not None:
                self.telemetry.pump(now)
            if now > max_ticks:
                raise TimeoutError(f"exceeded {max_ticks} target ticks")
            if self.stats["exceptions"] > max_exceptions:
                raise TimeoutError("exception budget exceeded")
            for cpu in self.target.pending_cores():
                self._handle_exception(cpu, now)
        return self.finish()

    # ---------------- fleet-synchronous stepping -------------------------
    def chunk_begin(self) -> bool | None:
        """Host phase before a fleet global chunk — one iteration of the
        :meth:`run_slice` loop minus the device advance, so a fleet
        runtime can batch N devices' advances into a single dispatch
        (:meth:`repro.core.fleet.FleetRuntime.run_synchronous`).  Polls
        async I/O and dispatches ready threads; returns True when the
        device wants cycles this chunk, False when the host side must
        idle (async I/O still draining), None when every thread has
        exited (the caller owns the :meth:`finish`)."""
        if self.sched.live_threads() == 0:
            return None
        self.async_io.poll()
        now = self.target.get_ticks()  # analysis: allow-host-sync
        self._dispatch_ready(now)
        if self.sched.running:
            return True
        if self.async_io.busy or any(th.state == "ready"
                                     for th in self.sched.threads.values()):
            return False
        raise Deadlock(
            f"no runnable threads; futex queues: "
            f"{ {k: list(v) for k, v in self.sched.futex_q.items()} }")

    def chunk_end(self) -> None:
        """Host phase after a fleet global chunk: pump telemetry and
        handle every exception the chunk raised, restoring the same
        loop-boundary invariant :meth:`run_slice` keeps (all raised
        exceptions handled, no half-applied host work)."""
        now = self.target.get_ticks()  # analysis: allow-host-sync
        if self.traffic_hook is not None:
            self.traffic_hook(now)
        if self.telemetry is not None:
            self.telemetry.pump(now)
        for cpu in self.target.pending_cores():
            self._handle_exception(cpu, now)

    # ---------------- live migration -------------------------------------
    def retarget(self, session) -> None:
        """Adopt a restored target behind a new queue pair (live
        migration, :meth:`repro.core.fleet.FleetRuntime.migrate`).  All
        host-side state — scheduler, software page tables, page
        allocator, fd table, stats — carries over untouched: in FASE the
        host owns it, only the device half moved.  The new board's
        HFutex mask cache starts cold (masks re-insert on the next futex
        syscalls), and :meth:`finish`'s traffic view covers the new link
        only — per-link splits live in the fleet's device stats."""
        assert self.mode == "fase", "migration models a live link"
        assert session.t is not None, "need a session wrapping a target"
        assert session.t.n_cores == self.target.n_cores
        assert session.t.mem_bytes == self.target.mem_bytes
        self.target = session.t
        self.session = session
        self.vm.sess = session
        self.link = session.channel.name
        if self.telemetry is not None:
            self.telemetry.rebind(session)

    def finish(self) -> Report:
        # flush telemetry first: a final forced counter sample + ring
        # drain on the telem lane (side-band — cannot move the harvest)
        if self.telemetry is not None:
            self.telemetry.finish(self.target.get_ticks())
        # final counter harvest: Tick + per-core UTick as one transaction,
        # barriered on every stream's last completion token
        txn = HtpTransaction().tick()
        for c in range(self.target.n_cores):
            txn.utick(c)
        sess = self.session
        deps = sess.tail_tokens() if isinstance(sess, AsyncHtpSession) \
            else ()
        res = sess.submit(txn, sess.channel.busy_until, deps=deps)
        uticks = list(res.values[1:])
        rep = Report(
            ticks=self.target.get_ticks(),
            uticks=uticks,
            instret=[self.target.get_instret(c)
                     for c in range(self.target.n_cores)],
            stdout=bytes(self.fdt.stdout),
            syscalls=dict(self.stats["syscalls"]),
            traffic=dict(sess.channel.bytes_by_cat),
            traffic_total=sess.channel.total_bytes,
            stall={"controller_cycles": sess.stats.controller_cycles,
                   "uart_ticks": sess.stats.uart_ticks,
                   "runtime_ticks": self.stats["runtime_ticks"],
                   "kernel_ticks": self.stats["kernel_ticks"]},
            sched={"ctx_switches": self.sched.ctx_switches,
                   "exceptions": self.stats["exceptions"],
                   "futex_waits": self.stats["futex_waits"],
                   "futex_wakes": self.stats["futex_wakes"],
                   "futex_wakes_empty": self.stats["futex_wakes_empty"]},
            vm=dict(self.vm.stats),
            hfutex={"hits": self.stats["hfutex_hits"],
                    "inserts": sess.hfutex.inserts},
            cq=(sess.cqstats.as_dict()
                if isinstance(sess, AsyncHtpSession) else {}),
            telemetry=(self.telemetry.report()
                       if self.telemetry is not None else {}),
            load_ticks=self.load_ticks,
            exit_code=self.exit_code,
        )
        return rep
