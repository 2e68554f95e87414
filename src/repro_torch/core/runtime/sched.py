"""Thread scheduling and synchronisation (paper §V-A).

Non-preemptive: a running CPU only context-switches at its next exception.
The scheduler owns full thread contexts host-side (the target core has no
notion of thread identity — a Redirect simply resumes from supplied state).
Futex wait queues are keyed by *physical* address.  Signals are delivered
through a host-saved-context trampoline: the handler runs on the thread's
stack and ``sigreturn`` restores the saved context (paper Fig 7(a)).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

READY, RUNNING, BLOCKED, EXITED = "ready", "running", "blocked", "exited"


@dataclass
class Thread:
    tid: int
    regs: list = field(default_factory=lambda: [0] * 32)
    pc: int = 0
    state: str = READY
    cpu: int = -1
    clear_child_tid: int = 0
    pending_signals: deque = field(default_factory=deque)
    saved_sigctx: tuple | None = None
    wake_value: int | None = None     # a0 to deliver on next schedule
    block_reason: str = ""
    utick_base: int = 0
    ready_at: int = 0                 # earliest tick this thread may start


class Scheduler:
    def __init__(self, n_cores: int):
        self.n_cores = n_cores
        self.threads: dict[int, Thread] = {}
        self.ready: deque[int] = deque()
        self.running: dict[int, int] = {}          # cpu -> tid
        self.futex_q: dict[int, deque[int]] = {}   # pa -> waiter tids
        self.next_tid = 2
        self.sigactions: dict[int, int] = {}       # signum -> handler va
        self.ctx_switches = 0

    # ------------------------------------------------------------------
    def new_thread(self, regs, pc) -> Thread:
        t = Thread(self.next_tid, list(regs), pc)
        self.next_tid += 1
        self.threads[t.tid] = t
        self.ready.append(t.tid)
        return t

    def current(self, cpu: int) -> Thread | None:
        tid = self.running.get(cpu)
        return self.threads.get(tid) if tid is not None else None

    def free_cpus(self, parked: set[int]) -> list[int]:
        return [c for c in parked if c not in self.running]

    def live_threads(self) -> int:
        return sum(1 for t in self.threads.values() if t.state != EXITED)

    # ---- state transitions -------------------------------------------
    def make_ready(self, tid: int, wake_value: int | None = None):
        t = self.threads[tid]
        if t.state == EXITED:
            return
        t.state = READY
        if wake_value is not None:
            t.wake_value = wake_value
        if tid not in self.ready:
            self.ready.append(tid)

    def block_current(self, cpu: int, reason: str) -> Thread:
        t = self.current(cpu)
        t.state = BLOCKED
        t.block_reason = reason
        del self.running[cpu]
        return t

    def exit_current(self, cpu: int) -> Thread:
        t = self.current(cpu)
        t.state = EXITED
        del self.running[cpu]
        return t

    def pick_next(self) -> int | None:
        while self.ready:
            tid = self.ready.popleft()
            if self.threads[tid].state == READY:
                return tid
        return None

    def assign(self, cpu: int, tid: int):
        self.running[cpu] = tid
        t = self.threads[tid]
        t.state = RUNNING
        t.cpu = cpu

    # ---- futex ----------------------------------------------------------
    def futex_wait(self, cpu: int, pa: int) -> Thread:
        t = self.block_current(cpu, f"futex@{pa:#x}")
        self.futex_q.setdefault(pa, deque()).append(t.tid)
        return t

    def futex_wake(self, pa: int, n: int) -> list[int]:
        q = self.futex_q.get(pa)
        woken = []
        while q and len(woken) < n:
            tid = q.popleft()
            if self.threads[tid].state == BLOCKED:
                woken.append(tid)
                self.make_ready(tid, wake_value=0)
        if q is not None and not q:
            del self.futex_q[pa]
        return woken

    # ---- signals ---------------------------------------------------------
    def post_signal(self, tid: int, signum: int) -> bool:
        t = self.threads.get(tid)
        if t is None or t.state == EXITED:
            return False
        t.pending_signals.append(signum)
        if t.state == BLOCKED:
            # EINTR semantics: wake the thread to take the signal
            for q in self.futex_q.values():
                if tid in q:
                    q.remove(tid)
                    break
            self.make_ready(tid, wake_value=-4)  # -EINTR
        return True
