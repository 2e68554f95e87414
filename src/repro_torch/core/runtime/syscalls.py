"""Linux-style syscall layer (paper §V): the host-side handlers that give
user programs a Linux-compatible contract without any target kernel.

Every argument-register read, result write and memory transfer is a
native :class:`~repro_torch.core.session.HtpTransaction` submitted on the
trapping hart's stream, so its wire bytes and latency are accounted; the
oracle ("full-system") timing mode instead charges the per-syscall
kernel-cost model — both modes share these handlers, so functional
behaviour is identical and only timing differs (that is the paper's
accuracy metric).  Argument registers are still read lazily (one RegR
transaction per touched arg): the traffic a syscall bills must scale with
the arguments its handler actually consumes.
"""
from __future__ import annotations

from ..session import HtpTransaction
from . import vm as vmod
from .vm import MAP_ANON, MAP_SHARED, PAGE, PROT_READ, PROT_WRITE

# RISC-V Linux syscall numbers
NR = {
    "io_setup": 0, "openat": 56, "close": 57, "lseek": 62, "read": 63,
    "write": 64, "writev": 66, "readlinkat": 78, "fstat": 80, "exit": 93,
    "exit_group": 94, "set_tid_address": 96, "futex": 98,
    "set_robust_list": 99, "clock_gettime": 113, "sched_yield": 124,
    "tgkill": 131, "rt_sigaction": 134, "rt_sigprocmask": 135,
    "rt_sigreturn": 139, "uname": 160, "getpid": 172, "gettid": 178,
    "brk": 214, "munmap": 215, "clone": 220, "mmap": 222, "mprotect": 226,
    "madvise": 233, "getrandom": 278,
}
NAME = {v: k for k, v in NR.items()}

FUTEX_WAIT, FUTEX_WAKE = 0, 1
FUTEX_CMD_MASK = 0x7F

EAGAIN, EBADF, EINVAL, ENOMEM, ENOENT, EINTR, ENOSYS = \
    11, 9, 22, 12, 2, 4, 38

# Oracle-mode ("full-system") kernel cost model, cycles @ target clock.
# Approximates in-kernel handling on the same core (LiteX/Linux role);
# I/O adds a per-byte term, mmap faults are charged per materialised page.
KERNEL_COST = {
    "write": 900, "read": 900, "openat": 2500, "close": 400, "lseek": 300,
    "fstat": 600, "brk": 600, "mmap": 1400, "munmap": 1600,
    "mprotect": 800, "clone": 3500, "futex_wait": 1100, "futex_wake": 550,
    "futex_wake0": 450, "clock_gettime": 320, "sched_yield": 500,
    "gettid": 160, "getpid": 160, "exit": 1800, "rt_sigaction": 350,
    "rt_sigreturn": 700, "tgkill": 800, "set_tid_address": 180,
    "set_robust_list": 180, "uname": 400, "getrandom": 700,
    "rt_sigprocmask": 250, "madvise": 300, "writev": 1000,
    "page_fault": 1400, "page_fault_per_page": 700, "io_per_byte": 0.03,
    "ctx_switch": 2600, "default": 600,
}


class SyscallError(Exception):
    pass


def dispatch(rt, cpu: int, thread, epc: int, t0: int) -> None:
    """Handle the ecall raised by ``thread`` on ``cpu`` trapped at ``t0``."""
    # snapshot the request counter BEFORE the a7 read: the host-latency
    # model bills exactly the requests this syscall's handling issues
    # (historically req0 started at 0, so every syscall re-billed all
    # requests since boot — quadratic host time in the syscall count)
    req0 = rt._total_requests()
    if rt.arg_prefetch:
        # speculative prefetch: the full a7 + a0..a5 register file crosses
        # the wire as ONE transaction at Next time; unused values are
        # discarded.  More bytes, fewer round trips — the crossover per
        # link is measured by benchmarks/arg_prefetch.py.
        txn = HtpTransaction().reg_read(cpu, 17, "argprefetch")
        for i in range(6):
            txn.reg_read(cpu, 10 + i, "argprefetch")
        res = rt.session.submit(txn, t0, stream=cpu)
        prefetched = dict(enumerate(res.values[1:]))
    else:
        res = rt.session.submit(HtpTransaction().reg_read(cpu, 17), t0,
                                stream=cpu)                   # a7
        prefetched = None
    t, nr = res.done, res.values[0]
    name = NAME.get(nr, f"sys_{nr}")
    rt.stats["syscalls"][name] = rt.stats["syscalls"].get(name, 0) + 1
    args = _ArgReader(rt, cpu, name, prefetched)
    args.t = t
    args.req0 = req0
    fn = _HANDLERS.get(name, _sys_enosys)
    fn(rt, cpu, thread, epc, args)


class _ArgReader:
    """Reads a0..a5 through the Reg ports with accounting — lazily (one
    RegR transaction per first-touched arg) or from the speculative
    prefetch (all six already local, no further wire traffic)."""

    def __init__(self, rt, cpu, cat, prefetched: dict | None = None):
        self.rt, self.cpu, self.cat = rt, cpu, cat
        self.t = 0
        self._vals = dict(prefetched) if prefetched else {}

    def __getitem__(self, i) -> int:
        if i not in self._vals:
            res = self.rt.session.submit(
                HtpTransaction().reg_read(self.cpu, 10 + i, self.cat),
                self.t, stream=self.cpu)
            self.t = res.done
            self._vals[i] = res.values[0]
        return self._vals[i]

    def signed(self, i) -> int:
        v = self[i]
        return v - (1 << 64) if v >> 63 else v


def _finish(rt, cpu, thread, epc, args, retval, kcost_key=None,
            extra_kcost=0):
    """Write a0, charge timing, resume at epc+4 (or take a signal)."""
    rv = retval & ((1 << 64) - 1)
    t = rt.session.submit(
        HtpTransaction().reg_write(cpu, 10, rv, args.cat),
        args.t, stream=cpu).done
    t = rt.charge(t, args, kcost_key or args.cat, extra_kcost)
    rt.resume(cpu, thread, epc + 4, t)


def _sys_enosys(rt, cpu, thread, epc, args):
    _finish(rt, cpu, thread, epc, args, -ENOSYS, "default")


# ---------------------------------------------------------------------------
def _sys_write(rt, cpu, thread, epc, args):
    fd, buf, count = args[0], args[1], args[2]
    count = min(count, 1 << 20)
    data, args.t = rt.vm.read_bytes(buf, count, cpu, args.t, "write")
    n = rt.fdt.write(fd, data)
    _finish(rt, cpu, thread, epc, args, n, "write",
            extra_kcost=int(KERNEL_COST["io_per_byte"] * count))


def _sys_writev(rt, cpu, thread, epc, args):
    fd, iov, iovcnt = args[0], args[1], args[2]
    total = 0
    for i in range(min(iovcnt, 16)):
        hdr, args.t = rt.vm.read_bytes(iov + 16 * i, 16, cpu, args.t,
                                       "write")
        base = int.from_bytes(hdr[:8], "little")
        ln = int.from_bytes(hdr[8:], "little")
        if ln:
            data, args.t = rt.vm.read_bytes(base, ln, cpu, args.t, "write")
            total += max(rt.fdt.write(fd, data), 0)
    _finish(rt, cpu, thread, epc, args, total, "writev")


def _sys_read(rt, cpu, thread, epc, args):
    fd, buf, count = args[0], args[1], args[2]
    data = rt.fdt.read(fd, min(count, 1 << 20))
    if data is None:
        # host-blocking read: park the thread, serve via the async helper
        rt.block_on_host_read(cpu, thread, epc, args, fd, buf, count)
        return
    args.t = rt.vm.write_bytes(buf, data, cpu, args.t, "read")
    _finish(rt, cpu, thread, epc, args, len(data), "read",
            extra_kcost=int(KERNEL_COST["io_per_byte"] * len(data)))


def _sys_openat(rt, cpu, thread, epc, args):
    path, args.t = rt.vm.read_cstr(args[1], cpu, args.t, "openat")
    fd = rt.fdt.openat(path.lstrip("./"), args[2])
    _finish(rt, cpu, thread, epc, args, fd if fd >= 0 else fd, "openat")


def _sys_close(rt, cpu, thread, epc, args):
    _finish(rt, cpu, thread, epc, args, rt.fdt.close(args[0]), "close")


def _sys_lseek(rt, cpu, thread, epc, args):
    _finish(rt, cpu, thread, epc, args,
            rt.fdt.lseek(args[0], args.signed(1), args[2]), "lseek")


def _sys_fstat(rt, cpu, thread, epc, args):
    fd, statbuf = args[0], args[1]
    size = rt.fdt.fstat_size(fd)
    st = bytearray(128)
    st[16:20] = (0o100644).to_bytes(4, "little")        # st_mode
    st[48:56] = size.to_bytes(8, "little")              # st_size
    st[56:64] = (4096).to_bytes(8, "little")            # st_blksize
    args.t = rt.vm.write_bytes(statbuf, bytes(st), cpu, args.t, "fstat")
    _finish(rt, cpu, thread, epc, args, 0, "fstat")


def _sys_brk(rt, cpu, thread, epc, args):
    new, args.t = rt.vm.set_brk(args[0], cpu, args.t)
    _finish(rt, cpu, thread, epc, args, new, "brk")


def _sys_mmap(rt, cpu, thread, epc, args):
    addr, length, prot, flags, fd = args[0], args[1], args[2], args[3], \
        args[4]
    off = args[5]
    if length == 0:
        return _finish(rt, cpu, thread, epc, args, -EINVAL, "mmap")
    f = None
    if not (flags & MAP_ANON):
        of = rt.fdt.fds.get(fd)
        if of is None:
            return _finish(rt, cpu, thread, epc, args, -EBADF, "mmap")
        f = of.file
    va = rt.vm.mmap(length, prot, flags, f, off)
    _finish(rt, cpu, thread, epc, args, va, "mmap")


def _sys_munmap(rt, cpu, thread, epc, args):
    addr, length = args[0], args[1]
    npages = (length + PAGE - 1) // PAGE
    args.t = rt.vm.munmap(addr, length, cpu, args.t)
    _finish(rt, cpu, thread, epc, args, 0, "munmap",
            extra_kcost=npages * 60)


def _sys_mprotect(rt, cpu, thread, epc, args):
    _finish(rt, cpu, thread, epc, args, 0, "mprotect")


def _sys_madvise(rt, cpu, thread, epc, args):
    _finish(rt, cpu, thread, epc, args, 0, "madvise")


def _sys_clock_gettime(rt, cpu, thread, epc, args):
    ts_va = args[1]
    ns = rt.tick_ns(args.t)
    blob = (ns // 1_000_000_000).to_bytes(8, "little") + \
        (ns % 1_000_000_000).to_bytes(8, "little")
    args.t = rt.vm.write_bytes(ts_va, blob, cpu, args.t, "clock_gettime")
    _finish(rt, cpu, thread, epc, args, 0, "clock_gettime")


def _sys_gettid(rt, cpu, thread, epc, args):
    _finish(rt, cpu, thread, epc, args, thread.tid, "gettid")


def _sys_getpid(rt, cpu, thread, epc, args):
    _finish(rt, cpu, thread, epc, args, 1, "getpid")


def _sys_uname(rt, cpu, thread, epc, args):
    buf = bytearray(65 * 6)
    for i, s in enumerate([b"Linux", b"fase", b"6.1.0-fase", b"#1",
                           b"riscv64", b""]):
        buf[65 * i:65 * i + len(s)] = s
    args.t = rt.vm.write_bytes(args[0], bytes(buf), cpu, args.t, "uname")
    _finish(rt, cpu, thread, epc, args, 0, "uname")


def _sys_getrandom(rt, cpu, thread, epc, args):
    buf, n = args[0], min(args[1], 256)
    rt.prng_state = (rt.prng_state * 6364136223846793005 + 1442695040888963407) \
        & ((1 << 64) - 1)
    data = (rt.prng_state.to_bytes(8, "little") * ((n + 7) // 8))[:n]
    args.t = rt.vm.write_bytes(buf, data, cpu, args.t, "getrandom")
    _finish(rt, cpu, thread, epc, args, n, "getrandom")


def _sys_set_tid_address(rt, cpu, thread, epc, args):
    thread.clear_child_tid = args[0]
    _finish(rt, cpu, thread, epc, args, thread.tid, "set_tid_address")


def _sys_set_robust_list(rt, cpu, thread, epc, args):
    _finish(rt, cpu, thread, epc, args, 0, "set_robust_list")


def _sys_rt_sigaction(rt, cpu, thread, epc, args):
    signum, act = args[0], args[1]
    if act:
        blob, args.t = rt.vm.read_bytes(act, 8, cpu, args.t, "rt_sigaction")
        rt.sched.sigactions[signum] = int.from_bytes(blob, "little")
    _finish(rt, cpu, thread, epc, args, 0, "rt_sigaction")


def _sys_rt_sigprocmask(rt, cpu, thread, epc, args):
    _finish(rt, cpu, thread, epc, args, 0, "rt_sigprocmask")


def _sys_rt_sigreturn(rt, cpu, thread, epc, args):
    regs, pc = thread.saved_sigctx
    thread.saved_sigctx = None
    thread.regs = list(regs)
    thread.pc = pc
    t = rt.charge(args.t, args, "rt_sigreturn", 0)
    rt.switch_in(cpu, thread, t)          # full context restore


def _sys_tgkill(rt, cpu, thread, epc, args):
    tid, sig = args[1], args[2]
    ok = rt.sched.post_signal(tid, sig)
    _finish(rt, cpu, thread, epc, args, 0 if ok else -ENOENT, "tgkill")


def _sys_sched_yield(rt, cpu, thread, epc, args):
    t = rt.charge(args.t, args, "sched_yield", 0)
    t = rt.save_context(cpu, thread, epc + 4, t)
    thread.regs[10] = 0
    rt.sched.block_current(cpu, "yield")
    rt.sched.make_ready(thread.tid)
    rt.schedule_onto(cpu, t)


def _sys_exit(rt, cpu, thread, epc, args):
    t = rt.charge(args.t, args, "exit", 0)
    rt.thread_exit(cpu, thread, t)


def _sys_clone(rt, cpu, thread, epc, args):
    flags, child_sp, ptid, tls, ctid = (args[0], args[1], args[2],
                                        args[3], args[4])
    t = args.t
    # child context = parent registers at the ecall, with a0=0, sp, tp
    t = rt.save_context(cpu, thread, epc + 4, t, keep_running=True)
    child_regs = list(thread.regs)
    child_regs[10] = 0        # a0 = 0 in child
    child_regs[2] = child_sp  # sp
    child_regs[4] = tls       # tp
    child = rt.sched.new_thread(child_regs, epc + 4)
    CLONE_CHILD_SETTID, CLONE_CHILD_CLEARTID, CLONE_PARENT_SETTID = \
        0x01000000, 0x00200000, 0x00100000
    if flags & CLONE_CHILD_SETTID and ctid:
        t = rt.vm.write_bytes(ctid, child.tid.to_bytes(8, "little"), cpu,
                              t, "clone")
    if flags & CLONE_PARENT_SETTID and ptid:
        t = rt.vm.write_bytes(ptid, child.tid.to_bytes(8, "little"), cpu,
                              t, "clone")
    if flags & CLONE_CHILD_CLEARTID:
        child.clear_child_tid = ctid
    args.t = t
    _finish(rt, cpu, thread, epc, args, child.tid, "clone")


def _sys_futex(rt, cpu, thread, epc, args):
    uaddr, op, val = args[0], args[1], args[2]
    cmd = op & FUTEX_CMD_MASK & ~0x80
    t = args.t
    if cmd == FUTEX_WAIT:
        t = rt.vm.ensure_mapped(uaddr, 4, cpu, t)
        pa = rt.vm.translate(uaddr)
        res = rt.session.submit(
            HtpTransaction().mem_read(cpu, pa & ~7, "futex"), t,
            stream=cpu)
        t, word = res.done, res.values[0]
        cur = (word >> ((pa & 4) * 8)) & 0xFFFFFFFF
        if cur != (val & 0xFFFFFFFF):
            args.t = t
            return _finish(rt, cpu, thread, epc, args, -EAGAIN,
                           "futex_wait")
        # clear HFutex masks holding this pa (wakes must reach the host
        # now); one mask-update batch covers every touched core
        touched = rt.session.hfutex.clear_pa(pa & ~3)
        if touched:
            txn = HtpTransaction()
            for c in touched:
                txn.hfutex_update(c)
            t = rt.session.submit(txn, t, stream=cpu).done
        t = rt.charge(t, args, "futex_wait", 0)
        t = rt.save_context(cpu, thread, epc + 4, t)
        thread.regs[10] = 0          # default wake result
        rt.sched.futex_wait(cpu, pa & ~3)
        rt.stats["futex_waits"] += 1
        rt.schedule_onto(cpu, t)
        return
    if cmd == FUTEX_WAKE:
        t = rt.vm.ensure_mapped(uaddr, 4, cpu, t)
        pa = rt.vm.translate(uaddr) & ~3
        woken = rt.sched.futex_wake(pa, val)
        rt.stats["futex_wakes"] += 1
        if not woken:
            rt.stats["futex_wakes_empty"] += 1
            if rt.session.hfutex.insert(cpu, uaddr, pa):
                t = rt.session.submit(
                    HtpTransaction().hfutex_update(cpu), t,
                    stream=cpu).done
        else:
            rt.wake_threads(woken, t)
        args.t = t
        return _finish(rt, cpu, thread, epc, args, len(woken),
                       "futex_wake" if woken else "futex_wake0")
    args.t = t
    _finish(rt, cpu, thread, epc, args, -ENOSYS, "default")


_HANDLERS = {
    "write": _sys_write, "writev": _sys_writev, "read": _sys_read,
    "openat": _sys_openat, "close": _sys_close, "lseek": _sys_lseek,
    "fstat": _sys_fstat, "brk": _sys_brk, "mmap": _sys_mmap,
    "munmap": _sys_munmap, "mprotect": _sys_mprotect,
    "madvise": _sys_madvise, "clock_gettime": _sys_clock_gettime,
    "gettid": _sys_gettid, "getpid": _sys_getpid, "uname": _sys_uname,
    "getrandom": _sys_getrandom, "set_tid_address": _sys_set_tid_address,
    "set_robust_list": _sys_set_robust_list,
    "rt_sigaction": _sys_rt_sigaction,
    "rt_sigprocmask": _sys_rt_sigprocmask,
    "rt_sigreturn": _sys_rt_sigreturn, "tgkill": _sys_tgkill,
    "sched_yield": _sys_sched_yield, "exit": _sys_exit,
    "exit_group": _sys_exit, "clone": _sys_clone, "futex": _sys_futex,
}
