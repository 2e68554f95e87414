"""The port's host stack (runtime, syscalls, scheduler, VM, session,
queue pair, channel model) over ``TorchTarget(device="cpu")``: whole run
reports must equal the JAX package's own run of the same guest program
on its pure-Python target.  Integer results; tolerance 0."""
import pytest

from repro.core.runtime import FaseRuntime as JFaseRuntime
from repro.core.target import asm as jasm
from repro.core.target.pysim import PySim
from repro.core.workloads import build as jbuild
from repro.core.workloads.libc import LIBC as JLIBC
from repro_torch.core.interface import TorchTarget
from repro_torch.core.runtime import FaseRuntime
from repro_torch.core.target import asm
from repro_torch.core.workloads import build
from repro_torch.core.workloads.libc import LIBC

from test_session import PAGE_HEAVY

THREADS = """
main:
    addi sp, sp, -32
    sd ra, 24(sp)
    sd s0, 16(sp)
    la a0, workerfn
    li a1, 21
    call thread_spawn
    mv s0, a0
    la a0, workerfn
    li a1, 21
    call thread_spawn
    sd a0, 8(sp)
    mv a0, s0
    call thread_join
    ld a0, 8(sp)
    call thread_join
    la t0, total
    ld a1, 0(t0)
    la a0, .Lmsg
    call print_kv
    li a0, 0
    ld s0, 16(sp)
    ld ra, 24(sp)
    addi sp, sp, 32
    ret
workerfn:
    la t0, total
    amoadd.d t1, a0, (t0)
    li a0, 0
    ret
.data
.Lmsg: .asciz "total"
.align 3
total: .dword 0
"""


def _key(rep):
    return dict(ticks=rep.ticks, instret=list(rep.instret),
                uticks=list(rep.uticks), stdout=rep.stdout,
                traffic=dict(rep.traffic), traffic_total=rep.traffic_total,
                stall=dict(rep.stall), sched=dict(rep.sched),
                syscalls=dict(rep.syscalls))


def _both(src_or_name, nc, mem, argv, **rt_kw):
    if src_or_name in ("hello",):
        timg, jimg = build(src_or_name), jbuild(src_or_name)
    else:
        assert LIBC == JLIBC
        timg = asm.assemble(LIBC + "\n.text\n" + src_or_name)
        jimg = jasm.assemble(JLIBC + "\n.text\n" + src_or_name)
    rt = FaseRuntime(TorchTarget(nc, mem, device="cpu"), **rt_kw)
    rt.load(timg, argv)
    rep = rt.run(max_ticks=1 << 34)
    jrt = JFaseRuntime(PySim(nc, mem), **rt_kw)
    jrt.load(jimg, argv)
    jrep = jrt.run(max_ticks=1 << 34)
    return rt, rep, jrep


@pytest.mark.parametrize("mode,link", [("fase", "uart"), ("fase", "pcie"),
                                       ("oracle", None)])
def test_torch_hello_modes_and_links(mode, link):
    rt, rep, jrep = _both("hello", 1, 1 << 22, ["hello"], mode=mode,
                          link=link)
    assert b"hello from FASE target" in rep.stdout
    assert rep.syscalls["write"] == 5
    assert _key(rep) == _key(jrep)


@pytest.mark.parametrize("session", ["sync", "async"])
def test_torch_threads_clone_join_futex(session):
    rt, rep, jrep = _both(THREADS, 2, 1 << 22, ["threads"], mode="fase",
                          session=session)
    assert b"total 42" in rep.stdout
    assert rep.syscalls.get("clone") == 2
    assert _key(rep) == _key(jrep)


def test_torch_page_heavy_traffic_reduction_95pct():
    """The paper's traffic claim through the port's session copy: a
    page-fault/munmap-churn workload sees >= 95 % total traffic reduction
    against the per-port baseline, with the same bytes as the reference."""
    tot = {}
    for direct in (False, True):
        rt, rep, jrep = _both(PAGE_HEAVY, 1, 1 << 23, ["ph"], mode="fase",
                              direct_mode=direct)
        assert _key(rep) == _key(jrep)
        tot[direct] = rep.traffic_total
    assert tot[False] <= 0.05 * tot[True]
