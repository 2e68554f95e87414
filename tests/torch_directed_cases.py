"""The directed regressions of ``tests/test_torch_cpu_directed.py`` as
data, free of JAX, so that every interpreter of the port can be driven
through them: the eager loop on the CPU, the chunk kernel on the card
(``tests/test_torch_gpu.py``) and the chunk kernel's source compiled for
the host (``tests/test_torch_run_chunk_shim.py``).

A case is a program, its core count, whether the MMU is on, and a
``drive`` generator that steps one target through the regression.  It
yields at each point where two targets must agree, and asserts what the
regression pins on the target it drives.  ``pysim`` says whether
``PySim`` is an oracle for the case: its host-side TLB may serve a stale
mapping until an sfence, so the store-over-a-cached-PTE case is held
against the eager loop only.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.core.target import asm
from repro_torch.core.target import isa

PTE_FLAGS = (isa.PTE_V | isa.PTE_R | isa.PTE_W | isa.PTE_X | isa.PTE_U |
             isa.PTE_A | isa.PTE_D)
#: the image of every case: 2 MiB
MEM = 1 << 21
#: the interpreter knobs the regressions sweep (the fuzzer's axes)
CONFIGS = [dict(block_cache=True, dtlb_ways=8),
           dict(block_cache=False, dtlb_ways=8),
           dict(block_cache=True, dtlb_ways=0),
           dict(block_cache=False, dtlb_ways=0)]

PRIV_SRC = """
_start:
    addi t0, t0, 5
    addi t0, t0, 7
    mul t1, t0, t0
    li a7, 93
    ecall
"""

#: ``addi t1, t1, 77``, stored over the ``nop`` at ``site``
SMC_PATCH = isa.enc_i(isa.OP_IMM, isa.reg_num("t1"), 0, isa.reg_num("t1"),
                      77)
SMC_SRC = f"""
_start:
    la s0, site
    li t0, {SMC_PATCH}
    sw t0, 0(s0)
    nop
site:
    nop
    li a7, 93
    ecall
"""

#: the leaf PTE of vpn 20 remapped to ppn 21, and ``addi s6, s6, 77``
DTLB_PTE = (21 << 10) | PTE_FLAGS
DTLB_PATCH = isa.enc_i(isa.OP_IMM, isa.reg_num("s6"), 0, isa.reg_num("s6"),
                       77)
DTLB_SRC = f"""
_start:
    li s1, 0x14000
    li s2, {{pte_page:#x}}
    li t0, 0xAAAA
    sd t0, 0(s1)
    ld t1, 0(s1)
    li t2, {DTLB_PTE}
    sd t2, 160(s2)
    ld t3, 0(s1)
    li t4, 0xBBBB
    sd t4, 0(s1)
    ld t5, 0(s1)
    la s3, site
    lw s4, 0(s3)
    li s5, {DTLB_PATCH}
    sw s5, 0(s3)
    nop
site:
    nop
    li a7, 93
    ecall
"""
#: the store reaches the l0 table (ppn 4) through vpn 4, whose data-TLB
#: way (4 of 8) is vpn 20's: the walk's fill evicts vpn 20 before the
#: store kills it.  Through vpn 97 (way 1) only the kill removes vpn 20.
DTLB_ALIASED_SRC = DTLB_SRC.format(pte_page=0x4000)
DTLB_KILL_SRC = DTLB_SRC.format(pte_page=97 << 12)

SFENCE_SRC = """
_start:
    li s1, 0x14000
    li s9, 100000
1:
    ld t1, 0(s1)
    addi s9, s9, -1
    bnez s9, 1b
    li a7, 93
    ecall
"""

STALL_SRC = """
_start:
    addi t0, t0, 1
    addi t0, t0, 2
    li a7, 93
    ecall
"""


def load(t, img, nc, mmu, extra=()):
    """The image through the target's own accessors, and with ``mmu``
    the page tables of ``tests/test_cpu_differential.py::build_tables``
    (root/l1/l0 at ppn 2/3/4, identity leaves for vpn 16..95 and
    256..271) plus a leaf for each ``(vpn, ppn)`` of ``extra``."""
    for seg in img.segments:
        data = bytes(seg.data)
        n = (len(data) + 7) // 8
        words = np.frombuffer(data.ljust(n * 8, b"\0"), dtype=np.uint64)
        for i, w in enumerate(words):
            t.mem_write_word(seg.vaddr + 8 * i, int(w))
    if mmu:
        t.mem_write_word(2 * 4096, (3 << 10) | isa.PTE_V)
        t.mem_write_word(3 * 4096, (4 << 10) | isa.PTE_V)
        for vpn0 in list(range(16, 96)) + list(range(256, 272)):
            t.mem_write_word(4 * 4096 + vpn0 * 8, (vpn0 << 10) | PTE_FLAGS)
        for c in range(t.n_cores):
            t.set_satp(c, (8 << 60) | 2)
        for vpn0, ppn in extra:
            t.mem_write_word(4 * 4096 + vpn0 * 8, (ppn << 10) | PTE_FLAGS)
    for c in range(nc):
        t.reg_write(c, 10, c)
        t.redirect(c, img.entry)


def _priv_gate(t):
    """An S-mode (priv=1) core must execute: the gate is ``priv != 3``."""
    t.csr_write(0, "priv", 1)
    t.run(max_cycles=64)
    assert t.get_instret(0) == 4
    assert t.pending_cores() == [0]
    yield "priv=1"


def _smc(t):
    """A store into the instruction stream just ahead of execution is
    fetched back, not replayed from a stale fetch block."""
    t.run(max_cycles=64)
    assert t.reg_read(0, isa.reg_num("t1")) == 77
    yield "smc"


def _dtlb_store(t):
    """A store over a leaf PTE that the data TLB caches kills the entry
    within the same chunk, and an SMC store whose PA came from a TLB hit
    still kills the fetch block."""
    t.run(max_cycles=500)
    r = isa.reg_num
    assert t.reg_read(0, r("t1")) == 0xAAAA
    assert t.reg_read(0, r("t3")) == 0           # post-remap load re-walked
    assert t.reg_read(0, r("t5")) == 0xBBBB
    assert t.reg_read(0, r("s6")) == 77          # patched inst executed
    assert t.mem_read_word(0x14000) == 0xAAAA
    assert t.mem_read_word(0x15000) == 0xBBBB
    yield "dtlb-smc"


def _sfence(t):
    """A host PTE change and an sfence between chunks: the next chunk
    sees the new mapping."""
    t.mem_write_word(0x14000, 0x111)
    t.mem_write_word(0x15000, 0x222)
    t.run(max_cycles=90)
    assert t.reg_read(0, isa.reg_num("t1")) == 0x111
    yield "before-sfence"
    t.mem_write_word(4 * 4096 + 20 * 8, DTLB_PTE)      # remap vpn 20
    t.sfence(0)
    t.run(max_cycles=90)
    assert t.reg_read(0, isa.reg_num("t1")) == 0x222
    yield "sfence"


def _stall(t):
    """A core stalled far in the future: the clock jumps to the wake-up
    in one substep, clamped to the chunk budget, and stall ticks
    accrue."""
    t.redirect(1, 0x10000, resume_tick=5000)
    t.run(max_cycles=1000)
    yield "clamped"
    t.clear_pending(0)
    t.park(0)
    t.run(max_cycles=100_000)
    assert t.get_ticks() > 5000
    if hasattr(t, "st"):
        assert int(t.st.stall_ticks[1]) >= 4000
    yield "woken"


@dataclass(frozen=True)
class Case:
    name: str
    src: str
    nc: int
    mmu: bool
    drive: Callable
    #: the interpreter knobs the case runs under
    configs: tuple = tuple(CONFIGS)
    load_kw: dict = field(default_factory=dict)
    pysim: bool = True


_WAYS = (dict(dtlb_ways=0), dict(dtlb_ways=8))
CASES = [
    Case("priv_gate", PRIV_SRC, 1, False, _priv_gate),
    Case("self_modifying_code", SMC_SRC, 1, False, _smc),
    Case("dtlb_store_over_cached_pte", DTLB_ALIASED_SRC, 1, True,
         _dtlb_store, configs=_WAYS, load_kw=dict(extra=((4, 4),)),
         pysim=False),
    Case("dtlb_store_over_cached_pte_kills_entry", DTLB_KILL_SRC, 1, True,
         _dtlb_store, configs=_WAYS, load_kw=dict(extra=((97, 4),)),
         pysim=False),
    Case("dtlb_host_pte_change_with_sfence", SFENCE_SRC, 1, True, _sfence,
         configs=_WAYS),
    Case("stall_fast_forward_and_budget_clamp", STALL_SRC, 2, False, _stall,
         configs=(dict(),)),
]
#: (case, knobs) pairs, with a readable id each
PARAMS = [(case, kw) for case in CASES for kw in case.configs]
IDS = [f"{case.name}-" + ("-".join(f"{k}{v}" for k, v in kw.items())
                          or "default")
       for case, kw in PARAMS]


def run_in_lockstep(case, targets, compare):
    """Load ``case`` on every target, step them through its ``drive``
    together, and call ``compare(targets, checkpoint)`` at each point
    where the case yields."""
    img = asm.assemble(case.src)
    drives = []
    for t in targets:
        load(t, img, case.nc, case.mmu, **case.load_kw)
        drives.append(case.drive(t))
    while True:
        points = [next(d, None) for d in drives]
        if points[0] is None:
            assert all(p is None for p in points)
            return
        compare(targets, points[0])
