"""Directed regressions for the PyTorch target, each held against the
``JaxTarget`` fast path (whole state) and ``PySim``: the directed
atomics/MMU program, the S-mode privilege gate, self-modifying code vs
the fetch-block cache, data-TLB invalidation inside and between chunks.
Integer state; tolerance 0."""
import pytest

from repro.core.interface import JaxTarget
from repro.core.target import isa
from repro.core.target.pysim import PySim
from repro_torch.core.interface import TorchTarget
from repro_torch.core.target import asm as tasm
from repro_torch.core.target import isa as tisa

from test_cpu_differential import SRC as DIRECTED_SRC
from test_torch_cpu_differential import (CONFIGS, MEM, assert_same_as_jax,
                                         assert_same_as_pysim, load_image,
                                         make_trio)

PTE_FLAGS = (isa.PTE_V | isa.PTE_R | isa.PTE_W | isa.PTE_X | isa.PTE_U |
             isa.PTE_A | isa.PTE_D)


def test_isa_copy_is_identical():
    names = [n for n in dir(isa) if n.isupper()]
    assert len(names) > 40
    for n in names:
        assert getattr(tisa, n) == getattr(isa, n), n


@pytest.mark.parametrize("nc", [1, 4])
def test_torch_directed_program(nc):
    """Atomics + MMU + byte/half traffic + M extension, to completion."""
    tt, jt, ps = make_trio(DIRECTED_SRC, nc, {}, True)
    for t in (tt, jt, ps):
        for _ in range(nc * 2):
            for c in t.pending_cores():
                t.clear_pending(c)
                t.park(c)
            t.run()
    assert_same_as_jax(tt, jt, "directed")
    assert_same_as_pysim(tt, ps, "directed")
    assert tt.get_instret(0) > 500


@pytest.mark.parametrize("kw", CONFIGS)
def test_torch_priv_gate(kw):
    """An S-mode (priv=1) core must execute: the gate is ``priv != 3``."""
    src = """
_start:
    addi t0, t0, 5
    addi t0, t0, 7
    mul t1, t0, t0
    li a7, 93
    ecall
"""
    tt, jt, ps = make_trio(src, 1, kw, False)
    for t in (tt, jt, ps):
        t.csr_write(0, "priv", 1)
        t.run(max_cycles=64)
    assert tt.get_instret(0) == 4
    assert tt.pending_cores() == [0]
    assert_same_as_jax(tt, jt, "priv=1")
    assert_same_as_pysim(tt, ps, "priv=1")


@pytest.mark.parametrize("kw", CONFIGS)
def test_torch_self_modifying_code(kw):
    """A store into the instruction stream just ahead of execution must
    be fetched back, not replayed from a stale fetch block."""
    patched = isa.enc_i(isa.OP_IMM, isa.reg_num("t1"), 0,
                        isa.reg_num("t1"), 77)     # addi t1, t1, 77
    src = f"""
_start:
    la s0, site
    li t0, {patched}
    sw t0, 0(s0)
    nop
site:
    nop
    li a7, 93
    ecall
"""
    tt, jt, ps = make_trio(src, 1, kw, False)
    for t in (tt, jt, ps):
        t.run(max_cycles=64)
    assert tt.reg_read(0, isa.reg_num("t1")) == 77
    assert_same_as_jax(tt, jt, "smc")
    assert_same_as_pysim(tt, ps, "smc")


@pytest.mark.parametrize("ways", [0, 8])
def test_torch_dtlb_store_over_cached_pte_rewalks_in_chunk(ways):
    """A guest store that overlaps a leaf PTE cached by the data-side
    translation cache must kill the cached entry within the SAME chunk,
    and an SMC store whose PA came from a dtlb hit still invalidates the
    fetch block.  (PySim's host-side TLB may legitimately serve the stale
    mapping until an sfence, so the oracle here is the JAX fast path.)"""
    new_pte = (21 << 10) | PTE_FLAGS        # remap vpn 20 -> ppn 21
    patched = isa.enc_i(isa.OP_IMM, isa.reg_num("s6"), 0,
                        isa.reg_num("s6"), 77)
    src = f"""
_start:
    li s1, 0x14000
    li s2, 0x4000
    li t0, 0xAAAA
    sd t0, 0(s1)
    ld t1, 0(s1)
    li t2, {new_pte}
    sd t2, 160(s2)
    ld t3, 0(s1)
    li t4, 0xBBBB
    sd t4, 0(s1)
    ld t5, 0(s1)
    la s3, site
    lw s4, 0(s3)
    li s5, {patched}
    sw s5, 0(s3)
    nop
site:
    nop
    li a7, 93
    ecall
"""
    img = tasm.assemble(src)
    tt = TorchTarget(1, MEM, device="cpu", dtlb_ways=ways)
    jt = JaxTarget(1, MEM, dtlb_ways=ways)
    for t in (tt, jt):
        load_image(t, img, 1, True, extra_vpn0=(4,), flags=PTE_FLAGS)
        t.run(max_cycles=500)
    r = isa.reg_num
    assert tt.reg_read(0, r("t1")) == 0xAAAA
    assert tt.reg_read(0, r("t3")) == 0          # post-remap load re-walked
    assert tt.reg_read(0, r("t5")) == 0xBBBB
    assert tt.reg_read(0, r("s6")) == 77         # patched inst executed
    assert tt.mem_read_word(0x14000) == 0xAAAA
    assert tt.mem_read_word(0x15000) == 0xBBBB
    assert_same_as_jax(tt, jt, "dtlb-smc")


@pytest.mark.parametrize("ways", [0, 8])
def test_torch_dtlb_host_pte_change_with_sfence_rewalks(ways):
    """Host-driven PTE change + sfence between chunks: the next chunk
    sees the new mapping, because the caches are chunk-local."""
    src = """
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
    img = tasm.assemble(src)
    new_pte = (21 << 10) | PTE_FLAGS
    tt = TorchTarget(1, MEM, device="cpu", dtlb_ways=ways)
    jt = JaxTarget(1, MEM, dtlb_ways=ways)
    ps = PySim(1, MEM)
    for t in (tt, jt, ps):
        load_image(t, img, 1, True)
        t.mem_write_word(0x14000, 0x111)
        t.mem_write_word(0x15000, 0x222)
        t.run(max_cycles=90)
        assert t.reg_read(0, isa.reg_num("t1")) == 0x111
        t.mem_write_word(4 * 4096 + 20 * 8, new_pte)   # remap vpn 20
        t.sfence(0)
        t.run(max_cycles=90)
        assert t.reg_read(0, isa.reg_num("t1")) == 0x222
    assert_same_as_jax(tt, jt, "sfence")
    assert_same_as_pysim(tt, ps, "sfence")


def test_torch_stall_fast_forward_and_budget_clamp():
    """A core stalled far in the future: the clock jumps to the wake-up
    in one substep, clamped to the chunk budget, and stall ticks accrue."""
    src = """
_start:
    addi t0, t0, 1
    addi t0, t0, 2
    li a7, 93
    ecall
"""
    tt, jt, ps = make_trio(src, 2, {}, False)
    for t in (tt, jt, ps):
        t.redirect(1, 0x10000, resume_tick=5000)
        t.run(max_cycles=1000)
    assert tt.get_ticks() == ps.get_ticks()
    assert_same_as_jax(tt, jt, "clamped")
    for t in (tt, jt, ps):
        t.clear_pending(0)
        t.park(0)
        t.run(max_cycles=100_000)
    assert tt.get_ticks() > 5000
    assert_same_as_jax(tt, jt, "woken")
    assert_same_as_pysim(tt, ps, "woken")
    assert int(tt.st.stall_ticks[1]) >= 4000
