"""Lockstep differential fuzzer for the PyTorch target.

The same seeded RV64IMA programs the JAX package's fuzzer generates
(``tests/test_cpu_differential.py``) run in lockstep chunks on three
targets — ``TorchTarget(device="cpu")``, the ``JaxTarget`` fast path with
the same knobs, and ``PySim`` — and after every chunk the WHOLE state is
compared: every ``CpuState`` field including the memory image and the
model counters against ``JaxTarget`` (the two share the substep
structure, so even ``fetch_hits``/``tlb_walks`` must agree), and the
architectural state against ``PySim``.  Integer state; tolerance 0.

Axes: 1/2/4 cores, MMU on/off, AMO and LR/SC on shared cells (the
generator's atomic runs), block cache on/off, ``dtlb_ways`` 0/8.
"""
import os

import numpy as np
import pytest

from repro.core.interface import JaxTarget
from repro.core.target import asm as jasm
from repro.core.target.pysim import PySim
from repro_torch.core.interface import TorchTarget
from repro_torch.core.target import asm as tasm
from repro_torch.core.target.convert import state_from_numpy, state_to_numpy
from repro_torch.core.target.cpu import STATE_FIELDS

from test_cpu_differential import _ProgGen, build_tables

MEM = 1 << 21
M64 = (1 << 64) - 1
FUZZ_SEEDS = int(os.environ.get("FASE_TORCH_FUZZ_SEEDS", "6"))

CONFIGS = [
    pytest.param(dict(block_cache=True, dtlb_ways=8), id="cache-dtlb8"),
    pytest.param(dict(block_cache=False, dtlb_ways=8), id="nocache-dtlb8"),
    pytest.param(dict(block_cache=True, dtlb_ways=0), id="cache-dtlb0"),
    pytest.param(dict(block_cache=False, dtlb_ways=0), id="nocache-dtlb0"),
]


def jax_state_numpy(jt):
    return {name: np.asarray(getattr(jt.st, name)) for name in STATE_FIELDS}


def assert_same_as_jax(tt, jt, ctx):
    """Every state field, bit for bit (counters and memory included)."""
    want = jax_state_numpy(jt)
    got = state_to_numpy(tt.st)
    for name in STATE_FIELDS:
        w, g = want[name], got[name]
        assert w.shape == g.shape, (ctx, name, w.shape, g.shape)
        if not np.array_equal(w, g):
            bad = np.argwhere(w != g)[:8].tolist()
            raise AssertionError((ctx, name, bad))


def assert_same_as_pysim(tt, ps, ctx):
    nc = ps.n_cores
    assert tt.get_ticks() == ps.get_ticks(), ctx
    assert tt.pending_cores() == ps.pending_cores(), ctx
    regs, csrs, _ = tt.fetch_batch(
        regs=[(c, r) for c in range(nc) for r in range(32)],
        csrs=[(c, n) for c in range(nc)
              for n in ("pc", "priv", "satp", "mcause", "mepc", "mtval",
                        "stall_until", "res", "uticks", "instret")])
    it_r, it_c = iter(regs), iter(csrs)
    for c in range(nc):
        for r in range(32):
            assert next(it_r) == ps.reg_read(c, r) & M64, (ctx, c, r)
        for n in ("pc", "priv", "satp", "mcause", "mepc", "mtval",
                  "stall_until", "res"):
            assert next(it_c) == ps.csr_read(c, n) & M64, (ctx, c, n)
        assert next(it_c) == ps.get_uticks(c), (ctx, c)
        assert next(it_c) == ps.get_instret(c), (ctx, c)
    tmem = state_to_numpy(tt.st)["mem"]
    pmem = np.frombuffer(bytes(ps.mem), dtype=np.uint64)
    diff = np.nonzero(tmem != pmem)[0]
    assert diff.size == 0, (ctx, [hex(int(i) * 8) for i in diff[:8]])


def load_image(t, img, nc, mmu, extra_vpn0=(), flags=None):
    for seg in img.segments:
        data = bytes(seg.data)
        n = (len(data) + 7) // 8
        words = np.frombuffer(data.ljust(n * 8, b"\0"), dtype=np.uint64)
        for i, w in enumerate(words):
            t.mem_write_word(seg.vaddr + 8 * i, int(w))
    if mmu:
        build_tables(t)
        for vpn0 in extra_vpn0:
            t.mem_write_word(4 * 4096 + vpn0 * 8, (vpn0 << 10) | flags)
    for c in range(nc):
        t.reg_write(c, 10, c)
        t.redirect(c, img.entry)


def make_trio(src, nc, kw, mmu, mem=MEM, **load_kw):
    """The three targets with the same image loaded through their own
    accessors (the port assembles with its own assembler copy)."""
    timg = tasm.assemble(src)
    jimg = jasm.assemble(src)
    assert [bytes(s.data) for s in timg.segments] == \
        [bytes(s.data) for s in jimg.segments]
    tt = TorchTarget(nc, mem, device="cpu", **kw)
    jt = JaxTarget(nc, mem, fast_path=True, **kw)
    ps = PySim(nc, mem)
    load_image(tt, timg, nc, mmu, **load_kw)
    load_image(jt, jimg, nc, mmu, **load_kw)
    load_image(ps, jimg, nc, mmu, **load_kw)
    return tt, jt, ps


def run_lockstep(src, nc, kw, mmu, chunk=379, max_chunks=400,
                 reseed_at=None):
    tt, jt, ps = make_trio(src, nc, kw, mmu)
    assert_same_as_jax(tt, jt, "loaded")
    for step in range(max_chunks):
        if step == reseed_at:
            # carry the state across through numpy: the port continues
            # from the JAX target's arrays
            tt.st = state_from_numpy(jax_state_numpy(jt), "cpu")
        for t in (tt, jt, ps):
            t.run(max_cycles=chunk)
        assert_same_as_jax(tt, jt, f"chunk {step}")
        assert_same_as_pysim(tt, ps, f"chunk {step}")
        for t in (tt, jt, ps):
            for c in t.pending_cores():
                t.clear_pending(c)
                t.park(c)
        if all(ps.priv[c] == 3 for c in range(nc)):
            return step + 1
    raise AssertionError("program did not finish within the chunk budget")


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("seed", range(FUZZ_SEEDS))
def test_torch_fuzz_differential(seed, kw):
    nc = (1, 2, 4)[seed % 3]
    mmu = seed % 3 != 1
    run_lockstep(_ProgGen(seed).build(), nc, kw, mmu)


@pytest.mark.parametrize("seed", [3, 5])
def test_torch_fuzz_state_carried_through_numpy(seed):
    """Mid-run the port is re-seeded from the JAX target's state arrays
    (``state_from_numpy``) and must carry on bit-identically."""
    nc = (1, 2, 4)[seed % 3]
    chunks = run_lockstep(_ProgGen(seed).build(), nc,
                          dict(block_cache=True, dtlb_ways=8),
                          seed % 3 != 1, chunk=61, reseed_at=1)
    assert chunks > 2
