"""The port's PySim (``repro_torch.core.target.pysim``), a jax-free copy
of the reference's, is held state for state against the reference's
``repro.core.target.pysim.PySim``: on the directed programs, on a seeded
sample of the lockstep fuzzer's programs, on the hello and bc pins
through each package's runtime, and on ``trace_drain`` under every
trigger kind.  Every comparison is exact: the whole state (registers,
pcs, CSRs, clock, counters, the commit-trace ring and its arm bits, the
memory image) after every chunk."""
import pytest

from repro.core.runtime import FaseRuntime as RefRuntime
from repro.core.target.pysim import PySim as RefSim
from repro.core.workloads import build as ref_build
from repro.core.workloads import graphgen as ref_graphgen
from repro_torch.core.runtime import FaseRuntime
from repro_torch.core.target.pysim import PySim
from repro_torch.core.workloads import build, graphgen

import torch_directed_cases as DC
import torch_trace_cases as TC
from test_torch_gpu import PROGRAM, fuzz_program

#: every attribute a PySim carries between steps (its host-side TLBs are
#: a cache of the page tables, not state)
FIELDS = ("regs", "pc", "priv", "pending", "stall_until", "satp", "mcause",
          "mepc", "mtval", "res", "ticks", "uticks", "instret",
          "stall_ticks", "fetch_hits", "fetch_walks", "tlb_walks",
          "trace_slots", "tracebuf", "trace_n", "_trace_base", "_trigger",
          "trace_armed", "mem")


def same_sims(a, b, point):
    for name in FIELDS:
        assert getattr(a, name) == getattr(b, name), f"{point}: {name}"


#: the directed cases PySim meets (its host-side TLB may serve a stale
#: mapping until an sfence, so the two store-over-a-cached-PTE cases pin
#: the tensor target alone)
_PYSIM_CASES = [c for c in DC.CASES if c.pysim]


@pytest.mark.parametrize("case", _PYSIM_CASES,
                         ids=[c.name for c in _PYSIM_CASES])
def test_port_pysim_equals_reference_on_directed_programs(case):
    sims = [RefSim(case.nc, DC.MEM), PySim(case.nc, DC.MEM)]
    DC.run_in_lockstep(case, sims, lambda ts, p: same_sims(*ts, p))


def _run_to_end(src, nc, chunk, sims, mmu):
    img = DC.asm.assemble(src)
    for t in sims:
        DC.load(t, img, nc, mmu=mmu)
    for step in range(400):
        for t in sims:
            t.run(max_cycles=chunk)
        same_sims(*sims, f"chunk {step}")
        for t in sims:
            for c in t.pending_cores():
                t.clear_pending(c)
                t.park(c)
        if all(t.get_priv(c) == 3 for t in sims for c in range(nc)):
            return
    raise AssertionError("program did not finish")


@pytest.mark.parametrize("seed", range(6))
def test_port_pysim_equals_reference_on_fuzz_programs(seed):
    """The lockstep fuzzer's programs (1/2/4 cores, the MMU on or off,
    shared atomics), chunk by chunk."""
    nc = (1, 2, 4)[seed % 3]
    _run_to_end(fuzz_program(seed), nc, 379,
                [RefSim(nc, DC.MEM), PySim(nc, DC.MEM)], mmu=seed % 3 != 1)


@pytest.mark.parametrize("slots", [TC.SLOTS_WRAP, TC.SLOTS_WIDE],
                         ids=["wrapping", "wide"])
def test_port_pysim_trace_drain_under_every_trigger(slots):
    """The atomics program on four cores under each trigger kind: the
    ring, counts and arm bits equal after every chunk, and every drain
    equal."""
    for _, trigger in TC.triggers(DC.asm.assemble(PROGRAM)):
        sims = [RefSim(4, DC.MEM), PySim(4, DC.MEM)]
        TC.arm(sims, slots, trigger)
        records = TC.run_program(PROGRAM, 4, 97, sims,
                                 lambda ts, p: same_sims(*ts, p))
        assert sum(len(r) for r in records) > 0


ARMED = dict(counters=True, commit_trace=True, interval_ticks=50_000,
             trace_slots=256)


def _both_runtimes(name, argv, n_cores, link, files=None, telemetry=None):
    reps = []
    for rt_cls, sim, bld in ((RefRuntime, RefSim, ref_build),
                             (FaseRuntime, PySim, build)):
        rt = rt_cls(sim(n_cores, 1 << 22), mode="fase", link=link,
                    session="async",
                    telemetry=None if telemetry is None else dict(telemetry))
        rt.load(bld(name), [name] + argv, files=files or {})
        reps.append(rt.run(max_ticks=1 << 36))
    return reps


@pytest.mark.parametrize("telemetry", [None, ARMED], ids=["plain", "armed"])
def test_port_pysim_holds_the_hello_and_bc_pins(telemetry):
    """hello@UART and bc@PCIe 2T on the reference's runtime over its
    PySim and on the port's runtime over the port's: the pins, the
    stdout, the per-core counters and (armed) the telemetry reports
    equal."""
    ref, got = _both_runtimes("hello", [], 1, None, telemetry=telemetry)
    assert got.ticks == ref.ticks == 6_554_780
    assert got.stdout == ref.stdout
    assert got.telemetry == ref.telemetry
    g = graphgen.rmat(4, 4, weights=True)
    assert g == ref_graphgen.rmat(4, 4, weights=True)
    ref, got = _both_runtimes("bc", ["g.bin", "2", "1"], 2, "pcie",
                              files={"g.bin": g}, telemetry=telemetry)
    assert (got.ticks, sum(got.instret), got.traffic_total) == \
        (ref.ticks, sum(ref.instret), ref.traffic_total) == \
        (775_078, 11_876, 24_681)
    assert got.instret == ref.instret and got.stall == ref.stall
    assert got.telemetry == ref.telemetry
