"""The chunk kernel's traced instantiation (``trace_on``: the
commit-trace ring, ``src/repro_torch/csrc/run_chunk.cu``) compiled for the
host with ``g++`` under the warp emulation of ``tests/cuda_shim`` and
launched through the wrapper's own argument list, as in
``tests/test_torch_run_chunk_shim.py``.  It records the ring equal to the
eager loop's — ``tracebuf``, ``trace_n`` and ``trace_armed`` after every
chunk, with every other state field — and drains PySim's records and
drops, under every trigger kind and none, with a ring that wraps and one
that does not, and on the directed regressions.  Integer state;
tolerance 0.  The same cases run on the card in
``tests/test_torch_gpu.py``."""
import pytest

from repro.core.target.pysim import PySim
from repro_torch.core.interface import TorchTarget

import torch_directed_cases as DC
import torch_trace_cases as TC
from test_torch_cpu_differential import assert_same_as_pysim
from test_torch_gpu import PROGRAM
from test_torch_run_chunk_shim import (WIDE_PROGRAM,  # noqa: F401
                                       _same_state, kernel_route, launch,
                                       shim_lib)


_IMG = DC.asm.assemble(PROGRAM)
_TRIGGERS = TC.triggers(_IMG)


@pytest.mark.parametrize("slots", [TC.SLOTS_WRAP, TC.SLOTS_WIDE],
                         ids=["wrapping", "wide"])
@pytest.mark.parametrize("trigger", [t for _, t in _TRIGGERS],
                         ids=[i for i, _ in _TRIGGERS])
def test_traced_chunk_kernel_source_records_the_eager_ring(kernel_route,
                                                           trigger, slots):
    """The atomics program on four cores under each trigger kind: the
    traced instantiation's ring, ``trace_n`` and ``trace_armed`` equal
    the eager loop's after every 97-tick chunk (same-tick conflicts
    defer lanes, so a lane's record can wait a substep), and the drains
    equal PySim's records and ring drops."""
    nc = 4
    targets = [TorchTarget(nc, DC.MEM, device="cpu", chunk_kernel=ck)
               for ck in ("kernel", "ref")] + [PySim(nc, DC.MEM)]
    TC.arm(targets, slots, trigger)

    def compare(ts, point):
        _same_state(ts[0], ts[1], point)
    records = TC.run_program(PROGRAM, nc, 97, targets, compare)
    n = [int(v) for v in targets[0].st.trace_n]
    assert n == [targets[2].trace_n[c] for c in range(nc)]
    assert kernel_route.trace_launches > 2 and kernel_route.launches == 0
    captured = sum(len(r) for r in records)
    if trigger is None:
        assert sum(n) == sum(targets[0].get_instret(c) for c in range(nc))
    else:
        assert 0 < sum(n) < sum(targets[0].get_instret(c)
                                 for c in range(nc))
    assert captured == sum(n) if slots == TC.SLOTS_WIDE else \
        captured < sum(n)


@pytest.mark.parametrize("case,kw", DC.PARAMS, ids=DC.IDS)
def test_traced_chunk_kernel_source_meets_directed_regression(kernel_route,
                                                              case, kw):
    """The directed regressions with an 8-slot ring armed on every
    target: the state (ring included) equal to the eager loop's at each
    checkpoint, the drains equal to PySim's where it is an oracle."""
    targets = [TorchTarget(case.nc, DC.MEM, device="cpu",
                           chunk_kernel=ck, **kw) for ck in ("kernel",
                                                             "ref")]
    if case.pysim:
        targets.append(PySim(case.nc, DC.MEM))
    TC.arm(targets, TC.SLOTS_WRAP, None)

    def compare(ts, point):
        _same_state(ts[0], ts[1], point)
        if case.pysim:
            assert_same_as_pysim(ts[0], ts[2], point)
        TC.same_drains(ts, point)
    DC.run_in_lockstep(case, targets, compare)
    assert kernel_route.trace_launches > 0
    assert int(targets[0].st.trace_n.sum()) > 0


def test_traced_chunk_kernel_source_records_the_eager_ring_at_40_cores(
        kernel_route):
    """The traced instantiation on a board of 40 cores (CTA-wide, two
    warps), ring wrapping, no gate: ring, ``trace_n`` and every field equal
    the eager loop's after every chunk, and the drains PySim's."""
    nc = 40
    targets = [TorchTarget(nc, DC.MEM, device="cpu", chunk_kernel=ck)
               for ck in ("kernel", "ref")] + [PySim(nc, DC.MEM)]
    TC.arm(targets, TC.SLOTS_WRAP, None)

    def compare(ts, point):
        _same_state(ts[0], ts[1], point)
    TC.run_program(WIDE_PROGRAM, nc, 7, targets, compare)
    n = [int(v) for v in targets[0].st.trace_n]
    assert n == [targets[2].trace_n[c] for c in range(nc)]
    assert sum(n) == sum(targets[0].get_instret(c) for c in range(nc))
    assert kernel_route.trace_launches > 2 and kernel_route.launches == 0
