"""The chunk kernel's CUDA source, ``src/repro_torch/csrc/run_chunk.cu``,
compiled for the host with ``g++`` under the warp emulation of
``tests/cuda_shim`` and run where the card would run it: a CPU
``TorchTarget`` on ``chunk_kernel="kernel"`` launches it through the
wrapper's own argument list (``run_chunk.launch_args``).  It meets the
directed regressions of ``tests/test_torch_cpu_directed.py`` (privilege
gate, self-modifying code, a store over a cached leaf PTE, a host PTE
change with sfence, stall fast-forward with the budget clamp), the
directed atomics/MMU program and the AMO table, in lockstep with the
eager loop (every state field and the substep count at every checkpoint)
and ``PySim`` (the architectural state).  Integer state; tolerance 0.
The same cases run on the card in ``tests/test_torch_gpu.py``; the traced
instantiation's cases are in ``tests/test_torch_run_chunk_trace_shim.py``."""
import numpy as np
import pytest
import torch

from repro.core.target.pysim import PySim
from repro_torch.core.interface import TorchTarget
from repro_torch.core.target import cpu
from repro_torch.core.target.convert import state_to_numpy
from repro_torch.kernels.run_chunk import run_chunk as RC

import torch_directed_cases as DC
import torch_shim
from test_torch_cpu_differential import assert_same_as_pysim
from test_torch_gpu import PROGRAM, amo_table_program


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    return torch_shim.build("run_chunk", tmp_path_factory.mktemp("shim"))


@pytest.fixture(scope="module")
def launch(shim_lib):
    return torch_shim.entry(shim_lib, "run_chunk_launch", RC._ARGS)


@pytest.fixture
def kernel_route(monkeypatch, shim_lib, launch):
    """CPU targets on ``chunk_kernel="kernel"`` run the compiled source;
    returns the stand-in wrapper, whose ``launches`` counts them and whose
    ``cta_lanes`` (None: the source's default) picks the cores a CTA."""
    def run_chunk(st, n_cores, mem_bytes, max_cycles, issue_width=8,
                  block_words=16, block_cache=True, dtlb_ways=8,
                  trace_on=False, trigger=None):
        RC.check_state(st, n_cores, mem_bytes, block_words, dtlb_ways)
        if trace_on:
            RC.check_trace(st, n_cores)
        cta_lanes, ranks = RC.layout("run_chunk", n_cores, block_words,
                                     dtlb_ways, run_chunk.cta_lanes,
                                     lib=shim_lib)
        out = torch.zeros((2,), dtype=torch.int64)
        assert launch(*RC.launch_args(
            st, out, n_cores, mem_bytes, max_cycles, issue_width,
            block_words, block_cache, dtlb_ways, cta_lanes, None, trace_on,
            trigger)) == 0
        if trace_on:
            run_chunk.trace_launches += 1
            run_chunk.cluster_trace_launches += ranks > 1
        else:
            run_chunk.launches += 1
            run_chunk.cluster_launches += ranks > 1
        return int(out[0])

    def chunk_route(st, chunk_kernel="kernel"):
        assert chunk_kernel in cpu.CHUNK_IMPLS
        return chunk_kernel

    run_chunk.launches = run_chunk.trace_launches = 0
    run_chunk.cluster_launches = run_chunk.cluster_trace_launches = 0
    run_chunk.cta_lanes = None
    monkeypatch.setattr(RC, "run_chunk", run_chunk)
    monkeypatch.setattr(cpu, "chunk_route", chunk_route)
    return run_chunk


def _same_state(kernel, eager, point):
    a, b = state_to_numpy(kernel.st), state_to_numpy(eager.st)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name],
                                      err_msg=f"{point}: {name}")
    assert kernel.substeps == eager.substeps, point


@pytest.mark.parametrize("case,kw", DC.PARAMS, ids=DC.IDS)
def test_chunk_kernel_source_meets_directed_regression(kernel_route, case,
                                                       kw):
    targets = [TorchTarget(case.nc, DC.MEM, device="cpu",
                           chunk_kernel=ck, **kw) for ck in ("kernel",
                                                             "ref")]
    if case.pysim:
        targets.append(PySim(case.nc, DC.MEM))

    def compare(ts, point):
        _same_state(ts[0], ts[1], point)
        if case.pysim:
            assert_same_as_pysim(ts[0], ts[2], point)
    DC.run_in_lockstep(case, targets, compare)
    assert kernel_route.launches > 0


#: the atomics program with one trip of its loop in place of twelve (a
#: trip races every core on its AMOs and stores): on the wide boards below
#: a trip is a few hundred substeps of 33–64 emulated threads at a
#: barrier, which a CPU busy with other work runs slowly
WIDE_PROGRAM = PROGRAM.replace("li t1, 12", "li t1, 1")
assert WIDE_PROGRAM != PROGRAM


@pytest.mark.parametrize("src,nc,chunk,instret", [
    (PROGRAM, 4, 97, 200), (amo_table_program(), 1, 61, 200),
    (WIDE_PROGRAM, 33, 7, 20), (WIDE_PROGRAM, 40, 7, 20),
    (WIDE_PROGRAM, 64, 7, 20)],
    ids=["atomics-mmu", "amo-table", "atomics-mmu-33", "atomics-mmu-40",
         "atomics-mmu-64"])
def test_chunk_kernel_source_equals_eager_loop(kernel_route, src, nc,
                                               chunk, instret):
    """Chunk by chunk to the end: same-tick conflicts between four
    lanes on one cell, and every AMO's old and new value.  At 33, 40 and
    64 cores the board runs on the CTA-wide instantiation (two warps):
    every core's AMOs hit one cell and its byte and halfword stores one
    line, so lanes above 31 race lanes below 32 in every tick; at 40
    cores PySim runs beside them (the eager loop held to the reference
    at a width past one warp)."""
    img = DC.asm.assemble(src)
    targets = [TorchTarget(nc, DC.MEM, device="cpu", chunk_kernel=ck)
               for ck in ("kernel", "ref")]
    pysim = PySim(nc, DC.MEM) if nc == 40 else None
    for t in targets + [pysim] * (pysim is not None):
        DC.load(t, img, nc, mmu=True)
    for step in range(400):
        for t in targets + [pysim] * (pysim is not None):
            t.run(max_cycles=chunk)
        _same_state(*targets, f"chunk {step}")
        if pysim is not None:
            assert_same_as_pysim(targets[1], pysim, f"chunk {step}")
            for c in pysim.pending_cores():
                pysim.clear_pending(c)
                pysim.park(c)
        for t in targets:
            for c in t.pending_cores():
                t.clear_pending(c)
                t.park(c)
        if all(t.get_priv(c) == 3 for t in targets for c in range(nc)):
            break
    else:
        raise AssertionError("program did not finish")
    assert min(targets[0].get_instret(c) for c in range(nc)) > instret
    assert kernel_route.launches > 2
