"""The fleet chunk kernel's CUDA source (``run_chunk_fleet_launch`` in
``src/repro_torch/csrc/run_chunk.cu``), compiled for the host with ``g++``
under the warp emulation of ``tests/cuda_shim`` (the CTAs of a grid run
one at a time, in a seeded random order) and run where the card would run
it: a CPU ``FleetTarget`` on ``chunk_kernel="kernel"`` launches it through
the wrapper's own argument list (``run_chunk.fleet_launch_args``).  It is
held against the eager flat form (``chunk_kernel="ref"``), every field of
every board and each board's substeps, at D = 3 boards: the directed
regressions of ``tests/torch_directed_cases.py`` on every board (each
view's ``run`` a one-hot global chunk, two boards at budget 0), and the
directed atomics/MMU program and the AMO table run by all boards at once
with unequal budgets.  Integer state; tolerance 0.  The same cases run
on the card in ``tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core.fleet.vmap import FleetTarget
from repro_torch.core.target import cpu
from repro_torch.core.target.convert import state_to_numpy
from repro_torch.kernels.run_chunk import run_chunk as RC

import torch_directed_cases as DC
import torch_shim
from test_torch_gpu import PROGRAM, amo_table_program
from test_torch_run_chunk_shim import WIDE_PROGRAM

D = 3


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    return torch_shim.build("run_chunk", tmp_path_factory.mktemp("shim"))


@pytest.fixture(scope="module")
def fleet_launch(shim_lib):
    return torch_shim.entry(shim_lib, "run_chunk_fleet_launch",
                            RC.FLEET_ARGS)


@pytest.fixture
def kernel_route(monkeypatch, shim_lib, fleet_launch):
    """CPU stacks on ``chunk_kernel="kernel"`` run the compiled source;
    returns the stand-in wrapper, whose ``launches`` counts them and whose
    ``cta_lanes`` (None: the source's default) picks the cores a CTA."""
    def run_chunk_fleet(sts, n_cores, mem_bytes, budgets, issue_width=8,
                        block_words=16, block_cache=True, dtlb_ways=8):
        RC.check_state(sts, n_cores, mem_bytes, block_words, dtlb_ways,
                       sts.pc.shape[0])
        cta_lanes, ranks = RC.layout("run_chunk_fleet", n_cores,
                                     block_words, dtlb_ways,
                                     run_chunk_fleet.cta_lanes, lib=shim_lib)
        out = torch.full((sts.pc.shape[0], 2), -1, dtype=torch.int64)
        limits = torch.tensor(budgets, dtype=torch.int64)
        assert fleet_launch(*RC.fleet_launch_args(
            sts, limits, out, n_cores, mem_bytes, issue_width, block_words,
            block_cache, dtlb_ways, cta_lanes, None)) == 0
        run_chunk_fleet.launches += 1
        run_chunk_fleet.cluster_launches += ranks > 1
        return out[:, 0].tolist()

    def chunk_route(st, chunk_kernel="kernel"):
        assert chunk_kernel in cpu.CHUNK_IMPLS
        return chunk_kernel

    run_chunk_fleet.launches = run_chunk_fleet.cluster_launches = 0
    run_chunk_fleet.cta_lanes = None
    monkeypatch.setattr(RC, "run_chunk_fleet", run_chunk_fleet)
    monkeypatch.setattr(cpu, "chunk_route", chunk_route)
    return run_chunk_fleet


def _pair(nc, **kw):
    return [FleetTarget(D, nc, DC.MEM, device="cpu", chunk_kernel=ck, **kw)
            for ck in ("kernel", "ref")]


def _same(kernel, eager, point):
    a, b = state_to_numpy(kernel.sts), state_to_numpy(eager.sts)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name],
                                      err_msg=f"{point}: {name}")
    for d in range(D):
        assert kernel.view(d).substeps == eager.view(d).substeps, (point, d)


@pytest.mark.parametrize("case,kw", DC.PARAMS, ids=DC.IDS)
def test_fleet_kernel_source_meets_directed_regression(kernel_route, case,
                                                       kw):
    fleets = _pair(case.nc, **kw)
    views = [f.view(d) for f in fleets for d in range(D)]
    DC.run_in_lockstep(case, views, lambda ts, p: _same(*fleets, p))
    assert kernel_route.launches == fleets[0].dispatch_count > 0


@pytest.mark.parametrize("src,nc,budgets,instret", [
    (PROGRAM, 4, (0, 13, 97, 379), 200),
    (amo_table_program(), 1, (0, 7, 61), 200),
    (WIDE_PROGRAM, 40, (0, 17, 61), 20),
    (WIDE_PROGRAM, 64, (0, 17, 61), 20)],
    ids=["atomics-mmu", "amo-table", "atomics-mmu-40", "atomics-mmu-64"])
def test_fleet_kernel_source_equals_eager_flat_form(kernel_route, src, nc,
                                                    budgets, instret):
    """Every board runs the program, each global chunk with budgets drawn
    per board (0 among them): same-tick conflicts between four lanes of
    one board, every AMO's old and new value, boards stopping apart.  At
    40 and 64 cores a board is a CTA of two warps (the CTA-wide
    instantiation), lanes above 31 racing lanes below 32."""
    img = DC.asm.assemble(src)
    fleets = _pair(nc)
    for f in fleets:
        for d in range(D):
            DC.load(f.view(d), img, nc, mmu=True)
    rng = np.random.RandomState(nc)
    for step in range(600):
        b = [int(x) for x in rng.choice(budgets, D)]
        for f in fleets:
            f.run_global(b)
        _same(*fleets, f"chunk {step} budgets {b}")
        for f in fleets:
            for d in range(D):
                v = f.view(d)
                for c in v.pending_cores():
                    v.clear_pending(c)
                    v.park(c)
        if bool((fleets[0].sts.priv == 3).all()):
            break
    else:
        raise AssertionError("program did not finish")
    assert int(fleets[0].sts.instret[:, 0].min()) > instret
    assert kernel_route.launches == step + 1
