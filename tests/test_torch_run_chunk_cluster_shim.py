"""The chunk kernels' cluster mode (a board past ``cta_lanes`` cores on a
thread-block cluster, ``chunk_body<TRACE, true, true>`` in
``src/repro_torch/csrc/run_chunk.cu``), compiled for the host with ``g++``
under the emulation of ``tests/cuda_shim`` (the CTAs of one cluster run
at once, each with its own shared memory, their threads at one cluster
barrier, ``map_shared_rank`` reaching into another CTA's array) and
launched through the wrappers' own argument lists with ``cta_lanes=32``:
a board of 33 or 40 cores is a cluster of two one-warp CTAs, so lanes of
rank 1 race lanes of rank 0 on one cell in every tick.  Held field for
field against the eager loop after every chunk (untraced, traced with its
ring, and as a fleet of two boards whose second has budget 0 and stays
byte-identical); at 40 cores also against ``PySim``.  One trip of the
atomics loop (``WIDE_PROGRAM``): a CTA of emulated threads at a barrier
is slow on a busy CPU.  Integer state; tolerance 0.  The same cluster
runs on the card in ``chip_smoke.py`` at 500 and 1 025 cores."""
import numpy as np
import pytest

from repro.core.target.pysim import PySim
from repro_torch.core.fleet.vmap import FleetTarget
from repro_torch.core.interface import TorchTarget
from repro_torch.core.target.convert import state_to_numpy

import torch_directed_cases as DC
import torch_trace_cases as TC
from test_torch_cpu_differential import assert_same_as_pysim
from test_torch_run_chunk_shim import (WIDE_PROGRAM,  # noqa: F401
                                       _same_state, kernel_route, launch,
                                       shim_lib)
from test_torch_run_chunk_fleet_shim import (  # noqa: F401
    fleet_launch, kernel_route as fleet_route)

#: cores a CTA: two CTAs of one warp hold 33-64 cores
CTA_LANES = 32
CHUNK = 7

_IMG = DC.asm.assemble(WIDE_PROGRAM)


def _park_exits(targets):
    for t in targets:
        for c in t.pending_cores():
            t.clear_pending(c)
            t.park(c)


@pytest.mark.parametrize("nc", [33, 40])
def test_cluster_kernel_source_equals_eager_loop(kernel_route, nc):
    """Chunk by chunk to the end, every field equal to the eager loop's
    and the substeps too; one launch a chunk, each on a cluster; at 40
    cores PySim beside them."""
    kernel_route.cta_lanes = CTA_LANES
    targets = [TorchTarget(nc, DC.MEM, device="cpu", chunk_kernel=ck)
               for ck in ("kernel", "ref")]
    pysim = [PySim(nc, DC.MEM)] if nc == 40 else []
    for t in targets + pysim:
        DC.load(t, _IMG, nc, mmu=True)
    for step in range(400):
        for t in targets + pysim:
            t.run(max_cycles=CHUNK)
        _same_state(*targets, f"chunk {step}")
        if pysim:
            assert_same_as_pysim(targets[1], pysim[0], f"chunk {step}")
        _park_exits(targets + pysim)
        if all(t.get_priv(c) == 3 for t in targets for c in range(nc)):
            break
    else:
        raise AssertionError("program did not finish")
    assert min(targets[0].get_instret(c) for c in range(nc)) > 20
    assert kernel_route.launches == kernel_route.cluster_launches == step + 1


@pytest.mark.parametrize("nc", [33, 40])
def test_traced_cluster_kernel_source_records_the_eager_ring(kernel_route,
                                                             nc):
    """The traced instantiation on the cluster, ring wrapping, no gate:
    ring, ``trace_n`` and every field equal the eager loop's after every
    chunk, and the drains PySim's."""
    kernel_route.cta_lanes = CTA_LANES
    targets = [TorchTarget(nc, DC.MEM, device="cpu", chunk_kernel=ck)
               for ck in ("kernel", "ref")] + [PySim(nc, DC.MEM)]
    TC.arm(targets, TC.SLOTS_WRAP, None)

    def compare(ts, point):
        _same_state(ts[0], ts[1], point)
    TC.run_program(WIDE_PROGRAM, nc, CHUNK, targets, compare)
    n = [int(v) for v in targets[0].st.trace_n]
    assert n == [targets[2].trace_n[c] for c in range(nc)]
    assert sum(n) == sum(targets[0].get_instret(c) for c in range(nc))
    assert kernel_route.trace_launches == \
        kernel_route.cluster_trace_launches > 2
    assert kernel_route.launches == kernel_route.cluster_launches == 0


def test_cluster_fleet_kernel_source_equals_eager_flat_form(fleet_route):
    """Two boards of 40 cores, one cluster a board: board 0 runs the
    program in 7-tick global chunks and equals the eager flat form after
    every one; board 1, loaded but at budget 0 throughout, stays
    byte-identical to its state before the first launch."""
    nc = 40
    fleet_route.cta_lanes = CTA_LANES
    fleets = [FleetTarget(2, nc, DC.MEM, device="cpu", chunk_kernel=ck)
              for ck in ("kernel", "ref")]
    for f in fleets:
        for d in range(2):
            DC.load(f.view(d), _IMG, nc, mmu=True)
    idle = {k: v[1].copy() for k, v in state_to_numpy(fleets[0].sts).items()}
    for step in range(400):
        for f in fleets:
            f.run_global([CHUNK, 0])
        a, b = state_to_numpy(fleets[0].sts), state_to_numpy(fleets[1].sts)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name],
                                          err_msg=f"chunk {step}: {name}")
            np.testing.assert_array_equal(a[name][1], idle[name],
                                          err_msg=f"idle board: {name}")
        assert fleets[0].view(0).substeps == fleets[1].view(0).substeps
        _park_exits([f.view(0) for f in fleets])
        if bool((fleets[0].sts.priv[0] == 3).all()):
            break
    else:
        raise AssertionError("program did not finish")
    assert int(fleets[0].sts.instret[0].min()) > 20
    assert fleet_route.launches == fleet_route.cluster_launches == step + 1
