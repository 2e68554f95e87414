"""Commit-trace replay and the ring against the reference, on
``TorchTarget(device="cpu")`` (the eager loop):

* the twin of the reference's ``test_trace_replay_conformance_bc``
  (``tests/test_telemetry.py``): bc captured on the tensor target replays
  divergence-free against the port's PySim — lockstep (tick, pc, inst,
  priv) conformance over every retirement;
* the eager loop and the reference's ``JaxTarget`` fast path, started from
  one state carried over with ``convert``, record the same ring under
  each trigger kind: ``tracebuf``, ``trace_n`` and ``trace_armed`` (and
  every other field) equal after each chunk.

Every comparison is exact."""
import pytest

from repro.core.interface import JaxTarget
from repro_torch.core.interface import TorchTarget
from repro_torch.core.target.convert import state_from_numpy
from repro_torch.core.workloads import graphgen

import torch_directed_cases as DC
import torch_trace_cases as TC
from test_torch_cpu_differential import assert_same_as_jax, jax_state_numpy
from test_torch_gpu import PROGRAM


def test_trace_replay_conformance_bc():
    from repro_torch.telemetry import capture_commit_trace, replay_trace

    g = graphgen.rmat(4, 4, weights=True)
    recs, rep = capture_commit_trace(
        "bc", ["g.bin", "1", "1"], target="torch",
        target_opts=dict(device="cpu"), n_cores=1, files={"g.bin": g},
        slots=1 << 15)
    assert sum(len(r) for r in recs) == sum(rep.instret)
    divergences = replay_trace(recs, "bc", ["g.bin", "1", "1"],
                               n_cores=1, files={"g.bin": g},
                               slots=1 << 15)
    assert divergences == []


_TRIGGERS = TC.triggers(DC.asm.assemble(PROGRAM))


@pytest.mark.parametrize("trigger", [t for _, t in _TRIGGERS],
                         ids=[i for i, _ in _TRIGGERS])
def test_eager_ring_equals_jax_fast_path_from_one_state(trigger):
    """The atomics program on four cores: the reference's JaxTarget is
    loaded and armed with an 8-slot ring under ``trigger``; the tensor
    target starts from its state (``convert``) with the same ring and
    trigger; both run three 97-tick chunks, every field equal after
    each."""
    nc = 4
    jt = JaxTarget(nc, DC.MEM, fast_path=True)
    DC.load(jt, DC.asm.assemble(PROGRAM), nc, mmu=True)
    jt.run(max_cycles=97)
    tt = TorchTarget(nc, DC.MEM, device="cpu")
    for t in (jt, tt):
        t.trace_arm(TC.SLOTS_WRAP)
        t.trace_trigger(trigger)
    tt.st = state_from_numpy(jax_state_numpy(jt), "cpu")
    for step in range(3):
        for t in (jt, tt):
            t.run(max_cycles=97)
        assert_same_as_jax(tt, jt, f"chunk {step}")
        assert tt.trace_drain() == jt.trace_drain(), f"chunk {step}"
    assert int(tt.st.trace_n.sum()) > 0
