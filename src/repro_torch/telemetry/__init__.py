"""Out-of-band telemetry bridges (FireSim AutoCounter/TracerV-style).

The port's copy of the reference's ``repro.telemetry``, module for module,
over this package's session, target and PySim (and
:mod:`repro_torch.core.consts` for the clock).  On a
:class:`~repro_torch.core.interface.TorchTarget` the commit-trace ring is
recorded at the retire point by both interpreter routes — the eager loop
and the traced instantiation of the chunk kernel (``csrc/run_chunk.cu``).

Profiling a FASE run must not perturb the timing FASE exists to
validate: every introspection mechanism that rides the billed syscall
path shows up in the golden ticks.  This package adds the out-of-band
alternative — two bridges that harvest target-side state at chunk
boundaries and emit it onto a dedicated low-priority **"telem" stream**
(:class:`~repro_torch.telemetry.stream.TelemStream`) with its own modelled
bandwidth budget and drop-counting backpressure:

  * :class:`~repro_torch.telemetry.bridges.CounterBridge` — periodic per-hart
    performance-counter frames (``htp.TELEM_COUNTERS``) plus host-known
    link/session counters,
  * :class:`~repro_torch.telemetry.bridges.CommitTraceBridge` — per-hart
    (tick, pc, inst, priv) commit records captured in a bounded ring in
    the target carry and drained in bundled reads.

Telemetry traffic is *timed* on the wire model (it occupies a
configurable fraction of the link) but **never delays** Layer-A/Layer-B
transactions and never touches the session's byte/stall accounting —
golden ticks and traffic pins hold with bridges armed, which
``tests/test_torch_telemetry.py`` enforces.

:class:`~repro_torch.telemetry.bridges.TelemetryHub` packages both bridges
behind one ``pump(now)`` surface that :class:`repro_torch.core.runtime.\
FaseRuntime` drives (``telemetry=`` constructor kwarg); captured commit
traces feed :mod:`repro_torch.telemetry.replay` — lockstep trace-driven
conformance against PySim.

Around the bridges:

  * :mod:`~repro_torch.telemetry.triggers` — windowed capture: a
    :class:`~repro_torch.telemetry.triggers.TriggerSelector` (PC / instruction
    match with arm/disarm, counter threshold, tick range) gates both
    bridges and the target-side retire-point capture predicate;
  * :mod:`~repro_torch.telemetry.timeline` — merge the transaction trace,
    telemetry samples, fabric counters, gang supersteps and migration
    spans into one Perfetto-openable Chrome trace-event JSON
    (``python -m repro_torch.telemetry timeline <workload>``);
  * :mod:`~repro_torch.telemetry.load` — the observability→control loop: an
    online per-device :class:`~repro_torch.telemetry.load.LoadEstimator` fed
    by the counter bridge, consumed by ``least_loaded_adaptive``
    placement and the gang's ``superstep_ticks="auto"`` pacing.
"""
from .stream import TELEM_STREAM, TelemStream
from .bridges import (CommitTraceBridge, CounterBridge, TelemetryHub,
                      without_backend_counters)
from .load import LoadEstimator
from .replay import TraceDivergence, capture_commit_trace, replay_trace
from .timeline import build_timeline, save_timeline, validate_timeline
from .triggers import TriggerSelector, as_spec

__all__ = [
    "TELEM_STREAM", "TelemStream",
    "CounterBridge", "CommitTraceBridge", "TelemetryHub",
    "without_backend_counters",
    "capture_commit_trace", "replay_trace", "TraceDivergence",
    "TriggerSelector", "as_spec", "LoadEstimator",
    "build_timeline", "validate_timeline", "save_timeline",
]
