"""Capture-window triggers (TracerV TriggerSelector-style).

A long workload rarely needs its *whole* commit stream traced — the
region of interest is a function, a phase, a window of ticks.  A
:class:`TriggerSelector` describes that window as a small predicate the
target evaluates **at the retire point**, on both backends, with
bit-identical semantics:

  * ``pc_window(arm, disarm)``     — sticky: capture turns on at the
    first retirement of ``arm`` (the arming record is captured) and off
    at a retirement of ``disarm`` (also captured); ``disarm=None``
    stays armed to the end,
  * ``inst_window(arm, disarm)``   — the same, matched on the raw
    instruction word instead of the pc,
  * ``tick_range(t0, t1)``         — capture while ``t0 <= tick < t1``,
  * ``instret_threshold(n)``       — capture from the (n+1)-th
    retirement of a hart onward (pre-retirement count ``>= n``).

The selector itself is host-side configuration; what crosses into the
target layer is only :meth:`spec` — a small hashable tuple that becomes
the ``trigger`` argument of ``run_chunk_fast`` (a Python-level branch of
the eager loop, a launch-uniform value of the chunk kernel's traced
instantiation; a ``None`` spec skips the gate) and is interpreted by the
identical PySim mirror (``PySim._trace_capture``).  Gating affects only
which records enter the trace ring: the architectural step, the clock
and the golden ticks are untouched by construction.

``trace_n`` counts captured records only, so ring-overflow accounting
(``ring_dropped``) and lossless-capture checks keep working unchanged
over a windowed capture.
"""
from __future__ import annotations


#: trigger kinds whose capture state is the sticky per-core arm bit
STICKY_KINDS = ("pc", "inst")
#: every valid first element of a trigger spec tuple
KINDS = STICKY_KINDS + ("tick", "instret")


class TriggerSelector:
    """One capture-window predicate, shared by both telemetry bridges.

    Build via the classmethod constructors; pass to
    :class:`~repro_torch.telemetry.bridges.TelemetryHub` (``trigger=``) or
    install directly with ``target.trace_trigger(sel.spec())``.
    """

    def __init__(self, spec: tuple):
        kind = spec[0]
        assert kind in KINDS, f"unknown trigger kind {kind!r}"
        if kind == "tick":
            assert len(spec) == 3 and 0 <= spec[1] < spec[2]
        elif kind == "instret":
            assert len(spec) == 2 and spec[1] >= 0
        else:
            assert len(spec) == 3 and spec[1] is not None
        self._spec = tuple(spec)

    # -- constructors ---------------------------------------------------
    @classmethod
    def pc_window(cls, arm: int, disarm: int | None = None):
        """Sticky window armed at a retirement of pc ``arm`` and
        disarmed at one of pc ``disarm`` (both endpoints captured)."""
        return cls(("pc", int(arm), None if disarm is None
                    else int(disarm)))

    @classmethod
    def inst_window(cls, arm: int, disarm: int | None = None):
        """Sticky window matched on the raw instruction word."""
        return cls(("inst", int(arm), None if disarm is None
                    else int(disarm)))

    @classmethod
    def tick_range(cls, t0: int, t1: int):
        """Capture retirements with ``t0 <= tick < t1``."""
        return cls(("tick", int(t0), int(t1)))

    @classmethod
    def instret_threshold(cls, n: int):
        """Capture each hart's retirements from pre-retirement count
        ``n`` onward."""
        return cls(("instret", int(n)))

    # -- surface --------------------------------------------------------
    @property
    def kind(self) -> str:
        return self._spec[0]

    def spec(self) -> tuple:
        """The hashable target-layer spec tuple (``trigger=``)."""
        return self._spec

    def host_gate(self, target, now: int) -> bool:
        """Whether the capture window is (possibly) live at tick
        ``now`` — the :class:`~repro_torch.telemetry.bridges.CounterBridge`'s
        host-side mirror of the retire-point predicate, so periodic
        counter sampling pauses outside the window too.  Sticky kinds
        read the target's arm bit (one tiny host read per pump; forced
        samples bypass the gate entirely)."""
        kind = self._spec[0]
        if kind == "tick":
            return self._spec[1] <= now < self._spec[2]
        if kind == "instret":
            return any(target.get_instret(c) >= self._spec[1]
                       for c in range(target.n_cores))
        return any(bool(target.csr_read(c, "trace_armed"))
                   for c in range(target.n_cores))

    def __repr__(self):
        return f"TriggerSelector{self._spec!r}"


def as_spec(trigger) -> tuple | None:
    """Normalize a ``trigger=`` kwarg: a :class:`TriggerSelector`, a raw
    spec tuple, or ``None`` (no windowing)."""
    if trigger is None:
        return None
    if isinstance(trigger, TriggerSelector):
        return trigger.spec()
    return TriggerSelector(tuple(trigger)).spec()
