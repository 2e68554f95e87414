"""Online per-device load estimation from the CtrSample stream.

The counter bridge already ships a periodic per-hart sample of
``stall_ticks``/``uticks``/``instret`` over the telem lane; a
:class:`LoadEstimator` folds that stream into two EWMAs the fleet layer
can act on — the first observability→control loop:

  * ``stall_frac`` — fraction of recent modelled time the device's
    harts spent parked on the link-stall horizon (from per-sample
    counter *deltas*, so it tracks the current phase, not the lifetime
    average),
  * ``span_ewma``  — recent job makespan on this device.

``penalty_ticks()`` combines them into the extra queueing time a
stall-bound device is expected to cost the next job, which the
``least_loaded_adaptive`` placement policy adds to the serial-occupancy
clock.  Gang superstep auto-pacing
(:mod:`repro_torch.core.net.gang`, ``superstep_ticks="auto"``) uses the same
EWMA mechanics over per-round halo wait fractions.

Estimates mirror into :class:`~repro_torch.core.fleet.device.DeviceStats`
(``load_stall_frac`` / ``load_samples``) so every fleet report carries
them.  The estimator is deliberately dependency-free: it consumes the
plain sample dicts the bridge builds.
"""
from __future__ import annotations

#: EWMA blend for per-sample updates (new observations weigh half)
ALPHA = 0.5


class LoadEstimator:
    """EWMA load signal of one fleet device, fed by its counter bridge
    (``CounterBridge.pump`` calls :meth:`note_sample` on the owning
    device's estimator) and by job retirement (:meth:`note_job`)."""

    def __init__(self, alpha: float = ALPHA):
        assert 0.0 < alpha <= 1.0
        self.alpha = alpha
        self.stall_frac = 0.0
        self.span_ewma = 0.0
        self.samples = 0
        self.jobs = 0
        self._last_tick: int | None = None
        self._last_stall: int | None = None

    def _ewma(self, old: float, new: float) -> float:
        return old + self.alpha * (new - old)

    def note_sample(self, sample: dict) -> None:
        """Fold one counter-bridge sample dict in: the delta of summed
        per-hart ``stall_ticks`` against the delta of the global clock
        (× harts) is the interval's stall fraction."""
        tick = sample["tick"]
        nc = max(len(sample["cores"]), 1)
        stall = sum(c["stall_ticks"] for c in sample["cores"])
        if self._last_tick is not None and tick > self._last_tick:
            frac = (stall - self._last_stall) / \
                ((tick - self._last_tick) * nc)
            self.stall_frac = self._ewma(self.stall_frac,
                                         min(max(frac, 0.0), 1.0))
            self.samples += 1
        self._last_tick = tick
        self._last_stall = stall

    def note_job(self, span_ticks: int) -> None:
        """Fold one retired job's on-device span in; the sample deltas
        reset (the next job is a fresh queue pair with fresh counters)."""
        self.span_ewma = span_ticks if self.jobs == 0 \
            else self._ewma(self.span_ewma, span_ticks)
        self.jobs += 1
        self._last_tick = None
        self._last_stall = None

    def penalty_ticks(self) -> int:
        """Expected extra queueing cost of placing the next job here:
        the stall-bound share of a typical job span.  0 until both
        signals exist — an unknown device is not penalized."""
        if self.samples == 0 or self.jobs == 0:
            return 0
        return int(self.stall_frac * self.span_ewma)

    def as_dict(self) -> dict:
        return dict(stall_frac=self.stall_frac, span_ewma=self.span_ewma,
                    samples=self.samples, jobs=self.jobs,
                    penalty_ticks=self.penalty_ticks())
