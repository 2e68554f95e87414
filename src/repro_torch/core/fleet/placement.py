"""Pluggable placement policies: which device owns a job / serving slot.

A policy sees the candidate :class:`~repro_torch.core.fleet.device.Device`
list in fleet order and returns the owner.  All three policies are
deterministic — fleet runs must reproduce tick-for-tick across
processes, so the affinity hash is a fixed FNV-1a over the key's string
form (never Python's salted ``hash``).

  * ``round_robin``  — cycles the fleet in submission order; ideal for
    homogeneous replicated jobs.
  * ``least_loaded`` — online greedy: place on the device with the
    smallest serial-occupancy clock *plus the re-imaging charge this
    job would trigger there* (ties break on fleet order).  Beats
    round-robin when job durations are skewed, and — with billed
    provisioning — keeps same-image jobs on warm boards whenever the
    flash cost outweighs the queue-depth gap.
  * ``least_loaded_blind`` — the same greedy without the provisioning
    term (the historical behaviour; the baseline ``benchmarks/
    migration.py`` measures the provision-aware policy against).
  * ``least_loaded_adaptive`` — ``least_loaded`` plus the telemetry
    load signal: each device's counter-bridge-fed
    :class:`~repro_torch.telemetry.load.LoadEstimator` penalty joins the
    clock comparison (optional — the default policy is unchanged).
  * ``affinity``     — sticky: the same ``affinity_key`` always lands on
    the same device (page-cache / re-image locality across a fleet);
    keyless jobs fall back to round-robin.
"""
from __future__ import annotations

from abc import ABC, abstractmethod

FNV_OFFSET, FNV_PRIME = 0xCBF29CE484222325, 0x100000001B3


def image_key_of(job) -> object:
    """The re-imaging identity of a job: which bitstream+ELF the owning
    board must carry.  Named workloads share their name (two ``"bc"``
    jobs re-use a flash); an explicit pre-assembled image is keyed by
    the image object itself — identity comparison, and the board's
    resident-image reference keeps it alive, so the key can never alias
    a recycled address the way ``id()`` would.  Only ever compared for
    equality — placement outcomes stay process-stable."""
    if job is None:
        return None
    img = getattr(job, "image", None)
    if img is not None:
        return img
    return getattr(job, "name", None)


def stable_hash(key) -> int:
    """Process-independent 64-bit FNV-1a of ``str(key)``."""
    h = FNV_OFFSET
    for b in str(key).encode():
        h = ((h ^ b) * FNV_PRIME) & ((1 << 64) - 1)
    return h


class PlacementPolicy(ABC):
    name = "policy"

    @abstractmethod
    def place(self, job, devices: list):
        """Return the owning device for ``job`` out of ``devices``."""

    def reset(self):
        """Forget inter-job state (fresh fleet run)."""


class RoundRobinPolicy(PlacementPolicy):
    name = "round_robin"

    def __init__(self):
        self._i = 0

    def place(self, job, devices):
        dev = devices[self._i % len(devices)]
        self._i += 1
        return dev

    def reset(self):
        self._i = 0


class LeastLoadedPolicy(PlacementPolicy):
    name = "least_loaded"

    def __init__(self, provision_aware: bool = True,
                 load_aware: bool = False):
        self.provision_aware = provision_aware
        self.load_aware = load_aware

    def place(self, job, devices):
        key = image_key_of(job) if self.provision_aware else None

        def cost(e):
            i, d = e
            c = d.clock
            if self.provision_aware:
                # the re-imaging charge this job would trigger here (0
                # on device-likes that don't model provisioning)
                fn = getattr(d, "provision_ticks_for", None)
                if fn is not None:
                    c += fn(key)
            if self.load_aware:
                # telemetry-driven signal: the expected stall-bound
                # queueing penalty from the device's LoadEstimator
                # (0 on devices without one / without samples yet)
                load = getattr(d, "load", None)
                if load is not None:
                    c += load.penalty_ticks()
            return (c, i)
        return min(enumerate(devices), key=cost)[1]


class LeastLoadedAdaptivePolicy(LeastLoadedPolicy):
    """``least_loaded`` plus the counter-bridge load signal: a device
    whose recent jobs were stall-bound (high EWMA ``stall_frac`` from
    its :class:`~repro_torch.telemetry.load.LoadEstimator`) is charged its
    expected stall penalty on top of the clock — the first consumer of
    the observability→control loop.  Degrades to plain
    ``least_loaded`` while no samples exist."""

    name = "least_loaded_adaptive"

    def __init__(self):
        super().__init__(provision_aware=True, load_aware=True)


class LeastLoadedBlindPolicy(LeastLoadedPolicy):
    """``least_loaded`` without the provisioning term: balances raw
    clocks only, re-flashing boards the aware policy would keep warm."""

    name = "least_loaded_blind"

    def __init__(self):
        super().__init__(provision_aware=False)


class AffinityPolicy(PlacementPolicy):
    name = "affinity"

    def __init__(self):
        self._fallback = RoundRobinPolicy()

    def place(self, job, devices):
        key = getattr(job, "affinity_key", None)
        if key is None:
            return self._fallback.place(job, devices)
        return devices[stable_hash(key) % len(devices)]

    def reset(self):
        self._fallback.reset()


POLICIES = {p.name: p for p in
            (RoundRobinPolicy, LeastLoadedPolicy, LeastLoadedBlindPolicy,
             LeastLoadedAdaptivePolicy, AffinityPolicy)}


def make_policy(name) -> PlacementPolicy:
    """Instantiate a policy by registry name (instances pass through)."""
    if isinstance(name, PlacementPolicy):
        return name
    try:
        return POLICIES[name]()
    except KeyError:
        raise KeyError(f"unknown placement policy {name!r} "
                       f"(have {sorted(POLICIES)})") from None
