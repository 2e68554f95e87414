"""Hardware-assisted futex (paper §V-B).

Each CPU core's FASE controller slice keeps a small *HFutex mask cache* of
virtual addresses.  When a ``futex(FUTEX_WAKE, addr)`` syscall traps and
``addr`` hits the core's mask, the controller answers locally (a0 = 0,
mepc += 4, resume) without any UART round-trip — eliminating the redundant
wake-ups aggressive pthread-style code emits.

Maintenance rules (mirroring the paper exactly):
  * a host-handled wake that woke nobody adds its address to the masking
    core's cache (host records both VA and PA);
  * when a futex *wait* is parked on some PA, every core's mask entries for
    that PA are cleared (via HFutex HTP requests, accounted by the caller);
  * a thread switch on a core clears that core's whole mask.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class HFutexCache:
    n_cores: int
    slots: int = 8
    enabled: bool = True
    masks: list = field(default_factory=list)   # per-core list of VAs
    va_to_pa: dict = field(default_factory=dict)
    hits: int = 0
    inserts: int = 0

    def __post_init__(self):
        self.masks = [[] for _ in range(self.n_cores)]

    def lookup(self, core: int, va: int) -> bool:
        if not self.enabled:
            return False
        hit = va in self.masks[core]
        if hit:
            self.hits += 1
        return hit

    def insert(self, core: int, va: int, pa: int) -> bool:
        """Add va to core's mask; returns True if an HTP update was sent."""
        if not self.enabled:
            return False
        m = self.masks[core]
        if va in m:
            return False
        if len(m) >= self.slots:
            m.pop(0)
        m.append(va)
        self.va_to_pa[va] = pa
        self.inserts += 1
        return True

    def clear_pa(self, pa: int) -> list[int]:
        """Clear mask entries resolving to ``pa``; returns cores updated."""
        touched = []
        for c, m in enumerate(self.masks):
            keep = [va for va in m if self.va_to_pa.get(va) != pa]
            if len(keep) != len(m):
                self.masks[c] = keep
                touched.append(c)
        return touched

    def clear_core(self, core: int) -> bool:
        """Thread switch: drop the whole mask.  True if it was non-empty."""
        had = bool(self.masks[core])
        self.masks[core] = []
        return had
