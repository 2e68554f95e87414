"""Constants shared by the host stack and the target model.

Kept apart from :mod:`repro_torch.core.target.cpu` so the pure-Python
host modules (channel model, runtime) can import them without pulling in
``torch``.
"""
from __future__ import annotations

CLOCK_HZ = 100_000_000

#: "no LR reservation held" — all ones as an unsigned 64-bit value.
_RES_INVALID = (1 << 64) - 1

#: Sentinel word index for "this walk level read nothing" / "empty way" —
#: outside any reachable physical word index.
NO_WORD = (1 << 64) - 1

#: Per-core architectural state a target checkpoint captures/restores, in
#: capture order.  Every name is a ``CpuState`` field.
SNAPSHOT_CORE_FIELDS = ("pc", "priv", "pending", "stall_until", "satp",
                        "mcause", "mepc", "mtval", "res", "uticks",
                        "instret")
