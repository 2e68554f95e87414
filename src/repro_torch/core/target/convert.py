"""numpy <-> :class:`~repro_torch.core.target.cpu.CpuState` bridge.

Lets a test (or a later checkpoint layer) seed this target and the JAX
reference from the same arrays and compare whole states: the fields are
the reference ``CpuState``'s, u64 arrays reinterpreted as ``int64``,
``priv`` ``uint32`` and ``pending``/``trace_armed`` ``bool``.
"""
from __future__ import annotations

import numpy as np
import torch

from .cpu import STATE_FIELDS, CpuState

_BOOL = ("pending", "trace_armed")


def state_from_numpy(fields: dict, device) -> CpuState:
    """Build a state on ``device`` from ``{field name: numpy array}``
    (every name in ``STATE_FIELDS``; u64 fields as ``uint64``)."""
    dev = torch.device(device)
    out = {}
    for name in STATE_FIELDS:
        if name in _BOOL:
            arr = np.array(fields[name], dtype=np.bool_, order="C")
        elif name == "priv":
            arr = np.array(fields[name], dtype=np.uint32,
                           order="C").view(np.int32)
        else:
            arr = np.array(fields[name], dtype=np.uint64,
                           order="C").view(np.int64)
        out[name] = torch.from_numpy(arr)     # a fresh, writable copy
    mem = out.pop("mem")
    store = torch.zeros((mem.shape[0] + 1,), dtype=torch.int64, device=dev)
    store[:-1].copy_(mem)
    out = {k: v.to(dev) for k, v in out.items()}
    return CpuState(mem=store[:-1], mem_store=store, **out)


def state_to_numpy(st: CpuState) -> dict:
    """The inverse of :func:`state_from_numpy` (host copies)."""
    out = {}
    for name in STATE_FIELDS:
        arr = getattr(st, name).detach().cpu().numpy()
        if name in _BOOL:
            out[name] = arr.astype(np.bool_)
        elif name == "priv":
            out[name] = arr.view(np.uint32).copy()
        else:
            out[name] = arr.view(np.uint64).copy()
    return out
