"""Workload builders: assemble libc + benchmark sources into Images."""
from __future__ import annotations

from functools import lru_cache

from ..target import asm
from .coremark import COREMARK, HELLO
from .gapbs import COMMON, KERNELS
from .libc import LIBC

GAPBS_NAMES = tuple(sorted(KERNELS))


@lru_cache(maxsize=None)
def build(name: str) -> asm.Image:
    sep = "\n.text\n"
    if name == "hello":
        src = LIBC + sep + HELLO
    elif name == "coremark":
        src = LIBC + sep + COREMARK
    elif name in KERNELS:
        src = LIBC + sep + COMMON + sep + KERNELS[name]
    else:
        raise KeyError(name)
    return asm.assemble(src)
