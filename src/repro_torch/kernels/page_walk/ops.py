"""Entry points of the page-walk chain: the tensor's device picks the
implementation.

A CUDA image goes to the hand-written kernel — or raises if it cannot be
built or launched; a CPU image goes to the plain PyTorch version.  There
is no probing and no fallback: the plain version runs on a CUDA image
only when it is asked for by name (``impl="ref"``), which is how the
on-card check compares the two.  The data-side walks have no kernel (in
the reference either) and are called from ``ref`` directly.
"""
from __future__ import annotations

from . import page_walk as K
from . import ref as R

IMPLS = ("kernel", "ref")


def walk_fetch_block(mem, satp, va, mask, block_words, base=None,
                     active=None, impl="kernel"):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel" and mem.is_cuda:
        return K.walk_fetch_block(mem, satp, va, mask, block_words, base,
                                  active)
    return R.walk_fetch_block_ref(mem, satp, va, mask, block_words, base,
                                  active)
