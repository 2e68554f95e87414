"""Entry points of the page operations: the pool's device picks the
implementation.

A CUDA pool goes to the hand-written kernel — or raises if it cannot be
built or launched; a CPU pool goes to the plain PyTorch version.  There
is no probing and no fallback: the plain version runs on a CUDA pool only
when it is asked for by name (``impl="ref"``).  ``page_set`` and
``page_copy`` update the pool in place and return it; ``page_gather``
returns a new tensor (no path of the system calls it yet).
"""
from __future__ import annotations

from . import page_ops as K
from . import ref as R

IMPLS = ("kernel", "ref")


def _kernel(pool, impl):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "kernel" and pool.is_cuda


def page_set(pool, ids, value, impl="kernel"):
    if _kernel(pool, impl):
        return K.page_set(pool, ids, value)
    return R.page_set_ref(pool, ids, value)


def page_copy(pool, pairs, impl="kernel"):
    """PageCP: page ``dst`` of every layer gets page ``src`` as it was
    before the call, for each row ``[src, dst]`` of ``pairs``.  The kernel
    takes at most ``page_ops.COPY_MAX_PAIRS`` (12 800) pairs a call and
    raises ``ValueError`` beyond: a limit the reference's ``page_copy``
    does not have (a serve step sends at most one pair per slot)."""
    if _kernel(pool, impl):
        return K.page_copy(pool, pairs)
    return R.page_copy_ref(pool, pairs)


def page_gather(pool, table, impl="kernel"):
    if _kernel(pool, impl):
        return K.page_gather(pool, table)
    return R.page_gather_ref(pool, table)
