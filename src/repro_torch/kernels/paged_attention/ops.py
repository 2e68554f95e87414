"""Entry point of paged decode attention: the tensor's device picks the
implementation.

CUDA tensors go to the hand-written kernel — or raise if it cannot be
built or launched; CPU tensors go to the plain PyTorch version.  There is
no probing and no fallback: the plain version runs on CUDA tensors only
when it is asked for by name (``impl="ref"``).  DTensor inputs (the dry
run's: rows over the data axes, query heads over "model", the pools'
pages over the data axes and "model") run the plain version split over
the pages each device holds and combined across the devices
(:func:`repro_torch.distributed.dtensor.local_decode`) under the same
rule: only with ``impl="ref"`` or shards off the card.
"""
from __future__ import annotations

from ...distributed import dtensor as DT
from .paged_attention import paged_attention
from .ref import paged_attention_ref

IMPLS = ("kernel", "ref")


def paged_decode(q, kpool, vpool, block_table, seq_lens, impl="kernel",
                 window=0):
    """``window`` > 0: the block table is a ring, attended by distance from
    the new token (see :mod:`.ref`)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if DT.is_dtensor(q):
        DT.refuse_kernel("paged_decode", q, impl)
        return DT.local_decode(q, kpool, vpool, block_table, seq_lens,
                              window)
    if impl == "kernel" and q.is_cuda:
        return paged_attention(q, kpool, vpool, block_table, seq_lens,
                               window)
    return paged_attention_ref(q, kpool, vpool, block_table, seq_lens,
                               window)

