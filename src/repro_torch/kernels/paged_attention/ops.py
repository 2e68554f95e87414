"""Entry point of paged decode attention: the tensor's device picks the
implementation.

CUDA tensors go to the hand-written kernel — or raise if it cannot be
built or launched; CPU tensors go to the plain PyTorch version.  There is
no probing and no fallback: the plain version runs on CUDA tensors only
when it is asked for by name (``impl="ref"``).
"""
from __future__ import annotations

from .paged_attention import paged_attention
from .ref import paged_attention_ref

IMPLS = ("kernel", "ref")


def paged_decode(q, kpool, vpool, block_table, seq_lens, impl="kernel"):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel" and q.is_cuda:
        return paged_attention(q, kpool, vpool, block_table, seq_lens)
    return paged_attention_ref(q, kpool, vpool, block_table, seq_lens)
