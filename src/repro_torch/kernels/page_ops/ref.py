"""Plain PyTorch versions of the HTP page operations on a KV page pool.

A pool is ``(..., NP, page, H, D)``: ``NP`` pages, optionally behind
leading layer axes (the serving engine keeps one pool per K and V with
all layers stacked in front), and an operation applies to the same page
ids on every layer.  ``page_set_ref`` and ``page_copy_ref`` update the
pool in place and return it, as the CUDA kernels of
``repro_torch/csrc/page_ops.cu`` do; the reference's functional
``pool.at[...].set`` becomes an in-place write on a pool nobody else
holds.  ``page_gather_ref`` returns a new tensor, as its kernel does.
"""
from __future__ import annotations

import math

import torch


def _pages(pool):
    """``pool`` as ``(layers, NP, page * H * D)``, a view of its storage."""
    if not pool.is_contiguous():
        raise ValueError("page ops need a contiguous pool (they write "
                         "through a view of it)")
    return pool.view(-1, pool.shape[-4], math.prod(pool.shape[-3:]))


def page_set_ref(pool, ids, value):
    """PageS: set pages ``ids`` ``(K,)`` to the scalar ``value``."""
    _pages(pool)[:, ids.long()] = value
    return pool


def page_copy_ref(pool, pairs):
    """PageCP: copy page ``src`` to page ``dst`` for each row ``[src, dst]``
    of ``pairs`` ``(K, 2)``.  Every source is read as it was before the
    call, and where two pairs name one destination the later pair wins —
    what the reference's one scatter of a gather gives."""
    p = _pages(pool)
    src, dst = pairs[:, 0].long(), pairs[:, 1].long()
    later = torch.triu(dst[:, None] == dst[None, :], diagonal=1).any(1)
    keep = ~later
    p[:, dst[keep]] = p[:, src[keep]]
    return pool


def page_gather_ref(pool, table):
    """PageR: pages ``table`` ``(K,)`` as a dense ``(..., K, page, H, D)``
    buffer."""
    return pool.index_select(pool.dim() - 4, table.long())
