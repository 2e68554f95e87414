"""Plain PyTorch version of paged decode attention.

Shapes (the reference's): ``q`` ``(B, H, D)`` one new token per
sequence, ``kpool``/``vpool`` ``(NP, page, Hkv, D)`` a global page pool,
``block_table`` ``(B, P)`` int32 page ids per sequence, ``seq_lens``
``(B,)`` int32.  Query head ``h * G + g`` (``G = H // Hkv``) reads KV head
``h``; positions ``>= seq_lens`` are masked with ``-1e30``, so a length of
0 gives the mean of V over all ``P * page`` slots.  Scores and the
softmax are f32; the output has ``q``'s dtype.

With a sliding ``window > 0`` the table is a ring of ``kv = P * page``
slots and ``seq_lens[b]`` counts row ``b``'s tokens, the new one included,
which sits in slot ``(seq_lens[b] - 1) mod kv``.  Slot ``t`` is attended
iff ``(seq_lens[b] - 1 - t) mod kv < window`` — the reference's decode
rule (``repro/models/core.py:675-683`` with ``_online_attn``'s mask,
``:86-89``): with ``s = seq_lens[b] - 1`` its ring position ``t`` has
``kv_pos = s - ((s - t) mod kv)``, kept iff ``kv_pos > s - window``.  The
rule does not ask whether the slot was ever written: while ``kv <=
window`` every slot of the ring is attended, zeros included, and a
one-token sequence averages its value with them (ROADMAP Queue C,
"Recorded").  Some slot is always attended, so no row is uniform.
"""
from __future__ import annotations

import math

import torch


def paged_attention_ref(q, kpool, vpool, block_table, seq_lens, window=0):
    B, H, D = q.shape
    NP, page, Hkv, _ = kpool.shape
    P = block_table.shape[1]
    G = H // Hkv
    bt = block_table.long()
    k = kpool[bt].reshape(B, P * page, Hkv, D).float()
    v = vpool[bt].reshape(B, P * page, Hkv, D).float()
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) / math.sqrt(D)
    pos = torch.arange(P * page, device=q.device)
    if window:
        ring = (seq_lens[:, None].long() - 1 - pos) % (P * page)
        valid = ring < window                                 # (B, P*page)
    else:
        valid = pos < seq_lens[:, None]
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v)
    return o.reshape(B, H, D).to(q.dtype)


def paged_partial(q, kpool, vpool, block_table, seq_lens, first, window=0):
    """One split of split-KV decoding: what the pages
    ``first .. first + NP - 1`` of the global pool, held here as
    ``kpool``/``vpool`` ``(NP, page, Hkv, D)``, give every row's softmax,
    as ``(m, l, acc)`` ``(B, H)``, ``(B, H)``, ``(B, H, D)`` f32: the
    running max of the scores, the sum of their exponentials after it and
    the sum of the values weighted by them: splits join as
    ``csrc/paged_attention.cu`` joins its ranges, each rescaled to the
    largest max and summed.  ``q`` ``(B, H, D)``, ``H = Hkv * G``.  Each
    page is read by the one table entry that names it, the scores of its
    slots masked as :func:`paged_attention_ref` masks them (-1e30); a row
    that reads no page of the split has ``m = -inf``, ``l = acc = 0``.  The
    work is the split's pages, not the rows': a table entry names at most
    one page of the split, so a table that names a page twice (a page
    shared between rows) is outside this function."""
    B, H, D = q.shape
    NP, page, Hkv, _ = kpool.shape
    P = block_table.shape[1]
    G = H // Hkv
    dev = q.device
    local = block_table.long() - first                            # (B, P)
    mine = (local >= 0) & (local < NP)
    entry = torch.arange(B * P, device=dev)
    reader = torch.full((NP + 1,), B * P, dtype=torch.long, device=dev) \
        .scatter_(0, torch.where(mine, local, NP).reshape(-1), entry)[:NP]
    read = reader < B * P
    row = torch.where(read, reader // P, B)                # B: no reader
    pos = (reader % P)[:, None] * page + torch.arange(page, device=dev)
    lens = torch.cat([seq_lens.long(), seq_lens.new_ones(1)])[row, None]
    if window:                                                # (NP, page)
        valid = (lens - 1 - pos) % (P * page) < window
    else:
        valid = pos < lens
    qg = torch.cat([q, q.new_zeros((1, H, D))])[row].float() \
        .reshape(NP, Hkv, G, D)
    s = torch.einsum("nhgd,nshd->nhgs", qg, kpool.float()) / math.sqrt(D)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    at = row[:, None, None].expand(NP, Hkv, G)
    m = torch.full((B + 1, Hkv, G), float("-inf"), device=dev).scatter_reduce(
        0, at, s.amax(dim=-1), "amax")
    p = torch.exp(s - m[row][..., None])
    l = torch.zeros((B + 1, Hkv, G), device=dev).index_add(0, row,
                                                           p.sum(dim=-1))
    acc = torch.zeros((B + 1, Hkv, G, D), device=dev).index_add(
        0, row, torch.einsum("nhgs,nshd->nhgd", p, vpool.float()))
    return m[:B].reshape(B, H), l[:B].reshape(B, H), acc[:B].reshape(B, H, D)

