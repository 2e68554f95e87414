"""Plain PyTorch version of paged decode attention.

Shapes (the reference's): ``q`` ``(B, H, D)`` one new token per
sequence, ``kpool``/``vpool`` ``(NP, page, Hkv, D)`` a global page pool,
``block_table`` ``(B, P)`` int32 page ids per sequence, ``seq_lens``
``(B,)`` int32.  Query head ``h * G + g`` (``G = H // Hkv``) reads KV head
``h``; positions ``>= seq_lens`` are masked with ``-1e30``, so a length of
0 gives the mean of V over all ``P * page`` slots.  Scores and the
softmax are f32; the output has ``q``'s dtype.
"""
from __future__ import annotations

import math

import torch


def paged_attention_ref(q, kpool, vpool, block_table, seq_lens):
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
    s = torch.where(pos < seq_lens[:, None, None, None], s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v)
    return o.reshape(B, H, D).to(q.dtype)
