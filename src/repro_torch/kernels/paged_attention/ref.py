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
