"""Plain PyTorch versions of flash attention (training / prefill).

:func:`attention_ref` is the reference's oracle
(``repro/kernels/flash_attention/ref.py``) on ``(BH, S, D)``: scores in
f32 scaled ``1/sqrt(D)``, an optional causal mask by index written as
``-1e30`` (with a sliding ``window``, also keys ``window`` or more
positions before the query: ``_online_attn``'s mask), a softmax over the keys and ``p @ v`` in f32, the output in
``q``'s dtype.  :func:`flash_mha_ref` is the same on the model's layout
``(B, S, H, D)`` with ``(B, S, Hkv, D)`` keys and values — the GQA fold of
``repro/kernels/flash_attention/ops.py``: query head ``h`` reads KV head
``h // (H // Hkv)``.

:func:`attention_bwd` is the gradient of that function, written out from
the saved inputs (it recomputes the scores and the softmax): the backward
of the kernel route's ``autograd.Function`` (``ops.py``).  It does not
call the forward's plain version.

:func:`online_attn` is the reference model's own attention
(``repro/models/core.py::_online_attn``): GQA queries ``(B, Sq, Hkv, G,
D)`` against K/V chunks of :data:`KV_CHUNK` keys with a running ``(m, l,
acc)`` in f32, K and V never repeated to the query heads.  It holds one
chunk's scores at a time, where :func:`flash_mha_ref` holds all ``S x S``;
the dry run's prefill runs it shard by shard.
"""
from __future__ import annotations

import math

import torch

#: the masked score, as the reference writes it
NEG = -1e30
#: how far the attention kernels (``flash_attention``, ``paged_attention``)
#: may lie from their plain versions on the card, as (atol, rtol) by
#: dtype: |kernel - plain| <= atol + rtol * |plain| elementwise.  Kernel
#: and plain version compute in f32 and differ in summation order only
#: (flash_attention's tensor-core design carries the probabilities as
#: three bf16 parts, 24 bits of mantissa), so f32 outputs agree to ~1e-6
#: and bf16 outputs by at most one rounding step (one ulp, at most 2**-7
#: of the value).  A kernel that drops one row of a 256-row sequence moves
#: outputs of ~0.1 by ~0.01, beyond either bound; at the training path's
#: S = 4096, where outputs are ~0.03, dropping one 64-key tile moves a row
#: by ~1/64 of its spread, about 2**-6 of the value.
ATTN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-6, 2 ** -7)}
#: keys a chunk of :func:`online_attn` (the reference's ``KV_CHUNK``)
KV_CHUNK = 512


def attention_ref(q, k, v, causal=True, window=0):
    BH, S, D = q.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(D)
    mask = _mask(S, causal, window, q.device)
    if mask is not None:
        s = torch.where(mask[None], s, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_mha_ref(q, k, v, causal=True, window=0):
    """q ``(B, S, H, D)``, k/v ``(B, S, Hkv, D)`` -> ``(B, S, H, D)``."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kr = k.repeat_interleave(G, dim=2)
    vr = v.repeat_interleave(G, dim=2)

    def fold(x):
        return x.transpose(1, 2).reshape(B * H, S, D)
    o = attention_ref(fold(q), fold(kr), fold(vr), causal, window)
    return o.reshape(B, H, S, D).transpose(1, 2)


def online_attn(q, k, v, q_pos, kv_pos, window=0):
    """The reference's ``_online_attn``: ``q`` ``(B, Sq, Hkv, G, D)``,
    ``k``/``v`` ``(B, Skv, Hkv, D)``, absolute positions ``q_pos`` ``(B,
    Sq)`` and ``kv_pos`` ``(B, Skv)`` -> ``(B, Sq, Hkv, G, D)`` in ``q``'s
    dtype.  Key ``j`` is attended by query ``i`` iff ``kv_pos[j] <=
    q_pos[i]`` and, with a ``window``, ``kv_pos[j] > q_pos[i] - window``;
    the keys go in ``max(Skv // KV_CHUNK, 1)`` equal chunks, each folded
    into a running max ``m``, sum ``l`` and output ``acc`` (f32)."""
    B, Sq, Hkv, G, D = q.shape
    Skv = k.shape[1]
    nkv = max(Skv // KV_CHUNK, 1)
    ck = k.reshape(B, nkv, Skv // nkv, Hkv, D)
    cv = v.reshape(B, nkv, Skv // nkv, Hkv, D)
    cpos = kv_pos.reshape(B, nkv, Skv // nkv)
    qs = q.float() * (1.0 / math.sqrt(D))
    qp = q_pos[:, None, None, :, None]
    m = torch.full((B, Hkv, G, Sq), NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32,
                      device=q.device)
    for j in range(nkv):
        pc = cpos[:, j][:, None, None, None, :]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qs, ck[:, j].float())
        mask = pc <= qp
        if window:
            mask = mask & (pc > qp - window)
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, cv[:, j].float())
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def masked_attn(q, k, v, q_pos, kv_pos, window=0):
    """:func:`online_attn` over all the keys at once (one chunk, no
    running max): the masked softmax of the scores, f32, in ``q``'s
    dtype.  The same inputs and outputs, and the same numbers up to f32
    rounding; under autograd it keeps the scores and probabilities as
    the chunks would, in a tenth of the operators."""
    B, Sq, Hkv, G, D = q.shape
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float() * (1.0 / math.sqrt(D)),
                     k.float())
    qp, pc = q_pos[:, None, None, :, None], kv_pos[:, None, None, None, :]
    mask = pc <= qp
    if window:
        mask = mask & (pc > qp - window)
    s = torch.where(mask, s, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhgqk,bkhd->bhgqd", p / p.sum(dim=-1, keepdim=True),
                       v.float())
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def _mask(S, causal, window, device):
    """The ``(S, S)`` boolean mask of :func:`attention_ref` (True:
    attended), or None without ``causal``."""
    if not causal:
        return None
    mask = torch.ones((S, S), dtype=torch.bool, device=device).tril()
    if window:
        mask = mask & ~torch.ones_like(mask).tril(-window)
    return mask


def attention_bwd(q, k, v, do, causal=True, window=0):
    """Gradients ``(dq, dk, dv)`` of ``flash_mha_ref(q, k, v, causal,
    window)``
    against the output gradient ``do`` ``(B, S, H, D)``, each in its
    input's dtype.  Per sequence and KV head (one GQA group of ``G`` query
    heads at a time): ``s = (q·scale) kᵀ`` in f32, masked, ``p =
    softmax(s)``; then ``dv = Σ_g pᵀ do``, ``dp = do vᵀ``, ``ds = p ⊙ (dp −
    rowsum(p ⊙ dp))``, ``dq = scale · ds k`` and ``dk = scale · Σ_g dsᵀ q``.
    The sums over the group make the GQA fold's gradient: every query head
    of a group read the same K and V.  One group at a time, the f32
    matrices held are ``G x S x S``, not ``H x S x S``."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    mask = _mask(S, causal, window, q.device)
    for b in range(B):
        for h in range(Hkv):
            heads = slice(h * G, (h + 1) * G)
            qg = q[b, :, heads].transpose(0, 1).float()       # (G, S, D)
            dog = do[b, :, heads].transpose(0, 1).float()
            kh = k[b, :, h].float()                           # (S, D)
            vh = v[b, :, h].float()
            s = (qg * scale) @ kh.T                           # (G, S, S)
            if mask is not None:
                s = torch.where(mask, s, NEG)
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            p = p / p.sum(dim=-1, keepdim=True)
            dv[b, :, h] = (p.transpose(1, 2) @ dog).sum(0).to(v.dtype)
            dp = dog @ vh.T
            ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
            dq[b, :, heads] = (ds @ kh * scale).transpose(0, 1).to(q.dtype)
            dk[b, :, h] = ((ds.transpose(1, 2) @ qg).sum(0) * scale) \
                .to(k.dtype)
    return dq, dk, dv
