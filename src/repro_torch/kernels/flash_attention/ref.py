"""Plain PyTorch versions of flash attention (training / prefill).

:func:`attention_ref` is the reference's oracle
(``repro/kernels/flash_attention/ref.py``) on ``(BH, S, D)``: scores in
f32 scaled ``1/sqrt(D)``, an optional causal mask by index written as
``-1e30``, a softmax over the keys and ``p @ v`` in f32, the output in
``q``'s dtype.  :func:`flash_mha_ref` is the same on the model's layout
``(B, S, H, D)`` with ``(B, S, Hkv, D)`` keys and values — the GQA fold of
``repro/kernels/flash_attention/ops.py``: query head ``h`` reads KV head
``h // (H // Hkv)``.

:func:`attention_bwd` is the gradient of that function, written out from
the saved inputs (it recomputes the scores and the softmax): the backward
of the kernel route's ``autograd.Function`` (``ops.py``).  It does not
call the forward's plain version.
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


def attention_ref(q, k, v, causal=True):
    BH, S, D = q.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None], s, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_mha_ref(q, k, v, causal=True):
    """q ``(B, S, H, D)``, k/v ``(B, S, Hkv, D)`` -> ``(B, S, H, D)``."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kr = k.repeat_interleave(G, dim=2)
    vr = v.repeat_interleave(G, dim=2)

    def fold(x):
        return x.transpose(1, 2).reshape(B * H, S, D)
    o = attention_ref(fold(q), fold(kr), fold(vr), causal)
    return o.reshape(B, H, S, D).transpose(1, 2)


def attention_bwd(q, k, v, do, causal=True):
    """Gradients ``(dq, dk, dv)`` of ``flash_mha_ref(q, k, v, causal)``
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
    mask = None
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
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
