"""Entry point of flash attention (training / prefill): the tensor's device
picks the implementation.

CUDA tensors go to the hand-written kernel — or raise if it cannot be
built or launched — inside an ``autograd.Function`` whose backward is
:func:`~repro_torch.kernels.flash_attention.ref.attention_bwd`, plain
PyTorch (the reference has no backward kernel either: its gradient is
XLA's autodiff).  CPU tensors go to the plain PyTorch version, with
autograd through it.  There is no probing and no fallback: the plain
version runs on CUDA tensors only when it is asked for by name
(``impl="ref"``).  A sliding window is a no-op while ``S <= window``; a
shorter one goes to the kernel (both of its designs take it) and to the
backward alike.  DTensor inputs (the dry run's, batch and heads sharded)
run the plain version on each device's shards, without autograd the
reference's online KV chunks
(:func:`repro_torch.distributed.dtensor.local_attention`) under the same
rule: only with ``impl="ref"`` or shards off the card.
"""
from __future__ import annotations

import torch

from ...distributed import dtensor as DT
from .flash_attention import flash_attention
from .ref import attention_bwd, flash_mha_ref

IMPLS = ("kernel", "ref")


class FlashMHA(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: :func:`attention_bwd` from the
    saved ``q``, ``k``, ``v``, with the same mask."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.causal = causal
        ctx.window = window
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*attention_bwd(q, k, v, do, ctx.causal, ctx.window), None,
                None)


def flash_mha(q, k, v, causal=True, impl="kernel", window=0):
    """q ``(B, S, H, D)``, k/v ``(B, S, Hkv, D)`` -> ``(B, S, H, D)``.
    ``window`` > 0 (with ``causal``) also masks keys ``window`` or more
    positions before the query, the reference's ``_online_attn``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    S = q.shape[1]
    if window and window >= S:
        window = 0                      # every causal key is in the window
    if DT.is_dtensor(q):
        DT.refuse_kernel("flash_mha", q, impl)
        return DT.local_attention(q, k, v, causal, window)
    if impl == "kernel" and q.is_cuda:
        return FlashMHA.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal, window)
    return flash_mha_ref(q, k, v, causal, window)

