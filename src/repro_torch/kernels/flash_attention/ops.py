"""Entry point of flash attention (training / prefill): the tensor's device
picks the implementation.

CUDA tensors go to the hand-written kernel — or raise if it cannot be
built or launched — inside an ``autograd.Function`` whose backward is
:func:`~repro_torch.kernels.flash_attention.ref.attention_bwd`, plain
PyTorch (the reference has no backward kernel either: its gradient is
XLA's autodiff).  CPU tensors go to the plain PyTorch version, with
autograd through it.  There is no probing and no fallback: the plain
version runs on CUDA tensors only when it is asked for by name
(``impl="ref"``).
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .ref import attention_bwd, flash_mha_ref

IMPLS = ("kernel", "ref")


class FlashMHA(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: :func:`attention_bwd` from the
    saved ``q``, ``k``, ``v``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*attention_bwd(q, k, v, do, ctx.causal), None)


def flash_mha(q, k, v, causal=True, impl="kernel"):
    """q ``(B, S, H, D)``, k/v ``(B, S, Hkv, D)`` -> ``(B, S, H, D)``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel" and q.is_cuda:
        return FlashMHA.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal)
    return flash_mha_ref(q, k, v, causal)
