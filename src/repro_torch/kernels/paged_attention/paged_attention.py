"""Launching wrapper of the CUDA ``paged_attention`` kernel.

The kernel (``repro_torch/csrc/paged_attention.cu``) is the Hopper
counterpart of the TPU kernel
``repro/kernels/paged_attention/paged_attention.py``; its plain PyTorch
version is :func:`repro_torch.kernels.paged_attention.ref.\
paged_attention_ref`.  The library is built and loaded at the first call,
never at import.  Page ids must lie in ``[0, NP)``: the kernel does not
check them (that would cost a host sync).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def paged_attention(q, kpool, vpool, block_table, seq_lens):
    """Same contract as :func:`~repro_torch.kernels.paged_attention.ref.\
paged_attention_ref`, for CUDA tensors: ``q`` ``(B, H, D)`` and the pools
    ``(NP, page, Hkv, D)`` all float32 or all bfloat16, ``block_table``
    ``(B, P)`` and ``seq_lens`` ``(B,)`` int32.  ``D`` times the element
    size must be a multiple of 16 bytes.  Returns ``(B, H, D)`` in ``q``'s
    dtype; launches on the current stream and does not synchronise."""
    op = "paged_attention"
    if not q.is_cuda:
        raise ValueError(f"{op}: the kernel needs CUDA tensors; use "
                         "paged_attention_ref for CPU tensors")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{op}: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    dev = q.device
    B, H, D = q.shape
    _build.check_tensor(op, "q", q, q.dtype, (B, H, D), dev)
    _build.check_tensor(op, "kpool", kpool, q.dtype, (None, None, None, D),
                        dev)
    NP, page, Hkv, _ = kpool.shape
    _build.check_tensor(op, "vpool", vpool, q.dtype, (NP, page, Hkv, D), dev)
    _build.check_tensor(op, "block_table", block_table, torch.int32,
                        (B, None), dev)
    _build.check_tensor(op, "seq_lens", seq_lens, torch.int32, (B,), dev)
    P = block_table.shape[1]
    if (H % Hkv or D * q.element_size() % 16 or kpool.data_ptr() % 16
            or vpool.data_ptr() % 16 or min(B, P, page) < 1):
        raise ValueError(f"{op}: needs H % Hkv == 0, rows of a multiple of "
                         f"16 bytes at 16-byte aligned pools and B, P, page "
                         f">= 1; got H={H} Hkv={Hkv} D={D} {q.dtype} B={B} "
                         f"P={P} page={page}")
    out = torch.empty_like(q)
    _build.launch(op, _build.entry("paged_attention",
                                   "paged_attention_launch", _ARGS),
                  (q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                   block_table.data_ptr(), seq_lens.data_ptr(),
                   out.data_ptr(), B, H, Hkv, D, page, P, _DTYPES[q.dtype],
                   torch.cuda.current_stream(dev).cuda_stream), dev)
    paged_attention.launches += 1
    return out


#: launches of the CUDA kernel since the counter was last set to 0
paged_attention.launches = 0
