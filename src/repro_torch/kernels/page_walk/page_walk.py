"""Launching wrapper of the CUDA ``walk_fetch_block`` kernel.

The kernel (``repro_torch/csrc/page_walk.cu``) is the Hopper counterpart
of the TPU kernel ``repro/kernels/page_walk/page_walk.py``; its plain
PyTorch version is :func:`repro_torch.kernels.page_walk.ref.\
walk_fetch_block_ref`.  The library is built and loaded at the first
call, never at import (the CPU tests import this module).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_uint64, ctypes.c_int,
                                  ctypes.c_int] + [ctypes.c_void_p] * 6


def _check(name, t, dtype, shape, device):
    _build.check_tensor("walk_fetch_block", name, t, dtype, shape, device)


def walk_fetch_block(mem, satp, va, mask, block_words, base=None,
                     active=None):
    """Same contract as :func:`~repro_torch.kernels.page_walk.ref.\
walk_fetch_block_ref`, for tensors on a CUDA device: ``mem`` ``(W,)``
    int64 (u64 bit patterns), ``satp``/``va`` ``(L,)`` int64, ``mask`` a
    python int, optional ``base`` ``(L,)`` int64 word offsets and
    ``active`` ``(L,)`` bool.  Returns ``(pa (L,) int64, fault (L,) bool,
    walk_words (L, 3) int64, insts (L, block_words) int32, nbytes (L,)
    int64)``.  Launches on the current stream and does not synchronise.
    """
    if not mem.is_cuda:
        raise ValueError("walk_fetch_block: the kernel needs CUDA tensors; "
                         "use walk_fetch_block_ref for a CPU image")
    if block_words <= 0 or block_words & (block_words - 1):
        raise ValueError("walk_fetch_block: block_words must be a power of "
                         f"two, got {block_words}")
    dev = mem.device
    _check("mem", mem, torch.int64, (None,), dev)
    _check("satp", satp, torch.int64, (None,), dev)
    lanes = satp.shape[0]
    _check("va", va, torch.int64, (lanes,), dev)
    if base is not None:
        _check("base", base, torch.int64, (lanes,), dev)
    if active is not None:
        _check("active", active, torch.bool, (lanes,), dev)
    pa = torch.empty((lanes,), dtype=torch.int64, device=dev)
    fault = torch.empty((lanes,), dtype=torch.bool, device=dev)
    walk_words = torch.empty((lanes, 3), dtype=torch.int64, device=dev)
    insts = torch.empty((lanes, block_words), dtype=torch.int32, device=dev)
    nbytes = torch.empty((lanes,), dtype=torch.int64, device=dev)
    args = (mem.data_ptr(), satp.data_ptr(), va.data_ptr(),
            None if base is None else base.data_ptr(),
            None if active is None else active.data_ptr(),
            mask & ((1 << 64) - 1), lanes, block_words,
            pa.data_ptr(), fault.data_ptr(), walk_words.data_ptr(),
            insts.data_ptr(), nbytes.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.launch("walk_fetch_block", _build.entry(
        "page_walk", "walk_fetch_block_launch", _ARGS), args, dev)
    walk_fetch_block.launches += 1
    return pa, fault, walk_words, insts, nbytes


#: launches of the CUDA kernel since the counter was last set to 0
walk_fetch_block.launches = 0
