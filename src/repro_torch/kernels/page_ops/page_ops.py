"""Launching wrappers of the CUDA ``page_set``, ``page_copy`` and
``page_gather`` kernels.

The kernels (``repro_torch/csrc/page_ops.cu``) are the Hopper
counterparts of the TPU kernels ``repro/kernels/page_ops/page_ops.py``
``page_set`` / ``page_copy`` / ``page_gather``; their plain PyTorch
versions are in :mod:`repro_torch.kernels.page_ops.ref`.  The pool
``(..., NP, page, H, D)`` is updated in place by the first two and read
by the third; one launch covers every leading layer.  The library is
built and loaded at the first call, never at import.  Page ids must lie
in ``[0, NP)``: the kernels do not check them (that would cost a host
sync).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

_ARGS = {
    "page_set_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p],
    "page_copy_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_void_p],
    "page_gather_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_void_p,
                           ctypes.c_void_p],
}
#: shared memory a ``page_copy`` CTA holds its chunk of every source in
COPY_SMEM_BYTES = 200 * 1024
#: most 16-byte vectors of a page one ``page_copy`` CTA moves per pair:
#: 8 KiB, so a single pair of 128 KiB pages still spreads over 16 CTAs a
#: layer
COPY_CHUNK_VECS = 512
#: most pairs of one ``page_copy``: a chunk of one vector of each
COPY_MAX_PAIRS = COPY_SMEM_BYTES // 16


def _fn(name):
    return _build.entry("page_ops", name, _ARGS[name])


def _geometry(op, pool):
    """``(layers, NP, 16-byte vectors per page)`` of a CUDA pool."""
    if pool.dim() < 4 or not pool.is_contiguous():
        raise ValueError(f"{op}: pool must be a contiguous (..., NP, page, "
                         f"H, D) tensor; got {tuple(pool.shape)}")
    if not pool.is_cuda:
        raise ValueError(f"{op}: the kernel needs a CUDA pool; use the "
                         "plain version in page_ops.ref for a CPU pool")
    page_bytes = math.prod(pool.shape[-3:]) * pool.element_size()
    layers = math.prod(pool.shape[:-4])
    if page_bytes % 16 or pool.data_ptr() % 16 or not 0 < layers < 65536:
        raise ValueError(f"{op}: a page must be a whole number of 16-byte "
                         f"vectors at a 16-byte aligned address, and the "
                         f"layers fewer than 65536; got {page_bytes} bytes "
                         f"per page, {layers} layers")
    return layers, pool.shape[-4], page_bytes // 16


def page_set(pool, ids, value):
    """PageS on a CUDA pool: pages ``ids`` ``(K,)`` int32 of every layer
    are set to ``value``.  Launches on the current stream (no launch for
    ``K = 0``) and returns ``pool``."""
    layers, np_, vecs = _geometry("page_set", pool)
    _build.check_tensor("page_set", "ids", ids, torch.int32, (None,),
                        pool.device)
    k = ids.shape[0]
    if k == 0:
        return pool
    # the value in the pool's dtype, repeated over 16 bytes
    pat = torch.full((16 // pool.element_size(),), value, dtype=pool.dtype)
    lo, hi = (int(w) & ((1 << 64) - 1) for w in pat.view(torch.int64))
    _build.launch("page_set", _fn("page_set_launch"),
                  (pool.data_ptr(), ids.data_ptr(), k, layers, np_, vecs,
                   lo, hi, torch.cuda.current_stream(pool.device).cuda_stream),
                  pool.device)
    page_set.launches += 1
    return pool


def page_copy(pool, pairs):
    """PageCP on a CUDA pool: for each row ``[src, dst]`` of ``pairs``
    ``(K, 2)`` int32, page ``dst`` of every layer gets page ``src`` as it
    was before the call; on duplicate destinations the last pair wins.
    Launches one grid on the current stream (none for ``K = 0``),
    allocates nothing, and returns ``pool``.  Each CTA holds a chunk of
    all ``K`` sources in shared memory, so ``K`` is at most
    ``COPY_MAX_PAIRS``."""
    _build.check_tensor("page_copy", "pairs", pairs, torch.int32, (None, 2),
                        pool.device)
    k = pairs.shape[0]
    if k > COPY_MAX_PAIRS:
        raise ValueError(f"page_copy: {k} pairs are more than the "
                         f"{COPY_MAX_PAIRS} whose chunks of one 16-byte "
                         f"vector fit a CTA's shared memory")
    layers, np_, vecs = _geometry("page_copy", pool)
    if k == 0:
        return pool
    chunk = min(vecs, COPY_CHUNK_VECS, COPY_SMEM_BYTES // (16 * k))
    _build.launch("page_copy", _fn("page_copy_launch"),
                  (pool.data_ptr(), pairs.data_ptr(), k, layers, np_, vecs,
                   chunk, torch.cuda.current_stream(pool.device).cuda_stream),
                  pool.device)
    page_copy.launches += 1
    return pool


def page_gather(pool, table):
    """PageR on a CUDA pool: pages ``table`` ``(K,)`` int32 of every layer
    as a new dense ``(..., K, page, H, D)`` tensor.  Launches on the
    current stream (none for ``K = 0``)."""
    _build.check_tensor("page_gather", "table", table, torch.int32, (None,),
                        pool.device)
    layers, np_, vecs = _geometry("page_gather", pool)
    k = table.shape[0]
    out = torch.empty((*pool.shape[:-4], k, *pool.shape[-3:]),
                      dtype=pool.dtype, device=pool.device)
    if k == 0:
        return out
    _build.launch("page_gather", _fn("page_gather_launch"),
                  (pool.data_ptr(), table.data_ptr(), k, layers, np_, vecs,
                   out.data_ptr(),
                   torch.cuda.current_stream(pool.device).cuda_stream),
                  pool.device)
    page_gather.launches += 1
    return out


#: launches of each CUDA kernel since its counter was last set to 0
page_set.launches = 0
page_copy.launches = 0
page_gather.launches = 0
