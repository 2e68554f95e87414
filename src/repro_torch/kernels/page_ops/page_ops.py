"""Launching wrappers of the CUDA ``page_set``, ``page_copy`` and
``page_gather`` kernels.

The kernels (``repro_torch/csrc/page_ops.cu``) are the Hopper
counterparts of the TPU kernels ``repro/kernels/page_ops/page_ops.py``
``page_set`` / ``page_copy`` / ``page_gather``; their plain PyTorch
versions are in :mod:`repro_torch.kernels.page_ops.ref`.  The pool
``(..., NP, page, H, D)`` is updated in place by the first two and read
by the third; one launch covers every leading layer (and, for
``page_set``, a tuple of pools of one shape).  The library is built and
loaded at the first call, never at import.  Page ids must lie in
``[0, NP)``: the kernels do not check them (that would cost a host
sync).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

_ARGS = {
    "page_set_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_longlong, ctypes.c_uint64, ctypes.c_uint64,
                        ctypes.c_void_p],
    "page_copy_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_void_p],
    "page_copy_staged_launch": [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_int,
                                ctypes.c_longlong, ctypes.c_longlong,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p],
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
#: most pairs of one ``page_copy`` in one grid (a chunk of one vector of
#: each in shared memory); more are staged through device memory
COPY_MAX_PAIRS = COPY_SMEM_BYTES // 16
#: most pools of one ``page_set`` launch (``MAX_POOLS`` of the source)
SET_MAX_POOLS = 8


def copy_route(k):
    """How ``page_copy`` moves ``k`` pairs: ``"grid"``, one launch whose
    CTAs hold a chunk of every source in shared memory, up to
    ``COPY_MAX_PAIRS``; ``"staged"`` beyond, every source gathered into a
    scratch buffer of ``k`` pages a layer, then scattered with the last
    pair of each destination winning (three launches)."""
    return "grid" if k <= COPY_MAX_PAIRS else "staged"


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


#: the 16-byte fill pattern of each (dtype, value), as two u64 halves
_patterns: dict[tuple, tuple[int, int]] = {}


def _pattern(dtype, value):
    key = (dtype, value)
    if key not in _patterns:
        # the value in the pool's dtype, repeated over 16 bytes
        pat = torch.full((16 // dtype.itemsize,), value, dtype=dtype)
        _patterns[key] = tuple(int(w) & ((1 << 64) - 1)
                               for w in pat.view(torch.int64))
    return _patterns[key]


def page_set(pools, ids, value):
    """PageS on CUDA pools: pages ``ids`` ``(K,)`` int32 of every layer
    of ``pools`` — one pool, or a tuple of pools of one shape, dtype and
    device (the serving engine's K and V pools) — are set to ``value``.
    One launch on the current stream (none for ``K = 0``); returns
    ``pools``."""
    many = isinstance(pools, (tuple, list))
    group = tuple(pools) if many else (pools,)
    if not 0 < len(group) <= SET_MAX_POOLS:
        raise ValueError(f"page_set: takes 1 to {SET_MAX_POOLS} pools, got "
                         f"{len(group)}")
    first = group[0]
    layers, np_, vecs = _geometry("page_set", first)
    for pool in group[1:]:
        if (pool.shape != first.shape or pool.dtype != first.dtype or
                pool.device != first.device):
            raise ValueError("page_set: the pools must share shape, dtype "
                             f"and device; got {tuple(pool.shape)} "
                             f"{pool.dtype} {pool.device} beside "
                             f"{tuple(first.shape)} {first.dtype} "
                             f"{first.device}")
        _geometry("page_set", pool)
    _build.check_tensor("page_set", "ids", ids, torch.int32, (None,),
                        first.device)
    k = ids.shape[0]
    if k == 0:
        return pools
    lo, hi = _pattern(first.dtype, value)
    ptrs = (ctypes.c_void_p * len(group))(*(p.data_ptr() for p in group))
    _build.launch("page_set", _fn("page_set_launch"),
                  (ptrs, len(group), ids.data_ptr(), k, layers, np_, vecs,
                   lo, hi, _build.current_stream(first.device)),
                  first.device)
    page_set.launches += 1
    return pools


def page_copy(pool, pairs):
    """PageCP on a CUDA pool: for each row ``[src, dst]`` of ``pairs``
    ``(K, 2)`` int32, page ``dst`` of every layer gets page ``src`` as it
    was before the call; on duplicate destinations the last pair wins.
    Returns ``pool``; nothing is launched for ``K = 0``.  Up to
    ``COPY_MAX_PAIRS`` pairs it is one grid on the current stream that
    allocates nothing; beyond, the sources are staged in a scratch buffer
    of ``K`` pages a layer (``copy_route``)."""
    _build.check_tensor("page_copy", "pairs", pairs, torch.int32, (None, 2),
                        pool.device)
    k = pairs.shape[0]
    layers, np_, vecs = _geometry("page_copy", pool)
    if k == 0:
        return pool
    stream = _build.current_stream(pool.device)
    if copy_route(k) == "grid":
        chunk = min(vecs, COPY_CHUNK_VECS, COPY_SMEM_BYTES // (16 * k))
        _build.launch("page_copy", _fn("page_copy_launch"),
                      (pool.data_ptr(), pairs.data_ptr(), k, layers, np_,
                       vecs, chunk, stream), pool.device)
    else:
        scratch = page_gather(pool, pairs[:, 0].contiguous())
        last = torch.zeros((np_,), dtype=torch.int32, device=pool.device)
        _build.launch("page_copy", _fn("page_copy_staged_launch"),
                      (pool.data_ptr(), pairs.data_ptr(), k, layers, np_,
                       vecs, scratch.data_ptr(), last.data_ptr(), stream),
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
