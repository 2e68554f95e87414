"""Launching wrapper of the CUDA ``paged_attention`` kernel.

The kernel (``repro_torch/csrc/paged_attention.cu``) is the Hopper
counterpart of the TPU kernel
``repro/kernels/paged_attention/paged_attention.py``; its plain PyTorch
version is :func:`repro_torch.kernels.paged_attention.ref.\
paged_attention_ref`.  It splits each sequence's pages over several CTAs
and combines their partial softmaxes in the same launch
(:func:`plan` picks the split from the shapes and the SM count).  The
library is built and loaded at the first call, never at import.  Page ids
must lie in ``[0, NP)``: the kernel does not check them (that would cost a
host sync).  A sliding window launches the kernel's windowed
instantiation (``paged_attention_window_launch``, counted in
``paged_attention.window_launches``); ``window = 0`` launches the
untouched one (``paged_attention_launch``, counted in
``paged_attention.launches``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
#: the windowed entry's: ``window`` before the stream
_WINDOW_ARGS = _ARGS[:-1] + [ctypes.c_int, ctypes.c_void_p]

#: the kernel's ring stages per warp (paged_attention.cu), and its warps
#: per CTA: 4, or 8 for a range of at most ``SHORT_CHUNKS`` chunks
STAGES, WARPS, SHORT_WARPS, SHORT_CHUNKS = 3, 4, 8, 16
#: a full-length table is spread over about WAVES waves of CTAs, a wave
#: being CTAS_PER_SM resident CTAs on every SM (a CTA holds ~60 KiB of
#: shared memory), in at most MAX_SPLITS ranges a sequence
WAVES, CTAS_PER_SM, MAX_SPLITS = 2, 4, 64
#: shared memory the rings of K and V rows of one CTA take at most
RING_BYTES = 48 * 1024
#: largest head dimension: four 4-element slices per lane
D_MAX = 512


class Plan(NamedTuple):
    """How one call is cut: ``gc`` query heads of a KV head per CTA in
    ``groups`` groups, ``splits`` ranges of ``pages_per_split`` pages per
    sequence, ring chunks of ``rows`` rows, ``warps`` warps a CTA."""
    gc: int
    groups: int
    splits: int
    pages_per_split: int
    rows: int
    warps: int


def plan(B, H, Hkv, D, page, P, esize, sm_count) -> Plan:
    """The cut of a call from its shapes and the card's SM count alone —
    never from the lengths, which live on the device.  ``gc`` keeps a
    lane's registers at 64 f32 for the query rows (``gc`` x ``4 *
    ceil(D / 128)``); the splits give about ``WAVES`` waves of CTAs when
    every table is full, with no split past the last page.  A range of
    at most ``SHORT_CHUNKS`` chunks gets ``SHORT_WARPS`` warps, so that
    each warp's serial chain of chunks is short; a longer range keeps
    ``WARPS``, so that more CTAs fit an SM."""
    G = H // Hkv
    c4 = -(-D // 128)
    gc = min(G, 16 // c4)
    groups = -(-G // gc)
    want = -(-WAVES * CTAS_PER_SM * sm_count // (B * Hkv * groups))
    splits = max(1, min(P, want, MAX_SPLITS))
    pages_per_split = -(-P // splits)
    splits = -(-P // pages_per_split)
    rows = max(1, min(16, RING_BYTES // (WARPS * STAGES * 2 * D * esize)))
    chunks = -(-pages_per_split * page // rows)
    warps = SHORT_WARPS if chunks <= SHORT_CHUNKS else WARPS
    return Plan(gc, groups, splits, pages_per_split, rows, warps)


_sm_counts: dict[int, int] = {}
#: per device: the partials (float32) and the tickets (int32, all 0
#: between calls)
_workspace: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def _sm_count(index):
    if index not in _sm_counts:
        _sm_counts[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def workspace(device, n_part, n_counters):
    """The device's workspace ``(partials, counters)``, grown to at least
    ``n_part`` floats and ``n_counters`` counters; the same tuple until it
    grows (the wrapper's checked calls hold it).  Calls share it in stream order: a decode
    step runs on one stream, so a call's partials and tickets are done
    with before the next call's kernel starts."""
    ws = _workspace.get(device.index)
    if ws is None or ws[0].numel() < n_part or ws[1].numel() < n_counters:
        if ws is not None:
            n_part = max(n_part, ws[0].numel())
            n_counters = max(n_counters, ws[1].numel())
        ws = _workspace[device.index] = (
            torch.empty((n_part,), dtype=torch.float32, device=device),
            torch.zeros((n_counters,), dtype=torch.int32, device=device))
    return ws


#: (shapes, dtypes, devices, layouts) of calls already checked -> (the
#: device, the workspace they were planned on, its two pointers, the
#: launch's trailing integer arguments)
_checked: dict[tuple, tuple] = {}


def _check(q, kpool, vpool, block_table, seq_lens):
    """Every refusal of the contract, once per distinct combination of
    shapes, dtypes, devices and layouts; returns what a launch of that
    combination needs besides the data pointers."""
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
    if (Hkv < 1 or H % Hkv or D * q.element_size() % 16 or D > D_MAX
            or min(B, P, page) < 1):
        raise ValueError(f"{op}: needs H % Hkv == 0, rows of a multiple of "
                         f"16 bytes, D <= {D_MAX} and B, P, page >= 1; got "
                         f"H={H} Hkv={Hkv} D={D} {q.dtype} B={B} P={P} "
                         f"page={page}")
    pl = plan(B, H, Hkv, D, page, P, q.element_size(),
              _sm_count(dev.index))
    slots = B * Hkv * pl.groups
    ws = workspace(dev, slots * pl.splits * pl.gc * (D + 2), slots)
    tail = (B, H, Hkv, D, page, P, _DTYPES[q.dtype], pl.gc, pl.splits,
            pl.pages_per_split, pl.rows, pl.warps)
    return dev, ws, ws[0].data_ptr(), ws[1].data_ptr(), tail


def paged_attention(q, kpool, vpool, block_table, seq_lens, window=0):
    """Same contract as :func:`~repro_torch.kernels.paged_attention.ref.\
paged_attention_ref`, for CUDA tensors: ``q`` ``(B, H, D)`` and the pools
    ``(NP, page, Hkv, D)`` all float32 or all bfloat16, ``block_table``
    ``(B, P)`` and ``seq_lens`` ``(B,)`` int32.  ``D`` times the element
    size must be a multiple of 16 bytes, and ``D`` at most ``D_MAX``.
    Returns ``(B, H, D)`` in ``q``'s dtype; one launch on the current
    stream, no synchronisation.  ``window`` > 0 reads the table as the
    ring of a sliding window (the windowed instantiation; see
    :mod:`.ref`).  The partials of a split sequence live in
    a per-device workspace that calls share in stream order (see
    :func:`workspace`)."""
    key = (q.device, q.dtype, q.shape, kpool.shape, vpool.shape,
           kpool.dtype, vpool.dtype, kpool.device, vpool.device,
           block_table.shape, block_table.dtype, block_table.device,
           seq_lens.shape, seq_lens.dtype, seq_lens.device,
           q.is_contiguous(), kpool.is_contiguous(), vpool.is_contiguous(),
           block_table.is_contiguous(), seq_lens.is_contiguous())
    hit = _checked.get(key)
    if hit is None or _workspace[hit[0].index] is not hit[1]:
        hit = _checked[key] = _check(q, kpool, vpool, block_table, seq_lens)
    dev, _, part, counters, tail = hit
    qp, kp, vp = q.data_ptr(), kpool.data_ptr(), vpool.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("paged_attention: q and the pools must start at "
                         "16-byte aligned addresses")
    out = torch.empty_like(q)
    stream = _build.current_stream(dev)
    args = (qp, kp, vp, block_table.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), part, counters, *tail)
    if window:
        _build.launch("paged_attention", _build.entry(
            "paged_attention", "paged_attention_window_launch",
            _WINDOW_ARGS), (*args, int(window), stream), dev)
        paged_attention.window_launches += 1
        return out
    _build.launch("paged_attention", _build.entry(
        "paged_attention", "paged_attention_launch", _ARGS),
        (*args, stream), dev)
    paged_attention.launches += 1
    return out


#: launches of the CUDA kernel since the counter was last set to 0: the
#: instantiation without a window, and the windowed one
paged_attention.launches = 0
paged_attention.window_launches = 0
