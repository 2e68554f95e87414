"""Launching wrapper of the CUDA ``flash_attention`` kernel.

The kernel (``repro_torch/csrc/flash_attention.cu``) is the Hopper
counterpart of the TPU kernel
``repro/kernels/flash_attention/flash_attention.py`` with the GQA fold of
its ``ops.py``; its plain PyTorch version is
:func:`repro_torch.kernels.flash_attention.ref.flash_mha_ref`.  The
library is built and loaded at the first call, never at import.  It holds
two designs, picked by dtype and head dimension in the C launcher: the
tensor-core kernel (``wgmma`` fed by TMA) for bfloat16 at D = 64 and 128,
the scalar f32 kernel for float32 and for bfloat16 at D = 16 and 32.
Both take a sliding window (causal only), the mask of the reference's
``_online_attn``: query ``r`` attends key ``c`` iff ``r - window < c <=
r``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
#: the kernel's designs, by the code its launch reports
DESIGNS = ("scalar", "tensor-core")


def flash_attention(q, k, v, causal=True, window=0):
    """Same contract as :func:`~repro_torch.kernels.flash_attention.ref.\
flash_mha_ref`, for CUDA tensors: ``q`` ``(B, S, H, D)``, ``k``/``v``
    ``(B, S, Hkv, D)``, all contiguous and all float32 or all bfloat16,
    ``H % Hkv == 0`` and ``D`` one of 16, 32, 64, 128; ``window`` >= 0
    (0: none; it needs ``causal``, and one of ``S`` or more is none).  A
    ``(BH, S, D)`` problem is ``q.unsqueeze(2)``.  Returns ``(B, S, H,
    D)`` in ``q``'s dtype; launches on the current stream and does not
    synchronise."""
    op = "flash_attention"
    if not q.is_cuda:
        raise ValueError(f"{op}: the kernel needs CUDA tensors; use "
                         "flash_mha_ref for CPU tensors")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{op}: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    dev = q.device
    _build.check_tensor(op, "q", q, q.dtype, (None,) * 4, dev)
    B, S, H, D = q.shape
    _build.check_tensor(op, "k", k, q.dtype, (B, S, None, D), dev)
    Hkv = k.shape[2]
    _build.check_tensor(op, "v", v, q.dtype, (B, S, Hkv, D), dev)
    if D not in _HEAD_DIMS or H % Hkv or min(B, S) < 1:
        raise ValueError(f"{op}: needs D in {_HEAD_DIMS}, H % Hkv == 0 and "
                         f"B, S >= 1; got B={B} S={S} H={H} Hkv={Hkv} D={D}")
    if window < 0 or (window and not causal):
        raise ValueError(f"{op}: window must be >= 0 and needs causal; got "
                         f"window={window} causal={causal}")
    if window >= S:
        window = 0                      # every causal key is in the window
    if S > 65535 * 64:
        raise ValueError(f"{op}: S={S} is over the grid's {65535 * 64}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{op}: q, k and v must start at 16-byte aligned "
                         "addresses (TMA reads them)")
    out = torch.empty_like(q)
    ran = ctypes.c_int(-1)
    _build.launch(op, _build.entry("flash_attention",
                                   "flash_attention_launch", _ARGS),
                  (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, S, H, Hkv, D, int(causal), int(window),
                   _DTYPES[q.dtype],
                   torch.cuda.current_stream(dev).cuda_stream,
                   ctypes.byref(ran)), dev)
    if window:
        flash_attention.window_launches += 1
    else:
        flash_attention.launches += 1
    flash_attention.last_design = DESIGNS[ran.value]
    return out


#: launches of the CUDA kernel since the counter was last set to 0: without
#: a window, and with one (``window < S``)
flash_attention.launches = 0
flash_attention.window_launches = 0
#: the design the last launch ran (``DESIGNS``), None before the first
flash_attention.last_design = None
