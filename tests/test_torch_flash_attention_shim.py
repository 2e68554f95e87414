"""The flash attention kernel's CUDA source,
``src/repro_torch/csrc/flash_attention.cu``, compiled for the host with
``g++`` under the emulation of ``tests/cuda_shim`` and called through its C
entry point, against the plain version ``flash_mha_ref``.  Only the scalar
design builds there (the tensor-core design is inline PTX for the card,
under ``__CUDACC__``; its entry cases return an error, checked here): f32
at D 16, 32, 64, 128 and bf16 at D 16 and 32, causal, not causal, and
under a sliding window — 1, 64 with S not a multiple of the 64-key tile,
S - 1, and windows whose first tile is wholly masked for some rows of a
query tile — with GQA.  Tolerance: ``ATTN_TOL`` (1e-5 + 1e-5·|plain| in
float32, one bfloat16 rounding step).  The output starts as NaN, so a row
the kernel does not store shows."""
import ctypes
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention.ref import ATTN_TOL, flash_mha_ref

import torch_shim


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    lib = torch_shim.build("flash_attention",
                           tmp_path_factory.mktemp("shim"))
    return torch_shim.entry(lib, "flash_attention_launch", FA._ARGS)


def shim_call(launch, q, k, v, causal, window):
    """The wrapper's launch on CPU tensors; returns ``(out, rc, design)``."""
    B, S, H, D = q.shape
    out = torch.full_like(q, math.nan)
    ran = ctypes.c_int(-1)
    rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, H, k.shape[2], D, int(causal), window,
                FA._DTYPES[q.dtype], None, ctypes.byref(ran))
    return out, rc, FA.DESIGNS[ran.value]


def inputs(B, S, H, Hkv, D, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
            for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def check(launch, B, S, H, Hkv, D, dtype, causal, window, seed=0):
    q, k, v = inputs(B, S, H, Hkv, D, dtype, seed)
    got, rc, design = shim_call(launch, q, k, v, causal, window)
    assert rc == 0 and design == "scalar"
    want = flash_mha_ref(q, k, v, causal, window)
    atol, rtol = ATTN_TOL[str(dtype).split(".")[1]]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    return got, want


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_scalar_design_f32(launch, D, causal):
    check(launch, 1, 80, 2, 1, D, torch.float32, causal, 0, seed=D)


@pytest.mark.parametrize("D", [16, 32])
def test_scalar_design_bf16(launch, D):
    check(launch, 2, 70, 4, 2, D, torch.bfloat16, True, 0, seed=D)


@pytest.mark.parametrize("S,window", [
    (70, 1),          # one key a row
    (200, 64),        # S not a multiple of the 64-key tile
    (130, 129),       # S - 1: one key masked, in the last row only
    (200, 70),        # a tile's edge inside the window on both sides
    (256, 3),         # every query tile starts one tile before its own
])
@pytest.mark.parametrize("dtype,D", [(torch.float32, 16),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 32)])
def test_scalar_design_windowed(launch, S, window, dtype, D):
    """Under a window the kernel skips the key tiles wholly before it and
    masks the tiles its edge cuts; for the windows below 64 the first tile
    of a query tile's range is wholly masked for its later rows."""
    got, want = check(launch, 1, S, 4, 2, D, dtype, True, window,
                      seed=S + window)
    full = flash_mha_ref(*inputs(1, S, 4, 2, D, dtype, S + window), True)
    assert not torch.equal(want, full)


def test_tensor_core_cases_are_not_built_here(launch):
    """bf16 at D 64 and 128 is the tensor-core design, which needs the
    card: under the shim the entry refuses it; a negative window and a
    window without causal are refused by every build."""
    q, k, v = inputs(1, 64, 2, 2, 64, torch.bfloat16, 0)
    assert shim_call(launch, q, k, v, True, 0)[1] != 0
    q, k, v = inputs(1, 64, 2, 2, 16, torch.float32, 0)
    assert shim_call(launch, q, k, v, True, -1)[1] != 0
    assert shim_call(launch, q, k, v, False, 8)[1] != 0
