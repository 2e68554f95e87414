"""The windowed instantiation of the paged decode attention kernel's CUDA
source (``paged_attention_window_launch`` in
``src/repro_torch/csrc/paged_attention.cu``), compiled for the host with
``g++`` under the emulation of ``tests/cuda_shim`` as
``tests/test_torch_paged_attention_shim.py`` compiles the unwindowed one,
against the plain version ``paged_attention_ref`` with the same window
(``WINDOW_CASES``): rings wrapped, the masked span across a page boundary
and over whole ranges, lengths below the window, every split count.
Tolerance: ``ATTN_TOL`` (1e-5 + 1e-5·|plain| in float32, one bfloat16
rounding step).  The workspace's partials start as NaN and every ticket
counter must be back at 0 after a call.  A file of its own so that a
test run that hands one file to one worker runs the two instantiations
side by side."""
import math

import pytest
import torch

from repro_torch.kernels.flash_attention.ref import ATTN_TOL
from repro_torch.kernels.paged_attention import paged_attention as PA
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

import torch_shim
from test_torch_paged_attention_shim import inputs


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return torch_shim.build("paged_attention",
                            tmp_path_factory.mktemp("shim"))


# -- the windowed instantiation (paged_attention_window_launch) -------------
def shim_window_call(launch_w, q, kp, vp, bt, lens, window, splits=None,
                     sm_count=132):
    """The wrapper's windowed launch on CPU tensors, with its plan (or
    ``splits`` ranges instead of the planned ones)."""
    B, H, D = q.shape
    NP, page, Hkv, _ = kp.shape
    P = bt.shape[1]
    pl = PA.plan(B, H, Hkv, D, page, P, q.element_size(), sm_count)
    if splits is not None:
        pps = -(-P // splits)
        pl = pl._replace(splits=-(-P // pps), pages_per_split=pps)
    slots = B * Hkv * pl.groups
    part = torch.full((slots * pl.splits * pl.gc * (D + 2),), math.nan)
    counters = torch.zeros((slots,), dtype=torch.int32)
    out = torch.full_like(q, math.nan)
    rc = launch_w(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
                  lens.data_ptr(), out.data_ptr(), part.data_ptr(),
                  counters.data_ptr(), B, H, Hkv, D, page, P,
                  PA._DTYPES[q.dtype], pl.gc, pl.splits, pl.pages_per_split,
                  pl.rows, pl.warps, window, None)
    assert rc == 0
    assert not counters.any(), "a ticket counter was left set"
    return out, pl


@pytest.fixture(scope="module")
def launch_window(lib):
    return torch_shim.entry(lib, "paged_attention_window_launch",
                            PA._WINDOW_ARGS)


def check_window(launch_w, shape, dtype, lens, window, splits=None, seed=0):
    """Every table entry is read under a window, so the table holds finite
    pages only; the plain version with the same window is the oracle."""
    q, kp, vp, bt, lens, _ = inputs(*shape, dtype, lens, seed)
    got, pl = shim_window_call(launch_w, q, kp, vp, bt, lens, window,
                               splits=splits)
    want = paged_attention_ref(q, kp, vp, bt, lens, window)
    assert torch.isfinite(got).all()
    atol, rtol = ATTN_TOL[str(dtype).split(".")[1]]
    diff = (got.float() - want.float()).abs()
    assert float((diff - rtol * want.float().abs()).max()) <= atol, \
        float(diff.max())
    return pl, want


#: (B, H, Hkv, D, page, P), dtype, lengths, window: a window past the ring
#: (every slot attended, written or not); rings wrapped, the masked span
#: (ring - window slots after the newest) across a page boundary and over
#: whole pages (a range of one page with no attended row); lengths below
#: the window; the newest token mid-page, on a page's first and last slot
WINDOW_CASES = [
    ((2, 4, 2, 16, 8, 4), torch.float32, [1, 30], 64),
    ((3, 8, 2, 32, 8, 4), torch.float32, [40, 45, 70], 20),
    ((3, 8, 2, 32, 8, 4), torch.float32, [33, 64, 97], 10),
    ((1, 4, 2, 32, 8, 3), torch.float32, [5], 16),
    ((2, 32, 8, 128, 16, 4), torch.bfloat16, [65, 100], 50),
    ((2, 32, 8, 128, 64, 3), torch.bfloat16, [200, 385], 150),
    ((1, 10, 2, 32, 8, 3), torch.float32, [26], 9),            # G = 5
]


@pytest.mark.parametrize("splits", [1, 2, "P"])
@pytest.mark.parametrize("shape,dtype,lens,window", WINDOW_CASES,
                         ids=[f"{c[0]}-{str(c[1])[6:]}-w{c[3]}"
                              for c in WINDOW_CASES])
def test_windowed_kernel_source_equals_plain_version(launch_window, shape,
                                                     dtype, lens, window,
                                                     splits):
    P = shape[5]
    pl, _ = check_window(launch_window, shape, dtype, lens, window,
                         P if splits == "P" else splits)
    assert pl.splits == min(P if splits == "P" else splits, P)


def test_windowed_kernel_source_masks_what_the_window_drops(launch_window):
    """The window is not a no-op: the same inputs without it (every slot up
    to the length, which is past the ring) give another output; and a
    window of the ring or more equals full attention over the ring."""
    shape, lens = (3, 8, 2, 32, 8, 4), [40, 45, 70]
    _, want = check_window(launch_window, shape, torch.float32, lens, 20,
                           splits=4)
    q, kp, vp, bt, lens_t, _ = inputs(*shape, torch.float32, lens, 0)
    full = paged_attention_ref(q, kp, vp, bt, lens_t)
    assert (want - full).abs().max() > 1e-2
    whole, _ = shim_window_call(launch_window, q, kp, vp, bt, lens_t, 32,
                                splits=4)
    assert torch.allclose(whole, full, rtol=1e-5, atol=1e-5)


def test_windowed_entry_refuses_a_window_below_one(launch_window):
    q, kp, vp, bt, lens, _ = inputs(1, 2, 1, 16, 8, 1, torch.float32, [3], 0)
    pl = PA.plan(1, 2, 1, 16, 8, 1, 4, 132)
    out = torch.empty_like(q)
    assert launch_window(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                         bt.data_ptr(), lens.data_ptr(), out.data_ptr(),
                         None, None, 1, 2, 1, 16, 8, 1, 0, pl.gc, pl.splits,
                         pl.pages_per_split, pl.rows, pl.warps, 0,
                         None) != 0
