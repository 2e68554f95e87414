"""The paged decode attention kernel's CUDA source,
``src/repro_torch/csrc/paged_attention.cu``, compiled for the host with
``g++`` under the emulation of ``tests/cuda_shim`` (cp.async becomes a
plain copy; CTAs run in a random order, so every CTA of a split sequence
is the last one to take a ticket in some case) and called through its C
entry point with the wrapper's plan, against the plain version
``paged_attention_ref``.  Cases: the test_kernels.py sweep's shapes in
float32, bfloat16 at the serving shape's family, a GQA group of 16, head
groups split over CTAs (G = 32, and G = 5), D = 256 and 512; lengths of
0 (the mean of V), 1, mid-page, a page boundary and the whole table;
split counts of 1, 2 and P (ranges wholly past the length included); the
table past ``ceil(len / page)`` pointing at a page of NaN, which must
never be read.  The windowed instantiation is held in
``tests/test_torch_paged_attention_window_shim.py``.  Tolerance: ``ATTN_TOL`` (1e-5 + 1e-5·|plain| in float32,
one bfloat16 rounding step).  The workspace's partials start as NaN and
every ticket counter must be back at 0 after a call."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import ATTN_TOL
from repro_torch.kernels.paged_attention import paged_attention as PA
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

import torch_shim


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return torch_shim.build("paged_attention",
                            tmp_path_factory.mktemp("shim"))


@pytest.fixture(scope="module")
def launch(lib):
    return torch_shim.entry(lib, "paged_attention_launch", PA._ARGS)


def shim_call(launch, q, kp, vp, bt, lens, splits=None, sm_count=132):
    """The wrapper's launch on CPU tensors, with its plan (or ``splits``
    ranges instead of the planned ones)."""
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
    rc = launch(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
                lens.data_ptr(), out.data_ptr(), part.data_ptr(),
                counters.data_ptr(), B, H, Hkv, D, page, P,
                PA._DTYPES[q.dtype], pl.gc, pl.splits, pl.pages_per_split,
                pl.rows, pl.warps, None)
    assert rc == 0
    assert not counters.any(), "a ticket counter was left set"
    return out, pl


def inputs(B, H, Hkv, D, page, P, dtype, lens, seed):
    """Seeded q, pools, a table of distinct pages, the lengths, and the
    table the kernel gets: page NP - 1 (all NaN) past each sequence's last
    page.  (The plain version reads the padding too, at weight 0, so it
    gets the table of finite pages.)"""
    rng = np.random.default_rng(seed)
    NP = B * P + 1
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32))
    kp = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D),
                                              np.float32))
    vp = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D),
                                              np.float32))
    kp[-1] = math.nan
    vp[-1] = math.nan
    bt = torch.from_numpy(rng.permutation(NP - 1)[:B * P].reshape(B, P)
                          .astype(np.int32))
    lens = torch.tensor(lens, dtype=torch.int32)
    padded = bt.clone()
    for b, n in enumerate(lens.tolist()):
        if n > 0:
            padded[b, -(-n // page):] = NP - 1
    return [t.to(dtype) if t.is_floating_point() else t
            for t in (q, kp, vp, bt, lens, padded)]


def check(launch, shape, dtype, lens, splits=None, seed=0):
    q, kp, vp, bt, lens, padded = inputs(*shape, dtype, lens, seed)
    got, pl = shim_call(launch, q, kp, vp, padded, lens, splits=splits)
    want = paged_attention_ref(q, kp, vp, bt, lens)
    assert torch.isfinite(got).all()
    atol, rtol = ATTN_TOL[str(dtype).split(".")[1]]
    diff = (got.float() - want.float()).abs()
    assert float((diff - rtol * want.float().abs()).max()) <= atol, \
        float(diff.max())
    return pl


#: (B, H, Hkv, D, page, P), dtype, lengths
CASES = [
    ((2, 4, 2, 16, 8, 4), torch.float32, [1, 30]),
    ((1, 2, 1, 32, 16, 3), torch.float32, [48]),
    ((2, 2, 2, 32, 8, 2), torch.float32, [0, 9]),
    ((3, 8, 2, 128, 64, 4), torch.float32, [1, 130, 256]),
    ((2, 32, 2, 128, 16, 3), torch.float32, [0, 40]),          # G = 16
    ((2, 8, 2, 64, 16, 4), torch.bfloat16, [17, 64]),
    ((2, 32, 8, 128, 16, 4), torch.bfloat16, [64, 33]),       # qwen3 heads
    ((1, 32, 1, 64, 8, 2), torch.bfloat16, [13]),     # G = 32: two groups
    ((1, 10, 2, 32, 8, 3), torch.float32, [20]),      # G = 5
    ((1, 4, 2, 256, 8, 2), torch.bfloat16, [11]),     # two slices a lane
    ((1, 2, 1, 512, 4, 3), torch.float32, [9]),       # four slices a lane
]


@pytest.mark.parametrize("splits", [1, 2, "P"])
@pytest.mark.parametrize("shape,dtype,lens", CASES,
                         ids=[f"{c[0]}-{str(c[1])[6:]}" for c in CASES])
def test_kernel_source_equals_plain_version(launch, shape, dtype, lens,
                                            splits):
    P = shape[5]
    pl = check(launch, shape, dtype, lens, P if splits == "P" else splits)
    assert pl.splits == min(P if splits == "P" else splits, P)


@pytest.mark.parametrize("where", ["zero", "one", "mid_page",
                                   "page_boundary", "full"])
def test_kernel_source_edge_lengths_over_every_split(launch, where):
    """Every sequence's length in one place, with one range per page, so
    that most ranges lie wholly past the length (or, at 0, none does)."""
    B, H, Hkv, D, page, P = 3, 4, 2, 32, 8, 4
    lens = {"zero": [0, 0, 0], "one": [1, 1, 1], "mid_page": [5, 13, 27],
            "page_boundary": [8, 16, 24], "full": [32, 32, 32]}[where]
    for dtype in (torch.float32, torch.bfloat16):
        check(launch, (B, H, Hkv, D, page, P), dtype, lens, splits=P)


def test_kernel_source_with_the_planned_split(launch):
    """The plan the wrapper would make on a 132-SM card, at the serving
    shape's head layout (B 4, Hkv 8): 8 ranges of one page, 8 warps a
    CTA."""
    pl = check(launch, (4, 32, 8, 128, 8, 8), torch.bfloat16,
               [1, 20, 64, 0])
    assert pl.splits == 8 and pl.pages_per_split == 1 and pl.warps == 8


@pytest.mark.parametrize("warps", [4, 8])
def test_kernel_source_with_either_warp_count(launch, warps):
    """Both CTA sizes the plan picks, on the same inputs, one range each
    sequence and one per page."""
    for splits in (1, 4):
        args = inputs(2, 8, 2, 32, 16, 4, torch.float32, [40, 64], 5)
        q, kp, vp, bt, lens, padded = args
        B, H, D = q.shape
        NP, page, Hkv, _ = kp.shape
        P = bt.shape[1]
        pl = PA.plan(B, H, Hkv, D, page, P, 4, 132)._replace(
            warps=warps, splits=splits, pages_per_split=P // splits)
        slots = B * Hkv * pl.groups
        part = torch.full((slots * splits * pl.gc * (D + 2),), math.nan)
        counters = torch.zeros((slots,), dtype=torch.int32)
        out = torch.full_like(q, math.nan)
        assert launch(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                      padded.data_ptr(), lens.data_ptr(), out.data_ptr(),
                      part.data_ptr(), counters.data_ptr(), B, H, Hkv, D,
                      page, P, 0, pl.gc, splits, pl.pages_per_split,
                      pl.rows, warps, None) == 0
        assert not counters.any()
        want = paged_attention_ref(q, kp, vp, bt, lens)
        assert torch.allclose(out, want, rtol=1e-5, atol=1e-5)
