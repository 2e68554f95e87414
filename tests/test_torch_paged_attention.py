"""The port's paged decode attention against the JAX package: its plain
version against ``paged_attention_ref`` and the Pallas kernel in
interpret mode, over the sweep of ``tests/test_kernels.py:50-65`` (B,
H, Hkv, D, page, P) in float32 and bfloat16, with lengths of 1, mid-page,
a page boundary, ``P * page`` and 0 (every slot masked: the mean of V).
Tolerances are those of ``tests/test_kernels.py``: 3e-3 in float32 and
2e-2 in bfloat16, where both sides round the output once to bfloat16 but
sum in another order.  Under a sliding window (``WINDOW_CASES``) the plain
version is held against the reference's windowed decode attention, its
``_online_attn`` over the ring's positions.  The CUDA kernel is held
against this plain version on the card (``chip_smoke.py``,
``tests/test_torch_gpu.py``)."""
import math

import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.paged_attention.paged_attention import paged_attention
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import paged_attention as PA

TOL = {"float32": 3e-3, "bfloat16": 2e-2}

#: (B, H, Hkv, D, page, P) and dtype: points of the sampled space of
#: test_kernels.py, and one of the serving shape's family (page 64, GQA
#: groups of 4); each new shape costs the Pallas interpreter a compile
CASES = [
    ((1, 2, 1, 16, 8, 1), "float32"), ((2, 4, 2, 32, 16, 3), "float32"),
    ((1, 4, 2, 16, 8, 4), "float32"), ((2, 2, 2, 32, 8, 2), "bfloat16"),
    ((3, 8, 2, 32, 64, 2), "bfloat16"),
]


def _inputs(B, H, Hkv, D, page, P, dtype, lens):
    rng = np.random.default_rng(B * 131 + H * 7 + P)
    NP = B * P + 1
    arr = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}[dtype]
    q = rng.standard_normal((B, H, D)).astype(arr)
    kp = rng.standard_normal((NP, page, Hkv, D)).astype(arr)
    vp = rng.standard_normal((NP, page, Hkv, D)).astype(arr)
    bt = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, P * page + 1, (B,))
    return q, kp, vp, bt, np.resize(np.asarray(lens, np.int32), B)


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _check(shape, dtype, lens):
    args = _inputs(*shape, dtype, lens)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(paged_attention_ref(*jargs), np.float32)
    pallas = np.asarray(paged_attention(*jargs, interpret=True), np.float32)
    got = ops.paged_decode(*(_torch(a) for a in args))
    assert got.dtype == {"float32": torch.float32,
                         "bfloat16": torch.bfloat16}[dtype]
    assert got.shape == args[0].shape
    got = got.float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,dtype", CASES)
def test_random_lengths(shape, dtype):
    _check(shape, dtype, None)


@pytest.mark.parametrize("where", ["one", "mid_page", "page_boundary",
                                   "full", "zero"])
def test_edge_lengths(where):
    B, H, Hkv, D, page, P = 3, 4, 2, 16, 16, 3
    lens = {"one": [1], "mid_page": [7, 23, 40], "page_boundary": [16, 32, 17],
            "full": [P * page], "zero": [0, 5, 0]}[where]
    for dtype in ("float32", "bfloat16"):
        _check((B, H, Hkv, D, page, P), dtype, lens)


def test_zero_length_is_the_mean_of_v():
    """The reference masks every slot of a length-0 sequence with -1e30,
    and its softmax over equal scores is uniform."""
    q, kp, vp, bt, _ = _inputs(1, 2, 1, 16, 8, 2, "float32", None)
    got = ops.paged_decode(*(_torch(a) for a in (q, kp, vp, bt)),
                           torch.zeros((1,), dtype=torch.int32))
    mean_v = vp[bt[0]].reshape(-1, 1, 16).mean(axis=0)
    np.testing.assert_allclose(got[0].numpy(), np.repeat(mean_v, 2, 0),
                               rtol=1e-5, atol=1e-6)


def test_impl_and_device_selection():
    args = [_torch(a) for a in _inputs(1, 2, 1, 16, 8, 1, "float32", [3])]
    with pytest.raises(ValueError, match="impl"):
        ops.paged_decode(*args, impl="pallas")
    before = PA.paged_attention.launches
    ops.paged_decode(*args)                  # CPU: the plain version
    assert PA.paged_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        PA.paged_attention(*args)


def split_decode(q, kpool, vpool, block_table, seq_lens, splits):
    """The CUDA kernel's decomposition in plain torch: the page axis cut
    into ``splits`` contiguous ranges (as ``paged_attention.plan`` cuts
    it), a partial softmax ``(m, l, acc)`` per range over the rows below
    the length (none for a range wholly past it: ``m = -inf``, ``l = 0``),
    then the rescaled sum of the partials.  It reads no table entry at or
    past ``ceil(len / page)``; a length of 0 scores every slot 0."""
    B, H, D = q.shape
    NP, page, Hkv, _ = kpool.shape
    P = block_table.shape[1]
    G = H // Hkv
    pps = -(-P // splits)
    splits = -(-P // pps)
    out = torch.empty((B, H, D))
    for b in range(B):
        n = int(seq_lens[b])
        n_valid = P * page if n <= 0 else min(n, P * page)
        qg = q[b].reshape(Hkv, G, D).float()
        parts = []
        for s in range(splits):
            r0, r1 = s * pps * page, min((s + 1) * pps * page, n_valid)
            if r0 >= r1:
                parts.append((torch.full((Hkv, G), -math.inf),
                              torch.zeros((Hkv, G)), None))
                continue
            rows = torch.arange(r0, r1)
            ids = block_table[b, rows // page].long()
            k = kpool[ids, rows % page].float()           # (r, Hkv, D)
            v = vpool[ids, rows % page].float()
            sc = torch.einsum("hgd,rhd->hgr", qg, k) / math.sqrt(D)
            if n <= 0:
                sc = torch.zeros_like(sc)
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("hgr,rhd->hgd", p, v)))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum, acc = torch.zeros((Hkv, G)), torch.zeros((Hkv, G, D))
        for m, l_, a in parts:
            if a is None:
                continue
            w = torch.exp(m - mx)
            lsum += w * l_
            acc += w[..., None] * a
        out[b] = (acc / lsum[..., None]).reshape(H, D)
    return out.to(q.dtype)


def _check_split(shape, dtype, lens, splits):
    args = _inputs(*shape, dtype, lens)
    q, kp, vp, bt, lens = (_torch(a) for a in args)
    P, page = shape[5], shape[4]
    padded = bt.clone()                  # ids no pool has past the length
    for b, n in enumerate(lens.tolist()):
        if n > 0:
            padded[b, -(-n // page):] = 10 ** 6
    got = split_decode(q, kp, vp, padded, lens, P if splits == "P" else
                       splits).float().numpy()
    jargs = [jnp.asarray(a) for a in args]
    tol = TOL[dtype]
    np.testing.assert_allclose(
        got, ops.paged_decode(q, kp, vp, bt, lens).float().numpy(),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(
        got, np.asarray(paged_attention_ref(*jargs), np.float32),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(
        got, np.asarray(paged_attention(*jargs, interpret=True), np.float32),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("splits", [1, 2, "P"])
@pytest.mark.parametrize("shape,dtype", CASES)
def test_split_decomposition_random_lengths(shape, dtype, splits):
    _check_split(shape, dtype, None, splits)


@pytest.mark.parametrize("splits", [1, 2, "P"])
@pytest.mark.parametrize("where", ["zero", "one", "mid_page",
                                   "page_boundary", "full"])
def test_split_decomposition_edge_lengths(where, splits):
    """With one range per page most ranges lie wholly past a short
    length; at 0 every range holds a part of the uniform mean."""
    B, H, Hkv, D, page, P = 3, 4, 2, 16, 16, 3
    lens = {"one": [1], "mid_page": [7, 23, 40], "page_boundary": [16, 32, 17],
            "full": [P * page], "zero": [0, 5, 0]}[where]
    for dtype in ("float32", "bfloat16"):
        _check_split((B, H, Hkv, D, page, P), dtype, lens, splits)


#: (B, H, Hkv, D, page, P, element size) of the registry's decode shapes
#: and the test sweeps, for the plan's invariants
PLAN_SHAPES = [(4, 32, 8, 128, 64, 8, 2), (4, 32, 8, 128, 64, 512, 2),
               (1, 2, 1, 16, 8, 1, 4), (2, 4, 2, 32, 16, 4, 4),
               (2, 32, 2, 128, 64, 3, 4), (8, 64, 8, 128, 16, 64, 2),
               (4, 24, 24, 64, 64, 16, 2), (4, 56, 8, 128, 64, 33, 2),
               (4, 40, 8, 128, 64, 7, 2), (4, 4, 4, 256, 16, 16, 2),
               (1, 128, 8, 128, 64, 2, 2), (2, 2, 1, 512, 4, 5, 4),
               (64, 32, 8, 128, 64, 16, 2)]


@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_split_plan_invariants(shape, sm_count):
    """The plan cuts every page into exactly one range (no range past
    the last page), covers every query head once, keeps a lane's query
    registers at 64 f32 and the rings within their budget, and gives a
    short range twice the warps."""
    B, H, Hkv, D, page, P, esize = shape
    pl = PA.plan(B, H, Hkv, D, page, P, esize, sm_count)
    assert 1 <= pl.splits <= min(P, PA.MAX_SPLITS)
    assert (pl.splits - 1) * pl.pages_per_split < P <= \
        pl.splits * pl.pages_per_split
    G = H // Hkv
    assert pl.groups * pl.gc >= G > (pl.groups - 1) * pl.gc
    assert pl.gc * 4 * -(-D // 128) <= 64
    assert 1 <= pl.rows <= 16
    assert pl.rows == 1 or PA.WARPS * PA.STAGES * 2 * pl.rows * D * esize \
        <= PA.RING_BYTES
    short = -(-pl.pages_per_split * page // pl.rows) <= PA.SHORT_CHUNKS
    assert pl.warps == (PA.SHORT_WARPS if short else PA.WARPS)


def test_split_plan_reads_no_lengths_and_spreads_a_full_table():
    """The plan takes shapes only (the lengths live on the device and are
    never read on the host); at the serving shape on a 132-SM H100 it
    gives one page per range, and at 32 768 tokens (P 512) about two waves
    of four CTAs per SM."""
    import inspect
    assert list(inspect.signature(PA.plan).parameters) == \
        ["B", "H", "Hkv", "D", "page", "P", "esize", "sm_count"]
    assert PA.plan(4, 32, 8, 128, 64, 8, 2, 132) == PA.Plan(
        gc=4, groups=1, splits=8, pages_per_split=1, rows=8, warps=8)
    pl = PA.plan(4, 32, 8, 128, 64, 512, 2, 132)
    assert (pl.splits, pl.pages_per_split, pl.warps) == (32, 16, 4)
    assert 7 * 132 <= 4 * 8 * pl.splits <= 8 * 132


def test_workspace_is_kept_until_it_grows():
    """The wrapper skips its checks while the workspace it planned on is
    the device's (an identity test), so the workspace is one object until
    a larger shape grows it, and a grown one keeps the larger sizes and
    fresh zero counters."""
    dev = torch.device("cpu")
    PA._workspace.pop(dev.index, None)
    try:
        ws = PA.workspace(dev, 100, 8)
        assert PA.workspace(dev, 50, 4) is ws
        assert PA.workspace(dev, 100, 8) is ws
        grown = PA.workspace(dev, 10, 16)
        assert grown is not ws and PA.workspace(dev, 100, 16) is grown
        assert grown[0].numel() == 100 and grown[1].numel() == 16
        assert not grown[1].any()
    finally:
        PA._workspace.pop(dev.index, None)


# -- a sliding window over a ring ------------------------------------------
def _ring_reference(q, kp, vp, bt, lens, window):
    """The reference's windowed decode attention on the same inputs:
    ``decode_step``'s ring positions (``repro/models/core.py:675-683``,
    ``s`` the length before the new token) through its ``_online_attn``."""
    from repro.models.core import _online_attn
    B, H, D = q.shape
    _, page, Hkv, _ = kp.shape
    P = bt.shape[1]
    kv = P * page
    s = jnp.asarray(lens, jnp.int32) - 1
    kv_pos = s[:, None] - (s[:, None] % kv - jnp.arange(kv)[None]) % kv
    kg = jnp.asarray(kp)[jnp.asarray(bt)].reshape(B, kv, Hkv, D)
    vg = jnp.asarray(vp)[jnp.asarray(bt)].reshape(B, kv, Hkv, D)
    qg = jnp.asarray(q).reshape(B, 1, Hkv, H // Hkv, D)
    o = _online_attn(qg, kg, vg, s[:, None], kv_pos, window)
    return np.asarray(o.reshape(B, H, D), np.float32)


#: (B, H, Hkv, D, page, P), dtype, lengths, window: a window past the ring
#: (every slot attended), rings wrapped with the masked span across a page
#: boundary and over whole pages, lengths below the window
WINDOW_CASES = [
    ((2, 4, 2, 16, 8, 4), "float32", [1, 30], 64),
    ((3, 8, 2, 32, 8, 4), "float32", [40, 45, 70], 20),
    ((3, 8, 2, 32, 8, 4), "float32", [33, 64, 97], 10),
    ((1, 4, 2, 32, 8, 3), "float32", [5], 16),
    ((2, 8, 2, 32, 16, 4), "bfloat16", [65, 100], 50),
]


@pytest.mark.parametrize("shape,dtype,lens,window", WINDOW_CASES)
def test_window_ring_matches_the_reference(shape, dtype, lens, window):
    """The plain version with ``window`` equals the reference's windowed
    decode attention over the same ring, within ``TOL``."""
    args = _inputs(*shape, dtype, lens)
    got = ops.paged_decode(*(_torch(a) for a in args), window=window)
    want = _ring_reference(*args, window)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_window_attends_unwritten_slots_as_the_reference_does():
    """The recorded reference fault: under a window of the ring or more,
    a one-token sequence attends to every slot of its ring, written or
    not, so its output is its one value averaged with the zeros of the
    other slots — in both packages — where full attention returns the
    value itself."""
    B, H, Hkv, D, page, P = 1, 4, 2, 16, 8, 4
    q, kp, vp, bt, _ = _inputs(B, H, Hkv, D, page, P, "float32", [1])
    kp[:], vp[:] = 0, 0
    kp[bt[0, 0], 0], vp[bt[0, 0], 0] = 1, 1          # slot 0 written only
    lens = np.asarray([1], np.int32)
    full = ops.paged_decode(*(_torch(a) for a in (q, kp, vp, bt, lens)))
    ring = ops.paged_decode(*(_torch(a) for a in (q, kp, vp, bt, lens)),
                            window=8192)
    np.testing.assert_allclose(full.numpy(), 1.0, rtol=1e-6)
    kv = P * page
    # slot 0 scores q.k / sqrt(D) against 0 for the others
    s0 = q.reshape(H, D).sum(-1) / math.sqrt(D)
    want = np.exp(s0) / (np.exp(s0) + kv - 1)
    np.testing.assert_allclose(ring[0].numpy(), np.repeat(want[:, None], D,
                                                          1), rtol=1e-5)
    np.testing.assert_allclose(ring.numpy(), _ring_reference(
        q, kp, vp, bt, lens, 8192), rtol=1e-5)
