"""The port's paged decode attention against the JAX package: its plain
version against ``paged_attention_ref`` and the Pallas kernel in
interpret mode, over the sweep of ``tests/test_kernels.py:50-65`` (B,
H, Hkv, D, page, P) in float32 and bfloat16, with lengths of 1, mid-page,
a page boundary, ``P * page`` and 0 (every slot masked: the mean of V).
Tolerances are those of ``tests/test_kernels.py``: 3e-3 in float32 and
2e-2 in bfloat16, where both sides round the output once to bfloat16 but
sum in another order.  The CUDA kernel is held against this plain
version on the card (``chip_smoke.py``, ``tests/test_torch_gpu.py``)."""
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
