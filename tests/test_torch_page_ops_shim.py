"""The page operations' CUDA source, ``src/repro_torch/csrc/page_ops.cu``,
compiled for the host with ``g++`` under the emulation of
``tests/cuda_shim`` and called through its C entry points with the
wrappers' arguments, against the plain versions of
``kernels/page_ops/ref.py``: ``page_set`` on one pool and on a tuple of
pools in one launch, ``page_copy`` on its one-grid route and on its staged
route (``page_gather`` into a scratch buffer, the last pair of each
destination marked, the winners scattered), and ``page_gather``; on a
float32 pool and a layered bfloat16 pool, with chained pairs, duplicate
destinations and repeated ids.  Tolerance 0."""
import ctypes
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.page_ops import page_ops as K
from repro_torch.kernels.page_ops import ref as R

import torch_shim


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = torch_shim.build("page_ops", tmp_path_factory.mktemp("shim"))
    return {name: torch_shim.entry(lib, name, args)
            for name, args in K._ARGS.items()}


def _geometry(pool):
    vecs = math.prod(pool.shape[-3:]) * pool.element_size() // 16
    return math.prod(pool.shape[:-4]), pool.shape[-4], vecs


def _pools(seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((8, 16, 2, 32), generator=g),
            torch.randn((3, 2, 9, 4, 2, 16), generator=g)
            .to(torch.bfloat16)]


def _int32(rows):
    return torch.tensor(rows, dtype=torch.int32)


@pytest.mark.parametrize("n_pools", [1, 2])
@pytest.mark.parametrize("ids", [[1, 4], [4, 4, 2], [7]])
def test_page_set_source(lib, ids, n_pools):
    for base in _pools(1):
        group = [base.clone() + i for i in range(n_pools)]
        want = [p.clone() for p in group]
        R.page_set_ref(want, _int32(ids), -2.5)
        layers, np_, vecs = _geometry(base)
        lo, hi = K._pattern(base.dtype, -2.5)
        ptrs = (ctypes.c_void_p * n_pools)(*(p.data_ptr() for p in group))
        a = _int32(ids)
        assert lib["page_set_launch"](ptrs, n_pools, a.data_ptr(), len(ids),
                                      layers, np_, vecs, lo, hi, None) == 0
        for got, w in zip(group, want):
            assert torch.equal(got, w)


PAIRS = [[[0, 3], [5, 7]], [[0, 3], [3, 5]], [[0, 3], [1, 3]],
         [[2, 6], [6, 2], [2, 6]],
         np.random.default_rng(3).integers(0, 8, (40, 2)).tolist()]


@pytest.mark.parametrize("route", ["grid", "staged"])
@pytest.mark.parametrize("pairs", PAIRS, ids=["reference", "chained",
                                              "duplicate_dst", "swap",
                                              "random40"])
def test_page_copy_source(lib, pairs, route):
    for pool in _pools(2):
        want = R.page_copy_ref(pool.clone(), _int32(pairs))
        layers, np_, vecs = _geometry(pool)
        a = _int32(pairs)
        k = len(pairs)
        if route == "grid":
            chunk = min(vecs, K.COPY_CHUNK_VECS,
                        K.COPY_SMEM_BYTES // (16 * k))
            assert lib["page_copy_launch"](pool.data_ptr(), a.data_ptr(), k,
                                           layers, np_, vecs, chunk,
                                           None) == 0
        else:
            src = a[:, 0].contiguous()
            scratch = torch.empty((layers, k, vecs * 16), dtype=torch.uint8)
            assert lib["page_gather_launch"](pool.data_ptr(), src.data_ptr(),
                                             k, layers, np_, vecs,
                                             scratch.data_ptr(), None) == 0
            last = torch.zeros((np_,), dtype=torch.int32)
            assert lib["page_copy_staged_launch"](
                pool.data_ptr(), a.data_ptr(), k, layers, np_, vecs,
                scratch.data_ptr(), last.data_ptr(), None) == 0
        assert torch.equal(pool, want)


def test_page_gather_source(lib):
    for pool in _pools(3):
        table = _int32([5, 0, 5, 7])
        layers, np_, vecs = _geometry(pool)
        out = torch.empty((*pool.shape[:-4], 4, *pool.shape[-3:]),
                          dtype=pool.dtype)
        assert lib["page_gather_launch"](pool.data_ptr(), table.data_ptr(),
                                         4, layers, np_, vecs,
                                         out.data_ptr(), None) == 0
        assert torch.equal(out, R.page_gather_ref(pool, table))
