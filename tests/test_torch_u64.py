"""Unsigned-64-bit helpers of the port (int64 storage) against Python
ints, and the port's ALU against the same model.  Tolerance 0."""
import numpy as np
import pytest
import torch

from repro_torch.core.target import cpu as tcpu
from repro_torch.core.target import u64

M64 = (1 << 64) - 1
EDGE = [0, 1, 2, 3, 31, 32, 63, 64, (1 << 31) - 1, 1 << 31, (1 << 32) - 1,
        1 << 32, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, M64 - 1, M64]


def _vals():
    rng = np.random.RandomState(7)
    rnd = [int(rng.randint(0, 1 << 62)) << 2 | int(rng.randint(4))
           for _ in range(24)]
    rnd += [int(rng.randint(0, 1 << 62)) >> int(rng.randint(62))
            for _ in range(12)]
    return EDGE + rnd


VALS = _vals()
A = [a for a in VALS for _ in VALS]
B = [b for _ in VALS for b in VALS]


def T(xs):
    return torch.tensor([u64.to_signed(x) for x in xs], dtype=torch.int64)


def U(t):
    return [int(v) & M64 for v in t.tolist()]


def S(x, bits=64):
    x &= (1 << bits) - 1
    return x - (1 << bits) if x >> (bits - 1) else x


def test_storage_round_trip():
    for v in VALS:
        assert u64.to_unsigned(u64.to_signed(v)) == v
        assert -(1 << 63) <= u64.to_signed(v) < (1 << 63)


@pytest.mark.parametrize("sh", [0, 1, 12, 31, 32, 60, 63])
def test_srl_constant(sh):
    assert U(u64.srl(T(VALS), sh)) == [v >> sh for v in VALS]


def test_srl_per_element():
    shs = [0, 1, 5, 31, 32, 33, 62, 63]
    a = [v for v in VALS for _ in shs]
    s = [k for _ in VALS for k in shs]
    got = U(u64.srl_v(T(a), torch.tensor(s)))
    assert got == [x >> k for x, k in zip(a, s)]


def test_unsigned_compares_and_min():
    ta, tb = T(A), T(B)
    assert u64.ult(ta, tb).tolist() == [a < b for a, b in zip(A, B)]
    assert u64.uge(ta, tb).tolist() == [a >= b for a, b in zip(A, B)]
    assert u64.ugt(ta, tb).tolist() == [a > b for a, b in zip(A, B)]
    assert U(u64.umin(ta, tb)) == [min(a, b) for a, b in zip(A, B)]
    # python-int operand in storage form
    assert u64.ult(ta, u64.to_signed(M64)).tolist() == [a < M64 for a in A]
    assert int(u64.umin_reduce(T([M64, 5, 1 << 63]))) == 5
    assert int(u64.umin_reduce(T([M64, M64]))) & M64 == M64


def test_sign_extend():
    for bits in (8, 12, 13, 16, 21, 32):
        xs = [v & ((1 << bits) - 1) for v in VALS]
        assert U(u64.sx(T(xs), bits)) == [S(x, bits) & M64 for x in xs]


def test_mulhu():
    assert U(u64.mulhu(T(A), T(B))) == [(a * b) >> 64 for a, b in zip(A, B)]


def _sdiv(a, b, bits=64):
    sa, sb = S(a, bits), S(b, bits)
    if sb == 0:
        return -1, sa
    if sa == -(1 << (bits - 1)) and sb == -1:
        return sa, 0
    q = abs(sa) // abs(sb)
    if (sa < 0) != (sb < 0):
        q = -q
    return q, sa - q * sb


def test_signed_division_riscv_corners():
    q, r = u64.sdiv_parts(T(A), T(B))
    want = [_sdiv(a, b) for a, b in zip(A, B)]
    assert U(q) == [w[0] & M64 for w in want]
    assert U(r) == [w[1] & M64 for w in want]
    # the named corners, explicitly
    q, r = u64.sdiv_parts(T([1 << 63, 7, 1 << 63]), T([M64, 0, 0]))
    assert U(q) == [1 << 63, M64, M64]
    assert U(r) == [0, 7, 1 << 63]


def test_unsigned_division_riscv_corners():
    q, r = u64.udiv_parts(T(A), T(B))
    assert U(q) == [M64 if b == 0 else a // b for a, b in zip(A, B)]
    assert U(r) == [a if b == 0 else a % b for a, b in zip(A, B)]


def _alu64_model(f3, is_sub, is_sra, is_m, a, b):
    sa, sb = S(a), S(b)
    if is_m:
        q, r = _sdiv(a, b)
        return [a * b, (sa * sb) >> 64, (sa * b) >> 64, (a * b) >> 64, q,
                M64 if b == 0 else a // b, r,
                a if b == 0 else a % b][f3] & M64
    sh = b & 63
    return [a - b if is_sub else a + b, a << sh, int(sa < sb), int(a < b),
            a ^ b, (sa >> sh) if is_sra else (a >> sh), a | b,
            a & b][f3] & M64


def _alu32_model(f3, is_sub, is_sra, is_m, a, b):
    a32, b32 = a & 0xFFFFFFFF, b & 0xFFFFFFFF
    sa, sb = S(a32, 32), S(b32, 32)
    sh = b & 31
    if is_m:
        q, r = _sdiv(a32, b32, 32)
        uq = M64 if b32 == 0 else a32 // b32
        ur = a32 if b32 == 0 else a32 % b32
        v = {0: a32 * b32, 4: q, 5: uq, 6: r}.get(f3, ur)
    elif f3 == 0:
        v = a - b if is_sub else a + b
    elif f3 == 1:
        v = a32 << sh
    else:
        v = (sa >> sh) if is_sra else (a32 >> sh)
    return S(v & 0xFFFFFFFF, 32) & M64


@pytest.mark.parametrize("is_m", [False, True])
@pytest.mark.parametrize("f3", range(8))
def test_alu_matches_integer_model(f3, is_m):
    """``_alu64``/``_alu32`` over every operand pair, including shifts by
    0/63, W-form shift amounts >= 32 (only the low five bits count),
    division by zero and ``INT_MIN / -1`` in both widths."""
    ta, tb = T(A), T(B)
    n = len(A)
    f3t = torch.full((n,), f3, dtype=torch.int64)
    for is_sub, is_sra in ((False, False), (True, True)):
        flags = [torch.full((n,), v, dtype=torch.bool)
                 for v in (is_sub and f3 == 0, is_sra and f3 == 5, is_m)]
        got64 = U(tcpu._alu64(f3t, *flags, ta, tb))
        got32 = U(tcpu._alu32(f3t, *flags, ta, tb))
        for i, (a, b) in enumerate(zip(A, B)):
            args = (f3, is_sub and f3 == 0, is_sra and f3 == 5, is_m, a, b)
            assert got64[i] == _alu64_model(*args), (args, "64")
            assert got32[i] == _alu32_model(*args), (args, "32")
