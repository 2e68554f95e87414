"""Unsigned 64-bit semantics over ``torch.int64`` storage.

The target is a 64-bit CPU whose registers, addresses and memory words
are unsigned, but ``torch.uint64`` lacks shifts, add, compares,
floor-division and ``index_put_``.  Every u64 value is therefore held as
its two's-complement ``int64`` bit pattern: add/sub/mul/and/or/xor and
left shifts are sign-agnostic and used directly; the helpers below cover
the operations that are not (logical right shift, ordered compares,
min, high multiply, division).  ``2**64 - 1`` is ``-1`` in storage and
is compare-*equal* only — never ordered with ``<`` directly.
"""
from __future__ import annotations

import torch

M64 = (1 << 64) - 1
INT64_MIN = -(1 << 63)
M32 = 0xFFFFFFFF


def to_signed(v: int) -> int:
    """Python int (any sign) -> the int64 storage value of ``v mod 2**64``."""
    v &= M64
    return v - (1 << 64) if v >> 63 else v


def to_unsigned(v: int) -> int:
    """int64 storage value -> the unsigned Python int it stands for."""
    return v & M64


def srl(a, sh):
    """Logical right shift by a constant ``0 <= sh <= 63``."""
    if sh == 0:
        return a
    return (a >> sh) & ((1 << (64 - sh)) - 1)


def srl_v(a, sh):
    """Logical right shift by a per-element amount in ``[0, 63]``."""
    # arithmetic shift, then clear the sign copies: ~((MIN >> sh) << 1)
    # is all ones for sh = 0 and the low (64 - sh) bits otherwise
    keep = ~((torch.full_like(sh, INT64_MIN) >> sh) << 1)
    return (a >> sh) & keep


def ult(a, b):
    """Unsigned ``a < b`` (either side may be a Python int in storage form)."""
    return _flip(a) < _flip(b)


def uge(a, b):
    return _flip(a) >= _flip(b)


def ugt(a, b):
    return _flip(a) > _flip(b)


def _flip(x):
    if isinstance(x, int):
        return to_signed(x ^ (1 << 63))
    return x ^ INT64_MIN


def umin(a, b):
    return torch.where(ult(a, b), a, b)


def umin_reduce(a):
    """Unsigned minimum over all elements (0-d result)."""
    return (a ^ INT64_MIN).min() ^ INT64_MIN


def sx(v, bits):
    """Sign-extend the low ``bits`` of ``v`` (upper bits must be clear)."""
    m = 1 << (bits - 1)
    return (v ^ m) - m


def mulhu(a, b):
    """High 64 bits of the unsigned 128-bit product."""
    al, ah = a & M32, srl(a, 32)
    bl, bh = b & M32, srl(b, 32)
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    mid = srl(ll, 32) + (lh & M32) + (hl & M32)
    return ah * bh + srl(lh, 32) + srl(hl, 32) + srl(mid, 32)


def _tdiv(a, b):
    return torch.div(a, b, rounding_mode="trunc")


def sdiv_parts(a, b, int_min=INT64_MIN):
    """Signed quotient/remainder with RISC-V semantics: ``x / 0`` gives
    ``(-1, x)`` and ``int_min / -1`` gives ``(int_min, 0)``.  ``int_min``
    is ``-2**31`` for the W forms (operands already sign-extended)."""
    div0 = b == 0
    ovf = (a == int_min) & (b == -1)
    den = torch.where(div0 | ovf, 1, b)
    q = _tdiv(a, den)
    r = a - q * den
    q = torch.where(div0, -1, torch.where(ovf, a, q))
    r = torch.where(div0, a, torch.where(ovf, 0, r))
    return q, r


def udiv_parts(a, b):
    """Unsigned quotient/remainder; ``x / 0`` gives ``(2**64 - 1, x)``."""
    div0 = b == 0
    den = torch.where(div0, 1, b)
    # den >= 2**63 (negative in storage): quotient is 0 or 1.  Otherwise
    # halve the dividend so signed division applies, double the quotient
    # and fix the last bit up (the remainder of that step is < 2 * den).
    big = den < 0
    sden = torch.where(big, 1, den)
    q = _tdiv(srl(a, 1), sden) << 1
    r = a - q * sden
    fix = uge(r, sden)
    q = q + fix
    r = r - torch.where(fix, sden, 0)
    ge = uge(a, den)
    q = torch.where(big, ge.to(torch.int64), q)
    r = torch.where(big, torch.where(ge, a - den, a), r)
    q = torch.where(div0, -1, q)
    r = torch.where(div0, a, r)
    return q, r
