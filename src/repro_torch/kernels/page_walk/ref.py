"""Plain PyTorch version of the Sv39 page-walk + fetch-block gather chain.

Lane-vectorized: every input is an ``(L,)`` lane vector (one lane per
core), every PTE load is one gather across all lanes, and the walk also
reports *which* memory words it read — the interpreter folds those into
its same-tick store-conflict read set.  :func:`walk_fetch_block_ref` is
the plain version of the CUDA kernel in ``csrc/page_walk.cu`` (the CPU
tests run it, and the on-card check holds the kernel against it); the
data-side walks :func:`sv39_walk_ref` / :func:`sv39_walk_leaf` have no
kernel and are used as they are on every device.

All u64 quantities (memory words, ``satp``, addresses, word indices) are
``torch.int64`` bit patterns (:mod:`repro_torch.core.target.u64`);
:data:`NO_WORD` is ``-1`` in storage.  Semantics: mode-8 ``satp`` selects
the three-level Sv39 walk (leaves allowed at any level, U-bit plus R/W/X
permission check, fault on invalid or non-permitted), any other mode is
Bare (identity translation under the memory mask).
"""
from __future__ import annotations

import torch

from ...core.target import isa
from ...core.target.u64 import srl

#: :data:`repro_torch.core.consts.NO_WORD` in int64 storage.
NO_WORD = -1

_PPN_MASK = (1 << 44) - 1


def _half(word, addr):
    """The 32-bit half of ``word`` that byte address ``addr`` selects,
    in the low bits (upper bits are whatever the shift left there)."""
    return word >> ((addr & 4) << 3)


def _walk(mem, satp, va, need, mask, base, leaf_meta):
    bare = srl(satp, 60) != 8
    a = (satp & _PPN_MASK) << 12
    done = torch.zeros_like(bare)
    fault = torch.zeros_like(bare)
    pa = torch.zeros_like(va)
    perms = torch.zeros_like(va)
    leaf0 = torch.zeros_like(bare)
    leaf_widx = torch.full_like(va, NO_WORD)
    walk_words = []
    for level in (2, 1, 0):
        idx = srl(va, 12 + 9 * level) & 0x1FF
        widx = srl((a + idx * 8) & mask, 3)
        pte = mem[widx if base is None else base + widx]
        valid = (pte & isa.PTE_V) != 0
        leaf = valid & ((pte & (isa.PTE_R | isa.PTE_X)) != 0)
        perm_ok = (pte & need) == need
        off_mask = (1 << (12 + 9 * level)) - 1
        ppn_addr = srl(pte, 10) << 12
        leaf_pa = (ppn_addr | (va & off_mask)) & mask
        take = ~done
        walk_words.append(torch.where(take & ~bare, widx, NO_WORD))
        taken_leaf = take & leaf & perm_ok
        fault = fault | (take & (~valid | (leaf & ~perm_ok)))
        pa = torch.where(taken_leaf, leaf_pa, pa)
        if leaf_meta:
            perms = torch.where(taken_leaf, pte & 0xFF, perms)
            if level == 0:
                leaf0 = taken_leaf & ~bare
                leaf_widx = torch.where(leaf0, widx, leaf_widx)
        done = done | (take & (~valid | leaf))
        a = torch.where(take & valid & ~leaf, ppn_addr, a)
    fault = (fault | ~done) & ~bare
    pa = torch.where(bare, va, pa) & mask
    return (pa, fault, torch.stack(walk_words, dim=-1), perms, leaf0,
            leaf_widx)


def _need(want_write, want_exec):
    return isa.PTE_U | torch.where(
        want_exec, isa.PTE_X,
        torch.where(want_write, isa.PTE_W, isa.PTE_R))


def sv39_walk_ref(mem, satp, va, want_write, want_exec, mask, base=None):
    """Vectorized Sv39 walk; lanes are independent cores.

    ``mem`` is the ``(mem_bytes // 8,)`` word array; ``satp``/``va``/
    ``want_write``/``want_exec`` are ``(L,)`` lanes; ``mask`` is the
    python int ``mem_bytes - 1``.  Returns ``(pa, fault, walk_words)``
    where ``walk_words`` is ``(L, 3)`` — the word index each level's PTE
    load touched, :data:`NO_WORD` for levels the walk never reached and
    for Bare lanes.

    ``base`` (optional, ``(L,)``) is a per-lane word offset into a larger
    backing buffer (several memory images concatenated, each lane offset
    into its own).  All *returned* word indices (and ``pa``) stay
    image-local; only the loads are offset.
    """
    return _walk(mem, satp, va, _need(want_write, want_exec), mask, base,
                 False)[:3]


def sv39_walk_leaf(mem, satp, va, want_write, want_exec, mask, base=None):
    """:func:`sv39_walk_ref` plus the leaf metadata a translation cache
    needs.  Returns ``(pa, fault, walk_words, perms, leaf0, leaf_widx)``:

      * ``perms``     — the taken leaf PTE's low permission byte, so a
        cached entry can re-check access rights without touching memory;
      * ``leaf0``     — True only for a 4 KiB (level-0) leaf, the only
        granularity the caches fill;
      * ``leaf_widx`` — word index of the backing leaf PTE
        (:data:`NO_WORD` when there is none), which store-overlap
        invalidation matches committed stores against.
    """
    return _walk(mem, satp, va, _need(want_write, want_exec), mask, base,
                 True)


def walk_fetch_block_ref(mem, satp, va, mask, block_words, base=None,
                         active=None):
    """Execute-translate ``va`` and gather a fetch block behind it.

    The block is ``block_words`` consecutive 32-bit instruction slots
    starting at ``va``; slot ``k`` reads word ``((pa + 4k) & mask) >> 3``
    and takes its low or high half.  ``nbytes`` is the per-lane valid
    byte count — clamped to the enclosing 4 KiB page (the walk only
    proves contiguity within one page), 0 on fault.  Returns ``(pa,
    fault, walk_words, insts, nbytes)`` with ``insts`` ``(L,
    block_words)`` ``torch.int32`` holding the u32 slot bit patterns.

    ``active`` (optional ``(L,)`` bool) masks lanes out: an inactive lane
    returns ``pa = 0``, ``fault = False``, ``walk_words = NO_WORD``,
    ``insts = 0``, ``nbytes = 0`` — what a caller that skips the walk
    when no lane needs it would have substituted.
    """
    need = isa.PTE_U | isa.PTE_X
    pa, fault, walk_words = _walk(mem, satp, va, need, mask, base, False)[:3]
    remain = 0x1000 - (va & 0xFFF)
    nbytes = torch.where(fault, 0, remain.clamp(max=4 * block_words))
    offs = torch.arange(block_words, dtype=torch.int64,
                        device=va.device) * 4
    addr = pa[..., None] + offs
    widx = srl(addr & mask, 3)
    word = mem[widx if base is None else base[..., None] + widx]
    insts = (_half(word, addr) & 0xFFFFFFFF).to(torch.int32)
    if active is not None:
        pa = torch.where(active, pa, 0)
        fault = fault & active
        walk_words = torch.where(active[..., None], walk_words, NO_WORD)
        insts = torch.where(active[..., None], insts, 0)
        nbytes = torch.where(active, nbytes, 0)
    return pa, fault, walk_words, insts, nbytes
