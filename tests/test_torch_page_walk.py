"""The port's plain page-walk chain against the JAX package's oracle and
its Pallas kernel (interpret mode), on the same numpy image.  All
outputs are integers; tolerance 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.target import isa
from repro.kernels.page_walk import page_walk as JK
from repro.kernels.page_walk import ref as JR
from repro_torch.kernels.page_walk import ops as TO
from repro_torch.kernels.page_walk import page_walk as TK
from repro_torch.kernels.page_walk import ref as TR

MEM_BYTES = 1 << 20
MASK = MEM_BYTES - 1
FLAGS = (isa.PTE_V | isa.PTE_R | isa.PTE_W | isa.PTE_X | isa.PTE_U |
         isa.PTE_A | isa.PTE_D)
ROOT, L1, L0 = 2, 3, 4
SATP = (8 << 60) | ROOT

#: the six vaddrs of tests/test_kernels.py: 4 KiB leaf mid-page, block
#: clamped at the page end, 2 MiB superpage, no-U fault, invalid leaf,
#: far outside the table
VAS = [16 * 4096 + 8, 40 * 4096 + 4092, 0x200000 + 0x1234 * 4, 65 * 4096,
       66 * 4096, 0x7000_0000]


def build_walk_image(mem_bytes=MEM_BYTES, word_off=0, total_words=None):
    """3-level Sv39 table: 4K leaves for vpn 16..64 (vpn 50 read-only,
    vpn 51 without X), a non-U leaf at vpn 65, nothing at 66+, a 2 MiB
    superpage at vpn1=1, and recognisable words everywhere else."""
    n = mem_bytes // 8
    mem = np.zeros(n, np.uint64)
    mem[(ROOT * 4096) // 8] = (L1 << 10) | isa.PTE_V
    mem[(L1 * 4096) // 8] = (L0 << 10) | isa.PTE_V
    mem[(L1 * 4096) // 8 + 1] = (0x80 << 10) | FLAGS
    for vpn0 in range(16, 65):
        mem[(L0 * 4096) // 8 + vpn0] = (vpn0 << 10) | FLAGS
    mem[(L0 * 4096) // 8 + 50] = (50 << 10) | (FLAGS & ~isa.PTE_W)
    mem[(L0 * 4096) // 8 + 51] = (51 << 10) | (FLAGS & ~isa.PTE_X)
    mem[(L0 * 4096) // 8 + 65] = (65 << 10) | (FLAGS & ~isa.PTE_U)
    code = np.arange(n, dtype=np.uint64)
    code = (code << np.uint64(32)) | (code * np.uint64(2654435761) &
                                      np.uint64(0xFFFFFFFF))
    mem[4096 // 8 * 16:] = code[4096 // 8 * 16:]
    if total_words is None:
        return mem
    big = np.full(total_words, 0xDEAD_BEEF_0BAD_F00D, np.uint64)
    big[word_off:word_off + n] = mem
    return big


def t64(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def as_u64(t):
    return t.numpy().view(np.uint64)


def _cmp_fetch(jax_out, torch_out):
    names = ("pa", "fault", "walk_words", "insts", "nbytes")
    for name, j, t in zip(names, jax_out, torch_out):
        j = np.asarray(j)
        t = t.numpy()
        if name == "fault":
            assert t.dtype == np.bool_
        elif name == "insts":
            assert t.dtype == np.int32
            t = t.view(np.uint32)
        else:
            t = t.view(np.uint64)
        np.testing.assert_array_equal(j, t, err_msg=name)


@pytest.mark.parametrize("block_words", [8, 16])
def test_walk_fetch_block_matches_jax_ref_and_pallas(block_words):
    mem = build_walk_image()
    satp = np.full(len(VAS), SATP, np.uint64)
    va = np.asarray(VAS, np.uint64)
    jref = JR.walk_fetch_block_ref(jnp.asarray(mem), jnp.asarray(satp),
                                   jnp.asarray(va), jnp.uint64(MASK),
                                   block_words)
    got = TR.walk_fetch_block_ref(t64(mem), t64(satp), t64(va), MASK,
                                  block_words)
    _cmp_fetch(jref, got)                       # every slot, every lane
    # the Pallas kernel (interpret mode) agrees within nbytes
    jk = JK.walk_fetch_block(jnp.asarray(mem), jnp.asarray(satp),
                             jnp.asarray(va), MASK, block_words,
                             interpret=True)
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(np.asarray(jk[i]),
                                      np.asarray(jref[i]))
    tin = got[3].numpy().view(np.uint32)
    for lane in np.nonzero(~got[1].numpy())[0]:
        n = int(got[4][lane]) // 4
        np.testing.assert_array_equal(np.asarray(jk[3])[lane, :n],
                                      tin[lane, :n])
    assert got[1].tolist() == [False, False, False, True, True, True]
    assert int(got[4][1]) == 4                  # clamped at the page end


def test_walk_fetch_block_bare_mode():
    mem = build_walk_image()
    va = np.asarray([0x10000, 0x10002 * 4 + 2], np.uint64)
    satp = np.zeros(2, np.uint64)
    jref = JR.walk_fetch_block_ref(jnp.asarray(mem), jnp.asarray(satp),
                                   jnp.asarray(va), jnp.uint64(MASK), 8)
    got = TR.walk_fetch_block_ref(t64(mem), t64(satp), t64(va), MASK, 8)
    _cmp_fetch(jref, got)
    assert not got[1].any()
    assert (got[2] == TR.NO_WORD).all()


@pytest.mark.parametrize("block_words", [8, 16])
def test_walk_fetch_block_with_base_offsets(block_words):
    """Two images back to back in one buffer, lanes offset into their
    own; returned indices stay image-local."""
    n = MEM_BYTES // 8
    big = np.concatenate([build_walk_image(), build_walk_image()])
    big[n + 4096 // 8 * 16:] ^= np.uint64(0x5555_0000_AAAA_0000)
    vas = VAS + VAS
    base = np.asarray([0] * len(VAS) + [n] * len(VAS), np.uint64)
    satp = np.full(len(vas), SATP, np.uint64)
    satp[3] = 0                                  # one Bare lane
    va = np.asarray(vas, np.uint64)
    jref = JR.walk_fetch_block_ref(jnp.asarray(big), jnp.asarray(satp),
                                   jnp.asarray(va), jnp.uint64(MASK),
                                   block_words, jnp.asarray(base))
    got = TR.walk_fetch_block_ref(t64(big), t64(satp), t64(va), MASK,
                                  block_words, t64(base))
    _cmp_fetch(jref, got)
    # the two images hold different code: the offset really applied
    assert not torch.equal(got[3][0], got[3][len(VAS)])


def test_walk_fetch_block_random_lanes():
    rng = np.random.RandomState(11)
    mem = build_walk_image()
    L = 512
    va = rng.randint(0, 80 * 4096, L).astype(np.uint64)
    va[::7] = (0x200000 + rng.randint(0, 1 << 21, len(va[::7]))) \
        .astype(np.uint64)
    va[::11] |= np.uint64(1) << np.uint64(rng.randint(39, 64))
    satp = np.where(rng.rand(L) < 0.85, np.uint64(SATP),
                    np.uint64(0)).astype(np.uint64)
    jref = JR.walk_fetch_block_ref(jnp.asarray(mem), jnp.asarray(satp),
                                   jnp.asarray(va), jnp.uint64(MASK), 16)
    got = TR.walk_fetch_block_ref(t64(mem), t64(satp), t64(va), MASK, 16)
    _cmp_fetch(jref, got)
    assert 0 < int(got[1].sum()) < L


def test_walk_fetch_block_active_mask():
    mem = t64(build_walk_image())
    satp = t64(np.full(len(VAS), SATP, np.uint64))
    va = t64(np.asarray(VAS, np.uint64))
    active = torch.tensor([True, False, True, True, False, True])
    full = TR.walk_fetch_block_ref(mem, satp, va, MASK, 16)
    got = TR.walk_fetch_block_ref(mem, satp, va, MASK, 16, active=active)
    for f, g in zip(full, got):
        assert torch.equal(f[active], g[active])
    off = ~active
    assert (got[0][off] == 0).all() and not got[1][off].any()
    assert (got[2][off] == TR.NO_WORD).all()
    assert (got[3][off] == 0).all() and (got[4][off] == 0).all()


@pytest.mark.parametrize("want", ["read", "write", "exec"])
@pytest.mark.parametrize("with_base", [False, True])
def test_data_walks_match_jax(want, with_base):
    """``sv39_walk_ref`` and ``sv39_walk_leaf`` (all six outputs) on
    read / write / execute walks: read-only page, no-X page, no-U page,
    superpage, invalid, Bare."""
    n = MEM_BYTES // 8
    off = 3 * n if with_base else 0
    mem = build_walk_image(word_off=off, total_words=4 * n) \
        if with_base else build_walk_image()
    vas = VAS + [50 * 4096 + 16, 51 * 4096 + 24, 0x3000]
    L = len(vas)
    satp = np.full(L, SATP, np.uint64)
    satp[-1] = 0
    va = np.asarray(vas, np.uint64)
    ww = np.full(L, want == "write")
    wx = np.full(L, want == "exec")
    base = np.full(L, off, np.uint64) if with_base else None
    jb = None if base is None else jnp.asarray(base)
    tb = None if base is None else t64(base)
    jl = JR.sv39_walk_leaf(jnp.asarray(mem), jnp.asarray(satp),
                           jnp.asarray(va), jnp.asarray(ww),
                           jnp.asarray(wx), jnp.uint64(MASK), jb)
    tl = TR.sv39_walk_leaf(t64(mem), t64(satp), t64(va),
                           torch.from_numpy(ww), torch.from_numpy(wx),
                           MASK, tb)
    for name, j, t in zip(("pa", "fault", "words", "perms", "leaf0",
                           "leaf_widx"), jl, tl):
        t = t.numpy()
        t = t if t.dtype == np.bool_ else t.view(np.uint64)
        np.testing.assert_array_equal(np.asarray(j), t, err_msg=name)
    jr = JR.sv39_walk_ref(jnp.asarray(mem), jnp.asarray(satp),
                          jnp.asarray(va), jnp.asarray(ww),
                          jnp.asarray(wx), jnp.uint64(MASK), jb)
    tr = TR.sv39_walk_ref(t64(mem), t64(satp), t64(va),
                          torch.from_numpy(ww), torch.from_numpy(wx), MASK,
                          tb)
    for j, t in zip(jr, tr):
        t = t.numpy()
        t = t if t.dtype == np.bool_ else t.view(np.uint64)
        np.testing.assert_array_equal(np.asarray(j), t)
    faults = tl[1].tolist()
    assert faults[6] == (want == "write")       # read-only page
    assert faults[7] == (want == "exec")        # no-X page
    assert not faults[-1]                       # Bare never faults


def test_ops_dispatch_is_by_device_and_name():
    """A CPU image takes the plain version (no launch counted); an
    unknown implementation name is refused; the kernel wrapper itself
    refuses CPU tensors instead of falling back."""
    mem = t64(build_walk_image())
    satp = t64(np.full(2, SATP, np.uint64))
    va = t64(np.asarray(VAS[:2], np.uint64))
    before = TK.walk_fetch_block.launches
    a = TO.walk_fetch_block(mem, satp, va, MASK, 16)
    b = TO.walk_fetch_block(mem, satp, va, MASK, 16, impl="ref")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert TK.walk_fetch_block.launches == before
    with pytest.raises(ValueError):
        TO.walk_fetch_block(mem, satp, va, MASK, 16, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        TK.walk_fetch_block(mem, satp, va, MASK, 16)
