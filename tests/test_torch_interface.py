"""``TorchTarget`` behind the ``Target`` protocol: the batched accessors
are value-identical to the per-element ones (and to ``JaxTarget``), and a
transaction's read->write->read sees the staged value.  Tolerance 0."""
import numpy as np
import pytest

from repro.core.interface import JaxTarget
from repro_torch.core.channel import UartChannel
from repro_torch.core.interface import Target, TorchTarget
from repro_torch.core.session import HtpSession, HtpTransaction

from test_session import _staleness_ops

M64 = (1 << 64) - 1
CSRS = ["pc", "priv", "pending", "stall_until", "satp", "mcause", "mepc",
        "mtval", "res", "uticks", "instret", "ticks"]


def _seed(t, rng):
    """Fill a target through the per-element accessors."""
    nc = t.n_cores
    for c in range(nc):
        for r in range(1, 32):
            t.reg_write(c, r, int(rng.randint(0, 1 << 63)) * 2 + (r & 1))
        for name in ("mcause", "mepc", "mtval", "satp", "stall_until",
                     "uticks", "instret", "res"):
            t.csr_write(c, name, int(rng.randint(0, 1 << 63)) * 2 + 1)
        t.csr_write(c, "priv", (0, 1, 3)[c % 3])
        t.csr_write(c, "pending", c & 1)
        t.csr_write(c, "pc", 0x10000 + 4 * c)
    t.csr_write(0, "ticks", 123_456_789_012)
    for pa in range(0x8000, 0x8100, 8):
        t.mem_write_word(pa, int(rng.randint(0, 1 << 63)) * 2 + 1)


def test_protocol_surface_is_complete():
    t = TorchTarget(1, 1 << 20, device="cpu")
    for name in dir(Target):
        if not name.startswith("_") and name != "n_cores":
            assert callable(getattr(t, name)), name
    assert t.n_cores == 1 and t.mem_bytes == 1 << 20


def test_fetch_batch_equals_per_element_accessors_and_jax():
    tt = TorchTarget(3, 1 << 20, device="cpu")
    jt = JaxTarget(3, 1 << 20)
    _seed(tt, np.random.RandomState(3))
    _seed(jt, np.random.RandomState(3))
    rng = np.random.RandomState(4)
    regs = [(int(rng.randint(3)), int(rng.randint(32))) for _ in range(40)]
    csrs = [(int(rng.randint(3)), CSRS[rng.randint(len(CSRS))])
            for _ in range(40)]
    words = [0x8000 + 8 * int(rng.randint(32)) for _ in range(20)]
    rv, cv, wv = tt.fetch_batch(regs, csrs, words)
    assert rv == [tt.reg_read(c, i) for c, i in regs]
    assert cv == [tt.csr_read(c, n) for c, n in csrs]
    assert wv == [tt.mem_read_word(pa) for pa in words]
    jr, jc, jw = jt.fetch_batch(regs, csrs, words)
    assert (rv, cv, wv) == (jr, jc, jw)
    assert all(isinstance(v, int) and 0 <= v <= M64 for v in rv + cv + wv)
    assert tt.fetch_batch() == ([], [], [])
    # one kind at a time, and ticks alone
    assert tt.fetch_batch(csrs=[(2, "ticks")])[1] == [123_456_789_012]
    assert tt.get_ticks() == 123_456_789_012
    assert tt.fetch_batch(words=words[:1])[2] == wv[:1]


def test_commit_batch_equals_per_element_writes_and_jax():
    rng = np.random.RandomState(9)
    regs = {(int(rng.randint(2)), int(rng.randint(1, 32))):
            int(rng.randint(0, 1 << 63)) * 2 + 1 for _ in range(30)}
    csrs = {(int(rng.randint(2)), n): int(rng.randint(0, 1 << 63)) * 2 + 1
            for n in ("mepc", "mtval", "mcause", "satp", "stall_until",
                      "pc") for _ in range(2)}
    csrs[(0, "priv")] = 1
    csrs[(1, "priv")] = 3
    csrs[(0, "pending")] = 1
    csrs[(1, "pending")] = 0
    words = {(0x9000 >> 3) + int(rng.randint(64)):
             int(rng.randint(0, 1 << 63)) * 2 + 1 for _ in range(30)}
    a = TorchTarget(2, 1 << 20, device="cpu")       # batched
    b = TorchTarget(2, 1 << 20, device="cpu")       # element by element
    j = JaxTarget(2, 1 << 20)
    for t in (a, j):
        t.commit_batch(regs=[(c, i, v) for (c, i), v in regs.items()],
                       csrs=[(c, n, v) for (c, n), v in csrs.items()],
                       words=list(words.items()))
    for (c, i), v in regs.items():
        b.reg_write(c, i, v)
    for (c, n), v in csrs.items():
        b.csr_write(c, n, v)
    for w, v in words.items():
        b.mem_write_word(w << 3, v)
    a.commit_batch()                                 # empty: a no-op
    q = dict(regs=[(c, r) for c in range(2) for r in range(32)],
             csrs=[(c, n) for c in range(2) for n in CSRS],
             words=[w << 3 for w in words])
    assert a.fetch_batch(**q) == b.fetch_batch(**q) == j.fetch_batch(**q)
    assert a.pending_cores() == [0]
    assert a.get_priv(1) == 3


def test_page_accessors_match_jax_and_do_not_alias():
    tt = TorchTarget(1, 1 << 20, device="cpu")
    jt = JaxTarget(1, 1 << 20)
    rng = np.random.RandomState(2)
    page = (rng.randint(0, 1 << 62, 512).astype(np.uint64) << np.uint64(2)) \
        | np.uint64(3)
    for t in (tt, jt):
        t.page_write(5, page)
        t.page_copy(5, 9)
        t.page_set(6, M64 - 1)
        t.mem_write_word(9 * 4096 + 16, 77)
    for ppn in (5, 6, 9, 10):
        got = tt.page_read(ppn)
        assert got.dtype == np.uint64 and got.shape == (512,)
        np.testing.assert_array_equal(got, np.asarray(jt.page_read(ppn)))
    got = tt.page_read(5)
    tt.page_set(5, 0)                    # a later write must not reach it
    np.testing.assert_array_equal(got, page)
    assert tt.mem_read_word(9 * 4096 + 16) == 77
    assert tt.mem_read_word(6 * 4096 + 8) == M64 - 1


def test_redirect_park_and_x0():
    t = TorchTarget(2, 1 << 20, device="cpu")
    t.redirect(1, 0x10000, resume_tick=-5)
    assert t.fetch_batch(csrs=[(1, "pc"), (1, "priv"), (1, "stall_until"),
                               (0, "priv")])[1] == [0x10000, 0, 0, 3]
    t.reg_write(1, 0, 99)
    assert t.reg_read(1, 0) == 0
    t.csr_write(1, "pending", 1)
    assert t.pending_cores() == [1]
    t.clear_pending(1)
    t.park(1)
    assert t.pending_cores() == [] and t.get_priv(1) == 3
    t.set_satp(0, (8 << 60) | 2)
    assert t.csr_read(0, "satp") == (8 << 60) | 2
    t.sfence(0)


def _run_staleness(ops, t):
    regs_pool = sorted({op[1] for op in ops if op[0] in ("rr", "rw")})
    csr_pool = sorted({op[1] for op in ops if op[0] in ("cr", "cw")})
    mem_pool = sorted({op[1] for op in ops if op[0] in ("mr", "mw")})
    sess = HtpSession(t, UartChannel())
    txn = HtpTransaction()
    regs = {r: 0 for r in regs_pool}
    csrs = {n: 0 for n in csr_pool}
    mem = {a: 0 for a in mem_pool}
    expect = {}
    for op in ops:
        i, k = len(txn), op[0]
        if k == "rw":
            txn.reg_write(0, op[1], op[2])
            if op[1]:
                regs[op[1]] = op[2] & M64
        elif k == "rr":
            txn.reg_read(0, op[1])
            expect[i] = regs[op[1]]
        elif k == "cw":
            txn.csr_write(0, op[1], op[2])
            csrs[op[1]] = op[2] & M64
        elif k == "cr":
            txn.csr_read(0, op[1])
            expect[i] = csrs[op[1]]
        elif k == "mw":
            txn.mem_write(0, op[1], op[2])
            mem[op[1]] = op[2] & M64
        else:
            txn.mem_read(0, op[1])
            expect[i] = mem[op[1]]
    res = sess.submit(txn, 0)
    for i, want in expect.items():
        assert int(res.values[i]) & M64 == want, (i, ops)
    for r, v in regs.items():
        assert t.reg_read(0, r) == v, r
    for n, v in csrs.items():
        assert t.csr_read(0, n) == v, n
    for a, v in mem.items():
        assert t.mem_read_word(a) == v, hex(a)


@pytest.mark.parametrize("seed", range(6))
def test_torch_write_batch_staleness_property(seed):
    """A read of a reg/CSR/word written EARLIER IN THE SAME transaction
    must observe the staged value, with the final device state matching
    a plain sequential model (the JAX package's read->write->read
    interleavings, through the port's own session copy)."""
    _run_staleness(_staleness_ops(seed), TorchTarget(1, 1 << 20,
                                                     device="cpu"))
