"""The port's snapshot/restore (``repro_torch.core.snapshot``): twin of
``tests/test_snapshot.py``.

A checkpoint captured from a ``TorchTarget(device="cpu")`` (or a board
of a stacked ``FleetTarget``) through the port's sessions restores
bit-identically into the reference package's ``PySim`` and ``JaxTarget``
through the reference's sessions, and the other way round, with the same
wire bytes per category, the same ``PageH`` delta capture and the same
u64-normalised values.  Snapshots of the two packages are compared as
plain data (``_key``): the two ``TargetSnapshot`` classes are distinct
types.  Integer state; tolerance 0."""
import numpy as np
import pytest

from repro.core import snapshot as jsnap
from repro.core.channel import UartChannel as JUart
from repro.core.interface import JaxTarget
from repro.core.session import HtpSession as JSession
from repro.core.target import asm as jasm
from repro.core.target.pysim import PySim
from repro_torch.core import snapshot as snap
from repro_torch.core.channel import OracleChannel, PcieChannel, UartChannel
from repro_torch.core.consts import SNAPSHOT_CORE_FIELDS
from repro_torch.core.cq import AsyncHtpSession
from repro_torch.core.fleet.vmap import FleetTarget
from repro_torch.core.interface import TorchTarget
from repro_torch.core.runtime import FaseRuntime
from repro_torch.core.session import HtpSession, HtpTransaction
from repro_torch.core.target import asm
from repro_torch.core.workloads import build

from test_snapshot import MEM, SRC, _load

M64 = (1 << 64) - 1
ZERO_PAGE = bytes(4096)


def _torch(**kw):
    return TorchTarget(1, MEM, device="cpu", **kw)


def _fresh(make, src=SRC):
    t = make()
    _load(t, (asm if isinstance(t, TorchTarget) else jasm).assemble(src))
    return t


def _is_port(t):
    return isinstance(t, TorchTarget)


def _cap(t, **kw):
    if _is_port(t):
        return snap.capture(HtpSession(t, UartChannel()), at=0, **kw)[0]
    return jsnap.capture(JSession(t, JUart()), at=0, **kw)[0]


def _restore(t, s, **kw):
    if _is_port(t):
        return snap.restore(HtpSession(t, UartChannel()), s, at=0, **kw)
    return jsnap.restore(JSession(t, JUart()), s, at=0, **kw)


def _key(s):
    """A snapshot of either package as plain data: shape, clock, every
    core's registers and fields, and its nonzero effective pages."""
    return (s.n_cores, s.mem_bytes, s.ticks,
            [(c.regs, c.csrs) for c in s.cores],
            {p: d for p, d in s.effective_pages().items() if d != ZERO_PAGE})


MAKERS = {"pysim": lambda: PySim(1, MEM), "jax": lambda: JaxTarget(1, MEM),
          "torch": _torch}


def test_capture_equals_reference_capture_with_the_same_wire_bytes():
    """The same state captured by the port (TorchTarget) and by the
    reference (PySim): equal snapshots, equal done ticks, equal bytes per
    category and requests per op on the link."""
    tt, ps = _fresh(_torch), _fresh(MAKERS["pysim"])
    for t in (tt, ps):
        t.run(max_cycles=200)
    ch, jch = UartChannel(), JUart()
    sess, jsess = HtpSession(tt, ch), JSession(ps, jch)
    s, done = snap.capture(sess, at=0)
    js, jdone = jsnap.capture(jsess, at=0)
    assert _key(s) == _key(js) and done == jdone
    assert s.page_hashes == js.page_hashes
    assert dict(ch.bytes_by_cat) == dict(jch.bytes_by_cat)
    assert ch.total_bytes == jch.total_bytes > 4096 * s.wire_pages()
    assert dict(sess.stats.requests) == dict(jsess.stats.requests)
    for t in (tt, ps):
        t.run(max_cycles=200)
    d, dd = snap.capture(sess, at=done, base=s)
    jd, jdd = jsnap.capture(jsess, at=jdone, base=js)
    assert _key(d) == _key(jd) and dd == jdd
    assert sorted(d.pages) == sorted(jd.pages)
    assert dict(ch.bytes_by_cat) == dict(jch.bytes_by_cat)
    dst, jdst = _torch(), PySim(1, MEM)
    ch2, jch2 = UartChannel(), JUart()
    assert snap.restore(HtpSession(dst, ch2), d, at=0) == \
        jsnap.restore(JSession(jdst, jch2), jd, at=0)
    assert dict(ch2.bytes_by_cat) == dict(jch2.bytes_by_cat)
    assert ch2.bytes_by_cat["sys:restore"] > 0


def test_snapshot_values_are_u64_normalised():
    """The port keeps u64 in int64 storage (the invalid reservation is
    -1 there); the format carries 2**64 - 1."""
    tt = _fresh(_torch)
    tt.run(max_cycles=50)
    assert int(tt.st.res[0]) == -1
    s = _cap(tt)
    res_idx = SNAPSHOT_CORE_FIELDS.index("res")
    assert s.cores[0].csrs[res_idx] == M64
    assert all(0 <= v <= M64 for core in s.cores
               for v in core.regs + core.csrs)
    assert _key(s) == _key(_cap(_fresh_run(MAKERS["pysim"], 50)))


def _fresh_run(make, cycles):
    t = _fresh(make)
    t.run(max_cycles=cycles)
    return t


def test_delta_ships_only_dirty_pages_and_restores_identically():
    tt = _fresh_run(_torch, 200)
    sess = HtpSession(tt, UartChannel())
    base, _ = snap.capture(sess, at=0)
    n_cand = len(base.page_hashes)
    assert base.wire_pages() == n_cand
    tt.run(max_cycles=200)
    reqs0 = dict(sess.stats.requests)
    delta, _ = snap.capture(sess, at=0, base=base)
    assert sess.stats.requests["PageH"] - reqs0.get("PageH", 0) >= n_cand
    assert 0 < delta.wire_pages() < n_cand
    assert delta.parent is base
    full = _cap(tt)
    for dst in (PySim(1, MEM), _torch()):
        _restore(dst, delta)
        assert _key(full) == _key(_cap(dst))


@pytest.mark.parametrize("kw", [dict(block_cache=True),
                                dict(block_cache=False)],
                         ids=["cache", "nocache"])
def test_restore_into_a_target_with_cached_fetch_blocks(kw):
    """Restoring over a target mid-run through cached fetch blocks: the
    next chunk follows the restored image's code (the donor ran another
    program at the same addresses), as PySim does."""
    tt = _fresh(lambda: _torch(**kw))
    tt.run(max_cycles=250)
    donor_src = SRC.replace("addi t2, t2, 3", "addi t2, t2, 9") \
                   .replace("amoadd.d t5, t2, (s0)",
                            "amoxor.d t5, t2, (s0)")
    donor = _fresh(MAKERS["pysim"], donor_src)
    donor.run(max_cycles=123)
    s = _cap(donor)
    ps = PySim(1, MEM)
    for t in (tt, ps):
        _restore(t, s)
    tt.run(max_cycles=300)
    ps.run(max_cycles=300)
    assert _key(_cap(tt)) == _key(_cap(ps))
    for t in (tt, ps):
        while not t.pending_cores():
            t.run(max_cycles=1000)
    assert _key(_cap(tt)) == _key(_cap(ps))
    assert tt.get_instret(0) == ps.get_instret(0)


def test_board_of_a_stacked_fleet_round_trips():
    """A board of a ``FleetTarget`` captures and restores like a plain
    target, and a restore into one board leaves the others as they
    were."""
    ft = FleetTarget(3, 1, MEM, device="cpu")
    v = ft.view(1)
    _load(v, asm.assemble(SRC))
    v.run(max_cycles=250)
    tt = _fresh_run(_torch, 250)
    s = _cap(v)
    assert _key(s) == _key(_cap(tt))
    other = [ft.view(d).get_ticks() for d in (0, 2)]
    ft.view(2).run(max_cycles=10)
    _restore(ft.view(2), s)
    assert _key(_cap(ft.view(2))) == _key(s)
    assert ft.view(0).get_ticks() == other[0]


def test_runtime_unperturbed_by_pause_and_oracle_snapshot():
    """Pausing mid-run (run_slice) and checkpointing through a zero-time
    oracle observer session moves no tick of the run."""
    def runtime():
        rt = FaseRuntime(TorchTarget(1, 1 << 22, device="cpu"),
                         mode="fase", link="uart")
        rt.load(build("hello"), ["hello"])
        return rt
    ref = runtime().run(max_ticks=1 << 40)
    rt = runtime()
    assert rt.run_slice(ref.ticks // 2, max_ticks=1 << 40) is None
    obs = HtpSession(rt.target, OracleChannel())
    s, done = snap.capture(obs, at=rt.target.get_ticks())
    assert done == rt.target.get_ticks()
    assert s.wire_pages() > 0
    rep = rt.run(max_ticks=1 << 40)
    assert (rep.ticks, rep.traffic_total, rep.stdout) == \
        (ref.ticks, ref.traffic_total, ref.stdout)
    assert "sys:snapshot" not in rep.traffic


def test_pcie_session_snapshot_barriers_on_streams():
    tt = _fresh(_torch)
    sess = AsyncHtpSession(tt, PcieChannel())
    txn = HtpTransaction()
    for i in range(1, 32):
        txn.reg_read(0, i, "ctxsw")
    r = sess.submit(txn, 0, stream=0)
    s, done = snap.capture(sess, at=0)
    assert done >= r.done
    assert s.wire_pages() > 0


def test_candidate_pages_scan_the_int64_image():
    """The host-side scan of a bare target finds the same nonzero pages
    in the port's int64 storage as in PySim's bytes."""
    tt, ps = _fresh(_torch), _fresh(MAKERS["pysim"])
    assert snap.candidate_pages(tt) == jsnap.candidate_pages(ps)
    tt.mem_write_word(200 * 4096 + 8, M64)     # a word that is -1 stored
    ps.mem_write_word(200 * 4096 + 8, M64)
    assert 200 in snap.candidate_pages(tt)
    assert snap.candidate_pages(tt) == jsnap.candidate_pages(ps)
    np.testing.assert_array_equal(tt.page_read(200), ps.page_read(200))
