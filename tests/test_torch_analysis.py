"""HTP hazard analyzer of the port (``repro_torch.analysis``): the twins
of ``tests/test_analysis.py`` against the port's footprints, linter,
trace hook and detector, over the port's sessions, fleet, fabric and
PySim; ``fetch_batch`` on ``TorchTarget(device="cpu")`` where the
reference used ``JaxTarget``; and ``python -m repro_torch.analysis gate
--quick`` clean.  The reference's docstring follows.

HTP hazard analyzer: footprints, linter, trace hook, detector.

Three layers of coverage:

  * **pins** — the footprint/argument tables cover exactly ``htp.SPECS``
    and the linter reports zero findings over the shipped tree;
  * **seeded-hazard corpus** (``@pytest.mark.hazard``) — every hazard
    class the analyzer exists for is deliberately constructed (dropped
    dependency tokens on cq/fleet/snapshot paths) and must be flagged,
    and its correctly-fenced twin must be clean — pinning both the
    detection power and the false-positive rate at the same time;
  * **batched reads** (ROADMAP item 1 satellite) — ``fetch_batch``
    returns accessor-identical values, the session routes multi-read
    transactions through exactly one device fetch, and intra-transaction
    write-then-read still sees the written value.

The autouse ``port_race_gate`` fixture below runs the port's detector
over every port async session a test of this file builds, as the
reference's ``htp_race_gate`` (``conftest.py``) does for its own.
"""
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import (ARG_SPECS, HtpTrace, attach_trace, detect,
                            footprint, lint_all, lint_builders,
                            lint_sources, lint_specs, summarize)
from repro_torch.analysis.trace import SERIAL_DOMAIN
from repro_torch.core import htp, snapshot
from repro_torch.core.channel import make_channel
from repro_torch.core.cq import AsyncHtpSession
from repro_torch.core.hfutex import HFutexCache
from repro_torch.core.session import HtpSession, HtpTransaction
from repro_torch.core.target.pysim import PySim


@pytest.fixture(autouse=True)
def port_race_gate(request):
    """The port's twin of ``conftest.py::htp_race_gate``: every port
    ``AsyncHtpSession`` built during a test gets the trace hook armed,
    and at teardown the detector must report zero findings; tests that
    seed hazards opt out with ``@pytest.mark.hazard``."""
    from repro_torch.analysis.trace import TraceRecorder, session_is_serial

    if request.node.get_closest_marker("hazard"):
        yield
        return
    traces = []
    orig_init = AsyncHtpSession.__init__

    def traced_init(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        trace = HtpTrace()
        traces.append(trace)
        self.trace = TraceRecorder(trace, session_is_serial(self))

    AsyncHtpSession.__init__ = traced_init
    try:
        yield
    finally:
        AsyncHtpSession.__init__ = orig_init
    for trace in traces:
        findings = detect(trace)
        assert not findings, (
            "HTP race(s) in a clean test's transaction trace:\n" +
            "\n".join(f"  {f}" for f in findings))


def _pcie_session(n_cores=2, mem=1 << 20, **kw):
    t = PySim(n_cores, mem)
    return AsyncHtpSession(t, make_channel("pcie"),
                           HFutexCache(n_cores), **kw)


def _uart_session(n_cores=1, mem=1 << 20):
    t = PySim(n_cores, mem)
    return AsyncHtpSession(t, make_channel("uart"), HFutexCache(n_cores))


# ---------------------------------------------------------------------------
# footprints
# ---------------------------------------------------------------------------
def test_footprint_tables_cover_specs_exactly():
    assert set(ARG_SPECS) == set(htp.SPECS)
    for op in htp.SPECS:
        nargs = len(ARG_SPECS[op])
        reads, writes = footprint(op, 1, tuple(range(2, nargs + 2)))
        assert isinstance(reads, tuple) and isinstance(writes, tuple)


def test_footprint_redirect_reads_fetch_state():
    reads, writes = footprint("Redirect", 0, (0x5123,))
    assert ("mem", 0x5, None) in reads          # the pc's page
    assert ("tlb", 0) in reads and ("icache", 0) in reads
    assert ("csr", 0, "pc") in writes and ("csr", 0, "priv") in writes


def test_footprint_csrw_ticks_is_the_clock():
    _, writes = footprint("CsrW", 0, ("ticks",))
    assert writes == ((("clock",)),)
    _, writes = footprint("CsrW", 3, ("mepc",))
    assert writes == (("csr", 3, "mepc"),)


def test_footprint_virtual_requests_use_serving_namespace():
    reads, writes = footprint("PageCP", 0, (7, 9), virtual=True)
    assert reads == (("vpage", 7),) and writes == (("vpage", 9),)
    reads, writes = footprint("Redirect", 4, (), virtual=True)
    assert reads == () and writes == (("vslot", 4),)


def test_footprint_nic_ops_touch_dram_and_doorbells():
    reads, writes = footprint("NicTx", 0, (5,))
    assert reads == (("mem", 5, None),) and writes == ()
    reads, writes = footprint("NicRx", 0, (7, (1, 2)))
    assert reads == () and writes == (("mem", 7, None),)
    reads, writes = footprint("NicCtl", 1, ("shootdown", 0))
    assert reads == () and writes == (("nicq", 1),)


# ---------------------------------------------------------------------------
# linter
# ---------------------------------------------------------------------------
def test_repo_lints_clean():
    assert lint_all() == []


def test_lint_builders_clean_and_complete():
    assert lint_builders() == []


def test_lint_specs_flags_corrupted_tables():
    class Spec:
        def __init__(self, req=8, resp=8, ctrl=4):
            self.req_bytes, self.resp_bytes = req, resp
            self.ctrl_cycles = ctrl
            self.total_bytes = req + resp

    specs = {op: Spec() for op in htp.SPECS}
    specs["PageR"] = Spec(resp=htp.PAGE)
    specs["PageW"] = Spec(req=htp.PAGE + 9)
    specs["Next"] = Spec(resp=2 + 3 * htp.WORD)
    direct = {op: 8 for op in specs}
    clean = lint_specs(specs, direct, lambda name: 0)
    assert clean == []

    # drop an op from the direct baseline
    bad = dict(direct)
    del bad["Tick"]
    assert any("direct table" in f.message
               for f in lint_specs(specs, bad, lambda name: 0))
    # free controller execution
    s2 = dict(specs)
    s2["RegR"] = Spec(ctrl=0)
    assert any("RegR" in f.message
               for f in lint_specs(s2, direct, lambda name: 0))
    # wire size below the intrinsic payload
    assert any("below intrinsic payload" in f.message
               for f in lint_specs(specs, direct, lambda name: 1 << 20))
    # serving analogue missing from the table
    s3 = {op: Spec() for op in specs if op != "PageCP"}
    assert any("serving analogue" in f.message for f in
               lint_specs(s3, {op: 8 for op in s3}, lambda name: 0))


def test_lint_sources_flags_seeded_antipatterns(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "from repro_torch.core.session import HtpRequest\n"
        "def build(t, sess):\n"
        "    r1 = HtpRequest('Bogus', 0, (1,))\n"
        "    r2 = HtpRequest('Redirect', 0, (1,), nbytes=8)\n"
        "    vals = []\n"
        "    for i in range(31):\n"
        "        vals.append(t.reg_read(0, i))\n"
        "    for i in range(4):\n"
        "        vals.append(sess.t.csr_read(i, 'mepc'))"
        "  # analysis: allow-host-sync\n"
        "    for i in range(31):\n"
        "        t.reg_write(0, i, vals[i])\n"
        "    for i in range(4):\n"
        "        sess.t.mem_write_word(i * 8, 0)"
        "  # analysis: allow-host-sync\n"
        "    return r1, r2, vals\n")
    found = lint_sources(paths=[bad])
    codes = sorted(f.code for f in found)
    assert codes == ["host-sync", "host-sync-write",
                     "nbytes-not-virtual", "unknown-op"]
    hs = next(f for f in found if f.code == "host-sync")
    assert "t.reg_read" in hs.message and hs.line == 7
    hw = next(f for f in found if f.code == "host-sync-write")
    assert "t.reg_write" in hw.message and hw.line == 11
    assert "commit_batch" in hw.message


def test_lint_sources_flags_builder_arity(tmp_path):
    bad = tmp_path / "session.py"
    bad.write_text(
        "class HtpTransaction:\n"
        "    def redirect(self, cpu, pc, extra):\n"
        "        return self.add(HtpRequest('Redirect', cpu, "
        "(pc, extra)))\n")
    found = lint_builders(bad)
    assert any(f.code == "builder-arity" and "Redirect" in f.message
               for f in found)
    assert any(f.code == "builder-missing" for f in found)  # other ops


# ---------------------------------------------------------------------------
# trace hook
# ---------------------------------------------------------------------------
@pytest.mark.hazard     # opt out of the autouse fixture's trace arming
def test_trace_hook_off_by_default():
    sess = _pcie_session()
    assert sess.trace is None
    res = sess.submit(HtpTransaction().reg_write(0, 5, 1), 0, stream=0)
    assert res.token is not None        # engine unaffected


def test_trace_records_tokens_deps_and_streams():
    sess = _pcie_session()
    trace = attach_trace(sess)
    r1 = sess.submit(HtpTransaction().page_set(0, 3, 0), 0, stream=0)
    sess.submit(HtpTransaction().page_read(1, 3), 0, stream=1,
                deps=(r1.token,))
    assert len(trace) == 2
    a, b = trace.events
    assert a.stream == 0 and b.stream == 1
    assert a.token_id is not None and b.dep_ids == (a.token_id,)
    assert b.ready == r1.done           # deps resolved into ready
    # empty transactions never cross the wire and are not recorded
    sess.submit(HtpTransaction(), 0, stream=0)
    assert len(trace) == 2


def test_trace_serial_links_collapse_to_one_domain():
    sess = _uart_session()
    trace = attach_trace(sess)
    sess.submit(HtpTransaction().reg_write(0, 5, 1), 0, stream=0)
    sess.submit(HtpTransaction().reg_read(0, 5), 0, stream="serve")
    assert trace.streams() == [SERIAL_DOMAIN]
    assert [e.seq for e in trace.events] == [0, 1]


# ---------------------------------------------------------------------------
# seeded-hazard corpus: every class flagged, every fenced twin clean
# ---------------------------------------------------------------------------
@pytest.mark.hazard
def test_seeded_page_race_on_sibling_streams():
    sess = _pcie_session()
    trace = attach_trace(sess)
    sess.submit(HtpTransaction().page_write(0, 5, [1] * htp.PAGE_WORDS),
                0, stream=0)
    sess.submit(HtpTransaction().page_read(1, 5), 0, stream=1)  # no deps
    found = detect(trace)
    assert len(found) == 1 and found[0].kind == "page-race"
    assert found[0].loc == ("mem", 5)
    assert summarize(found) == {"page-race": 1}


@pytest.mark.hazard
def test_dependency_token_fences_the_same_pair():
    sess = _pcie_session()
    trace = attach_trace(sess)
    r1 = sess.submit(
        HtpTransaction().page_write(0, 5, [1] * htp.PAGE_WORDS),
        0, stream=0)
    sess.submit(HtpTransaction().page_read(1, 5), 0, stream=1,
                deps=(r1.token,))
    assert detect(trace) == []
    assert detect(trace, time_fences=False) == []   # token edge, not time


@pytest.mark.hazard
def test_seeded_fetch_race_page_write_vs_redirect():
    sess = _pcie_session()
    trace = attach_trace(sess)
    sess.submit(HtpTransaction().page_write(0, 8, [0] * htp.PAGE_WORDS),
                0, stream=0)
    sess.submit(HtpTransaction().redirect(1, 8 << 12), 0, stream=1)
    found = detect(trace)
    assert [f.kind for f in found] == ["fetch-race"]


@pytest.mark.hazard
def test_seeded_tlb_race_flush_vs_redirect():
    sess = _pcie_session()
    trace = attach_trace(sess)
    sess.submit(HtpTransaction().flush_tlb(1, "shootdown"), 0,
                stream="mmu")
    sess.submit(HtpTransaction().redirect(1, 0x2000), 0, stream=1)
    kinds = {f.kind for f in detect(trace)}
    assert "tlb-race" in kinds


@pytest.mark.hazard
def test_seeded_unbarriered_snapshot_capture():
    sess = _pcie_session(n_cores=1)
    sess.t.page_set(3, 7)               # host prep: page 3 is nonzero
    trace = attach_trace(sess)
    # an in-flight fault-batch store on the hart stream...
    sess.submit(HtpTransaction().mem_write(0, 3 << 12, 42, "pagefault"),
                0, stream=0)
    # ...raced by a capture that drops the tail-token barrier
    snapshot.capture(sess, at=0, pages=[3], barrier=False)
    found = detect(trace)
    assert any(f.kind == "page-race" and f.loc == ("mem", 3)
               for f in found)


@pytest.mark.hazard
def test_barriered_snapshot_capture_is_clean():
    sess = _pcie_session(n_cores=1)
    sess.t.page_set(3, 7)
    trace = attach_trace(sess)
    sess.submit(HtpTransaction().mem_write(0, 3 << 12, 42, "pagefault"),
                0, stream=0)
    snapshot.capture(sess, at=0, pages=[3])          # default barrier
    assert detect(trace) == []
    assert detect(trace, time_fences=False) == []    # token-fenced


@pytest.mark.hazard
def test_advisory_precopy_capture_exempts_only_reads():
    # live pre-copy: the capture drains while the job keeps running —
    # declared advisory, its reads may race (a later fenced capture
    # supersedes them)
    sess = _pcie_session(n_cores=1)
    sess.t.page_set(3, 7)
    trace = attach_trace(sess)
    snapshot.capture(sess, at=0, pages=[3], advisory=True)
    sess.submit(HtpTransaction().mem_write(0, 3 << 12, 9, "pagefault"),
                1, stream=0)
    assert detect(trace) == []
    # the identical overlap without the advisory marking is a race
    trace2 = attach_trace(sess)
    t0 = sess.quiesce_tick()
    snapshot.capture(sess, at=t0, pages=[3])
    sess.submit(HtpTransaction().mem_write(0, 3 << 12, 11, "pagefault"),
                t0 + 1, stream=0)
    assert any(f.kind == "page-race" for f in detect(trace2))


@pytest.mark.hazard
def test_seeded_fleet_race_token_fence_and_device_namespacing():
    from repro_torch.core.fleet import Device, FleetRouter
    devs = [Device(i, lambda: PySim(2, 1 << 20), link="pcie")
            for i in range(2)]
    router = FleetRouter(devs)
    trace = attach_trace(router)
    # same board, sibling harts, no dependency token: a real race
    r1 = router.submit(
        HtpTransaction().page_write(0, 5, [1] * htp.PAGE_WORDS),
        0, stream=(0, 0))
    router.submit(HtpTransaction().page_read(1, 5), 0, stream=(0, 1))
    # same ppn on the *other* board: different DRAM, never a race
    router.submit(
        HtpTransaction().page_write(0, 5, [2] * htp.PAGE_WORDS),
        0, stream=(1, 0))
    found = detect(trace)
    assert [f.kind for f in found] == ["page-race"]
    assert {a.event.stream for f in found for a in (f.a, f.b)} == \
        {(0, 0), (0, 1)}
    # the same sibling-hart pair with the dependency token: ordered
    trace2 = attach_trace(router)
    r1 = router.submit(
        HtpTransaction().page_write(0, 5, [3] * htp.PAGE_WORDS),
        r1.done, stream=(0, 0))
    router.submit(HtpTransaction().page_read(1, 5), r1.done,
                  stream=(0, 1), deps=(r1.token,))
    assert detect(trace2) == []
    assert detect(trace2, time_fences=False) == []


def _fabric_pair(n_cores=2, **switch_kw):
    """Two fleet devices on one switch, both provisioned."""
    from repro_torch.core.fleet import Device
    from repro_torch.core.net import NicEndpoint, Switch
    sw = Switch(**switch_kw)
    devs = [Device(i, lambda: PySim(n_cores, 1 << 20), link="pcie")
            for i in range(2)]
    nics = [NicEndpoint(d, sw) for d in devs]
    return nics, devs[0].provision(), devs[1].provision()


@pytest.mark.hazard
def test_seeded_fabric_race_remote_shootdown_vs_local_fetch():
    """A remote TLB shootdown delivered off the fabric while the
    receiving board has an in-flight Redirect on the same hart: the
    flush can land before or after the fetch translates — tlb-race.
    The same delivery fenced on the redirect's token is clean (and by
    the token edge, not modelled time)."""
    nics, _, s1 = _fabric_pair()
    trace = attach_trace(s1)
    r = s1.submit(HtpTransaction().redirect(1, 0x2000), 0, stream=1)
    nics[1].deliver(HtpTransaction().flush_tlb(1, "shootdown"), at=1)
    found = detect(trace)
    assert summarize(found) == {"tlb-race": 1}

    nics, _, s1 = _fabric_pair()
    trace = attach_trace(s1)
    r = s1.submit(HtpTransaction().redirect(1, 0x2000), 0, stream=1)
    nics[1].deliver(HtpTransaction().flush_tlb(1, "shootdown"), at=1,
                    deps=(r.token,))
    assert detect(trace) == []
    assert detect(trace, time_fences=False) == []


@pytest.mark.hazard
def test_seeded_fabric_race_starved_flit_vs_migration_capture():
    """A credit-starved frame still draining into the destination board
    while a migration capture reads the same DRAM: the NicRx lands
    mid-capture (its delivery tick sits inside the capture window), so
    the captured page is indeterminate — page-race on the mailbox ppn.
    Token-fencing the capture on the delivery (``migrate(...,
    deps=(nic.last_token,))``, as ``migrate_gang`` does) is clean."""
    def seed(deps=()):
        nics, s0, s1 = _fabric_pair(n_cores=1, credits=2,
                                    latency_ticks=100)
        s0.t.page_set(3, 7)
        trace = attach_trace(s1)
        res = nics[0].push_pages(nics[1], [(3, 7)], at=0)
        snapshot.capture(s1, at=0, pages=list(range(16)),
                         deps=(res.token,) if deps else ())
        assert nics[0].port.credit_stalls > 0      # genuinely starved
        return trace

    found = detect(seed())
    assert any(f.kind == "page-race" and f.loc == ("mem", 7)
               for f in found)
    fenced = seed(deps=True)
    assert detect(fenced) == []
    assert detect(fenced, time_fences=False) == []


@pytest.mark.hazard
def test_host_time_chaining_counts_only_as_a_time_fence():
    sess = _pcie_session()
    trace = attach_trace(sess)
    r1 = sess.submit(
        HtpTransaction().page_write(0, 5, [1] * htp.PAGE_WORDS),
        0, stream=0)
    # the sequential host pattern: submit after observing completion,
    # without a token — ordered by modelled time, not by the protocol
    sess.submit(HtpTransaction().page_read(1, 5), r1.done, stream=1)
    assert detect(trace) == []
    assert [f.kind for f in detect(trace, time_fences=False)] == \
        ["page-race"]


def test_clean_end_to_end_trace_has_zero_findings():
    from repro_torch.core.runtime import FaseRuntime
    from repro_torch.core.workloads import build
    rt = FaseRuntime(PySim(1, 1 << 22), mode="fase", link="pcie",
                     session="async")
    trace = attach_trace(rt.session)
    rt.load(build("hello"), ["hello"])
    rep = rt.run()
    assert rep.stdout.startswith(b"hello")
    assert len(trace) > 10
    assert detect(trace) == []


# ---------------------------------------------------------------------------
# batched host reads (ROADMAP item 1 satellite)
# ---------------------------------------------------------------------------
class _CountingSim(PySim):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.batch_calls = 0
        self.direct_reads = 0
        self._in_batch = False

    def fetch_batch(self, regs=(), csrs=(), words=()):
        self.batch_calls += 1
        self._in_batch = True
        try:
            return super().fetch_batch(regs, csrs, words)
        finally:
            self._in_batch = False

    def reg_read(self, c, idx):
        if not self._in_batch:
            self.direct_reads += 1
        return super().reg_read(c, idx)

    def csr_read(self, c, name):
        if not self._in_batch:
            self.direct_reads += 1
        return super().csr_read(c, name)


def test_context_save_is_one_device_fetch():
    t = _CountingSim(1, 1 << 20)
    for i in range(1, 32):
        t.reg_write(0, i, 100 + i)
    t.direct_reads = 0
    sess = HtpSession(t, make_channel("uart"), HFutexCache(1))
    txn = HtpTransaction()
    for i in range(1, 32):
        txn.reg_read(0, i)
    res = sess.submit(txn, 0)
    assert res.values == [100 + i for i in range(1, 32)]
    assert t.batch_calls == 1
    assert t.direct_reads == 0


def test_intra_transaction_write_then_read_not_stale():
    t = _CountingSim(1, 1 << 20)
    t.reg_write(0, 5, 1)
    sess = HtpSession(t, make_channel("uart"), HFutexCache(1))
    txn = (HtpTransaction()
           .reg_read(0, 5)           # prefetched: original value
           .reg_write(0, 5, 99)
           .reg_read(0, 5)           # dirtied: served from the write
           .reg_read(0, 6))          # stage, not the device; prefetched
    res = sess.submit(txn, 0)
    assert res.values[0] == 1
    assert res.values[2] == 99
    assert res.values[3] == 0
    assert t.batch_calls == 1         # one fetch for the two clean reads
    assert t.direct_reads == 0        # the dirtied read hits the stage


def test_fetch_batch_matches_accessors_pysim():
    t = PySim(2, 1 << 20)
    t.reg_write(1, 7, 0xDEAD)
    t.csr_write(1, "mepc", 0x1234)
    t.mem_write_word(0x100, 0xBEEF)
    regs, csrs, words = t.fetch_batch(
        regs=[(1, 7), (0, 0)], csrs=[(1, "mepc"), (0, "priv")],
        words=[0x100])
    assert regs == [0xDEAD, 0]
    assert csrs[0] == 0x1234
    assert words == [0xBEEF]
    assert csrs[1] == t.get_priv(0)


def test_fetch_batch_matches_accessors_torch():
    from repro_torch.core.interface import TorchTarget
    t = TorchTarget(2, 1 << 16, device="cpu")
    t.reg_write(1, 7, 0xDEAD)
    t.csr_write(1, "mepc", 0x1234)
    t.mem_write_word(0x100, 0xBEEF)
    regs, csrs, words = t.fetch_batch(
        regs=[(1, 7), (0, 3)], csrs=[(1, "mepc"), (0, "priv")],
        words=[0x100])
    assert regs == [t.reg_read(1, 7), t.reg_read(0, 3)]
    assert csrs == [t.csr_read(1, "mepc"), t.csr_read(0, "priv")]
    assert words == [t.mem_read_word(0x100)]


def test_sessions_without_batch_surface_still_work():
    class NoBatch:
        """Minimal target lacking fetch_batch: the session must fall
        back to per-element accessors."""
        n_cores = 1

        def __init__(self):
            self.regs = {5: 77}

        def reg_read(self, c, idx):
            return self.regs.get(idx, 0)

    sess = HtpSession(NoBatch(), make_channel("uart"), HFutexCache(1))
    res = sess.submit(
        HtpTransaction().reg_read(0, 5).reg_read(0, 1), 0)
    assert res.values == [77, 0]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def test_cli_lint_and_footprints():
    from repro_torch.analysis.cli import main
    assert main(["lint"]) == 0
    assert main(["footprints", "Redirect"]) == 0
    assert main(["footprints", "NotAnOp"]) == 2


def test_gate_quick_is_clean():
    """``python -m repro_torch.analysis gate --quick``: the linter over
    the port's modules and the race detector over the canonical
    workloads (serial, pipelined, multi-hart, telemetry armed, a fleet
    migration) on ``TorchTarget`` on the CPU (``--device cpu``: the
    eager loop), with 0 findings."""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "gate", "--quick",
         "--device", "cpu"],
        cwd=root, env={"PYTHONPATH": str(root / "src"), "PATH": ""},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "lint: 0 finding(s)" in out.stdout
    assert "race: 0 finding(s)" in out.stdout
    assert "analysis-gate: PASS" in out.stdout


def test_default_scan_names_the_ports_modules():
    """The linter scans the port's own transaction-building modules, and
    each of them exists."""
    from repro_torch.analysis.lint import DEFAULT_SCAN
    root = Path(__file__).resolve().parents[1]
    assert all(p.startswith("src/repro_torch/") for p in DEFAULT_SCAN)
    assert all((root / p).is_file() for p in DEFAULT_SCAN)
