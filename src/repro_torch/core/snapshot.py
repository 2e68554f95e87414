"""Snapshot/restore subsystem: HTP-captured target checkpoints.

FASE's core premise is that the minimal CPU interface plus the host-side
runtime is enough to *own every bit of architectural state from the
host* — so a full target checkpoint (per-core GPRs, CSRs, pc, privilege,
satp, plus memory pages) is capturable and restorable purely through
Host-Target-Protocol traffic.  This module is that capability, with the
cost model attached: capture and restore lower to native
:class:`~repro_torch.core.session.HtpTransaction` batches, so shipping a
checkpoint pays real wire bytes and real link occupancy on whichever
:class:`~repro_torch.core.channel.Channel` carries it.  That is what makes
live job migration (:meth:`repro_torch.core.fleet.FleetRuntime.migrate`) a
*measured* operation instead of a free teleport.

Request composition (all billed, category ``"snapshot"``/``"restore"``):

  * per core — ``RegR``/``RegW`` ×31 for x1..x31, ``CsrR``/``CsrW`` for
    each :data:`~repro_torch.core.consts.SNAPSHOT_CORE_FIELDS` entry
    (pc/priv/pending/stall_until/satp/mcause/mepc/mtval/res and the
    user-tick counters);
  * memory — ``PageR`` on capture, ``PageW`` on restore, one per 4 KiB
    page; restore batches end with per-core ``FlushTLB`` (a restore is a
    host-driven wholesale PTE change);
  * delta capture — ``PageH`` (controller-side page checksum, 8 response
    bytes instead of 4096) per candidate page, then ``PageR`` only for
    pages whose hash diverged from the base snapshot.  A pre-copied base
    plus a dirty delta is the pre-copy live-migration pattern.

Snapshots are backend-portable: a :class:`TargetSnapshot` round-trips
bit-identically between :class:`~repro_torch.core.interface.TorchTarget`
(on the CPU or the card, a board of a
:class:`~repro_torch.core.fleet.vmap.FleetTarget` included) and the
reference package's targets, both ways (``tests/test_torch_snapshot.py``).
All values are normalised to u64 at capture, so backend-internal
representations (the ``int64`` storage of :class:`TorchTarget`, where
the invalid reservation ``2**64-1`` is ``-1``) never leak into the
format.

On an :class:`~repro_torch.core.cq.AsyncHtpSession` the batches ride the
dedicated :data:`~repro_torch.core.cq.SNAPSHOT_STREAM` and barrier on every
stream's tail token, so an in-flight fault batch is never captured
half-applied.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import htp
from .cq import SNAPSHOT_STREAM, AsyncHtpSession
from .htp import PAGE, PAGE_WORDS
from .session import HtpTransaction
from .consts import SNAPSHOT_CORE_FIELDS
from .target.u64 import to_unsigned


@dataclass(frozen=True)
class CoreState:
    """One core's architectural state, u64-normalised."""

    regs: tuple               # x0..x31 (x0 always 0)
    csrs: tuple               # SNAPSHOT_CORE_FIELDS order


@dataclass
class TargetSnapshot:
    """A point-in-time target checkpoint (full, or a delta off a base).

    ``pages`` holds only the pages this capture shipped; a delta's
    ``parent`` chain supplies the rest (:meth:`effective_pages`).
    ``page_hashes`` records the PageH digest of *every* candidate page
    at capture time — the comparison base for the next delta.
    """

    n_cores: int
    mem_bytes: int
    ticks: int
    cores: list = field(default_factory=list)
    pages: dict = field(default_factory=dict)        # ppn -> 4096 bytes
    page_hashes: dict = field(default_factory=dict)  # ppn -> u64 digest
    parent: "TargetSnapshot | None" = None
    #: the exact session this snapshot was last restored into (set by the
    #: pre-copy path): a delta-only restore is safe ONLY onto that queue
    #: pair — image-key equality is not enough, the board may have been
    #: re-provisioned for another job in between
    resident_session: object = field(default=None, repr=False,
                                     compare=False)

    @property
    def is_delta(self) -> bool:
        return self.parent is not None

    def effective_pages(self) -> dict:
        """Pages of the whole parent chain, newest layer winning."""
        chain = []
        s = self
        while s is not None:
            chain.append(s)
            s = s.parent
        out: dict = {}
        for s in reversed(chain):
            out.update(s.pages)
        return out

    def wire_pages(self) -> int:
        """Pages this capture actually shipped (delta: dirty only)."""
        return len(self.pages)

    def same_state(self, other: "TargetSnapshot") -> bool:
        """Bit-identical architectural state (pages absent from one side
        compare as zero-filled, so a full capture that skipped an
        all-zero page still matches a chain that materialised it)."""
        if (self.n_cores, self.mem_bytes, self.ticks) != \
                (other.n_cores, other.mem_bytes, other.ticks):
            return False
        if self.cores != other.cores:
            return False
        a, b = self.effective_pages(), other.effective_pages()
        zero = bytes(PAGE)
        for ppn in set(a) | set(b):
            if a.get(ppn, zero) != b.get(ppn, zero):
                return False
        return True


def candidate_pages(target) -> list[int]:
    """Host-side scan for nonzero pages of a bare target.  This is free
    host knowledge, not wire traffic — the runtime-integrated path
    passes the allocator's referenced pages instead; this fallback
    derives candidates from content for standalone targets."""
    if hasattr(target, "st"):            # TorchTarget: int64 storage
        words = target.st.mem.cpu().numpy().view(np.uint64)
    else:                                # bytes-backed: zero-copy view
        words = np.frombuffer(target.mem, dtype=np.uint64)
    nz = np.nonzero(words.reshape(-1, PAGE_WORDS).any(axis=1))[0]
    return [int(p) for p in nz]


def _barrier_deps(session, deps: tuple) -> tuple:
    if isinstance(session, AsyncHtpSession):
        return tuple(deps) + session.tail_tokens()
    return tuple(deps)


def capture(session, at: int = 0, pages: list | None = None,
            base: TargetSnapshot | None = None,
            category: str = "snapshot", stream=SNAPSHOT_STREAM,
            deps: tuple = (), barrier: bool = True,
            advisory: bool = False) -> tuple[TargetSnapshot, int]:
    """Checkpoint ``session``'s target through billed HTP traffic.

    Returns ``(snapshot, done_tick)``.  With ``base`` the capture is
    incremental: candidate pages are hashed on-device (``PageH``) and
    only diverging pages cross the wire; the result carries ``base`` as
    its parent.  ``pages`` narrows the candidate set (e.g. a runtime's
    allocated ppns); None scans the target for nonzero pages.

    ``barrier=False`` drops the tail-token fence against in-flight
    per-hart streams.  That is a protocol violation — the capture may
    race an in-flight fault batch — kept only as a seeded-hazard hook
    for the analyzer's corpus (``repro_torch.analysis``), which must
    flag it.

    ``advisory=True`` declares a *live pre-copy* capture: the job keeps
    running while the capture's wire transfer drains, so its reads are
    allowed to race traffic submitted afterwards — every value read
    here is superseded by a later fenced capture (pages via ``PageH``
    divergence, core state wholesale).  The hazard analyzer
    (``repro_torch.analysis``) exempts advisory *reads* and nothing
    else.
    """
    t = session.t
    assert t is not None, "capture needs a session wrapping a target"
    if pages is None:
        pages = candidate_pages(t)
    cand = sorted(set(pages) | set(base.page_hashes if base else ()))
    deps = _barrier_deps(session, deps) if barrier else tuple(deps)
    rec = session.trace if advisory else None
    if rec is not None:
        rec.advisory = True

    txn = HtpTransaction()
    for c in range(t.n_cores):
        for i in range(1, 32):
            txn.reg_read(c, i, category)
        for name in SNAPSHOT_CORE_FIELDS:
            txn.csr_read(c, name, category)
    txn.tick()
    if base is None:
        for p in cand:
            txn.page_read(0, p, category)
    else:
        for p in cand:
            txn.page_hash(0, p, category)
    try:
        res = session.submit(txn, at, stream=stream, deps=deps)

        nfields = 31 + len(SNAPSHOT_CORE_FIELDS)
        cores = []
        for c in range(t.n_cores):
            vals = res.values[c * nfields:(c + 1) * nfields]
            regs = (0,) + tuple(to_unsigned(int(v)) for v in vals[:31])
            csrs = tuple(to_unsigned(int(v)) for v in vals[31:])
            cores.append(CoreState(regs, csrs))
        ticks = int(res.values[t.n_cores * nfields])
        tail = res.values[t.n_cores * nfields + 1:]

        snap = TargetSnapshot(t.n_cores, t.mem_bytes, ticks, cores,
                              parent=base)
        done = res.done
        if base is None:
            for p, words in zip(cand, tail):
                data = np.ascontiguousarray(words,
                                            dtype=np.uint64).tobytes()
                snap.pages[p] = data
                snap.page_hashes[p] = htp.page_hash(words)
        else:
            snap.page_hashes = {p: int(h) for p, h in zip(cand, tail)}
            dirty = [p for p in cand
                     if snap.page_hashes[p] != base.page_hashes.get(p)]
            if dirty:
                txn2 = HtpTransaction()
                for p in dirty:
                    txn2.page_read(0, p, category)
                res2 = session.submit(txn2, res.done, stream=stream,
                                      deps=(res.token,))
                for p, words in zip(dirty, res2.values):
                    snap.pages[p] = np.ascontiguousarray(
                        words, dtype=np.uint64).tobytes()
                done = res2.done
    finally:
        if rec is not None:
            rec.advisory = False
    return snap, done


def restore(session, snap: TargetSnapshot, at: int = 0,
            category: str = "restore", stream=SNAPSHOT_STREAM,
            deps: tuple = (), delta_only: bool = False,
            set_ticks: bool = True, barrier: bool = True) -> int:
    """Write ``snap`` into ``session``'s target as one billed HTP batch;
    returns the completion tick.

    ``delta_only`` ships just this snapshot's own pages (the dirty set)
    — the pre-copy migration path, where the parent chain was already
    restored onto the destination earlier.  ``set_ticks`` also restores
    the global tick counter to the snapshot's (cross-backend fidelity);
    migration instead re-aligns the clock to the modelled resume tick
    afterwards, host-side.  ``barrier=False`` drops the tail-token fence
    (a protocol violation, kept as the analyzer's seeded-hazard hook).
    """
    t = session.t
    assert t is not None, "restore needs a session wrapping a target"
    assert (t.n_cores, t.mem_bytes) == (snap.n_cores, snap.mem_bytes), \
        "snapshot shape mismatch (cores/memory)"
    pagemap = snap.pages if delta_only else snap.effective_pages()
    txn = HtpTransaction()
    for ppn in sorted(pagemap):
        words = np.frombuffer(pagemap[ppn], dtype=np.uint64)
        txn.page_write(0, ppn, words, category)
    for c, core in enumerate(snap.cores):
        for i in range(1, 32):
            txn.reg_write(c, i, core.regs[i], category)
        for name, v in zip(SNAPSHOT_CORE_FIELDS, core.csrs):
            txn.csr_write(c, name, v, category)
    if set_ticks:
        txn.csr_write(0, "ticks", snap.ticks, category)
    for c in range(snap.n_cores):
        txn.flush_tlb(c, category)
    res = session.submit(txn, at, stream=stream,
                         deps=_barrier_deps(session, deps) if barrier
                         else tuple(deps))
    return res.done
