"""Declarative read/write footprints for every Table II HTP request.

The hazard analyzer (:mod:`repro_torch.analysis.detector`) needs to know, for
any two requests, whether they *conflict* — touch the same piece of
architectural state with at least one side writing.  This module is the
single source of that knowledge: one entry per ``repro_torch.core.htp.SPECS``
opcode, declaring

  * the request's **argument signature** (``ARG_SPECS``) — the names and
    order of its ``args`` tuple, which the protocol linter cross-checks
    against the :class:`~repro_torch.core.session.HtpTransaction` builders;
  * its **footprint** (:func:`footprint`) — the abstract locations it
    reads and writes.

Locations are plain tuples, namespaced by kind:

  ``("reg", cpu, idx)``     one GPR of one hart
  ``("csr", cpu, name)``    one CSR/core-control field (``pc``, ``priv``,
                            ``pending``, ``satp``, ``mcause`` … — Redirect
                            and Next touch these too, that is the point)
  ``("mem", ppn, widx)``    one 64-bit word of physical memory;
                            ``widx=None`` means the whole 4 KiB page, and
                            conflicts with every word of that page
  ``("tlb", cpu)``          one hart's translation caches (SetMMU /
                            FlushTLB write it; Redirect *reads* it —
                            resumed execution translates through it)
  ``("icache", cpu)``       fetch coherence (SyncI writes, Redirect reads)
  ``("hfutex", cpu)``       the controller's futex mask cache
  ``("clock",)``            the global tick counter
  ``("uticks", cpu)``       one hart's user-tick counter
  ``("tracebuf", cpu)``     one hart's commit-trace ring (telemetry:
                            ``TraceB`` drains it — read + write)
  ``("vpage", page)`` /     Layer-B serving analogues (``virtual``
  ``("vslot", slot)``       requests): pod block pages / decode slots.
                            A separate namespace — serving block ids are
                            not target ppns — so Layer-B traffic races
                            only against itself, never falsely against
                            Layer-A physical pages.

Two extensions beyond the literal register/page sets encode the real
hazard classes:

  * **Redirect reads the page containing its target pc** (and the hart's
    TLB/icache): the resumed core fetches from that page, so a Redirect
    HB-unordered with a ``PageW``/``PageS``/``PageCP`` of the same page
    is the "page write vs fetch on a sibling stream" race.
  * **CsrW of the pseudo-CSR ``ticks`` writes ``("clock",)``** (snapshot
    restore's clock re-alignment), conflicting with ``Tick`` harvests.

Drift is impossible by construction: importing this module asserts the
footprint and argument tables cover exactly ``htp.SPECS``, and
``tests/test_analysis.py`` re-pins it.
"""
from __future__ import annotations

from ..core import htp

#: argument signature of each opcode's ``args`` tuple, in order.  The
#: linter checks every ``HtpTransaction`` builder passes exactly this
#: many args; the trace recorder uses the names to keep only the scalars
#: the footprint needs (a ``PageW``'s 4 KiB payload is never retained).
ARG_SPECS: dict[str, tuple] = {
    "Redirect": ("pc",),
    "Next": (),
    "SetMMU": ("satp",),
    "FlushTLB": (),
    "SyncI": (),
    "HFutex": (),
    "RegR": ("idx",),
    "RegW": ("idx", "val"),
    "CsrR": ("name",),
    "CsrW": ("name", "val"),
    "MemR": ("pa",),
    "MemW": ("pa", "val"),
    "PageS": ("ppn", "val"),
    "PageCP": ("src", "dst"),
    "PageR": ("ppn",),
    "PageW": ("ppn", "words"),
    "PageH": ("ppn",),
    "Tick": (),
    "UTick": (),
    "CtrSample": (),
    "TraceB": (),
    "NicTx": ("ppn",),
    "NicRx": ("ppn", "words"),
    "NicCtl": ("kind", "val"),
}

#: args-tuple indices the footprint/trace layer retains per opcode
#: (everything except bulk payloads — ``PageW.words`` — and values)
KEY_ARGS: dict[str, tuple] = {
    op: tuple(i for i, name in enumerate(sig)
              if name not in ("words", "val"))
    for op, sig in ARG_SPECS.items()
}

#: control-state fields a Redirect overwrites on its hart (the execution
#: pattern of Table II: stage pc, csrw mepc, mret into user mode)
REDIRECT_CSRS = ("pc", "priv", "pending", "stall_until")
#: exception-state fields a Next harvests from its hart
NEXT_CSRS = ("mcause", "mepc", "mtval")


def key_args(op: str, args: tuple) -> tuple:
    """The footprint-relevant scalars of one request's args (compact,
    payload-free — safe to retain in a long trace)."""
    ks = KEY_ARGS[op]
    return tuple(args[i] for i in ks if i < len(args))


def footprint(op: str, cpu: int, kargs: tuple, virtual: bool = False
              ) -> tuple[tuple, tuple]:
    """``(reads, writes)`` location tuples of one request.

    ``kargs`` is the compact :func:`key_args` form (raw ``args`` work
    too for every op whose key args are a prefix).  ``virtual`` requests
    (Layer-B serving analogues) map into the ``vpage``/``vslot``
    namespace — they are never applied to a target, so they must never
    conflict with Layer-A physical state.
    """
    if virtual:
        if op == "PageCP":
            return (("vpage", kargs[0]),), (("vpage", kargs[1]),)
        if op in ("PageS", "PageW"):
            # argless analogues are bulk per-slot transfers (serving
            # slot migration ships a slot's whole KV plane h2d)
            if kargs:
                return (), (("vpage", kargs[0]),)
            return (), (("vslot", cpu),)
        if op in ("PageR", "PageH"):
            if kargs:
                return (("vpage", kargs[0]),), ()
            return (("vslot", cpu),), ()
        if op in ("Redirect", "SetMMU"):
            return (), (("vslot", cpu),)
        return (), ()
    if op == "Redirect":
        pc = int(kargs[0])
        return (("mem", pc >> 12, None), ("tlb", cpu), ("icache", cpu)), \
            tuple(("csr", cpu, f) for f in REDIRECT_CSRS)
    if op == "Next":
        return tuple(("csr", cpu, f) for f in NEXT_CSRS), \
            (("csr", cpu, "pending"),)
    if op == "SetMMU":
        return (), (("csr", cpu, "satp"), ("tlb", cpu))
    if op == "FlushTLB":
        return (), (("tlb", cpu),)
    if op == "SyncI":
        return (), (("icache", cpu),)
    if op == "HFutex":
        return (), (("hfutex", cpu),)
    if op == "RegR":
        return (("reg", cpu, int(kargs[0])),), ()
    if op == "RegW":
        return (), (("reg", cpu, int(kargs[0])),)
    if op == "CsrR":
        return (("csr", cpu, kargs[0]),), ()
    if op == "CsrW":
        name = kargs[0]
        if name == "ticks":          # restore's clock re-alignment
            return (), (("clock",),)
        return (), (("csr", cpu, name),)
    if op == "MemR":
        pa = int(kargs[0])
        return (("mem", pa >> 12, (pa & 0xFFF) >> 3),), ()
    if op == "MemW":
        pa = int(kargs[0])
        return (), (("mem", pa >> 12, (pa & 0xFFF) >> 3),)
    if op == "PageS":
        return (), (("mem", int(kargs[0]), None),)
    if op == "PageCP":
        return (("mem", int(kargs[0]), None),), \
            (("mem", int(kargs[1]), None),)
    if op in ("PageR", "PageH"):
        return (("mem", int(kargs[0]), None),), ()
    if op == "PageW":
        return (), (("mem", int(kargs[0]), None),)
    if op == "Tick":
        return (("clock",),), ()
    if op == "UTick":
        return (("uticks", cpu),), ()
    if op == "CtrSample":
        # out-of-band counter sample: reads the hart's retirement
        # counters and the global clock, mutates nothing — so a sample
        # races only against writers of those (CsrW of ticks/instret,
        # i.e. snapshot restore), never against ordinary traffic
        return (("clock",), ("uticks", cpu), ("csr", cpu, "instret")), ()
    if op == "TraceB":
        # commit-trace frame drain: consumes the hart's trace ring
        # (read + write — draining advances the ring's read cursor)
        return (("tracebuf", cpu),), (("tracebuf", cpu),)
    if op == "NicTx":
        # NIC egress DMA reads the whole source page out of board DRAM —
        # a migration capture or guest write of that page HB-unordered
        # with an in-flight egress frame is a fabric race
        return (("mem", int(kargs[0]), None),), ()
    if op == "NicRx":
        # ingress DMA lands a whole fabric frame into board DRAM behind
        # the cores' backs — conflicts with any local read of that page
        return (), (("mem", int(kargs[0]), None),)
    if op == "NicCtl":
        # control doorbell (wake/shootdown) on the receiving NIC queue;
        # the architectural effect travels as explicit HFutex/FlushTLB
        # rows of the delivered transaction
        return (), (("nicq", cpu),)
    raise KeyError(f"no footprint for HTP request {op!r}")


def mem_overlap(a, b) -> bool:
    """Do two ``("mem", ppn, widx)`` locations overlap?  Same page and
    (same word, or either side is the whole page)."""
    if a[1] != b[1]:
        return False
    return a[2] is None or b[2] is None or a[2] == b[2]


def conflicts(loc_a, loc_b) -> bool:
    """Location-level conflict test (kind-aware for memory)."""
    if loc_a[0] != loc_b[0]:
        return False
    if loc_a[0] == "mem":
        return mem_overlap(loc_a, loc_b)
    return loc_a == loc_b


def _check_coverage():
    missing = set(htp.SPECS) - set(ARG_SPECS)
    extra = set(ARG_SPECS) - set(htp.SPECS)
    assert not missing and not extra, \
        f"footprint table drifted from htp.SPECS: -{missing} +{extra}"
    for op in htp.SPECS:
        # every op must produce a well-formed footprint from key args
        nargs = len(ARG_SPECS[op])
        reads, writes = footprint(op, 0, tuple(range(1, nargs + 1)))
        for loc in reads + writes:
            assert isinstance(loc, tuple) and loc, (op, loc)


_check_coverage()
