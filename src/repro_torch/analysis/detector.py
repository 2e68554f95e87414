"""Happens-before race detection over an HTP transaction trace.

The async completion-queue engine (:mod:`repro_torch.core.cq`) and the fleet
router deliberately let independent transactions overlap in modelled
time.  *Independent* is a claim — this module checks it.  From a
recorded :class:`~repro_torch.analysis.trace.HtpTrace` it reconstructs the
happens-before partial order the engine actually guarantees and reports
every pair of HB-unordered requests whose footprints conflict
(:mod:`repro_torch.analysis.footprints`): the modelled device could execute
them in either order, so a conflicting pair is a real protocol race —
a page write racing a sibling stream's fetch, a snapshot capture racing
an in-flight fault batch, a FlushTLB unordered against the redirect it
should precede.

Happens-before edges
--------------------

  1. **Program order** per ordering domain: a submission stream of a
     pipelined queue pair, or the whole session when the engine used the
     serial (synchronous) arithmetic — one wire executes transactions
     back-to-back, so a serial session is a single chain.
  2. **Dependency tokens**: ``submit(..., deps=(tok,))`` orders the
     producer before the consumer.  ``tail_tokens()`` barriers and the
     snapshot/migration fences are just dense instances of this edge.
  3. **Modelled-time fences** (``time_fences=True``, default): if
     transaction A's completion tick is ≤ transaction B's post-deps
     submit tick, A is over before B can begin in *every* timeline the
     model admits — the host observed A's completion and scheduled B
     after it.  This is what makes the sequential host runtime's
     cross-stream chaining (``t = res.done; submit(..., t, ...)``)
     count as synchronisation.  Disable it to audit pure token/stream
     discipline (the seeded-hazard corpus runs both ways).

Edges 1–2 are closed transitively with per-domain vector clocks; edge 3
is checked directly on the candidate pair (it composes with 1–2 through
the conservative pair test, which is sound: a missed fence can only
*add* a reported race, never hide one).
"""
from __future__ import annotations

from dataclasses import dataclass

from .trace import HtpTrace, TraceEvent

#: hazard taxonomy: footprint-location kind -> finding kind
_KIND = {"mem": "page-race", "reg": "reg-race", "csr": "csr-race",
         "tlb": "tlb-race", "icache": "fetch-race",
         "hfutex": "hfutex-race", "clock": "clock-race",
         "uticks": "clock-race", "vpage": "serve-race",
         "vslot": "serve-race", "tracebuf": "telem-race",
         "nicq": "net-race"}


@dataclass(frozen=True)
class Access:
    """One request's touch of one location."""

    event: TraceEvent
    req_idx: int
    op: str
    write: bool


@dataclass(frozen=True)
class Finding:
    """One HB-unordered conflicting pair."""

    kind: str                     # taxonomy bucket (page-race, …)
    loc: tuple                    # canonical conflicting location
    a: Access
    b: Access

    def __str__(self):
        ea, eb = self.a.event, self.b.event
        return (f"{self.kind} at {self.loc}: "
                f"{self.a.op}[{self.a.req_idx}] in {ea} "
                f"{'writes' if self.a.write else 'reads'} vs "
                f"{self.b.op}[{self.b.req_idx}] in {eb} "
                f"{'writes' if self.b.write else 'reads'} "
                f"(no happens-before edge)")


def _canonical(loc):
    """Canonical reporting key for a location (mem folds to the page)."""
    if loc[0] == "mem":
        return ("mem", loc[1])
    return loc


def _finding_kind(loc, a: Access, b: Access) -> str:
    kind = _KIND.get(loc[0], loc[0])
    # a page write unordered against a Redirect's implicit fetch of the
    # same page is the fetch-vs-page-write hazard, not a data race
    if kind == "page-race" and ("Redirect" in (a.op, b.op)):
        return "fetch-race"
    return kind


class _VectorClocks:
    """Per-domain vector clocks over program order + dependency edges."""

    def __init__(self, trace: HtpTrace):
        self.dom_ix: dict = {}
        self.vc: list = []            # eid -> tuple clock
        by_token: dict = {}
        tails: dict = {}              # domain -> eid of last event
        for ev in trace.events:
            di = self.dom_ix.setdefault(ev.stream, len(self.dom_ix))
            clock: dict = {}
            prev = tails.get(ev.stream)
            if prev is not None:
                clock.update(self._at(prev))
            for dep in ev.dep_ids:
                producer = by_token.get(dep)
                if producer is not None:
                    for k, v in self._at(producer).items():
                        if v > clock.get(k, -1):
                            clock[k] = v
            clock[di] = ev.seq
            self.vc.append(clock)
            tails[ev.stream] = ev.eid
            if ev.token_id is not None:
                by_token[ev.token_id] = ev.eid

    def _at(self, eid: int) -> dict:
        return self.vc[eid]

    def ordered(self, a: TraceEvent, b: TraceEvent) -> bool:
        """Is the pair HB-ordered (either direction) by PO + deps?"""
        da = self.dom_ix[a.stream]
        if self.vc[b.eid].get(da, -1) >= a.seq:
            return True               # a happens-before b
        db = self.dom_ix[b.stream]
        return self.vc[a.eid].get(db, -1) >= b.seq


def _pair_ordered(a: TraceEvent, b: TraceEvent, vcs: _VectorClocks,
                  time_fences: bool) -> bool:
    if a.eid == b.eid or a.stream == b.stream:
        return True                   # intra-transaction / program order
    if time_fences and (a.done <= b.ready or b.done <= a.ready):
        return True                   # modelled-time fence
    return vcs.ordered(a, b)


def _collect_accesses(trace: HtpTrace) -> tuple:
    """Returns ``(groups, mem_sub)``: location-group key -> [Access],
    plus the sub-word index per memory access.  Memory groups by page so
    that whole-page and word accesses meet; ``mem_sub`` carries the word
    index for the overlap test.  Group keys are ``(device, location)``
    — physical state is per-board, so in a shared fleet trace page 5 of
    device 0 never falsely conflicts with page 5 of device 1 (the only
    cross-device flows, snapshot migration, move through host memory)."""
    groups: dict = {}
    mem_sub: dict = {}                # (eid, req_idx, write) -> widx
    for ev in trace.events:
        for i, req in enumerate(ev.requests):
            reads, writes = req.footprint()
            for locs, write in ((reads, False), (writes, True)):
                for loc in locs:
                    key = (ev.device, _canonical(loc))
                    acc = Access(ev, i, req.op, write)
                    groups.setdefault(key, []).append(acc)
                    if loc[0] == "mem":
                        mem_sub[(ev.eid, i, write)] = loc[2]
    return groups, mem_sub


def detect(trace: HtpTrace, time_fences: bool = True,
           max_findings: int = 256) -> list[Finding]:
    """All HB-unordered conflicting request pairs in ``trace``."""
    if not trace.events:
        return []
    vcs = _VectorClocks(trace)
    groups, mem_sub = _collect_accesses(trace)
    findings: list[Finding] = []
    seen: set = set()
    for key, accesses in groups.items():
        if len(accesses) < 2 or not any(a.write for a in accesses):
            continue
        loc = key[1]                  # (device, location) group key
        is_mem = loc[0] == "mem"
        # sweep in post-deps submit-tick order; with fences on, accesses
        # whose events already completed drop out of the active window
        accesses = sorted(accesses,
                          key=lambda a: (a.event.ready, a.event.eid))
        active: list[Access] = []
        for b in accesses:
            if time_fences:
                active = [a for a in active
                          if a.event.done > b.event.ready]
            for a in active:
                if not (a.write or b.write):
                    continue
                # an advisory *read* (live pre-copy capture) is allowed
                # to race: a later fenced capture supersedes its value
                if (a.event.advisory and not a.write) or \
                        (b.event.advisory and not b.write):
                    continue
                if is_mem:
                    wa = mem_sub[(a.event.eid, a.req_idx, a.write)]
                    wb = mem_sub[(b.event.eid, b.req_idx, b.write)]
                    if wa is not None and wb is not None and wa != wb:
                        continue
                if _pair_ordered(a.event, b.event, vcs, time_fences):
                    continue
                pair = (min(a.event.eid, b.event.eid),
                        max(a.event.eid, b.event.eid), key)
                if pair in seen:
                    continue
                seen.add(pair)
                first, second = (a, b) if a.event.eid <= b.event.eid \
                    else (b, a)
                findings.append(Finding(_finding_kind(loc, first, second),
                                        loc, first, second))
                if len(findings) >= max_findings:
                    return findings
            active.append(b)
    return findings


def summarize(findings: list[Finding]) -> dict:
    """Counts per taxonomy bucket (CLI / report surface)."""
    out: dict = {}
    for f in findings:
        out[f.kind] = out.get(f.kind, 0) + 1
    return out
