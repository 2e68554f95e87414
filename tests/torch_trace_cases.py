"""Commit-trace cases, free of JAX, for every interpreter of the port: the
eager loop on the CPU, the chunk kernel's source compiled for the host
(``tests/test_torch_run_chunk_shim.py``) and the chunk kernel on the card
(``tests/test_torch_gpu.py``).

Each case arms the ring of every target with the same slot count and
capture-window trigger (``repro_torch.telemetry.triggers`` spec tuples),
steps them chunk by chunk through one program and compares them after
every chunk: the whole state, ``tracebuf``/``trace_n``/``trace_armed``
included, and what ``trace_drain`` gives back (with ``PySim`` among the
targets, its drain is the oracle of the records and the drops).
"""
from __future__ import annotations

from repro_torch.core.target import asm

import torch_directed_cases as DC

#: a ring that wraps many times a run, and one that never does
SLOTS_WRAP = 8
SLOTS_WIDE = 4096


def word_at(img, va):
    """The 32-bit instruction word the image holds at ``va``."""
    for seg in img.segments:
        off = va - seg.vaddr
        if 0 <= off < len(seg.data):
            return int.from_bytes(bytes(seg.data[off:off + 4]), "little")
    raise KeyError(hex(va))


def triggers(img):
    """``(id, spec)`` of every trigger kind over a program with a
    ``loop`` label whose third instruction is an ``lr`` and fifth an
    ``sc`` (``tests/test_torch_gpu.py::PROGRAM``): no gate; a pc window
    armed at ``loop`` and disarmed at the ``lr`` (three records an
    iteration); a pc window that never disarms; an instruction window
    from the ``lr`` word to the ``sc`` word; a tick range; an instret
    threshold."""
    loop = img.symbols["loop"]
    return [("none", None),
            ("pc-window", ("pc", loop, loop + 8)),
            ("pc-open", ("pc", loop + 8, None)),
            ("inst-window", ("inst", word_at(img, loop + 8),
                             word_at(img, loop + 16))),
            ("tick", ("tick", 150, 1200)),
            ("instret", ("instret", 40))]


def arm(targets, slots, trigger):
    for t in targets:
        t.trace_arm(slots)
        t.trace_trigger(trigger)


def same_drains(targets, point):
    """Every target's drain gives the same records and drops."""
    got = [t.trace_drain() for t in targets]
    for i, g in enumerate(got[1:], 1):
        assert g == got[0], f"{point}: drain of target {i} differs"
    return got[0]


def run_program(src, nc, chunk, targets, compare, mmu=True):
    """Load ``src`` on ``targets`` (the MMU on), run them ``chunk`` ticks
    at a time to the end of the program, parking each core at its exit,
    and call ``compare(targets, point)`` after every chunk.  Returns the
    records each target drained, per core, over the whole run."""
    img = asm.assemble(src)
    for t in targets:
        DC.load(t, img, nc, mmu=mmu)
    records = [[] for _ in range(nc)]
    for step in range(400):
        for t in targets:
            t.run(max_cycles=chunk)
        compare(targets, f"chunk {step}")
        for c, (recs, _) in enumerate(same_drains(targets, f"chunk {step}")):
            records[c].extend(recs)
        for t in targets:
            for c in t.pending_cores():
                t.clear_pending(c)
                t.park(c)
        if all(t.get_priv(c) == 3 for t in targets for c in range(nc)):
            return records
    raise AssertionError("program did not finish")

