"""Program loader: places an assembled :class:`~repro_torch.core.target.asm.Image`
into target memory through HTP page writes (the paper's workload-loading
phase, visible in Fig 19(b)'s intercept), builds the Linux-ABI initial
stack (argc/argv/envp/auxv) and the initial brk.
"""
from __future__ import annotations

import numpy as np

from ..session import HtpTransaction
from .vm import (PAGE, PROT_EXEC, PROT_READ, PROT_WRITE, STACK_TOP)

MAIN_STACK_BYTES = 256 * 1024


def load_image(rt, image, argv: list[str], envp: list[str] | None = None):
    """Returns (entry, sp, brk_base).  All traffic accounted as 'load'."""
    vm = rt.vm
    t = 0
    for seg in image.segments:
        prot = PROT_READ | (PROT_EXEC if "x" in seg.flags else PROT_WRITE)
        vm.map_segment(seg.vaddr, len(seg.data), prot, "anon")
        t = vm.write_bytes(seg.vaddr, bytes(seg.data), 0, t, "load")
    bss_end = max(s.vaddr + len(s.data) for s in image.segments)
    if image.bss:
        bss_va, bss_sz = image.bss
        vm.map_segment(bss_va, bss_sz, PROT_READ | PROT_WRITE, "anon")
        t = vm.ensure_mapped(bss_va, bss_sz, 0, t, want_write=True)
        bss_end = max(bss_end, bss_va + bss_sz)
    vm.brk_base = vm.brk = (bss_end + PAGE - 1) & ~(PAGE - 1)

    # main stack
    stack_lo = STACK_TOP - MAIN_STACK_BYTES
    vm.map_segment(stack_lo, MAIN_STACK_BYTES, PROT_READ | PROT_WRITE,
                   "anon")

    # Linux ABI initial stack: strings block then argc/argv/envp/auxv
    envp = envp or []
    blob = bytearray()
    offs = []
    for s in argv + envp:
        offs.append(len(blob))
        blob += s.encode() + b"\0"
    str_base = (STACK_TOP - len(blob) - 64) & ~0xF   # headroom for cstr reads
    ptrs = [str_base + o for o in offs]
    vec = [len(argv)]
    vec += ptrs[:len(argv)] + [0]
    vec += ptrs[len(argv):] + [0]
    vec += [0, 0]                      # AT_NULL auxv
    vec_bytes = b"".join(int(v).to_bytes(8, "little") for v in vec)
    sp = (str_base - len(vec_bytes)) & ~0xF
    t = vm.write_bytes(sp, vec_bytes, 0, t, "load")
    if blob:
        t = vm.write_bytes(str_base, bytes(blob), 0, t, "load")

    # point every core's MMU at the new tables: one SetMMU batch
    txn = HtpTransaction()
    for c in range(rt.target.n_cores):
        txn.set_mmu(c, vm.satp, "load")
    t = rt.session.submit(txn, t).done
    rt.load_ticks = t
    return image.entry, sp, t
