"""Paper §IV-B on the port: HTP cuts link traffic >95% vs direct per-port
access (the analytic per-op table, and end to end on hello and on a
page-heavy workload), on the card by default.

The twin of the reference's ``benchmarks/htp_vs_direct.py``: the same
rows, sizes and ``--quick`` cut, each end-to-end row with its ``wall_s``
(both runs, HTP and direct); ``--link`` picks the channel backend.  Writes
``results/torch_htp_vs_direct.json``.
"""
from __future__ import annotations

from . import panels
from ..core import htp

# mmap + touch + munmap churn: every page costs one PageS (zero), one MemW
# (PTE), and the fault-path control requests — the traffic mix of Fig 13
# (the reference panel's own workload, kept here as the port's copy)
PAGE_HEAVY = r"""
main:
    addi sp, sp, -16
    sd ra, 8(sp)
    li s1, {rounds}
1:
    li a0, 0
    li a1, 262144              # 64 pages
    li a2, 3
    li a3, 0x22
    li a4, -1
    li a5, 0
    call mmap6
    mv s0, a0
    li t1, 0
2:
    li t2, 262144
    bgeu t1, t2, 3f
    add t3, s0, t1
    sd t1, 0(t3)               # touch one word per page
    li t4, 4096
    add t1, t1, t4
    j 2b
3:
    mv a0, s0
    li a1, 262144
    call munmap
    addi s1, s1, -1
    bnez s1, 1b
    li a0, 0
    ld ra, 8(sp)
    addi sp, sp, 16
    ret
"""


def end_to_end(workload_src, argv, link, target="card"):
    """Total link bytes of one run with HTP and one with direct per-port
    access: ``({False: htp, True: direct}, wall seconds of both)``."""
    from ..core.runtime import FaseRuntime
    from ..core.target import asm
    from ..core.workloads import build
    from ..core.workloads.libc import LIBC
    tot, wall = {}, 0.0
    for direct in (False, True):
        rt = FaseRuntime(panels.make_target(target, 1, 1 << 23),
                         mode="fase", direct_mode=direct, link=link)
        if workload_src is None:
            rt.load(build(argv[0]), argv)
        else:
            rt.load(asm.assemble(LIBC + "\n.text\n" + workload_src), argv)
        rep, w = panels.run_runtime(rt, target)
        tot[direct] = rep.traffic_total
        wall += w
    return tot, wall


def run(quick=False, link="uart", target="card", out_dir=None):
    rows = []
    for name in ("Redirect", "Next", "MemW", "PageS", "PageCP", "PageW"):
        spec = htp.SPECS[name]
        d = htp.direct_bytes(name)
        rows.append(dict(op=name, htp=spec.total_bytes, direct=d,
                         ratio=spec.total_bytes / d, wall_s=None))
        print(f"htp_vs_direct,{name},{spec.total_bytes},"
              f"{100*(1-spec.total_bytes/d):.1f}% saved", flush=True)
    page_heavy = PAGE_HEAVY.format(rounds=1 if quick else 4)
    for label, src, argv in (
            ("hello", None, ["hello"]),
            ("page_heavy", page_heavy, ["page_heavy"])):
        tot, wall = end_to_end(src, argv, link, target)
        redu = 1 - tot[False] / tot[True]
        rows.append(dict(op=f"end_to_end_{label}", link=link,
                         htp=tot[False], direct=tot[True],
                         ratio=tot[False] / tot[True], wall_s=wall))
        print(f"htp_vs_direct,end-to-end-{label}@{link},{tot[False]},"
              f"{redu*100:.1f}% saved ({target} {wall:.2f}s)", flush=True)
    panels.save_json("htp_vs_direct", rows, target, quick, out_dir)
    return rows


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, ["htp_vs_direct"],
                                 links=True))
