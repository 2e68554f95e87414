"""Paper Table IV on the port: the stall decomposition (controller / link
/ runtime) of BC across threads, links and sessions, and the queue-pair
overlap claim, on the card by default.

The twin of the reference's ``benchmarks/stall_breakdown.py``: the same
rows (one per threads, link and session), sizes and ``--quick`` cut, each
row with its ``wall_s``.  Writes ``results/torch_stall_breakdown.json``
and ``results/torch_cq_overlap.json``.
"""
from __future__ import annotations

from . import panels
from ..configs.fase_rocket import FASE_ROCKET, FASE_ROCKET_PCIE, \
    runtime_kwargs
from ..core.consts import CLOCK_HZ
from ..core.workloads import graphgen

LINKS = ("uart", "pcie", "oracle")
SESSIONS = ("sync", "async")


def _qp_kwargs(link: str, sess: str) -> dict:
    """Queue-pair knobs from the registry target configs: the PCIe run
    uses FASE_ROCKET_PCIE's tuned depth/coalescing, everything else the
    base FASE_ROCKET values (inert off the pipelined link)."""
    cfg = FASE_ROCKET_PCIE if link == "pcie" else FASE_ROCKET
    kw = runtime_kwargs(cfg)
    kw.pop("link", None)          # the sweep axis overrides the config
    kw["session"] = sess
    return kw


def run(quick=False, target="card", out_dir=None):
    g = graphgen.rmat(5 if quick else 6, 8, weights=True)
    threads = [1] if quick else [1, 4]

    def ms(ticks):
        return ticks / CLOCK_HZ * 1e3
    rows = []
    by_key = {}
    for t in threads:
        for link in LINKS:
            for sess in SESSIONS:
                rt, rep, wall = panels.run_workload(
                    "bc", ["g.bin", str(t), "2"], target, mode="fase",
                    files={"g.bin": g}, link=link, **_qp_kwargs(link, sess))
                row = dict(threads=t, link=link, session=sess,
                           controller_ms=ms(rep.stall["controller_cycles"]),
                           link_ms=ms(rep.stall["uart_ticks"]),
                           runtime_ms=ms(rep.stall["runtime_ticks"]),
                           total_ticks=rep.ticks, cq=rep.cq, wall_s=wall)
                rows.append(row)
                by_key[(t, link, sess)] = rep
                print(f"stall_breakdown,bc-{t}T@{link}/{sess},"
                      f"{row['link_ms']:.2f},"
                      f"ctrl={row['controller_ms']:.3f}ms "
                      f"runtime={row['runtime_ms']:.1f}ms "
                      f"ticks={rep.ticks} ({target} {wall:.2f}s)",
                      flush=True)
    panels.save_json("stall_breakdown", rows, target, quick, out_dir)

    # queue-pair overlap claim: multi-core run on the pipelined link
    t = threads[-1]
    sync_rep = by_key[(t, "pcie", "sync")]
    async_rep = by_key[(t, "pcie", "async")]
    saved = sync_rep.ticks - async_rep.ticks
    overlap = dict(
        workload=f"bc-{t}T", link="pcie",
        depth=FASE_ROCKET_PCIE["qp_depth"],
        coalesce_ticks=FASE_ROCKET_PCIE["qp_coalesce_ticks"],
        sync_ticks=sync_rep.ticks, async_ticks=async_rep.ticks,
        ticks_saved=saved,
        improvement_pct=100.0 * saved / max(sync_rep.ticks, 1),
        uart_identical=(by_key[(t, "uart", "sync")].ticks ==
                        by_key[(t, "uart", "async")].ticks),
        cq=async_rep.cq,
    )
    panels.save_json("cq_overlap", overlap, target, quick, out_dir)
    print(f"cq_overlap,bc-{t}T@pcie,{saved},"
          f"{overlap['improvement_pct']:.4f}% fewer ticks "
          f"(hidden={async_rep.cq.get('latency_hidden', 0)} "
          f"coalesced={async_rep.cq.get('coalesced', 0)}) "
          f"uart_identical={overlap['uart_identical']}", flush=True)
    return rows, overlap


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__,
                                 ["stall_breakdown", "cq_overlap"]))
