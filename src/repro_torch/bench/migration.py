"""Snapshot and migration economics across the fleet on the port, every
board a target on the card by default.

The twin of the reference's ``benchmarks/migration.py``: four panels in
one file, the same sizes and ``--quick`` cut, each row with its
``wall_s``:

  * ``migration``    — a bc job paused at 70 % of its instructions
    (:func:`_pause_at_instret`), checkpointed over its source link,
    restored over the destination's and run to the end, in full and as a
    pre-copy delta from a base taken at 35 %; the algorithmic output
    equal to the unmigrated run's;
  * ``provisioning`` — billed re-imaging on a skewed two-image mix under
    round-robin, the provision-blind and the provision-aware greedy;
  * ``serving``      — ``qwen3-8b.smoke()`` through the port's
    ``ServeEngine`` with its slots sharded over a PCIe and a far PCIe
    board, sticky against ``least_loaded`` slot migration; the engine
    runs on the CUDA device with ``--target card``, on the host
    otherwise, and both policies must give the same tokens;
  * ``identity``     — a 1-board UART fleet against a plain async
    ``FaseRuntime`` on the same kind of target.

Writes ``results/torch_migration.json``.
"""
from __future__ import annotations

from . import panels
from .fleet_scale import identity_row
from ..configs import CONFIGS
from ..configs.fase_rocket import FASE_FLEET_PROVISION
from ..core.consts import CLOCK_HZ
from ..core.fleet import FleetRuntime, Job
from ..core.workloads import graphgen
from ..serving.engine import Request, ServeEngine

N_CORES = 1
MEM = 1 << 23


def _fleet(links, target, placement="round_robin", provision_us=0.0):
    return FleetRuntime(
        make_target=lambda: panels.make_target(target, N_CORES, MEM),
        n_devices=len(links), links=list(links), placement=placement,
        provision_us=provision_us)


def _algo_output(report) -> bytes:
    """Stdout minus timing-visible lines: ``trial_ns`` comes from
    clock_gettime, i.e. modelled target time — a migrated run
    legitimately prints different timings, but the algorithmic output
    (scores, checksums) must be bit-identical."""
    return b"\n".join(ln for ln in report.stdout.splitlines()
                      if not ln.startswith(b"trial_ns"))


def _pause_at_instret(fr, handle, target_instret: int):
    """Advance a running job in slices until its retired-instruction
    count reaches ``target_instret``; each slice is bounded by the
    instructions still missing (one instruction needs at least one
    tick), so a slice never overshoots the milestone.  One read of the
    board's counter a slice (a host sync on the card)."""
    rt = handle.runtime
    while True:
        cur = rt.target.get_instret(0)
        if cur >= target_instret:
            return
        paused = fr.step_job(
            handle,
            pause_ticks=rt.target.get_ticks() + (target_instret - cur))
        assert paused is None, "job finished before the pause point"


def migration_panel(quick: bool, target: str = "card") -> list:
    g = graphgen.rmat(4 if quick else 5, 8, weights=True)
    # enough trials that the pre-copy's wire time can drain between the
    # base checkpoint and the stop-and-copy point on the fast link
    trials = "4" if quick else "48"
    job_args = (["g.bin", "1", trials], {"g.bin": g})
    rows = []
    for link in ("uart", "pcie"):
        def job():
            return Job("bc", job_args[0], files=dict(job_args[1]))

        def full():
            base = _fleet([link], target)
            b = base.run_job(base.devices[0], job())
            # pause milestones inside the compute phase, by instructions
            # retired
            n_inst = b.report.instret[0]
            i_pre, i_mig = int(n_inst * 0.35), int(n_inst * 0.7)
            fr = _fleet([link, link], target)
            h = fr.start_job(job(), fr.devices[0])
            _pause_at_instret(fr, h, i_mig)
            mig = fr.migrate(h, fr.devices[1])
            return b, (i_pre, i_mig), mig, fr.finish_job(h)
        (b, (i_pre, i_mig), mig, res), w_full = panels.timed(target, full)

        def delta():
            # pre-copy: base checkpoint ships early, downtime pays the delta
            fr2 = _fleet([link, link], target)
            h2 = fr2.start_job(job(), fr2.devices[0])
            _pause_at_instret(fr2, h2, i_pre)
            basesnap = fr2.prepare_migration(h2, fr2.devices[1])
            _pause_at_instret(fr2, h2, i_mig)
            mig_d = fr2.migrate(h2, fr2.devices[1], base=basesnap)
            return mig_d, fr2.finish_job(h2)
        (mig_d, res_d), w_delta = panels.timed(target, delta)

        ok = (_algo_output(res.report) == _algo_output(b.report) ==
              _algo_output(res_d.report))
        rows.append(dict(
            link=link, baseline_ticks=b.report.ticks,
            migrated_ticks=res.report.ticks,
            overhead_ticks=res.report.ticks - b.report.ticks,
            full=dict(pages=mig.pages_shipped, src_bytes=mig.src_bytes,
                      dst_bytes=mig.dst_bytes,
                      downtime_ticks=mig.downtime_ticks),
            delta=dict(pages=mig_d.pages_shipped,
                       pages_total=mig_d.pages_total,
                       src_bytes=mig_d.src_bytes,
                       dst_bytes=mig_d.dst_bytes,
                       downtime_ticks=mig_d.downtime_ticks,
                       # the base shipment's wire time had not drained
                       # off the links when the job paused, so the
                       # measured downtime still queues behind it
                       precopy_queued=(mig_d.downtime_ticks >=
                                       mig.downtime_ticks)),
            output_identical=ok, wall_s=w_full + w_delta))
        print(f"migration,bc@{link},{mig.downtime_ticks},"
              f"full {mig.src_bytes}+{mig.dst_bytes}B "
              f"delta {mig_d.src_bytes}+{mig_d.dst_bytes}B "
              f"({mig_d.pages_shipped}/{mig_d.pages_total} pages) "
              f"delta_downtime {mig_d.downtime_ticks} ok={ok} "
              f"({target} {w_full + w_delta:.2f}s)", flush=True)
    return rows


def provisioning_panel(quick: bool, target: str = "card") -> list:
    """Skewed two-image mix under billed provisioning: the aware greedy
    keeps same-image jobs on warm boards; the blind one re-flashes."""
    g = graphgen.rmat(4 if quick else 5, 8, weights=True)
    prov_us = FASE_FLEET_PROVISION["provision_us"]
    reps = 3 if quick else 4
    rows = []
    for policy in ("round_robin", "least_loaded_blind", "least_loaded"):
        fr = _fleet(["pcie", "pcie"], target, placement=policy,
                    provision_us=prov_us)
        for _ in range(reps):
            fr.submit(Job("bc", ["g.bin", "1", "1"],
                          files={"g.bin": g}))
            fr.submit(Job("hello"), replicas=2)
        rep, wall = panels.timed(target, fr.run)
        provisions = sum(d.stats.provisions for d in fr.devices)
        prov_ticks = sum(d.stats.provision_ticks for d in fr.devices)
        rows.append(dict(
            policy=policy, provision_us=prov_us,
            makespan_ticks=rep.makespan_ticks, provisions=provisions,
            provision_ticks=prov_ticks, balance=rep.balance,
            assignment=[(r.job.job_id, r.device_id) for r in rep.jobs],
            wall_s=wall))
        print(f"provisioning,{policy},{rep.makespan_ticks},"
              f"{provisions} flashes / {prov_ticks} ticks "
              f"({target} {wall:.2f}s)", flush=True)
    return rows


def serving_panel(quick: bool, target: str = "card") -> list:
    cfg = CONFIGS["qwen3-8b"].smoke()
    device = panels.torch_device(target)
    params = panels.lm_params(cfg, device)
    n_req = 8 if quick else 16
    max_new = 24
    outs = {}
    rows = []
    for policy in ("sticky", "least_loaded"):
        fr = _fleet(["pcie", "pcie_far"], target)
        # rebalance early: slots are cheapest to move while their KV
        # residency is still a page or two
        eng = ServeEngine(cfg, params, slots=8, max_seq=128,
                          poll_every=4, fleet=fr, slot_policy=policy,
                          rebalance_every=2, device=device)
        for i in range(n_req):
            eng.submit(Request(rid=i, prompt=[3 + i % 5, 7, 11, 2],
                               max_new=max_new, eos=1))
        done, wall = panels.timed(target, eng.run)
        outs[policy] = sorted((r.rid, tuple(r.out)) for r in done)
        mean_span = sum(eng.step_spans) / max(len(eng.step_spans), 1)
        rows.append(dict(
            policy=policy, links=["pcie", "pcie_far"], slots=8,
            requests=n_req, steps=eng.steps,
            makespan_ticks=eng.link_tick, mean_step_span=mean_span,
            slot_migrations=eng.slot_migrations,
            migrate_bytes=eng.traffic.by_cat.get("slot_migrate", 0),
            wall_s=wall))
        print(f"serving_migration,{policy},{eng.link_tick},"
              f"mean step {mean_span:.0f} ticks, "
              f"{eng.slot_migrations} moves ({target} {wall:.2f}s)",
              flush=True)
    assert outs["sticky"] == outs["least_loaded"], \
        "slot migration changed tokens"
    return rows


def identity_panel(target: str = "card") -> dict:
    fr = _fleet(["uart"], target)
    return identity_row(
        "migration_identity",
        lambda: fr.run_job(fr.devices[0], Job("hello")).report, target)


def run(quick=False, target="card", out_dir=None):
    mig = migration_panel(quick, target)
    prov = provisioning_panel(quick, target)
    serv = serving_panel(quick, target)
    ident = identity_panel(target)
    out = dict(quick=quick, clock_hz=CLOCK_HZ, migration=mig,
               provisioning=prov, serving=serv, uart_identical=ident)
    panels.save_json("migration", out, target, quick, out_dir)
    aware = next(r for r in prov if r["policy"] == "least_loaded")
    blind = next(r for r in prov if r["policy"] == "least_loaded_blind")
    print(f"migration,summary,{mig[-1]['full']['downtime_ticks']},"
          f"pcie downtime ticks; provision-aware vs blind makespan "
          f"{aware['makespan_ticks']}/{blind['makespan_ticks']}; "
          f"serving {serv[1]['makespan_ticks']}/"
          f"{serv[0]['makespan_ticks']} "
          f"(uart_identical={ident['identical']})", flush=True)
    return out


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, ["migration"]))
