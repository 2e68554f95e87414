"""Interpreter throughput on the port: guest instructions per second of
GAPBS bc under the full FASE runtime, on the card by default.

The twin of the reference's ``benchmarks/target_speed.py``: the same
workload (bc, 4 threads on 4 cores, 8 MiB, oracle mode, the registry's
``target_kwargs(FASE_ROCKET)``; ``rmat(9,8)``, ``rmat(5,8)`` under
``--quick``), the same warm-up and windows, and its procedure: modelled-
tick slices through ``FaseRuntime.run_slice`` (the fleet row's lockstep
through ``chunk_begin``/``chunk_end``), the clock on the window alone,
stopped on the card after ``torch.cuda.synchronize()``.  Each row names
the reference row it stands for (``reference_row``):

  * ``kernel``         (``jax_fast``)         — ``TorchTarget`` on the
    card: one ``run_chunk`` launch a chunk;
  * ``kernel_nocache`` (``jax_fast_nocache``) — the same with
    ``block_cache=False``: every fetch walks;
  * ``eager``          (``jax_slow``)         — the chunk kernel's plain
    version, the eager loop (``chunk_kernel="ref"``), with the standalone
    ``walk_fetch_block`` launched once a substep (the port has no scalar
    loop: the plain version of the fast path is its slow row);
  * ``pysim``          (``pysim``)            — the port's PySim;
  * ``fleet_x4``       (``fleet_vmap_x4``)    — four boards in one stacked
    ``FleetTarget``, one ``run_chunk_fleet`` launch a global chunk.

Each row also counts, over its window, its target's ``run`` calls and
substeps and each kernel's launches: on the card a kernel row launches
``run_chunk`` once a ``run``, ``eager`` launches ``walk_fetch_block`` once
a substep, and ``fleet_x4`` launches ``run_chunk_fleet`` once a dispatch;
the run exits 1 where they do not.  ``--target cpu`` runs the torch rows
on the host (the eager loop for every one of them; for tests) and
``--target pysim`` every row on the port's PySim (the modelled numbers
alone).  As in the reference, ``--quick`` on the card exits 1 if the
``kernel`` row's ips is below the ``eager`` row's, or if
``kernel_vs_eager_speedup`` is under the floor of the card's baseline in
``results/torch_target_speed.json`` (0.5x a quick baseline, 0.25x a full
one).  ``--against DIR`` holds each row's modelled fields (:data:`ROW_KEYS`,
and the cut's :data:`TOP_KEYS`) against the row of ``DIR/target_speed.json``
it names and the row of ``DIR/torch_target_speed.json`` of its name,
tolerance 0, and exits 1 on a difference.  Writes
``results/torch_target_speed.json``.
"""
from __future__ import annotations

import json
import os
import sys

from . import panels
from ..configs.fase_rocket import FASE_ROCKET, target_kwargs
from ..core.runtime import FaseRuntime
from ..core.target.pysim import PySim
from ..core.workloads import build, graphgen

THREADS = 4
N_CORES = 4
MEM = 1 << 23
FLEET_DEVICES = 4
#: the registry target config is the baseline; each row overrides one knob
CFG = target_kwargs(FASE_ROCKET)
#: ``TorchTarget``'s and ``FleetTarget``'s default chunk: the fleet row's
#: budget a global chunk, on PySim boards too
CHUNK_CYCLES = 1 << 30
#: where the rows run: the card, ``TorchTarget`` on the host, PySim
TARGETS = ("card", "cpu", "pysim")
#: the single-board torch rows: (name, reference row, knobs over CFG)
TORCH_ROWS = (("kernel", "jax_fast", {}),
              ("kernel_nocache", "jax_fast_nocache", {"block_cache": False}),
              ("eager", "jax_slow", {"chunk_kernel": "ref"}))
#: a row's modelled fields, and the cut's, that ``--against`` compares
ROW_KEYS = ("instructions", "ticks", "finished", "dispatches", "n_devices")
TOP_KEYS = ("workload", "warm_ticks", "n_cores")


def _instret(tgt):
    return sum(tgt.get_instret(c) for c in range(tgt.n_cores))


def _load(rt, g):
    rt.load(build("bc"), ["bc", "g.bin", str(THREADS), "1"],
            files={"g.bin": g})


def _counters():
    """The kernels of the rows' paths, by name (each wrapper's
    ``launches``)."""
    from ..kernels.page_walk import page_walk
    from ..kernels.run_chunk import run_chunk as RC
    return {"run_chunk": RC.run_chunk, "run_chunk_fleet": RC.run_chunk_fleet,
            "walk_fetch_block": page_walk.walk_fetch_block}


def _launches(counters, since=None):
    """Each counter's launches, or those since the reading ``since`` (the
    counters are never set back: a caller may be counting the whole
    run)."""
    now = {name: c.launches for name, c in counters.items()}
    return now if since is None else {k: now[k] - since[k] for k in now}


def _count_runs(tgt):
    """``tgt`` with its ``run`` calls counted in ``tgt.runs``."""
    run = tgt.run

    def counted(max_cycles=1 << 62):
        tgt.runs += 1
        run(max_cycles)
    tgt.runs = 0
    tgt.run = counted
    return tgt


def _measure(name, reference_row, make_target, g, warm_ticks, meas_ticks,
             target):
    tgt = _count_runs(make_target())
    rt = FaseRuntime(tgt, mode="oracle")
    _load(rt, g)
    paused = rt.run_slice(warm_ticks, max_ticks=1 << 40)   # build + boot
    t0, i0 = tgt.get_ticks(), _instret(tgt)
    runs0, sub0 = tgt.runs, getattr(tgt, "substeps", 0)
    finished = paused is not None
    wall = 0.0
    counters = _counters()
    before = _launches(counters)        # just before the window
    if not finished:
        rep, wall = panels.timed(
            target, lambda: rt.run_slice(t0 + meas_ticks, max_ticks=1 << 40))
        finished = rep is not None
    launches = _launches(counters, before)   # just after it
    insts = _instret(tgt) - i0
    ips = insts / wall if wall > 0 else 0.0
    row = dict(name=name, reference_row=reference_row, instructions=insts,
               wall_s=round(wall, 3), ips=round(ips, 1),
               ticks=tgt.get_ticks() - t0, finished=finished,
               runs=tgt.runs - runs0)
    if not isinstance(tgt, PySim):
        row.update(substeps=tgt.substeps - sub0, launches=launches)
    print(f"target_speed,{name},{ips:.0f},instr={insts} "
          f"wall={wall:.2f}s ({target})", flush=True)
    return row


class PySimFleet:
    """The fleet row's stacked target on PySim boards: ``run_global`` runs
    each board of a non-zero budget up to it (``FleetTarget``'s clip to
    the chunk included), one dispatch a call."""

    def __init__(self, n_devices, n_cores, mem_bytes,
                 chunk_cycles=CHUNK_CYCLES):
        self.chunk_cycles = chunk_cycles
        self.boards = [PySim(n_cores, mem_bytes, chunk_cycles)
                       for _ in range(n_devices)]
        self.dispatch_count = 0

    def view(self, d):
        return self.boards[d]

    def run_global(self, budgets):
        for t, b in zip(self.boards, budgets):
            if b:
                t.run(min(int(b), self.chunk_cycles))
        self.dispatch_count += 1


def _measure_fleet(g, warm_ticks, meas_ticks, target,
                   n_devices=FLEET_DEVICES):
    """Aggregate throughput of ``n_devices`` boards running bc at once in
    one stacked target: every global chunk of the window is one call (on
    the card one ``run_chunk_fleet`` launch)."""
    if target == "pysim":
        ft = PySimFleet(n_devices, N_CORES, MEM)
    else:
        from ..core.fleet.vmap import FleetTarget
        ft = FleetTarget(n_devices, N_CORES, MEM, CHUNK_CYCLES,
                         device=panels.torch_device(target), **CFG)
    rts = []
    for d in range(n_devices):
        rt = FaseRuntime(ft.view(d), mode="oracle")
        _load(rt, g)
        rts.append(rt)
    for rt in rts:                                  # build + boot (one-hot)
        rt.run_slice(warm_ticks, max_ticks=1 << 40)
    base = [(rt.target.get_ticks(), _instret(rt.target)) for rt in rts]
    d0 = ft.dispatch_count
    counters = _counters()

    def lockstep():                     # one dispatch a global chunk
        live = [True] * n_devices
        budgets = [0] * n_devices
        while any(live):
            budgets[:] = [0] * n_devices
            for d, rt in enumerate(rts):
                if not live[d]:
                    continue
                if rt.target.get_ticks() - base[d][0] >= meas_ticks:
                    live[d] = False
                    continue
                want = rt.chunk_begin()
                if want is None:
                    live[d] = False
                elif want:
                    budgets[d] = rt.target.chunk_cycles
            if any(budgets):
                ft.run_global(budgets)
                for d, rt in enumerate(rts):
                    if budgets[d]:
                        rt.chunk_end()
    before = _launches(counters)
    _, wall = panels.timed(target, lockstep)
    launches = _launches(counters, before)
    insts = sum(_instret(rt.target) - b[1] for rt, b in zip(rts, base))
    ips = insts / wall if wall > 0 else 0.0
    name = f"fleet_x{n_devices}"
    row = dict(name=name, reference_row=f"fleet_vmap_x{n_devices}",
               instructions=insts, wall_s=round(wall, 3), ips=round(ips, 1),
               ticks=max(rt.target.get_ticks() - b[0]
                         for rt, b in zip(rts, base)),
               dispatches=ft.dispatch_count - d0, n_devices=n_devices,
               finished=True)
    if target != "pysim":
        row.update(launches=launches)
    print(f"target_speed,{name},{ips:.0f},instr={insts} wall={wall:.2f}s "
          f"dispatches={row['dispatches']} ({target})", flush=True)
    return row


def card_baseline():
    """The result of ``results/torch_target_speed.json`` where a run on the
    card wrote it, else None."""
    try:
        with open(os.path.join(panels.RESULTS_DIR,
                               "torch_target_speed.json")) as f:
            saved = json.load(f)
    except OSError:
        return None
    return saved["result"] if saved.get("target") == "card" else None


def launch_faults(out) -> list:
    """Where a card row's launches are not what its path makes: one
    ``run_chunk`` a ``run`` on the kernel rows, one ``walk_fetch_block`` a
    substep on ``eager``, one ``run_chunk_fleet`` a dispatch on the fleet
    row, and no other."""
    want = {"kernel": lambda r: dict(run_chunk=r["runs"]),
            "kernel_nocache": lambda r: dict(run_chunk=r["runs"]),
            "eager": lambda r: dict(walk_fetch_block=r["substeps"]),
            f"fleet_x{FLEET_DEVICES}":
            lambda r: dict(run_chunk_fleet=r["dispatches"])}
    bad = []
    for r in out["rows"]:
        if r["name"] not in want:
            continue
        expect = dict.fromkeys(r["launches"], 0)
        expect.update(want[r["name"]](r))
        if r["launches"] != expect or not any(expect.values()):
            bad.append(f"target_speed: row {r['name']} launched "
                       f"{r['launches']}, not {expect}")
    return bad


def gate(out, baseline) -> list:
    """The reference's quick gate: the kernel row no slower than the eager
    row, and the speedup over the baseline's floor."""
    by = {r["name"]: r for r in out["rows"]}
    speedup = by["kernel"]["ips"] / max(by["eager"]["ips"], 1e-9)
    bad = []
    if by["kernel"]["ips"] < by["eager"]["ips"]:
        bad.append("target_speed: KERNEL ROW SLOWER THAN EAGER ROW")
    if baseline and baseline.get("kernel_vs_eager_speedup"):
        ref = baseline["kernel_vs_eager_speedup"]
        floor = ref * (0.5 if baseline.get("quick") else 0.25)
        if speedup < floor:
            bad.append(f"target_speed: SPEEDUP {speedup:.1f} REGRESSED "
                       f"BELOW BASELINE FLOOR {floor:.1f} (baseline "
                       f"{ref:.1f})")
    return bad


def run(quick=False, target="card", out_dir=None, scale=None,
        warm_ticks=None, fast_ticks=None, slow_ticks=None,
        pysim_ticks=None):
    """Every row at the reference's cut (each number a keyword, the
    reference's by default); writes ``torch_target_speed.json`` and exits
    1 on a launch fault on the card, or where the quick gate fails there."""
    if target not in TARGETS:
        raise ValueError(f"target must be one of {TARGETS}, got {target!r}")
    baseline = card_baseline()
    scale = scale or (5 if quick else 9)
    fast = fast_ticks or (100_000 if quick else 400_000)
    slow = slow_ticks or (8_000 if quick else 12_000)
    sim = pysim_ticks or (4_000_000 if quick else 16_000_000)
    # full size warms past bc's serial graph-load prefix, as the reference
    warm = warm_ticks or (3_000 if quick else 60_000)
    g = graphgen.rmat(scale, 8, weights=True)

    def torch_row(opts):
        if target == "pysim":
            return lambda: PySim(N_CORES, MEM)
        from ..core.interface import TorchTarget
        return lambda: TorchTarget(N_CORES, MEM, CHUNK_CYCLES,
                                   device=panels.torch_device(target),
                                   **{**CFG, **opts})
    rows = [_measure(name, ref, torch_row(opts), g, warm,
                     slow if name == "eager" else fast, target)
            for name, ref, opts in TORCH_ROWS]
    rows += [_measure("pysim", "pysim", lambda: PySim(N_CORES, MEM), g, warm,
                      sim, "pysim"),
             _measure_fleet(g, warm, fast, target)]
    by = {r["name"]: r for r in rows}
    speedup = by["kernel"]["ips"] / max(by["eager"]["ips"], 1e-9)
    fleet = by[f"fleet_x{FLEET_DEVICES}"]
    fleet_vs_one = fleet["ips"] / max(by["kernel"]["ips"], 1e-9)
    out = dict(quick=quick, workload=f"bc rmat{scale} {THREADS}T",
               warm_ticks=warm, n_cores=N_CORES,
               windows=dict(fast=fast, slow=slow, pysim=sim), rows=rows,
               kernel_vs_eager_speedup=round(speedup, 2),
               fleet_aggregate_vs_one_board=round(fleet_vs_one, 2))
    path = panels.save_json("target_speed", out, target, quick, out_dir)
    print(f"target_speed,speedup,{speedup:.1f},kernel_vs_eager", flush=True)
    print(f"target_speed,fleet_agg,{fleet_vs_one:.2f},vs_one_board",
          flush=True)
    print("saved", path, flush=True)
    bad = launch_faults(out) if target == "card" else []
    if quick and target == "card":
        bad += gate(out, baseline)
    for msg in bad:
        print(msg, flush=True)
    if bad:
        sys.exit(1)
    return out


def _result(saved):
    """A result from a file's content (a port file holds it under
    ``result``; the reference's file is the result)."""
    return saved["result"] if "result" in saved and "panel" in saved \
        else saved


def modelled_rows(saved) -> dict:
    """A result's modelled numbers: the cut's :data:`TOP_KEYS` and each
    row's :data:`ROW_KEYS`, by row name."""
    result = _result(saved)
    return dict({k: result.get(k) for k in TOP_KEYS},
                rows={r["name"]: {k: r[k] for k in ROW_KEYS if k in r}
                      for r in result["rows"]})


def check_rows(paths, against: str) -> int:
    """``--against DIR``: each row of the written file against the row of
    ``DIR/target_speed.json`` its ``reference_row`` names and the row of
    ``DIR/torch_target_speed.json`` of its name, on :data:`ROW_KEYS` and
    :data:`TOP_KEYS`, tolerance 0; prints a line a file compared and
    returns 1 on any difference."""
    rc = 0
    for path in paths:
        with open(path) as f:
            mine = _result(json.load(f))
        for other, key in (("target_speed.json", "reference_row"),
                           ("torch_target_speed.json", "name")):
            theirs_path = os.path.join(against, other)
            if not os.path.exists(theirs_path):
                continue
            with open(theirs_path) as f:
                theirs = _result(json.load(f))
            rows = {r["name"]: r for r in theirs["rows"]}
            diff = [f"{k}: {mine.get(k)!r} != {theirs.get(k)!r}"
                    for k in TOP_KEYS if mine.get(k) != theirs.get(k)]
            for r in mine["rows"]:
                want = rows.get(r[key])
                if want is None:
                    diff.append(f"{r['name']}: no row {r[key]!r}")
                    continue
                diff += [f"{r['name']}.{k}: {r.get(k)!r} != {want.get(k)!r}"
                         for k in ROW_KEYS if r.get(k) != want.get(k)]
            print(f"against {theirs_path}: "
                  f"{'modelled numbers equal' if not diff else 'DIFFERS'}"
                  + "".join(f"\n  {d}" for d in diff), flush=True)
            rc |= bool(diff)
    return rc


if __name__ == "__main__":
    raise SystemExit(panels.main(run, __doc__, ["target_speed"],
                                 targets=TARGETS, against=check_rows))
