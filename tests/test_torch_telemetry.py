"""Out-of-band telemetry on the port: the twins of
``tests/test_telemetry.py`` over ``repro_torch.telemetry``, on
``TorchTarget(device="cpu")`` (the eager loop, the chunk kernel's plain
version) where the reference used ``JaxTarget``'s fast path, and on the
port's PySim where the reference used its own.

Arming the bridges changes nothing modelled: the golden ticks and the
traffic pin hold with both bridges running.  The architectural counters
and the ring-drop accounting are identical between the port's PySim and
the tensor target (and the backend model counters between the tensor
target and the reference's ``JaxTarget`` fast path); a commit trace
captured on the tensor target replays cleanly against PySim.  The bc
cases are in ``tests/test_torch_telemetry_bc.py`` and
``tests/test_torch_telemetry_replay.py``.  Every comparison is exact."""
from benchmarks.common import run_workload as ref_run_workload
from repro_torch.run import run_workload
from repro_torch.telemetry.bridges import BACKEND_COUNTERS

# pinned independently of tests/test_golden_ticks.py on purpose, as the
# reference's telemetry tests pin them
HELLO_UART_TICKS = 6_554_780

ARMED = dict(counters=True, commit_trace=True, interval_ticks=50_000,
             trace_slots=256)
#: the tensor target on the CPU: the eager loop
TORCH_CPU = dict(device="cpu")
#: the reference's fast path, the oracle of the backend model counters
JAX_FAST = dict(fast_path=True, issue_width=8, block_words=16,
                block_cache=True)
BACKENDS = (("pysim", {}), ("torch", TORCH_CPU))


def _run(name, argv, target="torch", telemetry=None, **kw):
    opts = TORCH_CPU if target == "torch" else {}
    kw.setdefault("n_cores", 1)
    kw.setdefault("mem", 1 << 22)
    return run_workload(name, argv, mode="fase", target=target,
                        telemetry=None if telemetry is None
                        else dict(telemetry), **opts, **kw)


def test_hello_uart_golden_with_bridges_armed():
    """Both bridges on the starved UART lane: the bridge FIFOs stall
    (samples defer, records wait in the target ring) instead of dropping
    frames, the stall time is attributed per bridge, and the run's
    timing is untouched."""
    rt, rep, _ = _run("hello", [], telemetry=ARMED)
    assert rep.ticks == HELLO_UART_TICKS
    assert rep.stdout == b"hello from FASE target\nanswer 42\n"
    tel = rep.telemetry
    s = tel["stream"]
    assert s["frames"] > 0
    assert s["dropped_frames"] == 0
    assert s["dropped_bytes"] == 0
    assert s["stall_ticks"] > 0
    assert set(s["per_bridge"]) == {"counters", "commit_trace"}
    assert any(b["stall_ticks"] > 0 for b in s["per_bridge"].values())
    assert tel["counters"]["deferred_samples"] > 0
    assert sum(tel["commit_trace"]["records"]) == sum(rep.instret)
    assert sum(tel["commit_trace"]["ring_dropped"]) == 0
    _, ref, _ = _run("hello", [], target="pysim", telemetry=ARMED)
    assert tel["commit_trace"] == ref.telemetry["commit_trace"]
    assert tel["stream"] == ref.telemetry["stream"]


def test_oracle_armed_vs_unarmed_tick_identity():
    """On the disabled channel the lane is free; armed == unarmed."""
    _, plain, _ = _run("hello", [], link="oracle")
    _, armed, _ = _run("hello", [], link="oracle", telemetry=ARMED)
    assert armed.ticks == plain.ticks
    assert armed.traffic_total == plain.traffic_total
    assert armed.telemetry["stream"]["dropped_frames"] == 0


def _final_sample(rep):
    return rep.telemetry["counters"]["samples"][-1]


def _samples(rep, key):
    return [[core[key] for core in s["cores"]]
            for s in rep.telemetry["counters"]["samples"]]


def test_counter_identity_pysim_vs_torch():
    """The architectural counters (instret/uticks/stall_ticks/trace_n)
    are bit-identical across the port's PySim and the tensor target at
    every sampling point; the backend model counters (fetch_hits/
    tlb_walks) are the two allowed to differ, and on the tensor target
    they equal the reference's JaxTarget fast path sample for sample."""
    tel = dict(counters=True, interval_ticks=20_000)
    reps = {}
    for target, _ in BACKENDS:
        _, reps[target], _ = _run("hello", [], target=target, link="pcie",
                                  telemetry=tel)
    sp, st = _final_sample(reps["pysim"]), _final_sample(reps["torch"])
    assert sp["tick"] == st["tick"]
    for k in ("instret", "uticks", "stall_ticks", "trace_n"):
        assert sp["cores"][0][k] == st["cores"][0][k], k
        assert _samples(reps["pysim"], k) == _samples(reps["torch"], k), k
    assert sp["cores"][0]["uticks"] > 0
    assert sp["cores"][0]["stall_ticks"] > 0
    ticks = {t: [s["tick"] for s in r.telemetry["counters"]["samples"]]
             for t, r in reps.items()}
    assert ticks["pysim"] == ticks["torch"]
    _, jax, _ = ref_run_workload("hello", [], mode="fase", n_cores=1,
                                 mem=1 << 22, link="pcie", target="jax",
                                 target_opts=JAX_FAST, telemetry=dict(tel))
    for k in ("fetch_hits", "tlb_walks"):
        assert _samples(reps["torch"], k) == _samples(jax, k), k
    assert sum(st["cores"][0][k] for k in ("fetch_hits", "tlb_walks")) > 0


def test_ring_overflow_drop_accounting_identical():
    """An 8-slot ring overflows between chunk-boundary drains; the drop
    count is derived from the monotone produced-count and is identical
    on both backends (drain points are the same chunks)."""
    drops, ticks = {}, {}
    for target, _ in BACKENDS:
        rt, rep, _ = _run("hello", [], target=target, link="pcie",
                          telemetry=dict(counters=False, commit_trace=True,
                                         trace_slots=8))
        drops[target] = list(rt.telemetry.commit.ring_dropped)
        ticks[target] = rep.ticks
    assert ticks["pysim"] == ticks["torch"]
    assert drops["pysim"] == drops["torch"]
    assert sum(drops["pysim"]) > 0, "8 slots must overflow on hello"


def _pc_window():
    """A real arm/disarm PC pair from hello's commit stream (PCs a few
    records in from either end, so the window is a strict sub-range)."""
    from repro_torch.telemetry import capture_commit_trace
    recs, _ = capture_commit_trace("hello", [], target="pysim", n_cores=1)
    pcs = [r[1] for r in recs[0]]
    return pcs[5], pcs[-5], len(pcs)


def test_pc_window_trigger_identical_across_backends():
    """A sticky PC arm/disarm window captures the identical record
    sub-stream on the port's PySim and the tensor target."""
    from repro_torch.telemetry import capture_commit_trace

    arm, disarm, full = _pc_window()
    got = {}
    for target, opts in BACKENDS:
        recs, rep = capture_commit_trace(
            "hello", [], target=target, target_opts=opts, n_cores=1,
            trigger=("pc", arm, disarm))
        got[target] = (recs, rep.ticks)
    (rp, tp), (rt, tt) = got["pysim"], got["torch"]
    assert tp == tt
    assert rp == rt
    assert 0 < len(rp[0]) < full, "window must be a strict sub-capture"


def test_hello_uart_golden_with_pc_window_trigger():
    """Golden hello@UART with a PC-window trigger armed: the capture
    window gates what the ring records, never when the target runs."""
    trig = ("pc", 0x10000, None)      # arm at the entry point, stay on
    rt, rep, _ = _run("hello", [], telemetry=dict(ARMED, trigger=trig))
    assert rep.ticks == HELLO_UART_TICKS
    tel = rep.telemetry
    assert tel["commit_trace"]["trigger"] == list(trig)
    assert sum(tel["commit_trace"]["records"]) == sum(rep.instret)


def test_starved_lane_fifo_stall_all_backends():
    """A nearly-zero backlog budget starves the lane on every backend:
    the bridges stall and defer, yet nothing is dropped and (where the
    ring is armed) every record still lands by the final flush."""
    for target, commit in (("pysim", True), ("torch", True),
                           ("torch", False)):
        cfg = dict(counters=True, commit_trace=commit,
                   interval_ticks=2_000, trace_slots=256,
                   bandwidth_frac=0.00005, backlog_ticks=1_000)
        rt, rep, _ = _run("hello", [], target=target, link="pcie",
                          telemetry=cfg)
        label = f"{target}:{'trace' if commit else 'counters'}"
        s = rep.telemetry["stream"]
        assert s["stall_ticks"] > 0, label
        assert s["dropped_frames"] == 0, label
        assert s["dropped_bytes"] == 0, label
        if commit:
            ct = rep.telemetry["commit_trace"]
            assert sum(ct["records"]) == sum(rep.instret), label
            assert sum(ct["ring_dropped"]) == 0, label
        else:
            assert rep.telemetry["counters"]["deferred_samples"] > 0, \
                label


def test_trace_replay_conformance_over_trigger_window():
    """Lockstep replay stays green over a windowed capture: a trace
    captured on the tensor target under an instret-threshold trigger
    replays divergence-free against an identically-windowed PySim
    reference."""
    from repro_torch.telemetry import capture_commit_trace, replay_trace

    trig = ("instret", 100)
    recs, rep = capture_commit_trace("hello", [], target="torch",
                                     target_opts=TORCH_CPU, n_cores=1,
                                     trigger=trig)
    assert 0 < sum(len(r) for r in recs) < sum(rep.instret)
    assert replay_trace(recs, "hello", [], n_cores=1, trigger=trig) == []


def test_replay_flags_a_tampered_trace():
    """The replay check has teeth: corrupt one record and it reports
    exactly that divergence."""
    from repro_torch.telemetry import capture_commit_trace, replay_trace

    recs, _ = capture_commit_trace("hello", [], target="torch",
                                   target_opts=TORCH_CPU, n_cores=1)
    assert recs[0]
    idx = len(recs[0]) // 2
    t, pc, inst, priv = recs[0][idx]
    recs[0][idx] = (t, pc ^ 4, inst, priv)
    div = replay_trace(recs, "hello", [], n_cores=1)
    assert len(div) == 1
    assert (div[0].core, div[0].index) == (0, idx)


# -- unified timeline ---------------------------------------------------
GANG_BC_MAKESPAN = 526_792


def _modelled(events):
    """Timeline events with the backend model counters of each hart's
    counter track set to None (the reference's timelines run on PySim)."""
    out = []
    for e in events:
        if e.get("tid") == "counters" and e["name"].startswith("hart"):
            e = dict(e, args={k: None if k in BACKEND_COUNTERS else v
                              for k, v in e["args"].items()})
        out.append(e)
    return out


def test_timeline_gang_tracks_and_golden_makespan():
    """The 2-board gang timeline (``TorchTarget`` boards on the CPU)
    validates and carries every promised track family, with the golden
    makespan untouched by the armed bridges and the trace hook, and
    equals the reference's document but for the backend model
    counters."""
    from repro.telemetry.__main__ import _timeline_gang as ref_gang
    from repro_torch.telemetry import validate_timeline
    from repro_torch.telemetry.__main__ import _timeline_gang

    doc = _timeline_gang(2, quick=True, pacing="fixed", device="cpu")
    assert validate_timeline(doc) == []
    assert doc["metadata"]["makespan_ticks"] == GANG_BC_MAKESPAN
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    tracks = {(e["pid"], e.get("tid", "")) for e in evs}
    for dev in ("dev0", "dev1"):
        assert (dev, "hart0") in tracks
        assert (dev, "telem") in tracks
        assert (dev, "nic") in tracks
        assert (dev, "counters") in tracks
    assert ("gang", "supersteps") in tracks
    steps = [e for e in evs if e.get("tid") == "supersteps"]
    assert steps and steps[-1]["args"]["wait_ticks"] >= 0
    ref = ref_gang(2, quick=True, pacing="fixed")
    assert _modelled(doc["traceEvents"]) == _modelled(ref["traceEvents"])


def test_timeline_solo_and_validator_has_teeth():
    """A solo hello timeline passes validation and equals the
    reference's but for the backend model counters; a tampered document (backwards ts, orphan E, orphan
    async end) is rejected with one problem per defect."""
    from repro.telemetry.__main__ import _timeline_solo as ref_solo
    from repro_torch.telemetry import validate_timeline
    from repro_torch.telemetry.__main__ import _timeline_solo

    doc = _timeline_solo("hello", link="pcie", quick=True, device="cpu")
    assert validate_timeline(doc) == []
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    assert {(e["pid"], e.get("tid", "")) for e in evs} >= {
        ("session", "hart0"), ("session", "telem"),
        ("session", "counters")}
    assert _modelled(doc["traceEvents"]) == _modelled(
        ref_solo("hello", link="pcie", quick=True)["traceEvents"])

    bad = [
        {"name": "a", "ph": "X", "pid": "p", "tid": "t",
         "ts": 10.0, "dur": 1.0},
        {"name": "b", "ph": "X", "pid": "p", "tid": "t",
         "ts": 5.0, "dur": 1.0},                       # ts backwards
        {"name": "c", "ph": "E", "pid": "p", "tid": "t",
         "ts": 20.0},                                  # E without B
        {"name": "d", "ph": "e", "pid": "p", "tid": "t",
         "ts": 30.0, "cat": "x", "id": 1},             # async orphan
    ]
    problems = validate_timeline({"traceEvents": bad})
    assert len(problems) == 3


def test_telemetry_cli_timeline_and_validate(tmp_path):
    """``python -m repro_torch.telemetry timeline hello`` writes a
    document that ``validate`` accepts (``--device cpu``: the eager
    loop)."""
    from repro_torch.telemetry.__main__ import main

    out = tmp_path / "hello.json"
    assert main(["timeline", "hello", "--quick", "--out", str(out),
                 "--device", "cpu"]) == 0
    assert main(["validate", str(out)]) == 0
