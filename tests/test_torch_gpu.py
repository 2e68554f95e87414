"""Tests of the port that need a CUDA device: they skip (with a reason)
where there is none.  On a GPU machine run them with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py

(``--noconftest`` because the shared conftest arms a fixture of the JAX
package; this file imports only the port).  The kernel is held against
its plain version, and the CUDA target against the CPU target, on the
same inputs; the chunk kernel against the eager loop on the CPU, every
state field after every chunk.  Integer results and the page ops:
tolerance 0; the
attention kernels: ``kernels/flash_attention/ref.py::ATTN_TOL`` (1e-5 +
1e-5·|plain| in float32, 1e-6 + 2⁻⁷·|plain|, one rounding step, in
bfloat16)."""
import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import session
from repro_torch.core.channel import UartChannel
from repro_torch.core.interface import TorchTarget
from repro_torch.core.target import asm, isa
from repro_torch.core.target.pysim import PySim
from repro_torch.core.target.convert import state_to_numpy
from repro_torch.kernels.page_walk import ops, page_walk
from repro_torch.kernels.run_chunk import run_chunk as RC
from repro_torch.telemetry import without_backend_counters

import torch_directed_cases as DC
import torch_trace_cases as TC

pytestmark = pytest.mark.gpu

#: atomics + MMU + byte/half traffic + M extension, every core on one cell
PROGRAM = """
_start:
    li sp, 0x110000
    slli t0, a0, 12
    sub sp, sp, t0
    la s0, counter
    li t1, 12
loop:
    amoadd.d t2, t1, (s0)
    amoadd.w t3, t1, (s0)
    lr.d t4, (s0)
    addi t4, t4, 1
    sc.d t5, t4, (s0)
    amomax.d t6, a0, (s0)
    amominu.w s1, t1, (s0)
    la s2, bytes_area
    add s3, s2, a0
    sb t1, 0(s3)
    lb s4, 0(s3)
    sh t1, 8(s2)
    lhu s5, 8(s2)
    mul s6, t1, t3
    divu s7, s6, t1
    rem s8, s6, t1
    mulh s9, s6, t3
    addi t1, t1, -1
    bnez t1, loop
    li a7, 93
    ecall
.data
counter: .dword 0
bytes_area: .zero 64
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("block_words", [8, 16])
def test_kernel_equals_plain_version_on_the_card(cuda, block_words):
    mem, satp_v = _chip_smoke().build_walk_image(torch, 1 << 20, 3, cuda)
    rng = np.random.RandomState(3)
    va = torch.from_numpy(rng.randint(0, 80 * 4096, 2000)).to(cuda)
    satp = torch.full((2000,), satp_v - (1 << 64), dtype=torch.int64,
                      device=cuda)
    satp[10::13] = 0
    active = torch.from_numpy(rng.rand(2000) < 0.8).to(cuda)
    before = page_walk.walk_fetch_block.launches
    for a in (None, active):
        args = (mem, satp, va, (1 << 20) - 1, block_words, None, a)
        got = ops.walk_fetch_block(*args)
        want = ops.walk_fetch_block(*args, impl="ref")
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert page_walk.walk_fetch_block.launches == before + 2


#: the lockstep fuzzer's axes (tests/test_torch_cpu_differential.py CONFIGS)
FUZZ_CONFIGS = [dict(block_cache=True, dtlb_ways=8),
                dict(block_cache=False, dtlb_ways=8),
                dict(block_cache=True, dtlb_ways=0),
                dict(block_cache=False, dtlb_ways=0)]
#: the fuzzer's program generator and the tables it draws from
_GEN_NAMES = ("ALU_RR", "ALU_RI", "SHIFTS", "LOADS", "STORES", "AMOS",
              "BRANCHES", "GPRS", "EDGE_VALS", "_ProgGen")


def _defs_from(name, names, ns):
    """The top-level assignments, functions and classes ``names`` of
    ``tests/<name>``, executed into ``ns``: taken from the file's source
    so that this file needs no JAX."""
    path = Path(__file__).resolve().parent / name
    tree = ast.parse(path.read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.Assign) and
                isinstance(n.targets[0], ast.Name) and
                n.targets[0].id in names) or
            (isinstance(n, (ast.ClassDef, ast.FunctionDef)) and
             n.name in names)]
    exec(compile(ast.Module(keep, type_ignores=[]), str(path), "exec"), ns)
    return ns


def fuzz_program(seed):
    """The program the lockstep fuzzer runs for ``seed``: the JAX
    package's generator (``tests/test_cpu_differential.py::_ProgGen``)."""
    ns = _defs_from("test_cpu_differential.py", _GEN_NAMES, {"np": np})
    return ns["_ProgGen"](seed).build()


def amo_table_program():
    """Every AMO, W and D, on a cell holding more, less, and a negative
    against its operand: each old value and each new cell value is stored
    to ``out``."""
    lines = ["_start:", "    la s0, cell", "    la s1, out"]
    for amo in ("amoswap", "amoadd", "amoxor", "amoand", "amoor", "amomin",
                "amomax", "amominu", "amomaxu"):
        for w in (".w", ".d"):
            for old, b in ((5, 3), (3, 5), (-1, 1), (1 << 40, -7)):
                lines += [f"    li t0, {old}", "    sd t0, 0(s0)",
                          f"    li t1, {b}", f"    {amo}{w} t2, t1, (s0)",
                          "    ld t3, 0(s0)", "    sd t2, 0(s1)",
                          "    sd t3, 8(s1)", "    addi s1, s1, 16"]
    lines += ["    li a7, 93", "    ecall", ".data", "cell: .dword 0",
              "out: .zero 2400"]
    return "\n".join(lines)


def _load(t, img, nc, mmu=True):
    for seg in img.segments:
        data = bytes(seg.data)
        data = data.ljust((len(data) + 7) // 8 * 8, b"\0")
        for i in range(0, len(data), 8):
            t.mem_write_word(seg.vaddr + i,
                             int.from_bytes(data[i:i + 8], "little"))
    root, l1, l0 = 2, 3, 4
    flags = (isa.PTE_V | isa.PTE_R | isa.PTE_W | isa.PTE_X | isa.PTE_U |
             isa.PTE_A | isa.PTE_D)
    if mmu:
        t.mem_write_word(root * 4096, (l1 << 10) | isa.PTE_V)
        t.mem_write_word(l1 * 4096, (l0 << 10) | isa.PTE_V)
        for vpn0 in list(range(16, 96)) + list(range(256, 272)):
            t.mem_write_word(l0 * 4096 + vpn0 * 8, (vpn0 << 10) | flags)
    for c in range(nc):
        if mmu:
            t.set_satp(c, (8 << 60) | root)
        t.reg_write(c, 10, c)
        t.redirect(c, img.entry)


def _lockstep(src, nc, chunk, mmu=True, max_chunks=400, **kw):
    """``src`` on a CUDA target (its default route, or ``chunk_kernel``
    in ``kw``) and on a CPU target (the eager loop) in lockstep chunks:
    every state field and the substep count equal after every chunk.
    Returns the CUDA target."""
    img = asm.assemble(src)
    targets = [TorchTarget(nc, 1 << 21, device="cuda", **kw),
               TorchTarget(nc, 1 << 21, device="cpu",
                           **{k: v for k, v in kw.items()
                              if k != "chunk_kernel"})]
    for t in targets:
        _load(t, img, nc, mmu)
    for step in range(max_chunks):
        for t in targets:
            t.run(max_cycles=chunk)
        a, b = (state_to_numpy(t.st) for t in targets)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name],
                                          err_msg=f"chunk {step}: {name}")
        assert targets[0].substeps == targets[1].substeps, step
        for t in targets:
            for c in t.pending_cores():
                t.clear_pending(c)
                t.park(c)
        if all(t.get_priv(c) == 3 for t in targets for c in range(nc)):
            return targets[0]
    raise AssertionError("program did not finish")


@pytest.mark.parametrize("chunk_kernel", ["kernel", "ref"])
@pytest.mark.parametrize("nc", [1, 4])
def test_cuda_target_equals_cpu_target(cuda, nc, chunk_kernel):
    """Both card routes: the chunk kernel (one launch per chunk, no
    standalone walk) and the eager loop (the walk kernel each substep)."""
    walks = page_walk.walk_fetch_block.launches
    chunks = RC.run_chunk.launches
    t = _lockstep(PROGRAM, nc, 97, chunk_kernel=chunk_kernel)
    assert t.get_instret(0) > 200
    if chunk_kernel == "kernel":
        assert RC.run_chunk.launches > chunks
        assert page_walk.walk_fetch_block.launches == walks
    else:
        assert RC.run_chunk.launches == chunks
        assert page_walk.walk_fetch_block.launches > walks


@pytest.mark.parametrize("kw", FUZZ_CONFIGS,
                         ids=["cache-dtlb8", "nocache-dtlb8", "cache-dtlb0",
                              "nocache-dtlb0"])
@pytest.mark.parametrize("seed", range(6))
def test_chunk_kernel_equals_eager_loop_on_fuzz_programs(cuda, seed, kw):
    """The lockstep fuzzer's programs (1/2/4 cores, MMU on/off, shared
    atomics) on the chunk kernel against the CPU's eager loop."""
    nc = (1, 2, 4)[seed % 3]
    chunks = RC.run_chunk.launches
    _lockstep(fuzz_program(seed), nc, 379, mmu=seed % 3 != 1, **kw)
    assert RC.run_chunk.launches > chunks


def test_chunk_kernel_equals_eager_loop_on_the_amo_table(cuda):
    _lockstep(amo_table_program(), 1, 61)


def _same_state(a, b, point):
    sa, sb = state_to_numpy(a.st), state_to_numpy(b.st)
    for name in sa:
        np.testing.assert_array_equal(sa[name], sb[name],
                                      err_msg=f"{point}: {name}")
    assert a.substeps == b.substeps, point


@pytest.mark.parametrize("case,kw", DC.PARAMS, ids=DC.IDS)
def test_chunk_kernel_meets_directed_regression(cuda, case, kw):
    """The directed regressions of tests/test_torch_cpu_directed.py on
    the chunk kernel against the CPU's eager loop, every state field at
    each checkpoint."""
    chunks = RC.run_chunk.launches
    targets = [TorchTarget(case.nc, DC.MEM, device="cuda",
                           chunk_kernel="kernel", **kw),
               TorchTarget(case.nc, DC.MEM, device="cpu", **kw)]
    DC.run_in_lockstep(case, targets, lambda ts, p: _same_state(*ts, p))
    assert RC.run_chunk.launches > chunks


_TRACE_TRIGGERS = TC.triggers(asm.assemble(PROGRAM))


@pytest.mark.parametrize("slots", [TC.SLOTS_WRAP, TC.SLOTS_WIDE],
                         ids=["wrapping", "wide"])
@pytest.mark.parametrize("trigger", [t for _, t in _TRACE_TRIGGERS],
                         ids=[i for i, _ in _TRACE_TRIGGERS])
def test_traced_chunk_kernel_records_the_eager_ring(cuda, trigger, slots):
    """The traced instantiation of the chunk kernel on the atomics
    program under each trigger kind: ring, ``trace_n`` and
    ``trace_armed`` (and every other field) equal to the CPU's eager
    loop after every chunk, the drains equal to PySim's records and ring
    drops."""
    nc = 4
    traced = RC.run_chunk.trace_launches
    targets = [TorchTarget(nc, DC.MEM, device="cuda"),
               TorchTarget(nc, DC.MEM, device="cpu"), PySim(nc, DC.MEM)]
    TC.arm(targets, slots, trigger)
    records = TC.run_program(PROGRAM, nc, 97, targets,
                             lambda ts, p: _same_state(ts[0], ts[1], p))
    assert RC.run_chunk.trace_launches > traced
    assert sum(len(r) for r in records) > 0


def test_traced_chunk_kernel_meets_directed_regressions(cuda):
    """The directed regressions with an 8-slot ring armed: the traced
    kernel's state, ring included, equal to the eager loop's at each
    checkpoint, and its drains equal."""
    for case, kw in DC.PARAMS:
        targets = [TorchTarget(case.nc, DC.MEM, device="cuda", **kw),
                   TorchTarget(case.nc, DC.MEM, device="cpu", **kw)]
        TC.arm(targets, TC.SLOTS_WRAP, None)

        def compare(ts, point):
            _same_state(*ts, f"{case.name}: {point}")
            TC.same_drains(ts, point)
        DC.run_in_lockstep(case, targets, compare)


def test_starved_telemetry_lane_on_the_card(cuda):
    """The reference's starved-lane case on the card's kernel route: the
    bridges stall and defer, nothing is dropped, every record lands by
    the final flush, and the report equals PySim's but for the backend
    model counters."""
    from repro_torch.run import run_workload
    cfg = dict(counters=True, commit_trace=True, interval_ticks=2_000,
               trace_slots=256, bandwidth_frac=0.00005, backlog_ticks=1_000)
    traced = RC.run_chunk.trace_launches
    _, rep, _ = run_workload("hello", [], mode="fase", n_cores=1,
                             mem=1 << 22, link="pcie", telemetry=dict(cfg))
    assert RC.run_chunk.trace_launches > traced
    s = rep.telemetry["stream"]
    assert s["stall_ticks"] > 0
    assert s["dropped_frames"] == 0 and s["dropped_bytes"] == 0
    ct = rep.telemetry["commit_trace"]
    assert sum(ct["records"]) == sum(rep.instret)
    assert sum(ct["ring_dropped"]) == 0
    _, ref, _ = run_workload("hello", [], mode="fase", target="pysim",
                             n_cores=1, mem=1 << 22, link="pcie",
                             telemetry=dict(cfg))
    assert without_backend_counters(rep.telemetry) == \
        without_backend_counters(ref.telemetry)


def test_telemetry_and_analysis_clis_on_the_card(cuda, tmp_path, capsys):
    """Both CLIs run on the card by default: the hello timeline equals
    the one the eager loop gives on the CPU (the two routes keep every
    counter equal), and the quick analysis gate reports 0 findings."""
    from repro_torch.analysis.cli import main as analysis_main
    from repro_torch.telemetry.__main__ import _timeline_solo, main
    traced = RC.run_chunk.trace_launches
    out = tmp_path / "hello.json"
    assert main(["timeline", "hello", "--out", str(out)]) == 0
    assert RC.run_chunk.trace_launches > traced
    assert main(["validate", str(out)]) == 0
    assert _timeline_solo("hello", "pcie", True, "cuda")["traceEvents"] == \
        _timeline_solo("hello", "pcie", True, "cpu")["traceEvents"]
    capsys.readouterr()
    assert analysis_main(["gate", "--quick"]) == 0
    assert "race: 0 finding(s)" in capsys.readouterr().out


@pytest.mark.parametrize("seed", range(6))
def test_write_batch_staleness_then_a_chunk_on_the_card(cuda, seed):
    """The write-batch staleness property of
    tests/test_torch_interface.py on a CUDA target (a read staged after a
    write in one transaction sees the staged value; the final state is
    the sequential model's), then a chunk of the chunk kernel from the
    state the batch committed (core 0 sent to the words the transaction
    wrote), against the same on the CPU's eager loop."""
    ns = _defs_from("test_session.py",
                    ("_ST_REGS", "_ST_CSRS", "_ST_ADDRS", "_staleness_ops"),
                    {})
    ops = ns["_staleness_ops"](seed)
    run_staleness = _defs_from(
        "test_torch_interface.py", ("M64", "_run_staleness"),
        {"HtpSession": session.HtpSession,
         "HtpTransaction": session.HtpTransaction,
         "UartChannel": UartChannel})["_run_staleness"]
    chunks = RC.run_chunk.launches
    targets = [TorchTarget(1, 1 << 20, device="cuda", chunk_kernel="kernel"),
               TorchTarget(1, 1 << 20, device="cpu")]
    for t in targets:
        run_staleness(ops, t)
        t.redirect(0, 0x8000)
        t.run(max_cycles=64)
    _same_state(*targets, f"seed {seed}")
    assert RC.run_chunk.launches > chunks


# ---------------------------------------------------------------------------
# the fleet chunk kernel (one CTA a board) and snapshots on the card
# ---------------------------------------------------------------------------
def _fleet_lockstep(progs, nc, budgets, seed, max_chunks=400, **kw):
    """One program a board of a CUDA stack on the fleet kernel and of a
    CPU stack on the eager flat form, global chunks with budgets drawn
    per board from ``budgets`` (0 among them): every field of every
    board and each board's substeps equal after every global chunk, and
    every board of budget 0 untouched on the card.  Returns the CUDA
    fleet."""
    from repro_torch.core.fleet.vmap import FleetTarget
    D = len(progs)
    fleets = [FleetTarget(D, nc, 1 << 21, device=dev, **kw)
              for dev in ("cuda", "cpu")]
    for f in fleets:
        for d, (src, mmu) in enumerate(progs):
            _load(f.view(d), asm.assemble(src), nc, mmu)
    rng = np.random.RandomState(seed)
    for step in range(max_chunks):
        b = [int(x) for x in rng.choice(budgets, D)]
        before = state_to_numpy(fleets[0].sts)
        for f in fleets:
            f.run_global(b)
        a, c = (state_to_numpy(f.sts) for f in fleets)
        for name in a:
            np.testing.assert_array_equal(a[name], c[name],
                                          err_msg=f"chunk {step}: {name}")
            for d in range(D):
                if b[d] == 0:
                    np.testing.assert_array_equal(
                        a[name][d], before[name][d],
                        err_msg=f"chunk {step}: board {d} of budget 0")
        for d in range(D):
            assert fleets[0].view(d).substeps == fleets[1].view(d).substeps
        for f in fleets:
            for d in range(D):
                v = f.view(d)
                for c in v.pending_cores():
                    v.clear_pending(c)
                    v.park(c)
        if bool((fleets[1].sts.priv == 3).all()):
            return fleets[0]
    raise AssertionError("programs did not finish")


@pytest.mark.parametrize("kw", FUZZ_CONFIGS,
                         ids=["cache-dtlb8", "nocache-dtlb8", "cache-dtlb0",
                              "nocache-dtlb0"])
@pytest.mark.parametrize("seed", range(3))
def test_fleet_kernel_equals_eager_flat_form_on_fuzz_programs(cuda, seed,
                                                              kw):
    """The fuzzer's programs, one a board of 3 (1/2/4 cores, MMU on/off),
    on ``run_chunk_fleet``: one launch a global chunk."""
    nc = (1, 2, 4)[seed % 3]
    progs = [(fuzz_program(seed * 10 + d), (seed + d) % 3 != 1)
             for d in range(3)]
    launches = RC.run_chunk_fleet.launches
    ft = _fleet_lockstep(progs, nc, (0, 61, 97, 379), seed, **kw)
    assert RC.run_chunk_fleet.launches - launches == ft.dispatch_count > 0


def test_fleet_kernel_equals_eager_flat_form_on_the_amo_table(cuda):
    _fleet_lockstep([(amo_table_program(), True)] * 3, 1, (0, 7, 61), 1)


def test_fleet_kernel_boards_are_shared_nothing(cuda):
    """Each board of a CUDA stack after a global chunk of the fleet kernel
    equals the same board run alone on a CUDA ``TorchTarget`` (the chunk
    kernel) with the same budget, substeps included."""
    from repro_torch.core.fleet.vmap import FleetTarget
    D, nc = 3, 2
    progs = [(fuzz_program(20 + d), d != 1) for d in range(D)]
    ft = FleetTarget(D, nc, 1 << 21, device="cuda")
    alone = [TorchTarget(nc, 1 << 21, device="cuda") for _ in range(D)]
    for d, (src, mmu) in enumerate(progs):
        for t in (ft.view(d), alone[d]):
            _load(t, asm.assemble(src), nc, mmu)
    rng = np.random.RandomState(2)
    for step in range(400):
        b = [int(x) for x in rng.choice((0, 61, 97, 379), D)]
        subs = [ft.view(d).substeps for d in range(D)]
        ft.run_global(b)
        for d, t in enumerate(alone):
            n = t.substeps
            if b[d]:
                t.run(max_cycles=b[d])
            assert ft.view(d).substeps - subs[d] == t.substeps - n
            _same_state(t, ft.view(d), f"chunk {step} board {d}")
        for t in [ft.view(d) for d in range(D)] + alone:
            for c in t.pending_cores():
                t.clear_pending(c)
                t.park(c)
        if bool((ft.sts.priv == 3).all()):
            return
    raise AssertionError("programs did not finish")


def test_snapshot_round_trips_on_the_card(cuda):
    """A checkpoint of a CUDA ``TorchTarget`` restores into a CPU one and
    into a board of a CUDA ``FleetTarget`` (and back), every field and
    page equal, the same wire bytes per category."""
    from repro_torch.core import snapshot as snap
    from repro_torch.core.fleet.vmap import FleetTarget
    img = asm.assemble(PROGRAM)

    def cap(t):
        ch = UartChannel()
        s = snap.capture(session.HtpSession(t, ch), at=0)[0]
        return s, dict(ch.bytes_by_cat)

    def key(s):
        zero = bytes(4096)
        return (s.ticks, [(c.regs, c.csrs) for c in s.cores],
                {p: v for p, v in s.effective_pages().items() if v != zero})
    gpu = TorchTarget(4, 1 << 21, device="cuda")
    _load(gpu, img, 4)
    gpu.run(max_cycles=300)
    s, wire = cap(gpu)
    ft = FleetTarget(3, 4, 1 << 21, device="cuda")
    targets = [TorchTarget(4, 1 << 21, device="cpu"), ft.view(1)]
    for t in targets:
        snap.restore(session.HtpSession(t, UartChannel()), s, at=0)
        got, got_wire = cap(t)
        assert key(got) == key(s) and got_wire == wire
    back = TorchTarget(4, 1 << 21, device="cuda")
    snap.restore(session.HtpSession(back, UartChannel()),
                 cap(ft.view(1))[0], at=0)
    for t in targets + [back, gpu]:
        t.run(max_cycles=400)
    keys = [key(cap(t)[0]) for t in targets + [back, gpu]]
    assert all(k == keys[-1] for k in keys)
    assert ft.view(0).get_ticks() == 0 == ft.view(2).get_ticks()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_equals_plain_version(cuda, dtype):
    from repro_torch.kernels.paged_attention import paged_attention as PA
    smoke = _chip_smoke()
    dt = getattr(torch, dtype)
    before = PA.paged_attention.launches
    n = 0
    for B, H, Hkv, D, page, P, lens in (
            (2, 4, 2, 32, 16, 3, [1, 48]), (1, 2, 1, 16, 8, 4, [0]),
            (4, 32, 8, 128, 64, 8, [1, 64, 65, 512]),
            (2, 32, 2, 128, 64, 2, [100, 3])):
        args = smoke.attention_inputs(torch, cuda, B, H, Hkv, D, page, P, dt,
                                      n, lens, pages=2 * B * P + 1)
        smoke.attention_err(torch, *args)
        n += 1
    assert PA.paged_attention.launches == before + n


@pytest.mark.parametrize("splits", ["1", "2", "P"])
def test_paged_attention_at_each_split_count(cuda, splits):
    """Shapes whose plan on this card cuts each sequence into 1, 2 and P
    ranges, with lengths of 0, 1, mid-page, a page boundary and the whole
    table among the slots: the split kernel and its in-launch combine
    against the plain version."""
    from repro_torch.kernels.paged_attention import paged_attention as PA
    smoke = _chip_smoke()
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    H, Hkv, D, page, P = 4, 1, 128, 16, 6
    per = PA.WAVES * PA.CTAS_PER_SM * sm      # CTAs a full table spreads
    B = {"1": per, "2": per // 2, "P": 5}[splits]
    pl = PA.plan(B, H, Hkv, D, page, P, 2, sm)
    assert pl.splits == {"1": 1, "2": 2, "P": P}[splits]
    lens = [0, 1, 9, 16, P * page][:B] + \
        [(37 * i) % (P * page + 1) for i in range(B - 5)]
    before = PA.paged_attention.launches
    for seed, dtype in enumerate((torch.float32, torch.bfloat16)):
        smoke.attention_err(torch, *smoke.attention_inputs(
            torch, cuda, B, H, Hkv, D, page, P, dtype, seed, lens))
    assert PA.paged_attention.launches == before + 2


def test_paged_attention_at_long_context(cuda):
    """qwen3-8b's heads at 32 768 tokens a slot (one full, one of a single
    token, one mid-page, one empty) in bf16."""
    smoke = _chip_smoke()
    smoke.attention_err(torch, *smoke.attention_inputs(
        torch, cuda, *smoke.LONG_SHAPE, torch.bfloat16, 1,
        smoke.LONG_CHECK_LENS))


def test_windowed_paged_attention_equals_plain_version(cuda):
    """The windowed instantiation against its plain version at jamba's
    heads (its serve ring, the wrapped ring of 129 pages) and on small
    rings whose window masks whole one-page ranges, f32 and bf16
    (``chip_smoke.check_window_attention``); its own counter moves."""
    from repro_torch.kernels.paged_attention import paged_attention as PA
    before = (PA.paged_attention.launches,
              PA.paged_attention.window_launches)
    _chip_smoke().check_window_attention(torch, cuda)
    # one unwindowed launch: the full attention the window is held apart
    # from
    assert PA.paged_attention.launches == before[0] + 1
    assert PA.paged_attention.window_launches >= before[1] + 7


@pytest.mark.parametrize("splits", ["1", "2", "P"])
def test_windowed_paged_attention_at_each_split_count(cuda, splits):
    """Shapes whose plan cuts each ring into 1, 2 and P ranges, with the
    window masking a span across a page boundary and, at P, whole
    ranges; lengths past the wrap and below the window."""
    from repro_torch.kernels.paged_attention import paged_attention as PA
    smoke = _chip_smoke()
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    H, Hkv, D, page, P = 4, 1, 128, 16, 6
    per = PA.WAVES * PA.CTAS_PER_SM * sm
    B = {"1": per, "2": per // 2, "P": 5}[splits]
    assert PA.plan(B, H, Hkv, D, page, P, 2, sm).splits == \
        {"1": 1, "2": 2, "P": P}[splits]
    lens = [1, 9, 95, 96, 200][:B] + [(53 * i) % 400 + 1
                                      for i in range(B - 5)]
    for seed, dtype in enumerate((torch.float32, torch.bfloat16)):
        smoke.attention_err(torch, *smoke.attention_inputs(
            torch, cuda, B, H, Hkv, D, page, P, dtype, seed, lens),
            window=40)


def test_family_serving_routes_on_the_card(cuda):
    """chip_smoke.py's checks of the jamba and xlstm serve runs at smoke
    width: jamba's kernel route against its plain route one step at a
    time with the router's near ties accounted, and xlstm's first decode
    steps on the card against the same steps on the CPU."""
    from repro_torch.configs import CONFIGS
    from repro_torch.models import core as M
    from repro_torch.training.optim import tree_map
    smoke = _chip_smoke()
    cfg = CONFIGS[smoke.JAMBA_ARCH].smoke()
    params = M.init_params(cfg, 0, device=cuda)
    with smoke.RouterLog(M) as log:
        eng, stats, busiest, _ = smoke.lockstep(torch, cfg, params,
                                                resync=True, routing=log)
    assert M.moe is log.real
    assert stats["steps"] > 100 and busiest is not None
    cfg = CONFIGS[smoke.XLSTM_ARCH].smoke()
    params = M.init_params(cfg, 0, device=cuda)
    f32 = tree_map(lambda t: t.float(), params)
    _, stats, _, _ = smoke.lockstep(
        torch, cfg, f32, ref_params=tree_map(lambda t: t.cpu(), f32),
        ref_device="cpu", max_steps=smoke.XLSTM_CPU_STEPS)
    assert stats["steps"] == smoke.XLSTM_CPU_STEPS


def test_page_ops_kernels_equal_plain_versions(cuda):
    from repro_torch.kernels.page_ops import page_ops
    before = (page_ops.page_set.launches, page_ops.page_copy.launches)
    _chip_smoke().check_page_ops(torch, cuda)
    assert page_ops.page_set.launches > before[0]
    assert page_ops.page_copy.launches > before[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_gather_kernel_equals_plain_version(cuda, dtype):
    """A layered pool and a table with a repeated id: the kernel's dense
    copy equals ``index_select`` bit for bit, and its counter moves."""
    from repro_torch.kernels.page_ops import ops, page_ops
    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    pool = torch.randn((3, 2, 9, 16, 2, 32), generator=g,
                       device=cuda).to(getattr(torch, dtype))
    table = torch.tensor([8, 0, 3, 8], dtype=torch.int32, device=cuda)
    before = page_ops.page_gather.launches
    got = ops.page_gather(pool, table)
    want = ops.page_gather(pool, table, impl="ref")
    torch.cuda.synchronize()
    assert got.shape == (3, 2, 4, 16, 2, 32) and torch.equal(got, want)
    assert page_ops.page_gather.launches == before + 1


def test_serving_kernel_route_against_plain_route(cuda):
    """chip_smoke.py's lockstep comparison of the kernel and plain routes
    at smoke width: logits within its tolerance at every step, every
    differing used token a near tie, the same schedule and traffic."""
    from repro_torch.configs import CONFIGS
    from repro_torch.models import core as M
    smoke = _chip_smoke()
    cfg = CONFIGS[smoke.SERVE_ARCH].smoke()
    params = M.init_params(cfg, 0, device=cuda)
    eng, stats, busiest, most = smoke.lockstep(torch, cfg, params)
    assert stats["steps"] > 100 and stats["used_tokens"] > 0
    assert most["page_set"] > 0 and busiest is not None


def test_flash_attention_kernel_equals_plain_version(cuda):
    """chip_smoke.py's cases: the test_kernels.py shapes, S = 1 and 200,
    the training path's shapes, within ``ATTN_TOL``."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    before = FA.flash_attention.launches
    _chip_smoke().check_flash_attention(torch, cuda)
    assert FA.flash_attention.launches >= before + 12


def test_flash_attention_backward_against_plain_version(cuda):
    """The kernel route's dq, dk, dv against autograd through the plain
    version, at (2, 256, 64) f32 and qwen3-8b's GQA shape in bf16."""
    from repro_torch.configs import CONFIGS
    _chip_smoke().check_flash_backward(torch, cuda, CONFIGS["qwen3-8b"])


def test_training_restart_on_the_card(cuda):
    """The reference's fault test at smoke width on the card: the steps
    after the restore equal the uninterrupted run's."""
    _chip_smoke().restart_check(torch)


@pytest.mark.parametrize("nc", [33, 40, 64])
def test_chunk_kernel_on_boards_past_a_warp(cuda, nc):
    """Boards of 33, 40 and 64 cores on the chunk kernel's CTA-wide
    instantiation against the CPU's eager loop, every field after every
    chunk: the atomics program's lanes above 31 race lanes below 32."""
    chunks = RC.run_chunk.launches
    t = _lockstep(PROGRAM, nc, 97)
    assert min(t.get_instret(c) for c in range(nc)) > 200
    assert RC.run_chunk.launches > chunks


def test_wide_boards_on_both_chunk_kernels(cuda):
    """chip_smoke.py's ``wide_boards``: 40 and 64 cores on the untraced,
    traced and fleet kernels, each equal to the eager loop after every
    chunk."""
    smoke = _chip_smoke()
    smoke.wide_boards(torch)
    smoke.wide_boards(torch, fleet=True)


def test_windowed_flash_attention_equals_plain_version(cuda):
    """chip_smoke.py's windowed cases in both designs (window 1, 64 at a
    ragged S, S - 1, a wholly masked first tile, jamba's heads at S =
    16 384 on one GQA group) and the windowed backward."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    before = FA.flash_attention.window_launches
    _chip_smoke().check_flash_window(torch, cuda)
    assert FA.flash_attention.window_launches > before


def test_families_train_and_prefill_routes_on_the_card(cuda):
    """chip_smoke.py's routing replay at jamba's smoke widths: the plain
    route replaying the kernel route's MoE routing gives the kernel
    route's gradients within the train limits, the planted attention
    fault does not."""
    from repro_torch.configs import CONFIGS
    from repro_torch.models import core as M
    smoke = _chip_smoke()
    cfg = CONFIGS["jamba-v0.1-52b"].smoke()
    params = M.init_params(cfg, 0, device="cuda")
    tok = torch.randint(0, cfg.vocab, (1, 129), device="cuda",
                        dtype=torch.int32,
                        generator=torch.Generator("cuda").manual_seed(0))
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    with smoke.RouterReplay(torch, M) as rr:
        k = smoke.grad_run(torch, cfg, params, batch, "kernel")
        rr.replay()
        r = smoke.grad_run(torch, cfg, params, batch, "ref")
        rr.replay()
        with smoke.PlantedAttention(M, smoke.PLANTED_SCALE):
            f = smoke.grad_run(torch, cfg, params, batch, "kernel")
    assert smoke.route_gaps(k, r)["within"]
    assert not smoke.route_gaps(f, r)["within"]
