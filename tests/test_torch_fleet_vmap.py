"""The stacked fleet of the port (``repro_torch.core.fleet.vmap``) and its
global chunk, ``cpu.run_chunk_fleet``, on the CPU.

The eager flat form (the fleet chunk kernel's plain version) is held
against the reference's ``run_chunk_fleet`` on the lockstep fuzzer's
programs, one program a board, at D = 1, 2, 3 boards of 1 or 2 cores
with unequal budgets (0 among them): the whole stacked state, every field
of every board, after every global chunk.  The port's stack is carried to
the JAX ``FleetTarget.sts`` through ``convert`` (the stacked states both
ways).  Then the properties the fleet chunk kernel's design rests on:
boards are shared-nothing (each board after a global chunk equals the
same board run alone on a ``TorchTarget``), a board whose budget is 0 is
byte-identical, and a board's view stays valid across host ops, the
write-batch staleness property and re-provisioning.  Integer state;
tolerance 0."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.fleet.vmap import FleetTarget as JFleetTarget
from repro.core.target import cpu as jcpu
from repro_torch.core.channel import UartChannel
from repro_torch.core.fleet.vmap import FleetTarget
from repro_torch.core.interface import TorchTarget
from repro_torch.core.session import HtpSession, HtpTransaction
from repro_torch.core.target import asm as tasm
from repro_torch.core.target import cpu
from repro_torch.core.target.convert import state_from_numpy, state_to_numpy
from repro_torch.run import run_workload

from test_cpu_differential import _ProgGen
from test_session import _staleness_ops
from test_torch_cpu_differential import load_image
from test_torch_interface import _run_staleness

MEM = 1 << 21
#: per global chunk, each board's budget is drawn from these (0 included)
BUDGETS = (0, 61, 97, 379)
#: a guest loop without system calls on a private line per core
LOOP_SRC = """
_start:
    li s1, 0x20000
    slli t0, a0, 6
    add s1, s1, t0
1:
    ld t1, 0(s1)
    addi t1, t1, 3
    sd t1, 0(s1)
    mul t2, t1, t1
    j 1b
"""


def _programs(seed, D):
    """One fuzzer program a board, and whether its MMU is on."""
    return [(_ProgGen(seed * 10 + d).build(), (seed + d) % 3 != 1)
            for d in range(D)]


def _loaded(D, nc, progs, **kw):
    ft = FleetTarget(D, nc, MEM, device="cpu", **kw)
    for d, (src, mmu) in enumerate(progs):
        load_image(ft.view(d), tasm.assemble(src), nc, mmu)
    return ft


def _to_jax(sts_numpy):
    return jcpu.CpuState(**{k: jnp.asarray(v) for k, v in sts_numpy.items()})


def _jax_numpy(jft):
    return {k: np.asarray(getattr(jft.sts, k)) for k in cpu.STATE_FIELDS}


def _assert_equal(want, got, ctx):
    for name in cpu.STATE_FIELDS:
        w, g = want[name], got[name]
        assert w.shape == g.shape and w.dtype == g.dtype, (ctx, name)
        if not np.array_equal(w, g):
            raise AssertionError((ctx, name, np.argwhere(w != g)[:8]
                                  .tolist()))


def _retire_traps(views):
    for v in views:
        for c in v.pending_cores():
            v.clear_pending(c)
            v.park(c)


def _all_parked(ft):
    return bool((ft.sts.priv == 3).all())


@pytest.mark.parametrize("D,nc,kw", [
    (1, 1, {}), (1, 2, {}), (2, 1, {}), (2, 2, {}), (3, 1, {}), (3, 2, {}),
    (2, 2, dict(block_cache=False, dtlb_ways=0))],
    ids=["D1-nc1", "D1-nc2", "D2-nc1", "D2-nc2", "D3-nc1", "D3-nc2",
         "D2-nc2-nocache-dtlb0"])
def test_eager_flat_form_equals_reference_run_chunk_fleet(D, nc, kw):
    progs = _programs(D * 7 + nc, D)
    ft = _loaded(D, nc, progs, **kw)
    jft = JFleetTarget(D, nc, MEM, fetch_kernel="ref", **kw)
    jft.sts = _to_jax(state_to_numpy(ft.sts))
    _assert_equal(_jax_numpy(jft), state_to_numpy(ft.sts), "loaded")
    rng = np.random.RandomState(D * 10 + nc)
    for step in range(300):
        budgets = [int(b) for b in rng.choice(BUDGETS, D)]
        if step == 0:
            budgets[0] = 0              # a board untouched while others run
        ft.run_global(budgets)
        jft.run_global(np.asarray(budgets, np.uint64))
        _assert_equal(_jax_numpy(jft), state_to_numpy(ft.sts),
                      f"chunk {step} budgets {budgets}")
        _retire_traps([ft.view(d) for d in range(D)])
        _retire_traps([jft.view(d) for d in range(D)])
        if _all_parked(ft):
            break
    else:
        raise AssertionError("the programs did not finish")
    assert int(ft.sts.instret.sum()) > 50 * D


def test_stacked_state_round_trips_through_numpy():
    """``convert`` carries a stacked state both ways, with every board's
    image at its own offset of the one buffer."""
    ft = _loaded(3, 2, _programs(2, 3))
    arrs = state_to_numpy(ft.sts)
    assert arrs["mem"].shape == (3, MEM // 8)
    assert arrs["ticks"].shape == (3,)
    back = state_from_numpy(arrs, "cpu")
    assert back.mem.shape == (3, MEM // 8)
    assert back.mem_store.shape == (3 * MEM // 8 + 1,)
    assert back.mem.data_ptr() == back.mem_store.data_ptr()
    _assert_equal(arrs, state_to_numpy(back), "round trip")


@pytest.mark.parametrize("seed", range(3))
def test_boards_are_shared_nothing(seed):
    """Each board after a global chunk equals the same board run alone on
    a ``TorchTarget`` with the same budget — substeps included: the
    argument that lets the fleet kernel give every board a CTA of its own
    that stops at its own loop predicate."""
    D, nc = 3, 2
    progs = _programs(seed + 20, D)
    ft = _loaded(D, nc, progs)
    alone = []
    for src, mmu in progs:
        t = TorchTarget(nc, MEM, device="cpu")
        load_image(t, tasm.assemble(src), nc, mmu)
        alone.append(t)
    rng = np.random.RandomState(seed)
    for step in range(300):
        budgets = [int(b) for b in rng.choice(BUDGETS, D)]
        before = [v.substeps for v in (ft.view(d) for d in range(D))]
        ft.run_global(budgets)
        for d, t in enumerate(alone):
            n = t.substeps
            if budgets[d]:
                t.run(max_cycles=budgets[d])
            assert ft.view(d).substeps - before[d] == t.substeps - n, \
                (step, d)
            _assert_equal(state_to_numpy(t.st),
                          state_to_numpy(ft.view(d).st), (step, d))
        _retire_traps([ft.view(d) for d in range(D)] + alone)
        if _all_parked(ft):
            break
    else:
        raise AssertionError("the programs did not finish")


def test_budget_zero_board_is_untouched():
    """A board of budget 0 keeps every byte while the others run (a
    stalled core on one of them), and a view's one-hot ``run`` leaves
    every other board as it was."""
    D, nc = 3, 2
    ft = _loaded(D, nc, [(LOOP_SRC, d != 1) for d in range(D)])
    ft.run_global([97, 97, 97])
    ft.view(1).redirect(1, 0x10000, resume_tick=10_000)
    for budgets in ([0, 379, 61], [379, 0, 61], [61, 379, 0]):
        frozen = [d for d in range(D) if budgets[d] == 0]
        before = state_to_numpy(ft.sts)
        ft.run_global(budgets)
        after = state_to_numpy(ft.sts)
        for d in frozen:
            for name in cpu.STATE_FIELDS:
                assert np.array_equal(before[name][d], after[name][d]), \
                    (budgets, d, name)
        for d in range(D):
            if budgets[d]:
                assert after["ticks"][d] > before["ticks"][d], (budgets, d)
    before = state_to_numpy(ft.sts)
    ft.view(2).run(max_cycles=200)
    after = state_to_numpy(ft.sts)
    for name in cpu.STATE_FIELDS:
        for d in (0, 1):
            assert np.array_equal(before[name][d], after[name][d]), name
    assert ft.dispatch_count == 5


@pytest.mark.parametrize("seed", range(3))
def test_write_batch_staleness_property_on_a_view(seed):
    """The staleness property of ``tests/test_torch_interface.py`` through
    board 1's view (reads staged after writes in one transaction see the
    staged values; the final state is the sequential model's), leaving the
    other boards untouched, then a chunk from the committed state equal
    to a plain target's."""
    ft = FleetTarget(3, 1, 1 << 20, device="cpu")
    before = state_to_numpy(ft.sts)
    plain = TorchTarget(1, 1 << 20, device="cpu")
    for t in (ft.view(1), plain):
        _run_staleness(_staleness_ops(seed), t)
    after = state_to_numpy(ft.sts)
    for name in cpu.STATE_FIELDS:
        for d in (0, 2):
            assert np.array_equal(before[name][d], after[name][d]), name
    for t in (ft.view(1), plain):
        t.redirect(0, 0x8000)
        t.run(max_cycles=64)
    _assert_equal(state_to_numpy(plain.st), state_to_numpy(ft.view(1).st),
                  "after a chunk")


def test_provision_view_keeps_every_view_valid():
    """Re-provisioning a board resets it in place: a view taken before
    still reads and writes the stack (a rebound stack would leave it
    stale), and the other boards keep their state."""
    ft = _loaded(2, 1, _programs(5, 2))
    v0, v1 = ft.view(0), ft.view(1)
    ft.run_global([97, 97])
    keep = state_to_numpy(ft.sts)
    assert v1.get_ticks() > 0
    fresh = ft.provision_view(1)
    assert fresh is v1
    assert v1.get_ticks() == 0 and v1.get_priv(0) == 3
    assert v1.mem_read_word(0x10000) == 0
    v1.mem_write_word(0x10000, 0x1234_5678)
    v1.reg_write(0, 5, 77)
    assert int(ft.sts.mem[1, 0x10000 >> 3]) == 0x1234_5678
    assert int(ft.sts.regs[1, 0, 5]) == 77
    now = state_to_numpy(ft.sts)
    for name in cpu.STATE_FIELDS:
        assert np.array_equal(keep[name][0], now[name][0]), name
    # a HtpSession over the old view object drives the fresh board
    sess = HtpSession(v1, UartChannel())
    res = sess.submit(HtpTransaction().reg_read(0, 5), 0)
    assert int(res.values[0]) == 77
    assert v0.get_ticks() == int(ft.sts.ticks[0])


def test_view_refuses_to_arm_the_trace_ring():
    ft = FleetTarget(1, 1, 1 << 20, device="cpu")
    with pytest.raises(NotImplementedError, match="single-device"):
        ft.view(0).trace_arm(16)
    ft.view(0).trace_trigger(None)
    assert ft.view(0).trace_drain(0) == ([], 0)


def test_fleet_target_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetTarget(2, 1, 1 << 20)


def test_run_chunk_fleet_refuses_a_budget_per_board_mismatch():
    ft = FleetTarget(2, 1, 1 << 20, device="cpu")
    with pytest.raises(ValueError, match="2 boards"):
        cpu.run_chunk_fleet(ft.sts, 1, 1 << 20, [64])


def test_hello_uart_on_the_stacked_fleet():
    """``run_workload(target="fleet-vmap")`` (board 0 of a one-board
    stack) holds the hello@UART pin, one global chunk a ``run``."""
    rt, rep, _ = run_workload("hello", [], mode="fase", n_cores=1,
                              mem=1 << 22, target="fleet-vmap",
                              device="cpu")
    assert rep.ticks == 6_554_780
    assert rep.stdout == b"hello from FASE target\nanswer 42\n"
    assert rt.target.ft.dispatch_count > 0
    with pytest.raises(ValueError, match="fleet-vmap"):
        run_workload("hello", [], target="jax", device="cpu")
