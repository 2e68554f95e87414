"""The chunk kernel's route and wrapper, on the CPU.

The kernel itself (``csrc/run_chunk.cu``) runs only on a card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold it against the
eager loop there).  Here: which loop ``run_chunk_fast`` picks, what the
wrapper refuses and that its arguments line up with the kernel's C
signature, and the programs the card tests run, held against the
reference's generator and ``PySim``.
"""
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro.core.target import asm as jasm
from repro.core.target.pysim import PySim
from repro_torch.core.interface import TorchTarget
from repro_torch.core.target import cpu
from repro_torch.kernels import _build
from repro_torch.kernels.run_chunk import run_chunk as RC

import torch_shim
from test_cpu_differential import _ProgGen
from test_torch_cpu_differential import CONFIGS
from test_torch_gpu import (FUZZ_CONFIGS, amo_table_program, fuzz_program,
                            _load)

CSRC = Path(__file__).resolve().parent.parent / "src/repro_torch/csrc"
MEM = 1 << 20


def _state(nc=2):
    return cpu.make_state(nc, MEM, device="cpu")


def _cuda_like():
    return SimpleNamespace(mem=SimpleNamespace(is_cuda=True))


def test_route_is_chosen_by_device_and_by_name():
    st = _state()
    assert cpu.chunk_route(st) == "ref"
    assert cpu.chunk_route(st, "kernel") == "ref"
    assert cpu.chunk_route(st, "ref") == "ref"
    assert cpu.chunk_route(_cuda_like()) == "kernel"
    assert cpu.chunk_route(_cuda_like(), "ref") == "ref"
    for bad in ("pallas", "eager", None):
        with pytest.raises(ValueError, match="chunk_kernel must be one of"):
            cpu.chunk_route(st, bad)


def test_cpu_state_runs_the_eager_loop(monkeypatch):
    """A CPU state never reaches the kernel's wrapper, whatever the
    keyword; both names give the same state."""
    def refuse(*a, **k):
        raise AssertionError("the kernel wrapper was called for a CPU state")
    monkeypatch.setattr(cpu.rc_kernel, "run_chunk", refuse)
    img = jasm.assemble("_start:\n    addi t0, t0, 1\n    j _start\n")
    out = {}
    for name in ("kernel", "ref"):
        t = TorchTarget(1, MEM, device="cpu", chunk_kernel=name)
        _load(t, img, 1, mmu=False)
        t.run(max_cycles=40)
        out[name] = (t.substeps, t.reg_read(0, 5), t.get_ticks())
    assert out["kernel"] == out["ref"] == (40, 20, 40)


def test_kernel_route_calls_the_wrapper_once_per_chunk(monkeypatch):
    calls = []

    def record(*args):
        calls.append(args)
        return 16
    monkeypatch.setattr(cpu, "chunk_route", lambda st, name: name)
    monkeypatch.setattr(cpu.rc_kernel, "run_chunk", record)
    st = _state()
    n = cpu.run_chunk_fast(st, 2, MEM, 99, 4, 8, False, "ref", dtlb_ways=2)
    assert n == 16 and calls == [(st, 2, MEM, 99, 4, 8, False, 2, False,
                                  None)]
    t = TorchTarget(2, MEM, device="cpu")
    t.st = st
    t.run(max_cycles=7)
    assert t.substeps == 16 and len(calls) == 2


@pytest.mark.parametrize("name", ["kernel", "ref"])
def test_trace_capture_raises_on_both_routes(monkeypatch, name):
    """Capture into a ring that was never armed (no slots) raises on
    both routes before either loop runs; an armed ring records (the
    cases of tests/test_torch_run_chunk_trace_shim.py and
    tests/test_torch_telemetry*.py)."""
    monkeypatch.setattr(cpu, "chunk_route", lambda st, n: n)
    monkeypatch.setattr(cpu.rc_kernel, "run_chunk", None)
    st = _state()
    with pytest.raises(ValueError, match="armed ring"):
        cpu.run_chunk_fast(st, 2, MEM, 10, trace_on=True, chunk_kernel=name)
    with pytest.raises(ValueError, match="armed ring"):
        cpu.run_chunk_fast(st, 2, MEM, 10, trace_on=True,
                           trigger=("pc", 0, None), chunk_kernel=name)


def test_target_refuses_an_unknown_route():
    with pytest.raises(ValueError, match="chunk_kernel"):
        TorchTarget(1, MEM, device="cpu", chunk_kernel="jit")
    assert TorchTarget(1, MEM, device="cpu").chunk_kernel == "kernel"


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    """The kernel source built for the host (its shared-memory count)."""
    return torch_shim.build("run_chunk", tmp_path_factory.mktemp("shim"))


def _refused(st, match, nc=2, **kw):
    with pytest.raises(ValueError, match=match):
        RC.run_chunk(st, nc, MEM, 64, **kw)


def test_wrapper_refuses_a_cpu_state():
    _refused(_state(), "needs a CUDA state")


def test_wrapper_refuses_a_field_of_another_dtype():
    st = _state()
    st.priv = st.priv.long()
    _refused(st, r"priv must be a contiguous torch.int32")
    st = _state()
    st.pending = st.pending.to(torch.uint8)
    _refused(st, r"pending must be a contiguous torch.bool")


def test_wrapper_refuses_a_field_of_another_shape():
    st = _state()
    st.regs = st.regs[:, :16].contiguous()
    _refused(st, r"regs must be a contiguous torch.int64 tensor of shape "
                 r"\(2, 32\)")
    st = _state()
    st.ticks = st.ticks.reshape(1)
    _refused(st, r"ticks must be .* of shape \(\)")
    with pytest.raises(ValueError, match="mem must be"):
        RC.run_chunk(_state(), 2, 2 * MEM, 64)


def test_wrapper_refuses_a_non_contiguous_field():
    st = _state()
    st.regs = torch.zeros((32, 2), dtype=torch.int64).t()
    _refused(st, r"regs must be .*\(not contiguous\)")


def test_wrapper_refuses_more_lanes_than_a_warp(shim_lib):
    """Past a warp the kernel runs CTA-wide, and past ``cta_lanes`` (384
    at the registry's knobs) on a thread-block cluster, so 33 to 1025
    cores pass the checks (the CPU state then meets the device check);
    past the largest cluster the device schedules (16 CTAs of 384 cores
    here, the host build's answer) the wrapper refuses and names the
    limit, ``cta_lanes`` and the cluster size."""
    assert RC.LANES_MAX == 1024 and RC.WARP_LANES == 32
    for n in (33, 40, 64, 500, 1025):
        _refused(cpu.make_state(n, MEM, device="cpu"), "needs a CUDA state",
                 nc=n)
    assert RC.default_cta_lanes(16, 8, lib=shim_lib) == 384
    assert RC.max_cluster(384, 16, 8, lib=shim_lib) == RC.CLUSTER_MAX == 16
    for n, want in ((32, (384, 1)), (384, (384, 1)), (385, (384, 2)),
                    (1025, (384, 3)), (3072, (384, 8)), (6144, (384, 16)),
                    (40, (32, 2))):
        lanes = 32 if n == 40 else None
        assert RC.layout("run_chunk", n, 16, 8, lanes, lib=shim_lib) == want
    n = 16 * 384 + 1
    with pytest.raises(ValueError, match=f"{n} cores need a cluster of 17 "
                       f"CTAs of cta_lanes 384 cores, and the device "
                       f"schedules at most 16 a cluster: at most 6144 "
                       f"cores"):
        RC.layout("run_chunk", n, 16, 8, lib=shim_lib)
    with pytest.raises(ValueError, match="cta_lanes 32 cores, .* at most 512 "
                       "cores"):
        RC.layout("run_chunk_fleet", 513, 16, 8, 32, lib=shim_lib)
    with pytest.raises(ValueError, match="at least one"):
        RC.check_state(_state(), 0, MEM, 16, 8)
    # 1024 cores with the default TLB and fetch blocks no longer fit one
    # CTA's 227 KB (by the source's own count, its host build): a cluster
    # of three 384-core CTAs takes them, each within the limit
    assert RC.smem_bytes(1024, 16, 8, lib=shim_lib) > RC.SMEM_MAX
    assert RC.cluster_smem_bytes(384, 16, 8, lib=shim_lib) <= RC.SMEM_MAX \
        < RC.cluster_smem_bytes(416, 16, 8, lib=shim_lib)
    # the CTA-wide scratch: a word a warp for 9 sites, two reductions, a
    # store word a thread, after the 8-byte-aligned register files; on a
    # cluster also each rank's two reductions and 9 site summaries
    assert RC.smem_bytes(40, 16, 8, lib=shim_lib) == (
        40 * (32 + 32) * 8 + 40 * 16 * 4 + 9 * 32 * 4 + 2 * 32 * 8 + 64 * 8)
    assert RC.cluster_smem_bytes(64, 16, 8, lib=shim_lib) == \
        RC.smem_bytes(64, 16, 8, lib=shim_lib) + 2 * 16 * 8 + 9 * 16 * 4


def test_wrapper_refuses_knobs_the_kernel_cannot_hold(shim_lib):
    _refused(_state(), "block_words must be a power of two",
             block_words=12)
    _refused(_state(), "dtlb_ways must be a power of two", dtlb_ways=3)
    assert RC.smem_bytes(4, 16, 8, lib=shim_lib) == \
        4 * (32 + 32) * 8 + 4 * 16 * 4
    with pytest.raises(ValueError, match="bytes of shared memory"):
        RC.layout("run_chunk", 32, 1 << 11, 8, lib=shim_lib)
    assert RC.layout("run_chunk", 4, 1 << 11, 8, lib=shim_lib) == (0, 1)
    for lanes in (0, 48, 416):
        with pytest.raises(ValueError, match="cta_lanes must be whole "
                           "warps from 32 up to 384"):
            RC.layout("run_chunk", 500, 16, 8, lanes, lib=shim_lib)


def test_launch_arguments_follow_the_kernel_signature():
    """The wrapper's argument tuple lines up, name by name, with
    ``run_chunk_launch``'s parameters in the CUDA source."""
    src = (CSRC / "run_chunk.cu").read_text()
    sig = re.search(r"int run_chunk_launch\((.*?)\)\s*\{", src, re.S)[1]
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    assert params == ["mem", *(f for f, _, _ in RC.FIELDS), "out", "mask",
                      "limit", "lanes", "issue_width", "block_words",
                      "block_cache", "ways", "cta_lanes", "tracebuf",
                      "trace_n",
                      "trace_armed", "slots", "trace_on", "trig_kind",
                      "trig_disarm", "trig_a", "trig_b", "stream"]
    st = _state()
    out = torch.zeros((2,), dtype=torch.int64)
    args = RC.launch_args(st, out, 2, MEM, 99, 8, 16, True, 8, 384, 0)
    assert len(args) == len(RC._ARGS) == len(params)
    assert args[0] == st.mem.data_ptr() == st.mem_store.data_ptr()
    assert args[1 + [f for f, _, _ in RC.FIELDS].index("priv")] == \
        st.priv.data_ptr()
    assert args[-19:-9] == (out.data_ptr(), MEM - 1, 99, 2, 8, 16, 1, 8, 384,
                            st.tracebuf.data_ptr())
    assert args[-6:] == (0, 0, 0, 0, 0, 0)         # untraced: no gate
    traced = RC.launch_args(st, out, 2, MEM, 99, 8, 16, True, 8, 384, 0,
                            True, ("pc", 0x1000, (1 << 64) - 4))
    assert traced[-6:] == (1, RC.TRIGGER_KINDS["pc"], 1, 0x1000,
                           (1 << 64) - 4, 0)
    assert RC.launch_args(st, out, 2, MEM, 99, 8, 16, True, 8, 384, 0, True,
                          ("instret", 7))[-6:] == (1, 2, 0, 7, 0, 0)
    # the C side sizes shared memory as the wrapper does
    assert "lanes * (32 + 4 * (size_t)ways) * 8" in src
    assert "lanes * block_words * 4" in src


def test_a_shared_header_change_rebuilds(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build._target("k")[1]
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._target("k")[1] != first
    assert set((p.name for p in CSRC.glob("*.cuh"))) == {"page_walk.cuh"}


def test_card_tests_run_the_fuzzers_programs():
    """``tests/test_torch_gpu.py`` runs the lockstep fuzzer's programs
    and axes without importing JAX: the same sources, the same configs."""
    for seed in range(6):
        assert fuzz_program(seed) == _ProgGen(seed).build()
    assert FUZZ_CONFIGS == [p.values[0] for p in CONFIGS]


@pytest.mark.parametrize("kw", FUZZ_CONFIGS[:1] + FUZZ_CONFIGS[3:])
def test_amo_table_program_on_the_eager_loop_equals_pysim(kw):
    """The card test's AMO table (every AMO, W and D, operands above,
    below and negative) on the CPU's eager loop against ``PySim``."""
    img = jasm.assemble(amo_table_program())
    tt = TorchTarget(1, 1 << 21, device="cpu", **kw)
    ps = PySim(1, 1 << 21)
    for t in (tt, ps):
        _load(t, img, 1)
        t.run(max_cycles=1 << 20)
        assert t.pending_cores() == [0]
    out = img.symbols["out"]
    got = [tt.mem_read_word(out + 8 * i) for i in range(144)]
    want = [ps.mem_read_word(out + 8 * i) for i in range(144)]
    assert got == want
    assert len(set(got)) > 10 and tt.csr_read(0, "mcause") == 8
    assert tt.get_instret(0) == ps.get_instret(0) > 500
