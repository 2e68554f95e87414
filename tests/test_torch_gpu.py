"""Tests of the port that need a CUDA device: they skip (with a reason)
where there is none.  On a GPU machine run them with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py

(``--noconftest`` because the shared conftest arms a fixture of the JAX
package; this file imports only the port).  The kernel is held against
its plain version, and the CUDA target against the CPU target, on the
same inputs.  Integer results and the page ops: tolerance 0; the
attention kernels: ``kernels/flash_attention/ref.py::ATTN_TOL`` (1e-5 +
1e-5·|plain| in float32, 1e-6 + 2⁻⁷·|plain|, one rounding step, in
bfloat16)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.interface import TorchTarget
from repro_torch.core.target import asm, isa
from repro_torch.core.target.convert import state_to_numpy
from repro_torch.kernels.page_walk import ops, page_walk

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


def _load(t, img, nc):
    for seg in img.segments:
        data = bytes(seg.data)
        data = data.ljust((len(data) + 7) // 8 * 8, b"\0")
        for i in range(0, len(data), 8):
            t.mem_write_word(seg.vaddr + i,
                             int.from_bytes(data[i:i + 8], "little"))
    root, l1, l0 = 2, 3, 4
    flags = (isa.PTE_V | isa.PTE_R | isa.PTE_W | isa.PTE_X | isa.PTE_U |
             isa.PTE_A | isa.PTE_D)
    t.mem_write_word(root * 4096, (l1 << 10) | isa.PTE_V)
    t.mem_write_word(l1 * 4096, (l0 << 10) | isa.PTE_V)
    for vpn0 in list(range(16, 96)) + list(range(256, 272)):
        t.mem_write_word(l0 * 4096 + vpn0 * 8, (vpn0 << 10) | flags)
    for c in range(nc):
        t.set_satp(c, (8 << 60) | root)
        t.reg_write(c, 10, c)
        t.redirect(c, img.entry)


@pytest.mark.parametrize("nc", [1, 4])
def test_cuda_target_equals_cpu_target(cuda, nc):
    img = asm.assemble(PROGRAM)
    targets = [TorchTarget(nc, 1 << 21, device="cuda"),
               TorchTarget(nc, 1 << 21, device="cpu")]
    for t in targets:
        _load(t, img, nc)
    before = page_walk.walk_fetch_block.launches
    for _ in range(40):
        for t in targets:
            t.run(max_cycles=97)
        a, b = (state_to_numpy(t.st) for t in targets)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        for t in targets:
            for c in t.pending_cores():
                t.clear_pending(c)
                t.park(c)
        if all(t.get_priv(c) == 3 for t in targets for c in range(nc)):
            break
    else:
        raise AssertionError("program did not finish")
    assert targets[0].get_instret(0) > 200
    assert page_walk.walk_fetch_block.launches > before


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
