"""The PyTorch target CPU model (the "FPGA" role).

State is a dataclass of device tensors.  On the card
:func:`run_chunk_fast` runs a whole chunk in one launch of the chunk
kernel (``csrc/run_chunk.cu``); its plain version, and the CPU's route,
is the eager loop described here: the memory image and the register file
are updated in place, the small per-core vectors are rebound, and a
host-driven loop steps them: all cores execute one global tick
as lane-vectorized tensor math (:func:`_exec_substep`), a chunk-local
fetch-block cache skips the Sv39 fetch walk and instruction gather for
straight-line code, a chunk-local data-translation cache does the same
for loads/stores, and the loop predicate is tested once per
``issue_width`` ticks.  When every live core is stalled on
``stall_until`` the substep fast-forwards time to the next wake-up —
channel-induced stalls cost no work.

This is the port of the reference's fast path
(``repro.core.target.cpu.run_chunk_fast``): one instruction per
non-stalled core per tick, cores stepping in core-index order within a
tick.  Same-tick memory dependencies between cores are detected *before*
any write lands and only the conflict-free prefix of the core order is
applied (the rest of the tick replays from post-commit state), so
multicore interleaving, LR/SC and self-modifying code stay bit-identical
to the reference and to its pure-Python twin.

Every u64 quantity is a ``torch.int64`` bit pattern
(:mod:`repro_torch.core.target.u64`); ``priv`` is ``int32`` and
``pending`` is ``bool``.  The word- and page-granular helpers at the
bottom are the device-side halves of the HTP data-access requests
(``MemR/MemW/PageS/PageCP/PageR/PageW``) and of the batched
register/CSR/word reads and writes.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from . import isa
from . import u64
from .u64 import srl, sx, uge, ugt, ult
from ...kernels.page_walk import ops as pw_ops
from ...kernels.page_walk import ref as pw_ref
from ...kernels.run_chunk import run_chunk as rc_kernel

I64 = torch.int64
#: ``consts._RES_INVALID`` / ``consts.NO_WORD`` in int64 storage
RES_INVALID = -1
NO_WORD = -1
_M32 = 0xFFFFFFFF

#: major opcodes in the column order :func:`_exec_substep` unpacks them
_OPCODES = (isa.OP_LOAD, isa.OP_MISC_MEM, isa.OP_IMM, isa.OP_AUIPC,
            isa.OP_IMM_32, isa.OP_STORE, isa.OP_AMO, isa.OP_OP, isa.OP_LUI,
            isa.OP_OP_32, isa.OP_BRANCH, isa.OP_JALR, isa.OP_JAL,
            isa.OP_SYSTEM)
#: opcode classes whose retirement writes ``rd``
_WRITES_RD = (isa.OP_LOAD, isa.OP_IMM, isa.OP_AUIPC, isa.OP_IMM_32,
              isa.OP_AMO, isa.OP_OP, isa.OP_LUI, isa.OP_OP_32, isa.OP_JALR,
              isa.OP_JAL)
#: AMO funct5 values in the column order of the ``amo_new`` candidates
_AMO_F5 = (isa.AMO_SWAP, isa.AMO_ADD, isa.AMO_XOR, isa.AMO_AND, isa.AMO_OR,
           isa.AMO_MIN, isa.AMO_MAX, isa.AMO_MINU)


@dataclass
class CpuState:
    regs: torch.Tensor          # (nc, 32) i64
    pc: torch.Tensor            # (nc,) i64
    priv: torch.Tensor          # (nc,) i32 — 0 user, 3 parked
    pending: torch.Tensor       # (nc,) bool
    stall_until: torch.Tensor   # (nc,) i64
    satp: torch.Tensor          # (nc,) i64
    mcause: torch.Tensor        # (nc,) i64
    mepc: torch.Tensor          # (nc,) i64
    mtval: torch.Tensor         # (nc,) i64
    res: torch.Tensor           # (nc,) i64 LR reservation pa, -1 = invalid
    mem: torch.Tensor           # (mem_bytes // 8,) i64 — view of mem_store
    ticks: torch.Tensor         # () i64
    uticks: torch.Tensor        # (nc,) i64
    instret: torch.Tensor       # (nc,) i64
    # -- model counters (not snapshot state) ------------------------------
    stall_ticks: torch.Tensor   # (nc,) ticks spent active-but-stalled
    fetch_hits: torch.Tensor    # (nc,) fetch-block cache hits
    fetch_walks: torch.Tensor   # (nc,) fetch-block fills/walks
    tlb_walks: torch.Tensor     # (nc,) data-TLB walks (dtlb_ways > 0)
    # -- commit-trace ring (recorded with trace_on) -----------------------
    tracebuf: torch.Tensor      # (nc, slots, 4) i64
    trace_n: torch.Tensor       # (nc,) i64
    trace_armed: torch.Tensor   # (nc,) bool
    #: backing buffer of ``mem`` with one extra word at the end: masked-out
    #: stores are scattered there instead of being dropped
    mem_store: torch.Tensor     # (mem_bytes // 8 + 1,) i64

    @property
    def device(self):
        return self.mem.device


#: the fields that make up the architectural + counter state (everything
#: but the backing buffer), in the reference's order
STATE_FIELDS = tuple(f.name for f in fields(CpuState)
                     if f.name != "mem_store")


def make_state(n_cores: int, mem_bytes: int, trace_slots: int = 0,
               device="cuda") -> CpuState:
    assert mem_bytes & (mem_bytes - 1) == 0, "mem_bytes must be pow2"
    nc = n_cores
    dev = torch.device(device)

    def z():
        return torch.zeros((nc,), dtype=I64, device=dev)

    store = torch.zeros((mem_bytes // 8 + 1,), dtype=I64, device=dev)
    return CpuState(
        regs=torch.zeros((nc, 32), dtype=I64, device=dev), pc=z(),
        priv=torch.full((nc,), 3, dtype=torch.int32, device=dev),
        pending=torch.zeros((nc,), dtype=torch.bool, device=dev),
        stall_until=z(), satp=z(), mcause=z(), mepc=z(), mtval=z(),
        res=torch.full((nc,), RES_INVALID, dtype=I64, device=dev),
        mem=store[:-1], ticks=torch.zeros((), dtype=I64, device=dev),
        uticks=z(), instret=z(),
        stall_ticks=z(), fetch_hits=z(), fetch_walks=z(), tlb_walks=z(),
        tracebuf=torch.zeros((nc, trace_slots, 4), dtype=I64, device=dev),
        trace_n=z(),
        trace_armed=torch.zeros((nc,), dtype=torch.bool, device=dev),
        mem_store=store,
    )


def _pick(cands, idx):
    """``cands[idx[l]][l]`` per lane: one stack + one gather instead of a
    chain of selects."""
    return torch.stack(cands, dim=1).gather(1, idx[:, None])[:, 0]


def _alu64(f3, is_sub, is_sra, is_m, a, b):
    sh = b & 63
    base = _pick([
        torch.where(is_sub, a - b, a + b),
        a << sh,
        (a < b).to(I64),
        ult(a, b).to(I64),
        a ^ b,
        torch.where(is_sra, a >> sh, u64.srl_v(a, sh)),
        a | b,
        a & b], f3)
    q, r = u64.sdiv_parts(a, b)
    uq, ur = u64.udiv_parts(a, b)
    mulhu = u64.mulhu(a, b)
    a_neg_b = torch.where(a < 0, b, 0)
    mulhsu = mulhu - a_neg_b
    mulh = mulhsu - torch.where(b < 0, a, 0)
    m = _pick([a * b, mulh, mulhsu, mulhu, q, uq, r, ur], f3)
    return torch.where(is_m, m, base)


def _alu32(f3, is_sub, is_sra, is_m, a, b):
    a32 = a & _M32
    b32 = b & _M32
    sa = sx(a32, 32)
    sb = sx(b32, 32)
    sh = b & 31
    shr = torch.where(is_sra, sa >> sh, a32 >> sh)
    base = torch.where(f3 == 0, torch.where(is_sub, a - b, a + b),
                       torch.where(f3 == 1, a32 << sh, shr))
    q, r = u64.sdiv_parts(sa, sb, int_min=-(1 << 31))
    div0 = b32 == 0
    uden = torch.where(div0, 1, b32)
    uq = torch.div(a32, uden, rounding_mode="trunc")
    ur = torch.where(div0, a32, a32 - uq * uden)
    uq = torch.where(div0, -1, uq)
    # f3 1..3 are not W-form M ops; the reference's select leaves `ur`
    # there, and so does this table
    m = _pick([a32 * b32, ur, ur, ur, q, uq, r, ur], f3)
    return sx(torch.where(is_m, m, base) & _M32, 32)


@dataclass
class FetchBlocks:
    """Per-core fetch-block cache: one translated, pre-gathered run of
    consecutive instruction slots per core.  Strictly chunk-local — it is
    rebuilt empty on every :func:`run_chunk_fast` call, so host-side
    writes between chunks (redirect, sfence, satp/CSR writes, page loads)
    can never serve stale without any explicit invalidation protocol.
    Within a chunk, any committed store that lands inside a cached range
    zeroes that block's ``nbytes``.  A guest store into the *page tables*
    that translated a block does not invalidate it (the delayed-shootdown
    envelope the reference documents)."""

    vbase: torch.Tensor    # (nc,) virtual address of the first slot
    pbase: torch.Tensor    # (nc,) its physical address
    nbytes: torch.Tensor   # (nc,) valid bytes cached (0 = invalid)
    insts: torch.Tensor    # (nc, block_words) i64, zero-extended u32 slots


def _empty_blocks(nc, block_words, dev) -> FetchBlocks:
    def z():
        return torch.zeros((nc,), dtype=I64, device=dev)
    return FetchBlocks(z(), z(), z(),
                       torch.zeros((nc, block_words), dtype=I64, device=dev))


@dataclass
class DTlb:
    """Chunk-local per-lane data-translation cache — the load/store twin
    of :class:`FetchBlocks`.  Direct-mapped on ``vpn & (ways - 1)``, one
    row per lane, 4 KiB (level-0) leaves only.  Rebuilt empty every
    :func:`run_chunk_fast` call; no satp tag (the guest ISA carries no
    CSR writes, so a lane's ``satp`` cannot change inside a chunk).
    Within a chunk a committed store over a cached entry's backing leaf
    PTE kills the entry (``ptw`` match)."""

    vpn: torch.Tensor     # (L, ways) tag; NO_WORD = empty way
    ppn: torch.Tensor     # (L, ways) post-mask physical page number
    perms: torch.Tensor   # (L, ways) leaf PTE permission byte
    ptw: torch.Tensor     # (L, ways) word index of the backing PTE


def _empty_dtlb(lanes, ways, dev) -> DTlb:
    def z():
        return torch.zeros((lanes, ways), dtype=I64, device=dev)
    return DTlb(torch.full((lanes, ways), NO_WORD, dtype=I64, device=dev),
                z(), z(), z())


@dataclass
class _Fleet:
    """The flat-fleet form's lane layout: ``D`` boards of ``nc`` lanes,
    lane ``l`` is core ``l % nc`` of board ``l // nc``."""
    D: int
    nc: int
    board: torch.Tensor       # (L,) board of each lane
    base: torch.Tensor        # (L,) word offset of its board's image
    local: torch.Tensor       # (L,) core index within its board
    same: torch.Tensor        # (L, L) bool: lanes of one board


@dataclass
class _Chunk:
    """Per-chunk constants and the carried loop scalars (all on device)."""
    mask: int
    block_words: int
    block_cache: bool
    dtlb_ways: int
    fetch_kernel: str
    lanes: torch.Tensor       # (L,) arange
    earlier: torch.Tensor     # (L, L) bool: row lane executes before column
    other: torch.Tensor       # (L, L) bool: different lanes
    opcodes: torch.Tensor     # (14,)
    writes_rd: torch.Tensor   # (14,) bool: opcode classes that write rd
    amo_col: torch.Tensor     # (32,) funct5 -> column of the AMO candidates
    way_ids: torch.Tensor     # (1, ways)
    #: the flat-fleet form (:func:`run_chunk_fleet`); None for one target
    fleet: _Fleet | None = None
    #: record retirements into the commit-trace ring (one target only)
    trace_on: bool = False
    #: the capture-window spec (``repro_torch.telemetry.triggers``)
    trigger: tuple | None = None


def _chunk_consts(lanes, mask, block_words, block_cache, dtlb_ways,
                  fetch_kernel, fleet=None, trace_on=False,
                  trigger=None) -> _Chunk:
    """The per-chunk constants over the lane vector ``lanes``; with
    ``fleet`` the lane order and the store invalidation only relate lanes
    of one board."""
    dev = lanes.device
    earlier = lanes[:, None] < lanes[None, :]
    other = lanes[:, None] != lanes[None, :]
    if fleet is not None:
        earlier = earlier & fleet.same
        other = other & fleet.same
    return _Chunk(
        mask=mask, block_words=block_words, block_cache=block_cache,
        dtlb_ways=dtlb_ways, fetch_kernel=fetch_kernel, lanes=lanes,
        earlier=earlier, other=other,
        opcodes=torch.tensor(_OPCODES, dtype=I64, device=dev),
        writes_rd=torch.tensor([o in _WRITES_RD for o in _OPCODES],
                               device=dev),
        amo_col=torch.tensor([_AMO_F5.index(f) if f in _AMO_F5 else 8
                              for f in range(32)], dtype=I64, device=dev),
        way_ids=torch.arange(max(dtlb_ways, 1), dtype=I64,
                             device=dev)[None, :],
        fleet=fleet, trace_on=trace_on, trigger=trigger)


def _exec_substep(st: CpuState, fb: FetchBlocks, dtlb: DTlb, exec_from,
                  gate, budget_left, k: _Chunk):
    """One substep: a whole global tick in the common case.

    Executes every candidate lane from the pre-substep state, then checks
    whether core-index execution order could have produced a different
    result: an earlier core committing a store into a later core's read
    set (fetch word, PTE walk words, data word), into the same word a
    later core also writes, or onto a line a later core holds an LR
    reservation for.  Only the conflict-free *prefix* of the core order
    is applied; ``exec_from`` (the first lane still owed this tick's
    issue) is returned non-zero and the next substep re-executes the
    deferred lanes from post-commit state — exactly the sequential
    core-order result.  The tick counter advances only when a tick
    completes, and a tick whose every live lane is stalled fast-forwards
    the clock to the next wake-up (clamped to ``budget_left``).

    ``gate`` is the 0-d "a new tick may start" predicate; a
    partially-executed tick always finishes regardless (a trap raised
    mid-tick never stops the later cores of that same tick).  A substep
    with ``gate`` false and ``exec_from`` 0 has no candidate lane and no
    skip, so it changes nothing — which is what lets the caller test its
    loop predicate only every ``issue_width`` substeps.

    Updates ``st``/``fb``/``dtlb`` in place; returns ``(exec_from',
    dticks)`` as 0-d tensors.  The only host synchronisation is one
    ``any()`` read deciding whether a data-side walk is needed.

    With ``k.fleet`` this is the flat-fleet form (the reference's
    ``mem_words > 0`` branches): ``st`` holds ``D * nc`` lanes keyed
    (board, core), ``st.mem`` is every board's image end to end (each
    lane reads and writes its own board's words through ``base``),
    ``st.ticks``, ``exec_from``, ``gate`` and ``budget_left`` are ``(D,)``
    vectors, and every cross-lane relation (core order, conflicts, store
    invalidation, cache kills) holds between lanes of one board only, so
    each board advances as it would alone; ``exec_from'`` and ``dticks``
    come back as ``(D,)`` vectors.
    """
    mem = st.mem
    mask = k.mask
    pc, satp, res, regs, stall = st.pc, st.satp, st.res, st.regs, \
        st.stall_until
    ticks = st.ticks
    lanes = k.lanes
    f = k.fleet
    active = st.priv != 3
    cont = exec_from > 0
    if f is None:
        base = None
        ticks_lane = ticks
        # not parked (priv != 3) — NOT priv == 0: S-mode cores execute too
        runnable = active & ~st.pending & uge(ticks, stall)
        cand = (cont | gate) & runnable & (lanes >= exec_from)
    else:
        # per-board scalars became (D,) vectors, gathered per lane
        base = f.base
        ticks_lane = ticks[f.board]
        runnable = active & ~st.pending & uge(ticks_lane, stall)
        cand = (cont | gate)[f.board] & runnable & \
            (f.local >= exec_from[f.board])

    # ---- fetch: block cache hit / walk+fill on miss --------------------
    if k.block_cache:
        off = pc - fb.vbase                      # wraps huge when below
        hit = cand & ult(off, fb.nbytes) & ((off & 3) == 0)
    else:
        off = torch.zeros_like(pc)
        hit = torch.zeros_like(cand)
    miss = cand & ~hit
    # launched every substep with the miss mask instead of branching on
    # any(miss) (a host sync): masked-out lanes come back as "no walk"
    wpa, wfault, wwords, winsts32, wnb = pw_ops.walk_fetch_block(
        mem, satp, pc, mask, k.block_words, base, miss,
        impl=k.fetch_kernel)
    winsts = winsts32.to(I64) & _M32
    ipa = torch.where(hit, fb.pbase + off, wpa)
    ifault = wfault                              # already masked by miss
    slot = (off >> 2) & (k.block_words - 1)
    inst_hit = fb.insts.gather(1, slot[:, None])[:, 0]
    inst = torch.where(hit, inst_hit, winsts[:, 0])

    if k.block_cache:
        fill = miss & ~wfault
        fb.vbase = torch.where(fill, pc, fb.vbase)
        fb.pbase = torch.where(fill, wpa, fb.pbase)
        fb.nbytes = torch.where(fill, wnb, fb.nbytes)
        fb.insts = torch.where(fill[:, None], winsts, fb.insts)

    # ---- decode (inst is a zero-extended u32, so >> is logical) --------
    op = inst & 0x7F
    rd = (inst >> 7) & 0x1F
    f3 = (inst >> 12) & 7
    rs1 = (inst >> 15) & 0x1F
    rs2 = (inst >> 20) & 0x1F
    f7 = inst >> 25
    imm_i = sx(inst >> 20, 12)
    imm_s = sx((f7 << 5) | rd, 12)
    imm_b = sx((((inst >> 8) & 0xF) << 1) |
               (((inst >> 25) & 0x3F) << 5) |
               (((inst >> 7) & 1) << 11) |
               ((inst >> 31) << 12), 13)
    imm_u = sx(inst & 0xFFFFF000, 32)
    imm_j = sx((((inst >> 21) & 0x3FF) << 1) |
               (((inst >> 20) & 1) << 11) |
               (((inst >> 12) & 0xFF) << 12) |
               ((inst >> 31) << 20), 21)

    ab = regs.gather(1, torch.stack([rs1, rs2], dim=1))
    a, b = ab[:, 0], ab[:, 1]

    is_op_col = op[:, None] == k.opcodes
    (is_load, is_fence, is_opimm, is_auipc, is_opimm32, is_store, is_amo,
     is_op, is_lui, is_op32, is_branch, is_jalr, is_jal,
     is_system) = is_op_col.unbind(1)
    is_ecall = is_system & (inst == isa.INST_ECALL)
    is_ebreak = is_system & (inst == isa.INST_EBREAK)
    illegal = ~(is_op_col[:, :13].any(1) | is_ecall | is_ebreak)

    # ---- ALU ----------------------------------------------------------
    reg_form = is_op | is_op32
    bop = torch.where(reg_form, b, imm_i)
    is_m = reg_form & (f7 == 1)
    f7_20 = f7 == 0x20
    is_sub = reg_form & f7_20 & (f3 == 0)
    is_sra = torch.where(reg_form, f7_20, ((inst >> 30) & 1) != 0) & \
        (f3 == 5)
    alu_w = _alu64(f3, is_sub, is_sra, is_m, a, bop)
    alu_w32 = _alu32(f3, is_sub, is_sra, is_m, a, bop)

    # ---- data memory access -------------------------------------------
    funct5 = f7 >> 2
    is_lr = is_amo & (funct5 == isa.AMO_LR)
    is_sc = is_amo & (funct5 == isa.AMO_SC)
    dva = torch.where(is_amo, a, a + torch.where(is_store, imm_s, imm_i))
    is_memop = is_load | is_store | is_amo
    want_w = is_store | (is_amo & ~is_lr)
    no_exec = torch.zeros_like(cand)
    dfill = None
    if k.dtlb_ways:
        # data-TLB lookup: a hit replays the cached 4 KiB leaf translation
        # and re-checks the cached permission byte for THIS access (a
        # load-filled entry must still refuse a store on an R-only page —
        # that falls through to a real walk).  Only true misses walk, and
        # only their PTE words enter the same-tick conflict read set.
        bare = srl(satp, 60) != 8
        vpn = srl(dva, 12)
        way = (vpn & (k.dtlb_ways - 1))[:, None]
        tag = dtlb.vpn.gather(1, way)[:, 0]
        tppn = dtlb.ppn.gather(1, way)[:, 0]
        tperm = dtlb.perms.gather(1, way)[:, 0]
        dneed = isa.PTE_U | torch.where(want_w, isa.PTE_W, isa.PTE_R)
        xlate = cand & is_memop & ~bare
        dhit = xlate & (tag == vpn) & ((tperm & dneed) == dneed)
        dwalk = xlate & ~dhit
        hit_pa = ((tppn << 12) | (dva & 0xFFF)) & mask
        if bool(dwalk.any()):                    # the substep's one sync
            wdpa, wdfault, dwords, wperms, wleaf0, wptw = \
                pw_ref.sv39_walk_leaf(mem, satp, dva, want_w, no_exec, mask,
                                      base)
            dpa = torch.where(dhit, hit_pa,
                              torch.where(bare, dva & mask, wdpa))
            dfault = dwalk & wdfault
            dwords = torch.where(dwalk[:, None], dwords, NO_WORD)
            dfill = dwalk & ~dfault & wleaf0     # & safe, once known
        else:
            dpa = torch.where(dhit, hit_pa,
                              torch.where(bare, dva & mask, 0))
            dfault = no_exec
            dwords = None
    else:
        dwalk = cand & is_memop
        dpa, dfault, dwords = pw_ref.sv39_walk_ref(mem, satp, dva, want_w,
                                                   no_exec, mask, base)
        dwords = torch.where(dwalk[:, None], dwords, NO_WORD)
    szb = torch.where(is_amo, torch.where(f3 == 2, 4, 8), 1 << (f3 & 3))
    misal = is_memop & ((dva & (szb - 1)) != 0)

    stw = dpa >> 3                               # dpa is masked: >= 0
    stw_g = stw if base is None else base + stw  # the word in the buffer
    dword = mem[stw_g]
    dshift = (dpa & 7) << 3
    raw = dword >> dshift                        # sign copies masked below
    # all ones for 8 bytes: (1 << 64) wraps to 0, minus 1
    sizemask = torch.where(szb == 8, -1, (1 << (szb << 3)) - 1)
    rawv = raw & sizemask
    uns = (f3 & 4) != 0
    sbit = 1 << ((szb << 3) - 1)                 # wraps to MIN for 8 bytes
    loaded = torch.where(uns, rawv, (rawv ^ sbit) - sbit)

    # ---- AMO ----------------------------------------------------------
    amo_w = f3 == 2
    amo_old = rawv
    amo_b = b & sizemask
    s_old = torch.where(amo_w, sx(amo_old, 32), amo_old)
    s_b = torch.where(amo_w, sx(amo_b, 32), amo_b)
    amo_cands = torch.stack([
        amo_b, amo_old + amo_b, amo_old ^ amo_b, amo_old & amo_b,
        amo_old | amo_b,
        torch.where(s_old < s_b, amo_old, amo_b),
        torch.where(s_old > s_b, amo_old, amo_b),
        torch.where(ult(amo_old, amo_b), amo_old, amo_b),
        torch.where(ugt(amo_old, amo_b), amo_old, amo_b)], dim=1)
    # funct5 -> candidate column; anything unlisted takes the last one
    # (AMOMAXU), the reference select's default
    amo_new = amo_cands.gather(1, k.amo_col[funct5][:, None])[:, 0]
    sc_ok = is_sc & (res == dpa)
    amo_rdval = torch.where(is_sc, (~sc_ok).to(I64), s_old)

    # ---- traps --------------------------------------------------------
    ma_cause = torch.where(is_load | is_lr, 4, 6)
    pf_cause = torch.where(want_w, 15, 13)
    dtrap = is_memop & (misal | dfault)
    traps = ifault | illegal | is_ecall | is_ebreak | dtrap
    cause = torch.where(
        ifault, 12,
        torch.where(illegal, 2,
                    torch.where(is_ecall, 8,
                                torch.where(is_ebreak, 3,
                                            torch.where(misal, ma_cause,
                                                        pf_cause)))))
    tval = torch.where(
        ifault, pc,
        torch.where(illegal, inst,
                    torch.where(is_ecall | is_ebreak, 0, dva)))

    commit = cand & ~traps & (is_store |
                              (is_amo & ~is_lr & (~is_sc | sc_ok)))

    # ---- same-tick conflict detection ---------------------------------
    # Read set of lane j: the executed instruction word (cache hits read
    # it through fb content, which is kept equal to memory), the PTE
    # words its walks touched, and its data word.  Only a store by an
    # EARLIER core (i < j) can change what core j would have observed
    # under sequential core-order execution, so the applied set is the
    # prefix of the core order up to the first lane whose inputs an
    # earlier commit may have touched; the rest re-run next substep.
    read_cols = [torch.where(cand, ipa >> 3, NO_WORD)[:, None],
                 torch.where(cand & is_memop, stw, NO_WORD)[:, None],
                 wwords]                         # NO_WORD unless miss
    if dwords is not None:
        read_cols.append(dwords)
    reads = torch.cat(read_cols, dim=1)                    # (L, 5 or 8)
    res_word = torch.where(cand & (res != RES_INVALID), res >> 3, NO_WORD)
    wr = commit[:, None] & k.earlier                       # (i, j)
    read_hit = (stw[:, None, None] == reads[None, :, :]).any(-1)
    same_word = stw[:, None] == stw[None, :]
    st_hit = commit[None, :] & same_word
    res_hit = stw[:, None] == res_word[None, :]
    conf = (wr & (read_hit | st_hit | res_hit)).any(0)     # per j
    if f is None:
        safe = cand & (conf.cumsum(0) == 0)
    else:
        # the prefix is per board: a conflict on one board never defers
        # another board's lanes
        safe = cand & (conf.view(f.D, f.nc).cumsum(1).view(-1) == 0)
    deferred = cand & ~safe

    tr = safe & traps
    ret = safe & ~traps
    commit = commit & safe

    # ---- memory commit -------------------------------------------------
    sval = torch.where(is_store | is_sc, b, amo_new)
    wmask = sizemask << dshift
    new_word = (dword & ~wmask) | ((sval << dshift) & wmask)
    # masked-out lanes write the spare word behind the image
    widx = torch.where(commit, stw_g, mem.shape[0])
    st.mem_store.index_put_((widx,), new_word)

    # ---- reservations ---------------------------------------------------
    # Own update first (LR acquires, SC always clears), then invalidation
    # by any other core's commit to the same line.  An earlier store onto
    # a line a later core LRs in the same tick is unreachable here — the
    # LR's data read defers that lane to the next substep.
    own = torch.where(ret & is_lr, dpa,
                      torch.where(ret & is_sc, RES_INVALID, res))
    # own >> 3 arithmetic: -1 stays -1 and matches no (non-negative) stw
    inv = (commit[:, None] & k.other &
           (stw[:, None] == (own >> 3)[None, :])).any(0)
    st.res = torch.where(inv, RES_INVALID, own)

    # ---- next pc / register writeback ----------------------------------
    # f3 2/3 are not branches; the reference's select falls through to
    # its default (BGEU's compare) there — keep that for bit-identity
    ge_u = uge(a, b)
    taken = is_branch & _pick([a == b, a != b, ge_u, ge_u, a < b, a >= b,
                               ~ge_u, ge_u], f3)
    pc4 = pc + 4
    next_pc = torch.where(taken, pc + imm_b, pc4)
    next_pc = torch.where(is_jal, pc + imm_j, next_pc)
    next_pc = torch.where(is_jalr, (a + imm_i) & ~1, next_pc)

    wval = torch.where(is_opimm | is_op, alu_w, 0)
    wval = torch.where(is_opimm32 | is_op32, alu_w32, wval)
    wval = torch.where(is_load, loaded, wval)
    wval = torch.where(is_lui, imm_u, wval)
    wval = torch.where(is_auipc, pc + imm_u, wval)
    wval = torch.where(is_jal | is_jalr, pc4, wval)
    wval = torch.where(is_amo, amo_rdval, wval)
    wen = ret & (is_op_col & k.writes_rd).any(1) & (rd != 0)
    # x0 is hard-wired 0 and never written, so it takes the masked-out
    # lanes' (zero) writes
    st.regs.scatter_(1, torch.where(wen, rd, 0)[:, None],
                     torch.where(wen, wval, 0)[:, None])

    if k.block_cache:
        # content coherence: a committed store into any cached range
        # (including a block filled this very tick) kills that block;
        # physical byte addresses are < mem_bytes, so signed compares
        stb = stw << 3
        over = (commit[:, None] & ((stb[:, None] + 8) > fb.pbase[None, :])
                & (stb[:, None] < (fb.pbase + fb.nbytes)[None, :]))
        if f is not None:
            over = over & f.same
        fb.nbytes = torch.where(over.any(0), 0, fb.nbytes)

    if k.dtlb_ways:
        if dfill is not None:
            # fill: applied (safe) walk lanes that reached a 4 KiB leaf
            # cache it in their own row; deferred lanes re-walk next
            # substep and fill then, so a fill never captures a
            # pre-conflict translation
            put = (dfill & safe)[:, None] & (k.way_ids == way)
            dtlb.vpn = torch.where(put, vpn[:, None], dtlb.vpn)
            dtlb.ppn = torch.where(put, srl(wdpa, 12)[:, None], dtlb.ppn)
            dtlb.perms = torch.where(put, wperms[:, None], dtlb.perms)
            dtlb.ptw = torch.where(put, wptw[:, None], dtlb.ptw)
        # store-overlap: a committed store onto any entry's backing leaf
        # PTE word (including one filled this very tick) kills the entry
        phit = stw[:, None, None] == dtlb.ptw[None, :, :]
        if f is not None:
            phit = phit & f.same[:, :, None]
        pinv = (commit[:, None, None] & phit).any(0)
        dtlb.vpn = torch.where(pinv, NO_WORD, dtlb.vpn)

    # ---- tick bookkeeping ----------------------------------------------
    # The tick completes when no candidate lane was deferred; a fresh
    # tick whose every live lane is stalled fast-forwards the clock to
    # the next wake-up instead.
    wait = stall - ticks_lane
    gaps = torch.where(active, wait, -1)         # -1: the largest u64
    if f is None:
        any_def = deferred.any()
        started = cand.any() | cont
        tick_done = started & ~any_def
        skip = gate & ~cont & ~runnable.any() & active.any()
        gap = u64.umin(u64.umin_reduce(gaps), budget_left)
        dticks = torch.where(tick_done, 1, torch.where(skip, gap, 0))
        new_from = torch.where(any_def, deferred.to(I64).argmax(), 0)
        dticks_lane = dticks
    else:
        # every reduction becomes a segmented per-board one: each board
        # keeps its own clock, skip arm and deferred-lane resume point
        def dany(v):
            return v.view(f.D, f.nc).any(1)
        any_def = dany(deferred)
        started = dany(cand) | cont
        tick_done = started & ~any_def
        skip = gate & ~cont & ~dany(runnable) & dany(active)
        gap = u64.umin(u64.umin_rows(gaps.view(f.D, f.nc)), budget_left)
        dticks = torch.where(tick_done, 1, torch.where(skip, gap, 0))
        new_from = torch.where(
            any_def, deferred.view(f.D, f.nc).to(I64).argmax(1), 0)
        dticks_lane = dticks[f.board]
    retired = ret.to(I64)

    # ---- model counters -------------------------------------------------
    # On a completed exec tick every active-but-stalled core accrues 1;
    # on a skip tick every active core accrues the fast-forward gap; a
    # deferred substep (dticks = 0) accrues nothing.
    stalled = active & ugt(stall, ticks_lane)
    dstall = torch.where(stalled, u64.umin(wait, dticks_lane), 0)

    if k.trace_on:
        _trace_record(st, k.trigger, ret, pc, inst)

    st.pc = torch.where(ret, next_pc, pc)
    st.pending = st.pending | tr
    st.mcause = torch.where(tr, cause, st.mcause)
    st.mepc = torch.where(tr, pc, st.mepc)
    st.mtval = torch.where(tr, tval, st.mtval)
    st.ticks = ticks + dticks
    st.uticks = st.uticks + retired
    st.instret = st.instret + retired
    st.stall_ticks = st.stall_ticks + dstall
    st.fetch_hits = st.fetch_hits + (hit & safe)
    st.fetch_walks = st.fetch_walks + (miss & safe)
    if k.dtlb_ways:
        st.tlb_walks = st.tlb_walks + (dwalk & safe)
    return new_from, dticks


def _trace_record(st: CpuState, trigger, ret, pc, inst):
    """The commit-trace ring at the retire point (the reference's
    ``cpu.py:1021-1060``): each retiring lane whose capture gate is open
    writes one ``(tick, pc, inst, priv)`` record — the pre-substep clock,
    the retiring pc and instruction word — to row ``trace_n % slots`` of
    its ring and counts it in ``trace_n``.  Non-retiring lanes write
    nothing (the reference's out-of-range row becomes a mask).  The gate:
    none; ``("tick", t0, t1)``: ``t0 <= tick < t1``; ``("instret", n)``:
    the pre-retirement ``instret >= n``; ``("pc" | "inst", arm,
    disarm)``: a sticky arm bit, set by a retirement of ``arm`` (that
    record captured) and cleared after a retirement of ``disarm`` (that
    record captured too).  Updates ``st`` in place; no host sync."""
    slots = st.tracebuf.shape[1]
    cap = ret
    if trigger is not None:
        kind = trigger[0]
        if kind == "tick":
            cap = ret & uge(st.ticks, trigger[1]) & ult(st.ticks, trigger[2])
        elif kind == "instret":
            cap = ret & uge(st.instret, trigger[1])
        else:
            val = pc if kind == "pc" else inst
            armed = st.trace_armed | (ret & (val == u64.to_signed(trigger[1])))
            cap = ret & armed
            if trigger[2] is not None:
                armed = armed & ~(ret & (val == u64.to_signed(trigger[2])))
            st.trace_armed = armed
    rec = torch.stack([st.ticks.expand(pc.shape[0]), pc, inst,
                       st.priv.to(I64)], dim=1)
    row = torch.remainder(st.trace_n, slots)     # trace_n < 2**63
    buf = st.tracebuf
    old = buf.gather(1, row[:, None, None].expand(-1, 1, 4))[:, 0]
    buf.scatter_(1, row[:, None, None].expand(-1, 1, 4),
                 torch.where(cap[:, None], rec, old)[:, None])
    st.trace_n = st.trace_n + cap


#: the two routes of :func:`run_chunk_fast`, asked for by name
CHUNK_IMPLS = ("kernel", "ref")


def chunk_route(st: CpuState, chunk_kernel: str = "kernel") -> str:
    """Which loop :func:`run_chunk_fast` runs: ``"kernel"`` (the CUDA
    chunk kernel) for a CUDA state unless the eager loop is asked for by
    name, ``"ref"`` (the eager loop) for a CPU state or
    ``chunk_kernel="ref"``."""
    if chunk_kernel not in CHUNK_IMPLS:
        raise ValueError(f"chunk_kernel must be one of {CHUNK_IMPLS}, got "
                         f"{chunk_kernel!r}")
    return "kernel" if chunk_kernel == "kernel" and st.mem.is_cuda \
        else "ref"


def run_chunk_fast(st: CpuState, n_cores: int, mem_bytes: int,
                   max_cycles: int, issue_width: int = 8,
                   block_words: int = 16, block_cache: bool = True,
                   fetch_kernel: str = "kernel", trace_on: bool = False,
                   trigger: tuple | None = None,
                   dtlb_ways: int = 8, chunk_kernel: str = "kernel") -> int:
    """Advance ``st`` in place by up to ``max_cycles`` ticks, stopping
    when a core raises an exception or every core is parked.  Returns the
    number of substeps issued.

    The state's device picks the loop: a CUDA state runs the chunk
    kernel (``csrc/run_chunk.cu``, one launch, the walks as its device
    functions), a CPU state the eager loop; ``chunk_kernel="ref"`` asks
    for the eager loop on any device.  Both give the same state, counters
    and substep count.

    ``block_words`` (a power of two) sizes the per-core fetch block;
    ``block_cache=False`` re-walks the fetch for every instruction.
    ``fetch_kernel`` picks the translate/fetch-gather implementation for
    block fills inside the eager loop: ``"kernel"`` (the CUDA
    ``walk_fetch_block`` for a CUDA image, the plain version for a CPU
    image) or ``"ref"`` (the plain version on any device).
    ``dtlb_ways`` (a power of two; 0 disables) sizes the chunk-local
    data-translation cache.  ``trace_on`` records every retirement into
    the commit-trace ring (``tracebuf``/``trace_n``/``trace_armed``,
    armed by ``make_state(trace_slots=...)`` or
    ``TorchTarget.trace_arm``); ``trigger`` (a spec tuple of
    :mod:`repro_torch.telemetry.triggers`, or None) gates which
    retirements enter it, never the architectural step.  On the card
    ``trace_on`` launches the kernel's traced instantiation.

    The loop predicate is tested once per ``issue_width`` substeps;
    substeps issued after a trap inside such a group are no-ops.
    """
    assert block_words & (block_words - 1) == 0, "block_words must be pow2"
    assert dtlb_ways & (dtlb_ways - 1) == 0, "dtlb_ways must be pow2 or 0"
    route = chunk_route(st, chunk_kernel)
    if trace_on and st.tracebuf.shape[1] == 0:
        raise ValueError("trace_on needs an armed ring (make_state "
                         "trace_slots / TorchTarget.trace_arm)")
    if not trace_on:
        trigger = None
    if route == "kernel":
        return rc_kernel.run_chunk(st, n_cores, mem_bytes, max_cycles,
                                   issue_width, block_words, block_cache,
                                   dtlb_ways, trace_on, trigger)
    return _run_chunk_eager(st, n_cores, mem_bytes, max_cycles, issue_width,
                            block_words, block_cache, fetch_kernel,
                            dtlb_ways, trace_on, trigger)


def _run_chunk_eager(st: CpuState, n_cores: int, mem_bytes: int,
                     max_cycles: int, issue_width: int, block_words: int,
                     block_cache: bool, fetch_kernel: str,
                     dtlb_ways: int, trace_on: bool = False,
                     trigger: tuple | None = None) -> int:
    """The eager loop: one lane-vectorised :func:`_exec_substep` after
    another, the predicate read back every ``issue_width`` substeps.  The
    plain version of the chunk kernel (with ``trace_on``, of its traced
    instantiation)."""
    nc = n_cores
    dev = st.device
    k = _chunk_consts(torch.arange(nc, dtype=I64, device=dev),
                      mem_bytes - 1, block_words, block_cache, dtlb_ways,
                      fetch_kernel, trace_on=trace_on, trigger=trigger)
    limit = int(max_cycles)
    cycles = torch.zeros((), dtype=I64, device=dev)
    exec_from = torch.zeros((), dtype=I64, device=dev)
    fb = _empty_blocks(nc, block_words, dev)
    dtlb = _empty_dtlb(nc, max(dtlb_ways, 1), dev)
    substeps = 0
    while True:
        go = ((cycles < limit) & ~st.pending.any() &
              (st.priv != 3).any()) | (exec_from > 0)
        if not bool(go):
            return substeps
        for _ in range(issue_width):
            gate = ~st.pending.any() & (cycles < limit)
            exec_from, d = _exec_substep(st, fb, dtlb, exec_from, gate,
                                         limit - cycles, k)
            cycles = cycles + d
        substeps += issue_width


# ---------------------------------------------------------------------------
# The fleet: D boards' states stacked, one global chunk per call.
# ---------------------------------------------------------------------------
def make_fleet_state(n_devices: int, n_cores: int, mem_bytes: int,
                     device="cuda") -> CpuState:
    """D boards' power-on states stacked: every field carries a leading
    board axis ``(D, ...)`` (``ticks`` is ``(D,)``), contiguous, and the
    images lie end to end in one buffer, ``mem`` its ``(D, W)`` view with
    one spare word behind the last board (``mem_store``)."""
    one = make_state(n_cores, mem_bytes, device=device)
    words = mem_bytes // 8
    store = torch.zeros((n_devices * words + 1,), dtype=I64,
                        device=one.device)
    out = {name: getattr(one, name).unsqueeze(0).repeat(
        (n_devices,) + (1,) * getattr(one, name).dim())
        for name in STATE_FIELDS if name != "mem"}
    return CpuState(mem=store[:-1].view(n_devices, words), mem_store=store,
                    **out)


def board_state(sts: CpuState, d: int) -> CpuState:
    """Board ``d`` of a stacked state as a state of views: every in-place
    host op of this module (``redirect_op``, ``apply_write_batch``, the
    page ops, ``fetch_read_batch``) acts on the stack through it.  The
    views stay valid as long as the stack's tensors are updated in place
    (never rebound).  A board is never stepped alone — the fleet steps
    the stack — so it has no ``mem_store``."""
    out = {name: getattr(sts, name)[d] for name in STATE_FIELDS}
    return CpuState(mem_store=None, **out)


def _flat_state(sts: CpuState) -> CpuState:
    """The stack with its board axis folded into the lane axis: ``(D *
    nc, ...)`` views of the per-core fields, ``ticks`` ``(D,)``, ``mem``
    every image end to end."""
    out = {}
    for name in STATE_FIELDS:
        x = getattr(sts, name)
        out[name] = x if name == "ticks" else \
            x.view((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
    return CpuState(mem_store=sts.mem_store, **out)


def run_chunk_fleet(sts: CpuState, n_cores: int, mem_bytes: int, budgets,
                    issue_width: int = 8, block_words: int = 16,
                    block_cache: bool = True, fetch_kernel: str = "kernel",
                    dtlb_ways: int = 8, chunk_kernel: str = "kernel"
                    ) -> list:
    """One global chunk of a fleet: advance board ``d`` of the stacked
    state ``sts`` (:func:`make_fleet_state`) in place by up to
    ``budgets[d]`` ticks, each board exactly as :func:`run_chunk_fast`
    would advance it alone.  A board whose budget is 0 is left untouched,
    bit for bit.  Returns the substeps issued for each board.

    The state's device picks the loop, as in :func:`run_chunk_fast`: a
    CUDA stack runs the fleet chunk kernel (``csrc/run_chunk.cu``, one
    launch, one CTA per board), a CPU stack the eager flat form;
    ``chunk_kernel="ref"`` asks for the eager flat form on any device."""
    assert block_words & (block_words - 1) == 0, "block_words must be pow2"
    assert dtlb_ways & (dtlb_ways - 1) == 0, "dtlb_ways must be pow2 or 0"
    budgets = [int(b) for b in budgets]
    if len(budgets) != sts.pc.shape[0]:
        raise ValueError(f"run_chunk_fleet: {len(budgets)} budgets for "
                         f"{sts.pc.shape[0]} boards")
    if chunk_route(sts, chunk_kernel) == "kernel":
        return rc_kernel.run_chunk_fleet(sts, n_cores, mem_bytes, budgets,
                                         issue_width, block_words,
                                         block_cache, dtlb_ways)
    return _run_chunk_fleet_eager(sts, n_cores, mem_bytes, budgets,
                                  issue_width, block_words, block_cache,
                                  fetch_kernel, dtlb_ways)


def _run_chunk_fleet_eager(sts: CpuState, n_cores: int, mem_bytes: int,
                           budgets: list, issue_width: int,
                           block_words: int, block_cache: bool,
                           fetch_kernel: str, dtlb_ways: int) -> list:
    """The eager flat form, the port of the reference's
    ``run_chunk_fleet``: one machine of ``D * nc`` lanes, per-board
    clocks, budgets, gates and resume points as ``(D,)`` vectors, the
    loop running while any board's predicate holds.  The plain version of
    the fleet chunk kernel.

    A board whose own predicate is false stays unchanged while the others
    run (no lane of it is a candidate, it takes no skip, its clock and
    counters stand still), so its substeps count only the groups that
    started while its predicate held — what one CTA a board issues."""
    D, nc = sts.pc.shape[0], n_cores
    dev = sts.device
    L = D * nc
    fst = _flat_state(sts)
    lanes = torch.arange(L, dtype=I64, device=dev)
    board = lanes // nc
    fleet = _Fleet(D=D, nc=nc, board=board, base=board * (mem_bytes // 8),
                   local=lanes - board * nc,
                   same=board[:, None] == board[None, :])
    k = _chunk_consts(lanes, mem_bytes - 1, block_words, block_cache,
                      dtlb_ways, fetch_kernel, fleet)
    limit = torch.tensor(budgets, dtype=I64, device=dev)
    cycles = torch.zeros((D,), dtype=I64, device=dev)
    exec_from = torch.zeros((D,), dtype=I64, device=dev)
    fb = _empty_blocks(L, block_words, dev)
    dtlb = _empty_dtlb(L, max(dtlb_ways, 1), dev)
    substeps = [0] * D

    def dany(v):
        return v.view(D, nc).any(1)
    while True:
        go = (((cycles < limit) & ~dany(fst.pending) &
               dany(fst.priv != 3)) | (exec_from > 0)).tolist()
        if not any(go):
            break
        substeps = [n + issue_width * g for n, g in zip(substeps, go)]
        for _ in range(issue_width):
            gate = ~dany(fst.pending) & (cycles < limit)
            exec_from, d = _exec_substep(fst, fb, dtlb, exec_from, gate,
                                         limit - cycles, k)
            cycles = cycles + d
    # the substep rebinds the small per-core vectors: copy them back into
    # the stack, whose tensors the boards' views alias
    for name in STATE_FIELDS:
        dst, src = getattr(sts, name), getattr(fst, name)
        if src.data_ptr() != dst.data_ptr():
            dst.copy_(src.view(dst.shape))
    return substeps


# ---------------------------------------------------------------------------
# Host-side word/page access (the device half of the HTP data requests).
# All update the persistent tensors in place.
# ---------------------------------------------------------------------------
def mem_write_words(st: CpuState, word_idx, vals):
    apply_write_batch(st, words=zip(word_idx, vals))


def page_read_words(st: CpuState, word_off):
    """A host copy (numpy uint64) of the 512-word page at ``word_off``."""
    page = st.mem[word_off:word_off + 512].to("cpu", copy=True)
    return page.numpy().view("uint64")


def page_write_words(st: CpuState, word_off, words_i64):
    """``words_i64``: a 512-element int64 CPU tensor (u64 bit patterns)."""
    st.mem[word_off:word_off + 512].copy_(words_i64)


def page_set_words(st: CpuState, word_off, val):
    st.mem[word_off:word_off + 512].fill_(u64.to_signed(int(val)))


def page_copy_words(st: CpuState, src_off, dst_off):
    page = st.mem[src_off:src_off + 512].clone()
    st.mem[dst_off:dst_off + 512].copy_(page)


_BOOL_FIELDS = ("pending",)


def _field_put(st: CpuState, name, cpus, vals):
    """``st.<name>[cpus] = vals`` with the field's own dtype rules
    (``pending`` is ``v != 0``, ``priv`` is the low 32 bits)."""
    field = getattr(st, name)
    if name in _BOOL_FIELDS:
        vals = vals != 0
    elif name == "priv":
        vals = vals.to(torch.int32)
    field.index_put_((cpus,), vals)


def apply_write_batch(st: CpuState, regs=(), csrs=(), words=()):
    """Commit a staged transaction's writes — the device half of the
    session's write batching.  ``regs`` are ``(core, idx, val)``,
    ``csrs`` ``(core, name, val)``, ``words`` ``(word_index, val)``;
    indices are unique per kind (the stage is dict-keyed), values are
    unsigned 64-bit python ints.  Everything travels to the device as
    ONE int64 tensor (indices and values side by side) and is scattered
    from views of it — no padding and no out-of-range sentinels."""
    regs, csrs, words = list(regs), list(csrs), list(words)
    if not (regs or csrs or words):
        return
    by_name: dict = {}
    for c, name, v in csrs:
        by_name.setdefault(name, []).append((c, v))
    flat = []
    flat += [c * 32 + i for c, i, _ in regs]
    flat += [w for w, _ in words]
    for name in by_name:
        flat += [c for c, _ in by_name[name]]
    flat += [u64.to_signed(int(v)) for _, _, v in regs]
    flat += [u64.to_signed(int(v)) for _, v in words]
    for name in by_name:
        flat += [u64.to_signed(int(v)) for _, v in by_name[name]]
    n = len(flat) // 2
    buf = torch.tensor(flat, dtype=I64).to(st.device)
    idx, val = buf[:n], buf[n:]
    o = 0
    if regs:
        st.regs.view(-1).index_put_((idx[o:o + len(regs)],),
                                    val[o:o + len(regs)])
        o += len(regs)
    if words:
        st.mem.index_put_((idx[o:o + len(words)],), val[o:o + len(words)])
        o += len(words)
    for name, pairs in by_name.items():
        _field_put(st, name, idx[o:o + len(pairs)], val[o:o + len(pairs)])
        o += len(pairs)


def redirect_op(st: CpuState, c, pc, resume):
    st.pc[c] = u64.to_signed(pc)
    st.priv[c] = 0
    st.pending[c] = False
    st.stall_until[c] = u64.to_signed(resume)


def park_op(st: CpuState, c):
    st.priv[c] = 3
    st.pending[c] = False


def clear_pending_op(st: CpuState, c):
    st.pending[c] = False


def csr_write_op(st: CpuState, name: str, c, v):
    v = u64.to_signed(int(v))
    if name == "ticks":
        st.ticks.fill_(v)
    elif name in _BOOL_FIELDS:
        getattr(st, name)[c] = v != 0
    elif name == "priv":
        lo = v & _M32
        st.priv[c] = lo - (1 << 32) if lo >> 31 else lo
    else:
        getattr(st, name)[c] = v


def reg_write_op(st: CpuState, c, idx, v):
    st.regs[c, idx] = u64.to_signed(int(v))


def fetch_read_batch(st: CpuState, regs=(), csrs=(), words=()):
    """The host's batched reads — the read-side twin of
    :func:`apply_write_batch`: GPRs ``(core, idx)``, CSR/core-state
    fields ``(core, name)`` and physical words (byte addresses) are
    gathered into ONE int64 tensor and brought to the host in one
    transfer.  Returns three lists of unsigned python ints in input
    order; every CSR value is widened to 64 bits (``pending`` -> 0/1,
    ``priv`` zero-extended, ``ticks`` the global scalar)."""
    regs, csrs, words = list(regs), list(csrs), list(words)
    if not (regs or csrs or words):
        return [], [], []
    dev = st.device
    parts = []
    if regs or words:
        idx = torch.tensor([c * 32 + i for c, i in regs] +
                           [pa >> 3 for pa in words], dtype=I64).to(dev)
        if regs:
            parts.append(st.regs.view(-1)[idx[:len(regs)]])
        if words:
            parts.append(st.mem[idx[len(regs):]])
    if csrs:
        # one (fields, nc) table of the distinct fields asked for, then a
        # single gather in input order
        names = sorted({name for _, name in csrs})
        nc = st.pc.shape[0]
        rows = []
        for name in names:
            if name == "ticks":
                rows.append(st.ticks.expand(nc))
            elif name == "priv":
                rows.append(st.priv.to(I64) & _M32)
            else:
                rows.append(getattr(st, name).to(I64))
        table = torch.stack(rows).view(-1)
        pos = {name: i for i, name in enumerate(names)}
        cidx = torch.tensor([pos[name] * nc + c for c, name in csrs],
                            dtype=I64).to(dev)
        parts.append(table[cidx])
    got = (torch.cat(parts) if len(parts) > 1 else parts[0]).tolist()
    nr, nw = len(regs), len(words)
    out = [v & u64.M64 for v in got]
    return out[:nr], out[nr + nw:], out[nr:nr + nw]
