"""RV64IMA encodings shared by the assembler and both target models.

Only what the FASE reproduction needs: the base integer ISA (RV64I), the
M extension, the A extension (LR/SC + AMOs), FENCE/FENCE.I as no-ops and
ECALL/EBREAK.  No compressed instructions, no floating point, no CSR
instructions (the controller reaches CSRs through the Reg bundle, not
through target-executed code).
"""
from __future__ import annotations

# ---------------------------------------------------------------------------
# Sv39 PTE bits
# ---------------------------------------------------------------------------
PTE_V = 1 << 0
PTE_R = 1 << 1
PTE_W = 1 << 2
PTE_X = 1 << 3
PTE_U = 1 << 4
PTE_G = 1 << 5
PTE_A = 1 << 6
PTE_D = 1 << 7

SATP_SV39 = 8 << 60

# Exception causes (mcause)
CAUSE_MISALIGNED_FETCH = 0
CAUSE_ILLEGAL = 2
CAUSE_BREAKPOINT = 3
CAUSE_MISALIGNED_LOAD = 4
CAUSE_MISALIGNED_STORE = 6
CAUSE_USER_ECALL = 8
CAUSE_FETCH_PAGE_FAULT = 12
CAUSE_LOAD_PAGE_FAULT = 13
CAUSE_STORE_PAGE_FAULT = 15

# ---------------------------------------------------------------------------
# Major opcodes (bits [6:0])
# ---------------------------------------------------------------------------
OP_LOAD = 0x03
OP_MISC_MEM = 0x0F
OP_IMM = 0x13
OP_AUIPC = 0x17
OP_IMM_32 = 0x1B
OP_STORE = 0x23
OP_AMO = 0x2F
OP_OP = 0x33
OP_LUI = 0x37
OP_OP_32 = 0x3B
OP_BRANCH = 0x63
OP_JALR = 0x67
OP_JAL = 0x6F
OP_SYSTEM = 0x73

# funct5 values of the A extension (bits [31:27])
AMO_LR = 0x02
AMO_SC = 0x03
AMO_SWAP = 0x01
AMO_ADD = 0x00
AMO_XOR = 0x04
AMO_AND = 0x0C
AMO_OR = 0x08
AMO_MIN = 0x10
AMO_MAX = 0x14
AMO_MINU = 0x18
AMO_MAXU = 0x1C

# ---------------------------------------------------------------------------
# Register names
# ---------------------------------------------------------------------------
ABI_REGS = {
    "zero": 0, "ra": 1, "sp": 2, "gp": 3, "tp": 4,
    "t0": 5, "t1": 6, "t2": 7, "s0": 8, "fp": 8, "s1": 9,
    "a0": 10, "a1": 11, "a2": 12, "a3": 13, "a4": 14, "a5": 15,
    "a6": 16, "a7": 17,
    "s2": 18, "s3": 19, "s4": 20, "s5": 21, "s6": 22, "s7": 23,
    "s8": 24, "s9": 25, "s10": 26, "s11": 27,
    "t3": 28, "t4": 29, "t5": 30, "t6": 31,
}
ABI_REGS.update({f"x{i}": i for i in range(32)})


def reg_num(name: str) -> int:
    try:
        return ABI_REGS[name]
    except KeyError:
        raise ValueError(f"unknown register {name!r}") from None


# ---------------------------------------------------------------------------
# Encoders (values must already be range-checked by the caller)
# ---------------------------------------------------------------------------
def enc_r(op, rd, f3, rs1, rs2, f7):
    return (f7 << 25) | (rs2 << 20) | (rs1 << 15) | (f3 << 12) | \
        (rd << 7) | op


def enc_i(op, rd, f3, rs1, imm):
    return ((imm & 0xFFF) << 20) | (rs1 << 15) | (f3 << 12) | (rd << 7) | op


def enc_s(op, f3, rs1, rs2, imm):
    imm &= 0xFFF
    return ((imm >> 5) << 25) | (rs2 << 20) | (rs1 << 15) | (f3 << 12) | \
        (((imm & 0x1F)) << 7) | op


def enc_b(op, f3, rs1, rs2, imm):
    imm &= 0x1FFF
    return (((imm >> 12) & 1) << 31) | (((imm >> 5) & 0x3F) << 25) | \
        (rs2 << 20) | (rs1 << 15) | (f3 << 12) | \
        (((imm >> 1) & 0xF) << 8) | (((imm >> 11) & 1) << 7) | op


def enc_u(op, rd, imm20):
    return ((imm20 & 0xFFFFF) << 12) | (rd << 7) | op


def enc_j(op, rd, imm):
    imm &= 0x1FFFFF
    return (((imm >> 20) & 1) << 31) | (((imm >> 1) & 0x3FF) << 21) | \
        (((imm >> 11) & 1) << 20) | (((imm >> 12) & 0xFF) << 12) | \
        (rd << 7) | op


def enc_amo(f3, rd, rs1, rs2, funct5):
    return (funct5 << 27) | (rs2 << 20) | (rs1 << 15) | (f3 << 12) | \
        (rd << 7) | OP_AMO


INST_FENCE = enc_i(OP_MISC_MEM, 0, 0, 0, 0x0FF)
INST_FENCE_I = enc_i(OP_MISC_MEM, 0, 1, 0, 0)
INST_ECALL = enc_i(OP_SYSTEM, 0, 0, 0, 0)
INST_EBREAK = enc_i(OP_SYSTEM, 0, 0, 0, 1)
