"""A small two-pass RV64IMA assembler for the FASE workloads.

Supports exactly the dialect the in-tree sources use: ``.text/.data/.bss``
sections, ``.equ`` constants, ``.align/.byte/.word/.dword/.zero/.asciz``
data directives, named labels, GNU-style numeric local labels (``1:`` /
``1b`` / ``1f``), and the usual pseudo-instructions (``li`` with full
64-bit materialisation, ``la``/``call`` as pc-relative pairs, ``mv``,
``j``, ``ret``, branch aliases).

Pseudo-instructions expand to fixed-size sequences during the first pass,
so every label offset is final before encoding; the second pass resolves
symbols and emits machine code.  The output :class:`Image` is what the
loader (:mod:`repro_torch.core.runtime.loader`) and the bare-metal tests place
into target memory.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from . import isa
from .isa import (OP_AMO, OP_AUIPC, OP_BRANCH, OP_IMM, OP_IMM_32, OP_JAL,
                  OP_JALR, OP_LOAD, OP_LUI, OP_OP, OP_OP_32, OP_STORE,
                  enc_amo, enc_b, enc_i, enc_j, enc_r, enc_s, enc_u,
                  reg_num)

TEXT_BASE = 0x10000
SEC_ALIGN = 0x1000


class AsmError(Exception):
    pass


@dataclass
class Segment:
    vaddr: int
    data: bytearray
    flags: str          # "rx" | "rw"


@dataclass
class Image:
    entry: int
    segments: list
    symbols: dict
    bss: tuple | None = None


# ---------------------------------------------------------------------------
# Instruction tables
# ---------------------------------------------------------------------------
_R_OPS = {
    # name: (opcode, funct3, funct7)
    "add": (OP_OP, 0, 0x00), "sub": (OP_OP, 0, 0x20),
    "sll": (OP_OP, 1, 0x00), "slt": (OP_OP, 2, 0x00),
    "sltu": (OP_OP, 3, 0x00), "xor": (OP_OP, 4, 0x00),
    "srl": (OP_OP, 5, 0x00), "sra": (OP_OP, 5, 0x20),
    "or": (OP_OP, 6, 0x00), "and": (OP_OP, 7, 0x00),
    "mul": (OP_OP, 0, 0x01), "mulh": (OP_OP, 1, 0x01),
    "mulhsu": (OP_OP, 2, 0x01), "mulhu": (OP_OP, 3, 0x01),
    "div": (OP_OP, 4, 0x01), "divu": (OP_OP, 5, 0x01),
    "rem": (OP_OP, 6, 0x01), "remu": (OP_OP, 7, 0x01),
    "addw": (OP_OP_32, 0, 0x00), "subw": (OP_OP_32, 0, 0x20),
    "sllw": (OP_OP_32, 1, 0x00), "srlw": (OP_OP_32, 5, 0x00),
    "sraw": (OP_OP_32, 5, 0x20),
    "mulw": (OP_OP_32, 0, 0x01), "divw": (OP_OP_32, 4, 0x01),
    "divuw": (OP_OP_32, 5, 0x01), "remw": (OP_OP_32, 6, 0x01),
    "remuw": (OP_OP_32, 7, 0x01),
}
_I_OPS = {
    "addi": (OP_IMM, 0), "slti": (OP_IMM, 2), "sltiu": (OP_IMM, 3),
    "xori": (OP_IMM, 4), "ori": (OP_IMM, 6), "andi": (OP_IMM, 7),
    "addiw": (OP_IMM_32, 0),
}
_SHIFT_OPS = {
    # name: (opcode, funct3, hi-bits, shamt-width)
    "slli": (OP_IMM, 1, 0x000, 6), "srli": (OP_IMM, 5, 0x000, 6),
    "srai": (OP_IMM, 5, 0x400, 6),
    "slliw": (OP_IMM_32, 1, 0x000, 5), "srliw": (OP_IMM_32, 5, 0x000, 5),
    "sraiw": (OP_IMM_32, 5, 0x400, 5),
}
_LOADS = {"lb": 0, "lh": 1, "lw": 2, "ld": 3, "lbu": 4, "lhu": 5, "lwu": 6}
_STORES = {"sb": 0, "sh": 1, "sw": 2, "sd": 3}
_BRANCHES = {"beq": 0, "bne": 1, "blt": 4, "bge": 5, "bltu": 6, "bgeu": 7}
# alias: swap operands
_BRANCH_ALIASES = {"bgt": "blt", "ble": "bge", "bgtu": "bltu",
                   "bleu": "bgeu"}
_BRANCH_Z = {"beqz": ("beq", "z2"), "bnez": ("bne", "z2"),
             "bltz": ("blt", "z2"), "bgez": ("bge", "z2"),
             "blez": ("bge", "z1"), "bgtz": ("blt", "z1")}
_AMOS = {
    "amoswap": isa.AMO_SWAP, "amoadd": isa.AMO_ADD, "amoxor": isa.AMO_XOR,
    "amoand": isa.AMO_AND, "amoor": isa.AMO_OR, "amomin": isa.AMO_MIN,
    "amomax": isa.AMO_MAX, "amominu": isa.AMO_MINU,
    "amomaxu": isa.AMO_MAXU,
}

_MEM_RE = re.compile(r"^(.*)\(\s*([a-z0-9]+)\s*\)$")
_LABEL_RE = re.compile(r"^([A-Za-z_.$][\w.$]*|\d+)\s*:\s*(.*)$")
_NUMREF_RE = re.compile(r"^(\d+)([bf])$")

_ESCAPES = {"n": "\n", "t": "\t", "0": "\0", "\\": "\\", '"': '"',
            "r": "\r"}


def _parse_str(tok: str, line: str) -> bytes:
    tok = tok.strip()
    if len(tok) < 2 or tok[0] != '"' or tok[-1] != '"':
        raise AsmError(f"bad string literal: {line}")
    out = []
    i = 1
    while i < len(tok) - 1:
        ch = tok[i]
        if ch == "\\":
            i += 1
            out.append(_ESCAPES.get(tok[i], tok[i]))
        else:
            out.append(ch)
        i += 1
    return "".join(out).encode("latin1")


def _li_expand(rd: int, val: int) -> list:
    """Canonical RV64 'li' materialisation (lui/addiw + slli/addi chain)."""
    if -2048 <= val < 2048:
        return [("i", OP_IMM, rd, 0, 0, val)]
    if -(1 << 31) <= val < (1 << 31):
        lo = ((val & 0xFFF) ^ 0x800) - 0x800
        hi20 = ((val - lo) >> 12) & 0xFFFFF
        seq = [("u", OP_LUI, rd, hi20)]
        if lo:
            seq.append(("i", OP_IMM_32, rd, 0, rd, lo))
        return seq
    lo = ((val & 0xFFF) ^ 0x800) - 0x800
    seq = _li_expand(rd, (val - lo) >> 12)
    seq.append(("sh", OP_IMM, rd, 1, rd, 0x000, 12))       # slli rd, rd, 12
    if lo:
        seq.append(("i", OP_IMM, rd, 0, rd, lo))
    return seq


class _Assembler:
    def __init__(self, src: str):
        self.src = src
        self.consts: dict[str, int] = {}
        # section -> list of items; items:
        #   ("inst", rec)        4 bytes, rec encodes in pass 2
        #   ("bytes", bytes)
        #   ("align", pow2size)
        #   ("zero", n)
        self.items = {"text": [], "data": [], "bss": []}
        self.offs = {"text": 0, "data": 0, "bss": 0}
        self.labels: dict[str, tuple[str, int]] = {}
        self.numeric: list[tuple[int, str, int]] = []   # (n, sec, off)

    # ---------------- expression / operand helpers ---------------------
    def _int(self, tok: str, line: str) -> int:
        tok = tok.strip()
        neg = tok.startswith("-")
        body = tok[1:] if neg else tok
        if body in self.consts:
            v = self.consts[body]
        else:
            try:
                v = int(body, 0)
            except ValueError:
                raise AsmError(f"bad immediate {tok!r} in: {line}") from None
        return -v if neg else v

    def _imm12(self, tok, line) -> int:
        v = self._int(tok, line)
        if not -2048 <= v < 2048:
            raise AsmError(f"immediate {v} out of 12-bit range: {line}")
        return v

    # ---------------- emission -----------------------------------------
    def _emit(self, sec, item, size):
        if sec == "bss" and item[0] not in ("align", "zero"):
            raise AsmError(".bss may only hold .zero/.align")
        self.items[sec].append(item)
        self.offs[sec] += size

    def _emit_insts(self, sec, recs):
        for r in recs:
            self._emit(sec, ("inst", r), 4)

    # ---------------- pass 1 --------------------------------------------
    def parse(self):
        sec = "text"
        for raw in self.src.splitlines():
            line = raw.split("#", 1)[0].strip()
            while True:
                m = _LABEL_RE.match(line)
                if not m:
                    break
                name, line = m.group(1), m.group(2).strip()
                if name.isdigit():
                    self.numeric.append((int(name), sec, self.offs[sec]))
                else:
                    if name in self.labels:
                        raise AsmError(f"duplicate label {name!r}")
                    self.labels[name] = (sec, self.offs[sec])
            if not line:
                continue
            if line.startswith("."):
                sec = self._directive(sec, line)
            else:
                self._instruction(sec, line)

    def _directive(self, sec, line):
        parts = line.split(None, 1)
        d = parts[0]
        rest = parts[1] if len(parts) > 1 else ""
        if d in (".text", ".data", ".bss"):
            return d[1:]
        if d == ".section":
            name = rest.split(",")[0].strip().lstrip(".")
            if name not in self.items:
                raise AsmError(f"unknown section {rest!r}")
            return name
        if d == ".equ":
            name, val = [p.strip() for p in rest.split(",", 1)]
            self.consts[name] = self._int(val, line)
        elif d == ".align":
            p2 = self._int(rest, line)
            self._align(sec, 1 << p2)
        elif d == ".byte":
            vals = [self._int(t, line) & 0xFF for t in rest.split(",")]
            self._emit(sec, ("bytes", bytes(vals)), len(vals))
        elif d == ".word":
            blob = b"".join((self._int(t, line) & 0xFFFFFFFF)
                            .to_bytes(4, "little") for t in rest.split(","))
            self._emit(sec, ("bytes", blob), len(blob))
        elif d == ".dword":
            blob = b"".join((self._int(t, line) & (2**64 - 1))
                            .to_bytes(8, "little") for t in rest.split(","))
            self._emit(sec, ("bytes", blob), len(blob))
        elif d == ".zero":
            n = self._int(rest, line)
            self._emit(sec, ("zero", n), n)
        elif d in (".asciz", ".string"):
            blob = _parse_str(rest, line) + b"\0"
            self._emit(sec, ("bytes", blob), len(blob))
        elif d == ".ascii":
            blob = _parse_str(rest, line)
            self._emit(sec, ("bytes", blob), len(blob))
        elif d in (".globl", ".global", ".option", ".p2align", ".type",
                   ".size"):
            pass
        else:
            raise AsmError(f"unknown directive: {line}")
        return sec

    def _align(self, sec, size):
        pad = (-self.offs[sec]) % size
        if pad:
            self._emit(sec, ("zero", pad) if sec == "bss"
                       else ("bytes", b"\0" * pad), pad)

    # ---------------- instructions --------------------------------------
    def _instruction(self, sec, line):
        if sec != "text":
            raise AsmError(f"instruction outside .text: {line}")
        parts = line.split(None, 1)
        mn = parts[0]
        ops = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 \
            else []
        self._emit_insts(sec, self._expand(mn, ops, line))

    def _mem_operand(self, tok, line):
        m = _MEM_RE.match(tok.strip())
        if not m:
            raise AsmError(f"bad memory operand {tok!r}: {line}")
        off = m.group(1).strip()
        base = reg_num(m.group(2))
        return (self._imm12(off, line) if off else 0), base

    def _expand(self, mn, ops, line) -> list:
        R = lambda t: reg_num(t)    # noqa: E731
        try:
            return self._expand_inner(mn, ops, line, R)
        except (ValueError, IndexError) as e:
            raise AsmError(f"{e} in: {line}") from None

    def _expand_inner(self, mn, ops, line, R) -> list:
        if mn in _R_OPS:
            op, f3, f7 = _R_OPS[mn]
            return [("r", op, R(ops[0]), f3, R(ops[1]), R(ops[2]), f7)]
        if mn in _I_OPS:
            op, f3 = _I_OPS[mn]
            return [("i", op, R(ops[0]), f3, R(ops[1]),
                     self._imm12(ops[2], line))]
        if mn in _SHIFT_OPS:
            op, f3, hi, width = _SHIFT_OPS[mn]
            sh = self._int(ops[2], line)
            if not 0 <= sh < (1 << width):
                raise AsmError(f"shift amount {sh} out of range: {line}")
            return [("sh", op, R(ops[0]), f3, R(ops[1]), hi, sh)]
        if mn in _LOADS:
            off, base = self._mem_operand(ops[1], line)
            return [("i", OP_LOAD, R(ops[0]), _LOADS[mn], base, off)]
        if mn in _STORES:
            off, base = self._mem_operand(ops[1], line)
            return [("s", _STORES[mn], base, R(ops[0]), off)]
        if mn in _BRANCHES:
            return [("b", _BRANCHES[mn], R(ops[0]), R(ops[1]), ops[2])]
        if mn in _BRANCH_ALIASES:
            f3 = _BRANCHES[_BRANCH_ALIASES[mn]]
            return [("b", f3, R(ops[1]), R(ops[0]), ops[2])]
        if mn in _BRANCH_Z:
            base, kind = _BRANCH_Z[mn]
            f3 = _BRANCHES[base]
            rs1, rs2 = (R(ops[0]), 0) if kind == "z2" else (0, R(ops[0]))
            if kind == "z1":
                rs1, rs2 = 0, R(ops[0])
            return [("b", f3, rs1, rs2, ops[1])]
        if mn == "li":
            return _li_expand(R(ops[0]), self._signed64(ops[1], line))
        if mn == "la":
            rd = R(ops[0])
            return [("hi", OP_AUIPC, rd, ops[1]),
                    ("lo_i", OP_IMM, rd, 0, rd, ops[1])]
        if mn == "call":
            return [("hi", OP_AUIPC, 1, ops[0]),
                    ("lo_i", OP_JALR, 1, 0, 1, ops[0])]
        if mn == "tail":
            return [("hi", OP_AUIPC, 6, ops[0]),
                    ("lo_i", OP_JALR, 0, 0, 6, ops[0])]
        if mn == "j":
            return [("j", 0, ops[0])]
        if mn == "jal":
            if len(ops) == 1:
                return [("j", 1, ops[0])]
            return [("j", R(ops[0]), ops[1])]
        if mn == "jalr":
            if len(ops) == 1:
                return [("i", OP_JALR, 1, 0, R(ops[0]), 0)]
            off, base = self._mem_operand(ops[1], line)
            return [("i", OP_JALR, R(ops[0]), 0, base, off)]
        if mn == "jr":
            return [("i", OP_JALR, 0, 0, R(ops[0]), 0)]
        if mn == "ret":
            return [("i", OP_JALR, 0, 0, 1, 0)]
        if mn == "mv":
            return [("i", OP_IMM, R(ops[0]), 0, R(ops[1]), 0)]
        if mn == "not":
            return [("i", OP_IMM, R(ops[0]), 4, R(ops[1]), -1)]
        if mn == "neg":
            return [("r", OP_OP, R(ops[0]), 0, 0, R(ops[1]), 0x20)]
        if mn == "sext.w":
            return [("i", OP_IMM_32, R(ops[0]), 0, R(ops[1]), 0)]
        if mn == "seqz":
            return [("i", OP_IMM, R(ops[0]), 3, R(ops[1]), 1)]
        if mn == "snez":
            return [("r", OP_OP, R(ops[0]), 3, 0, R(ops[1]), 0)]
        if mn == "nop":
            return [("i", OP_IMM, 0, 0, 0, 0)]
        if mn == "lui":
            return [("u", OP_LUI, R(ops[0]),
                     self._int(ops[1], line) & 0xFFFFF)]
        if mn == "auipc":
            return [("u", OP_AUIPC, R(ops[0]),
                     self._int(ops[1], line) & 0xFFFFF)]
        if mn == "ecall":
            return [("raw", isa.INST_ECALL)]
        if mn == "ebreak":
            return [("raw", isa.INST_EBREAK)]
        if mn == "fence":
            return [("raw", isa.INST_FENCE)]
        if mn == "fence.i":
            return [("raw", isa.INST_FENCE_I)]
        if "." in mn:
            for order in (".aqrl", ".aq", ".rl"):   # acquire/release hints
                if mn.endswith(order):
                    mn = mn[:-len(order)]
                    break
            base, suffix = mn.rsplit(".", 1)
            if suffix in ("w", "d"):
                f3 = 2 if suffix == "w" else 3
                if base == "lr":
                    _, rs1 = self._mem_operand(ops[1], line)
                    return [("r", OP_AMO, R(ops[0]), f3, rs1, 0,
                             isa.AMO_LR << 2)]
                if base == "sc":
                    _, rs1 = self._mem_operand(ops[2], line)
                    return [("r", OP_AMO, R(ops[0]), f3, rs1, R(ops[1]),
                             isa.AMO_SC << 2)]
                if base in _AMOS:
                    _, rs1 = self._mem_operand(ops[2], line)
                    return [("r", OP_AMO, R(ops[0]), f3, rs1, R(ops[1]),
                             _AMOS[base] << 2)]
        raise AsmError(f"unknown instruction: {line}")

    def _signed64(self, tok, line) -> int:
        v = self._int(tok, line)
        v &= (1 << 64) - 1
        return v - (1 << 64) if v >> 63 else v

    # ---------------- pass 2 --------------------------------------------
    def _resolve(self, tok, sec_base, pos, line="") -> int:
        tok = tok.strip()
        m = _NUMREF_RE.match(tok)
        if m:
            n, d = int(m.group(1)), m.group(2)
            cands = [(s, o) for (num, s, o) in self.numeric
                     if num == n and s == "text"]
            if d == "b":
                prior = [o for (s, o) in cands if o <= pos]
                if not prior:
                    raise AsmError(f"no backward label {tok}: {line}")
                return sec_base["text"] + max(prior)
            nxt = [o for (s, o) in cands if o > pos]
            if not nxt:
                raise AsmError(f"no forward label {tok}: {line}")
            return sec_base["text"] + min(nxt)
        if tok in self.labels:
            s, o = self.labels[tok]
            return sec_base[s] + o
        if tok in self.consts:
            return self.consts[tok]
        raise AsmError(f"undefined symbol {tok!r}: {line}")

    def encode(self) -> Image:
        sec_base = {"text": TEXT_BASE}
        text_end = TEXT_BASE + self.offs["text"]
        sec_base["data"] = (text_end + SEC_ALIGN - 1) & ~(SEC_ALIGN - 1)
        data_end = sec_base["data"] + self.offs["data"]
        sec_base["bss"] = (data_end + SEC_ALIGN - 1) & ~(SEC_ALIGN - 1)

        text = bytearray()
        for item in self.items["text"]:
            if item[0] == "inst":
                pc = TEXT_BASE + len(text)
                text += self._encode_inst(item[1], pc,
                                          sec_base).to_bytes(4, "little")
            elif item[0] == "bytes":
                text += item[1]
            else:
                text += b"\0" * item[1]
        data = bytearray()
        for item in self.items["data"]:
            if item[0] == "inst":
                raise AsmError("instruction in .data")
            data += item[1] if item[0] == "bytes" else b"\0" * item[1]

        symbols = {name: sec_base[s] + o
                   for name, (s, o) in self.labels.items()}
        segments = [Segment(TEXT_BASE, text, "rx")]
        if data:
            segments.append(Segment(sec_base["data"], data, "rw"))
        bss = (sec_base["bss"], self.offs["bss"]) if self.offs["bss"] \
            else None
        entry = symbols.get("_start", TEXT_BASE)
        return Image(entry, segments, symbols, bss)

    def _encode_inst(self, rec, pc, sec_base) -> int:
        kind = rec[0]
        if kind == "raw":
            return rec[1]
        if kind == "r":
            _, op, rd, f3, rs1, rs2, f7 = rec
            return enc_r(op, rd, f3, rs1, rs2, f7)
        if kind == "i":
            _, op, rd, f3, rs1, imm = rec
            return enc_i(op, rd, f3, rs1, imm)
        if kind == "sh":
            _, op, rd, f3, rs1, hi, sh = rec
            return enc_i(op, rd, f3, rs1, hi | sh)
        if kind == "s":
            _, f3, base, rs2, off = rec
            return enc_s(OP_STORE, f3, base, rs2, off)
        if kind == "u":
            _, op, rd, imm20 = rec
            return enc_u(op, rd, imm20)
        if kind == "b":
            _, f3, rs1, rs2, target = rec
            dest = self._resolve(target, sec_base, pc - sec_base["text"])
            off = dest - pc
            if not -4096 <= off < 4096 or off & 1:
                raise AsmError(f"branch target out of range: {off}")
            return enc_b(OP_BRANCH, f3, rs1, rs2, off)
        if kind == "j":
            _, rd, target = rec
            dest = self._resolve(target, sec_base, pc - sec_base["text"])
            off = dest - pc
            if not -(1 << 20) <= off < (1 << 20) or off & 1:
                raise AsmError(f"jump target out of range: {off}")
            return enc_j(OP_JAL, rd, off)
        if kind == "hi":
            _, op, rd, target = rec
            dest = self._resolve(target, sec_base, pc - sec_base["text"])
            delta = dest - pc
            hi20 = ((delta + 0x800) >> 12) & 0xFFFFF
            return enc_u(op, rd, hi20)
        if kind == "lo_i":
            _, op, rd, f3, rs1, target = rec
            # the paired auipc is the immediately-preceding instruction
            anchor = pc - 4
            dest = self._resolve(target, sec_base, anchor - sec_base["text"])
            delta = dest - anchor
            lo = ((delta & 0xFFF) ^ 0x800) - 0x800
            return enc_i(op, rd, f3, rs1, lo)
        raise AsmError(f"bad record {rec!r}")


def assemble(src: str) -> Image:
    a = _Assembler(src)
    a.parse()
    return a.encode()
