"""Instruction encodings for NM-Caesar (bus micro-ops) and NM-Carus (xvnmc).

NM-Caesar (paper Section III-A1): in *computing* mode each bus write is one
instruction.  The write-data word packs ``opcode[31:26] | src2[25:13] |
src1[12:0]`` (word offsets relative to the macro base); the *address* bus
carries the destination offset, exactly as a normal store would.

NM-Carus (Section III-B1, Tables II/III): the ``xvnmc`` custom RISC-V vector
extension lives in the Custom-2 major opcode ``0x5b``.  We implement genuine
32-bit encodings (RVV-style bit layout) so the eCPU interpreter executes real
instruction words from its eMEM:

    31      26 25   24  20 19   15 14  12 11  7 6    0
    [ funct6 ][ind][ vs2 ][ vs1  ][funct3][ vd ][opcode]

``funct3`` selects the operand variant (OPIVV/OPIVX/OPIVI/OPMVX); bit 25 — the
RVV mask bit, unused by xvnmc — is repurposed as the **indirect register
addressing** flag ``[r]``: when set, the register indices are taken from the
three least-significant bytes of scalar GPR ``x[vs2_field]`` at *runtime*
(``[7:0]=vs1, [15:8]=vs2, [23:16]=vd``), which is the paper's key code-size
mechanism (one encoded instruction iterates over arbitrary registers).
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np

# ---------------------------------------------------------------------------
# NM-Caesar
# ---------------------------------------------------------------------------

class CaesarOp(enum.IntEnum):
    AND = 0; OR = 1; XOR = 2
    ADD = 3; SUB = 4; MUL = 5
    MAC_INIT = 6; MAC = 7; MAC_STORE = 8
    DOT_INIT = 9; DOT = 10; DOT_STORE = 11
    SLL = 12; SLR = 13
    MIN = 14; MAX = 15
    CSRW = 16
    SRA = 17   # arithmetic right shift — inherited from the CV32E40P ALU the
               # design is based on (Sec. III-A2); needed by the power-of-two
               # negative slope of Leaky-ReLU (Table V footnote f).
    NOP = 18   # true no-op: no state change, zero cycles, zero energy.  Used
               # by the bucketed scheduler (repro_torch.nmc.pool) to pad instruction
               # streams to power-of-two lengths so heterogeneous kernels
               # share one traced computation per bucket.


# Ops that use the 32-bit scalar DOT accumulator vs the packed MAC accumulator
CAESAR_DOT_OPS = {CaesarOp.DOT_INIT, CaesarOp.DOT, CaesarOp.DOT_STORE}
CAESAR_MAC_OPS = {CaesarOp.MAC_INIT, CaesarOp.MAC, CaesarOp.MAC_STORE}
CAESAR_STORE_OPS = {CaesarOp.AND, CaesarOp.OR, CaesarOp.XOR, CaesarOp.ADD,
                    CaesarOp.SUB, CaesarOp.MUL, CaesarOp.MAC_STORE,
                    CaesarOp.DOT_STORE, CaesarOp.SLL, CaesarOp.SLR,
                    CaesarOp.SRA, CaesarOp.MIN, CaesarOp.MAX}

CAESAR_ADDR_BITS = 13
CAESAR_ADDR_MASK = (1 << CAESAR_ADDR_BITS) - 1


def caesar_encode(op: CaesarOp, dest: int, src1: int, src2: int) -> tuple[int, int]:
    """-> (write_data_word, write_address) as issued on the bus."""
    assert 0 <= src1 <= CAESAR_ADDR_MASK and 0 <= src2 <= CAESAR_ADDR_MASK
    data = (int(op) << 26) | (src2 << CAESAR_ADDR_BITS) | src1
    return data & 0xFFFFFFFF, dest


def caesar_decode(data: int, addr: int) -> tuple[CaesarOp, int, int, int]:
    op = CaesarOp((data >> 26) & 0x3F)
    src2 = (data >> CAESAR_ADDR_BITS) & CAESAR_ADDR_MASK
    src1 = data & CAESAR_ADDR_MASK
    return op, addr, src1, src2


# Trace representation consumed by the scan-based engine.
CAESAR_TRACE_DTYPE = np.dtype(
    [("op", "<i4"), ("dest", "<i4"), ("src1", "<i4"), ("src2", "<i4")])


# ---------------------------------------------------------------------------
# NM-Carus: xvnmc
# ---------------------------------------------------------------------------

XVNMC_OPCODE = 0x5B  # RISC-V Custom-2

class F3(enum.IntEnum):
    OPIVV = 0b000
    OPIVI = 0b011
    OPIVX = 0b100
    OPMVX = 0b110
    OPCFG = 0b111     # vsetvli-style configuration


class VOp(enum.IntEnum):
    """funct6 assignments for xvnmc (custom space; RVV-inspired)."""
    VADD = 0b000000
    VSUB = 0b000010
    VMINU = 0b000100
    VMIN = 0b000101
    VMAXU = 0b000110
    VMAX = 0b000111
    VAND = 0b001001
    VOR = 0b001010
    VXOR = 0b001011
    VSLIDEUP = 0b001110    # also slide1up under OPMVX
    VSLIDEDOWN = 0b001111  # also slide1down under OPMVX
    VMV = 0b010111
    VMUL = 0b100100
    VMACC = 0b101101
    VSLL = 0b100101
    VSRL = 0b101000
    VSRA = 0b101001
    EMVV = 0b110000        # v[d][x[vs2_f]] = x[rs1]        (OPMVX)
    EMVX = 0b110001        # x[rd] = v[vs2][x[rs1]]         (OPMVX)
    VSETVL = 0b111111      # configuration (OPCFG)
    VNOP = 0b111110        # true no-op (VRF/VL untouched, zero cycles) —
                           # instruction-stream padding for the bucketed
                           # scheduler (repro_torch.nmc.pool)


ARITH_OPS = {VOp.VADD: "add", VOp.VSUB: "sub", VOp.VMUL: "mul",
             VOp.VAND: "and", VOp.VOR: "or", VOp.VXOR: "xor",
             VOp.VMIN: "min", VOp.VMINU: "minu", VOp.VMAX: "max",
             VOp.VMAXU: "maxu", VOp.VSLL: "sll", VOp.VSRL: "srl",
             VOp.VSRA: "sra"}

# Compact opcode ids shared by the scanned Carus executor (dense for
# lax.switch) and the unified program IR (repro_torch.nmc.program).
VOP_COMPACT = (VOp.VADD, VOp.VSUB, VOp.VMUL, VOp.VMACC, VOp.VAND, VOp.VOR,
               VOp.VXOR, VOp.VMIN, VOp.VMINU, VOp.VMAX, VOp.VMAXU, VOp.VSLL,
               VOp.VSRL, VOp.VSRA, VOp.VMV, VOp.VSLIDEUP, VOp.VSLIDEDOWN,
               VOp.EMVV, VOp.EMVX, VOp.VSETVL, VOp.VNOP)
COMPACT_ID = {op: i for i, op in enumerate(VOP_COMPACT)}

# Timing classes (see constants.CARUS_CPE)
VOP_TIMING_CLASS = {
    VOp.VADD: "add", VOp.VSUB: "add", VOp.VMIN: "add", VOp.VMINU: "add",
    VOp.VMAX: "add", VOp.VMAXU: "add", VOp.VAND: "logic", VOp.VOR: "logic",
    VOp.VXOR: "logic", VOp.VMUL: "mul", VOp.VMACC: "macc", VOp.VSLL: "shift",
    VOp.VSRL: "shift", VOp.VSRA: "shift", VOp.VMV: "move",
    VOp.VSLIDEUP: "move", VOp.VSLIDEDOWN: "move",
}


class VInstr(NamedTuple):
    """Decoded xvnmc instruction (fields straight from the encoding)."""
    funct6: int
    indirect: bool
    vs2_f: int      # vs2 / scalar GPR holding indirect indices / idx GPR
    vs1_f: int      # vs1 / rs1 / simm5
    funct3: int
    vd_f: int       # vd / rd
    one: bool = False  # slide1up/slide1down variant


def xvnmc_encode(i: VInstr) -> int:
    imm5 = i.vs1_f & 0x1F
    word = ((int(i.funct6) & 0x3F) << 26) | ((1 if i.indirect else 0) << 25) \
        | ((i.vs2_f & 0x1F) << 20) | (imm5 << 15) | ((int(i.funct3) & 0x7) << 12) \
        | ((i.vd_f & 0x1F) << 7) | XVNMC_OPCODE
    return word & 0xFFFFFFFF


def xvnmc_decode(word: int) -> VInstr:
    assert (word & 0x7F) == XVNMC_OPCODE, hex(word)
    return VInstr(
        funct6=(word >> 26) & 0x3F,
        indirect=bool((word >> 25) & 1),
        vs2_f=(word >> 20) & 0x1F,
        vs1_f=(word >> 15) & 0x1F,
        funct3=(word >> 12) & 0x7,
        vd_f=(word >> 7) & 0x1F,
    )


def vsetvli_encode(rd: int, rs1: int, sew: int) -> int:
    """vsetvl-style: vl = min(x[rs1], VLMAX(sew)); x[rd] = vl."""
    vsew = {8: 0, 16: 1, 32: 2}[sew]
    return (((VOp.VSETVL & 0x3F) << 26) | (vsew << 20) | ((rs1 & 0x1F) << 15)
            | (F3.OPCFG << 12) | ((rd & 0x1F) << 7) | XVNMC_OPCODE)


# ---------------------------------------------------------------------------
# Trace representation for the scan-based Carus VPU executor.
#
# A trace entry is an *issued* instruction: scalar operands already read from
# the eCPU GPRs (`sval1` = x[rs1], `sval2` = x[rs2-like field]).  Indirect
# register addressing is still resolved inside the engine from `sval2`'s bytes
# — faithfully modeling the hardware mechanism (and exercised as such).
#
# mode: 0=vv, 1=vx, 2=vi  |  bit2 (4): indirect  |  bit3 (8): slide1 variant
# ---------------------------------------------------------------------------

CARUS_TRACE_DTYPE = np.dtype(
    [("op", "<i4"), ("vd", "<i4"), ("vs1", "<i4"), ("vs2", "<i4"),
     ("sval1", "<i4"), ("sval2", "<i4"), ("imm", "<i4"), ("mode", "<i4")])

MODE_VV, MODE_VX, MODE_VI = 0, 1, 2
MODE_INDIRECT = 4
MODE_SLIDE1 = 8


def pack_indices(vd: int, vs2: int, vs1: int) -> int:
    """Pack register indices into a GPR value for indirect addressing
    (paper: 'the three least-significant bytes of a scalar GPR')."""
    return ((vd & 0xFF) << 16) | ((vs2 & 0xFF) << 8) | (vs1 & 0xFF)
