"""NM-Carus embedded controller: an RV32E interpreter + a tiny assembler.

The paper's eCPU is an OpenHW CV32E40X configured as RV32EC (16 GPRs, no
hardware mul/div) that offloads ``xvnmc`` instructions to the VPU over the
CORE-V X interface.  This module provides:

* :class:`ECpu` — an instruction-accurate RV32E interpreter executing real
  32-bit RISC-V words from an eMEM image.  ``xvnmc`` (Custom-2) instructions
  are decoded and dispatched to a :class:`repro_torch.core.carus.CarusVPU`
  *eagerly* (on the device of the VRF tensor), while also being appended
  to a unified-IR issue trace (:mod:`repro_torch.nmc.program` entries), so
  the exact same kernel can later be replayed through the batched VPU
  executor — or batched across tiles by
  :class:`repro_torch.nmc.pool.TilePool` — and costed by
  :mod:`repro_torch.core.timing` via :meth:`ECpu.program`.
* :func:`assemble` — a minimal assembler for the supported subset (enough to
  write the paper's kernel-driver loops, e.g. the indirect-addressing loop of
  Section III-B1).

This is a correctness/programmability model, not a performance model: timing
is derived from the issue trace by :mod:`repro_torch.core.timing`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import carus as carus_mod
from repro_torch.core import isa
from repro_torch.core.isa import F3, VOp
from repro_torch.models.config import resolve_device

N_GPRS = 16  # RV32E


def _ir():
    # Deferred: repro_torch.nmc.program imports repro_torch.core, which
    # imports this module — a top-level import here would close that cycle.
    from repro_torch.nmc import program as nmc_program
    return nmc_program


def _sx(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v & (1 << (bits - 1)) else v


def _u32(v: int) -> int:
    return v & 0xFFFFFFFF


def _i32(v: int) -> int:
    return _sx(v, 32)


class ECpu:
    """RV32E + xvnmc interpreter over a byte-addressable eMEM."""

    def __init__(self, vpu: carus_mod.CarusVPU, vrf, emem_bytes: int = 4096,
                 sew: int = 32, device=None):
        self.vpu = vpu
        # int32 tensor (n_regs, reg_words).  A tensor stays on its device;
        # an array-like goes to ``device``: the card unless the caller asks
        # for another (``device="cpu"``)
        self.vrf = vrf if isinstance(vrf, torch.Tensor) \
            else torch.as_tensor(np.asarray(vrf, np.int32),
                                 device=resolve_device(device))
        self.emem = np.zeros(emem_bytes, dtype=np.uint8)
        self.x = [0] * N_GPRS
        self.pc = 0
        self.sew = sew
        self.vl = vpu.cfg.vlmax(sew)
        self.issue_trace: list[np.ndarray] = []   # unified-IR entries
        self.scalar_retired = 0
        self.vector_retired = 0

    def program(self):
        """The issue trace as a unified-IR Program (replayable / costable)."""
        return _ir().Program.from_entries("carus", self.sew, self.issue_trace)

    # -- memory helpers -----------------------------------------------------
    def load_program(self, words: list[int], base: int = 0) -> None:
        for i, w in enumerate(words):
            self.emem[base + 4 * i: base + 4 * i + 4] = \
                np.frombuffer(int(w).to_bytes(4, "little"), dtype=np.uint8)
        self.pc = base

    def _lw(self, addr: int) -> int:
        return _i32(int.from_bytes(self.emem[addr:addr + 4].tobytes(), "little"))

    def _sw(self, addr: int, val: int) -> None:
        self.emem[addr:addr + 4] = np.frombuffer(
            _u32(val).to_bytes(4, "little"), dtype=np.uint8)

    def _set(self, rd: int, val: int) -> None:
        if rd != 0:
            self.x[rd] = _i32(val)

    # -- execution ----------------------------------------------------------
    def run(self, max_steps: int = 200_000) -> None:
        for _ in range(max_steps):
            word = _u32(self._lw(self.pc))
            if word == 0x0000006F:   # `j .` — halt convention
                return
            self.step(word)
        raise RuntimeError("eCPU did not halt within max_steps")

    def step(self, word: int) -> None:
        op = word & 0x7F
        rd = (word >> 7) & 0x1F
        f3 = (word >> 12) & 0x7
        rs1 = (word >> 15) & 0x1F
        rs2 = (word >> 20) & 0x1F
        f7 = (word >> 25) & 0x7F
        next_pc = self.pc + 4
        X = self.x

        if op == 0x37:      # LUI
            self._set(rd, word & 0xFFFFF000)
        elif op == 0x17:    # AUIPC
            self._set(rd, self.pc + _sx(word & 0xFFFFF000, 32))
        elif op == 0x6F:    # JAL
            imm = (((word >> 31) & 1) << 20) | (((word >> 12) & 0xFF) << 12) \
                | (((word >> 20) & 1) << 11) | (((word >> 21) & 0x3FF) << 1)
            self._set(rd, next_pc)
            next_pc = self.pc + _sx(imm, 21)
        elif op == 0x67:    # JALR
            t = (X[rs1] + _sx(word >> 20, 12)) & ~1
            self._set(rd, next_pc)
            next_pc = _u32(t)
        elif op == 0x63:    # branches
            imm = (((word >> 31) & 1) << 12) | (((word >> 7) & 1) << 11) \
                | (((word >> 25) & 0x3F) << 5) | (((word >> 8) & 0xF) << 1)
            off = _sx(imm, 13)
            a, b = X[rs1], X[rs2]
            ua, ub = _u32(a), _u32(b)
            taken = {0: a == b, 1: a != b, 4: a < b, 5: a >= b,
                     6: ua < ub, 7: ua >= ub}[f3]
            if taken:
                next_pc = self.pc + off
        elif op == 0x03:    # loads
            addr = _u32(X[rs1] + _sx(word >> 20, 12))
            w = self._lw(addr & ~3)
            sh = (addr & 3) * 8
            if f3 == 0:   self._set(rd, _sx(w >> sh, 8))       # LB
            elif f3 == 1: self._set(rd, _sx(w >> sh, 16))      # LH
            elif f3 == 2: self._set(rd, w)                     # LW
            elif f3 == 4: self._set(rd, (w >> sh) & 0xFF)      # LBU
            elif f3 == 5: self._set(rd, (w >> sh) & 0xFFFF)    # LHU
        elif op == 0x23:    # stores
            imm = ((word >> 25) << 5) | rd
            addr = _u32(X[rs1] + _sx(imm, 12))
            if f3 == 2:
                self._sw(addr, X[rs2])
            else:
                n = 1 if f3 == 0 else 2
                self.emem[addr:addr + n] = np.frombuffer(
                    _u32(X[rs2]).to_bytes(4, "little")[:n], dtype=np.uint8)
        elif op == 0x13:    # op-imm
            imm = _sx(word >> 20, 12)
            sh = (word >> 20) & 0x1F
            r = {0: X[rs1] + imm,
                 2: int(X[rs1] < imm),
                 3: int(_u32(X[rs1]) < _u32(imm)),
                 4: X[rs1] ^ imm, 6: X[rs1] | imm, 7: X[rs1] & imm,
                 1: X[rs1] << sh,
                 5: (_u32(X[rs1]) >> sh) if f7 == 0 else (X[rs1] >> sh)}[f3]
            self._set(rd, r)
        elif op == 0x33:    # op
            a, b = X[rs1], X[rs2]
            sh = b & 31
            if f3 == 0:
                r = a - b if f7 == 0x20 else a + b
            elif f3 == 1: r = a << sh
            elif f3 == 2: r = int(a < b)
            elif f3 == 3: r = int(_u32(a) < _u32(b))
            elif f3 == 4: r = a ^ b
            elif f3 == 5: r = (_u32(a) >> sh) if f7 == 0 else (a >> sh)
            elif f3 == 6: r = a | b
            else:         r = a & b
            self._set(rd, r)
        elif op == isa.XVNMC_OPCODE:
            self._exec_xvnmc(word)
            self.vector_retired += 1
            self.pc = next_pc
            return
        else:
            raise ValueError(f"unsupported opcode {op:#x} at pc={self.pc:#x}")
        self.scalar_retired += 1
        self.pc = next_pc

    # -- xvnmc offload --------------------------------------------------------
    def _exec_xvnmc(self, word: int) -> None:
        d = isa.xvnmc_decode(word)
        f6 = d.funct6

        if d.funct3 == F3.OPCFG:     # vsetvl: vl = min(x[rs1], VLMAX(sew))
            sew = 8 << d.vs2_f
            self.sew = sew
            avl = self.x[d.vs1_f]
            self.vl = min(avl, self.vpu.cfg.vlmax(sew))
            self._set(d.vd_f, self.vl)
            self.issue_trace.append(_ir().carus_entry(
                VOp.VSETVL, sval1=avl))
            self._replay_last()
            return

        if f6 == VOp.EMVX:
            e = _ir().carus_entry(VOp.EMVX, vs2=d.vs2_f,
                                  sval1=self.x[d.vs1_f])
            self.issue_trace.append(e)
            out = self._replay_last()
            self._set(d.vd_f, int(out))
            return
        if f6 == VOp.EMVV:
            e = _ir().carus_entry(VOp.EMVV, vd=d.vd_f,
                                  sval1=self.x[d.vs1_f],
                                  sval2=self.x[d.vs2_f])
            self.issue_trace.append(e)
            self._replay_last()
            return

        mode = {F3.OPIVV: isa.MODE_VV, F3.OPIVX: isa.MODE_VX,
                F3.OPIVI: isa.MODE_VI, F3.OPMVX: isa.MODE_VX}[F3(d.funct3)]
        if d.indirect:
            mode |= isa.MODE_INDIRECT
        slide1 = d.funct3 == F3.OPMVX and f6 in (VOp.VSLIDEUP, VOp.VSLIDEDOWN)
        if slide1:
            mode |= isa.MODE_SLIDE1
        sval1 = self.x[d.vs1_f] if mode & 0x3 != isa.MODE_VI else 0
        imm = _sx(d.vs1_f, 5) if mode & 0x3 == isa.MODE_VI else 0
        # In indirect mode the vs2 field names the GPR carrying the indices.
        sval2 = self.x[d.vs2_f] if d.indirect else 0
        e = _ir().carus_entry(VOp(f6), vd=d.vd_f, vs1=d.vs1_f,
                              vs2=d.vs2_f, sval1=sval1, sval2=sval2,
                              imm=imm, mode=mode)
        self.issue_trace.append(e)
        self._replay_last()

    def _replay_last(self):
        prog = _ir().Program.from_entries("carus", self.sew,
                                          [self.issue_trace[-1]])
        self.vrf, vl, outs = self.vpu.run_program(self.vrf, prog,
                                                  vl0=self.vl)
        self.vl = int(vl)
        return outs[0]


# ---------------------------------------------------------------------------
# Minimal assembler (subset used by the demo kernels and tests)
# ---------------------------------------------------------------------------

_REGS = {f"x{i}": i for i in range(32)}
_REGS.update({"zero": 0, "ra": 1, "sp": 2, "gp": 3, "tp": 4, "t0": 5,
              "t1": 6, "t2": 7, "s0": 8, "s1": 9, "a0": 10, "a1": 11,
              "a2": 12, "a3": 13, "a4": 14, "a5": 15})
_VREGS = {f"v{i}": i for i in range(32)}


def _enc_i(op, rd, f3, rs1, imm):
    return _u32((imm & 0xFFF) << 20 | rs1 << 15 | f3 << 12 | rd << 7 | op)


def _enc_r(f7, rs2, rs1, f3, rd, op):
    return _u32(f7 << 25 | rs2 << 20 | rs1 << 15 | f3 << 12 | rd << 7 | op)


def _enc_b(f3, rs1, rs2, off):
    imm = off & 0x1FFF
    return _u32((((imm >> 12) & 1) << 31) | (((imm >> 5) & 0x3F) << 25)
                | (rs2 << 20) | (rs1 << 15) | (f3 << 12)
                | (((imm >> 1) & 0xF) << 8) | (((imm >> 11) & 1) << 7) | 0x63)


def assemble(src: str) -> list[int]:
    """Two-pass assembler for the supported RV32E + xvnmc subset."""
    lines = []
    for raw in src.splitlines():
        line = raw.split("#")[0].strip().replace(",", " ")
        if line:
            lines.append(line)
    def _li_words(line: str) -> int:
        toks = line.split()
        if toks[0] != "li":
            return 1
        imm = int(toks[2], 0)
        return 1 if -2048 <= imm < 2048 else 2   # addi vs lui+addi

    # pass 1: labels
    labels, pc = {}, 0
    for line in lines:
        if line.endswith(":"):
            labels[line[:-1]] = pc
        else:
            pc += 4 * _li_words(line)
    # pass 2
    words, pc = [], 0
    for line in lines:
        if line.endswith(":"):
            continue
        toks = line.split()
        m, args = toks[0], toks[1:]

        def R(i):
            return _REGS[args[i]]

        def V(i):
            return _VREGS[args[i]]

        def IMM(i):
            a = args[i]
            return labels[a] - pc if a in labels else int(a, 0)

        if m == "li":
            imm = IMM(1)
            if -2048 <= imm < 2048:
                words.append(_enc_i(0x13, R(0), 0, 0, imm))          # addi rd,x0
            else:
                upper = (imm + 0x800) >> 12
                words.append(_u32((upper << 12) | (R(0) << 7) | 0x37))  # lui
                words.append(_enc_i(0x13, R(0), 0, R(0), imm - (upper << 12)))
                pc += 4
        elif m == "mv":
            words.append(_enc_i(0x13, R(0), 0, R(1), 0))
        elif m == "addi":
            words.append(_enc_i(0x13, R(0), 0, R(1), IMM(2)))
        elif m == "slli":
            words.append(_enc_i(0x13, R(0), 1, R(1), IMM(2) & 31))
        elif m == "add":
            words.append(_enc_r(0, R(2), R(1), 0, R(0), 0x33))
        elif m == "sub":
            words.append(_enc_r(0x20, R(2), R(1), 0, R(0), 0x33))
        elif m == "lw":
            off, base = args[1].split("(")
            words.append(_enc_i(0x03, R(0), 2, _REGS[base[:-1]], int(off, 0)))
        elif m == "sw":
            off, base = args[1].split("(")
            imm = int(off, 0)
            rs1, rs2 = _REGS[base[:-1]], R(0)
            words.append(_u32(((imm >> 5) << 25) | (rs2 << 20) | (rs1 << 15)
                              | (2 << 12) | ((imm & 0x1F) << 7) | 0x23))
        elif m in ("beq", "bne", "blt", "bge"):
            f3 = {"beq": 0, "bne": 1, "blt": 4, "bge": 5}[m]
            words.append(_enc_b(f3, R(0), R(1), IMM(2)))
        elif m == "j":
            off = IMM(0) & 0x1FFFFF
            words.append(_u32((((off >> 20) & 1) << 31)
                              | (((off >> 1) & 0x3FF) << 21)
                              | (((off >> 11) & 1) << 20)
                              | (((off >> 12) & 0xFF) << 12) | 0x6F))
        elif m == "halt":
            words.append(0x0000006F)                                  # j .
        elif m == "vsetvli":  # vsetvli rd, rs1, e{sew}
            sew = int(args[2][1:])
            words.append(isa.vsetvli_encode(R(0), R(1), sew))
        elif m.startswith("xvnmc."):
            words.append(_asm_xvnmc(m[6:], args))
        else:
            raise ValueError(f"unknown mnemonic {m!r}")
        pc += 4
    return words


_VOP_BY_NAME = {
    "vadd": VOp.VADD, "vsub": VOp.VSUB, "vmul": VOp.VMUL, "vmacc": VOp.VMACC,
    "vand": VOp.VAND, "vor": VOp.VOR, "vxor": VOp.VXOR, "vmin": VOp.VMIN,
    "vminu": VOp.VMINU, "vmax": VOp.VMAX, "vmaxu": VOp.VMAXU,
    "vsll": VOp.VSLL, "vsrl": VOp.VSRL, "vsra": VOp.VSRA, "vmv": VOp.VMV,
    "vslideup": VOp.VSLIDEUP, "vslidedown": VOp.VSLIDEDOWN,
}


def _asm_xvnmc(name: str, args: list[str]) -> int:
    if name == "emvv":      # emvv vd, x_idx, x_val  -> vd[x[idx]] = x[val]
        return isa.xvnmc_encode(isa.VInstr(VOp.EMVV, False,
                                           _REGS[args[1]], _REGS[args[2]],
                                           F3.OPMVX, _VREGS[args[0]]))
    if name == "emvx":      # emvx rd, vs2, x_idx
        return isa.xvnmc_encode(isa.VInstr(VOp.EMVX, False,
                                           _VREGS[args[1]], _REGS[args[2]],
                                           F3.OPMVX, _REGS[args[0]]))
    base, _, var = name.partition(".")
    indirect = base.endswith("r")
    if indirect:
        base = base[:-1]
    vop = _VOP_BY_NAME[base]
    if indirect:
        # xvnmc.vaddr.vv xN  (indices in GPR xN; fields vd/vs1 unused)
        f3 = {"vv": F3.OPIVV, "vx": F3.OPIVX, "vi": F3.OPIVI}[var]
        gpr = _REGS[args[0]]
        vs1 = _REGS[args[1]] if var == "vx" else (
            int(args[1], 0) & 0x1F if var == "vi" else 0)
        return isa.xvnmc_encode(isa.VInstr(vop, True, gpr, vs1, f3, 0))
    if var == "vv":
        return isa.xvnmc_encode(isa.VInstr(vop, False, _VREGS[args[1]],
                                           _VREGS[args[2]], F3.OPIVV,
                                           _VREGS[args[0]]))
    if var == "vx":
        return isa.xvnmc_encode(isa.VInstr(vop, False, _VREGS[args[1]],
                                           _REGS[args[2]], F3.OPIVX,
                                           _VREGS[args[0]]))
    if var == "vi":
        return isa.xvnmc_encode(isa.VInstr(vop, False, _VREGS[args[1]],
                                           int(args[2], 0) & 0x1F, F3.OPIVI,
                                           _VREGS[args[0]]))
    raise ValueError(f"bad xvnmc variant {name}")
