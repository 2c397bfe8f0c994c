"""Programs that hold one engine backend against another.

* :func:`golden_cases` — one small golden program per opcode (the
  reference's engine-conformance matrix, restated here so that code which
  must not import the reference — the card's smoke run — has it too; the
  CPU tests check that the two lists are identical).
* :func:`random_wave` — a wave of random, verifier-clean programs over every
  opcode and operand mode (slides, EMVV/EMVX, indirect register addressing
  and dynamic VL included), with random images.

Everything is made from a seed with numpy, so the kernels and their plain
versions see the same inputs on any device.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import isa
from repro_torch.core.carus import CarusConfig
from repro_torch.core.isa import CaesarOp, VOp
from repro_torch.nmc.program import (PROG_DTYPE, Program, caesar_entry,
                                     carus_entry)

CONF_BUCKET = 16    # all golden programs pad here
CAESAR_MEM_WORDS = 8192


def _caesar_golden_cases():
    """(label, entries) per NM-Caesar opcode; addresses span both banks."""
    cases = []
    for op in (CaesarOp.AND, CaesarOp.OR, CaesarOp.XOR, CaesarOp.ADD,
               CaesarOp.SUB, CaesarOp.MUL, CaesarOp.SLL, CaesarOp.SLR,
               CaesarOp.SRA, CaesarOp.MIN, CaesarOp.MAX):
        cases.append((op.name.lower(), [
            caesar_entry(op, 100 + i, 7 * i, 4096 + 11 * i)
            for i in range(4)]))
    cases.append(("mac_chain", [
        caesar_entry(CaesarOp.MAC_INIT, 0, 3, 4096),
        caesar_entry(CaesarOp.MAC, 0, 5, 4098),
        caesar_entry(CaesarOp.MAC_STORE, 200, 9, 4100)]))
    cases.append(("dot_chain", [
        caesar_entry(CaesarOp.DOT_INIT, 0, 4, 4097),
        caesar_entry(CaesarOp.DOT, 0, 6, 4099),
        caesar_entry(CaesarOp.DOT_STORE, 201, 8, 4101)]))
    # CSRW and NOP must leave memory untouched (an ADD proves the stream
    # still executed around them)
    cases.append(("csrw_nop", [
        caesar_entry(CaesarOp.CSRW, 0, 1, 0),
        caesar_entry(CaesarOp.NOP, 0, 0, 0),
        caesar_entry(CaesarOp.ADD, 300, 1, 4097)]))
    return [("caesar", label, entries) for label, entries in cases]


def _carus_golden_cases():
    """(label, entries) per NM-Carus vector opcode, VL-restricted so the
    tail-undisturbed writeback is part of every golden image."""
    pre = [carus_entry(VOp.VSETVL, sval1=777)]    # < vlmax at every SEW
    cases = []
    for vop in (VOp.VADD, VOp.VSUB, VOp.VMUL, VOp.VAND, VOp.VOR, VOp.VXOR,
                VOp.VMIN, VOp.VMINU, VOp.VMAX, VOp.VMAXU, VOp.VSLL,
                VOp.VSRL, VOp.VSRA, VOp.VMACC):
        cases.append((vop.name.lower(), pre + [
            carus_entry(vop, vd=4, vs1=1, vs2=2, mode=isa.MODE_VV),
            carus_entry(vop, vd=5, vs2=2, sval1=-3, mode=isa.MODE_VX),
            carus_entry(vop, vd=6, vs2=3, imm=7, mode=isa.MODE_VI)]))
    cases.append(("vmv", pre + [
        carus_entry(VOp.VMV, vd=7, vs1=1, mode=isa.MODE_VV),
        carus_entry(VOp.VMV, vd=8, sval1=-120, mode=isa.MODE_VX)]))
    cases.append(("vslideup", pre + [
        carus_entry(VOp.VSLIDEUP, vd=9, vs2=2, sval1=5, mode=isa.MODE_VX),
        carus_entry(VOp.VSLIDEUP, vd=10, vs2=2, sval1=42,
                    mode=isa.MODE_VX | isa.MODE_SLIDE1)]))
    cases.append(("vslidedown", pre + [
        carus_entry(VOp.VSLIDEDOWN, vd=11, vs2=2, sval1=3, mode=isa.MODE_VX),
        carus_entry(VOp.VSLIDEDOWN, vd=12, vs2=2, sval1=-9,
                    mode=isa.MODE_VX | isa.MODE_SLIDE1)]))
    cases.append(("emvv_emvx", pre + [
        carus_entry(VOp.EMVV, vd=13, sval1=99, sval2=17),
        carus_entry(VOp.EMVX, vd=0, vs2=2, sval1=5)]))
    cases.append(("indirect", pre + [
        carus_entry(VOp.VADD, sval2=isa.pack_indices(14, 2, 1),
                    mode=isa.MODE_VV | isa.MODE_INDIRECT)]))
    cases.append(("vsetvl_vnop", [
        carus_entry(VOp.VSETVL, sval1=3),
        carus_entry(VOp.VNOP),
        carus_entry(VOp.VXOR, vd=15, vs1=1, vs2=2, mode=isa.MODE_VV)]))
    return [("carus", label, entries) for label, entries in cases]


def golden_cases() -> list[tuple[str, str, list]]:
    """``(engine, label, entries)`` for every golden program."""
    return _caesar_golden_cases() + _carus_golden_cases()


def golden_state(engine: str, sew: int) -> np.ndarray:
    """The random initial image every golden program runs against."""
    rng = np.random.default_rng(sew)
    if engine == "caesar":
        return rng.integers(-2**31, 2**31, CAESAR_MEM_WORDS,
                            dtype=np.int64).astype(np.int32)
    return rng.integers(-2**31, 2**31, (32, 256),
                        dtype=np.int64).astype(np.int32)


# ---------------------------------------------------------------------------
# random verifier-clean programs
# ---------------------------------------------------------------------------

_MAC = (CaesarOp.MAC_INIT, CaesarOp.MAC, CaesarOp.MAC_STORE)
_DOT = (CaesarOp.DOT_INIT, CaesarOp.DOT, CaesarOp.DOT_STORE)


def random_caesar_entries(rng, n_instr: int) -> np.ndarray:
    """Random bus ops over the whole opcode set and image, as PROG_DTYPE
    entries; accumulator body and store ops always follow their INIT (a
    STORE closes the chain), and CSRW / NOP carry zero fields (the
    verifier's rules for a well-formed stream)."""
    ops = rng.integers(len(CaesarOp), size=n_instr)
    addr = rng.integers(CAESAR_MEM_WORDS, size=(3, n_instr))
    open_acc = {_MAC: False, _DOT: False}
    for i, op in enumerate(ops.tolist()):
        for chain in (_MAC, _DOT):
            if chain[0] <= op <= chain[2]:
                if not open_acc[chain]:
                    op = ops[i] = chain[0]
                open_acc[chain] = op != chain[2]
    entries = np.zeros(n_instr, dtype=PROG_DTYPE)
    entries["op"] = ops
    real = (ops != CaesarOp.CSRW) & (ops != CaesarOp.NOP)
    for k, name in enumerate(("dest", "src1", "src2")):
        entries[name] = np.where(real, addr[k], 0)
    return entries


def random_carus_entries(rng, n_instr: int, sew: int) -> np.ndarray:
    """Random xvnmc issues over every opcode, as PROG_DTYPE entries: vv/vx/vi
    modes, indirect register addressing, slide1 variants, slide offsets
    near the register length and over the full int32 range, EMVV/EMVX at
    random (also negative) element indices and VSETVL to random (also
    negative or oversized) lengths; 5% are padding VNOPs."""
    vlmax = CarusConfig().vlmax(sew)
    cid = isa.COMPACT_ID
    n = n_instr
    op = rng.integers(cid[VOp.VNOP], size=n)                 # every non-NOP
    reg = rng.integers(32, size=(3, n))
    sval1 = rng.integers(-2**31, 2**31, size=n)
    sval2 = rng.integers(-2**31, 2**31, size=n)
    mode = rng.integers(3, size=n)
    slide = (op == cid[VOp.VSLIDEUP]) | (op == cid[VOp.VSLIDEDOWN])
    near = rng.random(n) < 0.8
    sval1 = np.where(slide & near, rng.integers(-vlmax - 8, vlmax + 8, n),
                     sval1)
    mode = np.where(slide & (rng.random(n) < 0.5), mode | isa.MODE_SLIDE1,
                    mode)
    setvl = op == cid[VOp.VSETVL]
    sval1 = np.where(setvl, rng.integers(-4, vlmax + 17, n), sval1)
    emv = (op == cid[VOp.EMVV]) | (op == cid[VOp.EMVX])
    mode = np.where(emv, isa.MODE_VX, mode)
    ind = ~(emv | setvl) & (rng.random(n) < 0.25)
    mode = np.where(ind, mode | isa.MODE_INDIRECT, mode)
    sval2 = np.where(ind, (reg[0] << 16) | (reg[2] << 8) | reg[1], sval2)
    nop = rng.random(n) < 0.05
    entries = np.zeros(n, dtype=PROG_DTYPE)
    entries["op"] = np.where(nop, cid[VOp.VNOP], op)
    for name, val in (("dest", reg[0]), ("src1", reg[1]), ("src2", reg[2]),
                      ("sval1", sval1), ("sval2", sval2),
                      ("imm", rng.integers(-16, 16, n)), ("mode", mode)):
        entries[name] = np.where(nop, 0, val)
    return entries


def random_wave(engine: str, sew: int, n_tiles: int, n_instr: int,
                seed: int = 0) -> tuple[list[Program], np.ndarray]:
    """``n_tiles`` random programs of exactly ``n_instr`` instructions and
    their random int32 images, stacked ``[n_tiles, ...]``."""
    rng = np.random.default_rng(seed)
    if engine == "caesar":
        progs = [Program.from_entries("caesar", sew,
                                      random_caesar_entries(rng, n_instr))
                 for _ in range(n_tiles)]
        shape = (n_tiles, CAESAR_MEM_WORDS)
    else:
        progs = [Program.from_entries("carus", sew,
                                      random_carus_entries(rng, n_instr, sew))
                 for _ in range(n_tiles)]
        shape = (n_tiles, 32, 256)
    states = rng.integers(-2**31, 2**31, shape,
                          dtype=np.int64).astype(np.int32)
    return progs, states
