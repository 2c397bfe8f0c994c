"""Structural pass: per-entry well-formedness of a unified-IR program.

Opcode valid for the engine, register/address ranges (Carus VRF bounds,
Caesar word addresses vs the 32 KiB macro), SEW-legal modes, Caesar
entries structurally zero in the Carus-only fields, and padding NOPs
truly neutral.

This module also owns the shared IR-decoding machinery (opcode class
LUTs, the column view, resolved Carus operand masks) that the dataflow,
resource and optimizer layers reuse — decode once per verification, not
once per pass.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import constants as C
from repro_torch.core import isa
from repro_torch.core.isa import CaesarOp, VOp
from repro_torch.nmc.program import NOP_OP_ID, PROG_DTYPE, Program
from repro_torch.nmc.registry import engine_op_ids

from repro_torch.nmc.check.report import _Ctx

_CAESAR_MEM_WORDS = C.CAESAR_MEM_BYTES // C.WORD_BYTES
_CAESAR_BANK_WORDS = _CAESAR_MEM_WORDS // C.CAESAR_N_BANKS
_CARUS_REG_WORDS = C.CARUS_REG_WORDS
_CARUS_N_REGS = C.CARUS_N_VREGS

_NOP_C = NOP_OP_ID["caesar"]
_NOP_K = NOP_OP_ID["carus"]

# Caesar opcode classes, as boolean lookup tables over the (small) opcode
# space — `lut[clip(op)] & in-range` beats np.isin on the hot verify path
_LUT_N = 64


def _class_lut(ids) -> np.ndarray:
    lut = np.zeros(_LUT_N, bool)
    lut[np.array(sorted(int(i) for i in ids))] = True
    return lut


def _member(op: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Vectorized set membership; ids outside [0, _LUT_N) are non-members."""
    return lut[np.clip(op, 0, _LUT_N - 1)] & (op >= 0) & (op < _LUT_N)


_N_FIELDS = len(PROG_DTYPE.names)
_COL = {name: i for i, name in enumerate(PROG_DTYPE.names)}


def _columns(e: np.ndarray) -> np.ndarray:
    """The entries as a [n, 8] int32 matrix: column slices are much
    cheaper than repeated structured-field extraction on the hot path."""
    if not e.flags.c_contiguous:
        e = np.ascontiguousarray(e)
    return e.view(np.int32).reshape(len(e), _N_FIELDS)


def _caesar_code(ctx: _Ctx, op: np.ndarray) -> np.ndarray:
    """Per-op combined class code (see :data:`_C_CODE`), computed once per
    verification and shared between the structural and dataflow passes."""
    code = ctx.cache.get("ccode")
    if code is None:
        code = _C_CODE[np.clip(op, 0, _LUT_N - 1)]   # fancy index: a copy
        if len(op) and int(op.min()) < 0:
            code[op < 0] = 0
        ctx.cache["ccode"] = code
    return code


_C_STORE = _class_lut(isa.CAESAR_STORE_OPS)
_C_READ = _class_lut(o for o in CaesarOp
                     if o not in (CaesarOp.CSRW, CaesarOp.NOP))
_C_VALID = _class_lut(engine_op_ids("caesar"))
_C_CHAIN = _class_lut([CaesarOp.MAC_INIT, CaesarOp.MAC, CaesarOp.MAC_STORE,
                       CaesarOp.DOT_INIT, CaesarOp.DOT, CaesarOp.DOT_STORE])

# combined per-op class code (bit0 read, bit1 store, bit2 valid, bit3
# MAC/DOT chain) — one lookup serves the structural and dataflow passes
_C_CODE = (_C_READ * 1 + _C_STORE * 2 + _C_VALID * 4 + _C_CHAIN * 8
           ).astype(np.int8)

# Carus compact-id classes
_K_ID = isa.COMPACT_ID
_K_ARITH = _class_lut(_K_ID[v] for v in isa.ARITH_OPS)
_K_MACC = _K_ID[VOp.VMACC]
_K_MV = _K_ID[VOp.VMV]
_K_SLIDES = _class_lut([_K_ID[VOp.VSLIDEUP], _K_ID[VOp.VSLIDEDOWN]])
_K_EMVV, _K_EMVX = _K_ID[VOp.EMVV], _K_ID[VOp.EMVX]
_K_SETVL = _K_ID[VOp.VSETVL]
_K_MODE_BITS = 0x3 | isa.MODE_INDIRECT | isa.MODE_SLIDE1


def _structural_caesar(e: np.ndarray, ctx: _Ctx) -> None:
    m = _columns(e)
    op = m[:, 0]
    code = _caesar_code(ctx, op)
    bad = (code & 4) == 0
    ctx.emit_rows("error", "structural", "bad-opcode", np.flatnonzero(bad),
                  lambda i: f"opcode {int(op[i])} is not an NM-Caesar "
                            f"bus micro-op")
    addrs = m[:, 1:4]                   # dest / src1 / src2
    oob_any = (addrs < 0) | (addrs >= _CAESAR_MEM_WORDS)
    if oob_any.any():                   # clean programs skip the per-field walk
        real = ~bad & (op != _NOP_C)
        for c, f in enumerate(("dest", "src1", "src2")):
            v = addrs[:, c]
            ctx.emit_rows(
                "error", "structural", "oob-address",
                np.flatnonzero(real & oob_any[:, c]),
                lambda i, f=f, v=v: f"{f}={int(v[i])} outside the "
                f"{_CAESAR_MEM_WORDS}-word (32 KiB) macro")
    carus_f = m[:, 4:]                  # sval1 / sval2 / imm / mode
    junk = None
    if carus_f.any():
        junk = carus_f.any(axis=1)
        ctx.emit_rows(
            "error", "structural", "nonzero-carus-field",
            np.flatnonzero(junk),
            lambda i: "Caesar entries must be structurally zero in the "
            "Carus-only fields (sval1/sval2/imm/mode); Program.from_entries "
            "normalizes them")
    nops = op == _NOP_C
    if nops.any():
        nop_bad = nops & addrs.any(axis=1)
        if junk is not None:
            nop_bad &= ~junk
        ctx.emit_rows(
            "error", "structural", "nop-not-neutral",
            np.flatnonzero(nop_bad),
            lambda i: "padding NOP carries non-zero operand fields — not a "
            "neutral bucket filler")


def _carus_regs(e: np.ndarray) -> tuple:
    """Resolved (vd, vs2, vs1) operand indices per entry: direct fields,
    or the bytes of ``sval2`` under MODE_INDIRECT (the engine resolves
    these at runtime and silently wraps modulo n_regs — exactly the bug
    class the bounds check below catches statically)."""
    ind = (e["mode"] & isa.MODE_INDIRECT) != 0
    s2 = e["sval2"]
    vd = np.where(ind, (s2 >> 16) & 0xFF, e["dest"])
    vs2 = np.where(ind, (s2 >> 8) & 0xFF, e["src2"])
    vs1 = np.where(ind, s2 & 0xFF, e["src1"])
    return vd, vs2, vs1


def _carus_uses(e: np.ndarray) -> tuple:
    """Boolean (uses_vd, reads_vd, uses_vs2, uses_vs1, writes_vd) masks
    from the engine's operand semantics per opcode and mode."""
    op, opmode = e["op"], e["mode"] & 0x3
    arith = _member(op, _K_ARITH)
    macc = op == _K_MACC
    mv = op == _K_MV
    slide = _member(op, _K_SLIDES)
    vv = opmode == isa.MODE_VV
    writes_vd = arith | macc | mv | slide | (op == _K_EMVV)
    reads_vd = macc | (op == _K_EMVV)      # in-place accumulate / RMW lane
    uses_vs2 = arith | macc | slide | (op == _K_EMVX)
    uses_vs1 = (arith | macc | mv) & vv    # .vv second operand (VMV copies)
    return writes_vd | reads_vd, reads_vd, uses_vs2, uses_vs1, writes_vd


def _carus_operands(ctx: _Ctx, e: np.ndarray) -> tuple:
    """(regs, uses) for the program, cached on the ctx: both the
    structural and the dataflow pass need them, and on the tiny programs
    carus lowers to, the numpy-call count is the whole verify cost."""
    ops = ctx.cache.get("kops")
    if ops is None:
        ops = (_carus_regs(e), _carus_uses(e))
        ctx.cache["kops"] = ops
    return ops


def _structural_carus(e: np.ndarray, ctx: _Ctx, sew: int) -> None:
    op = e["op"]
    bad = (op < 0) | (op >= len(isa.VOP_COMPACT))
    ctx.emit_rows("error", "structural", "bad-opcode", np.flatnonzero(bad),
                  lambda i: f"opcode {int(op[i])} is outside the xvnmc "
                            f"compact-id space [0, {len(isa.VOP_COMPACT)})")
    ok = ~bad
    mode = e["mode"]
    bad_mode = ok & (((mode & ~_K_MODE_BITS) != 0) | ((mode & 0x3) == 0x3))
    ctx.emit_rows("error", "structural", "bad-mode",
                  np.flatnonzero(bad_mode),
                  lambda i: f"mode={int(mode[i])} is not a legal "
                            f"vv/vx/vi (+indirect/slide1) encoding")
    (vd, vs2, vs1), (uses_vd, _, uses_vs2, uses_vs1, _) = \
        _carus_operands(ctx, e)
    for name, idxs, used in (("vd", vd, uses_vd), ("vs2", vs2, uses_vs2),
                             ("vs1", vs1, uses_vs1)):
        oob = ok & used & ((idxs < 0) | (idxs >= _CARUS_N_REGS))
        ctx.emit_rows(
            "error", "structural", "oob-register", np.flatnonzero(oob),
            lambda i, name=name, idxs=idxs: f"{name}=v{int(idxs[i])} "
            f"outside the {_CARUS_N_REGS}-register VRF (the engine would "
            f"silently wrap modulo {_CARUS_N_REGS})")
    setvl = ok & (op == _K_SETVL)
    vlmax = _CARUS_REG_WORDS * (32 // sew)
    sval1 = e["sval1"]
    ctx.emit_rows(
        "warning", "structural", "vl-clamped",
        np.flatnonzero(setvl & (sval1 > vlmax)),
        lambda i: f"VSETVL requests vl={int(sval1[i])} > VLMAX({sew})="
        f"{vlmax}; the engine clamps")
    ctx.emit_rows(
        "warning", "structural", "vl-empty",
        np.flatnonzero(setvl & (sval1 <= 0)),
        lambda i: f"VSETVL requests vl={int(sval1[i])}: every following "
        f"vector op writes nothing")
    nop_bad = (op == _NOP_K) & (
        (e["dest"] | e["src1"] | e["src2"] | e["sval1"] | e["sval2"]
         | e["imm"] | e["mode"]) != 0)
    ctx.emit_rows(
        "error", "structural", "nop-not-neutral", np.flatnonzero(nop_bad),
        lambda i: "padding VNOP carries non-zero fields — not a neutral "
        "bucket filler")


def check_structural(prog: Program, ctx: _Ctx) -> None:
    if prog.engine == "caesar":
        _structural_caesar(prog.entries, ctx)
    else:
        _structural_carus(prog.entries, ctx, prog.sew)
