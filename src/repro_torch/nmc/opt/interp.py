"""Independent numpy interpreters — the optimizer's differential oracle.

These reimplement the engine semantics (``repro_torch.core.caesar`` /
``repro_torch.core.carus``) directly over numpy words, sharing only the lane
arithmetic in :mod:`repro_torch.core.alu`.  They are deliberately *not* the JAX
scan engines: the translation-validation gate (:mod:`repro_torch.nmc.opt.
validate`) compares a rewritten program against the pre-rewrite program
under this third implementation, so an optimizer bug and an engine bug
cannot mask each other.

Both entry points take the flat int32 image and the PROG_DTYPE entries
and return the final flat image; observable output is the ``out_slice``
window of that image (EMVX scan-outputs never leave the trace — the
frontend embeds tap values at lowering time — and the MAC/DOT
accumulators are not architecturally visible after the stream ends).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import alu
from repro_torch.core import constants as C
from repro_torch.core import isa
from repro_torch.core.caesar import _BINOP_OF
from repro_torch.core.isa import CaesarOp, VOp

_CAESAR_BINOP = {int(op): name for op, name in _BINOP_OF.items()}
_K = isa.COMPACT_ID
_K_ARITH = {_K[v]: name for v, name in isa.ARITH_OPS.items()}


def run_caesar(mem_words: np.ndarray, entries: np.ndarray,
               sew: int) -> np.ndarray:
    """Execute a caesar stream over a flat word image; returns the final
    image (mirrors ``CaesarEngine.run_stream`` row by row)."""
    mem = np.array(mem_words, np.int32).reshape(-1).copy()
    mac = np.zeros(1, np.int32)
    dot = 0
    nop, csrw = int(CaesarOp.NOP), int(CaesarOp.CSRW)
    for r in entries:
        op = int(r["op"])
        if op == nop or op == csrw:
            continue
        a = mem[int(r["src1"])][None]
        b = mem[int(r["src2"])][None]
        name = _CAESAR_BINOP.get(op)
        if name is not None:
            mem[int(r["dest"])] = alu.word_binop_np(name, a, b, sew)[0]
        elif op == int(CaesarOp.MAC_INIT):
            mac = alu.word_macc_np(np.zeros(1, np.int32), a, b, sew)
        elif op == int(CaesarOp.MAC):
            mac = alu.word_macc_np(mac, a, b, sew)
        elif op == int(CaesarOp.MAC_STORE):
            mac = alu.word_macc_np(mac, a, b, sew)
            mem[int(r["dest"])] = mac[0]
        elif op == int(CaesarOp.DOT_INIT):
            dot = alu.word_dot_np(0, a, b, sew)
        elif op == int(CaesarOp.DOT):
            dot = alu.word_dot_np(dot, a, b, sew)
        elif op == int(CaesarOp.DOT_STORE):
            dot = alu.word_dot_np(dot, a, b, sew)
            mem[int(r["dest"])] = dot
        else:
            raise ValueError(f"caesar oracle: unknown opcode {op}")
    return mem


def run_carus(vrf_words: np.ndarray, entries: np.ndarray,
              sew: int) -> np.ndarray:
    """Execute a carus trace over a flat VRF image; returns the final
    image (mirrors ``CarusVPU.run_trace``: indirect operand resolution,
    VL-masked tail-undisturbed writeback, dynamic VL)."""
    n_regs, rw = C.CARUS_N_VREGS, C.CARUS_REG_WORDS
    L = 32 // sew
    n_elems = rw * L
    vlmax = n_elems
    vrf = np.array(vrf_words, np.int32).reshape(n_regs, rw).copy()
    vl = vlmax
    elem_ids = np.arange(n_elems)

    def elems(reg):
        return alu.unpack_lanes_np(vrf[reg], sew).reshape(-1)

    for r in entries:
        op = int(r["op"])
        if op == _K[VOp.VNOP]:
            continue
        mode = int(r["mode"])
        sval1, sval2 = int(r["sval1"]), int(r["sval2"])
        if op == _K[VOp.VSETVL]:
            vl = min(sval1, vlmax)
            continue
        if op == _K[VOp.EMVX]:
            continue            # scan-output only: VRF and VL untouched
        indirect = mode & isa.MODE_INDIRECT
        opmode = mode & 0x3
        vd = ((sval2 >> 16) & 0xFF if indirect else int(r["dest"])) % n_regs
        vs2 = ((sval2 >> 8) & 0xFF if indirect else int(r["src2"])) % n_regs
        vs1 = ((sval2 & 0xFF) if indirect else int(r["src1"])) % n_regs
        dst_e = elems(vd)
        s2_e = elems(vs2)
        scalar_b = int(r["imm"]) if opmode == isa.MODE_VI else sval1
        s1_e = elems(vs1) if opmode == isa.MODE_VV \
            else np.full(n_elems, scalar_b, np.int64)
        wb_vl = vl
        name = _K_ARITH.get(op)
        if name is not None:
            r_e = alu.lane_binop_np(name, s2_e, s1_e, sew)
        elif op == _K[VOp.VMACC]:
            r_e = dst_e + s2_e * s1_e
        elif op == _K[VOp.VMV]:
            r_e = s1_e
        elif op in (_K[VOp.VSLIDEUP], _K[VOp.VSLIDEDOWN]):
            slide1 = mode & isa.MODE_SLIDE1
            off = 1 if slide1 else scalar_b
            if op == _K[VOp.VSLIDEUP]:
                idx = elem_ids - off
                r_e = np.where(idx >= 0,
                               s2_e[np.clip(idx, 0, n_elems - 1)], dst_e)
                if slide1:
                    r_e = np.where(elem_ids == 0, sval1, r_e)
            else:
                idx = elem_ids + off
                r_e = np.where(idx < vl,
                               s2_e[np.clip(idx, 0, n_elems - 1)], 0)
                if slide1:
                    r_e = np.where(elem_ids == vl - 1, sval1, r_e)
        elif op == _K[VOp.EMVV]:
            r_e = np.where(elem_ids == sval2 % n_elems, sval1, dst_e)
            wb_vl = n_elems     # element write: full-length writeback
        else:
            raise ValueError(f"carus oracle: unknown opcode {op}")
        sel = np.where(elem_ids < wb_vl, r_e, dst_e)
        vrf[vd] = alu.pack_lanes_np(sel.reshape(rw, L), sew)
    return vrf.reshape(-1)


def run(engine: str, image: np.ndarray, entries: np.ndarray,
        sew: int) -> np.ndarray:
    return (run_caesar if engine == "caesar" else run_carus)(
        image, entries, sew)
