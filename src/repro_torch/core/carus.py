"""NM-Carus functional model: banked VRF + single-issue xvnmc VPU.

The VPU executes *traces* — arrays of issued instructions (scalar GPR operands
already resolved, see :data:`repro_torch.core.isa.CARUS_TRACE_DTYPE`): one
dispatch from the host, then the whole kernel runs "autonomously" against the
VRF.  This mirrors the hardware split: the eCPU produces the issue stream; the
VPU consumes it.

Indirect register addressing (the paper's code-size mechanism) is resolved
*inside* the engine from the scalar value's three LSBytes, i.e. register
indices are runtime data — the same instruction template is reused for
arbitrary operand locations, exactly like the hardware.

Functional semantics are element-exact (two's complement, wrap at SEW) via
:mod:`repro_torch.core.alu`.  SEW is static per trace; VL is dynamic state.

:meth:`CarusVPU.run_trace` is the **plain PyTorch version** of the
``carus_wave`` CUDA kernel (``repro_torch/csrc/carus_wave.cu``): a Python
loop over instructions, batched over tiles, computing every candidate
result per step and selecting per tile (the tiles of one wave run different
opcodes at the same step), with no host sync inside the loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import alu
from repro_torch.core import constants as C
from repro_torch.core import isa
from repro_torch.core.isa import VOp


@dataclasses.dataclass(frozen=True)
class CarusConfig:
    n_regs: int = C.CARUS_N_VREGS
    reg_words: int = C.CARUS_REG_WORDS
    n_lanes: int = C.CARUS_N_LANES

    @property
    def mem_words(self) -> int:
        return self.n_regs * self.reg_words

    def vlmax(self, sew: int) -> int:
        return self.reg_words * (32 // sew)


COMPACT_ID = isa.COMPACT_ID
_ID = {op: COMPACT_ID[op] for op in isa.VOP_COMPACT}


def trace_entry(op: VOp, vd=0, vs1=0, vs2=0, sval1=0, sval2=0, imm=0,
                mode=isa.MODE_VV) -> np.ndarray:
    e = np.zeros((), dtype=isa.CARUS_TRACE_DTYPE)
    e["op"] = COMPACT_ID[op]
    e["vd"], e["vs1"], e["vs2"] = vd, vs1, vs2
    e["sval1"], e["sval2"], e["imm"], e["mode"] = (
        np.int32(sval1), np.int32(sval2), np.int32(imm), mode)
    return e


def _wrap32_i64(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> their int32 two's-complement value, kept in int64
    (the wraparound of the reference's int32 index arithmetic)."""
    return ((x + (1 << 31)) & alu._U32) - (1 << 31)


class CarusVPU:
    """xvnmc trace executor over a (n_regs, reg_words) int32 VRF."""

    def __init__(self, config: CarusConfig | None = None):
        self.cfg = config or CarusConfig()

    def run_program(self, vrf: torch.Tensor, program, vl0=None):
        """Execute a unified-IR :class:`repro_torch.nmc.program.Program` on
        the device of ``vrf``."""
        assert program.engine == "carus", program.engine
        return self.run_trace(vrf, program.lower(vrf.device), program.sew,
                              vl0=vl0)

    def run_trace(self, vrf: torch.Tensor, trace: dict, sew: int, vl0=None):
        """Execute a trace.  ``trace`` is a dict of equal-length int32
        tensors with the CARUS_TRACE_DTYPE fields.  Returns ``(vrf, vl,
        emvx_outs)``; the input ``vrf`` is not modified.

        ``vrf`` is one tile's ``[n_regs, reg_words]`` file with ``[n]``
        trace fields, or a wave ``[T, n_regs, reg_words]`` with ``[T, n]``
        fields; the results carry the same leading tile dimension."""
        cfg = self.cfg
        single = vrf.dim() == 2
        vrf = vrf.to(torch.int32).reshape(
            -1, cfg.n_regs, cfg.reg_words).clone()
        n_tiles, dev = vrf.shape[0], vrf.device
        vlmax = cfg.vlmax(sew)
        L = 32 // sew
        n_elems = cfg.reg_words * L
        f = {k: trace[k].to(device=dev, dtype=torch.int64)
             .reshape(n_tiles, -1) for k in isa.CARUS_TRACE_DTYPE.names}
        rows = torch.arange(n_tiles, device=dev)
        ids = torch.arange(n_elems, device=dev)[None]             # [1, E]
        vl = torch.full((n_tiles,), vlmax if vl0 is None else int(vl0),
                        dtype=torch.int64, device=dev)

        def elems(reg_words):
            return alu.unpack(reg_words, sew).reshape(n_tiles, n_elems) \
                .to(torch.int64)

        outs = []
        for i in range(f["op"].shape[1]):
            op, sval1, sval2 = f["op"][:, i], f["sval1"][:, i], f["sval2"][:, i]
            mode = f["mode"][:, i]
            indirect = (mode & isa.MODE_INDIRECT) != 0
            slide1 = ((mode & isa.MODE_SLIDE1) != 0)[:, None]
            opmode = mode & 0x3
            # Indirect register addressing: indices from sval2's LSBytes.
            # torch's % on integers is a floor mod, like the reference's.
            vd = torch.where(indirect, (sval2 >> 16) & 0xFF,
                             f["vd"][:, i]) % cfg.n_regs
            vs2 = torch.where(indirect, (sval2 >> 8) & 0xFF,
                              f["vs2"][:, i]) % cfg.n_regs
            vs1 = torch.where(indirect, sval2 & 0xFF,
                              f["vs1"][:, i]) % cfg.n_regs
            dst = elems(vrf[rows, vd])
            s2 = elems(vrf[rows, vs2])
            scalar_b = torch.where(opmode == isa.MODE_VI, f["imm"][:, i],
                                   sval1)
            # operand-1 elements: vs1 register (vv) or splat scalar/imm
            s1 = torch.where((opmode == isa.MODE_VV)[:, None],
                             elems(vrf[rows, vs1]), scalar_b[:, None])
            sv1 = sval1[:, None]

            # one candidate element row per writing opcode: the lane ops of
            # alu.lane_binop on untruncated int64 lanes (exact, no overflow
            # for int32 operands); pack truncates to SEW like the reference
            cand = [dst] * (_ID[VOp.EMVV] + 1)
            za, zb = alu._zext(s2, sew), alu._zext(s1, sew)
            sh = (s1 & alu._U32) % sew                  # RVV: mod SEW
            cand[_ID[VOp.VADD]] = s2 + s1
            cand[_ID[VOp.VSUB]] = s2 - s1
            cand[_ID[VOp.VMUL]] = s2 * s1
            cand[_ID[VOp.VMACC]] = dst + s2 * s1
            cand[_ID[VOp.VAND]] = s2 & s1
            cand[_ID[VOp.VOR]] = s2 | s1
            cand[_ID[VOp.VXOR]] = s2 ^ s1
            cand[_ID[VOp.VMIN]] = torch.minimum(s2, s1)
            cand[_ID[VOp.VMINU]] = torch.where(za <= zb, s2, s1)
            cand[_ID[VOp.VMAX]] = torch.maximum(s2, s1)
            cand[_ID[VOp.VMAXU]] = torch.where(za >= zb, s2, s1)
            cand[_ID[VOp.VSLL]] = (s2 & alu._U32) << sh
            cand[_ID[VOp.VSRL]] = za >> sh
            cand[_ID[VOp.VSRA]] = s2 >> sh
            cand[_ID[VOp.VMV]] = s1
            # slides gather from vs2 at ids -/+ offset, with the int32
            # wraparound of the reference's index arithmetic
            off = torch.where(slide1[:, 0], 1, scalar_b)[:, None]
            idx = _wrap32_i64(ids - off)
            up = torch.where(idx >= 0,
                             s2.gather(1, idx.clamp(0, n_elems - 1)), dst)
            cand[_ID[VOp.VSLIDEUP]] = torch.where(slide1 & (ids == 0),
                                                  sv1, up)
            idx = _wrap32_i64(ids + off)
            down = torch.where(idx < vl[:, None],
                               s2.gather(1, idx.clamp(0, n_elems - 1)), 0)
            cand[_ID[VOp.VSLIDEDOWN]] = torch.where(
                slide1 & (ids == vl[:, None] - 1), sv1, down)
            cand[_ID[VOp.EMVV]] = torch.where(
                ids == (sval2 % n_elems)[:, None], sv1, dst)
            sel_op = op.clamp(max=_ID[VOp.EMVV])[None, :, None] \
                .expand(1, n_tiles, n_elems)
            val = torch.stack(cand).gather(0, sel_op)[0]
            # VL-masked (tail-undisturbed) writeback; EMVV ignores VL and
            # EMVX / VSETVL / VNOP write nothing
            vl_eff = torch.where(op == _ID[VOp.EMVV], n_elems, vl)
            writes = (op <= _ID[VOp.EMVV])[:, None] & (ids < vl_eff[:, None])
            new = torch.where(writes, val, dst)
            vrf[rows, vd] = alu.pack(new.reshape(n_tiles, cfg.reg_words, L),
                                     sew)
            new_vl = torch.minimum(sval1, torch.tensor(vlmax, device=dev))
            emvx = s2.gather(1, (sval1 % n_elems)[:, None])[:, 0]
            outs.append(torch.where(op == _ID[VOp.EMVX], emvx,
                                    torch.where(op == _ID[VOp.VSETVL],
                                                new_vl, 0)))
            vl = torch.where(op == _ID[VOp.VSETVL], new_vl, vl)
        emvx_outs = (torch.stack(outs, dim=1) if outs else
                     torch.zeros((n_tiles, 0), dtype=torch.int64, device=dev))
        vl, emvx_outs = vl.to(torch.int32), emvx_outs.to(torch.int32)
        if single:
            return vrf[0], vl[0], emvx_outs[0]
        return vrf, vl, emvx_outs


def trace_to_arrays(entries: list[np.ndarray], device=None) -> dict:
    """Stack trace entries into the dict-of-tensors form run_trace expects."""
    arr = np.array([tuple(int(e[f]) for f in isa.CARUS_TRACE_DTYPE.names)
                    for e in entries], dtype=isa.CARUS_TRACE_DTYPE)
    return {name: torch.as_tensor(np.ascontiguousarray(arr[name]),
                                  device=device)
            for name in arr.dtype.names}
