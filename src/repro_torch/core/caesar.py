"""NM-Caesar functional model: 2-bank memory + multi-cycle packed-SIMD ALU.

NM-Caesar is micro-controlled by the host: each instruction arrives as a bus
write (see :func:`repro_torch.core.isa.caesar_encode`).  The engine here
executes a pre-assembled instruction *stream* — exactly what the system DMA
engine would replay from main memory.

State: a flat 8192-word memory (2 x 16 KiB single-port banks; bank = high
address bit), a packed MAC accumulator word, and a 32-bit DOT accumulator.
SEW is static per stream (the CSRW configuration instruction is modeled as a
stream boundary, matching how the paper's kernels configure the width once).

:meth:`CaesarEngine.run_stream` is the **plain PyTorch version** of the
``caesar_wave`` CUDA kernel (``repro_torch/csrc/caesar_wave.cu``): a Python
loop over instructions, batched over tiles.  The tiles of one wave run
different opcodes at the same step, so every step computes each candidate
result and selects per tile; nothing syncs with the host inside the loop,
so the same code runs on the card as the kernel's yardstick.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import alu
from repro_torch.core import constants as C
from repro_torch.core import isa
from repro_torch.core.isa import CaesarOp


@dataclasses.dataclass(frozen=True)
class CaesarConfig:
    mem_words: int = C.CAESAR_MEM_BYTES // C.WORD_BYTES  # 8192
    n_banks: int = C.CAESAR_N_BANKS

    @property
    def bank_words(self) -> int:
        return self.mem_words // self.n_banks

    def bank_of(self, word_addr):
        return word_addr // self.bank_words


_BINOP_OF = {
    CaesarOp.AND: "and", CaesarOp.OR: "or", CaesarOp.XOR: "xor",
    CaesarOp.ADD: "add", CaesarOp.SUB: "sub", CaesarOp.MUL: "mul",
    CaesarOp.SLL: "sll", CaesarOp.SLR: "srl", CaesarOp.SRA: "sra",
    CaesarOp.MIN: "min", CaesarOp.MAX: "max",
}
_STORE_IDS = sorted(int(o) for o in isa.CAESAR_STORE_OPS)


def stream_to_arrays(entries: list[tuple[CaesarOp, int, int, int]],
                     device=None) -> dict:
    arr = np.array([(int(op), d, s1, s2) for op, d, s1, s2 in entries],
                   dtype=isa.CAESAR_TRACE_DTYPE)
    return {n: torch.as_tensor(np.ascontiguousarray(arr[n]), device=device)
            for n in arr.dtype.names}


class CaesarEngine:
    def __init__(self, config: CaesarConfig | None = None):
        self.cfg = config or CaesarConfig()

    def run_stream(self, mem: torch.Tensor, stream: dict, sew: int):
        """Execute an instruction stream.  Returns ``(mem, mac_acc,
        dot_acc)``; the input ``mem`` is not modified.

        ``mem`` is one tile's int32 ``[mem_words]`` image with ``[n]``
        stream fields, or a wave ``[T, mem_words]`` with ``[T, n]`` fields;
        the results carry the same leading tile dimension."""
        single = mem.dim() == 1
        mem = mem.to(torch.int32).reshape(-1, self.cfg.mem_words).clone()
        n_tiles, dev = mem.shape[0], mem.device
        f = {k: stream[k].to(device=dev, dtype=torch.int64)
             .reshape(n_tiles, -1) for k in ("op", "dest", "src1", "src2")}
        rows = torch.arange(n_tiles, device=dev)
        writes_tab = torch.zeros(len(CaesarOp), dtype=torch.bool, device=dev)
        writes_tab[_STORE_IDS] = True
        mac = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
        dot = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
        for i in range(f["op"].shape[1]):
            op, dest = f["op"][:, i], f["dest"][:, i]
            a = mem[rows, f["src1"][:, i]]
            b = mem[rows, f["src2"][:, i]]
            al = alu.unpack(a, sew).to(torch.int64)         # [T, L]
            bl = alu.unpack(b, sew).to(torch.int64)
            sh = (bl & alu._U32) % sew                      # RVV: mod SEW
            prod = al * bl
            mac_base = torch.where((op == CaesarOp.MAC_INIT)[:, None], 0,
                                   alu.unpack(mac, sew).to(torch.int64))
            # every lane-level candidate, packed (truncated to SEW) at once
            (add, sub, mul, sll, srl, sra, mn, mx, mac_new) = alu.pack(
                torch.stack([al + bl, al - bl, prod, (al & alu._U32) << sh,
                             alu._zext(al, sew) >> sh, al >> sh,
                             torch.minimum(al, bl), torch.maximum(al, bl),
                             mac_base + prod]), sew)
            is_mac = (op >= CaesarOp.MAC_INIT) & (op <= CaesarOp.MAC_STORE)
            mac = torch.where(is_mac, mac_new, mac)
            dot_base = torch.where(op == CaesarOp.DOT_INIT, 0,
                                   dot.to(torch.int64))
            dot_new = alu._wrap32(dot_base + (prod & alu._U32).sum(-1))
            is_dot = (op >= CaesarOp.DOT_INIT) & (op <= CaesarOp.DOT_STORE)
            dot = torch.where(is_dot, dot_new, dot)
            # one candidate word per opcode (CaesarOp order), chosen per tile
            val = torch.stack([
                a & b, a | b, a ^ b, add, sub, mul,       # AND .. MUL
                a, a, mac,                                # MAC_INIT .. STORE
                a, a, dot,                                # DOT_INIT .. STORE
                sll, srl, mn, mx, a, sra, a,              # SLL .. NOP
            ]).gather(0, op[None])[0]
            mem[rows, dest] = torch.where(writes_tab[op], val,
                                          mem[rows, dest])
        if single:
            return mem[0], mac[0], dot[0]
        return mem, mac, dot
