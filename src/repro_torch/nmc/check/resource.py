"""Resource pass: capacity + cost-model cross-checks.

Allocator high-water vs engine capacity, plus an independent
bank-conflict / instruction count estimate cross-checked against
:mod:`repro_torch.core.timing` — drift between the verifier's and the cost
model's view of a program is itself an error.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import constants as C
from repro_torch.nmc.program import Program

from repro_torch.nmc.check.report import _Ctx
from repro_torch.nmc.check.structural import (_CAESAR_BANK_WORDS,
                                        _CAESAR_MEM_WORDS, _CARUS_N_REGS,
                                        _CARUS_REG_WORDS, _NOP_C, _columns)


def check_resource(prog: Program, ctx: _Ctx) -> None:
    from repro_torch.core import timing
    cap = _CAESAR_MEM_WORDS if prog.engine == "caesar" \
        else _CARUS_N_REGS * _CARUS_REG_WORDS
    if ctx.used_words:
        if ctx.used_words > cap:
            ctx.emit("error", "resource", "capacity",
                     f"allocator high-water {ctx.used_words} words exceeds "
                     f"the {cap}-word tile capacity")
        else:
            ctx.emit("info", "resource", "mem-highwater",
                     f"{ctx.used_words}/{cap} words "
                     f"({100.0 * ctx.used_words / cap:.1f}%) of tile "
                     f"memory occupied")
    try:
        report = timing.program_cycles(prog)
    except Exception as exc:  # corrupted stream: the cost model rejects it
        ctx.emit("error", "resource", "timing-drift",
                 f"timing.program_cycles rejects the program outright "
                 f"({type(exc).__name__}: {exc})")
        return
    n_real = prog.n_instr - prog.n_nops
    if report.n_instrs != n_real:
        ctx.emit("error", "resource", "timing-drift",
                 f"timing model costs {report.n_instrs} instructions, the "
                 f"verifier counts {n_real} non-NOP entries — the cost "
                 f"model and the IR disagree")
    if prog.engine == "caesar":
        m = _columns(prog.entries)
        real = m[:, 0] != _NOP_C
        same = int(np.count_nonzero(
            real & (m[:, 2] // _CAESAR_BANK_WORDS
                    == m[:, 3] // _CAESAR_BANK_WORDS)))
        modeled = report.detail.get("same_bank_ops")
        if modeled != same:
            ctx.emit("error", "resource", "timing-drift",
                     f"static bank-conflict estimate ({same} same-bank "
                     f"ops) disagrees with timing.program_cycles "
                     f"({modeled})")
        elif same:
            ctx.emit("info", "resource", "bank-conflicts",
                     f"{same}/{n_real} ops fetch both operands from one "
                     f"bank (+{C.CAESAR_SAME_BANK_CYCLES - C.CAESAR_CYCLES_PER_OP} "
                     f"cycle each, Section III-A2)")
