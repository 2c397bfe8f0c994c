"""Dataflow pass: event-sorted def-use analysis over one program.

Read-before-write against the image-defined spans, MAC/DOT accumulator
chains (use-before-init, never-stored), dead writes (overwritten or
never read), in-place VMACC hazards on Carus, and store coverage (every
word of ``out_slice`` written or image-defined).

The def/use event machinery here (one sorted int64 key stream per
verification) is also the substrate of the IR optimizer
(:mod:`repro_torch.nmc.opt`): the same events that *diagnose* a dead write are
what licenses its removal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.isa import CaesarOp
from repro_torch.nmc.program import Program

from repro_torch.nmc.check.report import MAX_PER_RULE, _Ctx, _defined_words
from repro_torch.nmc.check.structural import (_CAESAR_MEM_WORDS, _CARUS_N_REGS,
                                        _CARUS_REG_WORDS, _caesar_code,
                                        _carus_operands, _columns)


def _event_analysis(ctx: _Ctx, capacity: int, unit: str,
                    r_loc: np.ndarray, r_row: np.ndarray,
                    w_loc: np.ndarray, w_row: np.ndarray,
                    out_range: Optional[Tuple[int, int]],
                    acc_read_rows: Optional[np.ndarray] = None) -> None:
    """Shared def-use core for both engines: sort (location, row, kind)
    events — reads before writes at the same instruction, so an in-place
    update reads its old value first — then flag reads whose location's
    first event is that read (read-before-write, against the image-defined
    map), writes whose next same-location event is another write
    (dead-write / WAW), final writes that fall outside the output window,
    and output words never written nor image-defined."""
    defined = _defined_words(ctx, capacity)
    nr, nw = len(r_loc), len(w_loc)
    if nr + nw:
        # pack each event into one int64 key (loc, then row, then
        # read<write) and sort it IN PLACE — row and kind are recovered by
        # decoding the key, so no permutation array, no gathers, and no
        # 3-key lexsort on the <5% lowering-overhead hot path
        mr = int(r_row.max()) if nr else 0
        mw = int(w_row.max()) if nw else 0
        # power-of-two span: decode is a shift/mask, not an int division
        # (arithmetic right shift floors, so negative garbage locs from
        # corrupted programs still decode and sort consistently)
        shift = (2 * max(mr, mw) + 1).bit_length()
        key = np.empty(nr + nw, np.int64)
        key[:nr] = (r_loc << shift) + 2 * r_row
        key[nr:] = (w_loc << shift) + 2 * w_row + 1
        key.sort()
        loc = key >> shift
        kind = key & 1
    else:
        loc = kind = np.zeros(0, np.int64)
        shift = 1

    def row_at(p: int) -> int:
        # rows only matter at finding positions — decode lazily per hit
        return (int(key[p]) & ((1 << shift) - 1)) >> 1

    first = np.empty(len(loc), bool)
    if len(loc):
        first[0] = True
        first[1:] = loc[1:] != loc[:-1]

    if defined is not None and len(loc):
        cand = np.flatnonzero(first & (kind == 0))
        pos = cand[~defined[np.clip(loc[cand], 0, capacity - 1)]]
        acc_rows = set() if acc_read_rows is None else set(
            int(r) for r in acc_read_rows)
        for p in pos[:MAX_PER_RULE]:
            extra = (" (in-place VMACC accumulator)"
                     if row_at(p) in acc_rows else "")
            ctx.emit("error", "dataflow", "read-before-write",
                     f"reads {unit} {int(loc[p])} before any write "
                     f"(not image-defined either){extra}",
                     instr=row_at(p))
        if len(pos) > MAX_PER_RULE:
            ctx.emit("error", "dataflow", "read-before-write",
                     f"... and {len(pos) - MAX_PER_RULE} more "
                     f"'read-before-write' findings")

    if len(loc):
        nxt_same = np.empty(len(loc), bool)
        nxt_same[-1] = False
        nxt_same[:-1] = loc[1:] == loc[:-1]
        waw = np.zeros(len(loc), bool)
        waw[:-1] = (kind[:-1] == 1) & nxt_same[:-1] & (kind[1:] == 1)
        pos = np.flatnonzero(waw)
        for p in pos[:MAX_PER_RULE]:
            ctx.emit("warning", "dataflow", "dead-write",
                     f"{unit} {int(loc[p])} is overwritten at "
                     f"instr#{row_at(p + 1)} before any read",
                     instr=row_at(p))
        if len(pos) > MAX_PER_RULE:
            ctx.emit("warning", "dataflow", "dead-write",
                     f"... and {len(pos) - MAX_PER_RULE} more "
                     f"'dead-write' findings")
        if out_range is not None:
            lo, hi = out_range
            final = (kind == 1) & ~nxt_same
            dead_final = final & ((loc < lo) | (loc >= hi))
            pos = np.flatnonzero(dead_final)
            for p in pos[:MAX_PER_RULE]:
                ctx.emit("warning", "dataflow", "dead-write",
                         f"{unit} {int(loc[p])} is written, never read, "
                         f"and outside the output window [{lo}, {hi})",
                         instr=row_at(p))
            if len(pos) > MAX_PER_RULE:
                ctx.emit("warning", "dataflow", "dead-write",
                         f"... and {len(pos) - MAX_PER_RULE} more "
                         f"'dead-write' findings")

    # store coverage: every output location written or image-defined
    if out_range is not None and defined is not None:
        lo, hi = out_range
        covered = defined.copy()
        if len(w_loc):
            covered[np.clip(w_loc, 0, capacity - 1)] = True
        missing = np.flatnonzero(~covered[lo:hi]) + lo
        for m in missing[:MAX_PER_RULE]:
            ctx.emit("error", "dataflow", "uncovered-store",
                     f"output {unit} {int(m)} is never written and not "
                     f"image-defined — the extracted result would be "
                     f"uninitialized zeros")
        if len(missing) > MAX_PER_RULE:
            ctx.emit("error", "dataflow", "uncovered-store",
                     f"... and {len(missing) - MAX_PER_RULE} more "
                     f"uncovered output {unit}s")


def _chain_check(ctx: _Ctx, op: np.ndarray, init_id: int, body_id: int,
                 store_id: int, label: str) -> None:
    """Accumulator-chain protocol (MAC_INIT/MAC/MAC_STORE and the DOT
    triple): body/store ops require a live chain; INIT while live (and a
    chain that never stores) are dead accumulations."""
    chain = (op == init_id) | (op == body_id) | (op == store_id)
    if not chain.any():
        return
    rows = np.flatnonzero(chain)
    kinds = op[rows]
    t = np.where(kinds == init_id, 1, np.where(kinds == store_id, -1, 0))
    nz = np.flatnonzero(t != 0)
    last = np.full(len(rows), -1)
    if len(nz):
        marks = np.full(len(rows), -1)
        marks[nz] = nz
        last = np.maximum.accumulate(marks)
    prev = np.concatenate([[-1], last[:-1]])
    live_before = (prev >= 0) & (t[np.clip(prev, 0, None)] == 1)
    use_dead = ((kinds == body_id) | (kinds == store_id)) & ~live_before
    ctx.emit_rows(
        "error", "dataflow", "acc-use-before-init",
        rows[np.flatnonzero(use_dead)],
        lambda i: f"{label} accumulator used with no live "
        f"{label}_INIT chain")
    reinit = (kinds == init_id) & live_before
    ctx.emit_rows(
        "warning", "dataflow", "dead-accumulator",
        rows[np.flatnonzero(reinit)],
        lambda i: f"{label}_INIT while the previous chain was never "
        f"stored — the pending accumulation is dead")
    if last[-1] >= 0 and t[last[-1]] == 1:
        ctx.emit("warning", "dataflow", "dead-accumulator",
                 f"{label} chain never reaches {label}_STORE — the "
                 f"accumulation is dead", instr=int(rows[last[-1]]))


def _dataflow_caesar(prog: Program, ctx: _Ctx) -> None:
    m = _columns(prog.entries)
    op = m[:, 0]
    code = _caesar_code(ctx, op)
    ridx = np.flatnonzero(code & 1)
    widx = np.flatnonzero(code & 2)
    r_loc = m[ridx, 2:4].T.reshape(-1)          # src1 then src2 reads
    r_row = np.concatenate([ridx, ridx])
    out = None
    if ctx.out_slice is not None:
        out = (int(ctx.out_slice[0]), int(ctx.out_slice[0])
               + int(ctx.out_slice[1]))
    _event_analysis(ctx, _CAESAR_MEM_WORDS, "word",
                    r_loc.astype(np.int64), r_row,
                    m[widx, 1].astype(np.int64), widx, out)
    if (code & 8).any():                        # any MAC/DOT chain ops
        _chain_check(ctx, op, int(CaesarOp.MAC_INIT), int(CaesarOp.MAC),
                     int(CaesarOp.MAC_STORE), "MAC")
        _chain_check(ctx, op, int(CaesarOp.DOT_INIT), int(CaesarOp.DOT),
                     int(CaesarOp.DOT_STORE), "DOT")


def _dataflow_carus(prog: Program, ctx: _Ctx) -> None:
    e = prog.entries
    rows = np.arange(len(e))
    (vd, vs2, vs1), (_, reads_vd, uses_vs2, uses_vs1, writes_vd) = \
        _carus_operands(ctx, e)
    # match the engine's wrap so the dataflow stays well-indexed even when
    # the structural pass already flagged an out-of-range register
    vd, vs2, vs1 = (vd % _CARUS_N_REGS, vs2 % _CARUS_N_REGS,
                    vs1 % _CARUS_N_REGS)
    r_loc = np.concatenate([vs2[uses_vs2], vs1[uses_vs1], vd[reads_vd]])
    r_row = np.concatenate([rows[uses_vs2], rows[uses_vs1], rows[reads_vd]])
    out = None
    if ctx.out_slice is not None:
        lo, nw = int(ctx.out_slice[0]), int(ctx.out_slice[1])
        out = (lo // _CARUS_REG_WORDS,
               -(-(lo + nw) // _CARUS_REG_WORDS))
    # register-granular init map: a load/cpool block defines its registers
    reg_ctx = ctx
    if ctx.init_spans is not None:
        reg_spans = [(s // _CARUS_REG_WORDS,
                      -(-(s + n) // _CARUS_REG_WORDS) - s // _CARUS_REG_WORDS)
                     for s, n in ctx.init_spans]
        reg_ctx = dataclasses.replace(ctx, init_spans=reg_spans)
    _event_analysis(reg_ctx, _CARUS_N_REGS, "register",
                    r_loc.astype(np.int64), r_row,
                    vd[writes_vd].astype(np.int64), rows[writes_vd], out,
                    acc_read_rows=rows[reads_vd])


def check_dataflow(prog: Program, ctx: _Ctx) -> None:
    if prog.engine == "caesar":
        _dataflow_caesar(prog, ctx)
    else:
        _dataflow_carus(prog, ctx)
