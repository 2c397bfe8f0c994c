"""Rewrite rules over the unified IR, driven by the check package's
analyses (DESIGN.md §13).

Every rule takes a mutable :class:`Work` (entries + image + lowering
metadata) and either returns rewrite stats after mutating it, or ``None``
when it has nothing to do.  Rules only *propose* cheaper programs — the
driver (:func:`repro_torch.nmc.opt.optimize`) translation-validates each
applied rewrite before it is allowed to survive.

All rules are value-independent: they look at the instruction stream, the
span metadata and structurally-zero image words, never at live operand
values — so an optimized layout is stable across calls (the residency
contract of ``serve/block.py`` depends on this).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import constants as C
from repro_torch.core import isa
from repro_torch.core.isa import CaesarOp
from repro_torch.nmc.program import NOP_OP_ID

from repro_torch.nmc.check.structural import (_C_CODE, _CAESAR_BANK_WORDS,
                                        _CAESAR_MEM_WORDS, _CARUS_N_REGS,
                                        _CARUS_REG_WORDS, _LUT_N, _K_ARITH,
                                        _K_MACC, _K_MV, _K_SETVL, _K_SLIDES,
                                        _carus_regs, _carus_uses, _columns,
                                        _member)

_K_VMV = _K_MV
_MODE_COPY = isa.MODE_VV | isa.MODE_INDIRECT


@dataclasses.dataclass
class Work:
    """Mutable working copy of a lowering under optimization."""

    engine: str
    sew: int
    entries: np.ndarray                 # PROG_DTYPE rows
    mem: np.ndarray                     # flat int32 image (mutated in place)
    out_slice: Tuple[int, int]
    init_spans: List[Tuple[int, int]]
    cpool_spans: Tuple[Tuple[int, int], ...]
    used_words: int
    prov: Optional[np.ndarray]

    def drop_rows(self, keep: np.ndarray) -> None:
        self.entries = self.entries[keep]
        if self.prov is not None:
            self.prov = self.prov[keep]


def _code_of(op: np.ndarray) -> np.ndarray:
    code = _C_CODE[np.clip(op, 0, _LUT_N - 1)].copy()
    code[(op < 0) | (op >= _LUT_N)] = 0
    return code


# ---------------------------------------------------------------------------
# R1 — dead-write elimination + store-cone trimming
# ---------------------------------------------------------------------------

_CHAINS = ((int(CaesarOp.MAC_INIT), int(CaesarOp.MAC),
            int(CaesarOp.MAC_STORE)),
           (int(CaesarOp.DOT_INIT), int(CaesarOp.DOT),
            int(CaesarOp.DOT_STORE)))


def _dead_write_rows_caesar(m: np.ndarray, code: np.ndarray,
                            out: Tuple[int, int]) -> np.ndarray:
    """Per-row dead-write flag via the dataflow pass's event sort: a write
    is dead when the next same-location event is another write, or when it
    is the last event and the location falls outside the output window."""
    n = len(m)
    ridx = np.flatnonzero(code & 1)
    widx = np.flatnonzero(code & 2)
    dead_row = np.zeros(n, bool)
    if not len(widx):
        return dead_row
    r_loc = m[ridx, 2:4].T.reshape(-1).astype(np.int64)
    r_row = np.concatenate([ridx, ridx])
    w_loc = m[widx, 1].astype(np.int64)
    shift = (2 * max(n, 1) + 1).bit_length()
    key = np.empty(2 * len(ridx) + len(widx), np.int64)
    key[:2 * len(ridx)] = (r_loc << shift) + 2 * r_row
    key[2 * len(ridx):] = (w_loc << shift) + 2 * widx + 1
    key.sort()
    loc = key >> shift
    row = (key & ((1 << shift) - 1)) >> 1
    kind = key & 1
    nxt_same = np.zeros(len(key), bool)
    nxt_same[:-1] = loc[1:] == loc[:-1]
    nxt_write = np.zeros(len(key), bool)
    nxt_write[:-1] = kind[1:] == 1
    lo, hi = out
    dead_ev = (kind == 1) & np.where(
        nxt_same, nxt_write, (loc < lo) | (loc >= hi))
    dead_row[row[dead_ev]] = True
    return dead_row


def dead_write_elim(w: Work) -> Optional[dict]:
    """Remove stores no later instruction (or the output window) observes,
    and whole MAC/DOT chain segments whose every store is dead — the
    store-cone trim.  Runs to fixpoint: a removed store frees its source
    reads, which may expose further dead cones."""
    if w.engine != "caesar":
        return _dead_write_elim_carus(w)
    lo = int(w.out_slice[0])
    out = (lo, lo + int(w.out_slice[1]))
    removed = 0
    while True:
        e = w.entries
        m = _columns(e)
        op = m[:, 0]
        code = _code_of(op)
        dead_row = _dead_write_rows_caesar(m, code, out)
        # pure binop stores drop individually ...
        removable = dead_row & ((code & 2) != 0) & ((code & 8) == 0)
        # ... chain segments (INIT .. next INIT) only as a unit, when every
        # store of the segment is dead — partial removal would change the
        # accumulator for the surviving stores
        for init_id, body_id, store_id in _CHAINS:
            member = (op == init_id) | (op == body_id) | (op == store_id)
            rows = np.flatnonzero(member)
            if not len(rows):
                continue
            starts = np.flatnonzero(op[rows] == init_id)
            for si, s0 in enumerate(starts):
                s1 = starts[si + 1] if si + 1 < len(starts) else len(rows)
                seg = rows[s0:s1]
                stores = seg[op[seg] == store_id]
                if not len(stores) or dead_row[stores].all():
                    removable[seg] = True
        if not removable.any():
            break
        removed += int(removable.sum())
        w.drop_rows(~removable)
    return {"removed": removed} if removed else None


def _dead_write_elim_carus(w: Work) -> Optional[dict]:
    """Carus dead-final elimination at register granularity: an op whose
    written register is never touched again and lies outside the output
    registers is unobservable.  (WAW kills are left alone: tail-undisturbed
    writeback makes every write also a partial read of its destination.)"""
    removed = 0
    out_regs = -(-(int(w.out_slice[0]) + int(w.out_slice[1]))
                 // _CARUS_REG_WORDS)
    while True:
        e = w.entries
        (vd, vs2, vs1), (_, reads_vd, uses_vs2, uses_vs1, writes_vd) = \
            _carus_regs(e), _carus_uses(e)
        vd = vd % _CARUS_N_REGS
        vs2 = vs2 % _CARUS_N_REGS
        vs1 = vs1 % _CARUS_N_REGS
        n = len(e)
        last_event = np.full(_CARUS_N_REGS, -1)
        for regs, used in ((vs2, uses_vs2), (vs1, uses_vs1),
                           (vd, reads_vd | writes_vd)):
            rr = np.flatnonzero(used)
            if len(rr):
                np.maximum.at(last_event, regs[rr], rr)
        cand = writes_vd & ~reads_vd & (vd >= out_regs)
        removable = cand & (last_event[vd] == np.arange(n))
        if not removable.any():
            break
        removed += int(removable.sum())
        w.drop_rows(~removable)
    return {"removed": removed} if removed else None


# ---------------------------------------------------------------------------
# R2 — NOP / padding compaction
# ---------------------------------------------------------------------------

def nop_compact(w: Work) -> Optional[dict]:
    """Strip neutral NOP rows: zero modeled cycles either way, but fewer
    entries drop the kernel into a smaller instruction bucket (fewer
    scan/fori_loop steps and possibly one less XLA compile shape)."""
    m = _columns(w.entries)
    neutral = (m[:, 0] == NOP_OP_ID[w.engine]) & ~m[:, 1:].any(axis=1)
    if not neutral.any():
        return None
    w.drop_rows(~neutral)
    return {"removed": int(neutral.sum())}


# ---------------------------------------------------------------------------
# R3 — VSETVL canonicalization (carus)
# ---------------------------------------------------------------------------

def vsetvl_dedup(w: Work) -> Optional[dict]:
    """Remove VSETVLs that re-request the live VL (the engine clamps to
    ``min(sval1, vlmax)``; initial VL is VLMAX) or whose VL no following
    VL-sensitive op observes before the next VSETVL rewrites it."""
    if w.engine != "carus":
        return None
    e = w.entries
    op = e["op"]
    setvls = np.flatnonzero(op == _K_SETVL)
    if not len(setvls):
        return None
    vlmax = _CARUS_REG_WORDS * (32 // w.sew)
    sensitive = (_member(op, _K_ARITH) | (op == _K_MACC) | (op == _K_MV)
                 | _member(op, _K_SLIDES))
    remove = np.zeros(len(e), bool)
    cur = vlmax
    for j, i in enumerate(setvls):
        eff = min(int(e["sval1"][i]), vlmax)
        nxt = setvls[j + 1] if j + 1 < len(setvls) else len(e)
        if eff == cur or not sensitive[i + 1:nxt].any():
            remove[i] = True            # cur unchanged: VL is unobserved
        else:
            cur = eff
    if not remove.any():
        return None
    w.drop_rows(~remove)
    return {"removed": int(remove.sum())}


# ---------------------------------------------------------------------------
# R4 — bank-conflict-aware span placement (caesar)
# ---------------------------------------------------------------------------

def _first_fit(free: np.ndarray, n: int) -> Optional[int]:
    run = 0
    for i, f in enumerate(free):
        run = run + 1 if f else 0
        if run == n:
            return i - n + 1
    return None


def rebank(w: Work) -> Optional[dict]:
    """Move read-only image spans across the bank boundary when doing so
    reduces the same-bank operand-fetch count (every same-bank op pays
    +1 cycle on the single-port banks, Section III-A2).  Only spans that
    are never written, never patched (cpool) and outside the output
    window move; every instruction reference is remapped in place."""
    if w.engine != "caesar":
        return None
    e = w.entries
    m = _columns(e)
    op = m[:, 0]
    code = _code_of(op)
    real = np.flatnonzero(code & 1)     # operand-fetching rows
    if not len(real):
        return None
    wdest = m[np.flatnonzero(code & 2), 1]
    lo, hi = int(w.out_slice[0]), int(w.out_slice[0]) + int(w.out_slice[1])
    occupied = np.zeros(_CAESAR_MEM_WORDS, bool)
    for s, n in w.init_spans:
        occupied[int(s):int(s) + int(n)] = True
    occupied[lo:hi] = True
    occupied[m[:, 1]] = True            # every referenced word stays fixed
    occupied[m[:, 2]] = True
    occupied[m[:, 3]] = True
    cpools = {(int(s), int(n)) for s, n in w.cpool_spans}
    bw = _CAESAR_BANK_WORDS
    moved_refs = 0
    moved_spans = 0
    for si, (s, n) in enumerate(list(w.init_spans)):
        s, n = int(s), int(n)
        if (s, n) in cpools or n == 0:
            continue
        if s // bw != (s + n - 1) // bw:
            continue                    # bank-straddling span: leave it
        if s < hi and lo < s + n:
            continue                    # overlaps the output window
        if len(wdest) and np.any((wdest >= s) & (wdest < s + n)):
            continue                    # written: not a read-only span
        src1 = e["src1"][real].astype(np.int64)
        src2 = e["src2"][real].astype(np.int64)
        in1 = (src1 >= s) & (src1 < s + n)
        in2 = (src2 >= s) & (src2 < s + n)
        touched = in1 ^ in2             # both-in-span rows never change
        if not touched.any():
            continue
        cur_bank = s // bw
        other = np.where(in1[touched], src2[touched], src1[touched]) // bw
        before = int(np.count_nonzero(other == cur_bank))
        after = int(np.count_nonzero(other == 1 - cur_bank))
        if after >= before:
            continue                    # no same-bank cycles to win
        tb = 1 - cur_bank
        fit = _first_fit(~occupied[tb * bw:(tb + 1) * bw], n)
        if fit is None:
            continue
        new_s = tb * bw + fit
        delta = new_s - s
        for field, mask in (("src1", in1), ("src2", in2)):
            col = e[field][real]
            col[mask] += delta
            e[field][real] = col
        w.mem[new_s:new_s + n] = w.mem[s:s + n]
        w.mem[s:s + n] = 0
        occupied[s:s + n] = False
        occupied[new_s:new_s + n] = True
        w.init_spans[si] = (new_s, n)
        moved_refs += int(touched.sum())
        moved_spans += 1
    if not moved_spans:
        return None
    # allocator high-water from the post-move occupancy (drives the DMA-in
    # leg of the bus model)
    b0 = np.flatnonzero(occupied[:bw])
    b1 = np.flatnonzero(occupied[bw:])
    w.used_words = (int(b0[-1]) + 1 if len(b0) else 0) \
        + (int(b1[-1]) + 1 if len(b1) else 0)
    return {"moved": moved_refs, "spans": moved_spans}


# ---------------------------------------------------------------------------
# R5 — copy propagation / register coalescing (carus)
# ---------------------------------------------------------------------------

def copy_coalesce(w: Work) -> Optional[dict]:
    """Delete VMV block copies by loading the source image directly at the
    destination registers.  Fires on the lowering's accumulator-copy
    pattern (a loaded accumulator VMV'd into the output block before
    VMACC): when the copied registers are defined by exactly one image
    span, read by nothing but the copies, and the destination block is
    untouched before them, the copy is pure data movement."""
    if w.engine != "carus":
        return None
    removed = 0
    rw = _CARUS_REG_WORDS
    L = 32 // w.sew
    vlmax = rw * L
    while True:
        group = _find_coalescable(w, rw, L, vlmax)
        if group is None:
            break
        rows, d, s, k, span_idx = group
        ws, wn = w.init_spans[span_idx]
        off = ws - s * rw
        new_ws = d * rw + off
        w.mem[new_ws:new_ws + wn] = w.mem[ws:ws + wn]
        w.mem[ws:ws + wn] = 0
        w.init_spans[span_idx] = (new_ws, wn)
        keep = np.ones(len(w.entries), bool)
        keep[rows] = False
        w.drop_rows(keep)
        removed += len(rows)
    return {"removed": removed} if removed else None


def _find_coalescable(w: Work, rw: int, L: int, vlmax: int):
    from repro_torch.core import alu
    e = w.entries
    n = len(e)
    (vd, vs2, vs1), (_, reads_vd, uses_vs2, uses_vs1, writes_vd) = \
        _carus_regs(e), _carus_uses(e)
    vd, vs2, vs1 = (vd % _CARUS_N_REGS, vs2 % _CARUS_N_REGS,
                    vs1 % _CARUS_N_REGS)
    is_copy = (e["op"] == _K_VMV) & (e["mode"] == _MODE_COPY) & (vs2 == 0)
    copies = np.flatnonzero(is_copy)
    if not len(copies):
        return None
    # live VL at each row (initial VL is VLMAX, VSETVL clamps)
    vl_at = np.full(n, vlmax)
    cur = vlmax
    svl = e["sval1"]
    ops = e["op"]
    for i in range(n):
        vl_at[i] = cur
        if ops[i] == _K_SETVL:
            cur = min(int(svl[i]), vlmax)
    # maximal consecutive runs: rows r..r+k-1 copying s+i -> d+i
    g0 = 0
    groups = []
    for j in range(1, len(copies) + 1):
        if j < len(copies) and copies[j] == copies[j - 1] + 1 \
                and vd[copies[j]] == vd[copies[g0]] + (j - g0) \
                and vs1[copies[j]] == vs1[copies[g0]] + (j - g0):
            continue
        groups.append((copies[g0:j], int(vd[copies[g0]]),
                       int(vs1[copies[g0]])))
        g0 = j
    for rows, d, s in groups:
        k = len(rows)
        in_group = np.zeros(n, bool)
        in_group[rows] = True
        src_hit = np.zeros(n, bool)
        dst_hit = np.zeros(n, bool)
        for regs, used in ((vs2, uses_vs2), (vs1, uses_vs1),
                           (vd, reads_vd | writes_vd)):
            src_hit |= used & (regs >= s) & (regs < s + k)
            dst_hit |= used & (regs >= d) & (regs < d + k)
        if (src_hit & ~in_group).any():
            continue                    # source block read/written elsewhere
        if dst_hit[:rows[0]].any():
            continue                    # destination live before the copy
        spans = [(i, int(ws), int(wn))
                 for i, (ws, wn) in enumerate(w.init_spans)
                 if ws < (s + k) * rw and s * rw < ws + wn]
        if len(spans) != 1:
            continue
        span_idx, ws, wn = spans[0]
        if ws < s * rw or ws + wn > (s + k) * rw:
            continue                    # span leaks outside the block
        if any(ws2 < (d + k) * rw and d * rw < ws2 + wn2
               for ws2, wn2 in w.init_spans):
            continue                    # destination block is image-defined
        if w.mem[d * rw:(d + k) * rw].any():
            continue                    # non-zero destination image words
        # tail safety: elements at/after the copy's VL must be zero in the
        # source image, since the coalesced load skips the tail-undisturbed
        # (zero-preserving) writeback the VMV performed
        vl = int(vl_at[rows[0]])
        ok = True
        for i in range(k):
            lanes = alu.unpack_lanes_np(
                w.mem[(s + i) * rw:(s + i + 1) * rw], w.sew).reshape(-1)
            if lanes[vl:].any():
                ok = False
                break
        if ok:
            return rows, d, s, k, span_idx
    return None


#: Rule pipeline per engine, in application order (each entry:
#: (stable rule name, callable)).
PIPELINE = {
    "caesar": (("dead-write-elim", dead_write_elim),
               ("nop-compact", nop_compact),
               ("rebank", rebank)),
    "carus": (("dead-write-elim", dead_write_elim),
              ("copy-coalesce", copy_coalesce),
              ("vsetvl-dedup", vsetvl_dedup),
              ("nop-compact", nop_compact)),
}
