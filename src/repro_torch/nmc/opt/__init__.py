"""Analysis-driven IR optimizer with per-rewrite translation validation
(DESIGN.md §13).

The check package (:mod:`repro_torch.nmc.check`) computes exact dataflow facts
about every lowered program — dead writes, def/use event streams,
accumulator chains, bank-conflict recounts.  This package turns those
same analyses into rewrites over the unified IR:

* **dead-write elimination + store-cone trimming** — stores (and whole
  MAC/DOT accumulation cones) that no later instruction or output word
  observes are removed, to fixpoint;
* **NOP/padding compaction + stream canonicalization** — neutral NOPs
  and redundant VSETVLs are stripped, so kernels drop into smaller
  instruction buckets (fewer scan steps, fewer XLA compile shapes);
* **bank-conflict-aware placement (Caesar)** — read-only image spans
  migrate across the bank boundary when that reduces same-bank operand
  fetches (each costs +1 cycle on the single-port banks);
* **copy propagation / register coalescing (Carus)** — VMV block copies
  of image-defined registers are deleted by loading the image directly
  at the destination registers.

Every applied rewrite is **translation-validated**
(:mod:`repro_torch.nmc.opt.validate`): the full static pass pipeline re-runs
over the rewritten program and a numpy oracle differential must
reproduce the output window bit-exactly — :class:`OptError` otherwise.
The structured :class:`OptReport` (rule, instructions removed/moved,
modeled cycles before/after) is attached to the lowering as
``lk.opt_report``.

Wired end to end as ``nmc.jit(fn, opt="O1" | "off")`` (default ``O1``)
with per-call override on ``lower`` / ``lower_wave`` — partitioned
shards optimize *before* the common-bucket agreement, so a compacted
wave lands in a smaller bucket as a unit.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import timing
from repro_torch.nmc.program import PROG_DTYPE, Program

from repro_torch.nmc.opt import interp, rules
from repro_torch.nmc.opt.rules import Work
from repro_torch.nmc.opt.validate import OptError, reference_output, validate

#: Optimization levels accepted by ``nmc.jit(fn, opt=...)``.
OPT_LEVELS = ("O1", "off")

__all__ = ["OPT_LEVELS", "OptError", "OptReport", "RewriteRecord",
           "optimize", "clear_memo", "interp", "rules"]


@dataclasses.dataclass(frozen=True)
class RewriteRecord:
    """One applied, translation-validated rewrite."""

    rule: str
    removed: int                    # instructions deleted
    moved: int                      # operand references relocated
    n_before: int                   # instruction count entering the rule
    n_after: int
    cycles_before: float            # modeled engine cycles entering
    cycles_after: float


@dataclasses.dataclass(frozen=True)
class OptReport:
    """Structured result of one :func:`optimize` run."""

    kernel: str
    engine: str
    sew: int
    level: str
    rewrites: Tuple[RewriteRecord, ...]
    n_instr_before: int
    n_instr_after: int
    cycles_before: float
    cycles_after: float
    validated: int                  # translation-validation gates passed

    @property
    def removed(self) -> int:
        return sum(r.removed for r in self.rewrites)

    @property
    def moved(self) -> int:
        return sum(r.moved for r in self.rewrites)

    def render(self) -> str:
        head = (f"{self.kernel} [{self.engine}/sew{self.sew}] {self.level}: "
                f"{self.n_instr_before} -> {self.n_instr_after} instrs, "
                f"{self.cycles_before:.0f} -> {self.cycles_after:.0f} "
                f"cycles ({self.validated} rewrites validated)")
        lines = [head] + [
            f"  {r.rule}: -{r.removed} instrs, {r.moved} refs moved, "
            f"{r.cycles_before:.0f} -> {r.cycles_after:.0f} cycles"
            for r in self.rewrites]
        return "\n".join(lines)


def _check_level(level: str) -> str:
    if level not in OPT_LEVELS:
        raise ValueError(f"unknown opt level {level!r}: expected one of "
                         f"{OPT_LEVELS}")
    return level


# optimize() is a pure function of (entries, image, lowering metadata) —
# all rules are value-independent, and the validation gate is as well
# deterministic — so repeated lowerings of the same kernel reuse the
# optimized artifact from a content-keyed LRU (same discipline as the
# verify_lowered memo).
_MEMO_CAP = 64
_opt_memo: "OrderedDict[bytes, tuple]" = OrderedDict()


def clear_memo() -> None:
    """Drop the optimization memo (benchmarks, tests)."""
    _opt_memo.clear()


def _memo_key(lk, entries: np.ndarray, level: str) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(entries))
    h.update(np.ascontiguousarray(np.asarray(lk.mem).reshape(-1)))
    meta = (lk.engine, lk.sew, level, tuple(map(int, lk.out_slice)),
            tuple((int(s), int(n)) for s, n in lk.init_spans),
            tuple((int(s), int(n)) for s, n in lk.cpool_spans),
            int(lk.used_words))
    h.update(repr(meta).encode())
    return h.digest()


def _memo_put(key: bytes, value) -> None:
    _opt_memo[key] = value
    while len(_opt_memo) > _MEMO_CAP:
        _opt_memo.popitem(last=False)


def _install(lk, w: Work, report: OptReport) -> None:
    lk.stream = list(w.entries)
    mem = np.asarray(lk.mem).copy()
    mem.reshape(-1)[:] = w.mem
    lk.mem = mem
    lk.init_spans = tuple(w.init_spans)
    lk.used_words = int(w.used_words)
    if lk.prov is not None and w.prov is not None:
        lk.prov = [int(p) for p in w.prov]
    lk._prog = None                 # padded/cached Program is stale
    lk.opt_report = report


def optimize(lk, level: str = "O1") -> Optional[OptReport]:
    """Optimize a :class:`repro_torch.nmc.frontend.LoweredKernel` in place.

    Runs the engine's rule pipeline (:data:`repro_torch.nmc.opt.rules.
    PIPELINE`), translation-validating each applied rewrite; returns the
    :class:`OptReport` (also attached as ``lk.opt_report``) or ``None``
    when nothing fired.  Raises :class:`OptError` on a rewrite that fails
    validation."""
    _check_level(level)
    if level == "off" or not len(lk.stream):
        return None
    from repro_torch.nmc import check
    if check.verify_lowered(lk).errors:
        return None                 # broken input: leave it to check=
    entries = np.array(lk.stream, dtype=PROG_DTYPE)
    key = _memo_key(lk, entries, level)
    hit = _opt_memo.get(key)
    if hit is not None:
        _opt_memo.move_to_end(key)
        if hit[0] is None:
            return None             # known no-op for this artifact
        w, report = hit
        _install(lk, Work(w.engine, w.sew, w.entries.copy(), w.mem.copy(),
                          w.out_slice, list(w.init_spans), w.cpool_spans,
                          w.used_words,
                          None if w.prov is None else w.prov.copy()),
                 report)
        return report
    kernel = lk.kernel or f"<{lk.engine} kernel>"
    w = Work(engine=lk.engine, sew=lk.sew, entries=entries,
             mem=np.asarray(lk.mem).reshape(-1).copy(),
             out_slice=tuple(map(int, lk.out_slice)),
             init_spans=[(int(s), int(n)) for s, n in lk.init_spans],
             cpool_spans=tuple((int(s), int(n)) for s, n in lk.cpool_spans),
             used_words=int(lk.used_words),
             prov=None if lk.prov is None else np.asarray(lk.prov))
    ref_out = None                  # oracle runs lazily: only if a rule fires
    orig = (w.entries.copy(), w.mem.copy())
    records: List[RewriteRecord] = []
    n0 = len(w.entries)
    cycles = None

    def modeled_cycles() -> float:
        return float(timing.program_cycles(
            Program.from_entries(w.engine, w.sew, w.entries)).cycles)

    for rule_name, rule_fn in rules.PIPELINE[w.engine]:
        n_before = len(w.entries)
        stats = rule_fn(w)
        if not stats:
            continue
        if ref_out is None:
            ref_out = reference_output(w.engine, orig[1], orig[0], w.sew,
                                       w.out_slice)
            cycles = float(timing.program_cycles(
                Program.from_entries(w.engine, w.sew, orig[0])).cycles)
        validate(w, ref_out, kernel, rule_name)
        after = modeled_cycles()
        records.append(RewriteRecord(
            rule=rule_name, removed=int(stats.get("removed", 0)),
            moved=int(stats.get("moved", 0)), n_before=n_before,
            n_after=len(w.entries), cycles_before=cycles,
            cycles_after=after))
        cycles = after
    if not records:
        _memo_put(key, (None, None))
        return None
    report = OptReport(
        kernel=kernel, engine=w.engine, sew=w.sew, level=level,
        rewrites=tuple(records), n_instr_before=n0,
        n_instr_after=len(w.entries),
        cycles_before=records[0].cycles_before,
        cycles_after=records[-1].cycles_after, validated=len(records))
    _install(lk, w, report)
    _memo_put(key, (Work(w.engine, w.sew, w.entries.copy(), w.mem.copy(),
                         w.out_slice, list(w.init_spans), w.cpool_spans,
                         w.used_words,
                         None if w.prov is None else w.prov.copy()),
                    report))
    return report
