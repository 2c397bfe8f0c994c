"""Static IR verifier + dataflow analysis for NMC programs (DESIGN.md §11).

The stack hands ``Program`` arrays across four layers (tracer -> lowering ->
partitioner -> bucketed pools -> scan/Pallas engines), and a malformed
stream — an out-of-range Carus register, a read of a never-written Caesar
word, a shard wave that misses part of the output store set — executes
silently and computes garbage.  This package is the correctness *tooling*
layer that rejects such programs before they reach an engine:

* :func:`verify_program` — composable static passes over one unified-IR
  :class:`repro_torch.nmc.program.Program`, returning a :class:`CheckReport` of
  structured :class:`Diagnostic` records (severity, pass name, rule,
  instruction index, tracer-op provenance).  Passes:

  - **structural** (:mod:`repro_torch.nmc.check.structural`) — opcode valid for
    the engine, register/address ranges (Carus VRF bounds, Caesar word
    addresses vs the 32 KiB image), SEW-legal modes, Caesar entries
    structurally zero in Carus-only fields, padding NOPs truly neutral.
  - **dataflow** (:mod:`repro_torch.nmc.check.dataflow`) — def-use liveness:
    read-before-write against the image-defined spans, MAC/DOT
    accumulator chains (use-before-init, never-stored), dead writes
    (overwritten or never read), in-place VMACC hazards on Carus, and
    store coverage (every word of ``out_slice`` written or
    image-defined).
  - **resource** (:mod:`repro_torch.nmc.check.resource`) — allocator high-water
    vs engine capacity, plus an independent bank-conflict / instruction
    count estimate cross-checked against :mod:`repro_torch.core.timing` (drift
    between the verifier's and the cost model's view of a program is
    itself an error).

* :func:`verify_lowered` — the same passes over a frontend
  :class:`repro_torch.nmc.frontend.LoweredKernel`, using its recorded metadata
  (image-defined spans, per-instruction tracer provenance, kernel name).
* :func:`verify_plan` / :func:`verify_wave`
  (:mod:`repro_torch.nmc.check.partition`) — **partition safety**: shard store
  pieces exactly partition the parent store set, axis-shard loads carry a
  sufficient slide halo, and the common-bucket padding of a lowered wave
  is verifier-neutral.
* :func:`verify_resident` / :func:`verify_chained_waves`
  (:mod:`repro_torch.nmc.check.residency`) — **residency hazards**: patch spans
  never alias resident weight spans, no program write mutates an
  image-defined span, and chained waves are tile-disjoint (no WAR hazard
  across dependent submissions).
* :func:`assert_wave` / :func:`assert_submittable` — the cheap O(entries)
  subset the hot scheduler layers (:class:`repro_torch.nmc.pool.BucketedPool`,
  :class:`repro_torch.nmc.runtime.DispatchQueue`) assert on every dispatch.

``python -m repro_torch.nmc.check --all`` sweeps every registry kernel x engine
x SEW (plus partitioned waves) and prints a report — the CI lint gate.
``--report PATH`` writes the same sweep as stable-schema JSON.

The passes are numpy-vectorized (event sort over def/use streams, not a
per-instruction Python loop) and :func:`verify_lowered` memoizes its
verdict on a content fingerprint of the program, so
``nmc.jit(fn, check="error")`` — the default — verifies every lowering
at a few percent overhead (``benchmarks/check_bench.py`` is the gate).

These analyses are also the substrate of the IR optimizer
(:mod:`repro_torch.nmc.opt`): every rewrite re-runs them as its
translation-validation gate.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import alu
from repro_torch.nmc.program import ENGINES, PROG_DTYPE, Program
from repro_torch.nmc.registry import engine_op_ids

# Split modules re-exported verbatim: the 1005-line monolith became
# report / structural / dataflow / resource / partition / residency, and
# every pre-split import path (`from repro_torch.nmc.check import X`,
# `check.X`) keeps working through this facade.
from repro_torch.nmc.check.report import (CHECK_MODES, MAX_PER_RULE, PASSES,
                                    SEVERITIES, CheckReport, Diagnostic,
                                    VerificationError, _Ctx, _defined_words)
from repro_torch.nmc.check.structural import (_CAESAR_BANK_WORDS,
                                        _CAESAR_MEM_WORDS, _CARUS_N_REGS,
                                        _CARUS_REG_WORDS, _NOP_C, _NOP_K,
                                        _caesar_code, _carus_operands,
                                        _carus_regs, _carus_uses, _class_lut,
                                        _columns, _member, check_structural)
from repro_torch.nmc.check.dataflow import (_chain_check, _event_analysis,
                                      check_dataflow)
from repro_torch.nmc.check.resource import check_resource
from repro_torch.nmc.check.partition import verify_plan, verify_wave
from repro_torch.nmc.check.residency import verify_chained_waves, verify_resident

__all__ = [
    "CHECK_MODES", "SEVERITIES", "PASSES", "MAX_PER_RULE",
    "Diagnostic", "CheckReport", "VerificationError",
    "check_structural", "check_dataflow", "check_resource",
    "verify_program", "verify_lowered", "clear_memo",
    "verify_plan", "verify_wave",
    "verify_resident", "verify_chained_waves",
    "assert_submittable", "assert_wave", "main",
]


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

_PASS_FNS = {"structural": check_structural, "dataflow": check_dataflow,
             "resource": check_resource}


def verify_program(prog: Program, *, kernel: Optional[str] = None,
                   out_slice: Optional[Tuple[int, int]] = None,
                   init_spans: Optional[Sequence[Tuple[int, int]]] = None,
                   used_words: int = 0,
                   prov: Optional[Sequence[int]] = None,
                   passes: Optional[Sequence[str]] = None) -> CheckReport:
    """Run the static passes over one unified-IR program.

    ``init_spans`` lists the image-defined word spans (loads, constant
    pools) — without it the read-before-write and store-coverage checks
    are skipped (a bare program has no image to check against).  ``prov``
    maps instruction index -> tracer op index for provenance."""
    target = kernel or f"<{prog.engine} program>"
    ctx = _Ctx(kernel=target, out_slice=out_slice, init_spans=init_spans,
               used_words=int(used_words), prov=prov, diags=[])
    if prog.engine not in ENGINES:
        ctx.emit("error", "structural", "bad-engine",
                 f"unknown engine {prog.engine!r}")
        return CheckReport(target, ctx.diags)
    if prog.sew not in alu.SEWS:
        ctx.emit("error", "structural", "bad-sew",
                 f"sew={prog.sew!r} is not one of {sorted(alu.SEWS)}")
        return CheckReport(target, ctx.diags)
    for name in (passes or ("structural", "dataflow", "resource")):
        _PASS_FNS[name](prog, ctx)
    return CheckReport(target, ctx.diags)


# Verification is a pure function of (program bytes, lowering metadata),
# and the synchronous call path re-lowers an identical program on every
# invocation — memoize the verdict on a content fingerprint so repeated
# lowerings pay one 64 KiB hash, not the full pass pipeline.  In-place
# corruption of `entries` changes the fingerprint, so tampering is never
# masked by the cache.  The OrderedDict is LRU-bounded at ``_MEMO_CAP``
# entries so unbounded registry sweeps cannot grow it without limit;
# eviction only costs a re-verification on the next identical lowering.
_MEMO_CAP = 256
_report_memo: "OrderedDict[tuple, CheckReport]" = OrderedDict()


def clear_memo() -> None:
    """Drop the ``verify_lowered`` verdict cache (benchmarks, tests)."""
    _report_memo.clear()


def _spans_key(spans) -> Optional[tuple]:
    return None if spans is None else tuple((int(s), int(n)) for s, n in spans)


def _lowered_key(lk, kernel: str, passes) -> Optional[tuple]:
    prog = lk.program
    e = prog.entries
    if not e.flags.c_contiguous:
        e = np.ascontiguousarray(e)
    h = hashlib.blake2b(e, digest_size=16)
    prov = getattr(lk, "prov", None)
    if prov is not None:
        try:
            h.update(np.ascontiguousarray(prov, dtype=np.int64))
        except (TypeError, ValueError):
            return None                 # unhashable provenance: skip memo
    out_slice = getattr(lk, "out_slice", None)
    return (h.digest(), prog.engine, prog.sew, kernel,
            None if out_slice is None else tuple(map(int, out_slice)),
            _spans_key(getattr(lk, "init_spans", None)),
            int(getattr(lk, "used_words", 0) or 0),
            None if passes is None else tuple(passes))


def verify_lowered(lk, kernel: Optional[str] = None,
                   passes: Optional[Sequence[str]] = None) -> CheckReport:
    """Verify a frontend :class:`repro_torch.nmc.frontend.LoweredKernel` (or any
    duck-typed build) using its recorded lowering metadata."""
    prog = lk.program
    kernel = kernel or getattr(lk, "kernel", None) \
        or f"<{prog.engine} kernel>"
    key = _lowered_key(lk, kernel, passes)
    if key is not None:
        cached = _report_memo.get(key)
        if cached is not None:
            _report_memo.move_to_end(key)
            return cached
    report = verify_program(
        prog, kernel=kernel,
        out_slice=getattr(lk, "out_slice", None),
        init_spans=getattr(lk, "init_spans", None),
        used_words=getattr(lk, "used_words", 0) or 0,
        prov=getattr(lk, "prov", None), passes=passes)
    if key is not None:
        _report_memo[key] = report
        while len(_report_memo) > _MEMO_CAP:
            _report_memo.popitem(last=False)
    return report


# ---------------------------------------------------------------------------
# Cheap dispatch-time asserts (pool / runtime hot path)
# ---------------------------------------------------------------------------

def assert_submittable(program: Program) -> None:
    """O(n) structural floor checked at every queue submit: right dtype,
    known engine/sew, opcodes within the engine's id space.  Full
    verification belongs at lowering time (``nmc.jit(check=...)``) — this
    is the last-line invariant of the runtime boundary."""
    assert isinstance(program, Program), type(program)
    assert program.engine in ENGINES, program.engine
    assert program.sew in alu.SEWS, program.sew
    assert program.entries.dtype == PROG_DTYPE, program.entries.dtype
    if program.n_instr:
        op = program.entries["op"]
        lo, hi = int(op.min()), int(op.max())
        max_id = max(engine_op_ids(program.engine))
        assert 0 <= lo and hi <= max_id, \
            f"opcode {lo if lo < 0 else hi} outside the {program.engine} " \
            f"id space [0, {max_id}]"


def assert_wave(programs: Sequence[Program]) -> None:
    """Wave-level invariants asserted by the bucketed schedulers after
    padding: a non-empty wave of same-(engine, sew, n_instr) programs,
    each individually submittable."""
    assert programs, "empty wave"
    keys = {p.shape_key for p in programs}
    assert len(keys) == 1, f"mixed shape keys in one wave: {sorted(keys)}"
    for p in programs:
        assert_submittable(p)


# ---------------------------------------------------------------------------
# CLI: sweep every registry kernel x engine x SEW (the CI lint gate)
# ---------------------------------------------------------------------------

def _sweep_rows(kernels: Sequence[str], sews: Sequence[int],
                engines: Sequence[str]) -> list:
    from repro_torch.core import programs as P
    rows = []
    for name in kernels:
        for sew in sews:
            kb = P.build(name, sew)
            for engine in engines:
                eb = getattr(kb, engine, None)
                if eb is None:
                    continue
                lk = getattr(eb, "lowered", None)
                rep = verify_lowered(lk, kernel=f"{name}/{engine}/sew{sew}") \
                    if lk is not None else verify_program(
                        eb.program, kernel=f"{name}/{engine}/sew{sew}")
                rows.append((name, sew, engine, eb.program.n_instr, rep))
    return rows


def _wave_rows(sews: Sequence[int]) -> list:
    """Partition-safety coverage for the sweep: one axis wave (with a
    slide halo) and one rows wave, verified end to end."""
    from repro_torch.nmc import frontend

    def slide_sum(t, x):
        a = t.load(x)
        t.store(a + a.slide_down(2), n=a.ne - 2)

    def row_quad(t, *cols):
        for c in cols:
            t.store(t.load(c) * 3 + 1)

    rng = np.random.default_rng(0)
    rows = []
    for sew in sews:
        n = 64 * (32 // sew)
        x = rng.integers(-100, 100, n)
        k = frontend.jit(slide_sum, sew=sew, check="off")
        plan, lks = k.lower_wave(x, tiles=2)
        rep = verify_wave(k.trace(x), plan, lks, kernel=f"axis-wave/sew{sew}")
        rows.append(("axis-wave", sew, lks[0].engine,
                     lks[0].program.n_instr, rep))
        cols = [rng.integers(-100, 100, n) for _ in range(4)]
        k = frontend.jit(row_quad, sew=sew, check="off")
        plan, lks = k.lower_wave(*cols, tiles=2)
        rep = verify_wave(k.trace(*cols), plan, lks,
                          kernel=f"rows-wave/sew{sew}")
        rows.append(("rows-wave", sew, lks[0].engine,
                     lks[0].program.n_instr, rep))
    return rows


#: ``--report`` JSON schema version: bump only on breaking key changes.
REPORT_SCHEMA = 1


def _report_json(rows: Sequence, strict: bool) -> dict:
    """The sweep as a stable-schema JSON document (the CI artifact).

    Top-level keys: ``schema`` (int), ``strict`` (bool), ``targets``
    (list of per-target records with ``kernel``/``sew``/``engine``/
    ``n_instr``/``errors``/``warnings``/``status``/``diagnostics``), and
    ``summary`` (``targets``/``errors``/``warnings``/``status``).
    Diagnostic records use :meth:`Diagnostic.as_dict` keys."""
    targets = []
    n_err = n_warn = 0
    for name, sew, engine, n_instr, rep in rows:
        e, w = len(rep.errors), len(rep.warnings)
        n_err += e
        n_warn += w
        targets.append({
            "kernel": name, "sew": int(sew), "engine": engine,
            "n_instr": int(n_instr), "errors": e, "warnings": w,
            "status": "fail" if e or (strict and w) else "ok",
            "diagnostics": [d.as_dict() for d in rep.diagnostics
                            if d.severity != "info"],
        })
    return {
        "schema": REPORT_SCHEMA,
        "strict": bool(strict),
        "targets": targets,
        "summary": {
            "targets": len(targets), "errors": n_err, "warnings": n_warn,
            "status": "fail" if n_err or (strict and n_warn) else "ok",
        },
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import json
    from repro_torch.core import programs as P

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.nmc.check",
        description="Static verification sweep over the kernel registry.")
    ap.add_argument("--all", action="store_true",
                    help="sweep every registry kernel x engine x SEW "
                         "(default when no --kernel is given)")
    ap.add_argument("--kernel", action="append", default=None,
                    help="restrict to one registry kernel (repeatable)")
    ap.add_argument("--sew", action="append", type=int, default=None,
                    help="restrict to one element width (repeatable)")
    ap.add_argument("--engine", action="append", default=None,
                    choices=list(ENGINES), help="restrict to one engine")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="also write the sweep as JSON to PATH "
                         "(CI artifact, schema v%d)" % REPORT_SCHEMA)
    ap.add_argument("--strict", action="store_true",
                    help="fail on warnings too, not just errors")
    ap.add_argument("--no-waves", action="store_true",
                    help="skip the partitioned-wave checks")
    args = ap.parse_args(argv)

    kernels = args.kernel or list(P.ALL_KERNELS)
    sews = args.sew or sorted(alu.SEWS)
    engines = args.engine or list(ENGINES)
    rows = _sweep_rows(kernels, sews, engines)
    if not args.no_waves:
        rows += _wave_rows(sews)

    lines = [f"{'kernel':<12} {'sew':>3} {'engine':<7} {'instrs':>7} "
             f"{'errors':>6} {'warns':>5}  status"]
    n_err = n_warn = 0
    details = []
    for name, sew, engine, n_instr, rep in rows:
        e, w = len(rep.errors), len(rep.warnings)
        n_err += e
        n_warn += w
        status = "FAIL" if e or (args.strict and w) else "ok"
        lines.append(f"{name:<12} {sew:>3} {engine:<7} {n_instr:>7} "
                     f"{e:>6} {w:>5}  {status}")
        if e or w:
            details.append(rep.render())
    lines.append(f"\n{len(rows)} targets verified: {n_err} error(s), "
                 f"{n_warn} warning(s)")
    if details:
        lines.append("\n" + "\n".join(details))
    print("\n".join(lines))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(_report_json(rows, args.strict), f, indent=2)
            f.write("\n")
        print(f"report written to {args.report}")
    return 1 if n_err or (args.strict and n_warn) else 0
