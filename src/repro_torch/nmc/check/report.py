"""Diagnostics containers shared by every verifier pass (DESIGN.md §11).

:class:`Diagnostic` / :class:`CheckReport` / :class:`VerificationError` are
the public result types of :func:`repro_torch.nmc.check.verify_program` and
friends; :class:`_Ctx` is the internal pass context (emission helpers,
per-verification cache) threaded through the structural / dataflow /
resource / partition / residency passes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

#: Verification modes accepted by ``nmc.jit(fn, check=...)``.
CHECK_MODES = ("error", "warn", "off")

SEVERITIES = ("error", "warning", "info")
PASSES = ("structural", "dataflow", "resource", "partition", "residency")

#: Diagnostics reported per (pass, rule) before summarizing — a corrupted
#: 8k-instruction stream should not produce 8k records.
MAX_PER_RULE = 8


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verifier finding, with enough provenance to locate the defect:
    the pass and rule that fired, the instruction index in the lowered
    stream, and (when the program came from the traced frontend) the
    tracer-op index it lowered from."""

    severity: str               # "error" | "warning" | "info"
    pass_name: str              # "structural" | "dataflow" | ...
    rule: str                   # stable slug, e.g. "read-before-write"
    message: str
    kernel: Optional[str] = None
    instr: Optional[int] = None       # instruction index in the stream
    op_index: Optional[int] = None    # tracer node index (provenance)

    def __str__(self) -> str:
        where = self.kernel or "<program>"
        if self.instr is not None:
            where += f" instr#{self.instr}"
        if self.op_index is not None:
            where += f" (traced op#{self.op_index})"
        return (f"{self.severity}[{self.pass_name}/{self.rule}] "
                f"{where}: {self.message}")

    def as_dict(self) -> dict:
        """JSON-ready record (the CLI ``--report`` schema — stable keys)."""
        return {"severity": self.severity, "pass": self.pass_name,
                "rule": self.rule, "message": self.message,
                "kernel": self.kernel, "instr": self.instr,
                "op_index": self.op_index}


@dataclasses.dataclass
class CheckReport:
    """All diagnostics of one verification run."""

    target: str                       # what was verified (kernel / plan)
    diagnostics: List[Diagnostic]

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self) -> bool:
        """No errors (warnings and infos allowed)."""
        return not self.errors

    @property
    def clean(self) -> bool:
        """No errors and no warnings (infos allowed)."""
        return not self.errors and not self.warnings

    def by_rule(self, rule: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.rule == rule]

    def render(self) -> str:
        if not self.diagnostics:
            return f"{self.target}: clean"
        lines = [f"{self.target}: {len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s)"]
        lines += [f"  {d}" for d in self.diagnostics]
        return "\n".join(lines)

    def raise_if_errors(self) -> "CheckReport":
        if self.errors:
            raise VerificationError(self)
        return self

    def extend(self, other: "CheckReport") -> "CheckReport":
        self.diagnostics.extend(other.diagnostics)
        return self


class VerificationError(Exception):
    """A program failed static verification (``check="error"``)."""

    def __init__(self, report: CheckReport):
        self.report = report
        super().__init__(report.render())


# ---------------------------------------------------------------------------
# Pass context + emission helpers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Ctx:
    kernel: Optional[str]
    out_slice: Optional[Tuple[int, int]]
    init_spans: Optional[Sequence[Tuple[int, int]]]   # image-defined words
    used_words: int
    prov: Optional[Sequence[int]]
    diags: List[Diagnostic]
    cache: dict = dataclasses.field(default_factory=dict)

    def op_index(self, instr: Optional[int]) -> Optional[int]:
        if instr is None or self.prov is None or instr >= len(self.prov):
            return None
        return self.prov[instr]

    def emit(self, severity: str, pass_name: str, rule: str, message: str,
             instr: Optional[int] = None) -> None:
        self.diags.append(Diagnostic(
            severity, pass_name, rule, message, kernel=self.kernel,
            instr=None if instr is None else int(instr),
            op_index=self.op_index(instr)))

    def emit_rows(self, severity: str, pass_name: str, rule: str,
                  rows: np.ndarray, fmt: Callable[[int], str]) -> None:
        """Emit one diagnostic per flagged instruction row, capped at
        :data:`MAX_PER_RULE` with a summarizing tail record."""
        rows = np.asarray(rows)
        for i in rows[:MAX_PER_RULE]:
            self.emit(severity, pass_name, rule, fmt(int(i)), instr=int(i))
        if len(rows) > MAX_PER_RULE:
            self.emit(severity, pass_name, rule,
                      f"... and {len(rows) - MAX_PER_RULE} more "
                      f"'{rule}' findings")


def _defined_words(ctx: _Ctx, capacity: int) -> Optional[np.ndarray]:
    """Boolean image-defined map, or None when unknown (hand-built
    programs verify structurally but skip init-sensitive dataflow)."""
    if ctx.init_spans is None:
        return None
    defined = np.zeros(capacity, bool)
    for start, nw in ctx.init_spans:
        lo = max(0, int(start))
        defined[lo:min(capacity, int(start) + int(nw))] = True
    return defined
