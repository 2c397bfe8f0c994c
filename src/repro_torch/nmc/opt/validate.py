"""Per-rewrite translation validation (DESIGN.md §13).

Every applied rewrite must survive two independent gates before the
optimized program replaces the original:

1. **re-verification** — the full static pass pipeline
   (:func:`repro_torch.nmc.check.verify_program`) over the rewritten program
   with its updated metadata must report zero errors, and
2. **oracle differential** — the numpy reference interpreters
   (:mod:`repro_torch.nmc.opt.interp`) must produce bit-identical output-window
   words for the rewritten program as for the original.

A failure raises :class:`OptError` naming the rule — an optimizer bug
fails loudly at lowering time; it can never silently miscompile.
"""

from __future__ import annotations

import numpy as np

from repro_torch.nmc.program import Program

from repro_torch.nmc.opt import interp
from repro_torch.nmc.opt.rules import Work


class OptError(Exception):
    """A rewrite failed translation validation (optimizer bug)."""


def reference_output(engine: str, image: np.ndarray, entries: np.ndarray,
                     sew: int, out_slice) -> np.ndarray:
    lo, nw = int(out_slice[0]), int(out_slice[1])
    return interp.run(engine, image, entries, sew)[lo:lo + nw]


def validate(w: Work, ref_out: np.ndarray, kernel: str, rule: str) -> None:
    """Gate one applied rewrite; raises :class:`OptError` on any failure."""
    from repro_torch.nmc import check
    prog = Program.from_entries(w.engine, w.sew, w.entries)
    rep = check.verify_program(
        prog, kernel=f"{kernel}+{rule}", out_slice=tuple(w.out_slice),
        init_spans=tuple(w.init_spans), used_words=w.used_words,
        prov=None if w.prov is None else list(w.prov))
    if rep.errors:
        raise OptError(
            f"rule '{rule}' broke static verification of {kernel}:\n"
            + rep.render())
    got = reference_output(w.engine, w.mem, w.entries, w.sew, w.out_slice)
    if not np.array_equal(got, ref_out):
        bad = int(np.count_nonzero(got != ref_out))
        raise OptError(
            f"rule '{rule}' miscompiled {kernel}: {bad}/{len(ref_out)} "
            f"output words differ from the pre-rewrite oracle")
