"""Residency hazard pass: resident-weight kernels and chained waves.

The PR 8 serving path keeps weight images resident on private tiles and
patches only the activation constant-pool words between calls
(:class:`repro_torch.nmc.serve.block.ResidentProjection`).  That contract has
two static hazards the per-program passes cannot see:

* a **patch span** (cpool words rewritten every call) that aliases a
  **weight span** (words DMA'd once at construction) would corrupt the
  resident image on the first submit, and every later call computes
  against garbage weights;
* a program **write** landing inside any image-defined span mutates
  state the projection assumes immutable across calls — correct on call
  one, silently wrong on call two (a WAR hazard stretched across
  submissions);
* two **chained waves** touching the same tile would overlap DMA-out of
  wave *k* with DMA-in of wave *k+1* on that tile (a WAR hazard across
  the four dependent waves of a transformer block step).

:func:`verify_resident` proves the first two per lowered shard;
:func:`verify_chained_waves` proves tile-disjointness across a chained
wave schedule.  Both are wired into the serving layer at construction
time — the hazards are static properties of the layout, so one check at
build covers every future call.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.nmc.check.report import CheckReport, _Ctx
from repro_torch.nmc.check.structural import _caesar_code, _columns


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> bool:
    (s1, n1), (s2, n2) = a, b
    return s1 < s2 + n2 and s2 < s1 + n1


def verify_resident(lk, kernel: Optional[str] = None) -> CheckReport:
    """Prove a lowered kernel safe for weight residency: patch spans
    (``cpool_spans``) never alias the once-DMA'd weight spans, and no
    program write lands inside any image-defined span."""
    target = kernel or getattr(lk, "kernel", None) or "<resident>"
    ctx = _Ctx(kernel=target, out_slice=None, init_spans=None,
               used_words=0, prov=getattr(lk, "prov", None), diags=[])
    prog = lk.program
    if prog.engine != "caesar":
        ctx.emit("error", "residency", "engine-not-resident",
                 f"engine {prog.engine!r} embeds operand values in the "
                 f"instruction stream (EMVX scalars) — only caesar "
                 f"programs support the patch-only residency contract")
        return CheckReport(target, ctx.diags)
    cpools = [(int(s), int(n)) for s, n in (lk.cpool_spans or ())]
    weights = [sp for sp in ((int(s), int(n)) for s, n in
                             (lk.init_spans or ()))
               if sp not in cpools]
    for p in cpools:
        for w in weights:
            if _overlap(p, w):
                ctx.emit("error", "residency", "patch-aliases-weights",
                         f"patch span [{p[0]}, {p[0] + p[1]}) overlaps "
                         f"resident weight span [{w[0]}, {w[0] + w[1]}) — "
                         f"the first submit would corrupt the resident "
                         f"image")
    m = _columns(prog.entries)
    op = m[:, 0]
    writes = (_caesar_code(ctx, op) & 2) != 0
    if writes.any():
        dest = m[:, 1]
        spans = cpools + weights
        starts = np.array([s for s, _ in spans], np.int64)
        ends = np.array([s + n for s, n in spans], np.int64)
        hit = np.zeros(len(dest), bool)
        for lo, hi in zip(starts, ends):
            hit |= writes & (dest >= lo) & (dest < hi)
        ctx.emit_rows(
            "error", "residency", "resident-write-hazard",
            np.flatnonzero(hit),
            lambda i: f"writes word {int(dest[i])} inside an image-defined "
            f"span — the span DMAs in once at construction, so the write "
            f"corrupts state the next call reads (WAR across submits)")
    return CheckReport(target, ctx.diags)


def verify_chained_waves(wave_tiles: Sequence[Sequence],
                         kernel: Optional[str] = None) -> CheckReport:
    """Prove a chained wave schedule WAR-hazard-free: no tile appears
    twice within one wave (two programs racing one tile) and no tile
    appears in two different waves (wave *k*'s DMA-out overlapping wave
    *k+1*'s DMA-in on the shared tile).  Tile IDs are any hashable —
    ints for planner tiles, the serving layer's ``("resident", uid, j)``
    tuples alike."""
    target = kernel or "<chained-waves>"
    ctx = _Ctx(kernel=target, out_slice=None, init_spans=None,
               used_words=0, prov=None, diags=[])
    seen: dict = {}
    for wi, tiles in enumerate(wave_tiles):
        tl = list(tiles)
        dup = sorted({t for t in tl if tl.count(t) > 1})
        for t in dup:
            ctx.emit("error", "residency", "war-hazard",
                     f"wave {wi} submits tile {t} twice — two programs "
                     f"race one tile's memory within a wave")
        for t in set(tl):
            if t in seen and seen[t] != wi:
                ctx.emit("error", "residency", "war-hazard",
                         f"tile {t} appears in wave {seen[t]} and wave "
                         f"{wi} — wave {wi}'s DMA-in would race wave "
                         f"{seen[t]}'s DMA-out on the shared tile")
            else:
                seen[t] = wi
    return CheckReport(target, ctx.diags)
