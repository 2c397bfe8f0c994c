"""Partition-safety pass: shard plans and lowered waves.

Shard store pieces must exactly partition the parent store set (no gap,
no overlap), axis-shard loads must carry a sufficient slide halo, and a
lowered wave must agree on one instruction bucket with verifier-neutral
NOP tails.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.nmc.check.report import CheckReport, _Ctx


def verify_plan(parent, plan, kernel: Optional[str] = None) -> CheckReport:
    """Partition-safety pass over a :class:`repro_torch.nmc.partition.
    PartitionPlan`: the shards' store pieces must exactly partition every
    parent store's element range (no gap, no overlap), and axis shards'
    loads must carry the full slide halo."""
    from repro_torch.nmc.partition import slide_halo
    target = kernel or getattr(parent, "name", None) or "<plan>"
    ctx = _Ctx(kernel=target, out_slice=None, init_spans=None,
               used_words=0, prov=None, diags=[])
    per_store: dict = {si: [] for si in range(len(plan.store_trims))}
    for shard, pieces in enumerate(plan.pieces):
        for si, lo, hi in pieces:
            if si not in per_store:
                ctx.emit("error", "partition", "store-not-partitioned",
                         f"shard {shard} references store #{si}, but the "
                         f"parent tape has {len(plan.store_trims)} stores")
                continue
            per_store[si].append((lo, hi, shard))
    for si, trim in enumerate(plan.store_trims):
        ivs = sorted(per_store[si])
        pos = 0
        for lo, hi, shard in ivs:
            if lo > pos:
                ctx.emit("error", "partition", "store-not-partitioned",
                         f"store #{si}: elements [{pos}, {lo}) are covered "
                         f"by no shard")
            elif lo < pos:
                ctx.emit("error", "partition", "store-not-partitioned",
                         f"store #{si}: elements [{lo}, {min(pos, hi)}) "
                         f"are covered twice (shard {shard} overlaps)")
            pos = max(pos, hi)
        if pos < trim:
            ctx.emit("error", "partition", "store-not-partitioned",
                     f"store #{si}: elements [{pos}, {trim}) are covered "
                     f"by no shard")
    # halo sufficiency: axis shards replay every load sliced [lo, end);
    # end must reach hi + the tape's max cumulative slide read-ahead
    if plan.strategy in ("axis", "single") and plan.pieces:
        halo = slide_halo(parent)
        parent_loads = [n for n in parent.nodes if n.op == "load"]
        for shard, (b, pieces) in enumerate(zip(plan.builders, plan.pieces)):
            if not pieces:
                continue
            lo = min(p[1] for p in pieces)
            hi = max(p[2] for p in pieces)
            shard_loads = [n for n in b.nodes if n.op == "load"]
            for pl, sl in zip(parent_loads, shard_loads):
                required = min(hi + halo, pl.ne) - lo
                if sl.ne < required:
                    ctx.emit(
                        "error", "partition", "insufficient-halo",
                        f"shard {shard} load (traced op#{sl.idx}) carries "
                        f"{sl.ne} elements for piece [{lo}, {hi}) but "
                        f"slides read ahead {halo}: needs "
                        f"{required}")
    return CheckReport(target, ctx.diags)


def verify_wave(parent, plan, lks: Sequence,
                kernel: Optional[str] = None) -> CheckReport:
    """Partition safety + per-shard verification of a lowered wave,
    including the common-bucket padding contract: every shard program of
    one *engine group* must sit at one shared instruction count with
    verifier-neutral NOP tails (the structural nop-not-neutral rule
    covers the tails).  A mixed-engine wave (DESIGN.md §14) legitimately
    carries one bucket per engine — Caesar and Carus programs never share
    a compile bucket — so agreement is checked per group."""
    # facade-level import: verify_lowered (and its memo) live in the
    # package __init__, which re-exports this module — defer to avoid the
    # cycle
    from repro_torch.nmc.check import verify_lowered
    target = kernel or getattr(parent, "name", None) or "<wave>"
    report = verify_plan(parent, plan, kernel=target)
    ctx = _Ctx(kernel=target, out_slice=None, init_spans=None,
               used_words=0, prov=None, diags=report.diagnostics)
    by_engine: dict = {}
    for lk in lks:
        by_engine.setdefault(lk.engine, set()).add(lk.program.n_instr)
    for eng, sizes in sorted(by_engine.items()):
        if len(sizes) > 1:
            ctx.emit("error", "partition", "wave-bucket-mismatch",
                     f"{eng} shard programs pad to different instruction "
                     f"counts {sorted(sizes)} — the engine group would "
                     f"split into several compile buckets")
    for i, lk in enumerate(lks):
        report.extend(verify_lowered(lk, kernel=f"{target}[shard {i}]"))
    return report
