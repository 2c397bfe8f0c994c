"""Cost-model-driven heterogeneous wave scheduler + plan autotuner
(DESIGN.md §14).

The partitioning planner (:mod:`repro_torch.nmc.partition`) carves one traced
kernel into shards; *how* those shards are cut, which engine runs each
one and in what order their images stream over the shared system bus is
a scheduling decision with a measurable objective:
:func:`repro_torch.core.timing.wave_cycles`, the N+1-resource model of the
paper's edge-node topology (one serialized 32-bit bus, N independent
tile engines).  This module searches that space:

* **Partition strategy** — ``"rows"`` vs ``"axis"`` both cost out
  through real lowerings, not the structural auto rule alone (a matmul
  that *can* row-split may still be cheaper as axis chunks: row shards
  each replicate every B-row load, axis shards slice them).
* **Per-tile chunk skew** — the bus serializes the DMA ladder, so the
  first-dispatched tile's image lands first and the last tile idles
  behind every earlier transfer.  Skewing chunk sizes (a geometric
  just-in-time ramp: first-dispatched shards get larger chunks) lets
  every tile finish together instead of the last tile starting last
  *and* finishing last.
* **Per-shard engine assignment** — within one wave, bus-expressible
  shards can run on NM-Caesar (small image, host-streamed micro-ops)
  while slide/indirect/unsigned shards run on NM-Carus; a greedy
  ladder walk proposes the mix and the exact wave model arbitrates.
* **Dispatch order** — stages stream in list order, so the ragged tail
  (and any compute-heavy shard) goes where the cost model says, not
  blindly last.

Every candidate is evaluated on **real lowered shards** (exact
:func:`repro_torch.core.timing.stage_cost` legs), and the winning
:class:`SchedulePlan` is cached in a content-keyed blake2b-LRU registry
(the same idiom as ``opt/`` and ``verify_lowered``) keyed on the
*value-independent* tape structure — so re-calls with fresh activation
values reuse the identical plan object without re-searching.

Bit-exactness is by construction: a plan only ever reparameterizes the
partition planner (explicit chunk vectors, shard permutations) and the
per-shard lowerings; shards still replay through ``ProgramBuilder``
with the eager oracle, and the partition-safety verifier gates every
realized plan (``check="error"`` stays the frontend default).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import timing
from repro_torch.nmc import partition as P
from repro_torch.nmc.frontend import (ENGINES, LoweringError, ProgramBuilder,
                                UnsupportedOnEngine, _check_tiles,
                                _ConstScalar, _LOWERINGS, _Node,
                                engine_diagnosis, select_engine)

#: The valid ``schedule=`` mode names (a :class:`SchedulePlan` instance is
#: also accepted wherever a mode is).
SCHEDULE_MODES = ("auto", "uniform")

#: Fixed just-in-time skew ratios for the geometric chunk ramp, tried on
#: top of the per-kernel fitted ratio (compute/(dma+compute) of the head
#: shard).  The exact wave model arbitrates; these only seed candidates.
SKEW_RATIOS = (0.85, 0.7, 0.55)


# ---------------------------------------------------------------------------
# Plan artifact
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    """One scheduling decision for a partitioned wave, value-independent
    and reusable across calls of the same kernel structure.

    ``chunks``/``engines`` are indexed in *axis order* (the order the
    partition planner builds shards); ``order`` maps dispatch position
    ``k`` to the shard index dispatched k-th.  ``modeled_cycles`` /
    ``uniform_cycles`` / ``seed_cycles`` record the wave model's verdict
    for this plan, the best uniform single-engine plan, and the seed
    planner's fixed equal-chunk tail-last behavior respectively."""

    strategy: str                   # "single" | "rows" | "axis"
    chunks: Tuple[int, ...]         # axis: elements; rows: store counts
    engines: Tuple[str, ...]        # per shard, axis order
    order: Tuple[int, ...]          # dispatch position -> shard index
    tiles: int
    sew: int
    modeled_cycles: float
    uniform_cycles: float
    seed_cycles: float
    source: str                     # "auto" | "uniform" | "user"

    @property
    def n_shards(self) -> int:
        return len(self.engines)

    @property
    def mixed(self) -> bool:
        """True when the wave assigns more than one engine."""
        return len(set(self.engines)) > 1


def clear_plan_cache() -> None:
    """Drop every cached SchedulePlan (test isolation)."""
    _plan_cache.clear()


_PLAN_CAP = 64
_plan_cache: "OrderedDict[bytes, SchedulePlan]" = OrderedDict()


def plan_key(builder: ProgramBuilder, tiles: int, partition: str,
             engine: str, mode: str) -> bytes:
    """Content key of a scheduling problem: the blake2b digest of the
    tape's value-independent structure (op kinds, element counts, slide
    amounts, bank hints, operand wiring, store trims) plus the request
    (tiles, partition policy, engine policy, schedule mode).  Traced
    *values* are excluded on purpose — two calls of one kernel over
    different activations share the plan."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((builder.sew, int(tiles), partition, engine,
                   mode)).encode())
    for n in builder.nodes:
        args = []
        for a in n.args:
            if isinstance(a, _Node):
                args.append(("n", a.idx))
            elif isinstance(a, _ConstScalar):
                args.append(("c", a.pool.idx, a.index))
            else:                       # literal Python scalar: part of the
                args.append(("s", int(a)))   # kernel's code, not its data
        h.update(repr((n.op, n.ne, n.amount, n.bank, tuple(args))).encode())
    h.update(repr([(nd.idx, t) for nd, t in builder.stores]).encode())
    return h.digest()


def _cache_put(key: bytes, plan: SchedulePlan) -> None:
    _plan_cache[key] = plan
    while len(_plan_cache) > _PLAN_CAP:
        _plan_cache.popitem(last=False)


# ---------------------------------------------------------------------------
# Chunk-vector candidates
# ---------------------------------------------------------------------------

def _ramp(total: int, n: int, r: float) -> Tuple[int, ...]:
    """Integer geometric ramp: ``n`` positive descending values summing to
    ``total`` with shape ``~ r**i`` — the just-in-time skew (the first
    bus-served shard gets the largest share)."""
    assert 0 < r <= 1.0 and n >= 1 and total >= n, (total, n, r)
    weights = [r ** i for i in range(n)]
    scale = total / sum(weights)
    vals = [max(1, round(w * scale)) for w in weights]
    i = 0
    while sum(vals) != total:           # repair rounding drift in place
        j = i % n
        if sum(vals) > total:
            if vals[j] > 1:
                vals[j] -= 1
        else:
            vals[j] += 1
        i += 1
    vals.sort(reverse=True)
    return tuple(vals)


def _words_to_chunks(words: Sequence[int], lanes: int,
                     L: int) -> Tuple[int, ...]:
    """Word-aligned split points -> element chunk vector (tail clipped)."""
    out, lo = [], 0
    for w in words:
        hi = min(lo + int(w) * lanes, L)
        if hi > lo:
            out.append(hi - lo)
        lo = hi
    return tuple(out)


def _axis_extent(builder: ProgramBuilder) -> Optional[int]:
    """The common trimmed store length of an axis-splittable tape."""
    trims = {t for _, t in builder.stores}
    return trims.pop() if len(trims) == 1 else None


def _chunks_of(pplan: P.PartitionPlan) -> Tuple[int, ...]:
    """Recover the per-shard chunk vector from a built plan (elements for
    axis, store counts for rows)."""
    if pplan.strategy == "rows":
        return tuple(len(p) for p in pplan.pieces)
    return tuple(p[0][2] - p[0][1] for p in pplan.pieces)


def _axis_candidates(builder: ProgramBuilder, tiles: int, mode: str,
                     ratios: Sequence[float]) -> List[Tuple[int, ...]]:
    L = _axis_extent(builder)
    if L is None:
        return []
    lanes = 32 // builder.sew
    cands = [P.uniform_axis_chunks(L, tiles, lanes)]
    bal = P.balanced_axis_chunks(L, tiles, lanes)
    if bal not in cands:
        cands.append(bal)
    if mode == "auto":
        words_total = -(-L // lanes)
        n = min(tiles, words_total)
        if n >= 2:
            for r in ratios:
                c = _words_to_chunks(_ramp(words_total, n, r), lanes, L)
                if c and c not in cands:
                    cands.append(c)
    return cands


def _rows_candidates(builder: ProgramBuilder, tiles: int,
                     mode: str) -> List[Tuple[int, ...]]:
    S = len(builder.stores)
    if S < 2:
        return []
    n = min(tiles, S)
    q, rem = divmod(S, n)
    cands = [tuple(q + (1 if s < rem else 0) for s in range(n))]
    if mode == "auto" and n >= 2 and S > n:
        for r in SKEW_RATIOS:
            c = _ramp(S, n, r)
            if c not in cands:
                cands.append(c)
    return cands


# ---------------------------------------------------------------------------
# Dispatch-order search
# ---------------------------------------------------------------------------

def candidate_orders(stages: Sequence[timing.StageCost],
                     n_tiles: int) -> List[Tuple[int, ...]]:
    """Deterministic dispatch-order candidates: exhaustive for short waves,
    else identity + every single-shard relocation + the cost-sorted
    heuristics (largest-compute-first profits when a heavy shard would
    otherwise wait behind the whole DMA ladder)."""
    n = len(stages)
    ident = tuple(range(n))
    if n <= 1:
        return [ident]
    if n <= 5:
        return [ident] + [p for p in itertools.permutations(range(n))
                          if p != ident]
    cands = {ident}
    for i in range(n):
        for j in range(n):
            if i != j:
                rest = [k for k in range(n) if k != i]
                rest.insert(j, i)
                cands.add(tuple(rest))
    cands.add(tuple(sorted(range(n),
                           key=lambda k: (-stages[k].compute_cycles, k))))
    cands.add(tuple(sorted(range(n),
                           key=lambda k: (-stages[k].dma_in_cycles, k))))
    cands.add(tuple(sorted(
        range(n),
        key=lambda k: (stages[k].dma_in_cycles
                       - stages[k].compute_cycles, k))))
    return [ident] + sorted(cands - {ident})


def best_order(stages: Sequence[timing.StageCost], n_tiles: int,
               assign: str = "roundrobin") -> Tuple[Tuple[int, ...], float]:
    """The cheapest candidate dispatch order under the wave model, with a
    deterministic preference for identity on ties."""
    best_key, best = None, None
    for order in candidate_orders(stages, n_tiles):
        c = timing.wave_cycles([stages[i] for i in order], n_tiles,
                               assign=assign)
        key = (c, order != tuple(range(len(stages))), order)
        if best_key is None or key < best_key:
            best_key, best = key, (order, c)
    assert best is not None
    return best


# ---------------------------------------------------------------------------
# Candidate evaluation
# ---------------------------------------------------------------------------

#: Per shard: engine -> (LoweredKernel, StageCost); engines the shard
#: cannot lower on are simply absent.
_Options = List[Dict[str, tuple]]


def _shard_options(pplan: P.PartitionPlan,
                   allowed: Sequence[str]) -> Tuple[_Options, list]:
    """Lower every shard on every allowed engine; collect stage costs.
    Returns the per-shard option maps plus the diagnoses of failed
    (engine, shard) pairs for error reporting."""
    opts: _Options = []
    failures: list = []
    for sb in pplan.builders:
        d: Dict[str, tuple] = {}
        for eng in allowed:
            bad = engine_diagnosis(sb, eng)
            if bad is not None:
                failures.append(bad)
                continue
            try:
                lk = _LOWERINGS[eng](sb).lower()
            except LoweringError as e:
                failures.append(e)
                continue
            d[eng] = (lk, timing.stage_cost(lk))
        opts.append(d)
    return opts, failures


def _greedy_mix(opts: _Options) -> Optional[Tuple[str, ...]]:
    """Walk the DMA ladder in axis order, assigning each shard the engine
    that finishes it earliest given the bus time already committed —
    Caesar for small-image bus-expressible shards, Carus where the bus
    ALU cannot go (or its 100-cycle overhead still wins).  A heuristic
    proposal only: the exact wave model judges the result."""
    if not all(opts):
        return None
    bus = 0.0
    pick: List[str] = []
    for d in opts:
        best = None
        for eng in sorted(d):
            st = d[eng][1]
            key = (bus + st.dma_in_cycles + st.compute_cycles,
                   st.dma_in_cycles, eng)
            if best is None or key < best[0]:
                best = (key, eng, st)
        assert best is not None
        pick.append(best[1])
        bus += best[2].dma_in_cycles
    return tuple(pick)


def _assignments(opts: _Options, allowed: Sequence[str],
                 mix: bool) -> List[Tuple[str, ...]]:
    cands: List[Tuple[str, ...]] = []
    for eng in allowed:
        if all(eng in d for d in opts):
            cands.append((eng,) * len(opts))
    if mix and len(allowed) > 1:
        mixed = _greedy_mix(opts)
        if mixed is not None and mixed not in cands:
            cands.append(mixed)
    return cands


@dataclasses.dataclass
class _Eval:
    """One fully-costed candidate configuration."""

    cycles: float
    rank: tuple                     # deterministic tie-break
    strategy: str
    chunks: Tuple[int, ...]
    engines: Tuple[str, ...]        # axis order
    order: Tuple[int, ...]
    ident_cycles: float             # same config, identity dispatch order
    pplan: P.PartitionPlan          # axis order (not yet reordered)
    opts: _Options


def _fitted_ratios(builder: ProgramBuilder, tiles: int, partition: str,
                   allowed: Sequence[str]) -> Tuple[float, ...]:
    """Per-kernel just-in-time ratio fit: lower the seed plan's head shard
    per engine and read r = compute/(dma+compute) — the geometric ramp
    ratio that equalizes tile finish times when stage legs scale with
    chunk size (intercepts are left to the exact evaluator)."""
    ratios = list(SKEW_RATIOS)
    try:
        head = P.plan(builder, tiles, partition).builders[0]
    except P.PartitionError:
        return tuple(ratios)
    for eng in allowed:
        if engine_diagnosis(head, eng) is not None:
            continue
        try:
            st = timing.stage_cost(_LOWERINGS[eng](head).lower())
        except LoweringError:
            continue
        denom = st.dma_in_cycles + st.compute_cycles
        if denom > 0:
            r = round(min(0.95, max(0.3, st.compute_cycles / denom)), 3)
            if r not in ratios:
                ratios.append(r)
    return tuple(ratios)


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

def _single_plan(builder: ProgramBuilder, engine: str,
                 mode: str) -> Tuple[SchedulePlan, P.PartitionPlan, list]:
    pplan = P.plan(builder, 1)
    eng = engine if engine != "auto" else select_engine(builder)
    lk = _LOWERINGS[eng](builder).lower()
    c = timing.wave_cycles([timing.stage_cost(lk)], 1)
    splan = SchedulePlan("single", (), (eng,), (0,), 1, builder.sew,
                         c, c, c, mode)
    return splan, pplan, [lk]


def _search(builder: ProgramBuilder, tiles: int, partition: str,
            engine: str, mode: str):
    """Evaluate the candidate space and pick the winning configuration.
    Returns ``(splan, pplan, lks)`` with the plan's shards already in
    dispatch order and lowered (unoptimized, unpadded — the frontend owns
    opt/padding/verification)."""
    if tiles == 1:
        return _single_plan(builder, engine, mode)
    seed_pplan = P.plan(builder, tiles, partition)   # seed strategy rule
    seed_strategy = seed_pplan.strategy
    seed_chunks = _chunks_of(seed_pplan)
    # the seed's single-engine choice: select on the head (largest) shard,
    # falling back to an engine every shard can lower on — a tape whose
    # shards differ in expressibility (heterogeneous store cones) must not
    # crash the uniform path
    if engine != "auto":
        uni_engines: Tuple[str, ...] = (engine,)
    else:
        head_eng = select_engine(seed_pplan.builders[0])
        uni_engines = (head_eng,) + tuple(e for e in ENGINES
                                          if e != head_eng)
    allowed = (engine,) if engine != "auto" else ENGINES
    if mode == "uniform":
        strategies = [seed_strategy]
    elif partition != "auto":
        strategies = [partition]
    else:
        strategies = [s for s in ("rows", "axis") if s == seed_strategy] + \
            [s for s in ("rows", "axis") if s != seed_strategy]
    ratios = _fitted_ratios(builder, tiles, partition, allowed) \
        if mode == "auto" else SKEW_RATIOS

    evals: List[_Eval] = []
    failures: list = []
    for strategy in strategies:
        if strategy == "rows":
            chunk_cands = _rows_candidates(builder, tiles, mode)
        else:
            chunk_cands = _axis_candidates(builder, tiles, mode, ratios)
        for chunks in chunk_cands:
            try:
                pplan = P.plan(builder, tiles, strategy, chunks=chunks)
            except P.PartitionError as e:
                failures.append(e)
                continue
            # uniform mode costs only the seed engine resolution, reaching
            # for the fallback engine lazily (the default path should not
            # pay a second lowering per shard when the seed engine covers
            # the whole wave); auto mode costs every allowed engine
            if mode == "uniform":
                opts, fails = _shard_options(pplan, uni_engines[:1])
                if not all(opts) and len(uni_engines) > 1:
                    more, fails2 = _shard_options(pplan, uni_engines[1:])
                    opts = [{**a, **b} for a, b in zip(opts, more)]
                    fails.extend(fails2)
                engines_here: Sequence[str] = uni_engines
            else:
                engines_here = allowed
                opts, fails = _shard_options(pplan, engines_here)
            failures.extend(fails)
            assigns = _assignments(opts, engines_here, mix=(mode == "auto"))
            if mode == "uniform" and assigns:
                assigns = assigns[:1]   # first feasible engine in seed order
            for assign in assigns:
                stages = [opts[i][e][1] for i, e in enumerate(assign)]
                order, cycles = best_order(stages, tiles)
                rank = (cycles,
                        len(set(assign)) > 1,          # prefer single-engine
                        strategy != seed_strategy,     # prefer seed strategy
                        chunks != seed_chunks,         # prefer seed chunks
                        order != tuple(range(len(order))),
                        assign, chunks, order)
                evals.append(_Eval(
                    cycles, rank, strategy, chunks, assign, order,
                    timing.wave_cycles(stages, tiles), pplan, opts))
    if not evals:
        for f in failures:
            if isinstance(f, (UnsupportedOnEngine, LoweringError)):
                raise f
        raise P.PartitionError(
            f"{builder.name}: no feasible schedule for tiles={tiles}, "
            f"partition={partition!r}, engine={engine!r}: "
            + "; ".join(str(f) for f in failures))

    # the seed reference: seed strategy + seed chunks + first feasible
    # seed engine, identity dispatch order — what the planner did before
    # scheduling existed (the regression baseline for satellite tests)
    seed_cycles = min(
        (e.ident_cycles for e in evals
         if e.strategy == seed_strategy and e.chunks == seed_chunks
         and len(set(e.engines)) == 1),
        default=min(e.ident_cycles for e in evals))
    # the uniform reference: best single-engine candidate within the seed
    # strategy's uniform chunkings (cost-picked tail placement included)
    uniform_evals = [e for e in evals
                     if e.strategy == seed_strategy
                     and len(set(e.engines)) == 1
                     and e.chunks in (seed_chunks,
                                      _uniform_alternatives(
                                          builder, tiles, seed_strategy))]
    uniform_cycles = min((e.cycles for e in uniform_evals),
                         default=min(e.cycles for e in evals))

    best = min(evals, key=lambda e: e.rank)
    splan = SchedulePlan(best.strategy, best.chunks, best.engines,
                         best.order, tiles, builder.sew, best.cycles,
                         uniform_cycles, seed_cycles, mode)
    pplan = best.pplan.reordered(best.order)
    lks = [best.opts[i][best.engines[i]][0] for i in best.order]
    return splan, pplan, lks


def _uniform_alternatives(builder: ProgramBuilder, tiles: int,
                          strategy: str) -> Tuple[int, ...]:
    """The non-seed uniform chunking (balanced remainder spread) — the
    only chunk vector besides the seed's that still counts as 'uniform'."""
    if strategy != "axis":
        return ()
    L = _axis_extent(builder)
    if L is None:
        return ()
    return P.balanced_axis_chunks(L, tiles, 32 // builder.sew)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def realize(builder: ProgramBuilder,
            splan: SchedulePlan) -> Tuple[P.PartitionPlan, list]:
    """Apply a SchedulePlan to a (re)traced tape: build the partition with
    the plan's chunk vector, permute shards into dispatch order and lower
    each on its assigned engine.  Raises :class:`PartitionError` /
    :class:`UnsupportedOnEngine` / :class:`LoweringError` when the plan
    does not fit the tape (user-supplied plans validate here)."""
    for e in splan.engines:
        if e not in ENGINES:
            raise ValueError(f"SchedulePlan names unknown engine {e!r}: "
                             f"expected one of {ENGINES}")
    if len(splan.order) != len(splan.engines):
        raise ValueError(
            f"SchedulePlan order/engines length mismatch: "
            f"{len(splan.order)} vs {len(splan.engines)}")
    if splan.strategy == "single":
        pplan = P.plan(builder, 1)
    else:
        pplan = P.plan(builder, splan.tiles, splan.strategy,
                       chunks=splan.chunks)
    if pplan.n_shards != splan.n_shards:
        raise P.PartitionError(
            f"{builder.name}: SchedulePlan expects {splan.n_shards} "
            f"shards, partition produced {pplan.n_shards}")
    pplan = pplan.reordered(splan.order)
    engines = [splan.engines[i] for i in splan.order]
    lks = [_LOWERINGS[e](sb).lower()
           for e, sb in zip(engines, pplan.builders)]
    return pplan, lks


def plan_wave(builder: ProgramBuilder, tiles: int, *,
              partition: str = "auto", engine: str = "auto",
              mode="uniform"):
    """The frontend's scheduling entry: returns ``(splan, pplan, lks)``
    with shards lowered in dispatch order (unoptimized, unpadded).

    ``mode`` is ``"uniform"`` (seed strategy/engine, cost-picked uniform
    chunking and tail placement), ``"auto"`` (the full autotuner search)
    or an explicit :class:`SchedulePlan`.  Searches are memoized in the
    content-keyed plan registry; a cache hit returns the identical plan
    object and only re-lowers the shards for the fresh traced values."""
    tiles = _check_tiles(tiles)
    if isinstance(mode, SchedulePlan):
        pplan, lks = realize(builder, mode)
        return mode, pplan, lks
    if mode not in SCHEDULE_MODES:
        raise ValueError(f"unknown schedule mode {mode!r}: expected a "
                         f"SchedulePlan or one of {SCHEDULE_MODES}")
    key = plan_key(builder, tiles, partition, engine, mode)
    hit = _plan_cache.get(key)
    if hit is not None:
        _plan_cache.move_to_end(key)
        pplan, lks = realize(builder, hit)
        return hit, pplan, lks
    splan, pplan, lks = _search(builder, tiles, partition, engine, mode)
    _cache_put(key, splan)
    return splan, pplan, lks


def autotune(builder: ProgramBuilder, tiles: int, *,
             partition: str = "auto",
             engine: str = "auto") -> SchedulePlan:
    """Search (strategy x chunk skew x engine assignment x dispatch
    order) for the cheapest modeled wave; cached — repeat calls with the
    same tape structure return the identical SchedulePlan object."""
    return plan_wave(builder, tiles, partition=partition, engine=engine,
                     mode="auto")[0]


def uniform_plan(builder: ProgramBuilder, tiles: int, *,
                 partition: str = "auto",
                 engine: str = "auto") -> SchedulePlan:
    """The uniform-mode reference plan (seed strategy and engine, uniform
    chunks, cost-picked remainder spread + tail placement)."""
    return plan_wave(builder, tiles, partition=partition, engine=engine,
                     mode="uniform")[0]
