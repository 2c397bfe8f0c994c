"""Tile-parallel partitioning planner (DESIGN.md §9).

The paper's headline property is *scalability*: an edge node instantiates
an array of identical NM-Caesar / NM-Carus tiles behind its SRAM macros.
The layers below this one already execute many independent programs across
tiles (vmapped pools, bucketed compiles, async waves) — this module closes
the remaining gap: carving **one** kernel across the array, so a single
``nmc.jit(fn, tiles=N)`` call occupies N tiles with shards of one logical
computation and reassembles the caller's array afterwards.

The planner operates on the *traced tape* (:class:`ProgramBuilder`), not on
host arrays, so it needs no per-kernel annotations: the tape already knows
which nodes are loads, which are scalar-tap pools, where slides read ahead
and how stores trim.  Two strategies:

* ``"rows"`` — *store-level* split: the tape's stores (matmul/gemm output
  rows) distribute across tiles in contiguous balanced blocks, and each
  shard replays exactly the backward cone of its stores.  Loads and
  ``t.consts`` pools referenced by several shards are replicated into each
  shard's tile image (the B matrix every output row reads).
* ``"axis"`` — *element-axis* split: every vector node (loads and
  computes) shares one data-parallel element axis, which splits into
  word-aligned chunks — elementwise/relu streams, conv/maxpool output
  columns.  ``slide_down`` reads ahead by its amount, so each shard's
  loads carry a *halo* of ``max`` cumulative slide depth.  By default
  chunks are ceil-packed with the ragged tail on the last shard (the
  seed behavior); callers may pass an explicit ``chunks=`` vector —
  arbitrary positive element counts, word-aligned or not — which is how
  the wave scheduler (:mod:`repro_torch.nmc.schedule`, DESIGN.md §14) realizes
  skewed and cost-arbitrated splits.

``partition="auto"`` picks ``rows`` when the stores distribute evenly and
the tape has no slides (slides are column-structured), otherwise ``axis``,
otherwise any applicable strategy — and raises :class:`PartitionError`
naming the obstruction when the tape has no data-parallel axis at all.

Bit-exactness is by construction: shards are replayed through the same
:class:`ProgramBuilder` tracing (eager ``alu.*_np`` evaluation), so each
shard carries its own oracle, and concatenating shard oracles reproduces
the unsharded oracle exactly (property-tested in tests/test_partition.py
over random lengths × split factors).  The :meth:`PartitionPlan.gather`
closure is the inverse of the split: it reassembles per-shard outputs into
the caller's array with the same shaping rule the single-tile path uses.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import alu
from repro_torch.nmc.frontend import (PARTITIONS, ProgramBuilder, _ConstScalar,
                                _Node, _check_tiles, _shape_parts)

#: The valid ``partition=`` strategy names — one source of truth, shared
#: with the frontend's eager kwarg validation (``nmc.jit(partition=...)``).
STRATEGIES = PARTITIONS


class PartitionError(Exception):
    """The traced tape cannot be sharded by the requested strategy (no
    data-parallel axis, too few stores, ...) — names the obstruction."""


# ---------------------------------------------------------------------------
# Plan artifact
# ---------------------------------------------------------------------------

#: One shard's slice of one original store: (store index, element range).
Piece = Tuple[int, int, int]


@dataclasses.dataclass
class PartitionPlan:
    """A sharded kernel: per-tile replayed tapes + the gather that
    reassembles their outputs into the caller's array."""

    strategy: str                      # "single" | "rows" | "axis"
    sew: int
    builders: List[ProgramBuilder]     # one replayed tape per shard
    pieces: List[List[Piece]]          # per shard, in its store order
    store_trims: List[int]             # original store trimmed lengths
    requested_tiles: int
    parent: Optional[ProgramBuilder] = None   # the unsharded tape — the
                                       # reference the partition-safety
                                       # pass (repro_torch.nmc.check) checks
                                       # store coverage and halos against

    @property
    def n_shards(self) -> int:
        return len(self.builders)

    @property
    def signature(self) -> tuple:
        """Layout-stability fingerprint: everything about the plan that
        determines shard memory layout and gather shape — strategy, SEW,
        shard count, per-shard piece lists, store trims — and nothing that
        depends on traced *values*.  Two plans of one kernel over different
        activation values must agree on it for resident-weight patching to
        be sound (:mod:`repro_torch.serve.block` asserts this at build time and
        falls back to a full reload on mismatch)."""
        return (self.strategy, self.sew, self.n_shards,
                tuple(tuple(p) for p in self.pieces),
                tuple(self.store_trims))

    def shard_oracles(self) -> List[np.ndarray]:
        """Each shard's traced reference output (eager numpy evaluation)."""
        return [b.oracle() for b in self.builders]

    def reordered(self, order: Sequence[int]) -> "PartitionPlan":
        """The same plan with shards permuted into dispatch order
        (``order[k]`` = which shard dispatches k-th).  Gather scatters by
        piece ranges, so any permutation reassembles bit-exactly; the
        scheduler uses this to put shards where the bus-serialized DMA
        ladder reaches them just in time."""
        perm = tuple(int(i) for i in order)
        assert sorted(perm) == list(range(self.n_shards)), \
            (perm, self.n_shards)
        return PartitionPlan(self.strategy, self.sew,
                             [self.builders[i] for i in perm],
                             [self.pieces[i] for i in perm],
                             list(self.store_trims), self.requested_tiles,
                             parent=self.parent)

    def gather(self, shard_outs: List[np.ndarray]) -> np.ndarray:
        """Reassemble per-shard outputs into the unsharded kernel's output:
        scatter each shard's pieces back into its original store's element
        range, then apply the same shaping rule as the single-tile path
        (stack equal-size stores, else concatenate)."""
        dt = alu.NP_DTYPES[self.sew]
        parts = [np.zeros(t, dt) for t in self.store_trims]
        for out, pieces in zip(shard_outs, self.pieces):
            flat = np.asarray(out).reshape(-1)
            off = 0
            for si, lo, hi in pieces:
                parts[si][lo:hi] = flat[off:off + (hi - lo)]
                off += hi - lo
        return _shape_parts(parts)

    def oracle(self) -> np.ndarray:
        """Gather of the shard oracles — must equal the unsharded oracle."""
        return self.gather(self.shard_oracles())


# ---------------------------------------------------------------------------
# Tape replay
# ---------------------------------------------------------------------------

def _map_arg(a, m: dict):
    """Translate a tape operand into the replayed tape's namespace."""
    if isinstance(a, _Node):
        return m[a.idx]
    if isinstance(a, _ConstScalar):
        return _ConstScalar(m[a.pool.idx], a.index, a.value)
    return a                            # raw Python scalar


def _replay(b: ProgramBuilder, keep: set,
            load_slice: Callable[[_Node], tuple],
            store_sel: List[Piece]) -> ProgramBuilder:
    """Re-trace a subset of the tape into a fresh builder.

    ``keep`` filters nodes; ``load_slice(node) -> (lo, end)`` slices load
    values (identity for the rows strategy); ``store_sel`` lists the shard's
    store pieces.  Replaying through the public ``ProgramBuilder`` methods
    re-runs the eager oracle evaluation on the sliced values, so the shard's
    oracle is bit-exact with the sliced original by construction, and the
    lowerings see a perfectly ordinary tape (same fusion/placement rules)."""
    nb = ProgramBuilder(b.sew, name=getattr(b, "name", "kernel"))
    m: dict[int, object] = {}       # original node idx -> replayed value
    for n in b.nodes:
        if n.idx not in keep:
            continue
        if n.op == "load":
            lo, end = load_slice(n)
            m[n.idx] = nb.load(n.val[lo:end], bank=n.bank)
        elif n.op == "cpool":
            m[n.idx] = nb.cpool(n.val)     # scalar taps replicate whole
        elif n.op == "slide_down":
            m[n.idx] = nb.slide_down(m[n.args[0].idx], n.amount)
        elif n.op == "mul":
            # mul may be a mac-chain head whose scalar tap sits in the
            # first slot; nb.mac(None, ...) reconstructs either form
            x, y = n.args
            m[n.idx] = nb.mac(None, _map_arg(x, m), _map_arg(y, m))
        elif n.op == "mac":
            acc, x, y = n.args
            m[n.idx] = nb.mac(m[acc.idx], _map_arg(x, m), _map_arg(y, m))
        else:                              # elementwise binop
            x, y = n.args
            m[n.idx] = nb.binop(n.op, m[x.idx], _map_arg(y, m))
    for si, lo, hi in store_sel:
        node, _trim = b.stores[si]
        nb.store(m[node.idx], n=hi - lo)
    return nb


# ---------------------------------------------------------------------------
# "rows" strategy: distribute stores, replay each shard's backward cone
# ---------------------------------------------------------------------------

def _cone(b: ProgramBuilder, roots: List[_Node]) -> set:
    seen: set = set()
    stack = list(roots)
    while stack:
        n = stack.pop()
        if n.idx in seen:
            continue
        seen.add(n.idx)
        for a in n.args:
            if isinstance(a, _Node):
                stack.append(a)
            elif isinstance(a, _ConstScalar):
                stack.append(a.pool)
    return seen


def _check_chunks(b: ProgramBuilder, chunks, total: int, tiles: int,
                  what: str) -> Tuple[int, ...]:
    """Validate an explicit per-shard chunk vector: positive entries that
    exactly cover ``total`` with at most ``tiles`` shards."""
    vec = tuple(int(c) for c in chunks)
    if not vec or any(c <= 0 for c in vec):
        raise PartitionError(
            f"{b.name}: explicit {what} chunk vector must be non-empty "
            f"with positive entries, got {vec}")
    if sum(vec) != total:
        raise PartitionError(
            f"{b.name}: explicit {what} chunk vector {vec} sums to "
            f"{sum(vec)}, must exactly cover {total}")
    if len(vec) > tiles:
        raise PartitionError(
            f"{b.name}: explicit {what} chunk vector has {len(vec)} "
            f"shards for {tiles} tiles")
    return vec


def _plan_rows(b: ProgramBuilder, tiles: int,
               counts: Optional[Sequence[int]] = None) -> PartitionPlan:
    S = len(b.stores)
    if S < 2:
        raise PartitionError(
            f"{b.name}: rows split needs >= 2 stores, tape has {S} — use "
            f"the element-axis strategy for single-output kernels")
    if counts is not None:
        counts = _check_chunks(b, counts, S, tiles, "rows")
    else:
        n = min(tiles, S)
        q, r = divmod(S, n)
        counts = tuple(q + (1 if s < r else 0) for s in range(n))
    builders, pieces = [], []
    off = 0
    for count in counts:
        sel = [(si, 0, b.stores[si][1]) for si in range(off, off + count)]
        keep = _cone(b, [b.stores[si][0] for si, _, _ in sel])
        builders.append(_replay(b, keep, lambda nd: (0, nd.ne), sel))
        pieces.append(sel)
        off += count
    return PartitionPlan("rows", b.sew, builders, pieces,
                         [t for _, t in b.stores], tiles, parent=b)


# ---------------------------------------------------------------------------
# "axis" strategy: word-aligned element chunks with slide halo
# ---------------------------------------------------------------------------

def slide_halo(b: ProgramBuilder) -> int:
    """Max cumulative ``slide_down`` read-ahead on any path from a load to
    a store — the halo each shard's loads must carry so slid values inside
    the chunk see their true neighbours, not the shard boundary."""
    halo = {n.idx: 0 for n in b.nodes}
    for n in reversed(b.nodes):        # tape is topologically ordered
        h = halo[n.idx]
        inc = n.amount if n.op == "slide_down" else 0
        for a in n.args:
            if isinstance(a, _Node):
                halo[a.idx] = max(halo[a.idx], h + inc)
    return max((halo[n.idx] for n in b.nodes if n.op == "load"), default=0)


#: Backwards-compatible private alias (pre-§11 name).
_slide_halo = slide_halo


def uniform_axis_chunks(L: int, tiles: int, lanes: int) -> Tuple[int, ...]:
    """The seed uniform chunking: ceil-packed word-aligned chunks, ragged
    tail last.  May occupy fewer shards than tiles when the word count
    does not divide (e.g. 9 words on 8 tiles -> [2,2,2,2,1] words)."""
    words_total = -(-L // lanes)
    words_per = -(-words_total // tiles)
    chunk = words_per * lanes
    out, lo = [], 0
    while lo < L:
        hi = min(lo + chunk, L)
        out.append(hi - lo)
        lo = hi
    return tuple(out)


def balanced_axis_chunks(L: int, tiles: int, lanes: int) -> Tuple[int, ...]:
    """Balanced word-aligned chunking: spread the word remainder across
    the first shards (divmod, largest first) so every requested tile gets
    work — the cost-model-preferred alternative the scheduler weighs
    against the ceil-packed seed chunking."""
    words_total = -(-L // lanes)
    n = min(tiles, words_total)
    q, r = divmod(words_total, n)
    out, lo = [], 0
    for s in range(n):
        hi = min(lo + (q + (1 if s < r else 0)) * lanes, L)
        out.append(hi - lo)
        lo = hi
    return tuple(c for c in out if c > 0)


def _plan_axis(b: ProgramBuilder, tiles: int,
               chunks: Optional[Sequence[int]] = None) -> PartitionPlan:
    vec = [n for n in b.nodes if n.op != "cpool"]
    nes = {n.ne for n in vec}
    if len(nes) != 1:
        raise PartitionError(
            f"{b.name}: no common data-parallel element axis: vector "
            f"nodes have lengths {sorted(nes)}")
    ne = nes.pop()
    trims = {t for _, t in b.stores}
    if len(trims) != 1:
        raise PartitionError(
            f"{b.name}: stores disagree on trimmed length "
            f"({sorted(trims)}): cannot split one element axis")
    L = trims.pop()
    lanes = 32 // b.sew
    if chunks is not None:
        chunks = _check_chunks(b, chunks, L, tiles, "axis")
    else:
        # word-aligned chunks: every shard but the last covers a whole
        # number of memory words, so shard programs differ only in the
        # ragged tail
        chunks = uniform_axis_chunks(L, tiles, lanes)
    halo = slide_halo(b)
    builders, pieces = [], []
    lo = 0
    for c in chunks:
        hi = lo + c
        end = min(hi + halo, ne)
        builders.append(_replay(
            b, {n.idx for n in b.nodes},
            lambda nd, lo=lo, end=end: (lo, end),
            [(si, lo, hi) for si in range(len(b.stores))]))
        pieces.append([(si, lo, hi) for si in range(len(b.stores))])
        lo = hi
    return PartitionPlan("axis", b.sew, builders, pieces,
                         [t for _, t in b.stores], tiles, parent=b)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def plan(builder: ProgramBuilder, tiles: int,
         partition: str = "auto",
         chunks: Optional[Sequence[int]] = None) -> PartitionPlan:
    """Shard a traced tape across ``tiles`` tiles.

    ``partition`` is ``"auto"`` (rows when the stores distribute evenly
    and the tape has no slides, else element-axis, else any applicable
    strategy), ``"rows"`` or ``"axis"``.  The plan may hold fewer shards
    than requested when the tape is too small (a 3-element vector cannot
    occupy 8 tiles); it never holds more.  ``tiles=1`` returns the
    original tape as a single trivial shard.

    ``chunks`` (optional) is an explicit per-shard chunk vector — element
    counts for ``"axis"``, store counts for ``"rows"`` — the scheduler's
    skewed split points.  It must name an explicit strategy (the vector's
    meaning depends on it) and exactly cover the axis/store set
    (:class:`PartitionError` otherwise; the partition-safety verifier
    re-checks coverage and halos on the built plan)."""
    if partition not in STRATEGIES:
        raise ValueError(f"unknown partition strategy {partition!r}: "
                         f"expected one of {STRATEGIES}")
    tiles = _check_tiles(tiles)
    if not builder.stores:
        raise PartitionError(f"{builder.name}: tape has no stores — "
                             f"nothing to shard")
    if chunks is not None and partition == "auto" and tiles > 1:
        raise ValueError(
            "an explicit chunk vector needs an explicit partition "
            "strategy ('rows' or 'axis'): the vector's meaning — store "
            "counts vs element counts — depends on it")
    if tiles == 1:
        pieces = [[(si, 0, t) for si, (_, t) in enumerate(builder.stores)]]
        return PartitionPlan("single", builder.sew, [builder], pieces,
                             [t for _, t in builder.stores], tiles,
                             parent=builder)
    if partition == "rows":
        return _plan_rows(builder, tiles, counts=chunks)
    if partition == "axis":
        return _plan_axis(builder, tiles, chunks=chunks)
    # auto: prefer structurally-identical row shards (same program on every
    # tile, trivially one bucket) when stores distribute evenly; slides are
    # column-structured (conv's shifted replicas), so their presence routes
    # to the element-axis strategy
    S = len(builder.stores)
    has_slide = any(n.op == "slide_down" for n in builder.nodes)
    if S > 1 and S >= tiles and S % tiles == 0 and not has_slide:
        try:
            return _plan_rows(builder, tiles)
        except PartitionError:
            pass
    errors = []
    for strat in (_plan_axis, _plan_rows):
        try:
            return strat(builder, tiles)
        except PartitionError as e:
            errors.append(str(e))
    raise PartitionError(f"{builder.name}: no applicable partition "
                         f"strategy: " + "; ".join(errors))
