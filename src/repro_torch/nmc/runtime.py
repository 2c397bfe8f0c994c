"""Async double-buffered NMC dispatch runtime (DESIGN.md §5.2).

The paper's system-level speedups depend on the memory-mode/compute-mode
duality: the host DMA streams the next image into one tile's memory while
another tile (or the same tile's shadow buffer) computes, so data movement
and execution overlap instead of serializing.  :class:`DispatchQueue` makes
that duality executable on top of :class:`repro_torch.nmc.pool.ResidentPool`:

* ``submit(tile, program, image, out_slice)`` returns an :class:`NMCFuture`
  immediately.  The image — if any — is *staged* onto the device as early
  as the tile's single shadow buffer allows (``init_state`` issues the
  host->device copy, the memory-mode DMA): at submit time when the
  shadow is free — even while the tile's previous program is still in
  flight — otherwise when the item's launch wave is assembled, right after
  the preceding wave dispatched.  Depth-2 double buffering, matching the
  load-ahead of ``timing.dispatch_cycles``; nothing blocks until the
  future is resolved.
* work items launch in *waves*: at each flush the head-of-line item of every
  pending tile installs its staged shadow buffer (buffer swap) and the wave
  dispatches through the shared bucketed jit cache as one batched
  ``ResidentPool.dispatch`` per bucket.  Per-tile FIFO order is preserved;
  chained programs on one tile land in consecutive waves.
* :meth:`NMCFuture.result` is the only synchronization point: it waits on
  the CUDA event recorded right after the item's wave launched (nothing to
  wait for on the CPU), extracts the output
  slice (memory-mode read, counted in the pool's ``bytes_moved``), applies
  the build's host-side ``post`` stage, and caches the result.

Two schedulers are pluggable via ``mode``:

* ``"overlapped"`` (default) — eager staging + lazy batched waves: the
  double-buffered pipeline whose modeled cost is
  ``timing.dispatch_cycles(stages, mode="overlapped")`` (max(dma, compute)
  per steady-state stage instead of their sum).
* ``"inorder"`` — the serial reference: each submit blocks on the tile's
  previous work before staging, then launches a single-item wave.  Results
  are bit-exact equal between the two modes (and to synchronous
  ``ResidentPool.dispatch``); only the overlap counters differ.

``submit_call(fn, *args)`` is the generic device-work flavor of the same
contract: it launches any PyTorch computation (CUDA work is already
asynchronous) and wraps the result in a :class:`DeviceFuture`, so host-side
consumers adopt the same block-only-at-resolution discipline.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.nmc.engine import get_engine
from repro_torch.nmc.pool import WORD_BYTES, ResidentPool
from repro_torch.nmc.program import Program

SCHEDULERS = ("inorder", "overlapped")


def _record_events(value) -> list:
    """One CUDA event recorded on the current stream of every CUDA device
    holding a tensor in ``value`` (a tensor or nested lists / tuples /
    dicts of them) — what a later wait blocks on.  Empty on the CPU."""
    devices, stack = set(), [value]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
    events = []
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return events


class NMCFuture:
    """Handle to one queued (tile, program) work item.

    ``result()`` resolves lazily: it flushes the queue if the item has not
    launched yet, blocks until the tile's captured final state is ready, and
    extracts/post-processes the output elements exactly like the synchronous
    ``ResidentPool`` load/dispatch/store path (bit-exact, same accounting).
    """

    def __init__(self, queue: "DispatchQueue", tile, program: Program,
                 out_slice: Optional[tuple[int, int]],
                 post: Optional[Callable]):
        self.queue = queue
        self.tile = tile
        self.program = program
        self.out_slice = out_slice
        self.post = post
        self._final = None          # device tensor captured at launch
        self._events = []           # CUDA events recorded after the launch
        self._out = None            # host elements, cached after resolution
        self._resolved = False
        self._done = False
        self._seq = None            # key in the queue's outstanding book

    @property
    def launched(self) -> bool:
        return self._final is not None

    @property
    def done(self) -> bool:
        """The item's computation is known-complete (it was blocked on)."""
        return self._done

    @property
    def resolved(self) -> bool:
        return self._resolved

    def state(self):
        """The tile's final device state for this item (launches if needed,
        blocks until the computation is done)."""
        if self._final is None:
            self.queue.flush()
        for ev in self._events:
            ev.synchronize()
        self._done = True
        return self._final

    def result(self) -> Optional[np.ndarray]:
        """Output elements (memory-mode read).  ``None`` when the item was
        submitted without an ``out_slice`` (state stays resident)."""
        if not self._resolved:
            final = self.state()
            if self.out_slice is not None:
                elems = get_engine(self.program.engine,
                                   self.queue.pool.backend).extract(
                    final, self.out_slice, self.program.sew)
                self.queue._account_store(self.out_slice)
                self._out = self.post(elems) if self.post else elems
            self._resolved = True
            self.queue.resolved += 1
            # resolved futures leave the queue's books: only callers who
            # keep the future (or the pool's residency) pin device state
            self.queue._outstanding.pop(self._seq, None)
        return self._out


class GatherFuture:
    """Future over a partitioned kernel wave (DESIGN.md §9): one
    :class:`NMCFuture` per tile shard plus the partition plan's ``gather``
    closure.  ``result()`` resolves every shard (the first resolution
    flushes the queue, launching the whole wave batched) and reassembles
    the caller's array — bit-exact vs the single-tile path by
    construction (tests/test_partition.py)."""

    def __init__(self, futures, gather: Callable):
        self.futures = list(futures)
        self._gather = gather
        self._out = None
        self._resolved = False

    @property
    def launched(self) -> bool:
        return all(f.launched for f in self.futures)

    @property
    def done(self) -> bool:
        return all(f.done for f in self.futures)

    @property
    def resolved(self) -> bool:
        return self._resolved

    def result(self) -> np.ndarray:
        if not self._resolved:
            self._out = self._gather([f.result() for f in self.futures])
            self._resolved = True
        return self._out


class DeviceFuture:
    """Future over an already-launched PyTorch computation (CUDA work is
    asynchronous): ``result()`` blocks on events recorded at launch."""

    def __init__(self, value):
        self._value = value
        self._events = _record_events(value)
        self._ready = False

    @property
    def value(self):
        """The launched result *without* blocking — consumers that only
        force part of it can keep the rest in flight."""
        return self._value

    def result(self):
        if not self._ready:
            for ev in self._events:
                ev.synchronize()
            self._ready = True
        return self._value


@dataclasses.dataclass
class _WorkItem:
    tile: object
    program: Program
    image: object                   # host image awaiting staging | None
    staged: object                  # staged device state (shadow buffer) | None
    engine: str
    future: NMCFuture
    prev: Optional[NMCFuture]       # preceding future on this tile, if any
    backend: Optional[str] = None   # executor override for this item's wave
    patch: object = None            # (word_start, words) spans applied onto
                                    # the resident state at launch — the
                                    # steady-state serving path (weights
                                    # resident, activations patched per call)


class DispatchQueue:
    """Asynchronous double-buffered dispatch over a resident tile array.

    Counters (asserted by tests/benchmarks):

    * ``submitted`` / ``launched`` / ``resolved`` — work-item lifecycle.
    * ``waves`` — batched launch rounds (>= 1 ``ResidentPool.dispatch``
      each; one per distinct bucket in the wave).
    * ``staged_while_busy`` — images staged into a tile's shadow buffer
      while its previous program was still unresolved: the double-buffering
      overlap events.  Always 0 under the ``inorder`` scheduler.
    * ``calls`` — generic device computations launched via ``submit_call``.
    """

    def __init__(self, pool: ResidentPool | None = None,
                 mode: str = "overlapped"):
        assert mode in SCHEDULERS, mode
        self.pool = pool if pool is not None else ResidentPool()
        self.mode = mode
        self._queued: list[_WorkItem] = []
        self._last: dict[object, NMCFuture] = {}  # tile -> FIFO tail
        self._outstanding: dict[int, NMCFuture] = {}   # pruned at result()
        self._seq = itertools.count()
        self._staged_pending: dict[object, int] = {}  # tile -> staged count
        self.submitted = 0
        self.launched = 0
        self.resolved = 0
        self.waves = 0
        self.mixed_engine_waves = 0     # waves mixing Caesar+Carus shards
        self.staged_while_busy = 0
        self.calls = 0

    # -- submission ----------------------------------------------------------
    def submit(self, tile, program: Program, image=None,
               out_slice: Optional[tuple[int, int]] = None,
               post: Optional[Callable] = None,
               backend: Optional[str] = None,
               patch: Optional[list] = None) -> NMCFuture:
        """Queue one work item; returns its future immediately.

        ``image`` (optional) is the host image to stage into the tile's
        shadow buffer, installed as the tile's resident state when the item
        launches.  Staging is double-buffered: it happens as early as
        possible — at submit when the tile's single shadow buffer is free,
        otherwise when the item's launch wave is assembled (right after the
        previous wave dispatched, so the transfer overlaps the in-flight
        compute either way).  Without an image the program chains against
        the tile's current resident state.  ``backend`` (optional) pins the
        item to an executor ("torch"/"cuda"); waves group per backend at
        launch, default follows the pool.

        ``patch`` (optional) is a list of ``(word_start, words)`` spans
        applied onto the tile's resident state when the item launches
        (after any image install): the steady-state resident-serving path —
        weights stay on the tile, only the per-call activation words move
        (``ResidentPool.patch`` accounting)."""
        from repro_torch.nmc.check import assert_submittable
        # last-line structural floor of the static checking contract
        # (DESIGN.md §11): full verification belongs at lowering time
        assert_submittable(program)
        prev = self._last.get(tile)
        if image is not None and self.mode == "inorder" \
                and prev is not None and not prev.done:
            prev.state()            # serial DMA: wait before staging
        fut = NMCFuture(self, tile, program, out_slice, post)
        item = _WorkItem(tile, program, image, None, program.engine, fut,
                         prev, backend, patch)
        # depth-2 double buffering: at most one staged shadow buffer per
        # tile ahead of the resident (possibly computing) state
        if image is not None and not self._staged_pending.get(tile):
            self._stage(item)
        self._queued.append(item)
        self._last[tile] = fut
        fut._seq = next(self._seq)
        self._outstanding[fut._seq] = fut
        self.submitted += 1
        if self.mode == "inorder":
            self.flush()
        return fut

    def _stage(self, item: _WorkItem) -> None:
        """Start the async host->device copy into the tile's shadow buffer
        (memory-mode DMA); counted as overlapped when the tile's previous
        program is still unresolved at this moment."""
        item.staged = get_engine(item.engine,
                                 self.pool.backend).init_state(item.image)
        item.image = None
        self._staged_pending[item.tile] = \
            self._staged_pending.get(item.tile, 0) + 1
        if item.prev is not None and not item.prev.done:
            self.staged_while_busy += 1

    def submit_call(self, fn: Callable, *args, **kwargs) -> DeviceFuture:
        """Launch a generic PyTorch computation as queued device work (CUDA
        launches are asynchronous); block only at ``result()``."""
        self.calls += 1
        return DeviceFuture(fn(*args, **kwargs))

    # -- launching -----------------------------------------------------------
    def flush(self) -> None:
        """Launch every queued item, wave by wave (per-tile FIFO preserved:
        each wave takes the head-of-line item of every pending tile)."""
        while self._queued:
            wave, rest, seen = [], [], set()
            for it in self._queued:
                (rest if it.tile in seen else wave).append(it)
                seen.add(it.tile)
            self._queued = rest
            self._launch_wave(wave)

    def _launch_wave(self, wave: list[_WorkItem]) -> None:
        for it in wave:             # buffer swap: shadow -> resident state
            if it.image is not None:
                self._stage(it)     # deferred staging (shadow was occupied)
            if it.staged is not None:
                self.pool.install(it.tile, it.engine, it.staged)
                self._staged_pending[it.tile] -= 1
            if it.patch is not None:
                # partial memory-mode write on top of the resident state
                # (after any install, so patch words win over image words)
                self.pool.patch(it.tile, it.patch)
        by_backend: dict[str, list[_WorkItem]] = {}
        for it in wave:
            by_backend.setdefault(it.backend, []).append(it)
        for backend, items in by_backend.items():
            self.pool.dispatch([(it.tile, it.program) for it in items],
                               backend=backend)
        for it in wave:             # capture this wave's final state per item
            it.future._final = self.pool.state(it.tile)
        events = _record_events([it.future._final for it in wave])
        for it in wave:             # resolution waits on the wave's launch
            it.future._events = events
        self.launched += len(wave)
        self.waves += 1
        if len({it.program.engine for it in wave}) > 1:
            # a heterogeneous wave (DESIGN.md §14): Caesar and Carus
            # shards launched together; the pool batches per engine
            # bucket group inside the one dispatch
            self.mixed_engine_waves += 1

    def drain(self) -> None:
        """Flush and resolve every outstanding future (chained per-tile
        futures included, not just the FIFO tails)."""
        self.flush()
        for fut in list(self._outstanding.values()):
            fut.result()            # each pops itself from the book

    # -- convenience ---------------------------------------------------------
    def run_builds(self, builds: list,
                   n_tiles: Optional[int] = None) -> list[np.ndarray]:
        """EngineBuild list -> output elements through the async path:
        submit everything (staging all images up front), then resolve —
        bit-exact equal to ``ResidentPool.run_builds``.

        ``n_tiles`` feeds the builds round-robin through a fixed array of
        that many tiles (the paper's continuously-fed tile array): item
        ``k`` stages into tile ``k % n_tiles``'s shadow buffer while the
        tile's previous program is still in flight — the double-buffering
        the ``staged_while_busy`` counter measures.  Default (``None``)
        gives every build its own fresh tile."""
        futs = []
        for k, eb in enumerate(builds):
            # fresh tile ids draw from the wrapped pool's counter so they
            # can never collide with ResidentPool.run_builds (or another
            # queue) allocating on the same pool
            tile = (("lane", k % n_tiles) if n_tiles
                    else ("build", next(self.pool._ids)))
            futs.append(self.submit(tile, eb.program, image=eb.mem,
                                    out_slice=eb.out_slice, post=eb.post))
        return [f.result() for f in futs]

    # -- accounting ----------------------------------------------------------
    def _account_store(self, out_slice: tuple[int, int]) -> None:
        # mirrors ResidentPool.store: word-granular (n_words * 4), so
        # sub-word element tails at SEW 8/16 cost their whole last word
        self.pool.stores += 1
        self.pool.bytes_moved += int(out_slice[1]) * WORD_BYTES
