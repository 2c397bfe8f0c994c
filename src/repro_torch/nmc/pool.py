"""Batched multi-tile NMC executors (DESIGN.md §5).

The paper's architectures are *scalable*: an edge node instantiates arrays of
identical NM-Caesar / NM-Carus tiles across its SRAM macros, each running its
own program against its own memory.  This module models that at three levels:

* :class:`TilePool` — T independent tiles execute T same-shape programs in
  one batched executor (the plain PyTorch engines batched over tiles, or
  one CUDA kernel launch per wave when ``backend="cuda"``), with executor
  handles cached per exact ``(engine, sew, n_instr, n_tiles, backend)``.
* :class:`BucketedPool` — the shape-bucketed scheduler: instruction streams
  NOP-pad to power-of-two buckets (:func:`repro_torch.nmc.program.instr_bucket`)
  and partial tile batches pad to power-of-two tile counts
  (:func:`tile_bucket`, extra lanes replicated and masked off on readback),
  so a heterogeneous kernel sweep builds one executor per **(engine, sew,
  instr-bucket, tile-bucket)** instead of one per exact shape/count pair.
* :class:`ResidentPool` — persistently-resident tile memories: per-tile
  state stays in device tensors across dispatches (the paper's memory-mode
  / compute-mode duality), with explicit load/store accounting so
  benchmarks can assert that steady-state dispatch moves only instruction
  bytes.

Compilation discipline: ``compiles`` counts executor-cache misses (the
JAX reference's trace-cache misses, with identical accounting), and
``pad_waste`` / ``bytes_moved`` quantify the cost of the bucketing trade —
benchmarks and tests assert on all three exactly where the property is
claimed (one compile per bucket over a grouped sweep).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.core.caesar import CaesarConfig
from repro_torch.nmc.engine import get_engine, resolve_backend
from repro_torch.nmc.program import (PROG_DTYPE, Program, instr_bucket,
                               stack_programs)

WORD_BYTES = 4
CAESAR_WORDS = CaesarConfig().mem_words


def tile_bucket(n_tiles: int) -> int:
    """Power-of-two tile-count bucket rule: a partial batch pads up to the
    next power of two (replicated lanes, outputs discarded) so it reuses the
    padded-batch trace instead of re-tracing per tile count.  Same rule as
    :func:`repro_torch.nmc.program.instr_bucket`, delegated so the two bucketing
    dimensions can never drift apart."""
    return instr_bucket(n_tiles)


def _device_arrays(programs: list[Program], device) -> dict:
    """Stack same-shape programs into int32 ``[T, n_instr]`` field tensors
    on ``device``.  Caesar word addresses must lie inside the image: the
    CUDA kernel takes them as given (no clamping), so a wave that would
    index outside it is rejected here, on the host, before upload."""
    arrays = stack_programs(programs)
    if programs[0].engine == "caesar":
        for k in ("dest", "src1", "src2"):
            a = arrays[k]
            if a.size and (int(a.min()) < 0 or int(a.max()) >= CAESAR_WORDS):
                raise ValueError(
                    f"Caesar {k} address outside the {CAESAR_WORDS}-word "
                    f"image: [{int(a.min())}, {int(a.max())}]")
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


class TilePool:
    """Dispatch batches of same-shape NMC programs over virtual tiles.

    The pool is stateless between dispatches (tiles own no persistent
    memory); callers hand in one initial state per program and get the final
    state back, in input order.  Heterogeneous batches are grouped by shape
    key internally, so a full kernel sweep can be thrown at :meth:`run` in
    one call and same-shape instances (e.g. xor/add/mul/relu at one SEW)
    share a single compile and a single batched device dispatch.

    Grouping/padding policy lives in three overridable hooks
    (:meth:`_group_key`, :meth:`_pad_programs`, :meth:`_pad_tiles`);
    the base class groups by *exact* ``Program.shape_key`` and never pads —
    :class:`BucketedPool` overrides all three.
    """

    def __init__(self, donate: bool = False, backend: str = "auto"):
        self._cache: dict[tuple, object] = {}
        self._donate = donate
        self.backend = resolve_backend(backend)
        self.compiles = 0          # distinct executors (cache misses)
        self.dispatches = 0        # batched device executions
        self.programs_run = 0      # total (real) tile-programs executed

    # -- executor (kernel-handle) cache --------------------------------------
    def _batched_fn(self, shape_key: tuple, n_tiles: int,
                    backend: str | None = None):
        backend = self.backend if backend is None \
            else resolve_backend(backend)
        key = (*shape_key, n_tiles, backend)
        fn = self._cache.get(key)
        if fn is None:
            engine_name, sew, _ = shape_key
            engine = get_engine(engine_name, backend)
            # every backend runs the whole tile batch in one call: the
            # plain engines batch over tiles, "cuda" launches one kernel
            fn = engine.batched_fn(sew, n_tiles, donate=self._donate)
            self._cache[key] = fn
            self.compiles += 1
        return fn

    @property
    def shape_keys_compiled(self) -> set[tuple]:
        return {k[:3] for k in self._cache}

    # -- grouping / padding hooks (overridden by BucketedPool) ---------------
    def _group_key(self, p: Program) -> tuple:
        return p.shape_key

    def _pad_programs(self, programs: list[Program]) -> list[Program]:
        return programs

    def _pad_tiles(self, n_tiles: int) -> int:
        return n_tiles

    def _account(self, programs: list[Program], n_tiles: int,
                 batch_state, final) -> None:
        """Counter hook: called once per batched dispatch with the *real*
        (unreplicated) padded programs and the padded tile count."""

    # -- execution -----------------------------------------------------------
    def run(self, programs: list[Program], states: list) -> list[np.ndarray]:
        """Run ``programs[i]`` against ``states[i]``; return final states."""
        assert len(programs) == len(states)
        by_key: dict[tuple, list[int]] = {}
        for i, p in enumerate(programs):
            by_key.setdefault(self._group_key(p), []).append(i)
        out: list = [None] * len(programs)
        for idxs in by_key.values():
            group = self._pad_programs([programs[i] for i in idxs])
            n_tiles = self._pad_tiles(len(idxs))
            engine = get_engine(group[0].engine, self.backend)
            fn = self._batched_fn(group[0].shape_key, n_tiles)
            tile_states = [engine.init_state(states[i]) for i in idxs]
            # padding lanes replicate tile 0; their outputs are masked off
            # below (only real lanes are written back, in input order)
            tile_states += [tile_states[0]] * (n_tiles - len(idxs))
            batch_state = torch.stack(tile_states)
            padded = group + [group[0]] * (n_tiles - len(idxs))
            batch_arrays = _device_arrays(padded, batch_state.device)
            final = fn(batch_state, batch_arrays).cpu().numpy()
            self.dispatches += 1
            self.programs_run += len(idxs)
            self._account(group, n_tiles, batch_state, final)
            for t, i in enumerate(idxs):
                out[i] = final[t]
        return out

    def run_builds(self, builds: list) -> list[np.ndarray]:
        """Run a list of :class:`repro_torch.core.programs.EngineBuild` instances
        (each tagged with engine/sew by its kernel builder) and return each
        build's output *elements*, with its host-side ``post`` stage applied
        — bit-identical to the single-instance ``run_build`` path."""
        programs = [eb.program for eb in builds]
        finals = self.run(programs, [eb.mem for eb in builds])
        outs = []
        for eb, prog, final in zip(builds, programs, finals):
            elems = get_engine(prog.engine, self.backend).extract(
                final, eb.out_slice, prog.sew)
            outs.append(eb.post(elems) if eb.post else elems)
        return outs


class BucketedPool(TilePool):
    """Shape-bucketed :class:`TilePool` (the scheduler of DESIGN.md §5).

    Programs group by :attr:`repro_torch.nmc.program.Program.bucket_key`
    ``(engine, sew, instr_bucket(n_instr))`` and NOP-pad to the bucket;
    partial batches pad to power-of-two tile counts.  A heterogeneous sweep
    therefore compiles at most once per (engine, sew, instr-bucket,
    tile-bucket) — O(#buckets), not O(#distinct shapes x tile counts).

    Extra counters (asserted by benchmarks/tests):

    * ``pad_waste``   — instruction slots spent on padding: NOP tails of
      real programs plus the whole streams of replicated padding lanes.
    * ``bytes_moved`` — host<->device traffic of the stateless dispatch
      path: initial-state upload + instruction-stream upload + final-state
      download (the von-Neumann tax :class:`ResidentPool` removes).
    """

    def __init__(self, donate: bool = False, backend: str = "auto"):
        super().__init__(donate=donate, backend=backend)
        self.pad_waste = 0
        self.useful_instrs = 0
        self.bytes_moved = 0

    def _group_key(self, p: Program) -> tuple:
        return p.bucket_key

    def _pad_programs(self, programs: list[Program]) -> list[Program]:
        from repro_torch.nmc.check import assert_wave
        bucket = instr_bucket(max(p.n_instr for p in programs))
        padded = [p.pad_to(bucket) for p in programs]
        # wave-level floor of the static checking contract (DESIGN.md §11):
        # one shape key across the padded wave, every program submittable
        assert_wave(padded)
        return padded

    def _pad_tiles(self, n_tiles: int) -> int:
        return tile_bucket(n_tiles)

    def _account(self, programs, n_tiles, batch_state, final) -> None:
        bucket = programs[0].n_instr
        real = sum(p.n_instr - p.n_nops for p in programs)
        self.pad_waste += bucket * n_tiles - real
        self.useful_instrs += real
        self.bytes_moved += (n_tiles * bucket * PROG_DTYPE.itemsize
                             + batch_state.numel() * WORD_BYTES
                             + final.size * WORD_BYTES)


class ResidentPool:
    """Persistently-resident tile array over a :class:`BucketedPool`.

    Models the paper's memory-mode / compute-mode duality: a tile's SRAM
    macro is *loaded* once (memory-mode write), then arbitrarily many
    programs execute against the resident state (compute mode) with only
    instruction streams crossing the host/device boundary, and results are
    *stored* back explicitly (memory-mode read).  Between dispatches the
    per-tile state lives in device tensors; the batched executor takes the
    freshly stacked wave buffer as donated, and the CUDA kernels update it
    in place.

    Accounting: ``bytes_moved`` counts only explicit host<->device traffic —
    ``load`` (full image), ``dispatch`` (instruction bytes), ``store``
    (result words) — so benchmarks can assert that steady-state dispatch
    cost is O(program), not O(tile memory).
    """

    def __init__(self, pool: BucketedPool | None = None,
                 backend: str = "auto"):
        self.pool = pool if pool is not None \
            else BucketedPool(donate=True, backend=backend)
        self._engine: dict[object, str] = {}   # tile id -> engine name
        self._state: dict[object, object] = {}  # tile id -> resident state
        self._ids = itertools.count()
        self.loads = 0
        self.stores = 0
        self.dispatches = 0
        self.dispatch_calls = 0      # dispatch() invocations (launch waves)
        self.programs_run = 0
        self.bytes_moved = 0
        self.patches = 0             # partial memory-mode writes (word spans)
        self.patch_bytes = 0         # bytes moved by patches (also counted
                                     # in bytes_moved)

    @property
    def compiles(self) -> int:
        return self.pool.compiles

    @property
    def tiles(self) -> list:
        return list(self._state)

    @property
    def backend(self) -> str:
        return self.pool.backend

    def state(self, tile) -> torch.Tensor:
        """The tile's resident device buffer (memory-mode view)."""
        return self._state[tile]

    # -- memory mode ---------------------------------------------------------
    def load(self, tile, engine: str, image) -> None:
        """Memory-mode write: host image -> resident tile memory."""
        self.install(tile, engine,
                     get_engine(engine, self.backend).init_state(image))

    def install(self, tile, engine: str, state) -> None:
        """Adopt an already-staged device buffer as the tile's resident
        state (the buffer swap of the double-buffered dispatch runtime:
        :mod:`repro_torch.nmc.runtime` stages images asynchronously and installs
        them at launch time).  Accounted exactly like ``load``."""
        self._engine[tile] = engine
        self._state[tile] = state
        self.loads += 1
        self.bytes_moved += int(state.numel()) * WORD_BYTES

    def patch(self, tile, updates: list[tuple[int, np.ndarray]]) -> None:
        """Memory-mode *partial* write: apply ``(word_start, words)`` spans
        onto the tile's resident state without re-uploading the full image.

        This is the steady-state serving path (DESIGN.md §12): weights stay
        resident across calls, only the per-call activation words cross the
        bus.  Accounted under dedicated counters (``patches`` /
        ``patch_bytes``, also rolled into ``bytes_moved``) and *not* under
        ``loads`` — so residency proofs can assert weights DMA'd onto the
        tile once while activations streamed per call."""
        assert tile in self._state, \
            f"patch of tile {tile!r} with no resident state — load first"
        state = self._state[tile]
        # a fresh buffer, not an in-place write: a launched future may still
        # hold the previous state tensor as its result
        flat = state.reshape(-1).clone()
        nw = 0
        for lo, words in updates:
            w = torch.as_tensor(np.asarray(words, np.int32).reshape(-1),
                                device=flat.device)
            assert int(lo) >= 0 and int(lo) + w.numel() <= flat.numel(), \
                (tile, lo, int(w.numel()), int(flat.numel()))
            flat[int(lo):int(lo) + w.numel()] = w
            nw += int(w.numel())
        self._state[tile] = flat.reshape(state.shape)
        self.patches += 1
        self.patch_bytes += nw * WORD_BYTES
        self.bytes_moved += nw * WORD_BYTES

    def store(self, tile, out_slice: tuple[int, int], sew: int) -> np.ndarray:
        """Memory-mode read: resident output words -> host elements."""
        engine = get_engine(self._engine[tile], self.backend)
        elems = engine.extract(self._state[tile], out_slice, sew)
        self.stores += 1
        # word-granular accounting: ``out_slice`` is (word_start, n_words),
        # and the 32-bit system bus moves whole words — a sub-word element
        # tail at SEW 8/16 (common for gathered shard outputs) still costs
        # its full last word.  Locked by tests/test_runtime.py.
        self.bytes_moved += int(out_slice[1]) * WORD_BYTES
        return elems

    # -- compute mode --------------------------------------------------------
    def dispatch(self, assignments: list[tuple],
                 backend: str | None = None) -> None:
        """Execute ``(tile, program)`` pairs against the resident states.

        Grouped by bucket key and batched through the shared jit cache like
        :class:`BucketedPool`; final states replace the resident buffers
        without ever leaving the device.  Only the instruction streams are
        uploaded (counted in ``bytes_moved``).  ``backend`` overrides the
        wrapped pool's default executor ("torch"/"cuda") for this wave.

        One dispatch is one parallel step across the tile array, so a tile
        may appear at most once per call — chained programs on one tile are
        sequential ``dispatch`` calls (each sees the previous final state).
        A mixed-engine wave (DESIGN.md §14) rides one call: its Caesar and
        Carus shards fall into separate bucket-key groups below (the
        bucket key carries the engine), each batched on its own
        interpreter, but they remain one parallel step — ``dispatch_calls``
        counts the steps, ``dispatches`` the per-group executions."""
        self.dispatch_calls += 1
        seen = set()
        by_key: dict[tuple, list[tuple]] = {}
        for tile, prog in assignments:
            assert tile not in seen, \
                f"tile {tile!r} assigned twice in one dispatch — chain " \
                f"programs via sequential dispatch() calls"
            seen.add(tile)
            assert self._engine[tile] == prog.engine, \
                (tile, self._engine[tile], prog.engine)
            by_key.setdefault(prog.bucket_key, []).append((tile, prog))
        from repro_torch.nmc.check import assert_wave
        for key, group in by_key.items():
            tiles = [t for t, _ in group]
            bucket = key[2]
            progs = [p.pad_to(bucket) for _, p in group]
            # wave-level floor of the static checking contract (§11)
            assert_wave(progs)
            tb = tile_bucket(len(tiles))
            states = [self._state[t] for t in tiles]
            states += [states[0]] * (tb - len(tiles))
            progs += [progs[0]] * (tb - len(tiles))
            # the stacked wave buffer is fresh, so the kernels may update
            # it in place (donated); tiles then hold views of its rows
            batch_state = torch.stack(states)
            batch_arrays = _device_arrays(progs, batch_state.device)
            fn = self.pool._batched_fn(progs[0].shape_key, tb,
                                       backend=backend)
            final = fn(batch_state, batch_arrays)    # stays on device
            for t, tile in enumerate(tiles):
                self._state[tile] = final[t]
            self.dispatches += 1
            self.programs_run += len(tiles)
            self.bytes_moved += tb * bucket * PROG_DTYPE.itemsize
            # ragged-tail visibility: resident waves report padding waste
            # into the wrapped pool's counters exactly like stateless runs
            # (NOP tails of real programs + whole replicated padding lanes)
            real = sum(p.n_instr - p.n_nops for _, p in group)
            self.pool.pad_waste += bucket * tb - real
            self.pool.useful_instrs += real

    # -- convenience ---------------------------------------------------------
    def run_builds(self, builds: list, queue=None) -> list[np.ndarray]:
        """EngineBuild list -> output elements via load/dispatch/store —
        bit-identical to ``TilePool.run_builds`` (and the single-program
        path), but leaving every tile memory resident afterwards.

        With ``queue`` (a :class:`repro_torch.nmc.runtime.DispatchQueue` wrapping
        *this* pool) the builds go through the async double-buffered path
        instead: all images stage up front, waves launch batched, and
        results materialize at future resolution — bit-exact either way."""
        if queue is not None:
            assert queue.pool is self, "queue must wrap this ResidentPool"
            return queue.run_builds(builds)
        tiles = []
        for eb in builds:
            tile = ("build", next(self._ids))
            self.load(tile, eb.program.engine, eb.mem)
            tiles.append(tile)
        self.dispatch([(t, eb.program) for t, eb in zip(tiles, builds)])
        outs = []
        for t, eb in zip(tiles, builds):
            elems = self.store(t, eb.out_slice, eb.program.sew)
            outs.append(eb.post(elems) if eb.post else elems)
        return outs
