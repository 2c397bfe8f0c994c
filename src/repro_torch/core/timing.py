"""Cycle-accurate timing models for NM-Caesar, NM-Carus and the CPU baseline.

The models are *mechanistic*: cycle counts are derived from the actual
instruction streams/traces produced by :mod:`repro_torch.core.programs` using the
microarchitectural rules of the paper (Sections III-A2 and III-B2), with the
constants documented in :mod:`repro_torch.core.constants`.  They are validated
against every relative claim in Table V / Table VIII / Fig. 12 in
``benchmarks/table_v.py`` (results in EXPERIMENTS.md §Paper-validation).

Since the unified-IR refactor (DESIGN.md §5) both engines are costed through
one entry point, :func:`program_cycles`, which walks a
:class:`repro_torch.nmc.program.Program`'s structured-array entries; the legacy
``caesar_cycles`` / ``carus_cycles`` signatures survive as thin wrappers over
it (they accept both IR-emitting builds and hand-rolled legacy streams).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import constants as C
from repro_torch.core import isa
from repro_torch.core.caesar import CaesarConfig
from repro_torch.core.carus import CarusConfig
from repro_torch.core.isa import VOp
from repro_torch.nmc.program import Program


@dataclasses.dataclass(frozen=True)
class TimingReport:
    cycles: float            # NMC-engine cycles (incl. kernel overhead)
    host_cycles: float       # host-CPU / eCPU-serial cycles (e.g. h-pooling)
    n_instrs: int
    detail: dict

    @property
    def total_cycles(self) -> float:
        return self.cycles + self.host_cycles

    def seconds(self, f_hz: float = C.F_CLK_BENCH_HZ) -> float:
        return self.total_cycles / f_hz


# ---------------------------------------------------------------------------
# Unified IR costing — one code path for both engines
# ---------------------------------------------------------------------------

def program_cycles(prog: Program, host_cycles: float = 0.0,
                   cfg=None) -> TimingReport:
    """Cost a unified-IR program with the engine's microarchitectural rules."""
    if prog.engine == "caesar":
        return _caesar_program_cycles(prog, host_cycles,
                                      cfg or CaesarConfig())
    return _carus_program_cycles(prog, host_cycles, cfg or CarusConfig())


def _caesar_program_cycles(prog: Program, host_cycles: float,
                           cfg: CaesarConfig) -> TimingReport:
    # Section III-A2: one op per 2 cycles sustained when the operands sit in
    # opposite banks; +1 serialized-fetch cycle when they collide.  Padding
    # NOPs (bucketed scheduler) are zero-cost: the DMA stream simply ends.
    e = prog.entries
    e = e[e["op"] != int(isa.CaesarOp.NOP)]
    same = int(np.count_nonzero(e["src1"] // cfg.bank_words
                                == e["src2"] // cfg.bank_words))
    cycles = (C.CAESAR_OFFLOAD_CYCLES + same * C.CAESAR_SAME_BANK_CYCLES
              + (len(e) - same) * C.CAESAR_CYCLES_PER_OP)
    return TimingReport(float(cycles), host_cycles, len(e),
                        {"same_bank_ops": same})


def _port_accesses(vop: VOp, mode: int) -> int:
    """VRF bank-port words touched per result word (single-port banks)."""
    opmode = mode & 0x3
    if vop == VOp.VMACC:
        return 4 if opmode == isa.MODE_VV else 3   # reads vd + srcs, writes vd
    if vop == VOp.VMV:
        return 1 if opmode != isa.MODE_VV else 2   # splat: write-only
    if vop in (VOp.VSLIDEUP, VOp.VSLIDEDOWN):
        return 2
    if opmode == isa.MODE_VV:
        return 3
    return 2                                        # vx / vi

def _carus_walk(prog: Program, cfg: CarusConfig):
    """Yield (vop, mode, vl) per entry, tracking the dynamic VL carry."""
    vl = cfg.vlmax(prog.sew)
    for op, sval1, mode in zip(prog.entries["op"], prog.entries["sval1"],
                               prog.entries["mode"]):
        vop = isa.VOP_COMPACT[int(op)]
        if vop == VOp.VSETVL:
            vl = min(int(sval1), cfg.vlmax(prog.sew))
        yield vop, int(mode), vl


def _carus_program_cycles(prog: Program, host_cycles: float,
                          cfg: CarusConfig) -> TimingReport:
    sew = prog.sew
    cycles = float(C.CARUS_KERNEL_OVERHEAD_CYCLES)
    busy = 0.0
    for vop, mode, vl in _carus_walk(prog, cfg):
        if vop == VOp.VNOP:
            continue                     # padding: never issued, zero cost
        if vop == VOp.VSETVL:
            cycles += 1
            continue
        if vop in (VOp.EMVV, VOp.EMVX):
            cycles += C.CARUS_ISSUE_CYCLES   # overlapped with in-flight vector
            continue
        tclass = isa.VOP_TIMING_CLASS[vop]
        alu_w = C.CARUS_ALU_WORD_CYCLES[tclass][sew]
        port_w = _port_accesses(vop, mode)
        words_per_lane = math.ceil(math.ceil(vl * sew / 32) / cfg.n_lanes)
        instr_cycles = max(alu_w, port_w) * words_per_lane
        cycles += max(instr_cycles, C.CARUS_ISSUE_CYCLES)
        busy += instr_cycles
    return TimingReport(cycles, host_cycles, prog.n_instr - prog.n_nops,
                        {"vector_busy": busy})


def program_vrf_accesses(prog: Program, cfg: CarusConfig | None = None) -> int:
    """Total VRF word accesses of a Carus program (drives the energy model)."""
    assert prog.engine == "carus", prog.engine
    cfg = cfg or CarusConfig()
    acc = 0
    for vop, mode, vl in _carus_walk(prog, cfg):
        if vop in (VOp.VSETVL, VOp.VNOP):
            continue
        if vop in (VOp.EMVV, VOp.EMVX):
            acc += 1
            continue
        acc += _port_accesses(vop, mode) * math.ceil(vl * prog.sew / 32)
    return acc


def _program_of(eb, engine: str, sew: int) -> Program:
    """IR program of an EngineBuild; accepts hand-built streams too.

    Untagged builds (``eb.engine`` unset) can hold any entry format —
    legacy tuples, legacy CARUS_TRACE_DTYPE scalars, or raw PROG_DTYPE
    entries — so the caller's engine knowledge is passed through rather
    than relying on the build's own (auto-detecting) ``program`` property.
    """
    if getattr(eb, "engine", ""):
        prog = eb.program
    else:
        prog = Program.from_legacy(getattr(eb, "stream", eb), sew, engine)
    assert prog.engine == engine, (prog.engine, engine)
    return prog.with_sew(sew)


# ---------------------------------------------------------------------------
# Legacy per-engine entry points (thin wrappers over the IR path)
# ---------------------------------------------------------------------------

def caesar_cycles(eb, cfg: CaesarConfig | None = None) -> TimingReport:
    prog = _program_of(eb, "caesar", getattr(eb, "sew", 0) or 32)
    return program_cycles(prog, eb.host_cycles, cfg)


def carus_cycles(eb, sew: int, cfg: CarusConfig | None = None) -> TimingReport:
    return program_cycles(_program_of(eb, "carus", sew), eb.host_cycles, cfg)


def carus_vrf_accesses(eb, sew: int, cfg: CarusConfig | None = None) -> int:
    return program_vrf_accesses(_program_of(eb, "carus", sew), cfg)


# ---------------------------------------------------------------------------
# Dispatch-pipeline cost model: serial vs overlapped (double-buffered) DMA
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageCost:
    """One dispatch stage of the host-orchestration pipeline: DMA the image
    in (memory-mode write), run the program (compute mode), DMA the result
    out (memory-mode read).  Cycle legs are modeled independently so the
    scheduler modes below can serialize or overlap them."""

    name: str
    dma_in_cycles: float
    compute_cycles: float
    dma_out_cycles: float

    @property
    def serial_cycles(self) -> float:
        return self.dma_in_cycles + self.compute_cycles + self.dma_out_cycles


def dma_cycles(n_bytes: int) -> float:
    """Streaming host<->tile transfer cost on the 32-bit system bus."""
    return float(n_bytes) / C.DMA_BYTES_PER_CYCLE


def stage_cost(eb, name: str = "") -> StageCost:
    """StageCost of one (engine-tagged) EngineBuild: image load, modeled
    program cycles (incl. host-side work), result-slice store.

    Builds that record their allocator high-water (``used_words`` on
    :class:`repro_torch.nmc.frontend.LoweredKernel`) are charged only for the
    words the tile image actually occupies — partitioned shards DMA their
    slice of the data, not the whole 32 KiB macro.  Legacy builds without
    the attribute keep the full-image cost."""
    prog = eb.program
    rep = program_cycles(prog, eb.host_cycles)
    words = int(getattr(eb, "used_words", 0)) \
        or int(np.asarray(eb.mem).size)
    return StageCost(
        name or f"{prog.engine}/{prog.sew}",
        dma_in_cycles=dma_cycles(words * C.WORD_BYTES),
        compute_cycles=rep.total_cycles,
        dma_out_cycles=dma_cycles(int(eb.out_slice[1]) * C.WORD_BYTES))


def dispatch_cycles(stages: list[StageCost], mode: str = "serial") -> float:
    """Total cycles to run a sequence of dispatch stages.

    ``"serial"`` is the synchronous baseline: every leg fully serializes,
    so the total is ``sum(dma_in + compute + dma_out)`` — what a blocking
    ``load -> dispatch -> store`` loop costs.

    ``"overlapped"`` models the double-buffered runtime
    (:class:`repro_torch.nmc.runtime.DispatchQueue`): one DMA engine and one
    compute engine run concurrently, the DMA engine streams stage ``i+1``'s
    image into the shadow buffer while stage ``i`` computes, and stores
    drain between loads.  In steady state each stage therefore costs
    ``max(dma, compute)`` instead of their sum; only the first load and the
    last compute/store are exposed.  The makespan is computed by walking
    the two resource timelines with the DMA queue ordered
    ``load_0, load_1, store_0, load_2, store_1, ...`` (load-ahead depth 2 =
    double buffering); it is always <= the serial total, and strictly less
    whenever two adjacent stages have work to overlap.
    """
    assert mode in ("serial", "overlapped"), mode
    if not stages:
        return 0.0
    if mode == "serial":
        return sum(s.serial_cycles for s in stages)
    dma_free = 0.0                  # DMA engine timeline
    comp_free = 0.0                 # compute engine timeline
    comp_end: list[float] = []
    for i, s in enumerate(stages):
        # load stage i into the shadow buffer (DMA serializes on the bus)
        load_end = dma_free + s.dma_in_cycles
        dma_free = load_end
        # compute stage i once its image is in and the engine is free
        comp_free = max(load_end, comp_free) + s.compute_cycles
        comp_end.append(comp_free)
        # store stage i-1 (its compute is done; next load already issued)
        if i >= 1:
            dma_free = max(dma_free, comp_end[i - 1]) \
                + stages[i - 1].dma_out_cycles
    dma_free = max(dma_free, comp_end[-1]) + stages[-1].dma_out_cycles
    return max(dma_free, comp_free)


def sweep_dispatch_cycles(builds: list, mode: str = "serial") -> float:
    """dispatch_cycles over a list of engine-tagged EngineBuilds."""
    return dispatch_cycles([stage_cost(eb) for eb in builds], mode)


# ---------------------------------------------------------------------------
# Multi-tile system cost model: one shared bus, N overlapped tiles
# ---------------------------------------------------------------------------

#: Stage -> tile placement policies of the multi-tile wave models:
#: ``"roundrobin"`` pins stage ``i`` to tile ``i % n_tiles`` (the dispatch
#: order the runtime uses), ``"greedy"`` places each stage on the
#: least-loaded tile at its DMA-arrival time (a free tile never idles
#: behind a busy one just because of its index).
ASSIGN_MODES = ("roundrobin", "greedy")


def _place_stage(i: int, tile_free: list, assign: str) -> int:
    """Tile index for stage ``i`` under the given placement policy."""
    if assign == "roundrobin":
        return i % len(tile_free)
    # greedy: earliest-free tile; ties resolve to the lowest index, so the
    # policy is deterministic and degenerates to roundrobin on fresh tiles
    return min(range(len(tile_free)), key=lambda t: (tile_free[t], t))


def chained_wave_cycles(waves: list[list[StageCost]], n_tiles: int,
                        assign: str = "roundrobin") -> float:
    """Makespan of a *chain* of dependent partitioned waves on one
    ``n_tiles`` array — the resident-block serving shape (DESIGN.md §12):
    wave ``w+1`` consumes wave ``w``'s outputs, so its input DMA cannot
    start until the previous wave's result slices have drained over the
    shared system bus (the tile-to-tile activation hop), while the bus and
    per-tile compute timelines carry over between waves instead of
    resetting.

    The model is the same N+1-resource system as :func:`wave_cycles`
    (one serialized 32-bit bus, N independent tile engines); chaining just
    keeps the timelines hot across waves.  Consequences the tests lock:

    * one wave degenerates to ``wave_cycles(stages, n_tiles)`` exactly;
    * the chain is never cheaper than its longest wave, and never costs
      more than running the waves back-to-back with cold timelines
      (``sum(wave_cycles(w, n) for w in waves)``).

    ``assign`` picks the stage->tile placement (:data:`ASSIGN_MODES`):
    ``"roundrobin"`` pins stage ``i`` to tile ``i % n_tiles``;
    ``"greedy"`` places each stage on the least-loaded tile at its
    DMA-arrival time — never worse than roundrobin when stages outnumber
    tiles, identical when they don't (each stage gets a fresh tile).
    """
    n_tiles = int(n_tiles)
    assert n_tiles >= 1, n_tiles
    assert assign in ASSIGN_MODES, assign
    bus = 0.0                          # shared system-bus timeline
    tile_free = [0.0] * n_tiles        # per-tile compute timelines
    for stages in waves:
        comp_end: list[float] = []
        for i, s in enumerate(stages):     # images/patches stream in
            t = _place_stage(i, tile_free, assign)
            bus += s.dma_in_cycles
            tile_free[t] = max(bus, tile_free[t]) + s.compute_cycles
            comp_end.append(tile_free[t])
        for i, s in enumerate(stages):     # outputs drain: the activation
            bus = max(bus, comp_end[i]) + s.dma_out_cycles   # hop the next
    return max(bus, max(tile_free))        # wave's input DMA waits behind


def wave_cycles(stages, n_tiles: int,
                mode: str = "overlapped",
                assign: str = "roundrobin") -> float:
    """Makespan of one partitioned wave on an ``n_tiles`` tile array.

    The paper's edge-node topology hangs every tile's SRAM macro off one
    32-bit system bus (``constants.SYS_BUS_BYTES_PER_CYCLE``), so the
    model has N + 1 resources: the shared bus serializes **every** DMA leg
    (stage images stream in submission order, result slices drain after
    their compute), while each tile's compute engine runs independently —
    stage ``i`` executes on tile ``i % n_tiles`` as soon as its image has
    landed and the tile is free.

    ``"serial"`` is the single-tile synchronous reference (every leg
    serializes: ``sum(dma_in + compute + dma_out)``), so
    ``wave_cycles(stages, 1, "serial") / wave_cycles(shards, N)`` is the
    modeled wave speedup of a partitioned kernel.  The overlapped makespan
    reproduces the paper's system-level scaling shape: speedup grows with
    N while per-tile compute dominates and saturates once the serialized
    bus stream binds (adding tiles then only adds queued DMA).

    ``"chained"`` accepts a list of *waves* (each a list of StageCosts)
    and delegates to :func:`chained_wave_cycles` — the cost of dependent
    back-to-back waves whose activations hop tile-to-tile over the bus.

    ``assign`` picks the stage->tile placement (:data:`ASSIGN_MODES`):
    ``"roundrobin"`` (default) models the runtime's dispatch order,
    ``"greedy"`` the least-loaded placement a work-stealing host would
    use — the two differ only when stages outnumber tiles.
    """
    assert mode in ("serial", "overlapped", "chained"), mode
    if mode == "chained":
        return chained_wave_cycles(stages, n_tiles, assign=assign)
    n_tiles = int(n_tiles)
    assert n_tiles >= 1, n_tiles
    assert assign in ASSIGN_MODES, assign
    if not stages:
        return 0.0
    if mode == "serial":
        return sum(s.serial_cycles for s in stages)
    bus = 0.0                          # shared system-bus timeline
    tile_free = [0.0] * n_tiles        # per-tile compute timelines
    comp_end: list[float] = []
    for i, s in enumerate(stages):     # images stream in, bus-serialized
        t = _place_stage(i, tile_free, assign)
        bus += s.dma_in_cycles
        tile_free[t] = max(bus, tile_free[t]) + s.compute_cycles
        comp_end.append(tile_free[t])
    for i, s in enumerate(stages):     # result slices drain, bus-serialized
        bus = max(bus, comp_end[i]) + s.dma_out_cycles
    return max(bus, max(tile_free))


def wave_speedup(single: StageCost, shards: list[StageCost],
                 n_tiles: int) -> float:
    """Modeled speedup of a partitioned wave over its unsharded single-tile
    dispatch (both through the same two-resource bus/compute model)."""
    return wave_cycles([single], 1) / wave_cycles(shards, n_tiles)


# ---------------------------------------------------------------------------
# CPU baseline (RV32IMC, Table V measurements)
# ---------------------------------------------------------------------------

def cpu_cycles(kernel: str, sew: int, n_outputs: int) -> TimingReport:
    cyc = C.CPU_CYCLES_PER_OUTPUT[kernel][sew] * n_outputs
    return TimingReport(0.0, cyc, 0, {"model": "table_v"})


def kernel_timing(kb) -> dict[str, TimingReport]:
    """Timing for all three execution targets of a KernelBuild."""
    return {
        "cpu": cpu_cycles(kb.name, kb.sew, kb.n_outputs),
        "caesar": caesar_cycles(kb.caesar),
        "carus": carus_cycles(kb.carus, kb.sew),
    }
