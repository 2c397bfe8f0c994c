"""Op registry + shared execution runtime for the traced NMC frontend.

Two registries back :mod:`repro_torch.nmc.frontend` (DESIGN.md §7):

* **Op registry** — one :class:`OpSpec` per tracer-level operation, naming
  the pure-numpy lane semantics (``repro_torch.core.alu.lane_binop_np``), the
  NM-Caesar bus micro-op and the NM-Carus ``xvnmc`` funct6 it lowers to.
  ``caesar_op is None`` marks an op that is *not bus-expressible*
  (e.g. unsigned min/max): the frontend's engine auto-selection consults
  exactly this table, and an explicit ``engine="caesar"`` request raises
  :class:`repro_torch.nmc.frontend.UnsupportedOnEngine` naming the op.
* **Runtime registry** — the process-wide :class:`NmcRuntime` every
  :class:`repro_torch.nmc.frontend.CompiledKernel` dispatches through by default:
  one shared :class:`repro_torch.nmc.pool.BucketedPool` executor cache (one
  kernel handle per ``(engine, sew, instr-bucket, tile-bucket)``) under a
  :class:`repro_torch.nmc.pool.ResidentPool` and its
  :class:`repro_torch.nmc.runtime.DispatchQueue`.  Every kernel call — sync or
  async — submits to the queue on the shared ``jit_tile`` (a synchronous
  call simply resolves its future immediately), so both call styles share
  one code path, one jit cache, and are bit-exact equal by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.isa import CaesarOp, VOp


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One tracer-level elementwise op and its per-engine lowering."""

    name: str                          # alu lane-op name (= tracer op name)
    caesar_op: Optional[CaesarOp]      # bus micro-op; None = not expressible
    carus_vop: Optional[VOp]           # xvnmc funct6
    carus_imm: bool = False            # int scalar lowers to MODE_VI (imm5)

    @property
    def on_caesar(self) -> bool:
        return self.caesar_op is not None


#: Elementwise binary ops the tracer records (vector-vector or
#: vector-scalar).  ``mac`` / ``slide_down`` are structural ops handled by
#: the lowerings directly (accumulator chains / data movement, not lane
#: arithmetic), so they live outside this table.
BINOPS: dict[str, OpSpec] = {s.name: s for s in (
    OpSpec("add", CaesarOp.ADD, VOp.VADD),
    OpSpec("sub", CaesarOp.SUB, VOp.VSUB),
    OpSpec("mul", CaesarOp.MUL, VOp.VMUL),
    OpSpec("and", CaesarOp.AND, VOp.VAND),
    OpSpec("or", CaesarOp.OR, VOp.VOR),
    OpSpec("xor", CaesarOp.XOR, VOp.VXOR),
    OpSpec("min", CaesarOp.MIN, VOp.VMIN),
    OpSpec("max", CaesarOp.MAX, VOp.VMAX),
    # unsigned compares exist only in the xvnmc vector ISA (Table III);
    # NM-Caesar's bus ALU has signed MIN/MAX only (Section III-A2)
    OpSpec("minu", None, VOp.VMINU),
    OpSpec("maxu", None, VOp.VMAXU),
    OpSpec("sll", CaesarOp.SLL, VOp.VSLL, carus_imm=True),
    OpSpec("srl", CaesarOp.SLR, VOp.VSRL, carus_imm=True),
    OpSpec("sra", CaesarOp.SRA, VOp.VSRA, carus_imm=True),
)}


def engine_op_ids(engine: str) -> frozenset:
    """Every opcode id valid in ``engine``'s instruction stream — the
    single source of truth the static verifier (:mod:`repro_torch.nmc.check`)
    and the dispatch-time asserts validate the ``op`` field against."""
    if engine == "caesar":
        return frozenset(int(o) for o in CaesarOp)
    if engine == "carus":
        from repro_torch.core.isa import VOP_COMPACT
        return frozenset(range(len(VOP_COMPACT)))
    raise ValueError(f"unknown engine {engine!r}")


class NmcRuntime:
    """Shared execution stack for compiled kernels (DESIGN.md §7).

    Holds the three scheduler layers as one object so every kernel compiled
    by :func:`repro_torch.nmc.frontend.jit` reuses one jit cache:

    * ``bucketed`` — the shape-bucketed compile cache (donated state),
    * ``resident`` — the device-resident tile array under the queue,
    * ``queue``    — the double-buffered dispatch queue all kernel calls
      submit to (sync calls resolve their future immediately; async ones
      return it) — bit-exact either way (tests/test_frontend.py).

    Kernel calls dispatch on the runtime's tile set (:meth:`jit_tiles`):
    unpartitioned calls on the head tile, partitioned waves (``tiles=N``)
    one shard per tile.
    """

    def __init__(self, mode: str = "overlapped", backend: str = "auto"):
        """``backend`` defaults to the card (``"auto"`` resolves to
        ``"cuda"`` and raises without one); ``"torch"`` asks for the
        plain engines on the CPU."""
        from repro_torch.nmc.engine import resolve_backend
        from repro_torch.nmc.pool import BucketedPool, ResidentPool
        from repro_torch.nmc.runtime import DispatchQueue

        self.backend = resolve_backend(backend)
        self.bucketed = BucketedPool(donate=True, backend=self.backend)
        self.resident = ResidentPool(pool=self.bucketed)
        self.queue = DispatchQueue(pool=self.resident, mode=mode)

    @classmethod
    def for_queue(cls, queue) -> "NmcRuntime":
        """Wrap an existing :class:`repro_torch.nmc.runtime.DispatchQueue` (and
        the pools under it) as a runtime, so compiled kernels can join a
        caller-owned dispatch discipline instead of the process default —
        e.g. a :class:`repro_torch.serve.engine.ServeEngine` given a private
        queue routes its tile-array projections through the same queue it
        uses for prefill/decode work."""
        rt = cls.__new__(cls)
        rt.bucketed = queue.pool.pool
        rt.resident = queue.pool
        rt.queue = queue
        rt.backend = rt.bucketed.backend
        return rt

    def jit_tiles(self, n: int) -> tuple:
        """The runtime's shared tile *set*: partitioned kernel waves
        dispatch shard ``k`` on tile ``("jit", k)``.  A fixed, reused id
        space keeps the resident device state bounded (one buffer per
        array position, re-installed per call) instead of leaking a tile
        memory per kernel invocation; per-tile FIFO order makes
        arbitrarily many in-flight futures safe — each captures its own
        wave's final state."""
        return tuple(("jit", k) for k in range(int(n)))

    #: The head of the tile set: where unpartitioned (``tiles=1``) kernel
    #: calls dispatch.
    @property
    def jit_tile(self):
        return self.jit_tiles(1)[0]


_DEFAULT: Optional[NmcRuntime] = None


def default_runtime() -> NmcRuntime:
    """The process-wide runtime ``CompiledKernel`` dispatches through."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = NmcRuntime()
    return _DEFAULT


def set_default_runtime(rt: Optional[NmcRuntime]) -> Optional[NmcRuntime]:
    """Swap the process-wide runtime (``None`` resets to a fresh one on
    next use); returns the previous runtime so callers can restore it."""
    global _DEFAULT
    old, _DEFAULT = _DEFAULT, rt
    return old
