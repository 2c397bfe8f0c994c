"""Traced kernel frontend: numpy-style Python -> the whole NMC stack
(DESIGN.md §7).

Write a kernel as ordinary Python over traced values; calling it runs the
full pipeline — trace, engine selection, lowering to the unified IR,
bucketed/resident scheduling, sync or async dispatch — in one call::

    from repro_torch import nmc

    @nmc.kernel                        # trace + engine auto-selection
    def fused(t, x, y):
        a = t.load(x)                  # host array -> tile memory
        b = t.load(y)
        t.store(((a * 3) + b).max(0))  # ints broadcast; max(x, 0) = ReLU

    out = fused(xs, ys)                # sync: lower, schedule, run, extract
    fut = fused.call_async(xs, ys)     # async via the DispatchQueue
    assert (fut.result() == out).all() # bit-exact either way

    mm = nmc.jit(my_matmul, engine="carus", sew=16)   # explicit target

The contract, layer by layer:

* **Tracing** — the kernel function receives a :class:`TileContext` ``t``
  plus its host numpy arrays.  ``t.load`` / ``t.consts`` bring data into
  tile memory; arithmetic on :class:`NmcValue` (``+ - * ^ & | << >>``,
  ``min/max/minu/maxu``, :func:`mac`, ``slide_down``, scalar broadcast)
  records ops into a :class:`ProgramBuilder` tape *and* eagerly evaluates
  them through the pure-numpy oracle mirrors (``alu.lane_binop_np`` /
  ``alu.trunc_lanes_np``, two's complement, wrap at SEW) — so every traced
  kernel carries its own bit-exact reference output.
* **Engine selection** — ``engine="auto"`` picks NM-Caesar when every
  traced op is bus-expressible (the :data:`repro_torch.nmc.registry.BINOPS`
  table) and NM-Carus otherwise; an explicit engine that cannot express
  the body raises :class:`UnsupportedOnEngine` naming the offending op.
* **Lowering** — the tape lowers to a unified-IR
  :class:`repro_torch.nmc.program.Program` per engine.  NM-Caesar lowering is
  word-major: elementwise chains fuse through a rotating scratch window,
  ``mul``→``mac`` chains become MAC_INIT/MAC/MAC_STORE accumulator runs,
  scalars splat into constant words, and operand regions are placed in
  opposite banks (loads default to bank 1, constants/outputs/temporaries
  to bank 0 — the Section III-A2 one-op-per-2-cycles placement).
  NM-Carus lowering chunks vectors across registers with the indirect
  register-addressing template, reads ``t.consts`` scalars through
  EMVX + ``.vx`` ops, reuses dead registers in place (VMACC accumulates
  into its destination), and tracks VSETVL.
* **Execution** — ``CompiledKernel(...)`` runs synchronously through the
  shared :class:`repro_torch.nmc.registry.NmcRuntime` resident pool;
  ``call_async`` submits to its :class:`repro_torch.nmc.runtime.DispatchQueue`
  and returns a future.  Both paths share one bucketed executor cache (one
  kernel handle per ``(engine, sew, instr-bucket, tile-bucket)``) and are
  bit-exact equal to each other and to the traced oracle.

Re-tracing happens per call (programs embed ``t.consts`` scalar values,
faithfully modeling the eCPU reading taps at runtime); executor builds do
not — lowered programs hit the shared bucketed executor cache.

Partitioned calls (``tiles > 1``) go through the partitioning planner
(:mod:`repro_torch.nmc.partition`) and the wave scheduler
(:mod:`repro_torch.nmc.schedule`): the traced tape is sharded across the
runtime's tile set, every shard runs on its own tile in one launch wave,
and a gather future reassembles the caller's array.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core import alu
from repro_torch.core import constants as C
from repro_torch.core import isa
from repro_torch.core.isa import CaesarOp, VOp
from repro_torch.nmc.program import (Program, caesar_entry, carus_entry,
                                     instr_bucket)
from repro_torch.nmc.registry import BINOPS, NmcRuntime, default_runtime

ENGINES = ("caesar", "carus")
PARTITIONS = ("auto", "rows", "axis")

_CAESAR_MEM_WORDS = C.CAESAR_MEM_BYTES // C.WORD_BYTES
_CAESAR_BANK_WORDS = _CAESAR_MEM_WORDS // C.CAESAR_N_BANKS
_CAESAR_SCRATCH_WINDOW = 16        # rotating scratch words per fused group


class UnsupportedOnEngine(Exception):
    """A traced op cannot be expressed on the requested engine."""

    def __init__(self, op: str, engine: str, reason: str = "",
                 kernel: Optional[str] = None,
                 op_index: Optional[int] = None):
        self.op = op
        self.engine = engine
        self.kernel = kernel
        self.op_index = op_index
        where = f"op '{op}'"
        if op_index is not None:
            where += f" (traced op#{op_index})"
        if kernel:
            where += f" in kernel '{kernel}'"
        msg = f"{where} is not expressible on engine '{engine}'"
        if reason:
            msg = f"{msg}: {reason}"
        super().__init__(msg)


class LoweringError(Exception):
    """The traced program is valid but this lowering cannot realize it
    (capacity, layout or scheduling limitation with a named cause)."""


def splat_word(val: int, sew: int) -> int:
    """Replicate a SEW-bit value across a 32-bit word (host-side helper
    for NM-Caesar scalar constants)."""
    v = int(np.int64(val) & ((1 << sew) - 1))
    w = 0
    for k in range(32 // sew):
        w |= v << (sew * k)
    w &= 0xFFFFFFFF
    return w - (1 << 32) if w >= (1 << 31) else w


def _wrap_scalar(v, sew: int) -> int:
    """Wrap a Python scalar to SEW bits, sign-extended — the value the
    engines see (Caesar: splat word; Carus: eCPU GPR operand)."""
    return int(alu.trunc_lanes_np(np.int64(int(v)), sew))


# ---------------------------------------------------------------------------
# Tape
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class _Node:
    """One traced value: a load/const pool or a recorded vector op."""

    idx: int
    op: str                 # "load" | "cpool" | BINOPS name | "mac" | "slide_down"
    args: tuple = ()        # operand _Nodes / _ConstScalar / wrapped ints
    val: np.ndarray | None = None   # int64 lanes, wrapped at SEW (the oracle)
    ne: int = 0             # logical element count
    bank: Optional[int] = None      # NM-Caesar placement hint (loads)
    amount: int = 0         # slide offset

    def __repr__(self):
        return f"<{self.op}#{self.idx} ne={self.ne}>"


@dataclasses.dataclass(frozen=True)
class _ConstScalar:
    """One element of a ``t.consts`` pool: a scalar tap living in tile
    memory (Caesar: its own splat word; Carus: EMVX-read from the pool
    registers)."""

    pool: _Node
    index: int
    value: int              # wrapped to SEW


class ProgramBuilder:
    """Records traced ops; one instance per trace.  Kernel functions see
    it through :class:`TileContext`; lowerings walk ``nodes``/``stores``."""

    def __init__(self, sew: int, name: str = "kernel"):
        assert sew in alu.SEWS, sew
        self.sew = sew
        self.name = name          # diagnostic provenance (kernel name)
        self.nodes: list[_Node] = []
        self.stores: list[tuple[_Node, int]] = []   # (node, trimmed ne)

    def _where(self) -> str:
        """Provenance prefix for trace-time diagnostics: the kernel name
        and the index the op being recorded would get."""
        return f"{self.name} (traced op#{len(self.nodes)})"

    # -- node construction ---------------------------------------------------
    def _new(self, op: str, args: tuple = (), **kw) -> _Node:
        node = _Node(idx=len(self.nodes), op=op, args=args, **kw)
        self.nodes.append(node)
        return node

    def load(self, array, bank: Optional[int] = None) -> _Node:
        arr = np.asarray(array).reshape(-1)
        val = alu.trunc_lanes_np(arr.astype(np.int64), self.sew)
        return self._new("load", val=val, ne=int(arr.size), bank=bank)

    def cpool(self, array) -> _Node:
        arr = np.asarray(array).reshape(-1)
        val = alu.trunc_lanes_np(arr.astype(np.int64), self.sew)
        return self._new("cpool", val=val, ne=int(arr.size))

    def binop(self, name: str, a: _Node, b) -> _Node:
        assert name in BINOPS, name
        b_val = b.value if isinstance(b, _ConstScalar) \
            else (b.val if isinstance(b, _Node) else _wrap_scalar(b, self.sew))
        if isinstance(b, _Node) and a.ne != b.ne:
            raise LoweringError(
                f"{self._where()}: operand length mismatch for "
                f"'{name}': {a.ne} vs {b.ne}")
        val = alu.trunc_lanes_np(
            alu.lane_binop_np(name, a.val, b_val, self.sew), self.sew)
        return self._new(name, (a, b), val=val, ne=a.ne)

    def mac(self, acc, a, b) -> _Node:
        """acc + a * b elementwise; ``acc=None`` starts a chain (a mul)."""
        x, y = a, b
        vecs = [v for v in (x, y) if isinstance(v, _Node)]
        if not vecs:
            raise LoweringError(
                f"{self._where()}: mac needs at least one vector operand")
        ne = vecs[0].ne
        if any(v.ne != ne for v in vecs) or \
                (isinstance(acc, _Node) and acc.ne != ne):
            raise LoweringError(
                f"{self._where()}: mac operand length mismatch")
        xv = x.val if isinstance(x, _Node) else _scalar_val(x, self.sew)
        yv = y.val if isinstance(y, _Node) else _scalar_val(y, self.sew)
        if acc is None:
            return self._new(
                "mul", (x, y),
                val=alu.trunc_lanes_np(np.int64(xv) * yv, self.sew), ne=ne)
        val = alu.trunc_lanes_np(acc.val + np.int64(xv) * yv, self.sew)
        return self._new("mac", (acc, x, y), val=val, ne=ne)

    def slide_down(self, a: _Node, amount: int) -> _Node:
        amount = int(amount)
        assert amount >= 0, amount
        k = min(amount, a.ne)
        val = np.concatenate([a.val[k:], np.zeros(k, np.int64)])
        return self._new("slide_down", (a,), val=val, ne=a.ne, amount=amount)

    def store(self, node: _Node, n: Optional[int] = None) -> None:
        trim = int(n) if n is not None else node.ne
        assert 0 < trim <= node.ne, (trim, node.ne)
        if node.op in ("load", "cpool"):
            raise LoweringError(
                f"{self.name} (traced op#{node.idx}): storing a loaded "
                f"value directly is not supported — apply at least one op "
                f"(tile memory outputs are compute results)")
        self.stores.append((node, trim))

    # -- analysis ------------------------------------------------------------
    def compute_nodes(self) -> list[_Node]:
        return [n for n in self.nodes
                if n.op in BINOPS or n.op in ("mac", "slide_down")]

    def consumers(self) -> dict[int, list[_Node]]:
        cons: dict[int, list[_Node]] = {n.idx: [] for n in self.nodes}
        for n in self.nodes:
            for a in n.args:
                if isinstance(a, _Node):
                    cons[a.idx].append(n)
                elif isinstance(a, _ConstScalar):
                    cons[a.pool.idx].append(n)
        return cons

    def oracle(self):
        """Reference output: the stored values, trimmed and shaped exactly
        like the executed kernel's post-processed result."""
        dt = alu.NP_DTYPES[self.sew]
        parts = [node.val[:trim].astype(dt) for node, trim in self.stores]
        return _shape_parts(parts)


def _scalar_val(v, sew: int) -> int:
    return v.value if isinstance(v, _ConstScalar) else _wrap_scalar(v, sew)


def _shape_parts(parts: list[np.ndarray]) -> np.ndarray:
    if len(parts) == 1:
        return parts[0]
    if len({p.size for p in parts}) == 1:
        return np.stack(parts)
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# User-facing trace values
# ---------------------------------------------------------------------------

class NmcValue:
    """A traced vector living in tile memory.  Supports numpy-style
    arithmetic (recorded into the tape, evaluated eagerly through the
    ``alu.*_np`` oracle mirrors) and scalar broadcast of Python ints and
    ``t.consts`` elements."""

    __array_priority__ = 1000   # keep numpy from hijacking ndarray op value

    def __init__(self, builder: ProgramBuilder, node: _Node):
        self._b = builder
        self._node = node

    # -- introspection -------------------------------------------------------
    @property
    def ne(self) -> int:
        return self._node.ne

    @property
    def value(self) -> np.ndarray:
        """The traced (oracle) value: wrapped SEW-wide lanes."""
        return self._node.val.astype(alu.NP_DTYPES[self._b.sew])

    def __repr__(self):
        return f"NmcValue({self._node!r}, sew={self._b.sew})"

    # -- op recording --------------------------------------------------------
    def _bin(self, name: str, other, reverse: bool = False) -> "NmcValue":
        if isinstance(other, NmcValue):
            other = other._node
        elif isinstance(other, np.ndarray):
            raise TypeError("load host arrays with t.load()/t.consts() "
                            "before using them in traced arithmetic")
        if reverse and name in ("sub", "sll", "srl", "sra"):
            raise TypeError(f"scalar {name} with a traced vector on the "
                            f"right is not supported — rewrite the kernel "
                            f"with the vector on the left")
        return NmcValue(self._b, self._b.binop(name, self._node, other))

    def __add__(self, o):
        return self._bin("add", o)
    __radd__ = __add__

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("sub", o, reverse=True)

    def __mul__(self, o):
        return self._bin("mul", o)
    __rmul__ = __mul__

    def __xor__(self, o):
        return self._bin("xor", o)
    __rxor__ = __xor__

    def __and__(self, o):
        return self._bin("and", o)
    __rand__ = __and__

    def __or__(self, o):
        return self._bin("or", o)
    __ror__ = __or__

    def __rshift__(self, o):
        return self._bin("sra", o)      # arithmetic: values are signed lanes

    def __lshift__(self, o):
        return self._bin("sll", o)

    def sra(self, o):
        return self._bin("sra", o)

    def srl(self, o):
        return self._bin("srl", o)

    def sll(self, o):
        return self._bin("sll", o)

    def min(self, o):
        return self._bin("min", o)

    def max(self, o):
        return self._bin("max", o)

    def minu(self, o):
        return self._bin("minu", o)

    def maxu(self, o):
        return self._bin("maxu", o)

    def relu(self) -> "NmcValue":
        return self.max(0)

    def slide_down(self, amount: int) -> "NmcValue":
        """``out[i] = self[i + amount]``, zero-filled at the tail.  Lowers
        to VSLIDEDOWN on NM-Carus; on NM-Caesar it is realized as a
        host-prepared shifted data replica — hence only slides of *loaded*
        values are bus-expressible (the Table VII data-replication trick)."""
        return NmcValue(self._b, self._b.slide_down(self._node, amount))


class ConstView:
    """Indexable view of a ``t.consts`` pool: ``view[i, j]`` is a scalar
    tap usable wherever a Python int scalar is (mac taps, `*`, …)."""

    def __init__(self, builder: ProgramBuilder, node: _Node, shape: tuple):
        self._b = builder
        self._node = node
        self._shape = shape

    def __getitem__(self, key) -> _ConstScalar:
        flat = int(np.ravel_multi_index(key, self._shape)) \
            if isinstance(key, tuple) else int(key)
        if flat < 0:                    # pythonic negatives, normalized so
            flat += self._node.ne       # the lowered pool address matches
        if not 0 <= flat < self._node.ne:
            raise IndexError(f"consts index {key} out of range for shape "
                             f"{self._shape}")
        return _ConstScalar(self._node, flat, int(self._node.val[flat]))


class TileContext:
    """The trace context a kernel function receives as its first argument."""

    def __init__(self, builder: ProgramBuilder):
        self.builder = builder

    @property
    def sew(self) -> int:
        return self.builder.sew

    def load(self, array, bank: Optional[int] = None) -> NmcValue:
        """Bring a host array into tile memory as a traced vector.  ``bank``
        is an NM-Caesar placement hint (default bank 1; constants, outputs
        and temporaries live in bank 0, so vector/scalar op operands land
        in opposite banks — the 1-op-per-2-cycles placement)."""
        return NmcValue(self.builder, self.builder.load(array, bank=bank))

    def consts(self, array) -> ConstView:
        """Load an array of scalar taps (e.g. matmul A entries, conv filter
        weights).  Element reads model the hardware path: EMVX from the
        pool registers on NM-Carus, dedicated splat words on NM-Caesar."""
        arr = np.asarray(array)
        return ConstView(self.builder, self.builder.cpool(arr), arr.shape)

    def store(self, value: NmcValue, n: Optional[int] = None) -> None:
        """Mark a traced value as a kernel output; ``n`` trims the logical
        length (e.g. a convolution's valid width)."""
        self.builder.store(value._node, n=n)


def mac(acc: Optional[NmcValue], a, b) -> NmcValue:
    """Elementwise multiply-accumulate: ``acc + a * b`` (wrap at SEW).
    ``acc=None`` starts an accumulation chain.  Chains of ``mac`` lower to
    MAC_INIT/MAC/MAC_STORE accumulator runs on NM-Caesar and in-place
    VMUL/VMACC on NM-Carus."""
    vec = next((v for v in (acc, a, b) if isinstance(v, NmcValue)), None)
    if vec is None:
        raise TypeError("mac needs at least one traced operand")
    if acc is not None and not isinstance(acc, NmcValue):
        raise TypeError(f"mac accumulator must be a traced vector or None "
                        f"(chain start), got {type(acc).__name__} — add a "
                        f"scalar with `mac(None, a, b) + c` instead")
    b_ = vec._b
    node = b_.mac(acc._node if isinstance(acc, NmcValue) else None,
                  a._node if isinstance(a, NmcValue) else a,
                  b._node if isinstance(b, NmcValue) else b)
    return NmcValue(b_, node)


# ---------------------------------------------------------------------------
# Engine selection
# ---------------------------------------------------------------------------

def engine_diagnosis(builder: ProgramBuilder,
                     engine: str) -> Optional[UnsupportedOnEngine]:
    """Why this tape cannot lower to ``engine`` — or None if it can."""
    lanes = 32 // builder.sew
    name = getattr(builder, "name", None)
    for n in builder.compute_nodes():
        if engine == "caesar":
            if n.op in BINOPS and not BINOPS[n.op].on_caesar:
                return UnsupportedOnEngine(
                    n.op, "caesar", "the bus ALU has no such micro-op "
                    "(Section III-A2); use engine='carus'",
                    kernel=name, op_index=n.idx)
            if n.op == "slide_down" and n.args[0].op != "load":
                return UnsupportedOnEngine(
                    "slide_down", "caesar", "NM-Caesar realizes slides as "
                    "host-side shifted data replicas, so only loaded "
                    "values can slide; computed values need NM-Carus's "
                    "VSLIDEDOWN", kernel=name, op_index=n.idx)
        else:
            n_words = -(-n.ne // lanes)
            if n.op == "slide_down" and \
                    -(-n_words // C.CARUS_REG_WORDS) > 1:
                return UnsupportedOnEngine(
                    "slide_down", "carus", "VSLIDEDOWN operates within one "
                    "vector register; the vector spans multiple registers",
                    kernel=name, op_index=n.idx)
    return None


def select_engine(builder: ProgramBuilder) -> str:
    """``auto`` rule: NM-Caesar for bus-op-expressible bodies (host-
    streamed micro-ops, no eCPU bootstrap), NM-Carus otherwise."""
    if engine_diagnosis(builder, "caesar") is None:
        return "caesar"
    bad = engine_diagnosis(builder, "carus")
    if bad is not None:
        raise bad
    return "carus"


# ---------------------------------------------------------------------------
# Lowered artifact
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LoweredKernel:
    """A traced kernel lowered for one engine: the unified-IR program, the
    initial tile-memory image, the output window and the host-side
    extraction stage.  Duck-type compatible with
    :class:`repro_torch.core.programs.EngineBuild` (pools, runtime, timing and
    energy all accept it directly)."""

    engine: str
    sew: int
    stream: list                    # PROG_DTYPE entries
    mem: np.ndarray                 # initial memory / VRF image
    out_slice: tuple[int, int]      # (word_start, n_words)
    post: Callable                  # raw elements -> shaped logical output
    oracle: np.ndarray              # traced reference output (shaped)
    host_cycles: float = 0.0
    ecpu_instrs: int = 0
    used_words: int = 0             # allocator high-water: words the tile
                                    # image actually occupies (drives the
                                    # DMA legs of the multi-tile bus model)
    kernel: str = ""                # traced kernel name (diagnostics)
    init_spans: tuple = ()          # image-defined (word_start, n_words)
                                    # spans — what the static verifier may
                                    # treat as defined before instr #0
    prov: Optional[list] = None     # instruction index -> tracer op index
    cpool_spans: tuple = ()         # (word_start, n_elems) per ``t.consts``
                                    # pool, trace order — the value-dependent
                                    # image words.  On NM-Caesar each element
                                    # owns one splat word, so a resident-
                                    # weights caller (serve/block.py) can
                                    # patch exactly these words per call and
                                    # keep everything else on the tile.
    opt_report: Optional[object] = None  # repro_torch.nmc.opt.OptReport when the
                                    # optimizer rewrote this lowering
                                    # (None: opt="off" or nothing fired)
    _prog: Optional[Program] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def program(self) -> Program:
        if self._prog is None:
            self._prog = Program.from_entries(self.engine, self.sew,
                                              self.stream)
        return self._prog

    @property
    def n_outputs(self) -> int:
        return int(self.oracle.size)

    def pad_to(self, n_instr: int) -> None:
        """NOP-pad the lowered program to ``n_instr`` entries — the
        wave-level bucket alignment of partitioned shards (bit-exact and
        zero-cost by the padding contract of :meth:`Program.pad_to`).
        ``stream`` keeps the unpadded tape; ``program`` reflects the pad."""
        self._prog = self.program.pad_to(n_instr)


def _make_post(spans: list[tuple[int, int]], lanes: int, dtype) -> Callable:
    """Extraction stage: slice each store's elements out of the flat
    extracted window (skipping inter-store padding) and shape the result."""

    def post(elems: np.ndarray) -> np.ndarray:
        flat = np.asarray(elems).reshape(-1)
        parts = [flat[off * lanes: off * lanes + ne].astype(dtype, copy=False)
                 for off, ne in spans]
        return _shape_parts(parts)

    return post


# ---------------------------------------------------------------------------
# NM-Caesar lowering: word-major fused groups over a 2-bank memory
# ---------------------------------------------------------------------------

class _CaesarLowering:
    def __init__(self, builder: ProgramBuilder):
        bad = engine_diagnosis(builder, "caesar")
        if bad is not None:
            raise bad
        self.b = builder
        self.sew = builder.sew
        self.lanes = 32 // self.sew

    def words(self, ne: int) -> int:
        return -(-ne // self.lanes)

    def lower(self) -> LoweredKernel:
        b = self.b
        nodes = b.nodes
        consumers = b.consumers()
        stored: dict[int, list[int]] = {}
        for node, trim in b.stores:
            stored.setdefault(node.idx, []).append(trim)
        compute = b.compute_nodes()
        compute_set = {n.idx for n in compute}

        # -- demanded word counts (store trims propagate up the cone) -------
        demand: dict[int, int] = {}
        for n in reversed(compute):
            d = max((self.words(t) for t in stored.get(n.idx, ())),
                    default=0)
            for c in consumers[n.idx]:
                if c.idx in compute_set:
                    d = max(d, demand.get(c.idx, 0))
            demand[n.idx] = d if d else self.words(n.ne)

        # -- fused word-major groups (equal full word counts) ----------------
        groups: list[list[_Node]] = []
        for n in compute:
            if n.op == "slide_down":
                continue                       # host-side data replica
            if groups and self.words(groups[-1][0].ne) == self.words(n.ne):
                groups[-1].append(n)
            else:
                groups.append([n])
        group_of = {n.idx: gi for gi, g in enumerate(groups) for n in g}

        # -- streaming: single-use intermediates never touch a full region --
        streamed: set[int] = set()
        chain_into: dict[int, int] = {}        # producer -> consumer mac
        for n in compute:
            if n.op == "slide_down" or n.idx in stored:
                continue
            cons = [c for c in consumers[n.idx]]
            if len(cons) == 1 and cons[0].idx in group_of \
                    and group_of.get(n.idx) == group_of[cons[0].idx]:
                streamed.add(n.idx)
                c = cons[0]
                if c.op == "mac" and n.op in ("mul", "mac") \
                        and c.args[0] is n:
                    chain_into[n.idx] = c.idx

        # -- allocation ------------------------------------------------------
        b0, b1 = _Cursor(0, _CAESAR_BANK_WORDS, b.name), \
            _Cursor(_CAESAR_BANK_WORDS, _CAESAR_MEM_WORDS, b.name)
        region: dict[int, int] = {}            # node idx -> base word addr
        const_addr: dict = {}                  # wrapped int value -> addr
        cpool_base: dict[int, int] = {}        # cpool node idx -> base

        def const_word(v: int) -> int:
            if v not in const_addr:
                const_addr[v] = b0.take(1, "constant")
            return const_addr[v]

        for n in nodes:                        # constants, first-use order
            if n.op == "cpool":
                cpool_base[n.idx] = b0.take(n.ne, "consts pool")
            for a in n.args:
                if not isinstance(a, (_Node, _ConstScalar)):
                    const_word(_wrap_scalar(a, self.sew))

        spans: list[tuple[int, int]] = []
        region_words: dict[int, int] = {}      # node idx -> allocated words
        out_base = b0.pos
        for node, trim in b.stores:            # outputs: contiguous window
            if node.idx not in region:
                region[node.idx] = b0.take(demand[node.idx], "output")
                region_words[node.idx] = demand[node.idx]
            spans.append((region[node.idx] - out_base, trim))
        out_words = max(r + self.words(t) for (r, t) in spans) if spans else 0

        for n in nodes:                        # loads + replicas, then temps
            if n.idx in region:
                continue                       # a stored slide replica lands
                                               # directly in the output window
            if n.op == "load":
                cur = b0 if n.bank == 0 else b1
                region[n.idx] = cur.take(self.words(n.ne), "load")
                region_words[n.idx] = self.words(n.ne)
            elif n.op == "slide_down":
                src = n.args[0]
                cur = b0 if src.bank == 0 else b1
                region[n.idx] = cur.take(self.words(n.ne), "slide replica")
                region_words[n.idx] = self.words(n.ne)
        for n in compute:
            if n.op != "slide_down" and n.idx not in region \
                    and n.idx not in streamed:
                region[n.idx] = b0.take(demand[n.idx], "temporary")
        scratch: dict[int, int] = {}
        slot_base = b0.pos
        n_slots = 0
        for n in compute:
            if n.idx in streamed and n.idx not in chain_into:
                scratch[n.idx] = n_slots
                n_slots += 1
        if n_slots:
            b0.take(n_slots, "scratch window")
        mac_tmp = None                         # lazy: generic vector-acc mac

        # -- memory image ----------------------------------------------------
        mem = np.zeros(_CAESAR_MEM_WORDS, np.int32)
        dt = alu.NP_DTYPES[self.sew]
        init_spans: list[tuple[int, int]] = []     # image-defined words
        for n in nodes:
            if n.op in ("load", "slide_down"):
                # a stored slide's region is its (demand-sized) output
                # window slot — never write past the allocation
                nw = min(self.words(n.ne), region_words[n.idx])
                padded = np.zeros(nw * self.lanes, dt)
                padded[:min(n.ne, nw * self.lanes)] = \
                    n.val[:nw * self.lanes].astype(dt)
                mem[region[n.idx]:region[n.idx] + nw] = alu.pack_np(padded)
                init_spans.append((region[n.idx], nw))
            elif n.op == "cpool":
                base = cpool_base[n.idx]
                for i, v in enumerate(n.val):
                    mem[base + i] = splat_word(int(v), self.sew)
                init_spans.append((base, int(n.ne)))
        for v, addr in const_addr.items():
            mem[addr] = splat_word(v, self.sew)
            init_spans.append((addr, 1))

        # -- emission --------------------------------------------------------
        def wref(x, w: int) -> int:
            if isinstance(x, _ConstScalar):
                return cpool_base[x.pool.idx] + x.index
            if isinstance(x, _Node):
                if x.idx in scratch:
                    return slot_base + scratch[x.idx]
                return region[x.idx] + w
            return const_addr[_wrap_scalar(x, self.sew)]

        def wdest(n: _Node, w: int) -> int:
            if n.idx in scratch:
                return slot_base + scratch[n.idx]
            return region[n.idx] + w

        stream: list = []
        prov: list[int] = []                   # instr index -> tracer op idx

        def emit(idx: int, entry) -> None:
            stream.append(entry)
            prov.append(idx)

        for g in groups:
            gmax = max(demand[n.idx] for n in g)
            for w in range(gmax):
                acc_owner = None
                for n in g:
                    if w >= demand[n.idx]:
                        continue
                    if n.op == "mac":
                        acc, x, y = n.args
                        s1, s2 = wref(x, w), wref(y, w)
                        if isinstance(acc, _Node) \
                                and chain_into.get(acc.idx) == n.idx:
                            if acc_owner != acc.idx:
                                raise LoweringError(
                                    f"{b.name} (traced op#{n.idx}): "
                                    "interleaved MAC chains: NM-Caesar has "
                                    "one packed accumulator — keep each "
                                    "mul/mac chain contiguous in the trace")
                            if n.idx in chain_into:
                                emit(n.idx, caesar_entry(
                                    CaesarOp.MAC, 0, s1, s2))
                                acc_owner = n.idx
                            else:
                                emit(n.idx, caesar_entry(
                                    CaesarOp.MAC_STORE, wdest(n, w), s1, s2))
                                acc_owner = None
                        else:               # vector accumulator: mul + add
                            if mac_tmp is None:
                                mac_tmp = b0.take(1, "mac temporary")
                            emit(n.idx, caesar_entry(
                                CaesarOp.MUL, mac_tmp, s1, s2))
                            emit(n.idx, caesar_entry(
                                CaesarOp.ADD, wdest(n, w), wref(acc, w),
                                mac_tmp))
                    elif n.op == "mul" and n.idx in chain_into:
                        x, y = n.args
                        emit(n.idx, caesar_entry(
                            CaesarOp.MAC_INIT, 0, wref(x, w), wref(y, w)))
                        acc_owner = n.idx
                    else:
                        x, y = n.args
                        emit(n.idx, caesar_entry(
                            BINOPS[n.op].caesar_op, wdest(n, w),
                            wref(x, w), wref(y, w)))

        post = _make_post(spans, self.lanes, dt)
        used = b0.pos + (b1.pos - _CAESAR_BANK_WORDS)
        # the value-dependent image words, trace order: one splat word per
        # consts-pool element (the activation taps a resident-weights
        # caller patches per call — serve/block.py)
        cspans = tuple((cpool_base[n.idx], int(n.ne))
                       for n in nodes if n.op == "cpool")
        return LoweredKernel("caesar", self.sew, stream, mem,
                             (out_base, out_words), post, b.oracle(),
                             used_words=used, kernel=b.name,
                             init_spans=tuple(init_spans), prov=prov,
                             cpool_spans=cspans)


class _Cursor:
    """Bump allocator over one memory bank with capacity diagnostics."""

    def __init__(self, base: int, limit: int, kernel: str = "kernel"):
        self.base, self.pos, self.limit = base, base, limit
        self.kernel = kernel

    def take(self, n_words: int, what: str) -> int:
        addr = self.pos
        self.pos += n_words
        if self.pos > self.limit:
            raise LoweringError(
                f"{self.kernel}: NM-Caesar bank overflow allocating "
                f"{n_words} words for {what}: "
                f"{self.pos - self.base}/{self.limit - self.base} "
                f"words used")
        return addr


# ---------------------------------------------------------------------------
# NM-Carus lowering: chunked registers, indirect addressing, in-place reuse
# ---------------------------------------------------------------------------

class _CarusLowering:
    def __init__(self, builder: ProgramBuilder):
        bad = engine_diagnosis(builder, "carus")
        if bad is not None:
            raise bad
        self.b = builder
        self.sew = builder.sew
        self.lanes = 32 // self.sew
        self.rw = C.CARUS_REG_WORDS
        self.vlmax = self.rw * self.lanes

    def words(self, ne: int) -> int:
        return -(-ne // self.lanes)

    def chunks(self, ne: int) -> int:
        return max(1, -(-self.words(ne) // self.rw))

    def vl_of(self, n: _Node) -> int:
        """Single-register values run at their exact element count;
        register-spanning values use the vlmax indirect-loop template
        (exactly the paper's Section III-B1 kernel structure)."""
        return n.ne if self.chunks(n.ne) == 1 else self.vlmax

    def lower(self) -> LoweredKernel:
        b = self.b
        nodes = b.nodes
        consumers = b.consumers()
        compute_set = {n.idx for n in b.compute_nodes()}
        stored_first: dict[int, int] = {}
        for si, (node, _t) in enumerate(b.stores):
            if node.idx in stored_first:
                raise LoweringError(
                    f"{b.name} (traced op#{node.idx}): storing one value "
                    f"twice is not supported on NM-Carus")
            stored_first[node.idx] = si

        # -- output blocks (contiguous registers, store order) ---------------
        reg = 0
        spans: list[tuple[int, int]] = []
        out_words = 0
        home: dict[int, int] = {}       # node idx -> destination base reg
        for node, trim in b.stores:
            home[node.idx] = reg
            spans.append((reg * self.rw, trim))
            out_words = reg * self.rw + self.words(trim)
            reg += self.chunks(node.ne)

        # -- destination propagation: single-use producers compute straight
        # into their consumer's eventual output block (in-place VMACC
        # chains, leaky-relu's shift temp, gemm epilogues — the register-
        # pressure trick of the paper's hand-written kernels)
        uses = {n.idx: len(consumers[n.idx]) for n in nodes}
        for n in reversed(b.compute_nodes()):
            h = home.get(n.idx)
            if h is None:
                continue
            if n.op == "mac":
                acc = n.args[0]
                if isinstance(acc, _Node) and acc.idx in compute_set \
                        and uses[acc.idx] == 1 and acc.idx not in home:
                    home[acc.idx] = h       # the chain accumulates in place
            elif n.op in BINOPS:
                for a in n.args:
                    if isinstance(a, _Node) and a.idx in compute_set \
                            and uses[a.idx] == 1 and a.idx not in home:
                        home[a.idx] = h     # compute straight into the output
                        break

        # -- loads, const pools, temp space ----------------------------------
        block: dict[int, int] = {}
        for n in nodes:
            if n.op == "load":
                block[n.idx] = reg
                reg += self.chunks(n.ne)
        cpool_top = C.CARUS_N_VREGS
        cpool_base: dict[int, int] = {}
        for n in nodes:
            if n.op == "cpool":
                cpool_top -= -(-self.words(n.ne) // self.rw)
                cpool_base[n.idx] = cpool_top
        if reg > cpool_top:
            raise LoweringError(
                f"{b.name}: NM-Carus register file overflow: {reg} "
                f"registers of outputs+loads vs {cpool_top} available "
                f"below the const pools")
        temp = _RegAlloc(reg, cpool_top, b.name)

        # -- image ------------------------------------------------------------
        vrf = np.zeros((C.CARUS_N_VREGS, self.rw), np.int32)
        flat = vrf.reshape(-1)
        dt = alu.NP_DTYPES[self.sew]
        init_spans: list[tuple[int, int]] = []     # image-defined words
        for n in nodes:
            if n.op in ("load", "cpool"):
                base = block[n.idx] if n.op == "load" else cpool_base[n.idx]
                nw = self.words(n.ne)
                padded = np.zeros(nw * self.lanes, dt)
                padded[:n.ne] = n.val.astype(dt)
                flat[base * self.rw: base * self.rw + nw] = \
                    alu.pack_np(padded)
                init_spans.append((base * self.rw, nw))

        # -- emission ---------------------------------------------------------
        stream: list = []
        prov: list[int] = []                   # instr index -> tracer op idx
        remaining = dict(uses)
        cur_vl = None

        def emit(idx: int, entry) -> None:
            stream.append(entry)
            prov.append(idx)

        def setvl(idx: int, vl: int):
            nonlocal cur_vl
            if cur_vl != vl:
                emit(idx, carus_entry(VOp.VSETVL, sval1=vl))
                cur_vl = vl

        def consume(*operands):
            for x in operands:
                if isinstance(x, _Node):
                    remaining[x.idx] -= 1

        def reusable(x) -> bool:
            return isinstance(x, _Node) and remaining[x.idx] == 0 \
                and x.idx in block and x.idx not in home and x.op != "cpool"

        def release_dead(operands, chosen: int):
            """Return dead operand blocks (other than the one reused as the
            destination) to the temp free list."""
            seen = set()
            for x in operands:
                if reusable(x) and x.idx not in seen \
                        and block[x.idx] != chosen:
                    temp.free(block[x.idx], self.chunks(x.ne))
                    seen.add(x.idx)

        def scalar_emvx(idx: int, x) -> int:
            """Emit the eCPU tap read for a consts element; returns the
            wrapped scalar value for the following .vx op."""
            if isinstance(x, _ConstScalar):
                base = cpool_base[x.pool.idx]
                emit(idx, carus_entry(
                    VOp.EMVX, vs2=base + x.index // self.vlmax,
                    sval1=x.index % self.vlmax))
                return x.value
            return _wrap_scalar(x, self.sew)

        def dest_for(n: _Node, reuse: Sequence = ()) -> int:
            if n.idx in home:
                return home[n.idx]
            for cand in reuse:
                if reusable(cand):
                    return block[cand.idx]
            return temp.take(self.chunks(n.ne), repr(n))

        for n in b.compute_nodes():
            nch = self.chunks(n.ne)
            setvl(n.idx, self.vl_of(n))
            if n.op == "slide_down":
                (src,) = n.args
                src_base = block[src.idx]
                consume(src)
                d = dest_for(n, (src,))
                release_dead((src,), d)
                block[n.idx] = d
                emit(n.idx, carus_entry(
                    VOp.VSLIDEDOWN, vd=d, vs2=src_base,
                    sval1=n.amount, mode=isa.MODE_VX))
                continue
            if n.op == "mac":
                acc, x, y = n.args
                vec = y if isinstance(y, _Node) else x
                sca = x if vec is y else y
                acc_base = block[acc.idx]
                consume(acc, x, y)
                d = dest_for(n) if remaining[acc.idx] > 0 \
                    else home.get(n.idx, acc_base)
                if d != acc_base:
                    # the accumulator value is still live elsewhere, or it
                    # lives outside this mac's output block (e.g. a loaded
                    # C matrix): copy it, then accumulate into the copy
                    # (VMACC is in-place)
                    for i in range(nch):
                        emit(n.idx, carus_entry(
                            VOp.VMV,
                            sval2=isa.pack_indices(d + i, 0, acc_base + i),
                            mode=isa.MODE_VV | isa.MODE_INDIRECT))
                release_dead((acc, x, y), d)
                block[n.idx] = d
                if isinstance(sca, _Node):   # vector-vector mac
                    for i in range(nch):
                        emit(n.idx, carus_entry(
                            VOp.VMACC,
                            sval2=isa.pack_indices(d + i, block[x.idx] + i,
                                                   block[y.idx] + i),
                            mode=isa.MODE_VV | isa.MODE_INDIRECT))
                else:
                    sval = scalar_emvx(n.idx, sca)
                    for i in range(nch):
                        emit(n.idx, carus_entry(
                            VOp.VMACC, sval1=sval,
                            sval2=isa.pack_indices(d + i,
                                                   block[vec.idx] + i, 0),
                            mode=isa.MODE_VX | isa.MODE_INDIRECT))
                continue
            # binops (including the "mul" chain head, whose scalar tap may
            # sit in the first operand slot — mul is commutative)
            x, y = n.args
            if not isinstance(x, _Node):
                x, y = y, x
            spec = BINOPS[n.op]
            if isinstance(y, _Node):
                xb, yb = block[x.idx], block[y.idx]
                consume(x, y)
                d = dest_for(n, (x, y))
                release_dead((x, y), d)
                block[n.idx] = d
                for i in range(nch):
                    emit(n.idx, carus_entry(
                        spec.carus_vop,
                        sval2=isa.pack_indices(d + i, xb + i, yb + i),
                        mode=isa.MODE_VV | isa.MODE_INDIRECT))
            else:
                xb = block[x.idx]
                consume(x)
                d = dest_for(n, (x,))
                release_dead((x,), d)
                block[n.idx] = d
                if spec.carus_imm and not isinstance(y, _ConstScalar):
                    for i in range(nch):
                        emit(n.idx, carus_entry(
                            spec.carus_vop, imm=_wrap_scalar(y, self.sew),
                            sval2=isa.pack_indices(d + i, xb + i, 0),
                            mode=isa.MODE_VI | isa.MODE_INDIRECT))
                else:
                    sval = scalar_emvx(n.idx, y)
                    for i in range(nch):
                        emit(n.idx, carus_entry(
                            spec.carus_vop, sval1=sval,
                            sval2=isa.pack_indices(d + i, xb + i, 0),
                            mode=isa.MODE_VX | isa.MODE_INDIRECT))

        post = _make_post(spans, self.lanes, dt)
        used = (temp.next + (C.CARUS_N_VREGS - cpool_top)) * self.rw
        # NOTE: on NM-Carus the consts *values* also ride in the instruction
        # stream (EMVX taps embed sval1), so patching these VRF spans alone
        # does NOT retarget a resident program — serve/block.py rejects
        # carus residency for exactly this reason; the spans are recorded
        # for accounting/introspection symmetry only.
        cspans = tuple((cpool_base[n.idx] * self.rw, int(n.ne))
                       for n in nodes if n.op == "cpool")
        return LoweredKernel("carus", self.sew, stream, vrf,
                             (0, out_words), post, b.oracle(),
                             ecpu_instrs=3, used_words=used, kernel=b.name,
                             init_spans=tuple(init_spans), prov=prov,
                             cpool_spans=cspans)


class _RegAlloc:
    """Temp vector-register allocator: bump pointer + exact-size free list,
    bounded by the const-pool floor."""

    def __init__(self, start: int, limit: int, kernel: str = "kernel"):
        self.next = start
        self.limit = limit
        self.kernel = kernel
        self.free_list: dict[int, list[int]] = {}

    def take(self, n_regs: int, what: str) -> int:
        stack = self.free_list.get(n_regs)
        if stack:
            return stack.pop()
        base = self.next
        self.next += n_regs
        if self.next > self.limit:
            raise LoweringError(
                f"{self.kernel}: NM-Carus register file overflow "
                f"allocating {n_regs} registers for {what}: need "
                f"{self.next}, {self.limit} available (32 minus const "
                f"pools)")
        return base

    def free(self, base: int, n_regs: int) -> None:
        self.free_list.setdefault(n_regs, []).append(base)


# ---------------------------------------------------------------------------
# CompiledKernel + public entry points
# ---------------------------------------------------------------------------

_LOWERINGS = {"caesar": _CaesarLowering, "carus": _CarusLowering}


def _check_engine(engine: str) -> str:
    """Eager engine-name validation, shared by decoration-time kwargs and
    per-call overrides (a typo must raise a named ValueError, never a
    deep-stack KeyError)."""
    if engine != "auto" and engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: expected 'auto' or "
                         f"one of {ENGINES}")
    return engine


def _check_backend(backend: str) -> str:
    """Eager backend-name validation (same discipline as
    :func:`_check_engine`): ``"auto"``, ``"torch"`` or ``"cuda"``."""
    from repro_torch.nmc.engine import BACKENDS
    if backend != "auto" and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected 'auto' or "
                         f"one of {BACKENDS}")
    return backend


def _check_tiles(tiles) -> int:
    try:
        n = int(tiles)
    except (TypeError, ValueError):
        raise ValueError(
            f"tiles must be an int >= 1, got {tiles!r}") from None
    if n < 1:
        raise ValueError(f"tiles must be >= 1, got {n}")
    return n


def _check_checkmode(check: str) -> str:
    """Eager check-mode validation (same discipline as
    :func:`_check_engine`): ``"error"``, ``"warn"`` or ``"off"``."""
    from repro_torch.nmc.check import CHECK_MODES
    if check not in CHECK_MODES:
        raise ValueError(f"unknown check mode {check!r}: expected one of "
                         f"{CHECK_MODES}")
    return check


def _check_schedule(schedule):
    """Validate a ``schedule=`` argument: a mode name or an explicit
    :class:`repro_torch.nmc.schedule.SchedulePlan` (deferred import — the
    scheduler builds on this module)."""
    from repro_torch.nmc.schedule import SCHEDULE_MODES, SchedulePlan
    if isinstance(schedule, SchedulePlan):
        return schedule
    if schedule not in SCHEDULE_MODES:
        raise ValueError(
            f"unknown schedule {schedule!r}: expected a SchedulePlan or "
            f"one of {SCHEDULE_MODES}")
    return schedule


def _check_opt(opt: str) -> str:
    """Eager opt-level validation (same discipline as
    :func:`_check_engine`): ``"O1"`` or ``"off"``."""
    from repro_torch.nmc.opt import OPT_LEVELS
    if opt not in OPT_LEVELS:
        raise ValueError(f"unknown opt level {opt!r}: expected one of "
                         f"{OPT_LEVELS}")
    return opt


def _apply_report(report, mode: str) -> None:
    """Enforce a :class:`repro_torch.nmc.check.CheckReport` under the kernel's
    ``check=`` policy: ``"error"`` raises on errors, ``"warn"`` surfaces
    any finding as a Python warning."""
    if mode == "error":
        report.raise_if_errors()
    elif mode == "warn" and (report.errors or report.warnings):
        import warnings
        warnings.warn("static verification: " + report.render(),
                      stacklevel=3)


class CompiledKernel:
    """A traced kernel bound to an engine policy and element width.

    Calling it runs the whole stack synchronously (trace → select →
    lower → bucketed/resident dispatch → extract); ``call_async`` submits
    through the shared :class:`repro_torch.nmc.runtime.DispatchQueue` and
    returns an :class:`repro_torch.nmc.runtime.NMCFuture` whose ``result()`` is
    bit-exact equal to the synchronous output."""

    def __init__(self, fn: Callable, engine: str = "auto", sew: int = 8,
                 runtime: Optional[NmcRuntime] = None, tiles: int = 1,
                 partition: str = "auto", backend: str = "auto",
                 check: str = "error", opt: str = "O1",
                 schedule="uniform"):
        # kwargs validate eagerly: a typo'd engine string or an impossible
        # tile count must fail at decoration time with a named cause, not
        # as a deep-stack assertion at first call
        _check_engine(engine)
        _check_backend(backend)
        _check_checkmode(check)
        _check_opt(opt)
        _check_schedule(schedule)
        if sew not in alu.SEWS:
            raise ValueError(
                f"unsupported sew {sew!r}: expected one of "
                f"{tuple(sorted(alu.SEWS))}")
        tiles = _check_tiles(tiles)
        if partition not in PARTITIONS:
            raise ValueError(
                f"unknown partition strategy {partition!r}: expected one "
                f"of {PARTITIONS}")
        self.fn = fn
        self.engine = engine
        self.sew = sew
        self.tiles = tiles
        self.partition = partition
        self.backend = backend
        self.check = check
        self.opt = opt
        self.schedule = schedule
        self._runtime = runtime
        self.__name__ = getattr(fn, "__name__", "kernel")
        self.__doc__ = getattr(fn, "__doc__", None)

    def __repr__(self):
        return (f"CompiledKernel({self.__name__}, engine={self.engine!r}, "
                f"sew={self.sew}, tiles={self.tiles})")

    @property
    def runtime(self) -> NmcRuntime:
        return self._runtime if self._runtime is not None \
            else default_runtime()

    # -- pipeline stages -----------------------------------------------------
    def trace(self, *args, sew: Optional[int] = None) -> ProgramBuilder:
        builder = ProgramBuilder(sew or self.sew, name=self.__name__)
        self.fn(TileContext(builder), *args)
        if not builder.stores:
            raise LoweringError(f"kernel '{self.__name__}' stored no "
                                f"outputs — call t.store(...)")
        return builder

    def select_engine(self, *args, sew: Optional[int] = None) -> str:
        return select_engine(self.trace(*args, sew=sew))

    def _schedule_mode(self, schedule):
        return self.schedule if schedule is None else _check_schedule(schedule)

    def _check_mode(self, check: Optional[str]) -> str:
        return self.check if check is None else _check_checkmode(check)

    def _opt_level(self, opt: Optional[str]) -> str:
        return self.opt if opt is None else _check_opt(opt)

    def lower(self, *args, engine: Optional[str] = None,
              sew: Optional[int] = None,
              check: Optional[str] = None,
              opt: Optional[str] = None) -> LoweredKernel:
        builder = self.trace(*args, sew=sew)
        eng = _check_engine(engine) if engine is not None else self.engine
        if eng == "auto":
            eng = select_engine(builder)
        lk = _LOWERINGS[eng](builder).lower()
        level = self._opt_level(opt)
        if level != "off":
            # optimize before the check= gate so the verifier's report
            # describes the program the engine will actually run; every
            # rewrite was already translation-validated internally
            from repro_torch.nmc import opt as _opt
            _opt.optimize(lk, level)
        mode = self._check_mode(check)
        if mode != "off":
            from repro_torch.nmc import check as _chk
            _apply_report(_chk.verify_lowered(lk), mode)
        return lk

    def oracle(self, *args, sew: Optional[int] = None) -> np.ndarray:
        """Pure-numpy reference output (the traced ``alu.*_np`` values)."""
        return self.trace(*args, sew=sew).oracle()

    # -- partitioning (DESIGN.md §9) -----------------------------------------
    def plan_partition(self, *args, tiles: Optional[int] = None,
                       sew: Optional[int] = None):
        """Trace the kernel and shard its tape across the tile array via
        :func:`repro_torch.nmc.partition.plan` (the planner layer)."""
        from repro_torch.nmc import partition as P
        n = self.tiles if tiles is None else _check_tiles(tiles)
        return P.plan(self.trace(*args, sew=sew), n, self.partition)

    def plan_schedule(self, *args, tiles: Optional[int] = None,
                      engine: Optional[str] = None, schedule=None):
        """Trace the kernel and return the :class:`SchedulePlan` the wave
        scheduler picks for it (DESIGN.md §14) — cached, so a following
        call/``lower_wave`` with the same policy reuses the search."""
        from repro_torch.nmc import schedule as S
        n = self.tiles if tiles is None else _check_tiles(tiles)
        eng = _check_engine(engine) if engine is not None else self.engine
        mode = self._schedule_mode(schedule)
        return S.plan_wave(self.trace(*args), n, partition=self.partition,
                           engine=eng, mode=mode)[0]

    def lower_wave(self, *args, engine: Optional[str] = None,
                   tiles: Optional[int] = None,
                   check: Optional[str] = None,
                   opt: Optional[str] = None,
                   schedule=None):
        """Lower a scheduled wave: returns ``(plan, lowered_shards)`` in
        dispatch order, with every shard program NOP-padded to its
        *engine group's* common instruction bucket — a single-engine wave
        lands in one bucketed group (one kernel handle, one batched
        dispatch), while a mixed Caesar+Carus wave pads per engine so each
        group batches on its own wave kernel."""
        from repro_torch.nmc import schedule as S
        n = self.tiles if tiles is None else _check_tiles(tiles)
        eng = _check_engine(engine) if engine is not None else self.engine
        mode = self._schedule_mode(schedule)
        splan, pplan, lks = S.plan_wave(
            self.trace(*args), n, partition=self.partition, engine=eng,
            mode=mode)
        level = self._opt_level(opt)
        if level != "off":
            # shards optimize *before* the common-bucket agreement: a
            # compacted wave drops into the smaller bucket as a unit
            from repro_torch.nmc import opt as _opt
            for lk in lks:
                _opt.optimize(lk, level)
        for group in sorted({lk.engine for lk in lks}):
            members = [lk for lk in lks if lk.engine == group]
            bucket = instr_bucket(max(lk.program.n_instr
                                      for lk in members))
            for lk in members:
                lk.pad_to(bucket)
        cmode = self._check_mode(check)
        if cmode != "off":
            # partition safety + per-shard verification, over the *padded*
            # shard programs — the exact wave the scheduler will dispatch
            from repro_torch.nmc import check as _chk
            _apply_report(_chk.verify_wave(pplan.parent, pplan, lks,
                                           kernel=self.__name__), cmode)
        return pplan, lks

    # -- execution -----------------------------------------------------------
    def __call__(self, *args, engine: Optional[str] = None,
                 tiles: Optional[int] = None,
                 backend: Optional[str] = None,
                 opt: Optional[str] = None,
                 schedule=None) -> np.ndarray:
        """Synchronous call: submit and resolve immediately.  Shares the
        async path's tiles and executor cache, so sync and async are bit-exact
        by construction and device state stays bounded (one resident
        buffer per runtime tile, re-installed per call)."""
        return self.call_async(*args, engine=engine, tiles=tiles,
                               backend=backend, opt=opt,
                               schedule=schedule).result()

    def resolve_backend(self, backend: Optional[str] = None) -> str:
        """The executor this call will use: per-call override > kernel
        default > runtime default; ``"auto"`` follows the runtime, whose
        own default is the card (``"cuda"``)."""
        from repro_torch.nmc.engine import resolve_backend
        bk = self.backend if backend is None else _check_backend(backend)
        if bk == "auto":
            rt_bk = getattr(self.runtime, "backend", None)
            return rt_bk if rt_bk is not None else resolve_backend("auto")
        return bk

    def call_async(self, *args, engine: Optional[str] = None,
                   tiles: Optional[int] = None,
                   backend: Optional[str] = None,
                   opt: Optional[str] = None,
                   schedule=None):
        """Submit through the runtime's DispatchQueue; returns the future
        immediately (double-buffered staging, batched launch waves).

        With ``tiles=1`` the kernel runs whole on the runtime's shared
        head tile and the result is an
        :class:`repro_torch.nmc.runtime.NMCFuture`.  With ``tiles=N > 1``
        the partitioning planner shards the traced tape across the
        runtime's tile set (``jit_tiles``): every shard submits to its own
        tile — the queue batches them into one launch wave and, since the
        shard programs are pre-padded to one common instruction bucket per
        engine, one kernel handle covers each engine group — and the
        result is a :class:`repro_torch.nmc.runtime.GatherFuture` whose
        ``result()`` reassembles the caller's array (bit-exact vs the
        single-tile path by construction).  Per-tile FIFO order keeps any
        number of in-flight futures correct either way."""
        n = self.tiles if tiles is None else _check_tiles(tiles)
        bk = self.resolve_backend(backend)
        rt = self.runtime
        if n == 1:
            lk = self.lower(*args, engine=engine, opt=opt)
            return rt.queue.submit(rt.jit_tile, lk.program, image=lk.mem,
                                   out_slice=lk.out_slice, post=lk.post,
                                   backend=bk)
        from repro_torch.nmc.runtime import GatherFuture
        pplan, lks = self.lower_wave(*args, engine=engine, tiles=n, opt=opt,
                                     schedule=schedule)
        futs = [rt.queue.submit(tile, lk.program, image=lk.mem,
                                out_slice=lk.out_slice, post=lk.post,
                                backend=bk)
                for tile, lk in zip(rt.jit_tiles(len(lks)), lks)]
        return GatherFuture(futs, pplan.gather)


def jit(fn: Optional[Callable] = None, *, engine: str = "auto", sew: int = 8,
        runtime: Optional[NmcRuntime] = None, tiles: int = 1,
        partition: str = "auto", backend: str = "auto",
        check: str = "error", opt: str = "O1", schedule="uniform"):
    """Compile a traced kernel function into a :class:`CompiledKernel`.

    ``engine`` is ``"auto"`` (NM-Caesar when bus-expressible, NM-Carus
    otherwise), ``"caesar"`` or ``"carus"`` — an explicit engine that
    cannot express the body raises :class:`UnsupportedOnEngine` naming the
    op.  ``sew`` is the element width (8/16/32).  ``tiles`` shards every
    call across that many tiles through the partitioning planner
    (DESIGN.md §9) — ``partition`` picks the split strategy (``"auto"``,
    ``"rows"``, ``"axis"``).  ``backend`` picks the executor:
    ``"torch"`` (plain PyTorch engines), ``"cuda"`` (hand-written
    kernels), or ``"auto"`` (the runtime's backend, the card by default).
    ``check`` runs the static verifier (:mod:`repro_torch.nmc.check`,
    DESIGN.md §11) on every lowered program: ``"error"`` (default —
    raise :class:`repro_torch.nmc.check.VerificationError` on any error-severity
    diagnostic), ``"warn"`` (surface findings as Python warnings) or
    ``"off"``.  ``opt`` runs the analysis-driven IR optimizer
    (:mod:`repro_torch.nmc.opt`, DESIGN.md §13) on every lowered program:
    ``"O1"`` (default — translation-validated rewrites: dead-write
    elimination, NOP/VSETVL compaction, bank-conflict-aware placement,
    copy coalescing) or ``"off"``; both are overridable per call.
    ``schedule`` picks the wave scheduler (:mod:`repro_torch.nmc.schedule`,
    DESIGN.md §14): ``"uniform"`` (default — seed strategy and engine,
    cost-picked uniform chunking and tail placement), ``"auto"`` (the
    full autotuner: chunk skew, per-shard engine mix, dispatch order) or
    an explicit :class:`repro_torch.nmc.schedule.SchedulePlan`; overridable
    per call.  All kwargs validate eagerly with ``ValueError``.  Usable
    as a decorator (``@nmc.jit`` / ``@nmc.jit(engine="carus", tiles=4)``)
    or a call."""
    if fn is None:
        return lambda f: CompiledKernel(f, engine=engine, sew=sew,
                                        runtime=runtime, tiles=tiles,
                                        partition=partition, backend=backend,
                                        check=check, opt=opt,
                                        schedule=schedule)
    return CompiledKernel(fn, engine=engine, sew=sew, runtime=runtime,
                          tiles=tiles, partition=partition, backend=backend,
                          check=check, opt=opt, schedule=schedule)


def kernel(fn: Optional[Callable] = None, **options):
    """Decorator sugar for :func:`jit` with default options: numpy-style
    tracing, engine auto-selection, SEW 8."""
    return jit(fn, **options)
