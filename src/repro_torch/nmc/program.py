"""Unified NMC program IR shared by NM-Caesar and NM-Carus (DESIGN.md §5).

Historically the repo had two program formats — NM-Caesar bus-op streams
(lists of ``(op, dest, src1, src2)`` tuples) and NM-Carus xvnmc issue traces
(lists of :data:`repro_torch.core.isa.CARUS_TRACE_DTYPE` scalars) — and every
downstream consumer (kernel builders, engines, timing, energy, benchmarks)
special-cased both.  This module replaces the split with one structured-array
:class:`Program`:

* one entry dtype (:data:`PROG_DTYPE`) that is a field superset of both
  engine trace formats (Caesar uses ``op/dest/src1/src2``; Carus maps
  ``vd/vs1/vs2 -> dest/src1/src2`` and additionally uses
  ``sval1/sval2/imm/mode``);
* loss-free converters to/from the legacy formats (round-trip tested in
  ``tests/test_nmc_ir.py``);
* :meth:`Program.lower` producing exactly the dict-of-tensors the
  engines consume, keyed by the engine's own field names; and
* :attr:`Program.shape_key` — the ``(engine, sew, n_instr)`` tuple the
  :class:`repro_torch.nmc.pool.TilePool` uses as its jit-cache key.

The IR is deliberately *flat* (a numpy structured array, no objects) so a
batch of T same-shape programs stacks into ``[T, n_instr]`` arrays and runs
as one batched wave unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import isa
from repro_torch.core.isa import CaesarOp, VOp

ENGINES = ("caesar", "carus")

# Field superset of CAESAR_TRACE_DTYPE and CARUS_TRACE_DTYPE.  For Carus
# entries the register fields map vd->dest, vs1->src1, vs2->src2; for Caesar
# entries sval1/sval2/imm/mode are structurally zero.
PROG_DTYPE = np.dtype(
    [("op", "<i4"), ("dest", "<i4"), ("src1", "<i4"), ("src2", "<i4"),
     ("sval1", "<i4"), ("sval2", "<i4"), ("imm", "<i4"), ("mode", "<i4")])

# Carus register-field names in engine order, paired with the IR names.
_CARUS_FIELD_MAP = (("op", "op"), ("vd", "dest"), ("vs1", "src1"),
                    ("vs2", "src2"), ("sval1", "sval1"), ("sval2", "sval2"),
                    ("imm", "imm"), ("mode", "mode"))
_CAESAR_FIELD_MAP = (("op", "op"), ("dest", "dest"), ("src1", "src1"),
                     ("src2", "src2"))


def caesar_entry(op: CaesarOp, dest: int = 0, src1: int = 0,
                 src2: int = 0) -> np.void:
    """One NM-Caesar bus micro-op as an IR entry."""
    e = np.zeros((), dtype=PROG_DTYPE)
    e["op"], e["dest"], e["src1"], e["src2"] = int(op), dest, src1, src2
    return e


def carus_entry(op: VOp, vd: int = 0, vs1: int = 0, vs2: int = 0,
                sval1: int = 0, sval2: int = 0, imm: int = 0,
                mode: int = isa.MODE_VV) -> np.void:
    """One issued NM-Carus xvnmc instruction as an IR entry."""
    e = np.zeros((), dtype=PROG_DTYPE)
    e["op"] = isa.COMPACT_ID[op]
    e["dest"], e["src1"], e["src2"] = vd, vs1, vs2
    e["sval1"], e["sval2"], e["imm"], e["mode"] = (
        np.int32(sval1), np.int32(sval2), np.int32(imm), mode)
    return e


# Per-engine true-NOP opcodes: bit-exact no-op in the scan engines and zero
# cost in timing/energy — the padding filler of the bucketed scheduler.
NOP_OP_ID = {"caesar": int(CaesarOp.NOP), "carus": isa.COMPACT_ID[VOp.VNOP]}


def nop_entry(engine: str) -> np.void:
    """A padding NOP as an IR entry for the given engine."""
    e = np.zeros((), dtype=PROG_DTYPE)
    e["op"] = NOP_OP_ID[engine]
    return e


def instr_bucket(n_instr: int) -> int:
    """Power-of-two instruction-count bucket rule (DESIGN.md §5): programs
    pad up to the next power of two so heterogeneous kernels share one
    traced computation per ``(engine, sew, bucket)``."""
    n = int(n_instr)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class Program:
    """An engine-agnostic NMC program: ``entries`` is a PROG_DTYPE[n] array."""

    engine: str               # "caesar" | "carus"
    sew: int                  # static element width of the whole program
    entries: np.ndarray       # PROG_DTYPE, shape [n_instr]

    def __post_init__(self):
        assert self.engine in ENGINES, self.engine
        assert self.entries.dtype == PROG_DTYPE, self.entries.dtype

    # -- construction --------------------------------------------------------
    @classmethod
    def from_entries(cls, engine: str, sew: int, entries) -> "Program":
        """From a list of PROG_DTYPE scalars (builder / eCPU output).

        Caesar entries are normalized structurally zero in the Carus-only
        fields (``sval1/sval2/imm/mode``): the bus engine never decodes
        them, so junk there would otherwise ride silently through format
        round-trips and defeat the bucket/NOP identities the scheduler
        relies on (and the :mod:`repro_torch.nmc.check` structural pass flags
        it as an error on hand-built programs)."""
        arr = (np.array(entries, dtype=PROG_DTYPE) if len(entries)
               else np.zeros(0, dtype=PROG_DTYPE))
        if engine == "caesar" and len(arr):
            for f in ("sval1", "sval2", "imm", "mode"):
                arr[f] = 0
        return cls(engine, sew, arr)

    @classmethod
    def from_caesar_stream(cls, stream, sew: int = 32) -> "Program":
        """From the legacy list-of-tuples bus-op stream."""
        arr = np.zeros(len(stream), dtype=PROG_DTYPE)
        for i, (op, dest, s1, s2) in enumerate(stream):
            arr[i]["op"], arr[i]["dest"] = int(op), dest
            arr[i]["src1"], arr[i]["src2"] = s1, s2
        return cls("caesar", sew, arr)

    @classmethod
    def from_carus_trace(cls, trace, sew: int) -> "Program":
        """From the legacy list of CARUS_TRACE_DTYPE scalars."""
        arr = np.zeros(len(trace), dtype=PROG_DTYPE)
        for i, e in enumerate(trace):
            for src, dst in _CARUS_FIELD_MAP:
                arr[i][dst] = int(e[src])
        return cls("carus", sew, arr)

    @classmethod
    def from_legacy(cls, stream, sew: int, engine: str | None = None
                    ) -> "Program":
        """Auto-detect the legacy container format (used for EngineBuilds
        constructed by hand, e.g. in tests)."""
        if engine in ENGINES and stream and _dtype_of(stream[0]) == PROG_DTYPE:
            return cls.from_entries(engine, sew, stream)
        if not stream:
            return cls.from_entries(engine or "caesar", sew, [])
        first = stream[0]
        if isinstance(first, (tuple, list)):
            return cls.from_caesar_stream(stream, sew)
        if _dtype_of(first) == isa.CARUS_TRACE_DTYPE:
            return cls.from_carus_trace(stream, sew)
        if _dtype_of(first) == PROG_DTYPE:
            raise TypeError("PROG_DTYPE entries are engine-ambiguous: pass "
                            "engine= (or tag the EngineBuild)")
        raise TypeError(f"cannot infer program format from {type(first)}")

    # -- shape / identity ----------------------------------------------------
    @property
    def n_instr(self) -> int:
        return int(self.entries.shape[0])

    @property
    def shape_key(self) -> tuple:
        """Jit-cache / batching key: programs with equal keys lower to the
        same batched executor (one executor build per key)."""
        return (self.engine, self.sew, self.n_instr)

    @property
    def bucket_key(self) -> tuple:
        """Bucketed jit-cache key ``(engine, sew, instr_bucket(n_instr))``:
        programs with equal bucket keys pad (NOP-fill) to one shared traced
        computation — the compile-count unit of the bucketed scheduler."""
        return (self.engine, self.sew, instr_bucket(self.n_instr))

    @property
    def n_nops(self) -> int:
        """Number of padding NOPs in the stream (zero-cost entries)."""
        return int(np.count_nonzero(
            self.entries["op"] == NOP_OP_ID[self.engine]))

    def with_sew(self, sew: int) -> "Program":
        return self if sew == self.sew else dataclasses.replace(self, sew=sew)

    def pad_to(self, n_instr: int) -> "Program":
        """NOP-pad the instruction stream to exactly ``n_instr`` entries.

        Padding appends true NOPs, so the padded program is bit-exact with
        the original (same final state on either engine) and costs the same
        cycles/energy (NOPs are zero-cost in timing.py / energy.py)."""
        pad = n_instr - self.n_instr
        assert pad >= 0, (n_instr, self.n_instr)
        if pad == 0:
            return self
        entries = np.concatenate(
            [self.entries, np.repeat(nop_entry(self.engine)[None], pad)])
        return dataclasses.replace(self, entries=entries)

    # -- lowering ------------------------------------------------------------
    def field_map(self) -> tuple:
        return (_CAESAR_FIELD_MAP if self.engine == "caesar"
                else _CARUS_FIELD_MAP)

    def lower_np(self) -> dict[str, np.ndarray]:
        """Engine-facing dict of int32 numpy arrays (engine field names)."""
        return {eng_name: np.ascontiguousarray(self.entries[ir_name])
                for eng_name, ir_name in self.field_map()}

    def lower(self, device=None) -> dict:
        """Engine-facing dict of int32 tensors on ``device`` (CPU when
        ``None``), ready for the engines' instruction loops."""
        import torch
        return {k: torch.as_tensor(v, device=device)
                for k, v in self.lower_np().items()}

    # -- decode back to the legacy formats (round-trip tested) ---------------
    def to_caesar_stream(self) -> list[tuple]:
        assert self.engine == "caesar"
        return [(CaesarOp(int(e["op"])), int(e["dest"]), int(e["src1"]),
                 int(e["src2"])) for e in self.entries]

    def to_carus_trace(self) -> list[np.ndarray]:
        assert self.engine == "carus"
        out = []
        for e in self.entries:
            t = np.zeros((), dtype=isa.CARUS_TRACE_DTYPE)
            for eng_name, ir_name in _CARUS_FIELD_MAP:
                t[eng_name] = e[ir_name]
            out.append(t)
        return out

    def vops(self) -> list[VOp]:
        """Decoded Carus opcodes (compact ids -> VOp)."""
        assert self.engine == "carus"
        return [isa.VOP_COMPACT[int(o)] for o in self.entries["op"]]


def _dtype_of(x) -> np.dtype | None:
    return getattr(x, "dtype", None)


def stack_programs(programs: list[Program]) -> dict[str, np.ndarray]:
    """Stack same-shape programs into [T, n_instr] engine-field arrays."""
    key = programs[0].shape_key
    assert all(p.shape_key == key for p in programs), \
        [p.shape_key for p in programs]
    fields = programs[0].field_map()
    return {eng_name: np.stack([p.entries[ir_name] for p in programs])
            for eng_name, ir_name in fields}
