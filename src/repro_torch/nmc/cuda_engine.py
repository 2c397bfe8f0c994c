"""CUDA engine backend: each NMC wave is one hand-written kernel launch.

The counterpart of the JAX package's Pallas engine.  A bucketed wave of T
same-shape programs runs as **one** launch of ``caesar_wave`` or
``carus_wave`` (``repro_torch/csrc/*.cu``, built for ``sm_90a`` at first use
by :mod:`repro_torch.cuda_build`): one block per tile, the tile's 32 KiB
image resident in shared memory for the whole instruction stream, and the
int32 word image updated in place — the paper's near-memory thesis applied
to the simulator: N instructions cost one memory round trip, not N.

Lowering contract:

* **tile-batch dimension -> grid.**  Tile ``t`` of the wave is block ``t``;
  tiles are independent by construction, so blocks never communicate.
* **memory image -> shared memory, in place.**  Both kernels take the int32
  word image (``[T, 8192]`` for Caesar, ``[T, 32, 256]`` for Carus) and
  unpack / pack lanes inside the kernel, so no separate passes run around
  the launch.
* **instruction stream -> runtime data.**  The kernels never specialise on
  a program's contents, only on SEW (one template instance per width), so
  the pools' kernel-handle cache keys on shape alone.

The Caesar kernel runs a tile's stream in windows of
:data:`CAESAR_WINDOW` instructions, one per lane of a warp.  One warp
analyses the windows ahead, value-free: for each source the latest earlier
writer of the word in the window, for each word its last writer.  Another
warp executes them: lanes compute in rounds, forwarding operands from their
producer lanes by warp shuffles, the MAC and DOT accumulators run as
segmented scans over the window, and only each word's last writer stores
it.  A tile's time is its windows times a window's latency, which grows by
one round per level of the read-after-write chain inside the window
(:func:`caesar_window_rounds`); bytes play no part.

The Carus kernel runs :data:`CARUS_THREADS` threads per tile, thread ``t``
owning word ``t`` of every vector register.  It decodes each instruction
once per tile, in chunks of :data:`CARUS_CHUNK` (one per thread), into
16-byte records in shared memory: register indices reduced, the scalar
operand, and the VL in force, which depends only on the trace's VSETVLs.
VNOP, EMVX and VSETVL write nothing and are compacted out.  Every op but
the slides touches only the executing thread's own words, so the block
synchronises once per chunk and around each slide (before its gathers and
before its write).  A tile's time is its executed records times one warp's
latency per record, plus the slides' barriers (:func:`carus_schedule`).

The wrappers :func:`caesar_wave` and :func:`carus_wave` check device, dtype,
shape and contiguity, launch on ``torch.cuda.current_stream()`` and count
their launches in a plain integer (``caesar_wave.launches``).  On CPU
tensors they run the plain PyTorch version instead (the engines of
:mod:`repro_torch.core`), and only because the tensors lie on the CPU; on a
CUDA tensor they launch the kernel or raise — there is no fallback.  The
``"cuda"`` engines themselves refuse CPU state outright.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch import cuda_build
from repro_torch.core import isa
from repro_torch.core.caesar import CaesarEngine
from repro_torch.core.carus import CarusVPU
from repro_torch.core.isa import VOp
from repro_torch.nmc.engine import CaesarTile, CarusTile

CAESAR_FIELDS = isa.CAESAR_TRACE_DTYPE.names
#: instructions per window of the Caesar kernel (``kWindow`` in
#: ``csrc/caesar_wave.cu``): one per lane of a warp
CAESAR_WINDOW = 32
CARUS_FIELDS = isa.CARUS_TRACE_DTYPE.names
#: threads per tile of the Carus kernel (``kThreads`` in
#: ``csrc/carus_wave.cu``): thread t owns word t of every vector register
CARUS_THREADS = 256
#: instructions the Carus kernel decodes per chunk (``kChunk``), one a thread
CARUS_CHUNK = 256
#: one record of the Carus kernel's decode, as :func:`carus_schedule` gives
#: it (``bar_gather`` / ``bar_write``: the barriers before a slide's gathers
#: and before its write)
CARUS_RECORD_DTYPE = np.dtype([
    ("op", "<i4"), ("vd", "<i4"), ("vs1", "<i4"), ("vs2", "<i4"),
    ("vv", "?"), ("slide1", "?"), ("scalar", "<i4"), ("aux", "<i4"),
    ("vl", "<i4"), ("chunk", "<i4"), ("bar_gather", "?"),
    ("bar_write", "?")])

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned (the kernels "
                         f"move the image in 16-byte vectors)")


def caesar_wave(fields: dict, mem: torch.Tensor, sew: int) -> torch.Tensor:
    """Run a wave of NM-Caesar streams: ``fields`` holds int32 ``[T, n]``
    ``op/dest/src1/src2``; ``mem`` is the int32 ``[T, 8192]`` image,
    updated **in place** and returned."""
    if mem.device.type == "cpu":
        mem.copy_(CaesarEngine().run_stream(mem, fields, sew)[0])
        return mem
    n_tiles, mem_words = mem.shape
    n_instr = fields["op"].shape[-1]
    _check("mem", mem, (n_tiles, 8192), mem.device)
    for k in CAESAR_FIELDS:
        _check(k, fields[k], (n_tiles, n_instr), mem.device)
    fn = cuda_build.entry("caesar_wave", [_VP] * 5 + [_I] * 4 + [_VP])
    with torch.cuda.device(mem.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(fields[k].data_ptr() for k in CAESAR_FIELDS),
                mem.data_ptr(), n_tiles, n_instr, mem_words, sew, stream)
    cuda_build.check_launch("caesar_wave", rc)
    if n_tiles:                             # the entry launches nothing else
        caesar_wave.launches += 1
    return mem


_WRITES = frozenset(int(o) for o in isa.CAESAR_STORE_OPS)
_ACCUMULATES = {int(o): chain for chain, ops in (
    ("mac", isa.CAESAR_MAC_OPS), ("dot", isa.CAESAR_DOT_OPS)) for o in ops}
_INITS = (int(isa.CaesarOp.MAC_INIT), int(isa.CaesarOp.DOT_INIT))


def caesar_window_rounds(entries) -> np.ndarray:
    """Rounds the Caesar kernel takes for each window of one program
    (``op``, ``dest``, ``src1``, ``src2`` fields): the depth of the
    read-after-write chain inside the window.  A lane computes one round
    after the latest earlier writers of its sources in the window are done
    (round 1 without any); an accumulator lane is done once every lane of
    its MAC or DOT segment up to it has its operands.  Value-free."""
    fields = [np.asarray(entries[k]).tolist()
              for k in ("op", "dest", "src1", "src2")]
    n = len(fields[0])
    rounds = np.zeros(-(-n // CAESAR_WINDOW), dtype=np.int64)
    for w in range(len(rounds)):
        writer_round: dict[int, int] = {}      # word -> its latest writer's
        segment = {"mac": 0, "dot": 0}
        for op, dest, s1, s2 in zip(*(f[w * CAESAR_WINDOW:
                                         (w + 1) * CAESAR_WINDOW]
                                      for f in fields)):
            chain = _ACCUMULATES.get(op)
            if op not in _WRITES and chain is None:
                continue                        # CSRW, NOP
            r = 1 + max(writer_round.get(s1, 0), writer_round.get(s2, 0))
            if chain is not None:
                segment[chain] = r if op in _INITS else max(segment[chain], r)
                r = segment[chain]
            if op in _WRITES:
                writer_round[dest] = r
            rounds[w] = max(rounds[w], r)
    return rounds


def carus_wave(fields: dict, vrf: torch.Tensor, sew: int) -> torch.Tensor:
    """Run a wave of NM-Carus traces: ``fields`` holds the eight int32
    ``[T, n]`` CARUS_TRACE_DTYPE fields; ``vrf`` is the int32
    ``[T, 32, 256]`` register file, updated **in place** and returned."""
    if vrf.device.type == "cpu":
        vrf.copy_(CarusVPU().run_trace(vrf, fields, sew)[0])
        return vrf
    n_tiles, n_regs, reg_words = vrf.shape
    n_instr = fields["op"].shape[-1]
    _check("vrf", vrf, (n_tiles, 32, 256), vrf.device)
    for k in CARUS_FIELDS:
        _check(k, fields[k], (n_tiles, n_instr), vrf.device)
    fn = cuda_build.entry("carus_wave", [_VP] * 9 + [_I] * 5 + [_VP])
    with torch.cuda.device(vrf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(fields[k].data_ptr() for k in CARUS_FIELDS),
                vrf.data_ptr(), n_tiles, n_instr, n_regs, reg_words, sew,
                stream)
    cuda_build.check_launch("carus_wave", rc)
    if n_tiles and n_instr:                 # the entry launches nothing else
        carus_wave.launches += 1
    return vrf


_CID = isa.COMPACT_ID


@dataclasses.dataclass(frozen=True)
class CarusSchedule:
    """What the Carus kernel's decode makes of one program: the records it
    executes, in trace order (VNOP, EMVX and VSETVL compacted out), and
    the number of chunks.  Each chunk takes one barrier before its records
    run and the image one more before it goes out; each slide takes two."""

    records: np.ndarray
    chunks: int

    @property
    def slide_barriers(self) -> int:
        return int(self.records["bar_gather"].sum()
                   + self.records["bar_write"].sum())

    @property
    def chunk_barriers(self) -> int:
        return self.chunks + 1 if self.chunks else 0

    @property
    def barriers(self) -> int:
        return self.slide_barriers + self.chunk_barriers


def carus_schedule(entries, sew: int) -> CarusSchedule:
    """The Carus kernel's decode of one program (PROG_DTYPE ``entries``),
    value-free: register indices after the indirect selection, mod 32; the
    scalar operand (``imm`` in vi mode, else ``sval1``; EMVV's value); the
    auxiliary word (EMVV's element, ``sval2`` mod the register's elements;
    else ``sval1``, a slide1's edge value); and the VL in force, from the
    trace's VSETVLs alone: VLMAX, then ``min(sval1, VLMAX)`` of the latest
    earlier VSETVL, carried across chunks, and clamped at 0 (a VL at or
    below zero writes nothing)."""
    f = {k: np.asarray(entries[k], np.int64)
         for k in ("op", "dest", "src1", "src2", "sval1", "sval2", "imm",
                   "mode")}
    op, sval1, sval2, mode = f["op"], f["sval1"], f["sval2"], f["mode"]
    n, elems = len(op), 256 * 32 // sew
    indirect = (mode & isa.MODE_INDIRECT) != 0
    opmode = mode & 0x3
    emvv = op == _CID[VOp.EMVV]
    slide = (op == _CID[VOp.VSLIDEUP]) | (op == _CID[VOp.VSLIDEDOWN])
    last_set = np.maximum.accumulate(
        np.where(op == _CID[VOp.VSETVL], np.arange(n), -1))
    before = np.concatenate([[-1], last_set])[:n]
    cols = {
        "op": op,
        "vd": np.where(indirect, sval2 >> 16, f["dest"]) & 31,
        "vs1": np.where(indirect, sval2, f["src1"]) & 31,
        "vs2": np.where(indirect, sval2 >> 8, f["src2"]) & 31,
        "vv": opmode == isa.MODE_VV,
        "slide1": (mode & isa.MODE_SLIDE1) != 0,
        "scalar": np.where(~emvv & (opmode == isa.MODE_VI), f["imm"], sval1),
        "aux": np.where(emvv, sval2 & (elems - 1), sval1),
        "vl": np.where(before >= 0,
                       np.clip(sval1[before], 0, elems), elems),
        "chunk": np.arange(n) // CARUS_CHUNK,
        "bar_gather": slide, "bar_write": slide}
    keep = op <= _CID[VOp.EMVV]
    records = np.zeros(int(keep.sum()), CARUS_RECORD_DTYPE)
    for k, v in cols.items():
        records[k] = v[keep]
    return CarusSchedule(records, -(-n // CARUS_CHUNK))


caesar_wave.launches = 0
carus_wave.launches = 0
KERNELS = (caesar_wave, carus_wave)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# Engine-protocol adapters
# ---------------------------------------------------------------------------

class _CudaMixin:
    """Shared plumbing: per-(sew, tiles, donate) kernel-handle cache; the
    state lives on the card."""

    backend = "cuda"
    _wave = None

    def _on_card(self, state: torch.Tensor) -> None:
        if state.device.type != "cuda":
            raise ValueError(
                f"backend='cuda' runs only on CUDA tensors, got a tensor on "
                f"{state.device}; use backend='torch' on the CPU")

    def init_state(self, image) -> torch.Tensor:
        state = super().init_state(image)
        self._on_card(state)
        return state

    def _make_batched(self, sew: int, donate: bool):
        wave = type(self)._wave

        def run_batch(batch_state, arrays):
            self._on_card(batch_state)
            state = batch_state if donate else batch_state.clone()
            fields = {k: torch.as_tensor(v, device=state.device)
                      .to(torch.int32).contiguous()
                      for k, v in arrays.items()}
            return wave(fields, state.contiguous(), sew)

        return run_batch


class CudaCaesarEngine(_CudaMixin, CaesarTile):
    """NM-Caesar tile on the card: the 8192-word image resident in shared
    memory for the whole instruction stream."""

    _wave = staticmethod(caesar_wave)

    def __init__(self, config=None, device="cuda"):
        super().__init__(config, device)


class CudaCarusEngine(_CudaMixin, CarusTile):
    """NM-Carus tile on the card: the VRF resident in shared memory, one
    thread per word, each instruction decoded once per tile."""

    _wave = staticmethod(carus_wave)

    def __init__(self, config=None, device="cuda"):
        super().__init__(config, device)
