"""The NM-Carus VPU as a program-as-data kernel: the hand-written CUDA
kernel's wrapper.

The counterpart of the JAX package's Pallas ``vrf_alu``: an ``(n_instr,
6)`` int32 program (op, vd, vs1, vs2, scalar, mode; ops in
:data:`ref.VRF_OPS`) runs over an ``(n_regs, VL)`` int8/int16/int32 register
file, and the file is updated **in place** (the Pallas call aliases its
input to its output: the buffer is storage and operand at once).  The
kernel (``repro_torch/csrc/vrf_alu.cu``, built for ``sm_90a`` at first use)
takes any VL and any contiguous file, also a view at an offset; the Pallas
wrapper needed VL to divide its lane block.

On CPU tensors :func:`vrf_alu` runs the plain version
(:func:`ref.vrf_alu`), and only because the tensors lie on the CPU; on
CUDA tensors it launches the kernel or raises.  Both check the program on
the host first and raise ``ValueError`` on a register index outside
``[0, n_regs)``; a program tensor that lies on the card is read back once
for that.  On the card the wrapper then compiles the program
(:func:`compile_prog`, cached by the program's bytes, the file's register
count and its element width) into launches of at most :data:`MAX_INSTR`
instructions over at most :data:`MAX_SLOTS` registers each.  A launch's
program travels in the kernel's parameters (:data:`PROG_DTYPE`, the C
struct ``Prog``): the registers it reads before writing them are loaded
(load i fills slot i), every value holds a slot only while it is live,
each register is stored right after the instruction that writes its final
value, and each instruction is a pair of 32-bit words: one packed code
word and its vx scalar, truncated to the element width and copied into
every lane.  Nothing is copied to the card before a launch.  A longer
program runs as consecutive launches over the in-place file, which gives
the same file.

``vrf_alu.launches`` counts the launches, ``vrf_alu.launches_by_route``
those of each instance (:func:`route`).
"""

from __future__ import annotations

import ctypes
import functools
import heapq

import numpy as np
import torch

from repro_torch import cuda_build
from repro_torch.kernels import ref

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C interface of csrc/vrf_alu.cu: vrf, prog, prog_bytes, row_bytes,
#: elem_bytes, aligned, block_cap, device, stream
ARGTYPES = [_VP, _VP, _I, _LL, _I, _I, _I, _I, _VP]
#: vrf_alu_floor: prog, prog_bytes, stream
FLOOR_ARGTYPES = [_VP, _I, _VP]
#: bytes of every register a thread owns (kVecBytes)
VEC_BYTES = 16
#: instructions and registers one launch holds (kMaxInstr, kMaxSlots)
MAX_INSTR = 256
MAX_SLOTS = 128
#: shared memory a block may give its register slab (kMaxSlabBytes)
SLAB_BYTES = 200 * 1024
#: a code word: the dispatch key in bits 0-3 (the op, or for a vx shift
#: its key in :data:`VX_SHIFT_KEY`), the vx flag in bit 4, the store flag
#: in bit 5, then the slots of vd, vs1 and vs2 in 7 bits each (kModeShift,
#: kStoreShift, kVdShift, ... in the .cu)
MODE_SHIFT, STORE_SHIFT, VD_SHIFT, VS1_SHIFT, VS2_SHIFT, SLOT_BITS = \
    4, 5, 6, 13, 20, 7
#: the dispatch keys of vx shifts (enum VxShift in the .cu)
VX_SHIFT_KEY = {"sll": 12, "srl": 13, "sra": 14}
#: one launch's program, field for field the C struct ``Prog``
PROG_DTYPE = np.dtype([
    ("n_instr", "<i4"), ("n_load", "<i4"), ("n_store", "<i4"),
    ("n_slots", "<i4"), ("load_reg", "<i4", (MAX_SLOTS,)),
    ("store_reg", "<i4", (MAX_SLOTS,)), ("ins", "<u4", (MAX_INSTR + 1, 2))])
#: the kernel instances: rows 16-byte aligned, or not (or a ragged end)
ROUTE_ID = {"aligned": 1, "ragged": 0}
#: programs kept compiled (keyed by their bytes, n_regs, element width)
CACHE_SIZE = 256


def make_prog(entries: list, device=None) -> torch.Tensor:
    """``(op_name, vd, vs1, vs2, scalar, mode)`` tuples -> an int32
    ``(n, 6)`` program tensor (on the CPU unless ``device`` is given)."""
    rows = [(ref.VRF_OP_ID[op], vd, vs1, vs2, scalar, mode)
            for (op, vd, vs1, vs2, scalar, mode) in entries]
    arr = np.asarray(rows, dtype=np.int32).reshape(-1, len(ref.VRF_FIELDS))
    return torch.as_tensor(arr, device=device)


def block_size(n_slots: int) -> int:
    """The most threads per block (up to 256) whose slab of ``n_slots``
    16-byte vectors per thread fits :data:`SLAB_BYTES`; the kernel's host
    code runs the block at or below it that keeps the most threads
    resident."""
    for block in (256, 128, 64, 32):
        if n_slots * VEC_BYTES * block <= SLAB_BYTES:
            return block
    raise ValueError(f"vrf_alu: {n_slots} registers do not fit a block's "
                     f"shared memory (at most {SLAB_BYTES // (32 * VEC_BYTES)})")


def pack_scalar(scalar: int, elem_bytes: int) -> int:
    """A vx scalar truncated to the element width and copied into every
    lane of a 32-bit word (300 -> 0x2c2c2c2c at int8)."""
    bits = 8 * elem_bytes
    lane = int(scalar) & ((1 << bits) - 1)
    return lane * {1: 0x01010101, 2: 0x00010001, 4: 1}[elem_bytes]


def route(data_ptr: int, row_bytes: int) -> str:
    """The kernel instance a file takes: ``aligned`` when its start and
    every row start are 16-byte aligned, else ``ragged``."""
    return "aligned" if data_ptr % VEC_BYTES == 0 \
        and row_bytes % VEC_BYTES == 0 else "ragged"


class Launch:
    """One launch's program: ``prog`` (a ``(1,)`` array of
    :data:`PROG_DTYPE`, the kernel's parameters), its slot count and the
    most threads per block its slab allows (:func:`block_size`)."""

    def __init__(self, prog: np.ndarray):
        self.prog, self.n_slots = prog, int(prog["n_slots"][0])
        self.block = block_size(self.n_slots)


class Compiled:
    """A checked program in the kernel's form: its ``launches`` in order,
    ``n_instr``, and the registers the whole program reads before writing
    them (``reads``) and writes (``writes``), which bound its bytes."""

    def __init__(self, launches: list, n_instr: int, reads: list,
                 writes: list):
        self.launches, self.n_instr = launches, n_instr
        self.reads, self.writes = reads, writes

    @property
    def n_load(self) -> int:
        return len(self.reads)

    @property
    def n_store(self) -> int:
        return len(self.writes)


def _used(op: int, vs1: int, vs2: int, mode: int) -> list:
    """The registers an instruction reads: vs2 unless the op is mv, vs1 in
    vv mode."""
    used = [] if ref.VRF_OPS[op] == "mv" else [vs2]
    if mode == ref.VRF_MODE_VV:
        used.append(vs1)
    return used


def _reads_writes(rows: list) -> tuple:
    """(registers read before any instruction writes them, registers
    written), each sorted."""
    reads, writes = set(), set()
    for op, vd, vs1, vs2, _, mode in rows:
        reads.update(r for r in _used(op, vs1, vs2, mode) if r not in writes)
        writes.add(vd)
    return sorted(reads), sorted(writes)


def split(rows: list) -> list:
    """Consecutive runs of ``rows``, each of at most :data:`MAX_INSTR`
    instructions over at most :data:`MAX_SLOTS` registers: one launch
    each."""
    chunks, regs = [], set()
    for row in rows:
        op, vd, vs1, vs2, _, mode = row
        new = regs | set(_used(op, vs1, vs2, mode)) | {vd}
        if not chunks or len(chunks[-1]) == MAX_INSTR or len(new) > MAX_SLOTS:
            chunks.append([])
            new = set(_used(op, vs1, vs2, mode)) | {vd}
        chunks[-1].append(row)
        regs = new
    return chunks


def _slots(rows: list, reads: list) -> list:
    """The slots of each instruction's ``(vd, vs1, vs2)``: the loaded
    registers hold slots 0..n_load-1 from the start, and every value (a
    load, or one instruction's result) holds its slot from its definition
    to its last read, after which the slot is free for the next value
    (the lowest free slot first).  An instruction reads its operands before
    it writes, so its result may take the slot of an operand read for the
    last time.  An operand the op ignores points at slot 0."""
    cur = {r: -1 for r in reads}               # register -> its value's def
    end = {(r, -1): -1 for r in reads}         # value -> its last read
    for t, (op, vd, vs1, vs2, _, mode) in enumerate(rows):
        for r in _used(op, vs1, vs2, mode):
            end[(r, cur[r])] = t
        cur[vd] = t
        end[(vd, t)] = t
    live = {(r, -1): i for i, r in enumerate(reads)}
    cur = {r: -1 for r in reads}
    free, n_slots, out = [], len(reads), []
    for t, (op, vd, vs1, vs2, _, mode) in enumerate(rows):
        s1 = live[(vs1, cur[vs1])] if mode == ref.VRF_MODE_VV else 0
        s2 = live[(vs2, cur[vs2])] if ref.VRF_OPS[op] != "mv" else 0
        for v in [v for v in live if end[v] <= t]:
            heapq.heappush(free, live.pop(v))
        if free:
            sd = heapq.heappop(free)
        else:
            sd, n_slots = n_slots, n_slots + 1
        live[(vd, t)] = sd
        cur[vd] = t
        out.append((sd, s1, s2))
    return out


def _compile_launch(rows: list, elem_bytes: int) -> Launch:
    """One run of :func:`split` -> its :class:`Launch`: the loads, the
    slots of :func:`_slots`, and a store flag on the last instruction that
    writes each register (its row in ``store_reg``, in instruction
    order)."""
    reads, _ = _reads_writes(rows)
    last = {vd: t for t, (_, vd, *_) in enumerate(rows)}
    slots = _slots(rows, reads)
    stores = [vd for t, (_, vd, *_) in enumerate(rows) if last[vd] == t]
    p = np.zeros(1, PROG_DTYPE)
    p["n_instr"], p["n_load"], p["n_store"] = len(rows), len(reads), \
        len(stores)
    p["n_slots"] = max([len(reads)] + [max(s) + 1 for s in slots] + [1])
    p["load_reg"][0, :len(reads)] = reads
    p["store_reg"][0, :len(stores)] = stores
    for t, ((op, vd, _, _, scalar, mode), (sd, s1, s2)) in enumerate(
            zip(rows, slots)):
        vx = int(mode != ref.VRF_MODE_VV)
        key = VX_SHIFT_KEY.get(ref.VRF_OPS[op], op) if vx else op
        p["ins"][0, t] = ((key | vx << MODE_SHIFT
                           | int(last[vd] == t) << STORE_SHIFT
                           | sd << VD_SHIFT | s1 << VS1_SHIFT
                           | s2 << VS2_SHIFT),
                          pack_scalar(scalar, elem_bytes) if vx else 0)
    return Launch(p)


def compile_prog(rows: list, elem_bytes: int) -> Compiled:
    """Rows checked by :func:`ref.check_vrf_program` -> the kernel's form
    for a file of ``elem_bytes`` elements (the vx scalars are truncated to
    it).  A register is loaded when its launch reads it (vs2 unless the op
    is mv, vs1 in vv mode) before an instruction of that launch writes it,
    and stored once, after the launch's last write of it; a register
    written first is never loaded."""
    reads, writes = _reads_writes(rows)
    return Compiled([_compile_launch(c, elem_bytes) for c in split(rows)],
                    len(rows), reads, writes)


def unpack(launch: Launch) -> tuple:
    """A launch's program back as ``(loads, stores, body)``: the
    ``(register, slot)`` pairs it loads, the ``(register, instruction)``
    pairs it stores (after that instruction, from its result), and its rows
    ``(op, vd, vs1, vs2, scalar, mode)`` with registers as slots, the
    scalar as the packed word read as a signed int32 (0 in vv mode) and the
    mode as the vx flag."""
    p = launch.prog[0]
    n_instr, n_load = int(p["n_instr"]), int(p["n_load"])
    loads = [(int(r), i) for i, r in enumerate(p["load_reg"][:n_load])]
    mask = (1 << SLOT_BITS) - 1
    op_of = {k: ref.VRF_OP_ID[op] for op, k in VX_SHIFT_KEY.items()}
    body, stores = [], []
    for t, (w, s) in enumerate(p["ins"][:n_instr].tolist()):
        vx = w >> MODE_SHIFT & 1
        if w >> STORE_SHIFT & 1:
            stores.append((int(p["store_reg"][len(stores)]), t))
        body.append((op_of.get(w & 0xF, w & 0xF), w >> VD_SHIFT & mask,
                     w >> VS1_SHIFT & mask, w >> VS2_SHIFT & mask,
                     s - (s >> 31 << 32) if vx else 0, vx))
    return loads, stores, body


@functools.lru_cache(maxsize=CACHE_SIZE)
def _compiled(key: bytes, shape: tuple, dtype: str, n_regs: int,
              elem_bytes: int) -> Compiled:
    prog = torch.from_numpy(np.frombuffer(key, np.dtype(dtype))
                            .reshape(shape).copy())
    return compile_prog(ref.check_vrf_program(prog, n_regs), elem_bytes)


def vrf_alu(vrf: torch.Tensor, prog: torch.Tensor) -> torch.Tensor:
    """Execute ``prog`` over ``vrf`` in place and return ``vrf``."""
    if vrf.device.type == "cpu":
        return ref.vrf_alu(vrf, prog)
    if vrf.dtype not in ref.VRF_DTYPES:
        raise TypeError(f"vrf_alu: VRF must be one of {ref.VRF_DTYPES}, got "
                        f"{vrf.dtype}")
    if vrf.dim() != 2:
        raise ValueError("vrf_alu: VRF must be (n_regs, VL)")
    if not vrf.is_contiguous():
        raise ValueError("vrf_alu: VRF must be contiguous (it is updated "
                         "in place)")
    n_regs, vl = vrf.shape
    if vl >= 2 ** 31:
        raise ValueError(f"vrf_alu: VL {vl} does not fit an int32")
    arr = torch.as_tensor(prog).cpu().numpy()
    compiled = _compiled(arr.tobytes(), arr.shape, arr.dtype.str, n_regs,
                         vrf.element_size())
    return launch(vrf, compiled)


def launch(vrf: torch.Tensor, compiled: Compiled) -> torch.Tensor:
    """Run a program compiled by :func:`compile_prog` (from rows checked
    against this file, at its element width) over ``vrf`` on the card: one
    launch per entry of ``compiled.launches``, in order.  The one place the
    kernel launches, and where ``vrf_alu.launches`` counts."""
    vl = vrf.shape[1]
    if not compiled.launches or vl == 0:
        return vrf
    device = vrf.device.index
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(vrf, compiled)
    elem = vrf.element_size()
    row_bytes = vl * elem
    ptr = vrf.data_ptr()
    r = route(ptr, row_bytes)
    fn = cuda_build.entry("vrf_alu", ARGTYPES)
    stream = torch.cuda.current_stream(device).cuda_stream
    for ln in compiled.launches:
        rc = fn(ptr, ln.prog.ctypes.data, PROG_DTYPE.itemsize, row_bytes,
                elem, ROUTE_ID[r], ln.block, device, stream)
        cuda_build.check_launch("vrf_alu", rc)
        vrf_alu.launches += 1
        vrf_alu.launches_by_route[r] += 1
    return vrf


def launch_floor(device) -> None:
    """Launch the empty kernel that takes ``vrf_alu``'s parameters (one
    block of 32 threads) on ``device``'s current stream: the floor under
    any launch, for measurement.  Not counted in ``vrf_alu.launches``."""
    fn = cuda_build.load("vrf_alu").vrf_alu_floor
    fn.argtypes, fn.restype = FLOOR_ARGTYPES, ctypes.c_int
    prog = np.zeros(1, PROG_DTYPE)
    with torch.cuda.device(device):
        rc = fn(prog.ctypes.data, PROG_DTYPE.itemsize,
                torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch("vrf_alu_floor", rc)


vrf_alu.launches = 0
vrf_alu.launches_by_route = dict.fromkeys(ROUTE_ID, 0)
