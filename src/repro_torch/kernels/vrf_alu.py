"""The NM-Carus VPU as a program-as-data kernel: the hand-written CUDA
kernel's wrapper.

The counterpart of the JAX package's Pallas ``vrf_alu``: an ``(n_instr,
6)`` int32 program (op, vd, vs1, vs2, scalar, mode; ops in
:data:`ref.VRF_OPS`) runs over an ``(n_regs, VL)`` int8/int16/int32 register
file in ONE launch, and the file is updated **in place** (the Pallas call
aliases its input to its output: the buffer is storage and operand at
once).  The kernel (``repro_torch/csrc/vrf_alu.cu``, built for ``sm_90a``
at first use) takes any VL; the Pallas wrapper needed VL to divide its
lane block.

On CPU tensors :func:`vrf_alu` runs the plain version
(:func:`ref.vrf_alu`), and only because the tensors lie on the CPU; on
CUDA tensors it launches the kernel or raises.  Both check the program on
the host first and raise ``ValueError`` on a register index outside
``[0, n_regs)``.  On the card the wrapper then compiles the program
(:func:`compile_prog`): the registers it touches get dense slots, so a
block keeps only those in shared memory, and the kernel loads only the
registers the program reads before it writes them and stores only those it
writes.
``vrf_alu.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import cuda_build
from repro_torch.kernels import ref

_VP, _I = ctypes.c_void_p, ctypes.c_int
#: the C interface of csrc/vrf_alu.cu: vrf, code, n_instr, n_slots, n_load,
#: n_store, vl, elem_bytes, block, stream
ARGTYPES = [_VP, _VP] + [_I] * 7 + [_VP]
#: shared memory a block may give its register slab
SLAB_BYTES = 200 * 1024
#: columns each thread owns (kCols in csrc/vrf_alu.cu)
COLS = 4


def make_prog(entries: list, device=None) -> torch.Tensor:
    """``(op_name, vd, vs1, vs2, scalar, mode)`` tuples -> an int32
    ``(n, 6)`` program tensor (on the CPU unless ``device`` is given)."""
    rows = [(ref.VRF_OP_ID[op], vd, vs1, vs2, scalar, mode)
            for (op, vd, vs1, vs2, scalar, mode) in entries]
    arr = np.asarray(rows, dtype=np.int32).reshape(-1, len(ref.VRF_FIELDS))
    return torch.as_tensor(arr, device=device)


def block_size(n_slots: int) -> int:
    """Threads per block: the most (up to 256) whose ``(n_slots, COLS,
    block)`` int32 slab fits :data:`SLAB_BYTES`."""
    for block in (256, 128, 64, 32):
        if n_slots * COLS * block * 4 <= SLAB_BYTES:
            return block
    raise ValueError(f"vrf_alu: {n_slots} registers do not fit a block's "
                     f"shared memory (at most {SLAB_BYTES // (128 * COLS)})")


class Compiled:
    """A checked program in the kernel's form: ``code`` (int32: the
    ``(register, slot)`` pairs to load, those to store, then the rows with
    registers replaced by slots) and its counts."""

    def __init__(self, code: torch.Tensor, n_instr: int, n_slots: int,
                 n_load: int, n_store: int):
        self.code, self.n_instr, self.n_slots = code, n_instr, n_slots
        self.n_load, self.n_store = n_load, n_store

    def to(self, device) -> "Compiled":
        return Compiled(self.code.to(device), self.n_instr, self.n_slots,
                        self.n_load, self.n_store)


def compile_prog(rows: list) -> Compiled:
    """Rows checked by :func:`ref.check_vrf_program` -> the kernel's form.
    A register is loaded when the program reads it (vs2 unless the op is
    mv, vs1 in vv mode) before any instruction writes it, and stored when
    the program writes it; a register written first gets a slot but no
    load.  An operand the op ignores points at slot 0."""
    slot: dict = {}
    reads, writes = set(), set()
    for op, vd, vs1, vs2, _, mode in rows:
        used = []
        if ref.VRF_OPS[op] != "mv":
            used.append(vs2)
        if mode == ref.VRF_MODE_VV:
            used.append(vs1)
        reads.update(r for r in used if r not in writes)
        writes.add(vd)
        for r in used + [vd]:
            slot.setdefault(r, len(slot))
    body = [(op, slot[vd], slot.get(vs1, 0), slot.get(vs2, 0), scalar, mode)
            for op, vd, vs1, vs2, scalar, mode in rows]
    code = [v for r in sorted(reads) for v in (r, slot[r])] \
        + [v for r in sorted(writes) for v in (r, slot[r])] \
        + [v for row in body for v in row]
    return Compiled(torch.as_tensor(np.asarray(code, dtype=np.int32)),
                    len(rows), max(len(slot), 1), len(reads), len(writes))


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
    compiled = compile_prog(ref.check_vrf_program(prog, n_regs))
    return launch(vrf, compiled.to(vrf.device))


def launch(vrf: torch.Tensor, compiled: Compiled) -> torch.Tensor:
    """Launch the kernel on a program compiled by :func:`compile_prog`
    (from rows checked against this file) whose code lies on ``vrf``'s
    device.  The one place the kernel launches, and where
    ``vrf_alu.launches`` counts."""
    vl = vrf.shape[1]
    c = compiled
    if c.n_instr == 0 or vl == 0:
        return vrf
    fn = cuda_build.entry("vrf_alu", ARGTYPES)
    with torch.cuda.device(vrf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(vrf.data_ptr(), c.code.data_ptr(), c.n_instr, c.n_slots,
                c.n_load, c.n_store, vl, vrf.element_size(),
                block_size(c.n_slots), stream)
    cuda_build.check_launch("vrf_alu", rc)
    vrf_alu.launches += 1
    return vrf


vrf_alu.launches = 0
