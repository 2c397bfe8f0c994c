"""The port's ``vrf_alu`` (the plain version, on the CPU) against the JAX
reference bit for bit: ``repro.kernels.ref.vrf_alu`` and the Pallas kernel
in interpret mode, on every op x mode x element type, the three programs
of the reference's kernel tests, the kernels demo's programs and random
programs.  Inputs are made with numpy from a seed and handed to both
packages.  The CUDA kernel itself is held against this plain version on
the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``)."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.vrf_alu import make_prog as jmake_prog
from repro.kernels.vrf_alu import vrf_alu as jvrf_alu
from repro_torch.kernels import checks, ops, ref
from repro_torch.kernels import vrf_alu as V

CSRC = pathlib.Path(V.__file__).resolve().parents[1] / "csrc"
VV, VX = ref.VRF_MODE_VV, ref.VRF_MODE_VX


def _reference(vrf: np.ndarray, entries: list) -> np.ndarray:
    """The reference's oracle (``ref.vrf_alu`` over the program's fields)."""
    prog = np.asarray(jmake_prog(entries))
    fields = {k: prog[:, i] for i, k in enumerate(ref.VRF_FIELDS)}
    return np.asarray(jref.vrf_alu(jnp.asarray(vrf), fields))


def _plain(vrf: np.ndarray, entries: list) -> np.ndarray:
    return ref.vrf_alu(torch.from_numpy(vrf.copy()),
                       V.make_prog(entries)).numpy()


def test_op_table_matches_reference_and_kernel():
    assert ref.VRF_OPS == jref.VRF_OPS
    assert ref.VRF_OP_ID == jref.VRF_OP_ID
    assert (ref.VRF_MODE_VV, ref.VRF_MODE_VX) == \
        (jref.VRF_MODE_VV, jref.VRF_MODE_VX)
    src = (CSRC / "vrf_alu.cu").read_text()
    enum = re.search(r"enum Op : int \{(.*?)\};", src, re.S).group(1)
    ids = dict(re.findall(r"(\w+) = (\d+)", enum))
    assert {k.lower(): int(v) for k, v in ids.items()} == ref.VRF_OP_ID
    enum = re.search(r"enum VxShift : int \{(.*?)\};", src, re.S).group(1)
    assert {k.lower().removesuffix("_vx"): int(v) for k, v in
            re.findall(r"(\w+) = (\d+)", enum)} == V.VX_SHIFT_KEY
    assert f"kModeVV = {ref.VRF_MODE_VV}" in src
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kVecBytes"] == V.VEC_BYTES
    assert (consts["kMaxInstr"], consts["kMaxSlots"]) == \
        (V.MAX_INSTR, V.MAX_SLOTS)
    assert f"kMaxSlabBytes = {V.SLAB_BYTES // 1024} * 1024;" in src
    assert (consts["kModeShift"], consts["kStoreShift"], consts["kVdShift"],
            consts["kVs1Shift"], consts["kVs2Shift"], consts["kSlotBits"]) \
        == (V.MODE_SHIFT, V.STORE_SHIFT, V.VD_SHIFT, V.VS1_SHIFT,
            V.VS2_SHIFT, V.SLOT_BITS)


def test_make_prog_matches_reference():
    entries = checks.vrf_every_op_program()
    got = V.make_prog(entries)
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(entries), 6)
    assert np.array_equal(got.numpy(), np.asarray(jmake_prog(entries)))
    assert V.make_prog([]).shape == (0, 6)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("mode", [VV, VX])
@pytest.mark.parametrize("op", ref.VRF_OPS)
def test_every_op_matches_reference(op, mode, dtype):
    rng = np.random.default_rng(ref.VRF_OP_ID[op])
    info = np.iinfo(dtype)
    vrf = rng.integers(info.min, info.max + 1, (6, 64), dtype=dtype)
    vrf[1, :4] = (info.min, info.max, -1, 0)
    vrf[2, :4] = (info.max, info.min, -3, 1)
    # vx scalars past the element range: truncated before use
    entries = [(op, 3, 1, 2, s, mode)
               for s in (-3, 300, -129, 2 ** 31 - 1, -(2 ** 31))]
    entries.append((op, 4, 2, 3, 7, mode))
    assert np.array_equal(_plain(vrf, entries), _reference(vrf, entries))


def test_issue_traps_at_int8():
    vrf = np.zeros((4, 8), np.int8)
    vrf[1] = 1
    got = _plain(vrf, [("add", 2, 0, 1, 300, VX),      # 300 acts as 44
                       ("mv", 3, 0, 0, -129, VX)])     # -129 writes 127
    assert (got[2] == 45).all() and (got[3] == 127).all()
    vrf[1] = 1
    got = _plain(vrf, [("sll", 2, 0, 1, -3, VX)])       # shifts by 5
    assert (got[2] == 32).all()


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("block_vl", [128, 512])
def test_reference_kernel_test_program(dtype, block_vl):
    rng = np.random.default_rng(1)
    vrf = rng.integers(-100, 100, (16, 512)).astype(dtype)
    entries = [("add", 3, 1, 2, 0, VV), ("mul", 4, 3, 3, 0, VV),
               ("max", 5, 0, 4, 0, VX), ("sra", 6, 0, 5, 3, VX),
               ("xor", 7, 6, 5, 0, VV), ("sub", 8, 7, 3, 0, VV),
               ("mv", 9, 0, 0, -5, VX), ("min", 10, 9, 8, 0, VV)]
    want = np.asarray(jvrf_alu(jnp.asarray(vrf), jmake_prog(entries),
                               block_vl=block_vl, interpret=True))
    assert np.array_equal(_plain(vrf, entries), want)
    assert np.array_equal(want, _reference(vrf, entries))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_wrap_extremes_match_interpret_kernel(dtype):
    vrf, entries = checks.vrf_wrap_extremes(dtype)
    want = np.asarray(jvrf_alu(jnp.asarray(vrf), jmake_prog(entries),
                               block_vl=128, interpret=True))
    got = _plain(vrf, entries)
    assert np.array_equal(got, want)
    assert got[11].flat[0] == np.iinfo(vrf.dtype).min     # really wrapped


@pytest.mark.parametrize("seed", range(6))
def test_random_programs_match_interpret_kernel(seed):
    rng = np.random.default_rng(seed)
    dtype = (np.int8, np.int16, np.int32)[seed % 3]
    info = np.iinfo(dtype)
    vrf = rng.integers(info.min, info.max + 1, (16, 256), dtype=dtype)
    entries = checks.vrf_random_program(rng, int(rng.integers(1, 13)), 16)
    want = np.asarray(jvrf_alu(jnp.asarray(vrf), jmake_prog(entries),
                               block_vl=128, interpret=True))
    assert np.array_equal(_plain(vrf, entries), want)


def test_smoke_cases_match_reference():
    """The cases ``chip_smoke.py`` holds the kernel to on the card (both
    demo programs, every op, the wrap extremes, a ragged VL, and the first
    random programs of 1-64 instructions) give the reference's result."""
    cases = checks.vrf_cases(n_random=12)
    assert len(cases) == 3 * (2 * 3 + 1) + 12
    assert {f.shape[1] for _, f, _ in cases} >= set(checks.VRF_VLS)
    assert any(f.shape[1] % 256 for _, f, _ in cases)
    for label, vrf, entries in cases:
        assert np.array_equal(_plain(vrf, entries),
                              _reference(vrf, entries)), label


def test_updates_in_place_and_returns_the_file():
    vrf = torch.zeros((4, 16), dtype=torch.int16)
    out = V.vrf_alu(vrf, V.make_prog([("mv", 2, 0, 0, 9, VX)]))
    assert out is vrf and (vrf[2] == 9).all() and (vrf[1] == 0).all()
    out = ops.vrf_alu(vrf, V.make_prog([("add", 3, 2, 2, 0, VV)]))
    assert out is vrf and (vrf[3] == 18).all()
    with ops.force_plain():
        assert ops.vrf_alu(vrf, V.make_prog([])) is vrf


def _split(c):
    """A compiled one-launch program's (register, slot) loads, (register,
    instruction) stores and body rows (registers as slots), decoded from its
    parameter struct."""
    assert len(c.launches) == 1
    loads, stores, body = V.unpack(c.launches[0])
    return np.asarray(loads).reshape(-1, 2), np.asarray(stores).reshape(
        -1, 2), np.asarray(body, dtype=np.int64).reshape(-1, 6)


def _run_compiled(vrf: np.ndarray, c, seed: int) -> np.ndarray:
    """What the kernel does with a compiled program, launch by launch: a
    slab of ``n_slots`` rows that starts as junk, the load list copied in,
    the body run over slots one instruction at a time, and each store
    copied out right after its instruction.  A slot read before it is
    loaded or written reads junk."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(vrf.dtype)
    out = vrf.copy()
    for ln in c.launches:
        loads, stores, body = V.unpack(ln)
        slab = torch.from_numpy(rng.integers(
            info.min, info.max + 1, (ln.n_slots, vrf.shape[1]),
            dtype=vrf.dtype))
        for r, s in loads:
            slab[s] = torch.from_numpy(out[r])
        after = {t: r for r, t in stores}
        for t, row in enumerate(body):
            ref.vrf_alu(slab, torch.tensor([row], dtype=torch.int32))
            if t in after:
                out[after[t]] = slab[row[1]].numpy()
    return out


def test_compiled_program_loads_reads_and_stores_writes():
    """The kernel's form of a program: loads of the registers it reads (vs2
    unless mv, vs1 in vv mode) before any instruction writes them, into
    slots 0..n_load-1; slots reused once their value is dead; one store of
    each register it writes, after its last write."""
    rows = ref.check_vrf_program(
        V.make_prog(checks.VRF_DEMO_PROGRAMS["fused_chain"]), 32)
    c = V.compile_prog(rows, 2)
    assert (c.n_instr, c.launches[0].n_slots, c.n_load, c.n_store) == \
        (5, 3, 3, 2)
    loads, stores, body = _split(c)
    # v6 and v7 are written (mul, xor) before they are read (add, min/max)
    assert loads[:, 0].tolist() == [1, 4, 5] == c.reads
    assert loads[:, 1].tolist() == [0, 1, 2]        # load i fills slot i
    # v6 last written by the add (1), v7 by the max (4)
    assert stores.tolist() == [[6, 1], [7, 4]] and c.writes == [6, 7]
    # (vd, vs1, vs2) as slots: v4 dies at the mul and v6 takes its slot; v5
    # and the first v6 die at the add, the new v6 takes the lower; v1 and v6
    # die at the xor and v7 takes the lowest
    assert [row[1:4] for row in body.tolist()] == \
        [[1, 1, 0], [1, 2, 1], [0, 0, 1], [0, 0, 0], [0, 0, 0]]
    for (op, vd, vs1, vs2, sc, mode), row in zip(rows, body.tolist()):
        assert row[0] == op and row[5] == mode
        packed = V.pack_scalar(sc, 2) if mode == VX else 0
        assert row[4] % 2 ** 32 == packed
    mv = V.compile_prog(ref.check_vrf_program(
        V.make_prog([("mv", 3, 0, 9, 5, VX)]), 16), 4)
    assert (mv.launches[0].n_slots, mv.n_load, mv.n_store) == (1, 0, 1)
    p = mv.launches[0].prog[0]
    assert (p["n_instr"], p["n_load"], p["n_store"], p["n_slots"]) == \
        (1, 0, 1, 1)
    assert p["store_reg"][0] == 3
    # op 11, the vx and store flags, vd / vs1 / vs2 in slot 0; the scalar
    # as it is
    assert p["ins"][0].tolist() == \
        [11 | 1 << V.MODE_SHIFT | 1 << V.STORE_SHIFT, 5]


def test_compiled_program_reads_only_what_it_loads_or_wrote():
    """Registers read first (also in place, ``vd == vs2``) are loaded, and
    running the compiled form over a slab of junk equals the plain version
    on every case of kernels/checks.py and on random programs."""
    c = V.compile_prog(ref.check_vrf_program(V.make_prog([
        ("mv", 2, 0, 0, 7, VX), ("add", 3, 0, 3, 1, VX),
        ("sub", 2, 2, 3, 0, VV)]), 8), 1)
    loads, stores, _ = _split(c)
    # stored in the order of their last writes: v3 by the add, v2 by the sub
    assert loads[:, 0].tolist() == [3] and stores.tolist() == [[3, 1], [2, 2]]
    rng = np.random.default_rng(5)
    cases = checks.vrf_cases(n_random=8)
    for n in range(40):
        vrf = rng.integers(-2 ** 15, 2 ** 15, (16, 64), dtype=np.int16)
        cases.append((f"random {n}", vrf, checks.vrf_random_program(
            rng, int(rng.integers(1, 25)), 16)))
    for k, (label, vrf, entries) in enumerate(cases):
        prog = V.make_prog(entries)
        c = V.compile_prog(ref.check_vrf_program(prog, vrf.shape[0]),
                           vrf.itemsize)
        assert np.array_equal(_run_compiled(vrf, c, k),
                              _plain(vrf, entries)), label


def test_cpu_wrapper_runs_the_plain_version_without_launching():
    vrf = torch.arange(64, dtype=torch.int32).reshape(4, 16)
    before = V.vrf_alu.launches
    V.vrf_alu(vrf, V.make_prog(checks.VRF_DEMO_PROGRAMS["leaky_relu"]))
    assert V.vrf_alu.launches == before


@pytest.mark.parametrize("bad", [
    ("add", 8, 0, 1, 0, VV), ("add", 9, 0, 1, 0, VV),      # vd past the file
    ("add", 1, -1, 1, 0, VV), ("add", 1, 0, 8, 0, VV),    # vs1, vs2
    ("add", -1, 0, 1, 0, VX)])
def test_out_of_range_register_raises(bad):
    vrf = torch.zeros((8, 32), dtype=torch.int8)
    prog = V.make_prog([("add", 1, 0, 0, 0, VV), bad])
    with pytest.raises(ValueError, match="register"):
        V.vrf_alu(vrf.clone(), prog)
    with pytest.raises(ValueError, match="register"):
        ref.vrf_alu(vrf.clone(), prog)
    assert (vrf == 0).all()


def test_bad_programs_and_files_raise():
    vrf = torch.zeros((8, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="unknown op"):
        ref.vrf_alu(vrf, torch.tensor([[12, 0, 0, 0, 0, 0]],
                                      dtype=torch.int32))
    with pytest.raises(ValueError):
        ref.vrf_alu(vrf, torch.zeros((2, 5), dtype=torch.int32))
    with pytest.raises(TypeError):
        ref.vrf_alu(vrf, torch.zeros((2, 6), dtype=torch.int64))
    with pytest.raises(TypeError):
        ref.vrf_alu(vrf.to(torch.int64), V.make_prog([]))
    with pytest.raises(ValueError):
        V.block_size(1024)
    assert V.block_size(32) == 256 and V.block_size(100) == 128
