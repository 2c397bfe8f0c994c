"""The ``vrf_alu`` kernel's packed-word lane arithmetic and its launch
parameters, emulated in numpy on the CPU.

``csrc/vrf_alu.cu`` keeps 16 bytes of every register per thread as four
32-bit words of 4 / 2 / 1 lanes and computes on whole words: ``__vadd4``
... ``__vmaxs4`` (``...2`` at int16), masks after vx shifts, lanes taken to
32 bits and packed back with ``__byte_perm`` for mul and vv shifts.  The
functions below repeat those formulas one for one (an intrinsic by its
documented per-lane meaning), run the compiled launches (:data:`PROG_DTYPE`
decoded with the kernel's shifts and masks) over a slab of junk, and are
held against the port's ``ref.vrf_alu`` and the JAX package's
``vrf_alu(..., interpret=True)`` on inputs made with numpy from a seed.
Two mutated emulations, a carry that crosses a lane and an unsigned min,
must fail the same comparisons.  The kernel itself is held against the
plain version on the card (``tests/test_torch_cuda_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.vrf_alu import make_prog as jmake_prog
from repro.kernels.vrf_alu import vrf_alu as jvrf_alu
from repro_torch.kernels import checks, ref
from repro_torch.kernels import vrf_alu as V

VV, VX = ref.VRF_MODE_VV, ref.VRF_MODE_VX
U32 = np.uint32
NP = {8: np.int8, 16: np.int16, 32: np.int32}
TORCH = {8: torch.int8, 16: torch.int16, 32: torch.int32}
OP = ref.VRF_OP_ID
KVX = 1 << V.MODE_SHIFT


# ---- one 32-bit word of BITS-wide lanes, as the .cu writes it -----------

def lane_ones(bits):
    return U32({8: 0x01010101, 16: 0x00010001, 32: 1}[bits])


def lane_mask(bits):
    return U32(0xFFFFFFFF if bits == 32 else (1 << bits) - 1)


def byte_perm(x, y, s):
    """``__byte_perm``: byte n of the result is byte ``(s >> 4n) & 7`` of
    the 8-byte value ``y:x``."""
    src = [(x >> U32(8 * k)) & U32(0xFF) for k in range(4)] \
        + [(y >> U32(8 * k)) & U32(0xFF) for k in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(s >> (4 * n)) & 7] << U32(8 * n)
    return out


def pack4(p0, p1, p2, p3):
    return byte_perm(byte_perm(p0, p1, 0x0040), byte_perm(p2, p3, 0x0040),
                     0x5410)


def pack2(p0, p1):
    return byte_perm(p0, p1, 0x5410)


def _lanes(x, bits):
    return [(x >> U32(bits * k)) & lane_mask(bits) for k in range(32 // bits)]


def _signed(lane, bits):
    lane = lane.astype(np.int64)
    return np.where(lane >= 1 << (bits - 1), lane - (1 << bits), lane)


def _join(lanes, bits):
    out = np.zeros_like(lanes[0], dtype=U32)
    for k, v in enumerate(lanes):
        out |= (np.asarray(v).astype(np.int64) & int(lane_mask(bits))) \
            .astype(U32) << U32(bits * k)
    return out


def intrinsic(fn, bits, a, b):
    """A per-lane intrinsic (``__vadd4``, ``__vmins2``, ...) by its
    documented meaning: ``fn`` on each pair of signed lanes, wrapped."""
    return _join([fn(_signed(x, bits), _signed(y, bits))
                  for x, y in zip(_lanes(a, bits), _lanes(b, bits))], bits)


def w_add(a, b, bits):
    return a + b if bits == 32 else intrinsic(np.add, bits, a, b)


def w_sub(a, b, bits):
    return a - b if bits == 32 else intrinsic(np.subtract, bits, a, b)


def w_min(a, b, bits):
    if bits == 32:
        return np.where(a.view(np.int32) < b.view(np.int32), a, b)
    return intrinsic(np.minimum, bits, a, b)


def w_max(a, b, bits):
    if bits == 32:
        return np.where(a.view(np.int32) > b.view(np.int32), a, b)
    return intrinsic(np.maximum, bits, a, b)


def w_mul(a, b, bits):
    if bits == 8:
        return pack4(a * b, (a >> U32(8)) * (b >> U32(8)),
                     (a >> U32(16)) * (b >> U32(16)),
                     (a >> U32(24)) * (b >> U32(24)))
    if bits == 16:
        return pack2(a * b, (a >> U32(16)) * (b >> U32(16)))
    return a * b


def w_sll_vx(a, sh, bits):
    if bits == 32:
        return a << sh
    m = lane_mask(bits)
    return (a << sh) & (lane_ones(bits) * ((m << sh) & m))


def w_srl_vx(a, sh, bits):
    if bits == 32:
        return a >> sh
    return (a >> sh) & (lane_ones(bits) * (lane_mask(bits) >> sh))


def w_sra_vx(a, sh, bits):
    if bits == 32:
        return (a.view(np.int32) >> sh.astype(np.int32)).view(U32)
    n = ((a >> U32(bits - 1)) & lane_ones(bits)) * lane_mask(bits)
    return w_srl_vx(a ^ n, sh, bits) ^ n


def w_sll_vv(a, b, bits):
    if bits == 8:
        return pack4(a << (b & U32(7)), (a >> U32(8)) << ((b >> U32(8)) & U32(7)),
                     (a >> U32(16)) << ((b >> U32(16)) & U32(7)),
                     (a >> U32(24)) << ((b >> U32(24)) & U32(7)))
    if bits == 16:
        return pack2(a << (b & U32(15)),
                     (a >> U32(16)) << ((b >> U32(16)) & U32(15)))
    return a << (b & U32(31))


def w_srl_vv(a, b, bits):
    if bits == 8:
        return pack4((a & U32(0xFF)) >> (b & U32(7)),
                     ((a >> U32(8)) & U32(0xFF)) >> ((b >> U32(8)) & U32(7)),
                     ((a >> U32(16)) & U32(0xFF)) >> ((b >> U32(16)) & U32(7)),
                     (a >> U32(24)) >> ((b >> U32(24)) & U32(7)))
    if bits == 16:
        return pack2((a & U32(0xFFFF)) >> (b & U32(15)),
                     (a >> U32(16)) >> ((b >> U32(16)) & U32(15)))
    return a >> (b & U32(31))


def lane_s(a, bits, k):
    """Lane k sign-extended to 32 bits: shifted to the top, then down."""
    return (a << U32(32 - bits * (k + 1))).view(np.int32) >> (32 - bits)


def w_sra_vv(a, b, bits):
    def sra(k, m):
        sh = ((b >> U32(bits * k)) & U32(m)).astype(np.int32)
        return (lane_s(a, bits, k) >> sh).view(U32)
    if bits == 8:
        return pack4(sra(0, 7), sra(1, 7), sra(2, 7), sra(3, 7))
    if bits == 16:
        return pack2(sra(0, 15), sra(1, 15))
    return (a.view(np.int32) >> (b & U32(31)).astype(np.int32)).view(U32)


def _vx_shift(fn):
    return lambda a, b, bits: fn(a, b & U32(bits - 1), bits)


#: the kernel's dispatch, by key: an op's id, or a vx shift's key
WORD_OPS = {
    OP["add"]: w_add, OP["sub"]: w_sub, OP["mul"]: w_mul, OP["min"]: w_min,
    OP["max"]: w_max, OP["and"]: lambda a, b, _: a & b,
    OP["or"]: lambda a, b, _: a | b, OP["xor"]: lambda a, b, _: a ^ b,
    OP["mv"]: lambda a, b, _: b.copy(),
    OP["sll"]: w_sll_vv, OP["srl"]: w_srl_vv, OP["sra"]: w_sra_vv,
    V.VX_SHIFT_KEY["sll"]: _vx_shift(w_sll_vx),
    V.VX_SHIFT_KEY["srl"]: _vx_shift(w_srl_vx),
    V.VX_SHIFT_KEY["sra"]: _vx_shift(w_sra_vx),
}

#: mutations that must fail: a 32-bit add whose carry crosses lanes, and an
#: unsigned lane min
MUTANTS = {
    "carry-across-lanes": {OP["add"]: lambda a, b, _: a + b},
    "unsigned-min": {OP["min"]: lambda a, b, bits: _join(
        [np.minimum(x, y) for x, y in zip(_lanes(a, bits), _lanes(b, bits))],
        bits)},
}


def emulate(vrf: np.ndarray, compiled, ops=WORD_OPS, seed: int = 0):
    """The kernel over ``vrf`` (numpy ``(n_regs, VL)``), launch by launch:
    each 16-byte vector of a row is a thread's four words, its slab starts
    as junk, the launch's code words are decoded with the kernel's shifts
    and masks, an instruction with the store flag stores its result to the
    next register of the store list, and only the row's bytes go back."""
    n_regs, vl = vrf.shape
    bits = vrf.itemsize * 8
    row_bytes = vl * vrf.itemsize
    n_vec = -(-row_bytes // V.VEC_BYTES)
    raw = np.zeros((n_regs, n_vec * V.VEC_BYTES), np.uint8)
    raw[:, :row_bytes] = vrf.view(np.uint8).reshape(n_regs, row_bytes)
    words = raw.view(U32).reshape(n_regs, n_vec, 4)
    rng = np.random.default_rng(seed)
    mask = (1 << V.SLOT_BITS) - 1
    for ln in compiled.launches:
        p = ln.prog[0]
        slab = rng.integers(0, 2 ** 32, (int(p["n_slots"]), n_vec, 4),
                            dtype=np.uint64).astype(U32)
        for i in range(int(p["n_load"])):
            slab[i] = words[p["load_reg"][i]]
        i_store = 0
        for t in range(int(p["n_instr"])):
            w, scalar = (int(x) for x in p["ins"][t])
            a = slab[w >> V.VS2_SHIFT & mask]
            c = slab[w >> V.VS1_SHIFT & mask]
            b = np.full_like(a, scalar) if w & KVX else c
            r = ops[w & 0xF](a, b, bits)
            slab[w >> V.VD_SHIFT & mask] = r
            if w >> V.STORE_SHIFT & 1:
                words[p["store_reg"][i_store]] = r
                i_store += 1
        assert i_store == int(p["n_store"])
    out = words.reshape(n_regs, -1).view(np.uint8)[:, :row_bytes]
    return np.ascontiguousarray(out).view(vrf.dtype).reshape(vrf.shape)


def _compiled(vrf: np.ndarray, entries: list):
    rows = ref.check_vrf_program(V.make_prog(entries), vrf.shape[0])
    return V.compile_prog(rows, vrf.itemsize)


def _plain(vrf: np.ndarray, entries: list) -> np.ndarray:
    return ref.vrf_alu(torch.from_numpy(vrf.copy()),
                       V.make_prog(entries)).numpy()


def _edge_file(bits: int, seed: int, vl: int = 64) -> np.ndarray:
    """Lanes at the edges: 0x7f and 0xff (+1 carries into the next lane
    of a word), the type's extremes, -1 / 0 / 1, and shift amounts that
    are negative or at or past the width; the rest random."""
    dt = NP[bits]
    info = np.iinfo(dt)
    rng = np.random.default_rng(seed)
    vrf = rng.integers(info.min, info.max + 1, (8, vl), dtype=dt)
    lane_7f = (1 << (bits - 1)) - 1 if bits > 8 else 0x7F
    vrf[1] = np.resize(np.array([0x7F, -1, lane_7f, info.min, info.max, 0,
                                 1, -2], np.int64), vl).astype(dt)
    vrf[2] = np.resize(np.array([1, 1, 1, -1, info.max, info.min, -1, 3],
                                np.int64), vl).astype(dt)
    vrf[3] = np.resize(np.array([-1, -bits, bits, bits + 3, 2 * bits - 1,
                                 0, -(bits + 1), info.min], np.int64),
                       vl).astype(dt)
    return vrf


def _op_program(op: str, mode: int) -> list:
    scalars = (1, -1, 0x7F, 300, -129, 2 ** 31 - 1, -(2 ** 31), 7)
    if mode == VV:
        return [(op, 4, 2, 1, 0, VV), (op, 5, 3, 1, 0, VV),
                (op, 6, 1, 0, 0, VV), (op, 7, 1, 1, 0, VV),
                (op, 1, 3, 1, 0, VV)]
    return [(op, 4 + i % 4, 0, 1 + i % 3, s, VX)
            for i, s in enumerate(scalars)]


def _every_op_program() -> list:
    entries = []
    for i, op in enumerate(ref.VRF_OPS):
        entries += [(op, 4 + i % 4, 3, 1, 0, VV),
                    (op, 4 + (i + 1) % 4, 0, 2, (-1) ** i * (129 + 37 * i),
                     VX)]
    return entries


# ---- the emulation against both packages --------------------------------

@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("mode", [VV, VX])
@pytest.mark.parametrize("op", ref.VRF_OPS)
def test_emulation_matches_plain_on_every_op(op, mode, bits):
    vrf = _edge_file(bits, OP[op] + 17 * mode)
    entries = _op_program(op, mode)
    got = emulate(vrf, _compiled(vrf, entries))
    assert np.array_equal(got, _plain(vrf, entries))


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_emulation_matches_the_interpret_kernel(bits):
    vrf = _edge_file(bits, bits, vl=128)
    entries = _every_op_program() + _op_program("sra", VV) \
        + _op_program("sll", VX)
    want = np.asarray(jvrf_alu(jnp.asarray(vrf), jmake_prog(entries),
                               block_vl=64, interpret=True))
    assert np.array_equal(emulate(vrf, _compiled(vrf, entries)), want)
    assert np.array_equal(_plain(vrf, entries), want)


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_lane_edges_wrap_within_their_lane(bits):
    """0x7f + 1 and 0xff + 1 in every lane, min / max at the extremes, vv
    shifts by negative amounts and amounts at or past the width."""
    info = np.iinfo(NP[bits])
    vrf = np.zeros((6, 16), NP[bits])
    vrf[1] = (1 << (bits - 1)) - 1                  # 0x7f.. in every lane
    vrf[2] = -1                                     # 0xff.. in every lane
    vrf[3] = 1
    vrf[4, ::2], vrf[4, 1::2] = info.min, info.max
    entries = [("add", 5, 3, 1, 0, VV)]
    got = emulate(vrf, _compiled(vrf, entries))
    assert (got[5] == info.min).all()
    entries = [("add", 5, 3, 2, 0, VV)]             # carry out of every lane
    assert (emulate(vrf, _compiled(vrf, entries))[5] == 0).all()
    entries = [("min", 5, 2, 4, 0, VV), ("max", 0, 3, 4, 0, VV)]
    got = emulate(vrf, _compiled(vrf, entries))
    assert (got[5, ::2] == info.min).all() and (got[5, 1::2] == -1).all()
    assert (got[0, ::2] == 1).all() and (got[0, 1::2] == info.max).all()
    vrf[5] = np.resize([-1, bits, bits + 1, -bits], 16)
    entries = [("sll", 0, 5, 3, 0, VV), ("sra", 4, 5, 4, 0, VV)]
    got = emulate(vrf, _compiled(vrf, entries))
    assert got[0].tolist() == np.resize(
        np.array([1 << (bits - 1), 1, 2, 1], np.int64), 16).astype(
        NP[bits]).tolist()
    assert np.array_equal(got, _plain(vrf, entries))


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_emulation_matches_plain_on_random_programs(bits):
    rng = np.random.default_rng(bits)
    for n in range(6):
        vrf = checks.vrf_random_file(rng, (16, 48), TORCH[bits])
        entries = checks.vrf_random_program(rng, int(rng.integers(1, 40)),
                                            16)
        assert np.array_equal(emulate(vrf, _compiled(vrf, entries), seed=n),
                              _plain(vrf, entries)), n


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("mode", [VV, VX])
@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_mutated_emulations_fail(mutant, mode, bits):
    vrf = _edge_file(bits, 3)
    op = {"carry-across-lanes": "add", "unsigned-min": "min"}[mutant]
    entries = _op_program(op, mode)
    c = _compiled(vrf, entries)
    assert np.array_equal(emulate(vrf, c), _plain(vrf, entries))
    ops = {**WORD_OPS, **MUTANTS[mutant]}
    assert not np.array_equal(emulate(vrf, c, ops), _plain(vrf, entries))


def test_emulation_matches_plain_on_the_edge_cases():
    """Every case of ``checks.vrf_edge_cases`` (ragged rows, offsets, long
    and wide programs, vv shifts, empty) through the emulation, and the
    launches each states."""
    for label, f, entries, _, launches in checks.vrf_edge_cases():
        c = _compiled(f, entries)
        assert (len(c.launches) if f.shape[1] else 0) == launches, label
        assert np.array_equal(emulate(f, c), _plain(f, entries)), label


# ---- the launch parameters ---------------------------------------------

def test_prog_struct_round_trips():
    entries = checks.vrf_every_op_program()
    rows = ref.check_vrf_program(V.make_prog(entries), 32)
    for elem in (1, 2, 4):
        c = V.compile_prog(rows, elem)
        (ln,) = c.launches
        assert ln.prog.dtype == V.PROG_DTYPE
        assert V.PROG_DTYPE.itemsize == 16 + 8 * V.MAX_SLOTS \
            + 8 * (V.MAX_INSTR + 1) <= 4096
        back = np.frombuffer(ln.prog.tobytes(), V.PROG_DTYPE)
        assert back.tobytes() == ln.prog.tobytes()
        loads, stores, body = V.unpack(ln)
        assert [s for _, s in loads] == list(range(len(loads)))
        assert len(body) == len(rows)
        # the register each slot holds, followed through the program
        holds = {s: r for r, s in loads}
        last = {vd: t for t, (_, vd, *_) in enumerate(rows)}
        assert stores == sorted(last.items(), key=lambda x: x[1])
        for (op, vd, vs1, vs2, sc, mode), got in zip(rows, body):
            vx = mode != VV
            assert got[0] == op and got[5] == vx
            assert got[2] == 0 if vx else holds[got[2]] == vs1
            assert got[3] == 0 if op == OP["mv"] else holds[got[3]] == vs2
            holds[got[1]] = vd
            want = V.pack_scalar(sc, elem) if vx else 0
            assert got[4] % 2 ** 32 == want
        assert max(max(g[1:4]) for g in body) < ln.n_slots <= V.MAX_SLOTS


def test_scalar_is_truncated_and_copied_to_every_lane():
    assert V.pack_scalar(300, 1) == 0x2C2C2C2C
    assert V.pack_scalar(-129, 1) == 0x7F7F7F7F
    assert V.pack_scalar(-1, 1) == V.pack_scalar(-1, 2) == 0xFFFFFFFF
    assert V.pack_scalar(70000, 2) == 0x11701170
    assert V.pack_scalar(-(2 ** 31), 4) == 0x80000000
    assert V.pack_scalar(5, 4) == 5
    c = V.compile_prog(ref.check_vrf_program(V.make_prog(
        [("add", 1, 0, 0, 300, VX), ("add", 1, 0, 1, 300, VV)]), 2), 1)
    assert c.launches[0].prog["ins"][0, :2, 1].tolist() == [0x2C2C2C2C, 0]


@pytest.mark.parametrize("n_instr", [1, V.MAX_INSTR, V.MAX_INSTR + 1, 700])
def test_a_long_program_splits_into_launches(n_instr):
    """Split into launches, run one after another through the plain
    version, the program gives the same file as whole, and the emulation
    over the launches gives it too."""
    rng = np.random.default_rng(n_instr)
    vrf = checks.vrf_random_file(rng, (32, 32), torch.int16)
    entries = checks.vrf_random_program(rng, n_instr, 32)
    rows = ref.check_vrf_program(V.make_prog(entries), 32)
    chunks = V.split(rows)
    assert len(chunks) == -(-n_instr // V.MAX_INSTR)
    assert [r for c in chunks for r in c] == rows
    out = torch.from_numpy(vrf.copy())
    for c in chunks:
        ref.vrf_alu(out, torch.tensor(c, dtype=torch.int32))
    assert np.array_equal(out.numpy(), _plain(vrf, entries))
    compiled = V.compile_prog(rows, 2)
    assert len(compiled.launches) == len(chunks)
    assert np.array_equal(emulate(vrf, compiled), _plain(vrf, entries))


def test_a_wide_program_splits_by_registers():
    entries = [("xor", i, i + 1, i + 2, 0, VV) for i in range(0, 297, 3)]
    rows = ref.check_vrf_program(V.make_prog(entries), 300)
    chunks = V.split(rows)
    assert len(chunks) == 3
    for c in chunks:
        c_regs = {r for op, vd, vs1, vs2, _, _ in c for r in (vd, vs1, vs2)}
        assert len(c_regs) <= V.MAX_SLOTS
        # every operand is loaded at the start and live until its xor; a
        # result takes the slot of an operand read for the last time
        p = V.compile_prog(c, 1).launches[0].prog[0]
        assert p["n_slots"] == p["n_load"]


def test_route_follows_the_alignment_of_every_row():
    assert V.route(0x1000, 4096) == "aligned"
    assert V.route(0x1000, 4096 + 77) == "ragged"      # rows 2.. misaligned
    assert V.route(0x1001, 4096) == "ragged"           # a view at offset 1
    assert V.route(0x1004, 16) == "ragged"
    assert V.route(0x1010, 32) == "aligned"
