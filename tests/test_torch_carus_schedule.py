"""The NM-Carus wave kernel (``csrc/carus_wave.cu``), emulated in numpy on
the CPU and held bit for bit against the port's plain engine
(``CarusVPU.run_trace``) and the JAX package's scan engine.

The emulation follows the kernel's algorithm, not the serial one: the
records and barriers of ``cuda_engine.carus_schedule`` (the kernel's
decode: register indices reduced, VSETVL / EMVX / VNOP compacted out, the
VL in force carried across chunks), run by ``kThreads`` threads (read from
the source), thread ``t`` owning word ``t`` of every register, in warps of
32.  A slide is a gather step and a write step; the schedule puts a barrier
before each, and one before every chunk.  Between two barriers each warp
runs all its steps before the next warp starts, once in warp order and once
reversed, so a missing barrier shows as a wrong image.  (Between barriers
with no gather, every step reads and writes only its own thread's words,
so there the warps run at once.)  The word arithmetic is the SIMD
intrinsics' (``__vadd4`` ..., lane by lane for MUL and the shifts) with
the kernel's case split for signed VMIN / VMAX against a scalar.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from repro.nmc import engine as ref_engine
from repro.nmc.program import Program as RefProgram
from repro_torch.core import isa, programs
from repro_torch.core.carus import CarusVPU
from repro_torch.core.isa import VOp
from repro_torch.nmc import conformance, cuda_engine
from repro_torch.nmc.program import (PROG_DTYPE, Program, carus_entry,
                                     instr_bucket)

SEWS = (8, 16, 32)
SRC = (cuda_engine.cuda_build.CSRC / "carus_wave.cu").read_text()
K_THREADS = int(re.search(r"constexpr int kThreads = (\d+);", SRC)[1])
K_CHUNK = int(re.search(r"constexpr int kChunk = (\d+);", SRC)[1])
WARP = 32
REG_WORDS = 256
MASK32 = (1 << 32) - 1
ID = {op: isa.COMPACT_ID[op] for op in isa.VOP_COMPACT}
SLIDES = (ID[VOp.VSLIDEUP], ID[VOp.VSLIDEDOWN])


# ---------------------------------------------------------------------------
# word arithmetic, on words held as int64 in [0, 2^32)
# ---------------------------------------------------------------------------

def _lanes(w, sew, signed=True):
    """Words -> their SEW lanes [..., 32 / sew], little-endian."""
    raw = (np.asarray(w)[..., None] >> (np.arange(32 // sew) * sew)) \
        & ((1 << sew) - 1)
    return np.where(raw >= 1 << (sew - 1), raw - (1 << sew), raw) \
        if signed else raw


def _join(lanes, sew):
    """Lanes truncated to SEW bits, packed into words."""
    shifts = np.arange(lanes.shape[-1]) * sew
    return ((lanes & ((1 << sew) - 1)) << shifts).sum(-1) & MASK32


def _splat(s, sew):
    return _join(np.full(32 // sew, int(s), np.int64), sew)


def _wrap32(x):
    return ((x + (1 << 31)) & MASK32) - (1 << 31)


def _word_op(op, a, b, dst, s, vv, sew):
    """The kernel's word result of an element-local op (before VL)."""
    sa, sb = _lanes(a, sew), _lanes(b, sew)
    ua, ub = _lanes(a, sew, False), _lanes(b, sew, False)
    hi = (1 << (sew - 1)) - 1
    inside = vv or -hi - 1 <= s <= hi
    if op == ID[VOp.VMIN]:      # __vmins4 on the splat, or the case split
        return _join(np.minimum(sa, sb), sew) if inside \
            else (a if s > hi else b)
    if op == ID[VOp.VMAX]:
        return _join(np.maximum(sa, sb), sew) if inside \
            else (b if s > hi else a)
    sh = ub & (sew - 1)
    lanes = {
        ID[VOp.VADD]: lambda: sa + sb, ID[VOp.VSUB]: lambda: sa - sb,
        ID[VOp.VMUL]: lambda: sa * sb,
        ID[VOp.VMACC]: lambda: _lanes(dst, sew) + sa * sb,
        ID[VOp.VMINU]: lambda: np.minimum(ua, ub),
        ID[VOp.VMAXU]: lambda: np.maximum(ua, ub),
        ID[VOp.VSLL]: lambda: ua << sh, ID[VOp.VSRL]: lambda: ua >> sh,
        ID[VOp.VSRA]: lambda: sa >> sh,
    }
    if op in lanes:
        return _join(lanes[op](), sew)
    return {ID[VOp.VAND]: lambda: a & b, ID[VOp.VOR]: lambda: a | b,
            ID[VOp.VXOR]: lambda: a ^ b, ID[VOp.VMV]: lambda: b}[op]()


def _store(words, vd, t, w, vl, sew):
    """Tail-undisturbed write of threads ``t``'s words: lanes below VL."""
    n = 32 // sew
    keep = np.arange(n)[None, :] < (vl - t * n)[:, None]
    words[vd, t] = _join(np.where(keep, _lanes(w, sew, False),
                                  _lanes(words[vd, t], sew, False)), sew)


def _gather(words, r, t, sew):
    """A slide's words for threads ``t`` (before VL), reading vs2 now."""
    n = 32 // sew
    elems = REG_WORDS * n
    src = _lanes(words[r["vs2"]], sew).reshape(-1)
    e = t[:, None] * n + np.arange(n)
    off = 1 if r["slide1"] else int(r["scalar"])
    vl, edge = int(r["vl"]), int(r["aux"])
    if r["op"] == ID[VOp.VSLIDEUP]:
        idx = _wrap32(e - off)
        x = np.where(idx >= 0, src[np.clip(idx, 0, elems - 1)],
                     _lanes(words[r["vd"], t], sew))
        if r["slide1"]:
            x = np.where(e == 0, edge, x)
    else:
        idx = _wrap32(e + off)
        x = np.where(idx < vl, src[np.clip(idx, 0, elems - 1)], 0)
        if r["slide1"]:
            x = np.where(e == vl - 1, edge, x)
    return _join(x, sew)


def _local(words, r, t, sew):
    """An element-local record on threads ``t``."""
    n = 32 // sew
    vd = r["vd"]
    if r["op"] == ID[VOp.EMVV]:                # the owner's lane, no VL
        owner, k = divmod(int(r["aux"]), n)
        if owner in t:
            lanes = _lanes(words[vd, owner], sew, False)
            lanes[k] = int(r["scalar"])
            words[vd, owner] = _join(lanes, sew)
        return
    a = words[r["vs2"], t]
    b = words[r["vs1"], t] if r["vv"] else \
        np.full(len(t), _splat(r["scalar"], sew))
    w = _word_op(int(r["op"]), a, b, words[vd, t], int(r["scalar"]),
                 bool(r["vv"]), sew)
    _store(words, vd, t, w, int(r["vl"]), sew)


def _phases(records):
    """The schedule's steps, split at its barriers."""
    phases, chunk = [[]], None
    for j, r in enumerate(records):
        if r["chunk"] != chunk:
            phases.append([])
            chunk = r["chunk"]
        if r["op"] in SLIDES:
            if r["bar_gather"]:
                phases.append([])
            phases[-1].append(("gather", j))
            if r["bar_write"]:
                phases.append([])
            phases[-1].append(("write", j))
        else:
            phases[-1].append(("local", j))
    return [p for p in phases if p]


def emulate(schedule, image, sew, reverse=False):
    """The kernel on one tile: ``schedule``'s records by 256 threads in
    warps, each warp to the next barrier before the next warp starts."""
    words = np.asarray(image, np.int64).reshape(-1, REG_WORDS) & MASK32
    recs = schedule.records
    warps = [np.arange(w * WARP, (w + 1) * WARP)
             for w in range(K_THREADS // WARP)]
    if reverse:
        warps.reverse()
    held = {}
    for phase in _phases(recs):
        crosses = any(kind == "gather" for kind, _ in phase)
        for t in warps if crosses else [np.arange(K_THREADS)]:
            for kind, j in phase:
                r = recs[j]
                if kind == "gather":      # into the threads' registers
                    held.setdefault(j, np.zeros(K_THREADS, np.int64))[t] = \
                        _gather(words, r, t, sew)
                elif kind == "write":
                    _store(words, r["vd"], t, held[j][t], int(r["vl"]), sew)
                else:
                    _local(words, r, t, sew)
    return words.astype(np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# the references
# ---------------------------------------------------------------------------

def _plain(entries, image, sew):
    trace = Program.from_entries("carus", sew, entries).lower()
    return CarusVPU().run_trace(torch.as_tensor(image), trace, sew)[0] \
        .numpy()


def _scan(entries, image, sew):
    ref = ref_engine.get_engine("carus", "scan")
    return np.asarray(ref.run(ref.init_state(image),
                              RefProgram.from_entries("carus", sew, entries)))


def _agrees(schedule, entries, image, sew) -> bool:
    want = _plain(entries, image, sew)
    return all(np.array_equal(emulate(schedule, image, sew, rev), want)
               for rev in (False, True))


def _check(entries, image, sew):
    """Emulation (both warp orders) == port plain engine == JAX scan
    engine, bit for bit; returns the schedule."""
    entries = np.asarray(entries, dtype=PROG_DTYPE)
    image = np.asarray(image, np.int32)
    sched = cuda_engine.carus_schedule(entries, sew)
    want = _plain(entries, image, sew)
    for rev in (False, True):
        got = emulate(sched, image, sew, rev)
        assert np.array_equal(got, want), (rev, np.argwhere(got != want)[:5])
    assert np.array_equal(want, _scan(entries, image, sew))
    return sched


def _image(seed):
    return np.random.default_rng(seed).integers(
        -2**31, 2**31, (32, REG_WORDS), dtype=np.int64).astype(np.int32)


def _padded(entries):
    entries = np.asarray(entries, dtype=PROG_DTYPE)
    return Program.from_entries("carus", 8, entries) \
        .pad_to(instr_bucket(len(entries))).entries


def _vlmax(sew):
    return REG_WORDS * 32 // sew


def _in_place_slides(sew):
    """Slides with vd == vs2 across warp boundaries, in both directions,
    after ops that write their source, at full and at partial VL."""
    vlmax = _vlmax(sew)
    return _padded([
        carus_entry(VOp.VADD, vd=3, vs1=1, vs2=2),
        carus_entry(VOp.VSLIDEUP, vd=3, vs2=3, sval1=5, mode=isa.MODE_VX),
        carus_entry(VOp.VXOR, vd=4, vs1=3, vs2=1),
        carus_entry(VOp.VSLIDEDOWN, vd=4, vs2=4, sval1=37,
                    mode=isa.MODE_VX),
        carus_entry(VOp.VSETVL, sval1=vlmax - 70),
        carus_entry(VOp.VSLIDEUP, vd=1, vs2=1, sval1=-99,
                    mode=isa.MODE_VX | isa.MODE_SLIDE1),
        carus_entry(VOp.VSLIDEDOWN, vd=2, vs2=2, imm=7, mode=isa.MODE_VI),
        carus_entry(VOp.VSLIDEDOWN, vd=5, vs2=5, sval1=123,
                    mode=isa.MODE_VX | isa.MODE_SLIDE1),
    ])


def _long_trace(sew):
    """Longer than one chunk: a VSETVL in the first chunk, then element-
    local ops and slides in the next two that run at that VL."""
    rng = np.random.default_rng(sew)
    vl = _vlmax(sew) // 2 + 3
    ops = [VOp.VADD, VOp.VMACC, VOp.VMIN, VOp.VSRA, VOp.VMV, VOp.VMAXU]
    entries = [carus_entry(VOp.VSETVL, sval1=vl)]
    for i in range(2 * K_CHUNK + 40):
        vd, vs1, vs2 = (int(x) for x in rng.integers(6, size=3))
        if i % 17 == 16:
            entries.append(carus_entry(
                VOp.VSLIDEUP if i % 2 else VOp.VSLIDEDOWN, vd=vd,
                vs2=vd if i % 3 else vs2, sval1=int(rng.integers(-40, 40)),
                mode=isa.MODE_VX))
        else:
            entries.append(carus_entry(
                ops[i % len(ops)], vd=vd, vs1=vs1, vs2=vs2,
                sval1=int(rng.integers(-2**31, 2**31)),
                imm=int(rng.integers(-16, 16)), mode=int(rng.integers(3))))
    return np.asarray(entries, dtype=PROG_DTYPE)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def test_constants_are_the_kernels():
    assert K_THREADS == cuda_engine.CARUS_THREADS == REG_WORDS
    assert K_CHUNK == cuda_engine.CARUS_CHUNK == 256


@pytest.mark.parametrize("sew", SEWS)
def test_random_waves(sew):
    progs, states = conformance.random_wave("carus", sew, 2, 256, seed=sew)
    for p, s in zip(progs, states):
        assert _check(p.entries, s, sew).slide_barriers > 0


@pytest.mark.parametrize("sew", SEWS)
def test_table_v_programs_padded_to_their_buckets(sew):
    for name in programs.TABLE_V_KERNELS:
        eb = programs.build(name, sew).carus
        prog = eb.program.pad_to(instr_bucket(eb.program.n_instr))
        _check(prog.entries, eb.mem, sew)


@pytest.mark.parametrize("sew", SEWS)
def test_golden_opcode_programs(sew):
    for eng, label, entries in conformance.golden_cases():
        if eng == "carus":
            prog = Program.from_entries("carus", sew, entries) \
                .pad_to(conformance.CONF_BUCKET)
            _check(prog.entries, conformance.golden_state("carus", sew), sew)


@pytest.mark.parametrize("sew", SEWS)
def test_slide_dense_waves(sew):
    progs, states = conformance.slide_wave(sew, 2, 256, seed=sew)
    for p, s in zip(progs, states):
        e = p.entries
        slides = np.isin(e["op"], SLIDES)
        assert slides.sum() == 128
        assert (slides & (e["dest"] == e["src2"])).sum() > 32
        _check(e, s, sew)


@pytest.mark.parametrize("sew", SEWS)
def test_in_place_slides(sew):
    sched = _check(_in_place_slides(sew), _image(sew), sew)
    assert sched.slide_barriers == 2 * 5


@pytest.mark.parametrize("sew", SEWS)
def test_vsetvl_to_negative_and_oversized_lengths_between_slides(sew):
    vlmax = _vlmax(sew)
    body = []
    for k, n in enumerate([-3, vlmax + 9, 0, 17, -2**31, vlmax, 1]):
        body += [carus_entry(VOp.VSETVL, sval1=n),
                 carus_entry(VOp.VSLIDEUP, vd=k % 4, vs2=(k + 1) % 4,
                             sval1=2 * k - 5, mode=isa.MODE_VX),
                 carus_entry(VOp.VADD, vd=4, vs1=k % 4, vs2=4),
                 carus_entry(VOp.VSLIDEDOWN, vd=5, vs2=5, sval1=k + 1,
                             mode=isa.MODE_VX | isa.MODE_SLIDE1)]
    sched = _check(_padded(body), _image(10 + sew), sew)
    # the decode clamps VL at 0: a VL at or below zero writes nothing
    assert sorted(set(sched.records["vl"].tolist())) == \
        sorted({vlmax, 0, 17, 1})


@pytest.mark.parametrize("sew", SEWS)
def test_trace_longer_than_a_chunk(sew):
    entries = _long_trace(sew)
    sched = _check(entries, _image(20 + sew), sew)
    assert sched.chunks == 3
    late = sched.records[sched.records["chunk"] == 2]
    assert len(late) and (late["vl"] == _vlmax(sew) // 2 + 3).all()


def test_no_slide_no_barrier_inside_a_chunk():
    """A trace without slides takes only the chunk barriers, and the
    padding VNOPs, the EMVXs and the VSETVL are compacted out."""
    for name in ("gemm", "matmul", "leaky_relu"):
        prog = programs.build(name, 8).carus.program
        prog = prog.pad_to(instr_bucket(prog.n_instr))
        sched = cuda_engine.carus_schedule(prog.entries, 8)
        assert sched.slide_barriers == 0
        assert sched.barriers == sched.chunk_barriers == sched.chunks + 1
        writes = prog.entries["op"] <= ID[VOp.EMVV]
        assert len(sched.records) == int(writes.sum()) < prog.n_instr


# the design's table at SEW 8 and the paper's shapes: (instructions,
# bucket, records executed, barriers)
TABLE_V_SCHEDULE = {"gemm": (169, 256, 104, 2), "matmul": (129, 256, 64, 2),
                    "conv2d": (125, 128, 70, 34),
                    "leaky_relu": (33, 64, 32, 2)}


@pytest.mark.parametrize("name", sorted(TABLE_V_SCHEDULE))
def test_table_v_schedule(name):
    prog = programs.build(name, 8).carus.program
    bucket = instr_bucket(prog.n_instr)
    sched = cuda_engine.carus_schedule(prog.pad_to(bucket).entries, 8)
    assert (prog.n_instr, bucket, len(sched.records), sched.barriers) == \
        TABLE_V_SCHEDULE[name]


# ---------------------------------------------------------------------------
# the emulation has teeth: mutated schedules fail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sew", SEWS)
def test_without_the_barrier_between_gather_and_write_fails(sew):
    entries, image = _in_place_slides(sew), _image(sew)
    sched = cuda_engine.carus_schedule(entries, sew)
    assert _agrees(sched, entries, image, sew)
    recs = sched.records.copy()
    recs["bar_write"] = False
    assert not _agrees(dataclasses.replace(sched, records=recs), entries,
                       image, sew)


@pytest.mark.parametrize("sew", SEWS)
def test_without_the_barrier_before_the_gather_fails(sew):
    entries, image = _in_place_slides(sew), _image(sew)
    sched = cuda_engine.carus_schedule(entries, sew)
    recs = sched.records.copy()
    recs["bar_gather"] = False
    assert not _agrees(dataclasses.replace(sched, records=recs), entries,
                       image, sew)


@pytest.mark.parametrize("sew", SEWS)
def test_vl_reset_at_a_chunk_boundary_fails(sew):
    """Decoding each chunk as a trace of its own (VL back to VLMAX at every
    chunk) must be caught."""
    entries, image = _long_trace(sew), _image(20 + sew)
    sched = cuda_engine.carus_schedule(entries, sew)
    parts = []
    for c in range(sched.chunks):
        part = cuda_engine.carus_schedule(
            entries[c * K_CHUNK:(c + 1) * K_CHUNK], sew).records
        part["chunk"] = c
        parts.append(part)
    reset = dataclasses.replace(sched, records=np.concatenate(parts))
    assert _agrees(sched, entries, image, sew)
    assert not _agrees(reset, entries, image, sew)
