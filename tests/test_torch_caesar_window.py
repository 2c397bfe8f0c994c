"""The windowed NM-Caesar wave kernel (``csrc/caesar_wave.cu``), emulated
step by step in numpy on the CPU and held bit for bit against the port's
plain engine (``CaesarEngine.run_stream``) and the JAX package's scan
engine.

The emulation follows the kernel's algorithm, not the serial one: windows
of ``kWindow`` instructions (read from the source), one per lane; the
value-free analysis (a shared table of each word's writers in the window,
as a lane mask under the window's tag: producers and last writers); round
1 by selects over the window's ops for the lanes without producers, then
rounds in which a lane computes once its producers are done, with operands
forwarded from the producer lanes; MAC and DOT accumulators as
Hillis-Steele segmented scans with a carry across windows, run again in
each round in which an accumulator lane computed; write-back by each
word's last writer; and the SIMD intrinsics' lane semantics (``__vadd4``
... ``__dp4a``).  It
also counts the rounds of every window, which must equal the port's own
cost model (``cuda_engine.caesar_window_rounds``).
"""

import re

import numpy as np
import pytest
import torch

from repro.core.caesar import CaesarEngine as RefCaesar
from repro.nmc import engine as ref_engine
from repro.nmc.program import Program as RefProgram
from repro_torch.core import programs
from repro_torch.core.caesar import CaesarEngine
from repro_torch.core.isa import CaesarOp as Op
from repro_torch.nmc import conformance, cuda_engine, engine
from repro_torch.nmc.program import PROG_DTYPE, Program, caesar_entry

SEWS = (8, 16, 32)
SRC = (cuda_engine.cuda_build.CSRC / "caesar_wave.cu").read_text()
K_WINDOW = int(re.search(r"constexpr int kWindow = (\d+);", SRC)[1])
LANES = np.arange(K_WINDOW)
MASK32 = (1 << 32) - 1
MEM_WORDS = 8192

WRITERS = {Op.AND, Op.OR, Op.XOR, Op.ADD, Op.SUB, Op.MUL, Op.MAC_STORE,
           Op.DOT_STORE, Op.SLL, Op.SLR, Op.SRA, Op.MIN, Op.MAX}
MAC_OPS = {Op.MAC_INIT, Op.MAC, Op.MAC_STORE}
DOT_OPS = {Op.DOT_INIT, Op.DOT, Op.DOT_STORE}


def _bits(ops) -> int:
    return sum(1 << int(o) for o in ops)


# ---------------------------------------------------------------------------
# lane semantics of the kernel's intrinsics, on words held as int64 in
# [0, 2^32)
# ---------------------------------------------------------------------------

def _split(w, sew):
    """Words -> sign-extended SEW lanes [..., 32 / sew] (little-endian)."""
    shifts = np.arange(32 // sew) * sew
    raw = (w[..., None] >> shifts) & ((1 << sew) - 1)
    return np.where(raw >= 1 << (sew - 1), raw - (1 << sew), raw)


def _join(lanes, sew):
    """Lanes truncated to SEW bits, packed into words."""
    shifts = np.arange(lanes.shape[-1]) * sew
    return ((lanes & ((1 << sew) - 1)) << shifts).sum(-1) & MASK32


def vadd(a, b, sew):            # __vadd4 / __vadd2 / add: wraps per lane
    return _join(_split(a, sew) + _split(b, sew), sew)


def vsub(a, b, sew):            # __vsub4 / __vsub2 / sub
    return _join(_split(a, sew) - _split(b, sew), sew)


def vmin(a, b, sew):            # __vmins4 / __vmins2 / signed min
    return _join(np.minimum(_split(a, sew), _split(b, sew)), sew)


def vmax(a, b, sew):            # __vmaxs4 / __vmaxs2 / signed max
    return _join(np.maximum(_split(a, sew), _split(b, sew)), sew)


def vmul(a, b, sew):            # lane products truncated to SEW
    return _join(_split(a, sew) * _split(b, sew), sew)


def vshift(kind, a, b, sew):    # amounts mod SEW, per lane
    x, sh = _split(a, sew), _split(b, sew) & (sew - 1)
    low = x & ((1 << sew) - 1)
    r = {Op.SLL: low << sh, Op.SLR: low >> sh, Op.SRA: x >> sh}[kind]
    return _join(r, sew)


def dot_word(a, b, sew):        # __dp4a at SEW 8: signed lane dot, mod 2^32
    return (_split(a, sew) * _split(b, sew)).sum(-1) & MASK32


ALU = {
    Op.AND: lambda a, b, s: a & b, Op.OR: lambda a, b, s: a | b,
    Op.XOR: lambda a, b, s: a ^ b, Op.ADD: vadd, Op.SUB: vsub,
    Op.MIN: vmin, Op.MAX: vmax, Op.MUL: vmul,
    Op.SLL: lambda a, b, s: vshift(Op.SLL, a, b, s),
    Op.SLR: lambda a, b, s: vshift(Op.SLR, a, b, s),
    Op.SRA: lambda a, b, s: vshift(Op.SRA, a, b, s),
}


def _ballot(pred) -> int:
    return int(sum(1 << int(j) for j in np.flatnonzero(pred)))


def _top(masks):
    """Highest set lane of each mask (-1 for none)."""
    return np.array([int(m).bit_length() - 1 for m in masks])


def _segmented_scan(x, start, add):
    """Inclusive Hillis-Steele scan over lanes [start[j], j], by shifted
    copies as ``__shfl_up_sync`` gives them."""
    for d in (1 << k for k in range(K_WINDOW.bit_length() - 1)):
        up = np.concatenate([x[:d], x[:-d]])
        x = np.where(LANES - d >= start, add(x, up), x)
    return x


def _alu(present, op, a, b, sew):
    """Every lane's result (the MAC ops' lane products, the DOT ops' term)
    by selects over the ops in ``present``, as the kernel's round 1 does;
    a later round's one-lane switch is the same with one op present."""
    r = vmul(a, b, sew) if present & _bits({Op.MUL} | MAC_OPS) \
        else np.zeros_like(a)
    for alu_op, fn in ALU.items():
        if alu_op != Op.MUL and present & (1 << int(alu_op)):
            r = np.where(op == alu_op, fn(a, b, sew), r)
    if present & _bits(DOT_OPS):
        r = np.where(np.isin(op, list(DOT_OPS)), dot_word(a, b, sew), r)
    return r


def _scans(term, is_mac, is_dot, seg, waiting, mac, dot, sew):
    """The MAC and DOT segmented scans with their carries; an accumulator
    lane is final once no lane of its segment up to it is waiting."""
    waiting = _ballot(waiting)
    out, fin = [], np.zeros(K_WINDOW, bool)
    for chain, lanes_of, add, carry in (
            ("mac", is_mac, lambda x, y: vadd(x, y, sew),
             lambda x: vadd(x, np.int64(mac), sew)),
            ("dot", is_dot, lambda x, y: (x + y) & MASK32,
             lambda x: (x + dot) & MASK32)):
        inits, start, lanes = seg[chain]
        acc = _segmented_scan(np.where(lanes_of, term, 0), start, add)
        out.append(np.where(inits == 0, carry(acc), acc))
        fin |= lanes_of & ((waiting & lanes) == 0)
    return out, fin


def emulate(entries, image, sew):
    """The kernel's algorithm on one tile: ``(image, mac, dot, rounds per
    window)``, the image as int32 and the accumulators as int."""
    f = {k: np.asarray(entries[k], np.int64)
         for k in ("op", "dest", "src1", "src2")}
    n = len(f["op"])
    img = np.asarray(image, np.int64) & MASK32
    tags = np.full(MEM_WORDS, -1, np.int64)       # the writer table
    masks = np.zeros(MEM_WORDS, np.int64)
    below = (1 << LANES) - 1
    upto = below | (1 << LANES)
    mac = dot = 0
    rounds = []
    for w in range(-(-n // K_WINDOW)):
        idx = w * K_WINDOW + LANES
        inside = idx < n
        op, d, s1, s2 = (np.where(inside, f[k][np.minimum(idx, n - 1)], 0)
                         for k in ("op", "dest", "src1", "src2"))
        op = np.where(inside, op, int(Op.NOP))
        ob = np.left_shift(1, op)
        writes = (ob & _bits(WRITERS)) != 0
        is_mac = (ob & _bits(MAC_OPS)) != 0
        is_dot = (ob & _bits(DOT_OPS)) != 0
        active = writes | is_mac | is_dot
        d, s1, s2 = (np.where(active, v, 0) for v in (d, s1, s2))

        # analysis: each word's writers in the window, as a lane mask under
        # the window's tag (a tag store, then an atomic OR per writer)
        tags[d[writes]] = w
        masks[d[writes]] = 0
        for j in np.flatnonzero(writes):
            masks[d[j]] |= 1 << int(j)
        last = writes & (_top(masks[d]) == LANES)
        x1, x2 = img[s1], img[s2]
        p1, p2 = (np.where(tags[s] == w, _top(masks[s] & below), -1)
                  for s in (s1, s2))
        seg = {}
        for chain, init, ops in (("mac", Op.MAC_INIT, is_mac),
                                 ("dot", Op.DOT_INIT, is_dot)):
            inits = _ballot(op == init) & upto
            start = np.where(inits != 0, _top(inits), 0)
            seg[chain] = (inits, start,
                          _ballot(ops) & upto & ~((1 << start) - 1))

        # round 1: the lanes without producers, by selects over the ops
        # present; then rounds of the lanes whose producers are done.  The
        # scans run in every round in which an accumulator lane computed.
        present = int(np.bitwise_or.reduce(ob))
        acc = is_mac | is_dot
        taken = ~active | ((p1 < 0) & (p2 < 0))
        term = _alu(present, op, x1, x2, sew)
        res = term.copy()
        got, done = taken.copy(), taken & ~acc
        took = taken & active
        mac_next, dot_next = mac, dot
        r = int(active.any())
        while True:
            if (took & acc).any():
                (ms, ds), fin = _scans(term, is_mac, is_dot, seg, ~got,
                                       mac, dot, sew)
                mac_next, dot_next = int(ms[-1]), int(ds[-1])
                res = np.where(fin & (op == Op.MAC_STORE), ms,
                               np.where(fin & (op == Op.DOT_STORE), ds, res))
                done = done | fin
            if done.all():
                break
            r += 1
            took = (~taken & ((p1 < 0) | done[p1 & 31])
                    & ((p2 < 0) | done[p2 & 31]))
            a = np.where(p1 < 0, x1, res[p1 & 31])
            b = np.where(p2 < 0, x2, res[p2 & 31])
            one = np.array([_alu(1 << int(o), o, x, y, sew) for o, x, y in
                            zip(op, a[:, None], b[:, None])]).reshape(-1)
            term = np.where(took, one, term)
            res = np.where(took & ~acc, one, res)
            taken = taken | took
            got = got | took
            done = done | (took & ~acc)
        mac, dot = mac_next, dot_next
        img[d[last]] = res[last]                 # last writers only
        rounds.append(r)
    return (img.astype(np.uint32).view(np.int32), mac, dot,
            np.array(rounds, np.int64))


# ---------------------------------------------------------------------------
# the references
# ---------------------------------------------------------------------------

def _signed(x: int) -> int:
    return x - (1 << 32) if x >= 1 << 31 else x


def _check(entries, image, sew):
    """Emulation == port plain engine == JAX scan engine, bit for bit (the
    final image, and both accumulators against the port); returns the
    emulation's rounds per window."""
    entries = np.asarray(entries, dtype=PROG_DTYPE)
    got, mac, dot, rounds = emulate(entries, image, sew)
    stream = {k: torch.as_tensor(np.ascontiguousarray(entries[k]))
              for k in ("op", "dest", "src1", "src2")}
    pm, pmac, pdot = CaesarEngine().run_stream(torch.as_tensor(image),
                                               stream, sew)
    assert np.array_equal(got, pm.numpy()), np.flatnonzero(got != pm.numpy())
    assert _signed(mac) == int(pmac) and _signed(dot) == int(pdot)
    ref = ref_engine.get_engine("caesar", "scan")
    want = np.asarray(ref.run(ref.init_state(image),
                              RefProgram.from_entries("caesar", sew,
                                                      entries)))
    assert np.array_equal(got, want)
    assert np.array_equal(rounds, cuda_engine.caesar_window_rounds(entries))
    return rounds


def _image(seed):
    return np.random.default_rng(seed).integers(
        -2**31, 2**31, MEM_WORDS, dtype=np.int64).astype(np.int32)


def _placed(n, placed):
    """``n`` NOPs with ``{position: entry}`` put in place."""
    entries = np.zeros(n, dtype=PROG_DTYPE)
    entries["op"] = int(Op.NOP)
    for i, e in placed.items():
        entries[i] = e
    return entries


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def test_window_constant_is_the_kernels():
    assert K_WINDOW == cuda_engine.CAESAR_WINDOW == 32


@pytest.mark.parametrize("sew", SEWS)
def test_random_waves(sew):
    progs, states = conformance.random_wave("caesar", sew, 2, 200, seed=sew)
    for p, s in zip(progs, states):
        _check(p.entries, s, sew)


@pytest.mark.parametrize("n_words", [8, 32])
@pytest.mark.parametrize("sew", SEWS)
def test_conflict_dense_waves(sew, n_words):
    progs, states = conformance.random_wave("caesar", sew, 2, 256,
                                            seed=n_words + sew,
                                            n_words=n_words)
    assert len(np.unique(progs[0].entries["dest"])) <= n_words + 1
    rounds = [_check(p.entries, s, sew) for p, s in zip(progs, states)]
    assert max(r.max() for r in rounds) > 2       # deep chains in a window


@pytest.mark.parametrize("sew", SEWS)
def test_table_v_programs(sew):
    small = {"xor": dict(caesar_bytes=256), "add": dict(caesar_bytes=256),
             "mul": dict(caesar_bytes=256), "relu": dict(caesar_bytes=256),
             "leaky_relu": dict(caesar_bytes=256),
             "maxpool": dict(caesar_bytes=1024), "matmul": dict(p=4),
             "gemm": dict(p=4), "conv2d": dict(n=10, f=3)}
    assert set(small) == set(programs.TABLE_V_KERNELS)
    for name, kw in small.items():
        eb = programs.build(name, sew, **kw).caesar
        assert eb.program.n_instr <= 512, name
        _check(eb.program.entries, np.asarray(eb.mem, np.int32), sew)


@pytest.mark.parametrize("sew", SEWS)
def test_golden_opcode_programs(sew):
    for eng, label, entries in conformance.golden_cases():
        if eng == "caesar":
            prog = Program.from_entries("caesar", sew, entries) \
                .pad_to(conformance.CONF_BUCKET)
            _check(prog.entries, conformance.golden_state("caesar", sew), sew)


@pytest.mark.parametrize("sew", SEWS)
def test_all_lanes_write_one_word(sew):
    """A window whose 32 lanes all write word 5, reading it and its
    neighbours; the next window reads the survivor."""
    rng = np.random.default_rng(sew)
    alu = sorted(int(o) for o in ALU)
    placed = {j: caesar_entry(Op(int(rng.choice(alu))), 5,
                              int(rng.integers(4, 7)), int(rng.integers(4, 7)))
              for j in range(K_WINDOW)}
    placed[K_WINDOW] = caesar_entry(Op.ADD, 9, 5, 5)
    rounds = _check(_placed(2 * K_WINDOW, placed), _image(sew), sew)
    assert rounds[0] > 1


@pytest.mark.parametrize("sew", SEWS)
def test_serial_chain_takes_a_round_per_lane(sew):
    progs, states = conformance.chain_wave(sew, 2, 3 * K_WINDOW + 5, seed=sew)
    for p, s in zip(progs, states):
        rounds = _check(p.entries, s, sew)
        assert list(rounds) == [K_WINDOW] * 3 + [5]


@pytest.mark.parametrize("sew", SEWS)
def test_accumulators_with_forwarding_in_the_window(sew):
    """A MAC whose operand an earlier lane wrote; a MAC_STORE and a
    DOT_STORE that later lanes read; a DOT fed from the MAC's stored sum."""
    placed = {
        0: caesar_entry(Op.ADD, 10, 1, 2),
        1: caesar_entry(Op.MAC_INIT, 0, 10, 3),
        2: caesar_entry(Op.XOR, 11, 10, 4),
        3: caesar_entry(Op.MAC, 0, 11, 10),
        4: caesar_entry(Op.MAC_STORE, 20, 5, 11),
        5: caesar_entry(Op.SUB, 21, 20, 6),
        6: caesar_entry(Op.DOT_INIT, 0, 21, 20),
        7: caesar_entry(Op.DOT, 0, 7, 8),
        8: caesar_entry(Op.DOT_STORE, 22, 20, 21),
        9: caesar_entry(Op.MAX, 23, 22, 20),
        10: caesar_entry(Op.MAC_INIT, 0, 22, 23),
        11: caesar_entry(Op.MAC_STORE, 24, 23, 21),
        12: caesar_entry(Op.MUL, 20, 24, 22),       # overwrites a stored sum
        13: caesar_entry(Op.AND, 25, 20, 24),
    }
    rounds = _check(_placed(40, placed), _image(10 + sew), sew)
    assert rounds[0] >= 6


@pytest.mark.parametrize("sew", SEWS)
def test_chains_and_write_after_read_across_windows(sew):
    """MAC and DOT chains opened in one window and closed in the next (the
    carry), a chain re-opened after its store in the same window, and
    write-after-read pairs inside a window and across its boundary."""
    w = K_WINDOW
    placed = {
        w - 3: caesar_entry(Op.MAC_INIT, 0, 1, 2),
        w - 2: caesar_entry(Op.DOT_INIT, 0, 3, 4),
        w - 1: caesar_entry(Op.ADD, 30, 7, 31),      # reads 31 ...
        w: caesar_entry(Op.SUB, 31, 5, 6),           # ... the next window writes it
        w + 1: caesar_entry(Op.MAC, 0, 30, 31),
        w + 2: caesar_entry(Op.DOT, 0, 31, 30),
        w + 3: caesar_entry(Op.MAC_STORE, 40, 8, 9),
        w + 4: caesar_entry(Op.DOT_STORE, 41, 40, 30),
        w + 5: caesar_entry(Op.MAC_INIT, 0, 41, 40),
        w + 6: caesar_entry(Op.OR, 30, 40, 41),      # write after the reads above
        2 * w - 1: caesar_entry(Op.MAC, 0, 30, 1),
        2 * w: caesar_entry(Op.MAC, 0, 2, 3),
        2 * w + 1: caesar_entry(Op.MAC_STORE, 42, 4, 5),
        2 * w + 2: caesar_entry(Op.SLL, 43, 42, 41),
    }
    _check(_placed(3 * w, placed), _image(20 + sew), sew)


@pytest.mark.parametrize("n", [1, 31, 33, 95])
def test_stream_lengths_off_the_window(n):
    progs, states = conformance.random_wave("caesar", 8, 1, n, seed=n,
                                            n_words=16)
    _check(progs[0].entries, states[0], 8)


def test_accumulators_match_the_jax_stream_engine():
    """The emulation's MAC and DOT accumulators against the JAX package's
    stream executor as well (the scan engine returns images only)."""
    import jax.numpy as jnp
    progs, states = conformance.random_wave("caesar", 16, 1, 160, seed=4,
                                            n_words=12)
    entries = progs[0].entries
    _, mac, dot, _ = emulate(entries, states[0], 16)
    stream = {k: jnp.asarray(v) for k, v in progs[0].lower_np().items()}
    _, rmac, rdot = RefCaesar().run_stream(jnp.asarray(states[0]), stream, 16)
    assert _signed(mac) == int(rmac) and _signed(dot) == int(rdot)


# the Motivation table of the windowed design: (windows, rounds) at SEW 8
# and the paper's shapes
TABLE_V_ROUNDS = {"xor": (64, 64), "add": (64, 64), "mul": (64, 64),
                  "matmul": (256, 256), "gemm": (416, 1664),
                  "conv2d": (80, 80), "relu": (64, 64),
                  "leaky_relu": (128, 256), "maxpool": (32, 32)}


@pytest.mark.parametrize("name", sorted(TABLE_V_ROUNDS))
def test_table_v_rounds_per_window(name):
    """Rounds of the full-size Table V Caesar programs: the emulation and
    the port's cost model agree, and give the design's table; the
    emulated image equals the oracle of ``programs.build``."""
    eb = programs.build(name, 8).caesar
    entries = eb.program.entries
    img, _, _, rounds = emulate(entries, np.asarray(eb.mem, np.int32), 8)
    assert (len(rounds), int(rounds.sum())) == TABLE_V_ROUNDS[name]
    assert np.array_equal(rounds, cuda_engine.caesar_window_rounds(entries))
    eng = engine.get_engine("caesar", "torch")
    out = eng.extract(torch.as_tensor(img), eb.out_slice, 8)
    out = eb.post(out) if eb.post else out
    exp = np.asarray(eb.oracle).reshape(-1)
    assert np.array_equal(np.asarray(out).reshape(-1)[:exp.size], exp)


def test_random_wave_rounds_of_the_design_table():
    """The random wave of the design's table (seed 8, 2 tiles, 16384
    instructions): 535 and 549 rounds over 512 windows each."""
    progs, _ = conformance.random_wave("caesar", 8, 2, 16384, seed=8)
    rounds = [cuda_engine.caesar_window_rounds(p.entries) for p in progs]
    assert [(len(r), int(r.sum())) for r in rounds] == [(512, 535),
                                                        (512, 549)]
