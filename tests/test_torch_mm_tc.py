"""The int8 tensor-core route of ``nmc_matmul``, on the CPU.

The CUDA kernel runs only on the card (``tests/test_torch_cuda_kernels.py``).
Here: its plan (``nmc_matmul.plan``: every K index in exactly one split,
every output column in one tile, the grid filled), its routing rule, and a
test-local numpy emulation of its arithmetic, block by block: x slabs as
the ``cp.async`` ring holds them, w slabs as the ring holds them
(swizzled 16-byte chunks), read 16 k x 4 n per thread and transposed by
the ``__byte_perm`` selectors read from the CUDA source,
fragments gathered by the kernel's ``ldmatrix`` addresses, the
``mma.m16n8k32`` product taken on the PTX fragment maps, the accumulators
placed by the kernel's store map, and the per-split int32 partial sums
added.  It must equal ``ref.nmc_matmul(..., out_dtype=torch.int32)`` bit
for bit, and the JAX package's ``ref.nmc_matmul`` and interpret-mode
Pallas ``nmc_matmul`` (unit scale: the accumulator itself, exact in
float32 at these sizes).  Inputs are made with numpy from a seed."""

import itertools
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.nmc_matmul import nmc_matmul as jmatmul
from repro_torch.kernels import checks
from repro_torch.kernels import nmc_matmul as mm
from repro_torch.kernels import ref

SRC = (pathlib.Path(mm.__file__).resolve().parents[1] / "csrc"
       / "nmc_matmul.cu").read_text()
LANE = np.arange(32)
G, T4 = LANE // 4, LANE % 4
PAD = 16                       # bytes of padding per shared-memory row


def _tile(name: str) -> tuple:
    """(BM, BN, BK, WM, WN) of ``using <name> = Tile<...>`` in the
    source."""
    args = re.search(rf"using {name} = Tile<([^>]*)>;", SRC).group(1)
    return tuple(int(a) for a in args.split(","))


TILES = {16: _tile("TileThin"), 128: _tile("TileWide")}

# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated
# ---------------------------------------------------------------------------


def byte_perm(x, y, s: int):
    """CUDA's ``__byte_perm(x, y, s)`` on uint32 arrays: byte i of the
    result is byte ``(s >> 4 i) & 7`` of the 8 bytes ``y:x``."""
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
        [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= pool[(s >> (4 * i)) & 7] << (8 * i)
    return out


def _transpose4_source() -> str:
    """The body of ``transpose4`` in the CUDA source, as Python."""
    body = re.search(r"void transpose4\(.*?\{(.*?)\n\}", SRC, re.S).group(1)
    lines = []
    for stmt in body.split(";"):
        stmt = stmt.strip()
        if stmt:
            stmt = stmt.replace("const uint32_t ", "").replace(
                "__byte_perm", "byte_perm")
            lines.append(stmt)
    return "\n".join(lines)


TRANSPOSE4 = _transpose4_source()


def transpose4(r0, r1, r2, r3):
    env = {"byte_perm": byte_perm, "r0": r0, "r1": r1, "r2": r2, "r3": r3,
           "c": [None] * 4}
    exec(TRANSPOSE4, env)
    return env["c"]


def _words(b: np.ndarray):
    """int8 [..., 4] -> uint32 (the lowest index in the lowest byte)."""
    return np.ascontiguousarray(b).view(np.uint8).astype(np.uint64) \
        .dot(1 << (8 * np.arange(4, dtype=np.uint64))).astype(np.int64)


def _bytes(wd):
    """uint32 -> int8 [..., 4]."""
    wd = np.asarray(wd, np.int64)
    return np.stack([(wd >> (8 * i)) & 0xFF for i in range(4)], -1) \
        .astype(np.uint8).view(np.int8)


def smem_x(x, m0, kb, k_end, bm, bk):
    """The x slab as the cp.async ring holds it: [bm][bk + 16] bytes,
    rows past M and 16-byte chunks at or past ``k_end`` zero."""
    t = np.zeros((bm, bk + PAD), np.int8)
    rows = x[m0:m0 + bm, kb:min(kb + bk, k_end)]
    t[:rows.shape[0], :rows.shape[1]] = rows
    return t


def w_swizzle(r, kw_count):
    """The 16-byte chunk swizzle of the w ring's rows (``w_swizzle<KW>``)."""
    return ((r >> 4) * (8 // kw_count)) & 7


def smem_w(w, n0, kb, k_end, bn, bk, threads):
    """The w slab as the kernel stores it, [n][k].  First the ring stage:
    row r (k) as it lies in w, 16-byte chunk c at chunk ``c ^
    w_swizzle(r)``, zero at or past ``k_end`` and past N.  Then piece
    (kw, nq) of thread ``tid`` < (bk / 16) (bn / 4) (kw = tid % (bk / 16),
    nq = tid / (bk / 16)): the four-byte words of rows 16 kw + i (i < 16),
    columns 4 nq .. 4 nq + 3, each 4 x 4 block transposed."""
    k_total, n_total = w.shape
    kwn = bk // 16
    raw = np.zeros((bk, bn), np.int8)
    for r, c in itertools.product(range(bk), range(bn // 16)):
        gk, gn = kb + r, n0 + 16 * c
        if gk < k_end and gn < n_total:
            p = 16 * (c ^ w_swizzle(r, kwn))
            raw[r, p:p + 16] = w[gk, gn:gn + 16]
    tid = np.arange(min(threads, kwn * bn // 4))
    kw, nq = tid % kwn, tid // kwn
    col0 = 16 * ((nq >> 2) ^ w_swizzle(16 * kw, kwn)) + 4 * (nq & 3)
    breg = np.stack([_words(raw[(16 * kw + i)[:, None],
                                col0[:, None] + np.arange(4)])
                     for i in range(16)])
    t = np.zeros((bn, bk + PAD), np.int8)
    for q in range(4):
        col = transpose4(*breg[4 * q:4 * q + 4])
        for j in range(4):
            t[(4 * nq + j)[:, None],
              (16 * kw + 4 * q)[:, None] + np.arange(4)] = _bytes(col[j])
    return t


def ldmatrix_x4(tile, rows, cols):
    """``ldmatrix.x4`` of 8 x 8 b16 matrices (8 rows x 16 int8): lanes
    8 i .. 8 i + 7 address the rows of matrix i, and lane l receives row
    l / 4, bytes 4 (l % 4) .. + 3 of each.  Returns int8 [32 lanes][4
    registers][4 bytes]."""
    regs = np.zeros((32, 4, 4), np.int8)
    for i in range(4):
        src = 8 * i + G
        regs[:, i] = tile[rows[src][:, None],
                          (cols[src] + 4 * T4)[:, None] + np.arange(4)]
    return regs


def mma_m16n8k32(c, a, b):
    """``mma.sync.m16n8k32.row.col.s32.s8.s8.s32`` on lane fragments by the
    PTX ISA maps: a [32][4][4], b [32][2][4] int8, c [32][4] int32."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    k4 = (4 * T4)[:, None] + np.arange(4)
    for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
        A[(G + dr)[:, None], dk + k4] = a[:, reg]
    for reg, dk in enumerate((0, 16)):
        B[dk + k4, G[:, None]] = b[:, reg]
    C = A @ B
    add = np.stack([C[G, 2 * T4], C[G, 2 * T4 + 1], C[G + 8, 2 * T4],
                    C[G + 8, 2 * T4 + 1]], -1)
    return (c.astype(np.int64) + add).astype(np.int32)


def emulate(x, w, plan) -> np.ndarray:
    """The kernel's int32 result for ``plan`` = (bm, bn, splits,
    k_per_split): every block's accumulators by the kernel's fragment and
    store maps, the splits' partial sums added in int32."""
    m, k = x.shape
    n = w.shape[1]
    bm, bn, splits, kps = plan
    _, _, bk, wmn, wnn = TILES[bm]
    threads = 32 * wmn * wnn
    warp_m, warp_n = bm // wmn, bn // wnn
    n_mt, n_nt = warp_m // 16, warp_n // 8
    total = np.zeros((m, n), np.int32)
    for bx, by, z in itertools.product(range(math.ceil(m / bm)),
                                       range(math.ceil(n / bn)),
                                       range(splits)):
        m0, n0, k_begin = bx * bm, by * bn, z * kps
        k_end = min(k, k_begin + kps)
        acc = np.zeros((wmn, wnn, n_mt, n_nt, 32, 4), np.int32)
        for kb in range(k_begin, k_end, bk):
            xs = smem_x(x, m0, kb, k_end, bm, bk)
            ws = smem_w(w, n0, kb, k_end, bn, bk, threads)
            for wm, wn, kk in itertools.product(range(wmn), range(wnn),
                                                range(bk // 32)):
                af = [ldmatrix_x4(xs, wm * warp_m + mt * 16 + (LANE & 7)
                                  + ((LANE >> 3) & 1) * 8,
                                  kk * 32 + (LANE >> 4) * 16)
                      for mt in range(n_mt)]
                bf = []
                for np_ in range(n_nt // 2):
                    f = ldmatrix_x4(ws, wn * warp_n + np_ * 16
                                    + (LANE >> 4) * 8 + (LANE & 7),
                                    kk * 32 + ((LANE >> 3) & 1) * 16)
                    bf += [f[:, 0:2], f[:, 2:4]]
                for mt, nt in itertools.product(range(n_mt), range(n_nt)):
                    acc[wm, wn, mt, nt] = mma_m16n8k32(
                        acc[wm, wn, mt, nt], af[mt], bf[nt])
        part = np.zeros((m, n), np.int32)
        for wm, wn, mt, nt in itertools.product(range(wmn), range(wnn),
                                                range(n_mt), range(n_nt)):
            for h in range(2):
                row = m0 + wm * warp_m + G + mt * 16 + 8 * h
                col = n0 + wn * warp_n + 2 * T4 + nt * 8
                for e in range(2):
                    ok = (row < m) & (col + e < n)
                    part[row[ok], col[ok] + e] = \
                        acc[wm, wn, mt, nt][ok, 2 * h + e]
        total = (total.astype(np.int64) + part).astype(np.int32)
    return total


def _inputs(m, k, n, seed=0, lo=-128):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, 128, (m, k), dtype=np.int8),
            rng.integers(lo, 128, (k, n), dtype=np.int8))


# (m, k, n, sm_count): the 16-row tile with 2 splits and a partial second
# n-tile; a partial last slab; the 128-row tile with 2 splits (a 16-k last
# slab) and a partial second n-tile; a second, 2-row m-tile, one split
EMULATED = [(5, 320, 144, 4), (16, 96, 128, 132), (20, 272, 144, 4),
            (130, 256, 128, 1)]


@pytest.mark.parametrize("m,k,n,sms", EMULATED)
def test_emulated_kernel_equals_the_plain_accumulator(m, k, n, sms):
    x, w = _inputs(m, k, n, seed=m + k + n)
    plan = mm.plan(m, n, k, sms)
    assert mm.route(k, n) == "tensor_core"
    got = emulate(x, w, plan)
    want = ref.nmc_matmul(torch.from_numpy(x), torch.from_numpy(w), None,
                          out_dtype=torch.int32).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, x.astype(np.int64) @ w.astype(np.int64))


@pytest.mark.parametrize("m,k,n,sms", EMULATED)
def test_emulated_kernel_equals_the_jax_package(m, k, n, sms):
    """Unit scale, zero bias: the float32 output is the accumulator itself
    (|acc| < 2^24 here), in the reference's plain version and in its
    Pallas kernel run in interpret mode."""
    x, w = _inputs(m, k, n, seed=m * k + n)
    got = emulate(x, w, mm.plan(m, n, k, sms)).astype(np.float32)
    ones, zeros = jnp.ones((n,), jnp.float32), jnp.zeros((n,), jnp.float32)
    want_ref = np.asarray(jref.nmc_matmul(jnp.asarray(x), jnp.asarray(w),
                                          ones))
    want_pallas = np.asarray(jmatmul(jnp.asarray(x), jnp.asarray(w), ones,
                                     zeros, bm=m, bn=n, bk=k,
                                     interpret=True))
    assert np.array_equal(got, want_ref)
    assert np.array_equal(got, want_pallas)


def test_emulated_split_k_is_exact_at_the_worst_case_accumulator():
    """All -128: every partial sum and the total at their extremes, the
    total the same whatever order the splits are added in."""
    m, k, n = 3, 320, 16
    x = np.full((m, k), -128, np.int8)
    w = np.full((k, n), -128, np.int8)
    plan = mm.plan(m, n, k, 8)
    assert plan[2] > 1
    assert bool((emulate(x, w, plan) == 128 * 128 * k).all())


def test_transpose4_of_the_source_transposes():
    rng = np.random.default_rng(0)
    rows = rng.integers(-128, 128, (4, 4), dtype=np.int8)     # [k][n]
    cols = transpose4(*(np.array([_words(r)]) for r in rows))
    for j in range(4):
        assert np.array_equal(_bytes(cols[j])[0], rows[:, j])


# ---------------------------------------------------------------------------
# plan and route
# ---------------------------------------------------------------------------

SERVING = checks.serving_matmul_shapes()
EDGES = sorted(set(itertools.product((1, 16, 17), (32, 2816, 2817),
                                     (8, 151936))))
PLANNED = SERVING + list(checks.MATMUL_RAGGED) + list(checks.MATMUL_EDGES) \
    + EDGES


@pytest.mark.parametrize("m,k,n", PLANNED)
def test_plan_covers_k_and_n_once_and_fills_the_card(m, k, n):
    bm, bn, splits, kps = mm.plan(m, n, k)
    tile = mm.TILE_THIN if m <= 16 else mm.TILE_WIDE
    assert (bm, bn) == tile[:2]
    bk = tile[2]
    assert kps > 0 and kps % bk == 0
    seen = np.zeros(k, np.int64)
    for z in range(splits):
        lo, hi = z * kps, min(k, (z + 1) * kps)
        assert hi > lo, "an empty split"
        seen[lo:hi] += 1
    assert bool((seen == 1).all())
    cols = np.zeros(n, np.int64)
    for j in range(math.ceil(n / bn)):
        cols[j * bn:(j + 1) * bn] += 1
    assert bool((cols == 1).all())
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    slabs, per = math.ceil(k / bk), kps // bk
    assert per >= min(mm.MIN_SPLIT_SLABS, slabs)
    assert tiles * splits >= mm.SM_COUNT or per == min(mm.MIN_SPLIT_SLABS,
                                                       slabs)
    assert splits == 1 or tiles < mm.SM_COUNT


@pytest.mark.parametrize("m,k,n", SERVING)
def test_serving_shapes_take_the_tensor_core_route(m, k, n):
    """Every served shape but whisper-tiny's LM head (N = 51865, not a
    multiple of 16), which takes dp4a."""
    assert mm.route(k, n) == checks.serving_route(k, n)
    assert (mm.route(k, n) == "tensor_core") == \
        ((k, n) not in checks.DP4A_SERVING_KN)


def test_only_the_whisper_head_is_served_on_dp4a():
    assert checks.DP4A_SERVING_KN == ((384, 51865),)
    off = {(k, n) for k, n in checks.SERVING_MATMUL_KN
           if mm.route(k, n) != "tensor_core"}
    assert off == set(checks.DP4A_SERVING_KN)


@pytest.mark.parametrize("m,k,n", checks.MATMUL_RAGGED)
def test_ragged_shapes_take_the_dp4a_route(m, k, n):
    assert mm.route(k, n) == "dp4a"


@pytest.mark.parametrize("k,n,aligned,want", [
    (1024, 151936, True, "tensor_core"), (32, 16, True, "tensor_core"),
    (16, 16, True, "tensor_core"), (2816, 1024, False, "dp4a"),
    (2817, 1024, True, "dp4a"), (1024, 136, True, "dp4a"),
    (1024, 8, True, "dp4a"), (0, 16, True, "dp4a"), (8, 16, True, "dp4a"),
])
def test_route_rule(k, n, aligned, want):
    assert mm.route(k, n, aligned) == want


def test_plan_of_the_serving_shapes():
    """Decode splits K into ranges of 4 slabs where the 16 x 128 tiles are
    few; prefill splits its 24-66 tiles toward one block per SM; the LM
    heads fill the card without a split."""
    assert mm.plan(4, 1024, 2816) == (16, 128, 11, 256)
    assert mm.plan(1, 1024, 1024) == (16, 128, 4, 256)
    assert mm.plan(4, 151936, 1024) == (16, 128, 1, 1024)
    assert mm.plan(384, 1024, 1024) == (128, 128, 4, 256)
    assert mm.plan(384, 1024, 2816) == (128, 128, 7, 448)
    assert mm.plan(384, 2816, 1024) == (128, 128, 2, 512)
    assert mm.plan(384, 151936, 1024) == (128, 128, 1, 1024)
    with pytest.raises(ValueError):
        mm.plan(0, 16, 16)


def test_compiled_tiles_match_the_plan():
    assert TILES[16][:3] == mm.TILE_THIN and TILES[128][:3] == mm.TILE_WIDE
