"""The port's lane ALU (repro_torch.core.alu) against the JAX reference's
(repro.core.alu), bit for bit: every lane pair at SEW 8 (2^16), random
pairs plus the extremes at SEW 16 and 32, and the 32-bit DOT wrap."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alu as ref
from repro_torch.core import alu

SEWS = (8, 16, 32)


def _word_pairs(sew):
    """int32 word arrays (a, b) whose lanes cover the test pairs."""
    dt = alu.NP_DTYPES[sew]
    info = np.iinfo(dt)
    if sew == 8:                      # every (a, b) lane pair
        vals = np.arange(info.min, info.max + 1, dtype=np.int64)
        la, lb = (x.reshape(-1) for x in np.meshgrid(vals, vals))
    else:
        ext = np.array([info.min, info.min + 1, -2, -1, 0, 1, 2,
                        info.max - 1, info.max], np.int64)
        pa, pb = (x.reshape(-1) for x in np.meshgrid(ext, ext))
        rng = np.random.default_rng(sew)
        n = 4096 * (32 // sew) - pa.size
        la = np.concatenate([pa, rng.integers(info.min, info.max + 1, n)])
        lb = np.concatenate([pb, rng.integers(info.min, info.max + 1, n)])
    return alu.pack_np(la.astype(dt)), alu.pack_np(lb.astype(dt))


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("sew", SEWS)
def test_unpack_pack_match_reference(sew):
    a, _ = _word_pairs(sew)
    lanes = alu.unpack(_t(a), sew)
    exp = np.asarray(ref.unpack(jnp.asarray(a), sew))
    assert lanes.dtype == torch.int32
    assert (lanes.numpy() == exp).all()
    assert (alu.pack(lanes, sew).numpy() == a).all()
    # pack truncates untruncated lanes exactly like the reference
    wide = exp.astype(np.int64) * 977 - 12345
    got = alu.pack(_t(wide), sew).numpy()
    assert (got == np.asarray(ref.pack(jnp.asarray(wide.astype(np.int32)),
                                       sew))).all()


@pytest.mark.parametrize("op", ref.BINOPS)
@pytest.mark.parametrize("sew", SEWS)
def test_lane_and_word_binops_match_reference(op, sew):
    a, b = _word_pairs(sew)
    got = alu.word_binop(op, _t(a), _t(b), sew).numpy()
    exp = np.asarray(ref.word_binop(op, jnp.asarray(a), jnp.asarray(b), sew))
    assert (got == exp).all(), np.flatnonzero(got != exp)[:8]
    # the untruncated lane results too (what vx operands feed)
    la, lb = ref.unpack(jnp.asarray(a), sew), ref.unpack(jnp.asarray(b), sew)
    got_l = alu.lane_binop(op, _t(np.asarray(la)), _t(np.asarray(lb)), sew)
    assert (got_l.numpy() == np.asarray(ref.lane_binop(op, la, lb,
                                                       sew))).all()


@pytest.mark.parametrize("sew", SEWS)
def test_lane_binops_with_raw_scalar_operand(sew):
    """vx / vi operands are raw int32 scalars, not SEW-truncated lanes."""
    a, _ = _word_pairs(sew)
    la = ref.unpack(jnp.asarray(a[:512]), sew)
    for op, s in itertools.product(ref.BINOPS, (-2**31, -129, 77, 2**31 - 1)):
        lb = jnp.full(la.shape, s, jnp.int32)
        got = alu.lane_binop(op, _t(np.asarray(la)), _t(np.asarray(lb)), sew)
        assert (got.numpy() == np.asarray(ref.lane_binop(op, la, lb,
                                                         sew))).all(), op


@pytest.mark.parametrize("sew", SEWS)
def test_word_macc_matches_reference(sew):
    a, b = _word_pairs(sew)
    acc = np.roll(a, 7)
    got = alu.word_macc(_t(acc), _t(a), _t(b), sew).numpy()
    exp = np.asarray(ref.word_macc(jnp.asarray(acc), jnp.asarray(a),
                                   jnp.asarray(b), sew))
    assert (got == exp).all()


@pytest.mark.parametrize("acc", [0, 2**31 - 1, -2**31, -5])
@pytest.mark.parametrize("sew", SEWS)
def test_word_dot_wraps_like_reference(sew, acc):
    a, b = _word_pairs(sew)
    for n in (1, 64, a.size):               # single word .. all pairs
        got = alu.word_dot(acc, _t(a[:n]), _t(b[:n]), sew)
        exp = ref.word_dot(jnp.int32(acc), jnp.asarray(a[:n]),
                           jnp.asarray(b[:n]), sew)
        assert got.dtype == torch.int32
        assert int(got) == int(exp), (n, int(got), int(exp))
    # a product sum far past 2^31 must wrap, not saturate or widen
    big = alu.pack_np(np.full(32 // sew, np.iinfo(alu.NP_DTYPES[sew]).min,
                              alu.NP_DTYPES[sew]))
    words = np.repeat(big, 4096)
    got = alu.word_dot(acc, _t(words), _t(words), sew)
    exp = ref.word_dot(jnp.int32(acc), jnp.asarray(words),
                       jnp.asarray(words), sew)
    assert int(got) == int(exp)


def test_numpy_mirrors_are_the_reference_copies():
    rng = np.random.default_rng(0)
    a = rng.integers(-2**31, 2**31, 256, dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, 256, dtype=np.int64).astype(np.int32)
    for sew in SEWS:
        for op in ref.BINOPS:
            assert (alu.word_binop_np(op, a, b, sew)
                    == ref.word_binop_np(op, a, b, sew)).all()
        assert (alu.word_macc_np(a, b, a, sew)
                == ref.word_macc_np(a, b, a, sew)).all()
        assert alu.word_dot_np(9, a, b, sew) == ref.word_dot_np(9, a, b, sew)
        assert (alu.unpack_np(a, alu.NP_DTYPES[sew])
                == ref.unpack_np(a, ref.NP_DTYPES[sew])).all()
