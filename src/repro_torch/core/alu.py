"""Bit-exact packed-SIMD integer ALU semantics shared by NM-Caesar and NM-Carus.

Both NMC macros operate on 32-bit memory words interpreted as packed vectors of
4x8-bit, 2x16-bit or 1x32-bit two's-complement integers (the paper's "standard
data types", Section III).  This module is the single source of arithmetic
truth for the port: the plain PyTorch engines and the pure-numpy oracles all
reduce to these lane operations, and the CUDA wave kernels
(``repro_torch/csrc``) are held bit for bit against them.

Words are int32 tensors.  PyTorch has no unsigned 32-bit shifts on the CPU
and widens integer sums to int64, so every bit manipulation below runs on
int64 values masked to 32 bits and wraps back to int32 explicitly
(:func:`_wrap32`) — the modulo-2^32 arithmetic of the hardware.  ``sew``
(selected element width, bits) is a static Python int.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SEWS = (8, 16, 32)

# canonical SEW -> numpy dtype map (shared by builders, engines, tests)
NP_DTYPES = {8: np.int8, 16: np.int16, 32: np.int32}

_U32 = (1 << 32) - 1


def lanes_per_word(sew: int) -> int:
    assert sew in SEWS, f"unsupported SEW {sew}"
    return 32 // sew


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """Integer values -> int32 modulo 2^32 (two's-complement bitcast)."""
    x = x.to(torch.int64) & _U32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _shifts(sew: int, device) -> torch.Tensor:
    """Bit offsets of the lanes of a word (cached: a few tensors per SEW
    and device, read-only)."""
    return torch.arange(lanes_per_word(sew), dtype=torch.int64,
                        device=device) * sew


# ---------------------------------------------------------------------------
# Pack / unpack between int32 words and sign-extended int32 lanes
# ---------------------------------------------------------------------------

def unpack(words: torch.Tensor, sew: int) -> torch.Tensor:
    """words int32[...] -> sign-extended lanes int32[..., L], little-endian."""
    if lanes_per_word(sew) == 1:
        return words.to(torch.int32)[..., None]
    u = words.to(torch.int64) & _U32
    raw = (u[..., None] >> _shifts(sew, words.device)) & ((1 << sew) - 1)
    sign = 1 << (sew - 1)
    return ((raw ^ sign) - sign).to(torch.int32)


def pack(lanes: torch.Tensor, sew: int) -> torch.Tensor:
    """lanes int[..., L] -> int32 words[...]; lanes truncated to SEW bits."""
    if lanes_per_word(sew) == 1:
        return _wrap32(lanes[..., 0])
    u = lanes.to(torch.int64) & ((1 << sew) - 1)
    # the lanes occupy disjoint bit fields, so their sum is their OR
    return _wrap32((u << _shifts(sew, lanes.device)).sum(dim=-1))


# numpy-side helpers for building memory images in tests/benchmarks ---------

def pack_np(arr: np.ndarray) -> np.ndarray:
    """Pack a little-endian int8/int16/int32 numpy array into int32 words."""
    b = np.ascontiguousarray(arr).tobytes()
    assert len(b) % 4 == 0, "array byte size must be a multiple of 4"
    return np.frombuffer(b, dtype="<i4").copy()


def unpack_np(words: np.ndarray, dtype) -> np.ndarray:
    return np.frombuffer(np.ascontiguousarray(words, dtype="<i4").tobytes(),
                         dtype=np.dtype(dtype).newbyteorder("<")).copy()


# ---------------------------------------------------------------------------
# Lane ops (two's complement, wraparound at SEW — RVV / NM-Caesar semantics)
# ---------------------------------------------------------------------------

def _shift_amount(b_lanes: torch.Tensor, sew: int) -> torch.Tensor:
    # RVV: shift amount is taken modulo SEW (of the unsigned 32-bit value).
    return (b_lanes.to(torch.int64) & _U32) % sew


def _zext(lanes: torch.Tensor, sew: int) -> torch.Tensor:
    return lanes.to(torch.int64) & (_U32 if sew == 32 else (1 << sew) - 1)


def lane_binop(op: str, a: torch.Tensor, b: torch.Tensor,
               sew: int) -> torch.Tensor:
    """Apply ``op`` on sign-extended int32 lanes; result is NOT yet truncated
    to SEW (pack() truncates).  Arithmetic wraps modulo 2^32, which is exact
    for the low SEW bits of the result — matching hardware truncating
    multiplies."""
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    if op == "add":
        return _wrap32(a64 + b64)
    if op == "sub":
        return _wrap32(a64 - b64)
    if op == "mul":
        return _wrap32(a64 * b64)
    if op == "and":
        return _wrap32(a64 & b64)
    if op == "or":
        return _wrap32(a64 | b64)
    if op == "xor":
        return _wrap32(a64 ^ b64)
    if op == "min":
        return _wrap32(torch.minimum(a64, b64))
    if op == "max":
        return _wrap32(torch.maximum(a64, b64))
    if op == "minu":
        return _wrap32(torch.where(_zext(a, sew) <= _zext(b, sew), a64, b64))
    if op == "maxu":
        return _wrap32(torch.where(_zext(a, sew) >= _zext(b, sew), a64, b64))
    if op == "sll":
        return _wrap32((a64 & _U32) << _shift_amount(b, sew))
    if op == "srl":
        return _wrap32(_zext(a, sew) >> _shift_amount(b, sew))
    if op == "sra":
        # lanes are sign-extended => arithmetic shift is correct
        return _wrap32(a64 >> _shift_amount(b, sew))
    raise ValueError(f"unknown lane op {op!r}")


BINOPS = ("add", "sub", "mul", "and", "or", "xor", "min", "max", "minu",
          "maxu", "sll", "srl", "sra")


# ---------------------------------------------------------------------------
# Pure-numpy mirrors (the differential-test oracle)
#
# These reimplement the lane/word semantics above with numpy-only integer
# arithmetic, so randomized programs executed by the engines can be checked
# bit-exactly against an implementation with an entirely independent
# evaluation path.  Lanes are *sign-extended int32 values* carried in int64
# (so a splat vx scalar is the raw 32-bit value, exactly like `lane_binop`),
# and truncation to SEW happens at `pack_lanes_np`, exactly like `pack`.
# ---------------------------------------------------------------------------


def _to_i32_np(x: np.ndarray) -> np.ndarray:
    """Wrap int64 values into signed 32-bit range (bitcast semantics)."""
    x = np.asarray(x, np.int64) & _U32
    return np.where(x >= (1 << 31), x - (1 << 32), x)


def trunc_lanes_np(x, sew: int) -> np.ndarray:
    """Truncate int64 lane values to SEW bits, sign-extended (= pack+unpack)."""
    mask = (1 << sew) - 1
    x = np.asarray(x, np.int64) & mask
    sign = 1 << (sew - 1)
    return (x ^ sign) - sign


def unpack_lanes_np(words: np.ndarray, sew: int) -> np.ndarray:
    """int32 words[...] -> sign-extended lanes int64[..., L] (mirror of
    :func:`unpack`, little-endian lane order)."""
    words = np.asarray(words, np.int64) & _U32
    nl = lanes_per_word(sew)
    shifts = np.arange(nl, dtype=np.int64) * sew
    return trunc_lanes_np(words[..., None] >> shifts, sew)


def pack_lanes_np(lanes: np.ndarray, sew: int) -> np.ndarray:
    """lanes int64[..., L] -> int32 words (mirror of :func:`pack`:
    truncates each lane to SEW bits)."""
    nl = lanes_per_word(sew)
    mask = (1 << sew) - 1
    u = np.asarray(lanes, np.int64) & mask
    shifts = np.arange(nl, dtype=np.int64) * sew
    return _to_i32_np((u << shifts).sum(axis=-1) & _U32)


def lane_binop_np(op: str, a, b, sew: int) -> np.ndarray:
    """numpy mirror of :func:`lane_binop` — untruncated int64 results over
    sign-extended int32 lane values (truncation happens at pack)."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    mask = (1 << sew) - 1
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return a ^ b
    if op == "min":
        return np.minimum(a, b)
    if op == "max":
        return np.maximum(a, b)
    if op == "minu":
        au, bu = a & mask, b & mask
        return np.where(au <= bu, a, b)
    if op == "maxu":
        au, bu = a & mask, b & mask
        return np.where(au >= bu, a, b)
    sh = (b & _U32) % sew                      # RVV: shift amount mod SEW
    if op == "sll":
        return _to_i32_np(((a & _U32) << sh) & _U32)
    if op == "srl":
        return (a & mask) >> sh
    if op == "sra":
        return a >> sh                          # sign-extended => arithmetic
    raise ValueError(f"unknown lane op {op!r}")


def word_binop_np(op: str, a_words, b_words, sew: int) -> np.ndarray:
    """numpy mirror of :func:`word_binop`."""
    return pack_lanes_np(
        lane_binop_np(op, unpack_lanes_np(a_words, sew),
                      unpack_lanes_np(b_words, sew), sew), sew)


def word_macc_np(acc_words, a_words, b_words, sew: int) -> np.ndarray:
    """numpy mirror of :func:`word_macc`."""
    acc = unpack_lanes_np(acc_words, sew)
    a = unpack_lanes_np(a_words, sew)
    b = unpack_lanes_np(b_words, sew)
    return pack_lanes_np(acc + a * b, sew)


def word_dot_np(acc32: int, a_words, b_words, sew: int) -> int:
    """numpy mirror of :func:`word_dot` (wraps modulo 2^32)."""
    a = unpack_lanes_np(a_words, sew)
    b = unpack_lanes_np(b_words, sew)
    return int(_to_i32_np(int(acc32) + int((a * b).sum())))


# ---------------------------------------------------------------------------
# Word-level operations used by the engines
# ---------------------------------------------------------------------------

def word_binop(op: str, a_words: torch.Tensor, b_words: torch.Tensor,
               sew: int) -> torch.Tensor:
    """Element-wise packed-SIMD op on tensors of int32 words."""
    a = unpack(a_words, sew)
    b = unpack(b_words, sew)
    return pack(lane_binop(op, a, b, sew), sew)


def word_macc(acc_words: torch.Tensor, a_words: torch.Tensor,
              b_words: torch.Tensor, sew: int) -> torch.Tensor:
    """Per-lane multiply-accumulate: acc[i] += a[i]*b[i] (wraps at SEW).
    NM-Caesar MAC / NM-Carus vmacc semantics."""
    a = unpack(a_words, sew).to(torch.int64)
    b = unpack(b_words, sew).to(torch.int64)
    acc = unpack(acc_words, sew).to(torch.int64)
    return pack(acc + a * b, sew)


def word_dot(acc32, a_words: torch.Tensor, b_words: torch.Tensor,
             sew: int) -> torch.Tensor:
    """Word-wise dot product accumulated into a 32-bit scalar accumulator:
    acc32 += sum_l a_l * b_l  (NM-Caesar DOT; wraps modulo 2^32).

    ``torch.sum`` of integers returns int64, so each product is reduced
    modulo 2^32 before the sum (no int64 overflow for any realistic word
    count) and the total is wrapped back to int32 explicitly."""
    a = unpack(a_words, sew).to(torch.int64)
    b = unpack(b_words, sew).to(torch.int64)
    prod = ((a * b) & _U32).sum()
    acc = torch.as_tensor(acc32, device=prod.device).to(torch.int64)
    return _wrap32(acc + prod)
