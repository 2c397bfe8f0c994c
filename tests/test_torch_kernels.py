"""The port's LM-layer kernels (plain versions, on the CPU) against the JAX
reference: ``nmc_matmul`` against the Pallas kernel in interpret mode and
against ``ref.nmc_matmul``, attention against the Pallas flash kernel in
interpret mode, the quantizers and activations against ``ref``.  Inputs
are made with numpy from a seed and handed to both packages.  The CUDA
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``)."""

import ctypes
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.nmc_matmul import nmc_matmul as jmatmul
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import nmc_matmul as mm
from repro_torch.kernels import ops, ref

CSRC = pathlib.Path(mm.__file__).resolve().parents[1] / "csrc"


def _rng(seed):
    return np.random.default_rng(seed)


def _mm_inputs(rng, m, k, n, lo=-127):
    x = rng.integers(lo, 128, (m, k), dtype=np.int8)
    w = rng.integers(lo, 128, (k, n), dtype=np.int8)
    s = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    return x, w, s, b


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# nmc_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 256, 128, 64, 64, 128),
    (256, 512, 256, 128, 256, 256),
    (64, 128, 512, 64, 128, 64),
])
@pytest.mark.parametrize("act", ["none", "relu", "silu"])
def test_nmc_matmul_plain_matches_pallas_interpret(m, k, n, bm, bn, bk, act):
    x, w, s, b = _mm_inputs(_rng(m + n), m, k, n)
    want = jmatmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                   jnp.asarray(b), act=act, bm=bm, bn=bn, bk=bk,
                   interpret=True)
    before = mm.nmc_matmul.launches
    got = mm.nmc_matmul(*_t(x, w, s, b), act=act)
    assert mm.nmc_matmul.launches == before      # the CPU runs the plain
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_nmc_matmul_extreme_int8_epilogue_matches_pallas():
    rng = _rng(1)
    k = 512
    x = rng.choice(np.array([-128, -1, 127], np.int8), (64, k))
    w = rng.choice(np.array([-128, -1, 127], np.int8), (k, 128))
    s = rng.uniform(1e-4, 1e-3, 128).astype(np.float32)
    b = rng.normal(size=128).astype(np.float32)
    want = jmatmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                   jnp.asarray(b), act="silu", bm=64, bn=128, bk=128,
                   interpret=True)
    got = mm.nmc_matmul(*_t(x, w, s, b), act="silu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("m,k,n", [(4, 2816, 384), (7, 33, 70), (1, 88, 130),
                                   (5, 1024, 257)])
@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
def test_nmc_matmul_plain_matches_ref_at_ragged_shapes(m, k, n, act):
    """Shapes the Pallas kernel's tiles refuse (qwen1.5-0.5B's d_ff = 2816
    leaves 256 over bk = 512, its vocabulary 128 over bn = 256)."""
    x, w, s, b = _mm_inputs(_rng(k + n), m, k, n)
    want = jref.nmc_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                           jnp.asarray(b), act=act)
    got = mm.nmc_matmul(*_t(x, w, s, b), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    acc = mm.nmc_matmul(*_t(x, w), None, out_dtype=torch.int32)
    assert acc.dtype == torch.int32
    assert np.array_equal(acc.numpy(),
                          x.astype(np.int64) @ w.astype(np.int64))


def test_nmc_matmul_bf16_out_within_one_ulp_of_ref():
    x, w, s, b = _mm_inputs(_rng(3), 8, 96, 40)
    for act in ("none", "silu", "gelu"):
        want = np.asarray(jref.nmc_matmul(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), jnp.asarray(b),
            act=act, out_dtype=jnp.bfloat16).astype(jnp.float32))
        got = mm.nmc_matmul(*_t(x, w, s, b), act=act,
                            out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=1e-4)


def test_nmc_matmul_int32_accumulation_exact():
    k = 2816
    x = torch.full((4, k), -128, dtype=torch.int8)
    w = torch.full((k, 8), -128, dtype=torch.int8)
    acc = mm.nmc_matmul(x, w, None, out_dtype=torch.int32)
    assert bool((acc == 128 * 128 * k).all())
    with pytest.raises(ValueError):
        ref.nmc_matmul(x, w, torch.ones(8), out_dtype=torch.int32)


def test_quantizers_match_ref():
    rng = _rng(4)
    w = (rng.normal(size=(96, 40)) * 0.05).astype(np.float32)
    x = rng.normal(size=(6, 96)).astype(np.float32)
    jw, js = jref.quantize_rowwise(jnp.asarray(w))
    tw, ts = ref.quantize_rowwise(torch.from_numpy(w))
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jx, jsx = jref.quantize_dynamic(jnp.asarray(x))
    tx, tsx = ref.quantize_dynamic(torch.from_numpy(x))
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    assert float(tsx) == float(jsx)


@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
def test_apply_act_matches_ref(act):
    y = np.linspace(-8, 8, 257).astype(np.float32)
    np.testing.assert_allclose(
        ref.apply_act(torch.from_numpy(y), act).numpy(),
        np.asarray(jref.apply_act(jnp.asarray(y), act)), rtol=1e-6,
        atol=1e-6)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(rng, b, hq, hkv, sq, skv, d, dv=None):
    dv = dv or d
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, dv)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,win", [
    (2, 4, 2, 256, 256, 64, True, None),
    (1, 8, 2, 128, 512, 64, True, 128),
    (1, 4, 4, 128, 256, 32, False, None),
    (2, 2, 1, 64, 384, 128, True, None),
])
def test_attention_plain_matches_flash_interpret(b, hq, hkv, sq, skv, d,
                                                 causal, win):
    q, k, v = _qkv(_rng(sq + skv), b, hq, hkv, sq, skv, d)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=win, bq=64, bk=128, interpret=True)
    before = fa.flash_attention.launches
    got = fa.flash_attention(*_t(q, k, v), causal=causal, window=win)
    assert fa.flash_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_attention_gqa_window_and_dv_match_flash_interpret():
    rng = _rng(5)
    q, k, v = _qkv(rng, 2, 8, 2, 192, 384, 64)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, window=96, bq=64, bk=64, interpret=True)
    got = ops.attention(*_t(q, k, v), causal=True, window=96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    q, k, v = _qkv(rng, 1, 4, 4, 128, 128, 192, dv=128)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, bq=64, bk=64, interpret=True)
    got = fa.flash_attention(*_t(q, k, v), causal=True)
    assert got.shape == (1, 4, 128, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_fully_masked_rows_follow_the_pallas_kernel():
    """q at kv positions 16..23 with window 4 over 8 keys: every row is
    fully masked.  The Pallas kernel (and the chunked fallback) give the
    mean of V there; the plain-softmax reference gives 0.  The port keeps
    each of the two behaviours where the reference has it."""
    q, k, v = _qkv(_rng(6), 1, 2, 1, 8, 8, 16)
    kw = dict(causal=True, window=4, q_offset=16)
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               bq=8, bk=8, interpret=True, **kw))
    np.testing.assert_allclose(pallas[0, 0],
                               np.broadcast_to(v[0, 0].mean(0), (8, 16)),
                               atol=1e-6)
    got = fa.flash_attention(*_t(q, k, v), **kw)
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-5)
    jchunk = np.asarray(jops.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    np.testing.assert_allclose(ops.chunked_attention(*_t(q, k, v), **kw)
                               .numpy(), jchunk, atol=2e-5)
    zeros = ref.attention(*_t(q, k, v), **kw)
    assert not zeros.abs().any()
    np.testing.assert_array_equal(
        zeros.numpy(),
        np.asarray(jref.attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)))


def test_chunked_attention_ragged_kv_matches_reference():
    q, k, v = _qkv(_rng(7), 1, 4, 2, 40, 100, 16)
    for kw in (dict(causal=True), dict(causal=True, window=24),
               dict(causal=False), dict(causal=True, q_offset=60)):
        want = np.asarray(jops.chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_chunk=32,
            **kw))
        got = ops.chunked_attention(*_t(q, k, v), kv_chunk=32, **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
        np.testing.assert_allclose(
            ref.attention(*_t(q, k, v), **kw).numpy(),
            np.asarray(jref.attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)), atol=2e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_reference(window):
    rng = _rng(8)
    q = rng.normal(size=(3, 4, 1, 16)).astype(np.float32)
    kc = rng.normal(size=(3, 2, 24, 16)).astype(np.float32)
    vc = rng.normal(size=(3, 2, 24, 16)).astype(np.float32)
    clen = np.array([1, 9, 24], np.int32)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(clen),
                                 window=window)
    got = ops.decode_attention(*_t(q, kc, vc, clen), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_force_plain_is_scoped():
    x, w, s, b = _mm_inputs(_rng(9), 3, 16, 8)
    want = ref.nmc_matmul(*_t(x, w, s, b), out_dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        with ops.force_plain():
            assert ops._PLAIN.get()
            assert torch.equal(ops.nmc_matmul(*_t(x, w, s, b)), want)
            raise RuntimeError("leave the block")
    assert not ops._PLAIN.get()


# ---------------------------------------------------------------------------
# the C interfaces the ctypes wrappers bind
# ---------------------------------------------------------------------------

def _c_argtypes(stem: str) -> list:
    """The ctypes type of each parameter of the C entry ``stem``."""
    src = (CSRC / f"{stem}.cu").read_text()
    sig = re.search(rf'extern "C" int {stem}\((.*?)\)', src, re.S).group(1)
    types = []
    for param in sig.split(","):
        param = param.strip()
        if "*" in param or param.startswith("cudaStream_t"):
            types.append(ctypes.c_void_p)
        elif param.startswith("float"):
            types.append(ctypes.c_float)
        else:
            assert param.startswith("int "), param
            types.append(ctypes.c_int)
    return types


@pytest.mark.parametrize("wrapper", [mm, fa], ids=["nmc_matmul",
                                                   "flash_attention"])
def test_c_interface_matches_the_wrapper(wrapper):
    stem = wrapper.__name__.rsplit(".", 1)[1]
    assert _c_argtypes(stem) == wrapper.ARGTYPES


def test_activation_and_output_ids_match_the_kernel():
    src = (CSRC / "nmc_matmul.cu").read_text()
    enum = re.search(r"enum Act : int \{(.*?)\};", src, re.S).group(1)
    ids = dict(re.findall(r"ACT_(\w+) = (\d)", enum))
    assert {k.lower(): int(v) for k, v in ids.items()} == mm.ACT_ID
    enum = re.search(r"enum Out : int \{(.*?)\};", src, re.S).group(1)
    assert [int(v) for v in re.findall(r"= (\d)", enum)] == \
        sorted(mm.OUT_KIND.values())
