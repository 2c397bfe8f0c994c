"""The log-sum-exp output of the attention kernel's plain version, and the
partial attention a cross-attention over encoder frames split across
ranks runs (``ops.attention_partial``, ``ops.combine_partials``), on the
CPU.

Inputs are drawn with numpy from a seed.  ``chunked_attention(...,
return_lse=True)``'s lse equals ``torch.logsumexp`` of the whole scaled,
masked logits (masked keys at ``NEG_INF``, as ``ops.partial_softmax``),
its output is the one without the flag bit for bit and the JAX package's
``chunked_attention`` within float32's 2e-5; the partials of the keys'
halves, combined, equal the attention over all of them within 2e-5.  The
kernel's own lse runs on the card: ``tests/test_torch_cuda_kernels.py``
(the ``gpu`` cases, which skip without a card) and ``chip_smoke.py``
(``kernels/checks.ATTENTION_CASES["whisper-cross-partial-750"]``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import NEG_INF, chunked_attention

ATOL = 2e-5
#: (B, Hq, Hkv, Sq, Skv, D, Dv, masking): GQA with a causal mask and a
#: prefill continuing a cache, a window inside a chunk, non-causal with
#: Dv != D and a ragged Skv over several chunks, rows that see no key
CASES = {
    "gqa-causal-offset": (2, 4, 2, 5, 40, 16, 16,
                          dict(causal=True, q_offset=35)),
    "window": (1, 2, 2, 24, 24, 8, 8, dict(causal=True, window=6)),
    "noncausal-ragged": (2, 6, 3, 3, 77, 16, 8, dict(causal=False)),
    "masked-rows": (1, 2, 1, 4, 10, 8, 8,
                    dict(causal=True, window=3, q_offset=20)),
}


def _inputs(case: str, seed: int = 0) -> tuple:
    b, hq, hkv, sq, skv, d, dv, kw = CASES[case]
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return (rand(b, hq, sq, d), rand(b, hkv, skv, d), rand(b, hkv, skv, dv),
            kw)


def _logits(q, k, kw) -> torch.Tensor:
    """Every head's scaled logits (B, Hq, Sq, Skv), masked with NEG_INF."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    kf = k.repeat_interleave(hq // k.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kf) / math.sqrt(d)
    qpos = torch.arange(sq)[:, None] + kw.get("q_offset", 0)
    kpos = torch.arange(k.shape[2])[None, :]
    seen = torch.ones((sq, k.shape[2]), dtype=torch.bool)
    if kw.get("causal", True):
        seen &= kpos <= qpos
    if kw.get("window") is not None:
        seen &= kpos > qpos - kw["window"]
    return s.masked_fill(~seen, NEG_INF)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lse_is_the_logsumexp_of_the_scaled_logits(case):
    q, k, v, kw = (torch.from_numpy(t) if isinstance(t, np.ndarray) else t
                   for t in _inputs(case))
    out, lse = chunked_attention(q, k, v, **kw, kv_chunk=16,
                                 return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    want = torch.logsumexp(_logits(q, k, kw), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-5)
    # the output is the one without the flag, and the reference's
    assert torch.equal(out, chunked_attention(q, k, v, **kw, kv_chunk=16))
    ref = jops.chunked_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                 **kw, kv_chunk=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("case", ["noncausal-ragged", "gqa-causal-offset"])
def test_partials_over_two_halves_combine_to_the_whole(case):
    """The cross-attention of a frame-split cache: each half of the keys
    gives (o, lse) by ``ops.attention_partial``; ``ops.combine_partials``
    (the two halves stacked on a leading dim stand for two ranks) equals
    ``ops.attention`` over every key.  A causal case's second half starts
    at the first half's length (``q_offset`` minus it)."""
    q, k, v, kw = (torch.from_numpy(t) if isinstance(t, np.ndarray) else t
                   for t in _inputs(case, seed=1))
    half = k.shape[2] // 2
    causal = kw["causal"]
    parts = []
    for lo, hi in ((0, half), (half, k.shape[2])):
        if causal:          # keys lo.. seen from position q_offset - lo
            o, lse = chunked_attention(q, k[:, :, lo:hi], v[:, :, lo:hi],
                                       causal=True,
                                       q_offset=kw["q_offset"] - lo,
                                       return_lse=True)
        else:
            o, lse = ops.attention_partial(q, k[:, :, lo:hi],
                                           v[:, :, lo:hi], causal=False)
        parts.append((o, lse))
    o, lse = (torch.stack(t) for t in zip(*parts))
    got = ops.combine_partials(
        o, lse, lambda t: t.amax(0, keepdim=True).expand_as(t),
        lambda t: t.sum(0, keepdim=True).expand_as(t))
    want = ops.attention(q, k, v, **kw)
    assert got.dtype == torch.float32
    for rank in range(2):
        np.testing.assert_allclose(got[rank].numpy(), want.numpy(), rtol=0,
                                   atol=ATOL)


def test_attention_partial_follows_force_plain():
    """Under ``ops.force_plain`` (and on the CPU) the partial is the plain
    version's (out, lse) bit for bit."""
    q, k, v, _ = (torch.from_numpy(t) if isinstance(t, np.ndarray) else t
                  for t in _inputs("noncausal-ragged", seed=2))
    want = chunked_attention(q, k, v, causal=False, return_lse=True)
    for plain in (False, True):
        if plain:
            with ops.force_plain():
                got = ops.attention_partial(q, k, v, causal=False)
        else:
            got = ops.attention_partial(q, k, v, causal=False)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_attention_partial_without_lse_is_the_attention():
    """Asked for no log-sum-exp (a slice that is all the keys),
    ``ops.attention_partial`` gives ``ops.attention``'s output bit for bit
    and None."""
    q, k, v, _ = (torch.from_numpy(t) if isinstance(t, np.ndarray) else t
                  for t in _inputs("noncausal-ragged", seed=3))
    o, lse = ops.attention_partial(q, k, v, causal=False, lse=False)
    assert lse is None
    assert torch.equal(o, ops.attention(q, k, v, causal=False))


def test_one_rank_cross_decode_is_the_forward_cross_attention():
    """Off a mesh, ``GQAttention.cross_decode`` (the decode step's one
    cross-attention path) gives the forward's cross-attention over the
    same K / V (``kv=``) at one query, bit for bit."""
    from repro_torch.configs import base as cb
    from repro_torch.models import attention as A
    cfg = cb.get("whisper-tiny", smoke=True).scaled(dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    xattn = A.GQAttention.init(gen, cfg)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 1, cfg.d_model))
                         .astype(np.float32))
    kv = tuple(torch.from_numpy(rng.normal(
        size=(2, cfg.n_kv_heads, cfg.enc_seq, cfg.head_dim))
        .astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        got = xattn.cross_decode(x, cfg, kv)
        want = xattn(x, cfg, causal=False, kv=kv)
    assert got.shape == (2, 1, cfg.d_model)
    assert torch.equal(got, want)
