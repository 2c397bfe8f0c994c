"""Dispatching entry points the models call: the hand-written kernel on CUDA
tensors, its plain version on CPU tensors.

The counterpart of the JAX package's ``kernels/ops.py`` (Pallas on a TPU,
XLA elsewhere).  Here the implementation follows the tensors' device: on
the card :func:`nmc_matmul` and :func:`attention` launch the CUDA kernels,
on the CPU they run the plain PyTorch versions.  :func:`force_plain` is a
scoped override that makes them run the plain versions on any device, so
that a test or the smoke run can hold one against the other on the same
inputs; nothing on the serving path enters it.

:func:`chunked_attention` and :func:`decode_attention` are plain PyTorch
everywhere: in the reference they are XLA, not Pallas.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import nmc_matmul as _mm
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import NEG_INF, chunked_attention

__all__ = ["attention", "chunked_attention", "decode_attention",
           "force_plain", "nmc_matmul"]

_PLAIN = contextvars.ContextVar("repro_torch_force_plain", default=False)


@contextlib.contextmanager
def force_plain():
    """Run the plain versions instead of the kernels inside the block."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def nmc_matmul(x_q, w_q, scale, bias=None, *, act: str = "none",
               out_dtype=torch.bfloat16):
    """W8A8 matmul with fused epilogue (2-D operands)."""
    if _PLAIN.get():
        return ref.nmc_matmul(x_q, w_q, scale, bias, act=act,
                              out_dtype=out_dtype)
    return _mm.nmc_matmul(x_q, w_q, scale, bias, act=act,
                          out_dtype=out_dtype)


def attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """Memory-safe attention: the flash kernel on the card, the chunked
    online softmax otherwise."""
    if _PLAIN.get():
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    return _fa.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window,
                               q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None):
    """Single-token decode attention against a (possibly padded) KV cache.

    q: (B, Hq, 1, D); caches: (B, Hkv, S, D); cache_len: (B,) valid
    lengths (the new token is at index cache_len - 1)."""
    b, hq, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    group = hq // hkv
    qf = q.float().reshape(b, hkv, group, d) * (1.0 / d ** 0.5)
    logits = torch.einsum("bhgd,bhkd->bhgk", qf, k_cache.float())
    kpos = torch.arange(s, device=q.device)[None, :]
    clen = cache_len.to(q.device)[:, None]
    mask = kpos < clen
    if window is not None:
        mask &= kpos > (clen - 1 - window)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, 1, v_cache.shape[-1]).to(q.dtype)
