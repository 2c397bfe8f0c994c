"""Dispatching entry points the models call: the hand-written kernel on CUDA
tensors, its plain version on CPU tensors.

The counterpart of the JAX package's ``kernels/ops.py`` (Pallas on a TPU,
XLA elsewhere).  Here the implementation follows the tensors' device: on
the card :func:`nmc_matmul`, :func:`attention` and :func:`vrf_alu` launch
the CUDA kernels, on the CPU they run the plain PyTorch versions.
:func:`force_plain` is a scoped override that makes them run the plain
versions on any device, so that a test or the smoke run can hold one
against the other on the same inputs; nothing on the serving path
enters it.  ``force_plain(kernel_autograd=True)`` keeps the card's
program around the plain arithmetic: the attention's inputs made
contiguous and, where autograd records, the kernel's autograd Function
with the plain forward in the kernel's place (the dry run's route, on
``meta``, where no kernel runs).

Where autograd records (a train step on the card), :func:`attention`
runs the kernel inside :class:`~repro_torch.kernels.flash_attention.
FlashAttentionFn`, whose backward is plain PyTorch; on the CPU and under
:func:`force_plain` autograd differentiates the plain version itself.

:func:`chunked_attention` and :func:`decode_attention` are plain PyTorch
everywhere: in the reference they are XLA, not Pallas.  So are the two
halves that :func:`decode_attention` is made of, which a decode over a
cache whose slots are split across ranks runs apart:
:func:`decode_attention_partial` (one slice of the slots: its attention
and the logsumexp of its logits) and :func:`combine_partials` (the
slices' attentions weighted by their logsumexps, by reductions the
caller passes in: this module knows no collectives).
:func:`attention_partial` is the same first half over one slice of the
keys of an attention without a cache mask (a cross-attention over a
rank's encoder frames), and follows the device: the flash kernel with
its log-sum-exp output on the card.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import nmc_matmul as _mm
from repro_torch.kernels import ref
from repro_torch.kernels import vrf_alu as _vrf
from repro_torch.kernels.flash_attention import (NEG_INF, FlashAttentionFn,
                                                 chunked_attention)

__all__ = ["attention", "attention_partial", "chunked_attention",
           "combine_partials", "decode_attention",
           "decode_attention_partial", "force_plain", "nmc_matmul",
           "partial_softmax", "vrf_alu"]

_PLAIN = contextvars.ContextVar("repro_torch_force_plain", default=False)


@contextlib.contextmanager
def force_plain(kernel_autograd: bool = False):
    """Run the plain versions instead of the kernels inside the block;
    with ``kernel_autograd``, an attention that autograd records through
    :class:`FlashAttentionFn` (q, k and v saved, the backward
    :func:`~repro_torch.kernels.flash_attention.attention_backward`), as
    on the card."""
    token = _PLAIN.set("kernel_autograd" if kernel_autograd else True)
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


def vrf_alu(vrf, prog):
    """Execute an ``(n_instr, 6)`` VRF program over ``vrf`` in place."""
    if _PLAIN.get():
        return ref.vrf_alu(vrf, prog)
    return _vrf.vrf_alu(vrf, prog)


def attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """Memory-safe attention: the flash kernel on the card, the chunked
    online softmax otherwise.  On the card, where autograd records and an
    input requires grad, the kernel's output gets its gradient from
    :class:`FlashAttentionFn`."""
    plain = _PLAIN.get()
    if plain is True:
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    forward = chunked_attention if plain else _fa.flash_attention
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if (plain or q.device.type != "cpu") and torch.is_grad_enabled() and \
            any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, forward, causal, window,
                                      q_offset)
    return forward(q, k, v, causal=causal, window=window, q_offset=q_offset)


def attention_partial(q, k, v, *, causal=True, window=None,
                      lse: bool = True):
    """Attention over one slice of the keys, for :func:`combine_partials`:
    (o (B, Hq, Sq, Dv) in q's dtype, lse (B, Hq, Sq) float32, the
    log-sum-exp of each row's scaled logits over the slice; None without
    ``lse``, where the slice is all the keys).  The flash kernel on the
    card (one launch, ``return_lse``), its plain version on the CPU and
    under :func:`force_plain`; inference only (no autograd Function around
    it)."""
    forward = chunked_attention if _PLAIN.get() else _fa.flash_attention
    out = forward(q.contiguous(), k.contiguous(), v.contiguous(),
                  causal=causal, window=window, return_lse=lse)
    return out if lse else (out, None)


def _decode_mask(s: int, offset: int, cache_len, window, device):
    """(B, s): which of ``s`` slots, at global positions ``offset`` on, a
    row of ``cache_len`` attends to (within ``window`` where given)."""
    kpos = torch.arange(offset, offset + s, device=device)[None, :]
    clen = cache_len.to(device)[:, None]
    mask = kpos < clen
    if window is not None:
        mask &= kpos > (clen - 1 - window)
    return mask


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None):
    """Single-token decode attention against a (possibly padded) KV cache.

    q: (B, Hq, 1, D); caches: (B, Hkv, S, D); cache_len: (B,) valid
    lengths (the new token is at index cache_len - 1).  The one-slice case
    of :func:`decode_attention_partial` (nothing to combine)."""
    o, _ = decode_attention_partial(q, k_cache, v_cache, cache_len, 0,
                                    window=window, lse=False)
    return o[:, :, None].to(q.dtype)


def partial_softmax(logits: torch.Tensor, lse: bool = True) -> tuple:
    """Float32 logits (masked entries ``NEG_INF``) over the last dim ->
    (their softmax, their logsumexp or None without ``lse``).  A slice
    whose entries are all masked has a finite softmax and a logsumexp of
    ``NEG_INF``, so that :func:`combine_partials` gives it weight
    ``exp(NEG_INF - M) = 0`` beside any slice that holds an unmasked
    entry."""
    return (torch.softmax(logits, dim=-1),
            torch.logsumexp(logits, dim=-1) if lse else None)


def decode_attention_partial(q, k_cache, v_cache, cache_len, offset: int, *,
                             window=None, lse: bool = True) -> tuple:
    """:func:`decode_attention` over one slice of the slots: q (B, Hq, 1,
    D) against k / v caches (B, Hkv, S_local, D / Dv) whose slots sit at
    global positions ``offset`` to ``offset + S_local``, under the same
    masks (``cache_len`` (B,) valid lengths, ``window``; a ring cache
    passes ``min(cache_len, S_cache)`` and no window).  Returns float32
    (o (B, Hq, Dv), the attention over the slice; lse (B, Hq), the
    logsumexp of its logits, for :func:`combine_partials`; None without
    ``lse``)."""
    b, hq, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    group = hq // hkv
    qf = q.float().reshape(b, hkv, group, d) * (1.0 / d ** 0.5)
    logits = torch.einsum("bhgd,bhkd->bhgk", qf, k_cache.float())
    mask = _decode_mask(s, offset, cache_len, window, q.device)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    p, lse = partial_softmax(logits, lse)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return (o.reshape(b, hq, v_cache.shape[-1]),
            None if lse is None else lse.reshape(b, hq))


def combine_partials(o, lse, all_max, all_sum) -> torch.Tensor:
    """The attention over every slice of the slots from each slice's
    :func:`decode_attention_partial` (or :func:`partial_softmax`, or
    :func:`attention_partial`) parts: each slice's ``o`` weighted by
    ``exp(lse - M)``, ``M`` the largest ``lse`` over the slices, summed
    with the weights (one reduction of both) and divided.  ``all_max`` /
    ``all_sum`` reduce a tensor over the slices (the ranks that hold them).
    Float32 (B, H, Dv), or (B, H, Sq, Dv) for an ``o`` of that shape."""
    w = torch.exp(lse - all_max(lse))
    part = all_sum(torch.cat([o * w[..., None], w[..., None]], dim=-1))
    return part[..., :-1] / part[..., -1:]
