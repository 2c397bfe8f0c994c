"""Flash attention: the hand-written CUDA kernel's wrapper and its plain
version.

The counterpart of the JAX package's Pallas ``flash_attention``: blocked
online-softmax attention with GQA, causal masking, a sliding ``window``, a
``q_offset`` and ``Dv != D``; the logits never reach device memory.  The
kernel (``repro_torch/csrc/flash_attention.cu``, built for ``sm_90a`` at
first use) takes any Sq and Skv.

Both versions reproduce the Pallas kernel, including where it departs from
the plain-softmax reference (:func:`ref.attention`): a masked key gets the
logit -1e30, so a row that sees no key at all returns the mean of V rather
than 0.  Keys past Skv, which the Pallas kernel never had, are excluded
outright.  No such row occurs on the serving path (causal attention with
``q_offset=0`` always sees its own key).

:func:`chunked_attention` is the plain version (in the JAX package, the
XLA fallback of the same name): the same online softmax over KV chunks in
PyTorch ops.  :func:`flash_attention` runs it on CPU tensors, and only
because they lie on the CPU; on CUDA tensors it launches the kernel or
raises.  ``flash_attention.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import cuda_build

NEG_INF = -1e30                    # the Pallas kernel's masked logit
DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the C interface of csrc/flash_attention.cu: q, k, v, out, B, Hq, Hkv, Sq,
#: Skv, D, Dv, scale, causal, has_window, window, q_offset, dtype, stream
ARGTYPES = [_VP] * 4 + [_I] * 7 + [_F] + [_I] * 5 + [_VP]


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      kv_chunk: int = 1024):
    """Online-softmax attention over KV chunks in plain PyTorch; never
    materializes Sq x Skv (peak temp Sq x kv_chunk per head).
    q: (B, Hq, Sq, D); k: (B, Hkv, Skv, D); v: (B, Hkv, Skv, Dv)."""
    b, hq, sq, d = q.shape
    dv = v.shape[-1]
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    dev = q.device
    qf = (q.float() * (1.0 / math.sqrt(d))).reshape(b, hkv, group * sq, d)
    qpos = (torch.arange(sq, device=dev) + q_offset).repeat(group)
    m = torch.full((b, hkv, group * sq, 1), NEG_INF, device=dev)
    l = torch.zeros((b, hkv, group * sq, 1), device=dev)
    acc = torch.zeros((b, hkv, group * sq, dv), device=dev)
    for j in range(0, skv, kv_chunk):
        kb = k[:, :, j:j + kv_chunk].float()
        vb = v[:, :, j:j + kv_chunk].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
        kpos = torch.arange(j, j + kb.shape[2], device=dev)
        mask = torch.ones((group * sq, kb.shape[2]), dtype=torch.bool,
                          device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > (qpos[:, None] - window)
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l).reshape(b, hq, sq, dv).to(q.dtype)


def _check(name: str, t: torch.Tensor, dtype, shape: tuple, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"flash_attention: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"flash_attention: {name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, "
                         f"expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k: (B, Hkv, Skv, D); v: (B, Hkv, Skv, Dv); one
    dtype, float32 or bfloat16.  Returns (B, Hq, Sq, Dv) in that dtype."""
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be 4-D")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[-1]
    if q.dtype not in DTYPE_ID:
        raise TypeError(f"flash_attention: dtype must be one of "
                        f"{list(DTYPE_ID)}, got {q.dtype}")
    if hkv < 1 or hq % hkv or sq < 1 or skv < 1:
        raise ValueError(f"flash_attention: need Hq a multiple of Hkv and "
                         f"Sq, Skv >= 1, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if max(d, dv) > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dims up to {MAX_HEAD_DIM}, "
                         f"got D={d}, Dv={dv}")
    dev = q.device
    _check("q", q, q.dtype, (b, hq, sq, d), dev)
    _check("k", k, q.dtype, (b, hkv, skv, d), dev)
    _check("v", v, q.dtype, (b, hkv, skv, dv), dev)
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=dev)
    fn = cuda_build.entry("flash_attention", ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, hkv, sq, skv, d, dv, 1.0 / math.sqrt(d), int(causal),
                int(window is not None), 0 if window is None else window,
                q_offset, DTYPE_ID[q.dtype], stream)
    cuda_build.check_launch("flash_attention", rc)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
