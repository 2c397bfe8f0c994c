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
raises.

The CUDA source holds two kernel bodies, and its entry picks one from
the dtype and head dims before the launch and reports it; :func:`route`
states the same rule, which the wrapper applies first (and raises if the
entry took another route):

* ``"tensor_core"``: bf16 with D and Dv at most 128, each a multiple of 8
  (qwen's 64, danube's 80): ``mma.sync`` bf16 products with f32
  accumulation, P rounded to bf16 before the P V product.
* ``"cuda_core"``: everything else, in f32 on the CUDA cores: f32 inputs
  (whose 2e-5 tolerance rules out bf16 or TF32 products), and bf16 with a
  head dim over 128: MLA's D = nope + rope = 192 (Dv = 128), on which
  deepseek-v2-lite-16b's prefill runs.

``flash_attention.launches`` counts the launches and
``flash_attention.launches_by_route`` splits them by route.

With ``return_lse`` both versions also return each query row's
log-sum-exp of its scaled logits (float32, the kernel writing it beside
the output on either route): a decode over keys split across ranks weighs
the ranks' outputs by it (``ops.attention_partial``,
``ops.combine_partials``).  The output is the same with or without it.

The kernel writes a fresh tensor through raw pointers, so its output has
no autograd history.  :class:`FlashAttentionFn` gives it one: its forward
calls the forward it is given (the kernel's wrapper on the card) and saves
q, k and v; its backward is :func:`attention_backward`, plain PyTorch that
recomputes the chunked online softmax of :func:`chunked_attention` and
returns dq, dk and dv.  The reference has no gradient rule for its Pallas
kernel either: its attention gradient is XLA's autodiff of
``chunked_attention``.
"""

from __future__ import annotations

import contextvars
import ctypes
import functools
import math

import torch

from repro_torch import cuda_build

NEG_INF = -1e30                    # the Pallas kernel's masked logit
DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: the kernel bodies, by their id in the C source's ``enum Route``
ROUTE_ID = {"cuda_core": 0, "tensor_core": 1}
ROUTE_NAME = {i: name for name, i in ROUTE_ID.items()}
#: the tensor-core route's head dims: at most 128, a multiple of 8 (one
#: 16-byte copy per 8 bf16)
TC_MAX_HEAD_DIM = 128
TC_HEAD_DIM_MULTIPLE = 8
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the C interface of csrc/flash_attention.cu: q, k, v, out, lse (out, or
#: null), B, Hq, Hkv, Sq, Skv, D, Dv, scale, causal, has_window, window,
#: q_offset, dtype, the route taken (out), stream
ARGTYPES = [_VP] * 5 + [_I] * 7 + [_F] + [_I] * 5 + [_VP] * 2


def route(dtype, d: int, dv: int) -> str:
    """The kernel body a launch with this dtype and these head dims takes:
    ``"tensor_core"`` or ``"cuda_core"`` (module docstring)."""
    if dtype not in DTYPE_ID:
        raise TypeError(f"flash_attention: dtype must be one of "
                        f"{list(DTYPE_ID)}, got {dtype}")
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: head dims 1..{MAX_HEAD_DIM}, "
                         f"got D={d}, Dv={dv}")
    if dtype == torch.bfloat16 and max(d, dv) <= TC_MAX_HEAD_DIM \
            and d % TC_HEAD_DIM_MULTIPLE == 0 \
            and dv % TC_HEAD_DIM_MULTIPLE == 0:
        return "tensor_core"
    return "cuda_core"


#: true while a plain attention runs in the kernel's place, forward
#: (:func:`chunked_attention`) or backward (:func:`attention_backward`):
#: the counterpart of the reference's ``named_scope("flashattn_fallback")``,
#: read by the dry run's census (:mod:`repro_torch.launch.analysis`).  The
#: backward that autograd derives from :func:`chunked_attention` runs
#: outside it.
FALLBACK = contextvars.ContextVar("flashattn_fallback", default=False)


def _fallback(fn):
    @functools.wraps(fn)
    def scoped(*args, **kwargs):
        token = FALLBACK.set(True)
        try:
            return fn(*args, **kwargs)
        finally:
            FALLBACK.reset(token)
    return scoped


@_fallback
def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      kv_chunk: int = 1024, return_lse: bool = False):
    """Online-softmax attention over KV chunks in plain PyTorch; never
    materializes Sq x Skv (peak temp Sq x kv_chunk per head).
    q: (B, Hq, Sq, D); k: (B, Hkv, Skv, D); v: (B, Hkv, Skv, Dv).  With
    ``return_lse`` also each row's log-sum-exp of its scaled logits, the
    running max plus the log of the running sum, float32 (B, Hq, Sq):
    ``ops.partial_softmax``'s logsumexp, masked keys at ``NEG_INF``."""
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
    out = (acc / l).reshape(b, hq, sq, dv).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l)).reshape(b, hq, sq)


@_fallback
def attention_backward(q, k, v, do, *, causal=True, window=None,
                       q_offset=0, kv_chunk: int = 1024) -> tuple:
    """The gradients (dq, dk, dv) of :func:`chunked_attention`'s output at
    (q, k, v) for the output gradient ``do`` (B, Hq, Sq, Dv), each in its
    input's dtype; float32 inside, the GQA groups of a KV head summed into
    its dk and dv.  Two passes over the KV chunks: the first recomputes
    each row's running max ``m``, its sum ``l`` and its output ``o``
    (those of the forward), the second forms ``P = exp(S - m) / l`` per
    chunk and from it ``dV = P^T dO``, ``dS = P * (dO V^T - rowsum(dO *
    o))`` (zero where the mask hides the key, as autograd's gradient of
    the masked fill) and ``dQ = dS K``, ``dK = dS^T Q``, both scaled by
    ``1 / sqrt(D)``.  A row that sees no key has ``P = 1 / Skv`` over all
    keys, as in the forward, and passes gradient to V only."""
    b, hq, sq, d = q.shape
    dv_dim = v.shape[-1]
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    rows = group * sq
    qf = (q.float() * scale).reshape(b, hkv, rows, d)
    dof = do.float().reshape(b, hkv, rows, dv_dim)
    qpos = (torch.arange(sq, device=dev) + q_offset).repeat(group)

    def chunk(j):
        kb = k[:, :, j:j + kv_chunk].float()
        vb = v[:, :, j:j + kv_chunk].float()
        kpos = torch.arange(j, j + kb.shape[2], device=dev)
        mask = torch.ones((rows, kb.shape[2]), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > (qpos[:, None] - window)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb).masked_fill(~mask,
                                                                NEG_INF)
        return kb, vb, mask, s

    m = torch.full((b, hkv, rows, 1), NEG_INF, device=dev)
    l = torch.zeros((b, hkv, rows, 1), device=dev)
    acc = torch.zeros((b, hkv, rows, dv_dim), device=dev)
    for j in range(0, skv, kv_chunk):
        _, vb, _, s = chunk(j)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    delta = (dof * (acc / l)).sum(dim=-1, keepdim=True)
    del acc
    dq = torch.zeros_like(qf)
    dk = torch.empty((b, hkv, skv, d), device=dev)
    dv = torch.empty((b, hkv, skv, dv_dim), device=dev)
    for j in range(0, skv, kv_chunk):
        kb, vb, mask, s = chunk(j)
        p = torch.exp(s - m) / l
        dv[:, :, j:j + kv_chunk] = torch.einsum("bhqk,bhqd->bhkd", p, dof)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vb)
        ds = (p * (dp - delta)).masked_fill(~mask, 0.0)
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dk[:, :, j:j + kv_chunk] = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dq = (dq * scale).reshape(b, hq, sq, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with an autograd history: ``apply(q, k, v, forward,
    causal, window, q_offset)`` returns ``forward(q, k, v, causal=...,
    window=..., q_offset=...)`` (on the card :func:`flash_attention`, the
    kernel; a test may pass :func:`chunked_attention` to drive this
    backward on the CPU) and saves q, k and v; the backward is
    :func:`attention_backward` on them."""

    @staticmethod
    def forward(ctx, q, k, v, forward, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset)
        return forward(q, k, v, **ctx.kw)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(q, k, v, do, **ctx.kw), None, None, None,
                None)


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
                    q_offset: int = 0, return_lse: bool = False):
    """q: (B, Hq, Sq, D); k: (B, Hkv, Skv, D); v: (B, Hkv, Skv, Dv); one
    dtype, float32 or bfloat16.  Returns (B, Hq, Sq, Dv) in that dtype;
    with ``return_lse`` (out, lse), lse float32 (B, Hq, Sq) as
    :func:`chunked_attention` gives it."""
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, return_lse=return_lse)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be 4-D")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[-1]
    kind = route(q.dtype, d, dv)
    if hkv < 1 or hq % hkv or sq < 1 or skv < 1:
        raise ValueError(f"flash_attention: need Hq a multiple of Hkv and "
                         f"Sq, Skv >= 1, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    dev = q.device
    _check("q", q, q.dtype, (b, hq, sq, d), dev)
    _check("k", k, q.dtype, (b, hkv, skv, d), dev)
    _check("v", v, q.dtype, (b, hkv, skv, dv), dev)
    if kind == "tensor_core" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the tensor-core route copies 16 "
                         "bytes at a time and needs q, k and v 16-byte "
                         "aligned")
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=dev)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev) \
        if return_lse else None
    fn = cuda_build.entry("flash_attention", ARGTYPES)
    taken = _I(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), b, hq, hkv, sq,
                skv, d, dv, 1.0 / math.sqrt(d), int(causal),
                int(window is not None), 0 if window is None else window,
                q_offset, DTYPE_ID[q.dtype], ctypes.byref(taken), stream)
    cuda_build.check_launch("flash_attention", rc)
    took = ROUTE_NAME.get(taken.value)
    if took != kind:
        raise RuntimeError(f"flash_attention: the kernel took route "
                           f"{taken.value}, the wrapper's rule says {kind}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[took] += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTE_ID, 0)
