"""Plain PyTorch versions of the LM-layer kernels (the port's oracles).

The counterpart of the JAX package's ``kernels/ref.py``: the W8A8 matmul
with its fused epilogue, the activation table, the two int8 quantizers and
plain-softmax attention.  Each runs on the device of its tensors.  The VRF
ALU half of the reference waits for the ``vrf_alu`` slice of the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ACTS = ("none", "relu", "silu", "gelu")


def nmc_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
               scale: torch.Tensor | None, bias: torch.Tensor | None = None,
               act: str = "none", out_dtype=torch.float32) -> torch.Tensor:
    """``y = act((x_q @ w_q) * scale + bias)``.

    x_q: (M, K) int8, w_q: (K, N) int8, scale: (N,) f32 (= s_x * s_w),
    bias: (N,) f32 or None.  ``out_dtype=torch.int32`` returns the int32
    accumulator itself (``scale`` and ``bias`` None, ``act`` "none").

    The product is exact, at the NM-Carus ``vmacc`` width (never
    accumulate at operand width).  CUDA has no integer ``matmul``, so on
    the card it accumulates in float64: every partial sum is an integer
    far below 2^53.  On the CPU it accumulates in int64."""
    wide = torch.float64 if x_q.is_cuda else torch.int64
    acc = (x_q.to(wide) @ w_q.to(wide)).to(torch.int32)
    if out_dtype == torch.int32:
        if scale is not None or bias is not None or act != "none":
            raise ValueError("out_dtype=int32 returns the raw accumulator: "
                             "scale, bias and act must be unset")
        return acc
    # two roundings, as the reference: a product, then a sum (no FMA)
    y = acc.to(torch.float32) * scale.to(torch.float32)[None, :]
    if bias is not None:
        y = y + bias.to(torch.float32)[None, :]
    return apply_act(y, act).to(out_dtype)


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "none":
        return y
    if act == "relu":
        return torch.clamp_min(y, 0)
    if act == "silu":
        return y * torch.sigmoid(y)
    if act == "gelu":                      # jax.nn.gelu's default
        return F.gelu(y, approximate="tanh")
    raise ValueError(act)


def quantize_rowwise(w: torch.Tensor, axis: int = 0):
    """Symmetric per-output-channel int8 quantization of a weight matrix."""
    amax = torch.amax(w.abs(), dim=axis, keepdim=True)
    s = torch.clamp_min(amax, 1e-8) / 127.0
    wq = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return wq, s.reshape(-1)


def quantize_dynamic(x: torch.Tensor):
    """Per-tensor dynamic symmetric int8 quantization of activations: one
    scale over the whole tensor, in the tensor's dtype."""
    amax = torch.amax(x.abs())
    s = torch.clamp_min(amax, 1e-8) / 127.0
    xq = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return xq, s


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              q_offset: int = 0) -> torch.Tensor:
    """Plain-softmax attention.  q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D).
    GQA by head repetition; ``window`` = sliding-window size (None = full);
    ``q_offset`` puts q token i at kv index q_offset + i.  Fully masked
    rows output 0 (the flash kernel and ``chunked_attention`` give the mean
    of V there instead; see ``flash_attention``)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    skv = k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)               # fully masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
