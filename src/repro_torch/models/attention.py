"""Attention layers: GQA (RoPE, optional bias / sliding window).

The counterpart of the GQA half of the JAX package's ``models/attention.py``:
  * train/prefill: blocked flash attention (the CUDA kernel on the card, the
    chunked online softmax on the CPU) — never materializes S x S;
  * decode: one-token attention against a KV cache updated in place (the
    reference's one-hot blend, written as a slot write: equal for finite
    values), optionally int8 with per-token-per-head scales.
MLA waits for its slice of the port (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


class GQAttention(nn.Module):
    def __init__(self, wq: L.NmcLinear, wk: L.NmcLinear, wv: L.NmcLinear,
                 wo: L.NmcLinear):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo

    @classmethod
    def init(cls, gen: torch.Generator, cfg: ModelConfig,
             device=None) -> "GQAttention":
        d, hd = cfg.d_model, cfg.head_dim
        return cls(
            L.NmcLinear.init(gen, d, cfg.n_heads * hd, cfg.qkv_bias, device),
            L.NmcLinear.init(gen, d, cfg.n_kv_heads * hd, cfg.qkv_bias,
                             device),
            L.NmcLinear.init(gen, d, cfg.n_kv_heads * hd, cfg.qkv_bias,
                             device),
            L.NmcLinear.init(gen, cfg.n_heads * hd, d, device=device))

    def _project(self, x: torch.Tensor, cfg: ModelConfig) -> tuple:
        """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd), before RoPE."""
        b, s, _ = x.shape
        hd, mode = cfg.head_dim, cfg.nmc_mode
        return (self.wq(x, nmc_mode=mode).reshape(b, s, cfg.n_heads, hd),
                self.wk(x, nmc_mode=mode).reshape(b, s, cfg.n_kv_heads, hd),
                self.wv(x, nmc_mode=mode).reshape(b, s, cfg.n_kv_heads, hd))

    def qkv(self, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor) -> tuple:
        """x: (B, S, D) -> q (B,H,S,hd), k/v (B,KV,S,hd), rope applied."""
        q, k, v = self._project(x, cfg)
        if not cfg.learned_pos:
            cos, sin = L.rope_table(positions, cfg.head_dim, cfg.rope_theta)
            q = L.apply_rope(q, cos, sin)
            k = L.apply_rope(k, cos, sin)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def _out(self, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        b, _, s, _ = o.shape
        return self.wo(o.transpose(1, 2).reshape(b, s, -1),
                       nmc_mode=cfg.nmc_mode)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, *,
                causal: bool = True, q_offset: int = 0) -> torch.Tensor:
        """Train/prefill path (the reference's ``gqa_apply``)."""
        positions = torch.arange(x.shape[1], device=x.device) + q_offset
        q, k, v = self.qkv(x, cfg, positions)
        o = ops.attention(q, k, v, causal=causal, window=cfg.window,
                          q_offset=q_offset)
        return self._out(o, cfg)

    def prefill(self, x: torch.Tensor, cfg: ModelConfig,
                max_len: int) -> tuple:
        """Full attention over the prompt AND the cache, padded to
        ``max_len`` (the reference's ``gqa_prefill``)."""
        s = x.shape[1]
        q, k, v = self.qkv(x, cfg, torch.arange(s, device=x.device))
        out = self._out(ops.attention(q, k, v, causal=True,
                                      window=cfg.window), cfg)
        pad = (0, 0, 0, max_len - s)
        kp, vp = F.pad(k, pad), F.pad(v, pad)
        if cfg.kv_cache_dtype == "int8":
            kq, ks = quant_kv(kp)
            vq, vs = quant_kv(vp)
            return out, {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
        return out, {"k": kp.to(x.dtype), "v": vp.to(x.dtype)}

    def decode_step(self, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                    cache_len: torch.Tensor) -> tuple:
        """One-token decode (the reference's ``gqa_decode``).  cache:
        {"k","v"}: (B, KV, S_cache, hd), updated in place; cache_len (B,)
        absolute lengths including the new token.  Sliding-window archs
        with S_cache <= window use a RING cache: slot (len-1) mod S_cache
        holds the newest token (softmax is permutation-invariant, and RoPE
        is applied with absolute positions before the insert).
        Returns (out (B,1,D), cache)."""
        b = x.shape[0]
        q, k, v = self._project(x, cfg)
        if not cfg.learned_pos:
            cos, sin = L.rope_table(cache_len[:, None] - 1, cfg.head_dim,
                                    cfg.rope_theta)
            cos, sin = cos[:, :, None, :], sin[:, :, None, :]
            q = L.apply_rope(q, cos, sin)
            k = L.apply_rope(k, cos, sin)
        s_cache = cache["k"].shape[2]
        ring = cfg.window is not None and s_cache <= cfg.window
        rows = torch.arange(b, device=x.device)
        idx = ((cache_len - 1) % s_cache).long()
        k_new, v_new = k[:, 0], v[:, 0]                 # (B, KV, hd)
        if "k_s" in cache:                              # int8 cache
            for name, val in (("k", k_new), ("v", v_new)):
                vq, vs = quant_kv(val)
                cache[name][rows, :, idx] = vq
                cache[name + "_s"][rows, :, idx] = vs
            kc = dequant_kv(cache["k"], cache["k_s"], x.dtype)
            vc = dequant_kv(cache["v"], cache["v_s"], x.dtype)
        else:
            cache["k"][rows, :, idx] = k_new.to(cache["k"].dtype)
            cache["v"][rows, :, idx] = v_new.to(cache["v"].dtype)
            kc, vc = cache["k"], cache["v"]
        if ring:
            # every resident slot is within the window; mask warm-up slots
            o = ops.decode_attention(q.transpose(1, 2), kc, vc,
                                     torch.clamp_max(cache_len, s_cache))
        else:
            o = ops.decode_attention(q.transpose(1, 2), kc, vc, cache_len,
                                     window=cfg.window)
        return self._out(o, cfg), cache


def cache_init(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(sshape, dtype=torch.bfloat16,
                                   device=device),
                "v_s": torch.zeros(sshape, dtype=torch.bfloat16,
                                   device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def quant_kv(x: torch.Tensor) -> tuple:
    """(..., hd) -> int8 values + (..., 1) bf16 scale (symmetric per
    token and head)."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / s), -127, 127)
    return q.to(torch.int8), s.to(torch.bfloat16)


def dequant_kv(q: torch.Tensor, s: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * s.float()).to(dtype)
