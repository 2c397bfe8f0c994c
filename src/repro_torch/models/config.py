"""Unified model configuration covering all assigned architecture families.

The counterpart of the JAX package's ``models/config.py`` with torch dtypes.
The distribution and training knobs (``remat``, ``remat_policy``,
``scan_layers``, ``seq_parallel``) wait for the training slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  Without a card, ``None`` raises; the CPU is asked for
    with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's models and serving run on the "
                "card by default; pass device='cpu' to run them on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | xlstm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention
    qkv_bias: bool = False
    rope_theta: float = 1e4
    window: int | None = None      # sliding-window attention
    learned_pos: bool = False      # learned absolute positions (whisper)

    # MLA (DeepSeek)
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0
    dense_d_ff: int = 0            # d_ff of the first dense layers

    # SSM (Mamba2 / hybrid)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0            # hybrid: shared attention block period

    # xLSTM
    slstm_layers: tuple = ()       # layer indices running sLSTM (others mLSTM)
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0

    # encoder-decoder (whisper)
    encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500

    # VLM (pixtral)
    vlm: bool = False
    n_img_tokens: int = 1024

    act: str = "silu"
    norm_eps: float = 1e-5

    # the paper's technique as a framework feature: quantized near-memory
    # execution of projections (none | w8 | w8a8)
    nmc_mode: str = "none"
    # int8 KV cache with per-token-per-head scales (bf16 | int8)
    kv_cache_dtype: str = "bf16"

    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:      # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def sub_quadratic(self) -> bool:
        return (self.family in ("hybrid", "xlstm")
                or self.window is not None)

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (the reference's formula)."""
        d, v = self.d_model, self.vocab_size
        n = v * d * 2                               # embed + head
        hd = self.head_dim
        if self.family == "xlstm":
            for i in range(self.n_layers):
                if i in self.slstm_layers:
                    di = int(self.d_model * self.proj_factor_slstm)
                    n += 4 * d * d + 2 * d * di     # r/z/i/f gates + up/down
                else:
                    di = int(self.d_model * self.proj_factor_mlstm)
                    n += 2 * d * di + 3 * di * di + di * d  # up/gate + qkv + down
            return n
        if self.family == "hybrid":
            di = self.d_inner
            per_mamba = d * (2 * di) + di * d + di * (2 * self.ssm_state) \
                + di  # in/out proj + BC proj + dt
            n += self.n_layers * per_mamba
            n += (d * (self.n_heads + 2 * self.n_kv_heads) * hd
                  + self.n_heads * hd * d + 3 * d * self.d_ff)
            return n
        if self.mla:
            per_attn = (d * self.kv_lora_rank + d * self.qk_rope_dim
                        + self.kv_lora_rank * self.n_heads
                        * (self.qk_nope_dim + self.v_head_dim)
                        + d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                        + self.n_heads * self.v_head_dim * d)
        else:
            per_attn = (d * (self.n_heads + 2 * self.n_kv_heads) * hd
                        + self.n_heads * hd * d)
        n_dec = self.n_layers
        if self.moe:
            per_ffn_moe = 3 * d * self.moe_d_ff * (self.n_experts
                                                   + self.n_shared_experts) \
                + d * self.n_experts
            n_moe = self.n_layers - self.first_dense_layers
            n += n_moe * (per_attn + per_ffn_moe)
            n += self.first_dense_layers * (per_attn + 3 * d *
                                            (self.dense_d_ff or self.d_ff))
            return n
        per_ffn = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
        n += n_dec * (per_attn + per_ffn)
        if self.encdec:
            n += self.n_enc_layers * (per_attn + per_ffn)
            n += self.n_layers * per_attn          # cross-attention
        return n
