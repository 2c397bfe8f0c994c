"""The dense decoder LM: ``[attn + MLP] x L`` behind three entry points.

The counterpart of the dense family of the JAX package's ``models/lm.py``:
``forward`` (teacher-forced logits), ``prefill`` (the prompt's last-position
logits and the KV caches) and ``decode_step`` (one token against the
caches, updated in place).  The layers run in a Python loop over a
``ModuleList``; the caches keep the reference's layout, one tensor per
field stacked over layers, ``(L, B, KV, S, hd)``.  The other families (MoE,
hybrid SSM, xLSTM, encoder-decoder, VLM) and MLA attention raise
``NotImplementedError`` until their slices land (ROADMAP.md, queue 1).

Every entry point runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, resolve_device


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense GQA family only so far "
            f"(family {cfg.family!r}, mla={cfg.mla}); see ROADMAP.md, "
            f"queue 1")


class DecoderBlock(nn.Module):
    def __init__(self, ln1: L.RMSNorm, attn: A.GQAttention, ln2: L.RMSNorm,
                 mlp: L.MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp

    @classmethod
    def init(cls, gen: torch.Generator, cfg: ModelConfig,
             device=None) -> "DecoderBlock":
        return cls(L.RMSNorm.init(cfg.d_model, cfg.norm_eps, device),
                   A.GQAttention.init(gen, cfg, device),
                   L.RMSNorm.init(cfg.d_model, cfg.norm_eps, device),
                   L.MLP.init(gen, cfg.d_model, cfg.d_ff, cfg.act, device))

    def _mlp(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        return x + self.mlp(self.ln2(x), cfg.act, nmc_mode=cfg.nmc_mode)

    def forward(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        return self._mlp(x + self.attn(self.ln1(x), cfg), cfg)

    def prefill(self, x: torch.Tensor, cfg: ModelConfig,
                max_len: int) -> tuple:
        y, cache = self.attn.prefill(self.ln1(x), cfg, max_len)
        return self._mlp(x + y, cfg), cache

    def decode_step(self, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                    cache_len: torch.Tensor) -> torch.Tensor:
        y, _ = self.attn.decode_step(self.ln1(x), cfg, cache, cache_len)
        return self._mlp(x + y, cfg)


class DecoderLM(nn.Module):
    def __init__(self, embed: L.Embedding, layers: list, final_norm: L.RMSNorm,
                 head: L.NmcLinear):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.head = head

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def logits(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """The LM head over every position (at prefill the dynamic
        activation scale of ``w8a8`` covers all of them, as in the
        reference, so the head is not cut to the last position first)."""
        return self.head(self.final_norm(x), nmc_mode=cfg.nmc_mode)

    def forward(self, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        x = self.embed(tokens, cfg.dtype)
        for blk in self.layers:
            x = blk(x, cfg)
        return self.logits(x, cfg)

    def prefill(self, tokens: torch.Tensor, cfg: ModelConfig,
                max_len: int) -> tuple:
        x = self.embed(tokens, cfg.dtype)
        caches = []
        for blk in self.layers:
            x, c = blk.prefill(x, cfg, max_len)
            caches.append(c)
        stacked = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
        return self.logits(x, cfg)[:, -1], {"layers": stacked}

    def decode_step(self, tokens: torch.Tensor, caches: dict,
                    cache_len: torch.Tensor, cfg: ModelConfig) -> tuple:
        x = self.embed(tokens, cfg.dtype)
        stack = caches["layers"]
        for i, blk in enumerate(self.layers):
            x = blk.decode_step(x, cfg, {k: t[i] for k, t in stack.items()},
                                cache_len)
        return self.logits(x, cfg)[:, 0], caches


# ---------------------------------------------------------------------------
# entry points (the reference's function names)
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> DecoderLM:
    """Random float32 weights with the reference's initialisation (normal
    / sqrt(d_in) linears, 0.02 embedding, unit norm gains, zero biases),
    drawn from ``generator`` (a fresh seed-0 generator on ``device`` when
    None).  ``device=None`` is the card and raises without one."""
    _dense_only(cfg)
    device = resolve_device(device)
    gen = generator if generator is not None \
        else torch.Generator(device=device).manual_seed(0)
    embed = L.Embedding.init(gen, cfg.vocab_size, cfg.d_model, device)
    head = L.NmcLinear.init(gen, cfg.d_model, cfg.vocab_size, device=device)
    layers = [DecoderBlock.init(gen, cfg, device)
              for _ in range(cfg.n_layers)]
    return DecoderLM(embed, layers,
                     L.RMSNorm.init(cfg.d_model, cfg.norm_eps, device), head)


@torch.inference_mode()
def forward(params: DecoderLM, batch: dict, cfg: ModelConfig) -> tuple:
    """Teacher-forced forward.  Returns (logits, aux_loss = 0)."""
    _dense_only(cfg)
    return params(batch["tokens"], cfg), torch.zeros((), device=params.device)


@torch.inference_mode()
def prefill(params: DecoderLM, batch: dict, cfg: ModelConfig,
            max_len: int) -> tuple:
    """Process the prompt, return (last-position logits, caches)."""
    _dense_only(cfg)
    return params.prefill(batch["tokens"], cfg, max_len)


@torch.inference_mode()
def decode_step(params: DecoderLM, tokens: torch.Tensor, caches: dict,
                cache_len: torch.Tensor, cfg: ModelConfig) -> tuple:
    """One decode step.  tokens: (B, 1) the new token ids; cache_len: (B,)
    lengths INCLUDING the new token.  Returns (logits (B, vocab), caches),
    the caches updated in place."""
    _dense_only(cfg)
    return params.decode_step(tokens, caches, cache_len, cfg)


@torch.inference_mode()
def init_caches(params: DecoderLM, cfg: ModelConfig, batch: int,
                max_len: int, dtype=torch.bfloat16) -> dict:
    _dense_only(cfg)
    one = A.cache_init(cfg, batch, max_len, dtype, params.device)
    return {"layers": {k: torch.zeros((cfg.n_layers,) + t.shape,
                                      dtype=t.dtype, device=t.device)
                       for k, t in one.items()}}


def cache_batch_axes(cfg: ModelConfig, caches: dict) -> dict:
    """The batch axis of every cache leaf: the same tree with an int per
    leaf.  Dense caches are stacked with one leading layer axis, so batch
    sits at 1 (shape sniffing cannot tell a size-1 layer axis from a
    size-1 batch axis)."""
    _dense_only(cfg)
    return {"layers": {k: 1 for k in caches["layers"]}}
