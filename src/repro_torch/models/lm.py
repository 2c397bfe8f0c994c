"""The decoder LMs: ``[attn + MLP] x L`` (dense, VLM) and ``first_dense x k
+ [attn + MoE] x (L - k)`` (MoE) behind three entry points.

The counterpart of the dense, MoE and VLM families of the JAX package's
``models/lm.py``: ``forward`` (teacher-forced logits and the summed MoE
aux loss), ``prefill`` (the prompt's last-position logits and the KV
caches) and ``decode_step`` (one token against the caches, updated in
place).  The attention is GQA, or MLA where ``cfg.mla``.  A VLM's batch
carries ``"images"``, precomputed patch embeddings that ``img_proj``
projects and places before the text embeddings.  The layers run in a
Python loop over ``ModuleList``s; the caches keep the reference's layout,
one tensor per field stacked over layers (GQA ``(L, B, KV, S, hd)``, MLA
``(L, B, S, r)``), under ``"layers"`` and, for a MoE model's first dense
layers, ``"dense_layers"``.  The other families (hybrid SSM, xLSTM,
encoder-decoder) raise ``NotImplementedError`` until their slices land
(ROADMAP.md, queue 1).

Every entry point runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig, resolve_device


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense, MoE and VLM families only "
            f"so far (family {cfg.family!r}); see ROADMAP.md, queue 1")


class DecoderBlock(nn.Module):
    """ln1 -> attention -> ln2 -> FFN, a residual around each; the FFN is
    the dense ``mlp`` or the ``moe``, exactly one of them."""

    def __init__(self, ln1: L.RMSNorm, attn: A.GQAttention | A.MLAttention,
                 ln2: L.RMSNorm, mlp: L.MLP | None = None,
                 moe: MOE.MoE | None = None):
        super().__init__()
        if (mlp is None) == (moe is None):
            raise ValueError("a DecoderBlock holds an mlp or a moe")
        self.ln1, self.attn, self.ln2 = ln1, attn, ln2
        self.mlp, self.moe = mlp, moe

    @classmethod
    def init(cls, gen: torch.Generator, cfg: ModelConfig, device=None,
             use_moe: bool = False, d_ff: int | None = None) -> "DecoderBlock":
        ln1 = L.RMSNorm.init(cfg.d_model, cfg.norm_eps, device)
        attn = (A.MLAttention if cfg.mla else A.GQAttention).init(
            gen, cfg, device)
        ln2 = L.RMSNorm.init(cfg.d_model, cfg.norm_eps, device)
        if use_moe:
            return cls(ln1, attn, ln2, moe=MOE.MoE.init(gen, cfg, device))
        return cls(ln1, attn, ln2, mlp=L.MLP.init(
            gen, cfg.d_model, d_ff or cfg.d_ff, cfg.act, device))

    def _ffn(self, x: torch.Tensor, cfg: ModelConfig) -> tuple:
        """(x + FFN(ln2(x)), the MoE aux loss or None)."""
        h = self.ln2(x)
        if self.moe is not None:
            y, aux = self.moe(h, cfg)
            return x + y, aux
        return x + self.mlp(h, cfg.act, nmc_mode=cfg.nmc_mode), None

    def forward(self, x: torch.Tensor, cfg: ModelConfig) -> tuple:
        return self._ffn(x + self.attn(self.ln1(x), cfg), cfg)

    def prefill(self, x: torch.Tensor, cfg: ModelConfig,
                max_len: int) -> tuple:
        y, cache = self.attn.prefill(self.ln1(x), cfg, max_len)
        return self._ffn(x + y, cfg)[0], cache

    def decode_step(self, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                    cache_len: torch.Tensor) -> torch.Tensor:
        y, _ = self.attn.decode_step(self.ln1(x), cfg, cache, cache_len)
        return self._ffn(x + y, cfg)[0]


class DecoderLM(nn.Module):
    def __init__(self, embed: L.Embedding, layers: list, final_norm: L.RMSNorm,
                 head: L.NmcLinear, dense_layers: list = (),
                 img_proj: L.NmcLinear | None = None):
        super().__init__()
        self.embed = embed
        self.dense_layers = nn.ModuleList(dense_layers)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.head = head
        self.img_proj = img_proj

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def stacks(self) -> list:
        """``(cache key, blocks)`` in the order the blocks run: a MoE
        model's first dense layers (``"dense_layers"``), then ``"layers"``."""
        first = [("dense_layers", self.dense_layers)] \
            if len(self.dense_layers) else []
        return first + [("layers", self.layers)]

    def vlm_embed(self, images: torch.Tensor, tokens: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
        """The projected image embeddings (B, S_img, D) before the text
        embeddings: (B, S_img + S_txt, D)."""
        img = self.img_proj(images.to(cfg.dtype), nmc_mode=cfg.nmc_mode)
        return torch.cat([img, self.embed(tokens, cfg.dtype)], dim=1)

    def inputs(self, batch: dict, cfg: ModelConfig) -> torch.Tensor:
        """The embedded batch: its ``"tokens"``, after its ``"images"`` for
        a VLM (a VLM batch without them raises ``KeyError``, as the
        reference)."""
        if cfg.family == "vlm":
            return self.vlm_embed(batch["images"], batch["tokens"], cfg)
        return self.embed(batch["tokens"], cfg.dtype)

    def logits(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """The LM head over every position (at prefill the dynamic
        activation scale of ``w8a8`` covers all of them, as in the
        reference, so the head is not cut to the last position first)."""
        return self.head(self.final_norm(x), nmc_mode=cfg.nmc_mode)

    def hidden(self, x: torch.Tensor, cfg: ModelConfig) -> tuple:
        """Every block over the embedded ``x``: (x, the MoE layers' summed
        aux loss, 0 without any)."""
        auxs = []
        for _, blocks in self.stacks():
            for blk in blocks:
                x, aux = blk(x, cfg)
                if aux is not None:
                    auxs.append(aux)
        aux = torch.stack(auxs).sum() if auxs \
            else torch.zeros((), device=x.device)
        return x, aux

    def forward(self, batch: dict, cfg: ModelConfig) -> tuple:
        x, aux = self.hidden(self.inputs(batch, cfg), cfg)
        return self.logits(x, cfg), aux

    def prefill(self, batch: dict, cfg: ModelConfig, max_len: int) -> tuple:
        x = self.inputs(batch, cfg)
        caches = {}
        for key, blocks in self.stacks():
            cs = []
            for blk in blocks:
                x, c = blk.prefill(x, cfg, max_len)
                cs.append(c)
            caches[key] = {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
        return self.logits(x, cfg)[:, -1], caches

    def decode_step(self, tokens: torch.Tensor, caches: dict,
                    cache_len: torch.Tensor, cfg: ModelConfig) -> tuple:
        x = self.embed(tokens, cfg.dtype)
        for key, blocks in self.stacks():
            stack = caches[key]
            for i, blk in enumerate(blocks):
                x = blk.decode_step(x, cfg,
                                    {k: t[i] for k, t in stack.items()},
                                    cache_len)
        return self.logits(x, cfg)[:, 0], caches


# ---------------------------------------------------------------------------
# entry points (the reference's function names)
# ---------------------------------------------------------------------------

@torch.no_grad()
def draw_blocks(cfg: ModelConfig, generator: torch.Generator | None,
                device, each) -> DecoderLM:
    """:func:`init_params`, with ``each`` applied to the head, to every
    block and to a VLM's ``img_proj`` as soon as it is drawn (the float
    block is then dropped), in the generator's order: embedding, head, the
    first dense layers, the layers, ``img_proj`` (the reference's order of
    keys)."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = generator if generator is not None \
        else torch.Generator(device=device).manual_seed(0)
    embed = L.Embedding.init(gen, cfg.vocab_size, cfg.d_model, device)
    head = each(L.NmcLinear.init(gen, cfg.d_model, cfg.vocab_size,
                                 device=device))
    moe = cfg.family == "moe"
    n_dense = cfg.first_dense_layers if moe else 0
    dense = [each(DecoderBlock.init(gen, cfg, device,
                                    d_ff=cfg.dense_d_ff or cfg.d_ff))
             for _ in range(n_dense)]
    layers = [each(DecoderBlock.init(gen, cfg, device, use_moe=moe))
              for _ in range(cfg.n_layers - n_dense)]
    img_proj = each(L.NmcLinear.init(gen, cfg.d_model, cfg.d_model,
                                     device=device)) \
        if cfg.family == "vlm" else None
    return DecoderLM(embed, layers,
                     L.RMSNorm.init(cfg.d_model, cfg.norm_eps, device), head,
                     dense, img_proj)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> DecoderLM:
    """Random float32 weights with the reference's initialisation (normal
    / sqrt(d_in) linears and expert banks, 0.02 embedding, unit norm
    gains, zero biases), drawn from ``generator`` (a fresh seed-0
    generator on ``device`` when None).  ``device=None`` is the card and
    raises without one."""
    return draw_blocks(cfg, generator, device, lambda m: m)


@torch.inference_mode()
def forward(params: DecoderLM, batch: dict, cfg: ModelConfig) -> tuple:
    """Teacher-forced forward over ``batch["tokens"]`` (after
    ``batch["images"]`` for a VLM: the logits cover the image positions
    too).  Returns (logits, aux_loss): the MoE layers' summed
    load-balancing loss, 0 for the dense and VLM families."""
    _check_family(cfg)
    return params(batch, cfg)


@torch.inference_mode()
def prefill(params: DecoderLM, batch: dict, cfg: ModelConfig,
            max_len: int) -> tuple:
    """Process the prompt (a VLM's images first), return (last-position
    logits, caches)."""
    _check_family(cfg)
    return params.prefill(batch, cfg, max_len)


@torch.inference_mode()
def decode_step(params: DecoderLM, tokens: torch.Tensor, caches: dict,
                cache_len: torch.Tensor, cfg: ModelConfig) -> tuple:
    """One decode step.  tokens: (B, 1) the new token ids; cache_len: (B,)
    lengths INCLUDING the new token.  Returns (logits (B, vocab), caches),
    the caches updated in place."""
    _check_family(cfg)
    return params.decode_step(tokens, caches, cache_len, cfg)


@torch.inference_mode()
def init_caches(params: DecoderLM, cfg: ModelConfig, batch: int,
                max_len: int, dtype=torch.bfloat16) -> dict:
    _check_family(cfg)
    one = A.cache_init(cfg, batch, max_len, dtype, params.device)
    return {key: {k: torch.zeros((len(blocks),) + t.shape, dtype=t.dtype,
                                 device=t.device)
                  for k, t in one.items()}
            for key, blocks in params.stacks()}


def cache_batch_axes(cfg: ModelConfig, caches: dict) -> dict:
    """The batch axis of every cache leaf: the same tree with an int per
    leaf.  Every entry (``"layers"``, ``"dense_layers"``) is stacked with
    one leading layer axis, so batch sits at 1 for GQA's and MLA's leaves
    alike (shape sniffing cannot tell a size-1 layer axis from a size-1
    batch axis)."""
    _check_family(cfg)
    return {key: {k: 1 for k in entry} for key, entry in caches.items()}
