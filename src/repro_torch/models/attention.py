"""Attention layers: GQA (RoPE, optional bias / sliding window) and MLA.

The counterpart of the JAX package's ``models/attention.py``:
  * train/prefill: blocked flash attention (the CUDA kernel on the card, the
    chunked online softmax on the CPU) — never materializes S x S;
  * decode: one-token attention against a KV cache updated in place (the
    reference's one-hot blend, written as a slot write: equal for finite
    values), optionally int8 with per-token-per-head scales;
  * MLA (DeepSeek's multi-head latent attention) keeps the *compressed*
    cache, ``kv_lora_rank + qk_rope_dim`` values per token, runs prefill in
    the expanded form (flash attention at D = nope + rope, Dv = v) and
    decode in the absorbed form (float32 einsums in the latent space).

On a mesh with a ``model`` axis (:func:`~repro_torch.models.lm.shard`),
GQA runs the rank's heads: ``wq`` / ``wk`` / ``wv`` column-parallel,
``wo`` row-parallel, ``n_heads / model`` query and ``n_kv_heads / model``
KV heads through the same ``flash_attention`` (heads are independent).
Where ``model`` does not divide ``n_kv_heads``, ``wk`` and ``wv`` stay
whole: each rank computes every KV head and takes those its query heads
read (``kv_select``).

Where ``model`` does not divide the heads (whisper-tiny's 6 on model 4,
phi3-medium-14b's 40 on model 16), the rule still splits ``wq`` / ``wk``
/ ``wv`` by columns and ``wo`` by rows, through a head (and the KV heads
do not divide either, so ``wk`` / ``wv`` stay whole, but for a
cross-attention's, which the rule splits).  Such a layer runs every head
on every rank (``every_head``): the column slices of q (and of k / v
where they are split) are gathered over ``model`` into whole heads
(``context.gather_to_heads``, whose backward is a reduce-scatter), the
attention runs on every head, and each rank keeps the columns of its
output that its rows of ``wo`` meet (:meth:`GQAttention._out`); the
row-parallel sum closes the layer as before.  The attention's flops are
then replicated on the ``model`` ranks.

MLA on such a mesh runs the rank's heads too: ``wq``, ``w_uk`` and
``w_uv`` column-parallel (their columns are head-major), ``wo``
row-parallel, ``n_heads / model`` heads through ``flash_attention``.
``w_dkv``, ``w_krope`` and ``norm_ckv`` stay whole: every rank computes
the whole latent ``ckv`` and the shared RoPE key, and each differentiates
them through its own heads only, so their gradients are partial and
summed over ``model`` by the train step.  Where ``model`` does not divide
the heads (deepseek-v2-lite's 16 on model 3), the rule splits each of
``wq`` (``h * (dn + dr)`` columns, each head's nope part then its rope
part), ``w_uk``, ``w_uv`` by columns and ``wo`` by rows wherever ``model``
divides that width, through a head, and keeps the others whole.  Such a
layer runs every head on every rank (``every_head``), as GQA does: a
split projection's columns gathered into whole heads
(``context.gather_to_heads``), and its output through the columns of the
rank's rows of a split ``wo``; a whole ``wo`` gives every rank the whole
output, of which model rank 0 alone carries the gradient
(``context.leave_whole``), so that every whole tensor of the layer gets
a partial gradient.  The absorbed decode reads ``W_uk`` / ``W_uv`` by
whole heads: their column slices are gathered.

Serving on such a mesh (``lm.prefill`` / ``lm.decode_step``) keeps each
layer's cache laid out by ``sharding.cache_shardings``: every KV head (or
MLA's whole latent) for this rank's slots, the sequence split over
``model`` (over the data axes and ``model`` together for a batch of one).
Prefill runs on local heads through ``flash_attention`` and hands its K /
V over to that layout (:func:`~repro_torch.distributed.sharding.relayout`:
gathered over the heads, narrowed to the slots; only the narrow where
``wk`` / ``wv`` or MLA's latent are whole).  Decode gathers every head's
query (and the new token's k / v) over ``model``, writes the new token on
the rank that holds its slot, attends over the rank's slots
(``ops.decode_attention_partial``: the attention and the logsumexp of
its logits) and combines the ranks' partials (``ops.combine_partials``:
weighted by their logsumexps, a max and a sum over the split axes); each
rank keeps the columns its rows of the row-parallel ``wo`` meet, its
heads where they divide (MLA: its heads' ``W_uv`` first).  An
encoder-decoder's cross K/V follow the same rule over the encoder frames
(over each head's features where ``model`` does not divide the frames:
whisper-tiny's 1500 on 16): its prefill hands the K / V of its local heads
over to every head of its frames (:meth:`GQAttention.to_cache`, the
slots' code), and its decode (:meth:`GQAttention.cross_decode`) attends
every head's query over the rank's frames through the flash kernel with
its log-sum-exp (``ops.attention_partial``) and combines the partials
as above.

Under sequence parallelism (``sp=True``, :mod:`~repro_torch.models.layers`)
both enter their region by gathering the whole sequence and leave it by
a reduce-scatter onto this rank's rows: the attention itself still sees
every position, so each launch keeps its shape.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import context as C
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


class GQAttention(nn.Module):
    """Grouped-query attention; on a mesh, ``mesh`` is set and, where
    ``wk`` / ``wv`` are not sharded, ``kv_select`` holds the KV head each
    local query head reads."""

    mesh: C.Mesh | None = None
    kv_select: list | None = None
    #: on a mesh whose ``model`` axis does not divide the heads: every
    #: rank runs every head (module docstring)
    every_head: bool = False

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

    def heads(self, y: torch.Tensor, lin: L.NmcLinear,
              cfg: ModelConfig) -> torch.Tensor:
        """A projection's output y (B, S, cols) by ``lin`` as (B, S, heads,
        hd): under ``every_head`` a column-parallel one's slice gathered
        over ``model`` into every head first."""
        y = C.gather_to_heads_if(y, self.mesh,
                                 self.every_head and lin.parallel == "col")
        return y.reshape(y.shape[0], y.shape[1], -1, cfg.head_dim)

    def _project(self, x: torch.Tensor, cfg: ModelConfig,
                 select: bool = True) -> tuple:
        """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd), before RoPE
        (this rank's heads on a mesh, every head under ``every_head``;
        with ``select`` False, every KV head where ``wk`` / ``wv`` are
        whole)."""
        mode = cfg.nmc_mode
        q, k, v = (self.heads(lin(x, nmc_mode=mode), lin, cfg)
                   for lin in (self.wq, self.wk, self.wv))
        if select and self.kv_select is not None:
            k, v = k[:, :, self.kv_select], v[:, :, self.kv_select]
        return q, k, v

    def qkv(self, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor, select: bool = True) -> tuple:
        """x: (B, S, D) -> q (B,H,S,hd), k/v (B,KV,S,hd), rope applied."""
        q, k, v = self._project(x, cfg, select)
        if not cfg.learned_pos:
            cos, sin = L.rope_table(positions, cfg.head_dim, cfg.rope_theta)
            q = L.apply_rope(q, cos, sin)
            k = L.apply_rope(k, cos, sin)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def _out(self, o: torch.Tensor, cfg: ModelConfig, sp: bool = False,
             every: bool = False) -> torch.Tensor:
        """The output projection of o (B, H, S, hd).  Where o holds every
        head (``every``, or under ``every_head``) and ``wo`` is
        row-parallel, the columns its rows meet
        (:func:`_local_columns`)."""
        b, _, s, _ = o.shape
        o = o.transpose(1, 2).reshape(b, s, -1)
        if (every or self.every_head) and self.wo.parallel == "row":
            o = _local_columns(o, self.wo)
        return self.wo(o, nmc_mode=cfg.nmc_mode, sp=sp)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, *,
                causal: bool = True, q_offset: int = 0,
                kv: tuple | None = None, sp: bool = False) -> torch.Tensor:
        """Train/prefill path (the reference's ``gqa_apply``).  ``kv``,
        ``(k, v)`` of shape (B, KV, Skv, hd), overrides K/V
        (cross-attention): then only q is projected.  The reference
        projects k and v from ``x`` there too and never reads them.
        ``sp``: x is this rank's rows of a sequence-split stream (the
        region gathers the whole sequence; the output is this rank's rows
        again)."""
        if self.mesh is not None:
            x = C.enter_region(x, self.mesh, sp)
        if kv is not None:
            o = ops.attention(self._cross_q(x, cfg, q_offset), *kv,
                              causal=causal, window=cfg.window,
                              q_offset=q_offset)
            return self._out(o, cfg, sp)
        positions = torch.arange(x.shape[1], device=x.device) + q_offset
        q, k, v = self.qkv(x, cfg, positions)
        o = ops.attention(q, k, v, causal=causal, window=cfg.window,
                          q_offset=q_offset)
        return self._out(o, cfg, sp)

    def _cross_q(self, x: torch.Tensor, cfg: ModelConfig,
                 q_offset: int = 0) -> torch.Tensor:
        """A cross-attention's q (B, H, S, hd) from x (B, S, D), rope
        applied at positions ``q_offset`` on (this rank's heads on a
        mesh, every head under ``every_head``)."""
        s = x.shape[1]
        q = self.heads(self.wq(x, nmc_mode=cfg.nmc_mode), self.wq, cfg)
        if not cfg.learned_pos:
            positions = torch.arange(s, device=x.device) + q_offset
            cos, sin = L.rope_table(positions, cfg.head_dim, cfg.rope_theta)
            q = L.apply_rope(q, cos, sin)
        return q.transpose(1, 2)

    def to_cache(self, t: torch.Tensor, sh: sharding.Sharding
                 ) -> torch.Tensor:
        """t (B, KV, S, hd), this rank's KV heads of every position (every
        KV head where ``wk`` / ``wv`` are whole or under ``every_head``),
        as its slice under the cache's ``sh`` (:func:`cache_split`):
        gathered over the heads, narrowed to the rank's positions."""
        heads = C.MODEL_AXIS if self.wk.parallel == "col" and \
            not self.every_head else None
        src = sharding.Sharding(sh.mesh, (sh.spec[0], heads, None, None))
        return sharding.relayout(t, src, sh.spec)

    def cross_decode(self, x: torch.Tensor, cfg: ModelConfig, kv: tuple,
                     sh: sharding.Sharding | None = None) -> torch.Tensor:
        """One token's cross-attention over an encoder output's K / V (B,
        KV, S_enc, hd).  ``sh``: on a ``model`` axis their layout
        (:func:`cache_split`: every KV head, this rank's frames; where the
        layout splits the head dim instead, K / V are gathered on it
        first): every head's q gathered over ``model``, the attention over
        the rank's frames (``ops.attention_partial``: the flash kernel,
        with its log-sum-exp where the frames are split), the ranks' partials
        combined over the axes that split them, the columns of the rank's
        rows of the row-parallel ``wo`` on to it; one rank's attention over
        all the frames otherwise (the same launch, no log-sum-exp).  The
        query sits at position 0, so a window hides no frame, as in
        :meth:`forward`.  Returns (B, 1, D)."""
        q = self._cross_q(x, cfg)
        axes = () if sh is None else sharding.split_axes(sh, 2)
        if sh is not None and sharding.split_axes(sh, 3):
            kv = tuple(C.all_gather(t, sharding.split_axes(sh, 3), sh.mesh, 3)
                       for t in kv)
        if sh is not None and self.mesh is not None and not self.every_head:
            q = C.all_gather(q, C.MODEL_AXIS, self.mesh, 1)
        o, lse = ops.attention_partial(q, *kv, causal=False, lse=bool(axes))
        o = _combine(o, lse, axes, None if sh is None else sh.mesh)
        return self._out(o.to(x.dtype), cfg, every=sh is not None)

    def prefill(self, x: torch.Tensor, cfg: ModelConfig, max_len: int,
                cache_sh: dict | None = None) -> tuple:
        """Full attention over the prompt AND the cache, padded to
        ``max_len`` (the reference's ``gqa_prefill``).  ``cache_sh``: on a
        mesh with a ``model`` axis, one layer's cache Shardings ({field:
        Sharding of (B, KV, S, hd)}); the attention runs on this rank's
        heads and the cache returned is its slice: every KV head, the
        slots of its sequence split (:func:`cache_split`)."""
        s = x.shape[1]
        q, k, v = self.qkv(x, cfg, torch.arange(s, device=x.device),
                           select=False)
        ks, vs = k, v
        if self.kv_select is not None:
            ks, vs = k[:, self.kv_select], v[:, self.kv_select]
        out = self._out(ops.attention(q, ks, vs, causal=True,
                                      window=cfg.window), cfg)
        pad = (0, 0, 0, max_len - s)
        kp, vp = F.pad(k, pad), F.pad(v, pad)
        if cache_sh is not None:
            sh = cache_split(cache_sh)
            kp, vp = self.to_cache(kp, sh), self.to_cache(vp, sh)
        if cfg.kv_cache_dtype == "int8":
            kq, ks = quant_kv(kp)
            vq, vs = quant_kv(vp)
            return out, {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
        return out, {"k": kp.to(x.dtype), "v": vp.to(x.dtype)}

    def decode_step(self, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                    cache_len: torch.Tensor,
                    cache_sh: dict | None = None) -> tuple:
        """One-token decode (the reference's ``gqa_decode``).  cache:
        {"k","v"}: (B, KV, S_cache, hd), updated in place; cache_len (B,)
        absolute lengths including the new token.  Sliding-window archs
        with S_cache <= window use a RING cache: slot (len-1) mod S_cache
        holds the newest token (softmax is permutation-invariant, and RoPE
        is applied with absolute positions before the insert).
        ``cache_sh``: the cache is this rank's slots of every KV head
        (:meth:`prefill`): the new token's k / v (every KV head) and q
        (every head) are gathered over ``model``, the rank holding a row's
        slot writes it, every rank attends over its slots and the ranks'
        partials are combined over the axes that split them; the columns
        of the result that the rank's rows of the row-parallel ``wo`` meet
        go on to it (its heads' where the heads divide).
        Returns (out (B,1,D), cache)."""
        b = x.shape[0]
        q, k, v = self._project(x, cfg, select=cache_sh is None)
        if not cfg.learned_pos:
            cos, sin = L.rope_table(cache_len[:, None] - 1, cfg.head_dim,
                                    cfg.rope_theta)
            cos, sin = cos[:, :, None, :], sin[:, :, None, :]
            q = L.apply_rope(q, cos, sin)
            k = L.apply_rope(k, cos, sin)
        s_loc = cache["k"].shape[2]
        split = cache_split(cache_sh) if cache_sh is not None else None
        axes = () if split is None else sharding.split_axes(split, 2)
        s_cache = s_loc * (split.mesh.size(axes) if axes else 1)
        offset = 0 if split is None else sharding.local_offset(split, 2,
                                                               s_loc)
        if split is not None and self.mesh is not None and \
                not self.every_head:
            q = C.all_gather(q, C.MODEL_AXIS, self.mesh, 2)
            if self.wk.parallel == "col":
                k = C.all_gather(k, C.MODEL_AXIS, self.mesh, 2)
                v = C.all_gather(v, C.MODEL_AXIS, self.mesh, 2)
        ring = cfg.window is not None and s_cache <= cfg.window
        rows = torch.arange(b, device=x.device)
        slot = ((cache_len - 1) % s_cache).long() - offset
        own = None if split is None else (slot >= 0) & (slot < s_loc)
        k_new, v_new = k[:, 0], v[:, 0]                 # (B, KV, hd)
        if "k_s" in cache:                              # int8 cache
            for name, val in (("k", k_new), ("v", v_new)):
                vq, vs = quant_kv(val)
                _write_slots(cache[name], rows, slot, own, vq)
                _write_slots(cache[name + "_s"], rows, slot, own, vs)
            kc = dequant_kv(cache["k"], cache["k_s"], x.dtype)
            vc = dequant_kv(cache["v"], cache["v_s"], x.dtype)
        else:
            _write_slots(cache["k"], rows, slot, own, k_new)
            _write_slots(cache["v"], rows, slot, own, v_new)
            kc, vc = cache["k"], cache["v"]
        # a ring: every resident slot is within the window; mask warm-up
        # slots
        lens, window = (torch.clamp_max(cache_len, s_cache), None) if ring \
            else (cache_len, cfg.window)
        o = _combine(*ops.decode_attention_partial(
            q.transpose(1, 2), kc, vc, lens, offset, window=window,
            lse=bool(axes)), axes, None if split is None else split.mesh)
        return self._out(o.to(x.dtype)[:, :, None], cfg,
                         every=split is not None), cache


class MLAttention(nn.Module):
    """DeepSeek-V2's multi-head latent attention (the reference's
    ``mla_*``): q from ``wq``; K and V decompressed by ``w_uk`` / ``w_uv``
    from the normalised latent ``ckv = norm_ckv(w_dkv(x))``; one RoPE key
    ``w_krope(x)`` shared by every head.  On a mesh ``mesh`` is set and the
    column-parallel projections hold this rank's heads (module
    docstring): the head count is read from their widths."""

    mesh: C.Mesh | None = None
    #: on a mesh whose ``model`` axis does not divide the heads: every
    #: rank runs every head (module docstring)
    every_head: bool = False

    def __init__(self, wq: L.NmcLinear, w_dkv: L.NmcLinear,
                 w_krope: L.NmcLinear, w_uk: L.NmcLinear, w_uv: L.NmcLinear,
                 wo: L.NmcLinear, norm_ckv: L.RMSNorm):
        super().__init__()
        self.wq, self.w_dkv, self.w_krope = wq, w_dkv, w_krope
        self.w_uk, self.w_uv, self.wo = w_uk, w_uv, wo
        self.norm_ckv = norm_ckv

    @classmethod
    def init(cls, gen: torch.Generator, cfg: ModelConfig,
             device=None) -> "MLAttention":
        d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return cls(L.NmcLinear.init(gen, d, h * (dn + dr), device=device),
                   L.NmcLinear.init(gen, d, r, device=device),
                   L.NmcLinear.init(gen, d, dr, device=device),
                   L.NmcLinear.init(gen, r, h * dn, device=device),
                   L.NmcLinear.init(gen, r, h * dv, device=device),
                   L.NmcLinear.init(gen, h * dv, d, device=device),
                   L.RMSNorm.init(r, device=device))

    def _heads(self, y: torch.Tensor, lin: L.NmcLinear) -> torch.Tensor:
        """A projection's output by ``lin``: under ``every_head`` a
        column-parallel one's slice gathered over ``model`` into every
        head."""
        return C.gather_to_heads_if(y, self.mesh, self.every_head
                                    and lin.parallel == "col")

    def _weight(self, lin: L.NmcLinear) -> torch.Tensor:
        """``lin``'s float32 weight (d_in, columns): under ``every_head``
        a column-parallel one's slice gathered into every head."""
        w = lin.float_weight()
        if self.every_head and lin.parallel == "col":
            w = C.all_gather(w, C.MODEL_AXIS, self.mesh, 1)
        return w

    def _out(self, o: torch.Tensor, cfg: ModelConfig,
             sp: bool = False) -> torch.Tensor:
        """The output projection of o (B, S, heads * dv): under
        ``every_head`` (o holds every head) the columns of a row-parallel
        ``wo``'s rows, or a whole ``wo``'s output left whole
        (``context.leave_whole``)."""
        mode = cfg.nmc_mode
        if self.every_head and self.wo.parallel == "row":
            o = _local_columns(o, self.wo)
        elif self.every_head:
            return C.leave_whole(self.wo(o, nmc_mode=mode), self.mesh, sp)
        return self.wo(o, nmc_mode=mode, sp=sp)

    def _q_and_latent(self, x: torch.Tensor, cfg: ModelConfig, cos,
                      sin) -> tuple:
        """x: (B, S, D) -> q_nope (B,S,H,dn), q_rope (B,S,H,dr), ckv
        (B,S,r) and the shared key krope (B,S,1,dr), rope applied (H this
        rank's heads on a mesh, every head under ``every_head``)."""
        b, s, _ = x.shape
        dn, dr, mode = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.nmc_mode
        q = self._heads(self.wq(x, nmc_mode=mode), self.wq).reshape(
            b, s, -1, dn + dr)
        ckv = self.norm_ckv(self.w_dkv(x, nmc_mode=mode))
        krope = L.apply_rope(self.w_krope(x, nmc_mode=mode)[:, :, None, :],
                             cos, sin)
        return q[..., :dn], L.apply_rope(q[..., dn:], cos, sin), ckv, krope

    def _expanded(self, x: torch.Tensor, cfg: ModelConfig,
                  q_offset: int, sp: bool = False) -> tuple:
        """The expanded (flash-compatible) form: (out (B,S,D), ckv, krope
        (B,S,dr)); with ``sp`` x and out are this rank's rows of a
        sequence-split stream (ckv and krope cover the whole sequence)."""
        if self.mesh is not None:
            x = C.enter_region(x, self.mesh, sp)
        b, s, _ = x.shape
        dr, mode = cfg.qk_rope_dim, cfg.nmc_mode
        positions = torch.arange(s, device=x.device) + q_offset
        cos, sin = L.rope_table(positions, dr, cfg.rope_theta)
        q_nope, q_rope, ckv, krope = self._q_and_latent(x, cfg, cos, sin)
        h = q_nope.shape[2]
        k_nope = self._heads(self.w_uk(ckv, nmc_mode=mode), self.w_uk) \
            .reshape(b, s, h, cfg.qk_nope_dim)
        v = self._heads(self.w_uv(ckv, nmc_mode=mode), self.w_uv) \
            .reshape(b, s, h, cfg.v_head_dim)
        q = torch.cat([q_nope, q_rope], -1).transpose(1, 2)
        k = torch.cat([k_nope, krope.expand(b, s, h, dr)], -1).transpose(1, 2)
        o = ops.attention(q, k, v.transpose(1, 2), causal=True,
                          q_offset=q_offset)
        out = self._out(o.transpose(1, 2).reshape(b, s, -1), cfg, sp)
        return out, ckv, krope[:, :, 0]

    def forward(self, x: torch.Tensor, cfg: ModelConfig, *,
                q_offset: int = 0, sp: bool = False) -> torch.Tensor:
        """Train/prefill path (the reference's ``mla_apply``; causal)."""
        return self._expanded(x, cfg, q_offset, sp)[0]

    def prefill(self, x: torch.Tensor, cfg: ModelConfig, max_len: int,
                cache_sh: dict | None = None) -> tuple:
        """The expanded attention over the prompt and the compressed cache
        ``{"ckv": (B, max_len, r), "krope": (B, max_len, dr)}`` (the
        reference's ``mla_prefill``, which projects ``ckv`` and ``krope``
        a second time: the same function of the same inputs, so the
        forward's are reused).  ``cache_sh``: on a mesh with a ``model``
        axis, one layer's cache Shardings; ``ckv`` and ``krope`` are whole
        on every rank, which keeps the slots of its sequence split."""
        out, ckv, krope = self._expanded(x, cfg, 0)
        pad = (0, 0, 0, max_len - x.shape[1])
        cache = {"ckv": F.pad(ckv, pad).to(x.dtype),
                 "krope": F.pad(krope, pad).to(x.dtype)}
        if cache_sh is not None:
            sh = cache_split(cache_sh)
            whole = sharding.Sharding(sh.mesh, (sh.spec[0], None, None))
            cache = {k: sharding.relayout(t, whole, sh.spec)
                     for k, t in cache.items()}
        return out, cache

    def decode_step(self, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                    cache_len: torch.Tensor,
                    cache_sh: dict | None = None) -> tuple:
        """Absorbed decode (the reference's ``mla_decode``): ``W_uk`` is
        folded into the query and ``W_uv`` applied after the attention, so
        the scores and the weighted sum run over the compressed cache, in
        float32 einsums with the float32 weights (``w``, or ``w_q`` times
        its scale).  cache: {"ckv", "krope"} updated in place at
        ``cache_len - 1``.  ``cache_sh``: the cache is this rank's slots
        (:meth:`prefill`): every head's latent query is gathered over
        ``model``, the rank holding a row's slot writes it, the ranks'
        partials over their slots are combined, and each rank applies its
        heads' ``W_uv`` (every head's under ``every_head``, then the
        columns its rows of ``wo`` meet).  Returns (out (B,1,D),
        cache)."""
        b = x.shape[0]
        cos, sin = L.rope_table(cache_len[:, None] - 1, cfg.qk_rope_dim,
                                cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        q_nope, q_rope, ckv_new, krope_new = self._q_and_latent(x, cfg, cos,
                                                                sin)
        s_loc = cache["ckv"].shape[1]
        split = cache_split(cache_sh) if cache_sh is not None else None
        offset = 0 if split is None else sharding.local_offset(split, 1,
                                                               s_loc)
        rows = torch.arange(b, device=x.device)
        slot = (cache_len - 1).long() - offset
        own = None if split is None else (slot >= 0) & (slot < s_loc)
        _write_slots(cache["ckv"], rows, slot, own, ckv_new[:, 0], dim=1)
        _write_slots(cache["krope"], rows, slot, own, krope_new[:, 0, 0],
                     dim=1)
        o = self.absorbed_attention(q_nope[:, 0], q_rope[:, 0], cache,
                                    cache_len, cfg, split)
        return self._out(o.reshape(b, 1, -1).to(x.dtype), cfg), cache

    def latent_query(self, q_nope: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
        """q_nope (B,H,dn) -> ``q_nope W_uk`` (B,H,r) in float32 (H this
        rank's heads on a mesh, every head under ``every_head``)."""
        w_uk = self._weight(self.w_uk).reshape(cfg.kv_lora_rank, -1,
                                               cfg.qk_nope_dim)
        return torch.einsum("bhd,rhd->bhr", q_nope.float(), w_uk)

    def latent_logits(self, q_lat: torch.Tensor, q_rope: torch.Tensor,
                      cache: dict, cache_len: torch.Tensor, cfg: ModelConfig,
                      offset: int = 0) -> torch.Tensor:
        """The scores ``q_lat ckv^T + q_rope krope^T`` (B,H,S) in float32
        over the cache's slots, at global positions ``offset`` on; those
        at or past ``cache_len`` masked with ``NEG_INF``."""
        dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
        ckv = cache["ckv"].float()
        logits = (torch.einsum("bhr,bsr->bhs", q_lat, ckv)
                  + torch.einsum("bhd,bsd->bhs", q_rope.float(),
                                 cache["krope"].float())) \
            * (1.0 / math.sqrt(dn + dr))
        seen = torch.arange(offset, offset + ckv.shape[1],
                            device=ckv.device)[None, :] < cache_len[:, None]
        return logits.masked_fill(~seen[:, None, :], ops.NEG_INF)

    def latent_out(self, o_lat: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
        """o_lat (B,H,r) -> ``o_lat W_uv`` (B,H,dv) in float32."""
        w_uv = self._weight(self.w_uv).reshape(cfg.kv_lora_rank, -1,
                                               cfg.v_head_dim)
        return torch.einsum("bhr,rhv->bhv", o_lat, w_uv)

    def absorbed_attention(self, q_nope: torch.Tensor, q_rope: torch.Tensor,
                           cache: dict, cache_len: torch.Tensor,
                           cfg: ModelConfig,
                           split: sharding.Sharding | None = None
                           ) -> torch.Tensor:
        """q_nope (B,H,dn), q_rope (B,H,dr) against the compressed cache ->
        (B, H, dv) in float32: the scores ``(q_nope W_uk) ckv^T + q_rope
        krope^T`` over the first ``cache_len`` slots, their softmax times
        ``ckv``, then ``W_uv``.  ``split``: the cache is this rank's slots
        laid out so (:func:`cache_split`): every head's latent query is
        gathered over ``model``, the partials over the rank's slots are
        combined with the other ranks', and the rank's heads go on to its
        ``W_uv``.  Under ``every_head`` every rank holds every head
        throughout."""
        q_lat = self.latent_query(q_nope, cfg)
        offset, axes = 0, ()
        local = split is not None and self.mesh is not None and \
            not self.every_head
        if split is not None:
            offset = sharding.local_offset(split, 1, cache["ckv"].shape[1])
            axes = sharding.split_axes(split, 1)
        if local:
            q_lat = C.all_gather(q_lat, C.MODEL_AXIS, self.mesh, 1)
            q_rope = C.all_gather(q_rope, C.MODEL_AXIS, self.mesh, 1)
        p, lse = ops.partial_softmax(self.latent_logits(
            q_lat, q_rope, cache, cache_len, cfg, offset), bool(axes))
        o_lat = _combine(torch.einsum("bhs,bsr->bhr", p, cache["ckv"].float()),
                         lse, axes, None if split is None else split.mesh)
        if local:
            o_lat = _local_heads(o_lat, self.mesh)
        return self.latent_out(o_lat, cfg)


def cache_split(cache_sh: dict, features: bool = False) -> sharding.Sharding:
    """The Sharding of one layer's attention cache that splits its slots
    (GQA's ``k`` (B, KV, S, hd) on dim 2, an encoder-decoder's cross K/V
    on its frames there too, MLA's ``ckv`` (B, S, r) on dim 1): every
    field must split the same slots and nothing else but the batch (dim
    0), and with ``features`` its last dim (a cross K/V whose frames the
    model axis does not divide: whisper-tiny's 1500 over 16 split each
    head's 64 features instead), else the layout is one the port does not
    serve."""
    key = "ckv" if "ckv" in cache_sh else "k"
    sh = cache_sh[key]
    seq = 1 if key == "ckv" else 2
    last = len(sh.spec) - 1
    for name, other in cache_sh.items():
        parts = tuple(other.spec)
        bad = [d for d, p in enumerate(parts) if p is not None
               and d not in (0, seq) + ((last,) if features else ())]
        if bad or parts[0] != sh.spec[0] or parts[seq] != sh.spec[seq] \
                or parts[-1] != sh.spec[-1]:
            raise NotImplementedError(
                f"cache field {name!r} laid out as {parts}: the port serves "
                f"a cache split on its batch and its slots only")
    return sh


def _write_slots(t: torch.Tensor, rows: torch.Tensor, slot: torch.Tensor,
                 own: torch.Tensor | None, val: torch.Tensor,
                 dim: int = 2) -> None:
    """``t[row, ..., slot[row]] = val[row]`` on the slot dim ``dim`` (2:
    (B, KV, S, ...); 1: (B, S, ...)) in ``t``'s dtype; with ``own``, only
    the rows whose slot this rank holds (the others written back with
    what they held: no row count leaves the device)."""
    val = val.to(t.dtype)
    if own is None:
        idx = slot
    else:
        idx = slot.clamp(0, t.shape[dim] - 1)
        old = t[rows, :, idx] if dim == 2 else t[rows, idx]
        keep = own.reshape((-1,) + (1,) * (val.dim() - 1))
        val = torch.where(keep, val, old)
    if dim == 2:
        t[rows, :, idx] = val
    else:
        t[rows, idx] = val


def _combine(o: torch.Tensor, lse: torch.Tensor | None, axes: tuple,
             mesh: C.Mesh | None) -> torch.Tensor:
    """``ops.combine_partials`` of this rank's partial with those of the
    ranks that hold the other slots: a max and a sum over the mesh
    ``axes`` that split them (none: the rank's slots are all of them)."""
    if not axes:
        return o
    return ops.combine_partials(o, lse, lambda t: C.all_max(t, axes, mesh),
                                lambda t: C.all_reduce(t, axes, mesh))


def _local_columns(o: torch.Tensor, wo: L.NmcLinear) -> torch.Tensor:
    """The columns of o (..., every head's features) that this rank's rows
    of the row-parallel ``wo`` meet: its heads' where the heads divide,
    a slice through a head where they do not."""
    n = (wo.w if wo.w is not None else wo.w_q).shape[0]
    return o.narrow(-1, wo.mesh.index(C.MODEL_AXIS) * n, n)


def _local_heads(o: torch.Tensor, mesh: C.Mesh) -> torch.Tensor:
    """This rank's heads (dim 1) of every head's ``o`` (MLA, whose heads
    divide)."""
    n = o.shape[1] // mesh.model_size()
    return o.narrow(1, mesh.index(C.MODEL_AXIS) * n, n)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16) -> dict:
    """One layer's cache fields as ``{field: (shape, dtype)}``: MLA's
    compressed ``{"ckv", "krope"}`` in ``dtype``, or the GQA ``{"k",
    "v"}`` (int8 with bf16 scales under ``kv_cache_dtype="int8"``)."""
    if cfg.mla:
        return {"ckv": ((batch, max_len, cfg.kv_lora_rank), dtype),
                "krope": ((batch, max_len, cfg.qk_rope_dim), dtype)}
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        sshape = shape[:-1] + (1,)
        return {"k": (shape, torch.int8), "v": (shape, torch.int8),
                "k_s": (sshape, torch.bfloat16),
                "v_s": (sshape, torch.bfloat16)}
    return {"k": (shape, dtype), "v": (shape, dtype)}


def cache_init(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """One layer's zero cache (:func:`cache_shapes`)."""
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in cache_shapes(cfg, batch, max_len,
                                               dtype).items()}


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
