"""The LMs behind three entry points: ``[attn + MLP] x L`` (dense, VLM),
``first_dense x k + [attn + MoE] x (L - k)`` (MoE), ``[[Mamba2 x
attn_every] + shared attn/MLP block] x G`` (hybrid) and an encoder
``[attn + MLP] x Le`` with a decoder ``[self + cross + MLP] x L``
(encoder-decoder) and mLSTM / sLSTM blocks (xLSTM).

The counterpart of the JAX package's ``models/lm.py``: ``forward``
(teacher-forced logits and the summed MoE aux loss), ``prefill`` (the
prompt's last-position logits and the caches) and ``decode_step`` (one
token against the caches, updated in place).  The attention is GQA, or
MLA where ``cfg.mla``.  A VLM's batch carries ``"images"``, precomputed
patch embeddings that ``img_proj`` projects and places before the text
embeddings; an encoder-decoder's carries ``"frames"``, precomputed frame
embeddings that the encoder reads.  The layers run in a Python loop over
``ModuleList`` s; the caches keep the reference's layout, one tensor per
field stacked over layers:

* dense, MoE, VLM: GQA ``(L, B, KV, S, hd)`` or MLA ``(L, B, S, r)`` under
  ``"layers"`` and, for a MoE model's first dense layers,
  ``"dense_layers"``;
* hybrid: ``"mamba"`` (the Mamba2 states stacked ``(G, attn_every, B,
  ...)``) and ``"attn"`` (one GQA cache per group, ``(G, B, ...)``: the
  shared block's weights serve every group, each with its own cache);
* encoder-decoder: ``"layers"`` (the decoder's self-attention) and
  ``"cross_k"`` / ``"cross_v"`` ``(L, B, KV, S_enc, hd)``, the encoder
  output's keys and values, computed once at prefill;
* xLSTM: ``"blocks"``, a list with one tuple of float32 states per
  block, whatever the activation dtype: ``(C, n, m)`` for an mLSTM block,
  ``(c, n, m, h)`` for an sLSTM one, batch first.

The serving entry points (``forward``, ``prefill``, ``decode_step``,
``init_caches``) run under ``torch.inference_mode()``; :func:`loss_fn`,
the training objective, runs with autograd recording, through the
model's own ``forward``.

:func:`shard` lays a model out on a mesh (every rank draws or loads the
same full weights, then keeps its slices, as the reference's ``init``
then ``device_put``): data parallelism, and tensor and expert
parallelism over ``model``, for every family (column-parallel projections
and head, row-parallel ``wo`` / MLP ``wo`` / ``out_proj`` / ``down``,
vocab-parallel embedding, expert-local dispatch, Mamba2, mLSTM and sLSTM
heads, the encoder-decoder's encoder and cross K/V on local heads; a VLM's
``img_proj`` whole).  A vocab-parallel head's logits are gathered over
``model`` before the loss, so the cross entropy stays the single-rank
function.

Serving on a mesh: :func:`shard` lays out the int8 serving weights too
(quantize the full model first, then lay it out: a row-parallel weight's
per-output-channel scales span its whole input dim), and the caches are
this rank's slices under ``sharding.cache_shardings`` (the reference's
GSPMD layout): the batch over the data axes, and on a ``model`` axis the
attention caches' slots (a batch-1 cache's over the data axes and
``model`` together), the encoder-decoder's cross K/V over the encoder
frames, the Mamba2 and xLSTM states by the same rule (their longest dim:
an mLSTM ``C`` / ``n`` over its key dim, its ``m`` over heads, an sLSTM
state over its channels).  Prefill runs the model-parallel regions as the
forward does and hands each layer's cache over to that layout; decode
reads and updates it in place (each rank attends over its slots or its
frames, the ranks' partials combined, the heads of ``kv`` attention, of
a cross-attention and of MLA gathered for it; the Mamba2 and xLSTM
states gathered to the rank's heads and written back).  The logits are
this rank's rows with the whole vocabulary.  A batch is this rank's rows
(the global batch's under ``sharding.batch_shardings``); ``cache_len`` is
the global batch's, as the reference's replicated argument.  Where the
rule splits a layer stack over the data axes (a batch equal to an
encoder-decoder's decoder layers: it takes the first dim of the batch's
size), each data rank holds every row's cache of its slice of the
layers; each layer's rows move between the rank that holds it and the
ranks that own them (``sharding.StackSplit``: gathered onto the holder
at prefill, broadcast from it and written back at decode).

Activation checkpointing (``cfg.remat``, the reference's ``_maybe_remat``)
wraps the training forward at the reference's granularity: one
checkpoint per decoder layer (dense, VLM, a MoE model's dense and MoE
layers), per encoder and per decoder layer (encoder-decoder), per group
of ``attn_every`` Mamba2 layers with the shared block (hybrid), none for
the xLSTM.  It applies only where autograd records (prefill and decode are
unchanged) and runs ``torch.utils.checkpoint`` without reentry: the
backward runs each checkpointed forward again, so the kernel launches,
collectives (``context.traffic``) and MoE routings inside it count twice,
once in the forward and once in the recompute (which stops after the last
tensor the backward needs: collectives after it run once).
``remat_policy="dots"`` (JAX's ``checkpoint_dots``) saves the outputs of
the matrix products (``aten.mm``, ``addmm``, ``bmm``, ``baddbmm``) and
recomputes the rest; the CUDA kernels are called through ``ctypes``, out
of the dispatcher's sight, so ``flash_attention`` is recomputed under both
policies, and so is the plain attention in its place (its products run
under ``flash_attention.FALLBACK``; JAX would save an einsum attention's
products: the two packages differ there in memory, not in values).

Sequence parallelism (``cfg.seq_parallel`` on a ``model`` axis, where
``layers.seq_split`` holds for the embedded stream): the dense, MoE and
VLM stream holds this rank's rows of the sequence from the embedding to
``final_norm``, gathered before the head; the hybrid's only around its
shared block (its Mamba2 layers need the whole sequence).  The
encoder-decoder and the xLSTM run as without it.  The norm gains then see
local rows, so their gradients are partial over ``model``
(``Layout.seq_partial``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils import checkpoint as ckpt_lib

from repro_torch.distributed import context as C
from repro_torch.distributed import sharding
from repro_torch.kernels.flash_attention import FALLBACK
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.config import ModelConfig, resolve_device

#: the rows of the encoder-decoder's learned decoder positions
DEC_POSITIONS = 32768

#: the model families the port runs (every family of the reference)
FAMILIES = ("dense", "moe", "vlm", "hybrid", "encdec", "xlstm")
#: the families whose stream ``seq_parallel`` splits (the reference's
#: ``shard_seq`` sits in its decoder block only)
SEQ_FAMILIES = ("dense", "moe", "vlm", "hybrid")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the families {FAMILIES}, not "
            f"{cfg.family!r}")


#: the products that ``remat_policy="dots"`` saves
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default,
                   torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return ckpt_lib.CheckpointPolicy.MUST_SAVE \
        if op in _DOTS and not FALLBACK.get() \
        else ckpt_lib.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return ckpt_lib.create_selective_checkpoint_contexts(_dots_policy)


def remat(fn, cfg: ModelConfig, *args):
    """``fn(*args)``, checkpointed where ``cfg.remat`` and autograd
    records (the reference's ``_maybe_remat``; module docstring)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    kw = {"context_fn": _dots_contexts} if cfg.remat_policy == "dots" else {}
    return ckpt_lib.checkpoint(fn, *args, use_reentrant=False, **kw)


def _stack(caches: list) -> dict:
    """Per-layer caches (dicts of tensors) stacked over a new first axis,
    the layers this rank does not hold (None) left out."""
    caches = [c for c in caches if c is not None]
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _split(stacks: dict | None, key: str) -> sharding.WholeStack:
    """How the stack of cache ``key`` lies over the data axes
    (:meth:`LMBase.stack_splits`)."""
    return (stacks or {}).get(key, sharding.WHOLE_STACK)


def _stacked(one: dict, lead: tuple) -> dict:
    """``{field: (shape, dtype)}`` as ``{field: sharding.CacheField}``
    with ``lead`` stack dims in front."""
    return {k: sharding.CacheField(lead + tuple(shape), dt)
            for k, (shape, dt) in one.items()}


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

    def _ffn(self, x: torch.Tensor, cfg: ModelConfig,
             sp: bool = False) -> tuple:
        """(x + FFN(ln2(x)), the MoE aux loss or None)."""
        h = self.ln2(x)
        if self.moe is not None:
            y, aux = self.moe(h, cfg, sp)
            return x + y, aux
        return x + self.mlp(h, cfg.act, nmc_mode=cfg.nmc_mode, sp=sp), None

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                sp: bool = False) -> tuple:
        """``sp``: x and the result are this rank's rows of a
        sequence-split stream."""
        return self._ffn(x + self.attn(self.ln1(x), cfg, sp=sp), cfg, sp)

    def prefill(self, x: torch.Tensor, cfg: ModelConfig, max_len: int,
                cache_sh: dict | None = None) -> tuple:
        y, cache = self.attn.prefill(self.ln1(x), cfg, max_len, cache_sh)
        return self._ffn(x + y, cfg)[0], cache

    def decode_step(self, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                    cache_len: torch.Tensor,
                    cache_sh: dict | None = None) -> torch.Tensor:
        y, _ = self.attn.decode_step(self.ln1(x), cfg, cache, cache_len,
                                     cache_sh)
        return self._ffn(x + y, cfg)[0]


class EncoderBlock(nn.Module):
    """The encoder-decoder's encoder layer: LayerNorm -> non-causal GQA ->
    LayerNorm -> gelu MLP, a residual around each."""

    def __init__(self, ln1: L.LayerNorm, attn: A.GQAttention,
                 ln2: L.LayerNorm, mlp: L.MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp

    @classmethod
    def init(cls, gen: torch.Generator, cfg: ModelConfig,
             device=None) -> "EncoderBlock":
        d = cfg.d_model
        return cls(L.LayerNorm.init(d, cfg.norm_eps, device),
                   A.GQAttention.init(gen, cfg, device),
                   L.LayerNorm.init(d, cfg.norm_eps, device),
                   L.MLP.init(gen, d, cfg.d_ff, "gelu", device))

    def forward(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), cfg, causal=False)
        return x + self.mlp(self.ln2(x), "gelu", nmc_mode=cfg.nmc_mode)


class CrossDecoderBlock(nn.Module):
    """The encoder-decoder's decoder layer: causal self-attention (``ln1``,
    ``attn``), cross-attention to the encoder output (``lnx``, ``xattn``)
    and the gelu MLP (``ln2``, ``mlp``), LayerNorms, a residual around
    each."""

    def __init__(self, ln1: L.LayerNorm, attn: A.GQAttention,
                 lnx: L.LayerNorm, xattn: A.GQAttention, ln2: L.LayerNorm,
                 mlp: L.MLP):
        super().__init__()
        self.ln1, self.attn, self.lnx, self.xattn = ln1, attn, lnx, xattn
        self.ln2, self.mlp = ln2, mlp

    @classmethod
    def init(cls, gen: torch.Generator, cfg: ModelConfig,
             device=None) -> "CrossDecoderBlock":
        d = cfg.d_model
        return cls(L.LayerNorm.init(d, cfg.norm_eps, device),
                   A.GQAttention.init(gen, cfg, device),
                   L.LayerNorm.init(d, cfg.norm_eps, device),
                   A.GQAttention.init(gen, cfg, device),
                   L.LayerNorm.init(d, cfg.norm_eps, device),
                   L.MLP.init(gen, d, cfg.d_ff, "gelu", device))

    def cross_kv(self, enc: torch.Tensor, cfg: ModelConfig,
                 select: bool = True) -> tuple:
        """The encoder output's keys and values (B, KV, S_enc, hd), by
        ``xattn``'s ``wk`` / ``wv`` without ``nmc_mode``, as the
        reference's ``_cross_kv``: the float weights, or once quantized
        the w8 form (weights dequantized, then a matmul in the activation
        dtype); never an ``nmc_matmul`` launch.  On a mesh this rank's KV
        heads (with ``select`` False, every KV head where ``wk`` / ``wv``
        are whole; every KV head, the column slices gathered, where
        ``xattn`` runs every head)."""
        # ``enc`` entered the region in EncDecLM.hidden
        xa = self.xattn
        k, v = (xa.heads(lin(enc), lin, cfg) for lin in (xa.wk, xa.wv))
        if select and xa.kv_select is not None:
            k, v = k[:, :, xa.kv_select], v[:, :, xa.kv_select]
        return k.transpose(1, 2), v.transpose(1, 2)

    def _mlp(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        return x + self.mlp(self.ln2(x), "gelu", nmc_mode=cfg.nmc_mode)

    def _cross_and_mlp(self, x: torch.Tensor, kv: tuple,
                       cfg: ModelConfig) -> torch.Tensor:
        x = x + self.xattn(self.lnx(x), cfg, causal=False, kv=kv)
        return self._mlp(x, cfg)

    def forward(self, x: torch.Tensor, kv: tuple,
                cfg: ModelConfig) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), cfg, causal=True)
        return self._cross_and_mlp(x, kv, cfg)

    def prefill(self, x: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig,
                max_len: int, cache_sh: dict | None = None) -> tuple:
        """(x after the layer, its self-attention cache, its cross K/V).
        ``cache_sh``: on a ``model`` axis, :meth:`EncDecLM.cache_layout`;
        the caches returned are this rank's slices (the cross K/V every
        KV head of its frames)."""
        kv = self.cross_kv(enc, cfg, select=cache_sh is None)
        y, cache = self.attn.prefill(self.ln1(x), cfg, max_len,
                                     cache_sh and cache_sh["layers"])
        kv_x = kv
        if cache_sh is not None:
            sel = self.xattn.kv_select
            if sel is not None:
                kv_x = (kv[0][:, sel], kv[1][:, sel])
            sh = A.cache_split({"k": cache_sh["cross_k"],
                                "v": cache_sh["cross_v"]}, features=True)
            kv = tuple(self.xattn.to_cache(t, sh) for t in kv)
        return self._cross_and_mlp(x + y, kv_x, cfg), cache, kv

    def decode_step(self, x: torch.Tensor, kv: tuple, cfg: ModelConfig,
                    cache: dict, cache_len: torch.Tensor,
                    cache_sh: dict | None = None) -> torch.Tensor:
        """``cache_sh``: as in :meth:`prefill`; ``kv`` and ``cache`` are
        this rank's slices."""
        x = x + self.attn.decode_step(self.ln1(x), cfg, cache, cache_len,
                                      cache_sh and cache_sh["layers"])[0]
        cross_sh = None if cache_sh is None else A.cache_split(
            {"k": cache_sh["cross_k"], "v": cache_sh["cross_v"]},
            features=True)
        return self._mlp(x + self.xattn.cross_decode(self.lnx(x), cfg, kv,
                                                      cross_sh), cfg)


class LMBase(nn.Module):
    """What every family's model shares: the token embedding, the final
    RMSNorm and the LM head."""

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def inputs(self, batch: dict, cfg: ModelConfig) -> torch.Tensor:
        """The embedded ``batch["tokens"]``."""
        return self.embed(batch["tokens"], cfg.dtype)

    #: the layout on a mesh (:func:`shard`), None on one rank
    layout: sharding.Layout | None = None
    #: the stack dims in front of each cache key's fields (its layers; a
    #: hybrid's Mamba2 groups and layers; none for the xLSTM's per-block
    #: states), 1 where a key is not named
    CACHE_STACK_DIMS: dict = {}

    def init_caches(self, cfg: ModelConfig, batch: int, max_len: int,
                    dtype, device=None, shardings=None):
        """The caches of :meth:`cache_shapes`, each field at its initial
        value (0; an xLSTM max state's ``M0``); with ``shardings`` (their
        ``sharding.cache_shardings``) only this rank's slices."""
        device = device or self.device
        return sharding.map_tree(
            lambda f, sh: f.full(device, sh),
            self.cache_shapes(cfg, batch, max_len, dtype), shardings)

    def stacked_cache_layout(self, cfg: ModelConfig, batch: int,
                             max_len: int) -> tuple:
        """(the stacked caches' tree of ``sharding.CacheField`` s, their
        ``sharding.cache_shardings`` on this model's mesh) for a global
        ``batch`` and ``max_len``."""
        full = self.cache_shapes(cfg, batch, max_len, torch.bfloat16)
        return full, sharding.cache_shardings(full, self.layout.mesh, batch)

    def cache_layout(self, cfg: ModelConfig, batch: int,
                     max_len: int) -> dict:
        """The caches' layout on this model's mesh for a global ``batch``
        and ``max_len``: per cache key, one layer's Shardings as the layer
        computes (the key's tree: ``{field: Sharding}``, one Sharding, a
        list of tuples), those ``sharding.cache_shardings`` gives the
        stacked caches with their stack dims (:data:`CACHE_STACK_DIMS`)
        dropped; where the data axes split a stack dim
        (:meth:`stack_splits`) the layer's rows are split over them
        instead, as the rows its activations hold.  A stack dim split over
        ``model`` (no configuration's caches meet one; an empty stack's,
        which holds nothing, aside) raises ``NotImplementedError``."""
        full, shs = self.stacked_cache_layout(cfg, batch, max_len)
        shapes = sharding.flat_tree(full)
        for path, sh in sharding.flat_tree(shs).items():
            lead = self.CACHE_STACK_DIMS.get(path.split(".")[0], 1)
            if shapes[path].shape.numel() and any(
                    C.MODEL_AXIS in sharding.split_axes(sh, d)
                    for d in range(lead)):
                raise NotImplementedError(
                    f"{cfg.name}: cache {path} of "
                    f"{tuple(shapes[path].shape)} laid out as {sh.spec}: "
                    f"its layer stack split over {C.MODEL_AXIS!r}")
        splits = self._stack_splits(full, shs, batch)

        def unstacked(key, tree):
            n = self.CACHE_STACK_DIMS.get(key, 1)
            split = splits.get(key)

            def one(sh, _):
                spec = tuple(sh.spec[n:])
                if split is not None:        # the rows, not the stack
                    spec = (sh.spec[split.dim],) + spec[1:]
                return sharding.Sharding(sh.mesh, spec)
            return sharding.map_tree(one, tree)
        return {key: unstacked(key, tree) for key, tree in shs.items()}

    def stack_splits(self, cfg: ModelConfig, batch: int,
                     max_len: int) -> dict:
        """``{cache key: sharding.StackSplit}`` of the keys whose layer
        stack ``sharding.cache_shardings`` splits over the data axes for a
        global ``batch`` (ROADMAP fact 21: the first dim of the batch's
        size is a stack dim; whisper-tiny's 4 decoder layers for 4 rows);
        none off a mesh.  The data axes' place does not depend on
        ``max_len``: every field's slots come after its batch dim."""
        if self.layout is None:
            return {}
        return self._stack_splits(
            *self.stacked_cache_layout(cfg, batch, max_len), batch)

    def _stack_splits(self, full, shs, batch: int) -> dict:
        """:meth:`stack_splits` of the stacked caches ``full`` laid out as
        ``shs``."""
        shapes = sharding.flat_tree(full)
        rows = _rows(self.layout, batch)
        out = {}
        for path, sh in sharding.flat_tree(shs).items():
            key = path.split(".")[0]
            for d in range(self.CACHE_STACK_DIMS.get(key, 1)):
                axes = sharding.split_axes(sh, d)
                if axes and C.MODEL_AXIS not in axes:
                    out[key] = sharding.StackSplit(
                        self.layout.mesh, axes, d, shapes[path].shape[d],
                        rows)
        return out

    def splits_rows(self, batch: dict, cfg: ModelConfig) -> bool:
        """Whether the teacher-forced forward over ``batch`` splits its
        embedded stream on the sequence: ``cfg.seq_parallel``, a family
        of :data:`SEQ_FAMILIES`, and the reference's rule
        (``layers.seq_split``) on the layout's mesh for the embedded
        length (a VLM's image positions before its tokens).  The train
        step reads it too, for the gradients it sums over ``model``."""
        lay = self.layout
        if lay is None or not cfg.seq_parallel or \
                cfg.family not in SEQ_FAMILIES:
            return False
        n = batch["tokens"].shape[1]
        if cfg.family == "vlm":
            n += batch["images"].shape[1]
        model = lay.mesh.model_size()
        return model > 1 and n % model == 0

    def logits(self, x: torch.Tensor, cfg: ModelConfig,
               split: bool = False, last: bool = False) -> torch.Tensor:
        """The LM head over every position (at prefill the dynamic
        activation scale of ``w8a8`` covers all of them, as in the
        reference, so the head is not cut to the last position first);
        a vocab-parallel head's logits gathered over ``model``.
        ``split``: x is this rank's rows of a sequence-split stream,
        normalised there and gathered whole before the head.  ``last``:
        the last position's logits (B, vocab) only, cut before the
        gather."""
        h = self.final_norm(x)
        mesh = self.head.mesh
        if mesh is None:
            if split:        # a whole head: every rank reads every row
                h = C.gather_from_model(h, self.layout.mesh, 1)
            y = self.head(h, nmc_mode=cfg.nmc_mode)
            return y[:, -1] if last else y
        h = C.enter_region(h, mesh, split)
        y = self.head(h, nmc_mode=cfg.nmc_mode)
        if last:
            y = y[:, -1].contiguous()
        return C.gather_from_model(y, mesh, -1)


class DecoderLM(LMBase):
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
        return super().inputs(batch, cfg)

    def hidden(self, x: torch.Tensor, cfg: ModelConfig,
               split: bool = False) -> tuple:
        """Every block over the embedded ``x`` (each checkpointed under
        ``cfg.remat``): (x, the MoE layers' summed aux loss, 0 without
        any).  ``split``: x and the result are this rank's rows of the
        sequence-split stream."""
        auxs = []
        for _, blocks in self.stacks():
            for blk in blocks:
                x, aux = remat(blk, cfg, x, cfg, split)
                if aux is not None:
                    auxs.append(aux)
        aux = torch.stack(auxs).sum() if auxs \
            else torch.zeros((), device=x.device)
        return x, aux

    def forward(self, batch: dict, cfg: ModelConfig) -> tuple:
        x = self.inputs(batch, cfg)
        split = self.splits_rows(batch, cfg)
        if split:
            x = L.shard_seq(x, self.layout.mesh)
        x, aux = self.hidden(x, cfg, split)
        return self.logits(x, cfg, split), aux

    def prefill(self, batch: dict, cfg: ModelConfig, max_len: int,
                cache_sh: dict | None = None,
                stacks: dict | None = None) -> tuple:
        """``cache_sh``: :meth:`cache_layout` on a ``model`` axis;
        ``stacks``: :meth:`stack_splits`."""
        x = self.inputs(batch, cfg)
        caches = {}
        for key, blocks in self.stacks():
            split, cs = _split(stacks, key), []
            for i, blk in enumerate(blocks):
                x, c = blk.prefill(x, cfg, max_len,
                                   cache_sh and cache_sh[key])
                cs.append(split.keep((i,), c))
            caches[key] = _stack(cs) if cs else None
        # a stack of no layer (a MoE model cut to its dense layers, as the
        # reference's zero-length leaves): every layer's cache has the
        # same fields, so another stack's, cut to none
        like = next(c for c in caches.values() if c is not None)
        caches = {key: c if c is not None else
                  {f: t[:0] for f, t in like.items()}
                  for key, c in caches.items()}
        return self.logits(x, cfg, last=True), caches

    def decode_step(self, tokens: torch.Tensor, caches: dict,
                    cache_len: torch.Tensor, cfg: ModelConfig,
                    cache_sh: dict | None = None,
                    stacks: dict | None = None) -> tuple:
        x = self.embed(tokens, cfg.dtype)
        for key, blocks in self.stacks():
            split, stack = _split(stacks, key), caches[key]
            for i, blk in enumerate(blocks):
                layer = split.fetch(stack, (i,))
                x = blk.decode_step(x, cfg, layer, cache_len,
                                    cache_sh and cache_sh[key])
                split.store(stack, (i,), layer)
        return self.logits(x, cfg)[:, 0], caches

    def cache_shapes(self, cfg: ModelConfig, batch: int, max_len: int,
                     dtype) -> dict:
        """``{key: {field: sharding.CacheField}}`` of the caches, each
        layer's cache stacked over its stack's layers."""
        one = A.cache_shapes(cfg, batch, max_len, dtype)
        return {key: _stacked(one, (len(blocks),))
                for key, blocks in self.stacks()}


class HybridLM(LMBase):
    """zamba2-style: ``G = n_layers // attn_every`` groups of
    ``attn_every`` Mamba2 layers, each group followed by the ONE
    ``shared_attn`` block (RMSNorm, GQA, MLP), whose weights every group
    reuses."""

    CACHE_STACK_DIMS = {"mamba": 2}

    def __init__(self, embed: L.Embedding, mamba: list,
                 shared_attn: DecoderBlock, final_norm: L.RMSNorm,
                 head: L.NmcLinear):
        super().__init__()
        self.embed = embed
        self.mamba = nn.ModuleList(nn.ModuleList(g) for g in mamba)
        self.shared_attn = shared_attn
        self.final_norm = final_norm
        self.head = head

    def _group(self, x: torch.Tensor, group: nn.ModuleList,
               cfg: ModelConfig, split: bool) -> torch.Tensor:
        """One group: its Mamba2 layers, then the shared block (``split``:
        over this rank's rows of the sequence, entered split and left
        gathered)."""
        for layer in group:
            x = x + layer(x, cfg)
        if not split:
            return self.shared_attn(x, cfg)[0]
        mesh = self.layout.mesh
        x, _ = self.shared_attn(L.shard_seq(x, mesh), cfg, True)
        return C.gather_from_model(x, mesh, 1)

    def hidden(self, x: torch.Tensor, cfg: ModelConfig,
               split: bool = False) -> tuple:
        """Every group over the embedded ``x`` (each checkpointed under
        ``cfg.remat``): (x, 0).  ``split``: the shared block runs on this
        rank's rows of the sequence."""
        for group in self.mamba:
            x = remat(self._group, cfg, x, group, cfg, split)
        return x, torch.zeros((), device=x.device)

    def forward(self, batch: dict, cfg: ModelConfig) -> tuple:
        x = self.inputs(batch, cfg)
        x, aux = self.hidden(x, cfg, self.splits_rows(batch, cfg))
        return self.logits(x, cfg), aux

    def prefill(self, batch: dict, cfg: ModelConfig, max_len: int,
                cache_sh: dict | None = None,
                stacks: dict | None = None) -> tuple:
        """``cache_sh``: :meth:`cache_layout` on a ``model`` axis (each
        Mamba2 layer's state laid out from its heads to it); ``stacks``:
        :meth:`stack_splits`."""
        x = self.inputs(batch, cfg)
        ms, ac = _split(stacks, "mamba"), _split(stacks, "attn")
        states, attn = [], []
        for g, group in enumerate(self.mamba):
            sts = []
            for e, layer in enumerate(group):
                y, st = layer(x, cfg, return_state=True)
                x = x + y
                sts.append(ms.keep((g, e), st if cache_sh is None
                                   else layer.laid_out(st, cache_sh["mamba"])))
            if any(st is not None for st in sts):
                states.append(_stack(sts))
            x, c = self.shared_attn.prefill(x, cfg, max_len,
                                            cache_sh and cache_sh["attn"])
            attn.append(ac.keep((g,), c))
        return self.logits(x, cfg, last=True), {"mamba": _stack(states),
                                            "attn": _stack(attn)}

    def decode_step(self, tokens: torch.Tensor, caches: dict,
                    cache_len: torch.Tensor, cfg: ModelConfig,
                    cache_sh: dict | None = None,
                    stacks: dict | None = None) -> tuple:
        x = self.embed(tokens, cfg.dtype)
        ms, ac = _split(stacks, "mamba"), _split(stacks, "attn")
        for g, group in enumerate(self.mamba):
            for e, layer in enumerate(group):
                st = ms.fetch(caches["mamba"], (g, e))
                x = x + layer.decode_step(x, cfg, st,
                                          cache_sh and cache_sh["mamba"])
                ms.store(caches["mamba"], (g, e), st)
            c = ac.fetch(caches["attn"], (g,))
            x = self.shared_attn.decode_step(x, cfg, c, cache_len,
                                             cache_sh and cache_sh["attn"])
            ac.store(caches["attn"], (g,), c)
        return self.logits(x, cfg)[:, 0], caches

    def cache_shapes(self, cfg: ModelConfig, batch: int, max_len: int,
                     dtype) -> dict:
        """``{key: {field: sharding.CacheField}}``: the Mamba2 states
        stacked (groups, layers), the shared block's caches (groups)."""
        groups = (len(self.mamba), len(self.mamba[0]))
        return {"mamba": _stacked(SSM.state_shapes(cfg, batch, dtype),
                                  groups),
                "attn": _stacked(A.cache_shapes(cfg, batch, max_len, dtype),
                                 groups[:1])}


class EncDecLM(LMBase):
    """whisper-style: an encoder (``enc_layers``, then the RMSNorm
    ``enc_norm``) over the batch's ``"frames"``, and a decoder
    (``layers``) over the tokens plus the learned positions ``pos_dec``
    (:data:`DEC_POSITIONS` rows), each layer attending to the encoder
    output."""

    def __init__(self, embed: L.Embedding, enc_layers: list, layers: list,
                 pos_dec: L.Embedding, enc_norm: L.RMSNorm,
                 final_norm: L.RMSNorm, head: L.NmcLinear):
        super().__init__()
        self.embed = embed
        self.enc_layers = nn.ModuleList(enc_layers)
        self.layers = nn.ModuleList(layers)
        self.pos_dec = pos_dec
        self.enc_norm = enc_norm
        self.final_norm = final_norm
        self.head = head

    def encode(self, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """frames (B, S_enc, D), cast to ``cfg.dtype`` -> the encoder
        output."""
        x = frames.to(cfg.dtype)
        for blk in self.enc_layers:
            x = remat(blk, cfg, x, cfg)
        return self.enc_norm(x)

    def inputs(self, batch: dict, cfg: ModelConfig) -> torch.Tensor:
        """The decoder's input: the embedded tokens plus their positions."""
        s = batch["tokens"].shape[1]
        return super().inputs(batch, cfg) + \
            self.pos_dec.table[:s].to(cfg.dtype)

    def hidden(self, x: torch.Tensor, enc: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
        """Every decoder layer over ``x``, against the encoder output (on a
        mesh, entering the model-parallel region once: every layer's cross
        K/V projections give partial gradients of it)."""
        mesh = self.layers[0].xattn.mesh if len(self.layers) else None
        if mesh is not None:
            enc = C.copy_to_model(enc, mesh)

        def layer(x, enc, blk):
            return blk(x, blk.cross_kv(enc, cfg), cfg)
        for blk in self.layers:
            x = remat(layer, cfg, x, enc, blk)
        return x

    def forward(self, batch: dict, cfg: ModelConfig) -> tuple:
        enc = self.encode(batch["frames"], cfg)
        x = self.hidden(self.inputs(batch, cfg), enc, cfg)
        return self.logits(x, cfg), torch.zeros((), device=x.device)

    def prefill(self, batch: dict, cfg: ModelConfig, max_len: int,
                cache_sh: dict | None = None,
                stacks: dict | None = None) -> tuple:
        """``cache_sh``: :meth:`cache_layout` on a ``model`` axis;
        ``stacks``: :meth:`stack_splits`."""
        enc = self.encode(batch["frames"], cfg)
        x = self.inputs(batch, cfg)
        cs, ks, vs = [], [], []
        for i, blk in enumerate(self.layers):
            x, c, (k, v) = blk.prefill(x, enc, cfg, max_len, cache_sh)
            cs.append(_split(stacks, "layers").keep((i,), c))
            ks.append(_split(stacks, "cross_k").keep((i,), k))
            vs.append(_split(stacks, "cross_v").keep((i,), v))
        return self.logits(x, cfg, last=True), {
            "layers": _stack(cs),
            "cross_k": torch.stack([k for k in ks if k is not None]),
            "cross_v": torch.stack([v for v in vs if v is not None])}

    def decode_step(self, tokens: torch.Tensor, caches: dict,
                    cache_len: torch.Tensor, cfg: ModelConfig,
                    cache_sh: dict | None = None,
                    stacks: dict | None = None) -> tuple:
        """The cross K/V are read, never written: a layer held on another
        data rank (``stacks``) is fetched and not stored back."""
        table = self.pos_dec.table
        pos = torch.clamp(cache_len - 1, 0, table.shape[0] - 1).long()
        x = self.embed(tokens, cfg.dtype) + table[pos][:, None, :].to(
            cfg.dtype)
        split = _split(stacks, "layers")
        for i, blk in enumerate(self.layers):
            layer = split.fetch(caches["layers"], (i,))
            kv = tuple(_split(stacks, key).fetch(caches[key], (i,))
                       for key in ("cross_k", "cross_v"))
            x = blk.decode_step(x, kv, cfg, layer, cache_len, cache_sh)
            split.store(caches["layers"], (i,), layer)
        return self.logits(x, cfg)[:, 0], caches

    def cache_shapes(self, cfg: ModelConfig, batch: int, max_len: int,
                     dtype) -> dict:
        """``{"layers": {field: CacheField}, "cross_k" / "cross_v":
        CacheField}`` (``sharding.CacheField``): the self-attention caches
        and the encoder output's keys and values, each stacked over the
        decoder layers."""
        n = len(self.layers)
        cross = sharding.CacheField(
            (n, batch, cfg.n_kv_heads, cfg.enc_seq, cfg.head_dim), dtype)
        return {"layers": _stacked(A.cache_shapes(cfg, batch, max_len,
                                                  dtype), (n,)),
                "cross_k": cross, "cross_v": cross}


class XLSTMLM(LMBase):
    """xLSTM: a stack of mLSTM blocks with sLSTM blocks at
    ``cfg.slstm_layers``, each block holding its own residual."""

    CACHE_STACK_DIMS = {"blocks": 0}

    def __init__(self, embed: L.Embedding, blocks: list,
                 final_norm: L.RMSNorm, head: L.NmcLinear):
        super().__init__()
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.head = head

    def hidden(self, x: torch.Tensor, cfg: ModelConfig) -> tuple:
        """Every block over the embedded ``x``: (x, 0)."""
        for blk in self.blocks:
            x = blk(x, cfg)
        return x, torch.zeros((), device=x.device)

    def forward(self, batch: dict, cfg: ModelConfig) -> tuple:
        x, aux = self.hidden(self.inputs(batch, cfg), cfg)
        return self.logits(x, cfg), aux

    def prefill(self, batch: dict, cfg: ModelConfig, max_len: int,
                cache_sh: dict | None = None,
                stacks: dict | None = None) -> tuple:
        """``cache_sh``: :meth:`cache_layout` on a ``model`` axis (each
        block's state laid out from its heads to it).  The states are per
        block, no stack: ``stacks`` is always empty."""
        x = self.inputs(batch, cfg)
        states = []
        for i, blk in enumerate(self.blocks):
            x, st = blk(x, cfg, return_state=True)
            states.append(st if cache_sh is None
                          else blk.laid_out(st, cache_sh["blocks"][i]))
        return self.logits(x, cfg, last=True), {"blocks": states}

    def decode_step(self, tokens: torch.Tensor, caches: dict,
                    cache_len: torch.Tensor, cfg: ModelConfig,
                    cache_sh: dict | None = None,
                    stacks: dict | None = None) -> tuple:
        x = self.embed(tokens, cfg.dtype)
        for i, (blk, st) in enumerate(zip(self.blocks, caches["blocks"])):
            x = blk.decode_step(x, cfg, st,
                                cache_sh and cache_sh["blocks"][i])
        return self.logits(x, cfg)[:, 0], caches

    def cache_shapes(self, cfg: ModelConfig, batch: int, max_len: int,
                     dtype) -> dict:
        """``{"blocks": [one block's state fields, ...]}``, float32
        whatever ``dtype`` is (as the reference), unstacked
        (:func:`~repro_torch.models.xlstm.mlstm_state_shapes`,
        :func:`~repro_torch.models.xlstm.slstm_state_shapes`)."""
        return {"blocks": [
            (XL.slstm_state_shapes if isinstance(blk, XL.SLSTM)
             else XL.mlstm_state_shapes)(cfg, batch)
            for blk in self.blocks]}


# ---------------------------------------------------------------------------
# entry points (the reference's function names)
# ---------------------------------------------------------------------------

@torch.no_grad()
def draw_blocks(cfg: ModelConfig, generator: torch.Generator | None,
                device, each) -> LMBase:
    """:func:`init_params`, with ``each`` applied to the head, to every
    block (a hybrid's Mamba2 layers and its shared block, an
    encoder-decoder's encoder and decoder layers) and to a VLM's
    ``img_proj`` as soon as it is drawn (the float block is then
    dropped), in the generator's order: embedding, head, then the
    reference's order of keys (the first dense layers, the layers,
    ``img_proj``; the Mamba2 groups, ``shared_attn``; ``enc_layers``,
    ``layers``, ``pos_dec``; the xLSTM blocks)."""
    _check_family(cfg)
    device = resolve_device(device)
    if device.type == "meta":      # shapes only: nothing is drawn
        gen = None
    else:
        gen = generator if generator is not None \
            else torch.Generator(device=device).manual_seed(0)
    embed = L.Embedding.init(gen, cfg.vocab_size, cfg.d_model, device)
    head = each(L.NmcLinear.init(gen, cfg.d_model, cfg.vocab_size,
                                 device=device))

    def norm():
        return L.RMSNorm.init(cfg.d_model, cfg.norm_eps, device)
    if cfg.family == "hybrid":
        mamba = [[each(SSM.Mamba2.init(gen, cfg, device))
                  for _ in range(cfg.attn_every)]
                 for _ in range(cfg.n_layers // cfg.attn_every)]
        shared = each(DecoderBlock.init(gen, cfg, device))
        return HybridLM(embed, mamba, shared, norm(), head)
    if cfg.family == "xlstm":
        blocks = [each((XL.SLSTM if i in cfg.slstm_layers else XL.MLSTM)
                       .init(gen, cfg, device))
                  for i in range(cfg.n_layers)]
        return XLSTMLM(embed, blocks, norm(), head)
    if cfg.family == "encdec":
        enc = [each(EncoderBlock.init(gen, cfg, device))
               for _ in range(cfg.n_enc_layers)]
        dec = [each(CrossDecoderBlock.init(gen, cfg, device))
               for _ in range(cfg.n_layers)]
        pos = L.Embedding.init(gen, DEC_POSITIONS, cfg.d_model, device)
        return EncDecLM(embed, enc, dec, pos, norm(), norm(), head)
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
    return DecoderLM(embed, layers, norm(), head, dense, img_proj)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> LMBase:
    """Random float32 weights with the reference's initialisation (normal
    / sqrt(d_in) linears and expert banks, 0.02 embedding and decoder
    positions, unit norm gains, zero biases, the Mamba2 layers' own, the
    sLSTM blocks' 0.1-normal recurrent weights),
    drawn from ``generator`` (a fresh seed-0 generator on ``device`` when
    None; none on ``device="meta"``, where the weights are shapes and
    dtypes only).  ``device=None`` is the card and raises without one."""
    return draw_blocks(cfg, generator, device, lambda m: m)


@torch.inference_mode()
def forward(params: LMBase, batch: dict, cfg: ModelConfig) -> tuple:
    """Teacher-forced forward over ``batch["tokens"]`` (after
    ``batch["images"]`` for a VLM: the logits cover the image positions
    too; against ``batch["frames"]`` for an encoder-decoder).  Returns
    (logits, aux_loss): the MoE layers' summed load-balancing loss, 0 for
    the other families."""
    _check_family(cfg)
    return params(batch, cfg)


def loss_fn(params: LMBase, batch: dict, cfg: ModelConfig,
            aux_weight: float = 0.01) -> tuple:
    """Next-token cross entropy in float32 plus ``aux_weight`` times the
    MoE aux loss: ``(loss, {"nll", "aux"})``, differentiable in the
    model's parameters.  ``batch["tokens"]`` supervises; a VLM's image
    positions are dropped first; an optional ``batch["mask"]`` (B, S)
    weights the targets (the mean over the kept ones, at least 1).

    On a model laid out over ``n`` data ranks, ``batch`` is this rank's
    rows, and a masked mean is the reference's global one: the weighted
    sum over this rank's rows times ``n`` over the kept count summed over
    the data ranks (at least 1), so that the mean of the ranks' values,
    which the train step takes of the loss and of the gradients, is the
    global masked mean and its gradient."""
    _check_family(cfg)
    logits, aux = params(batch, cfg)
    tokens = batch["tokens"]
    if cfg.family == "vlm":
        logits = logits[:, batch["images"].shape[1]:]
    tgt = tokens[:, 1:].long()
    lg = logits[:, :-1].float()
    nll = torch.logsumexp(lg, dim=-1) - \
        torch.gather(lg, -1, tgt[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is not None:
        m = mask[:, 1:].float()
        count, scale = torch.sum(m), 1.0
        lay = params.layout
        if lay is not None and lay.mesh.size(lay.mesh.data_axes()) > 1:
            axes = lay.mesh.data_axes()
            count = C.all_reduce(count, axes, lay.mesh)
            scale = float(lay.mesh.size(axes))
        loss = torch.sum(nll * m) * scale / torch.clamp_min(count, 1.0)
    else:
        loss = torch.mean(nll)
    return loss + aux_weight * aux, {"nll": loss, "aux": aux}


def _rows(lay: sharding.Layout, n: int) -> tuple:
    """(this rank's first row, its rows) of a global batch of ``n`` rows
    (``sharding.batch_shardings``: split over the data axes where they
    divide it)."""
    axes = lay.mesh.data_axes()
    d = lay.mesh.size(axes)
    if d > 1 and n % d == 0:
        return lay.mesh.index(axes) * (n // d), n // d
    return 0, n


def _check_rows(got: int, lay: sharding.Layout, n: int) -> None:
    if got != _rows(lay, n)[1]:
        raise ValueError(f"this rank holds {got} rows of a global batch of "
                         f"{n}, its layout gives it {_rows(lay, n)[1]}")


@torch.inference_mode()
def prefill(params: LMBase, batch: dict, cfg: ModelConfig, max_len: int,
            global_batch: int | None = None) -> tuple:
    """Process the prompt (a VLM's images first; an encoder-decoder's
    frames through the encoder), return (last-position logits, caches).
    On a mesh of more than one rank ``batch`` holds this rank's rows of a
    global batch of ``global_batch`` rows, which it needs (a batch copied
    to every data rank and one split over them hold the same local rows
    and are laid out apart), and the caches are this rank's slices under
    ``cache_shardings`` (module docstring), a layer stack split over the
    data axes included (ROADMAP fact 21)."""
    _check_family(cfg)
    lay = params.layout
    if lay is None:
        return params.prefill(batch, cfg, max_len)
    rows = batch["tokens"].shape[0]
    if global_batch is None and lay.mesh.size(lay.mesh.axis_names) > 1:
        raise ValueError(f"{cfg.name}: prefill on a mesh needs "
                         f"global_batch, the rows of the whole batch")
    n = rows if global_batch is None else global_batch
    _check_rows(rows, lay, n)
    cache_sh = params.cache_layout(cfg, n, max_len) \
        if lay.mesh.model_size() > 1 else None
    return params.prefill(batch, cfg, max_len, cache_sh,
                          params.stack_splits(cfg, n, max_len))


@torch.inference_mode()
def decode_step(params: LMBase, tokens: torch.Tensor, caches: dict,
                cache_len: torch.Tensor, cfg: ModelConfig,
                max_len: int | None = None) -> tuple:
    """One decode step.  tokens: (B, 1) the new token ids; cache_len: (B,)
    lengths INCLUDING the new token.  Returns (logits (B, vocab), caches),
    the caches updated in place.  On a mesh ``tokens`` are this rank's
    rows and ``cache_len`` the global batch's; on a ``model`` axis
    ``max_len`` is the caches' full length (that of :func:`init_caches`
    or :func:`prefill`), which their slices do not tell, and every slice
    must have the shape that layout gives it."""
    _check_family(cfg)
    lay = params.layout
    if lay is None:
        return params.decode_step(tokens, caches, cache_len, cfg)
    n = cache_len.shape[0]
    first, rows = _rows(lay, n)
    _check_rows(tokens.shape[0], lay, n)
    local = cache_len.narrow(0, first, rows)
    if lay.mesh.model_size() == 1:
        # on data axes alone max_len does not move the layout
        return params.decode_step(tokens, caches, local, cfg, None,
                                  params.stack_splits(cfg, n, max_len or 1))
    if max_len is None:
        raise ValueError(f"{cfg.name}: decode_step on a 'model' axis needs "
                         f"max_len, the caches' full length")
    _check_slices(params, cfg, caches, n, max_len)
    return params.decode_step(tokens, caches, local, cfg,
                              params.cache_layout(cfg, n, max_len),
                              params.stack_splits(cfg, n, max_len))


def _check_slices(params: LMBase, cfg: ModelConfig, caches: dict, n: int,
                  max_len: int) -> None:
    """Raise unless every cache slice has the shape ``cache_shardings``
    gives this rank for ``n`` rows of ``max_len`` (a cache laid out for
    another batch or length)."""
    full, lay = params.stacked_cache_layout(cfg, n, max_len)
    shs, got = sharding.flat_tree(lay), sharding.flat_tree(caches)
    for path, f in sharding.flat_tree(full).items():
        want = sharding.local_shape(tuple(f.shape), shs[path])
        if tuple(got[path].shape) != want:
            raise ValueError(
                f"{cfg.name}: cache {path} is {tuple(got[path].shape)} on "
                f"this rank, its layout for {n} rows of {max_len} gives "
                f"{want}")


@torch.inference_mode()
def init_caches(params: LMBase, cfg: ModelConfig, batch: int,
                max_len: int, dtype=torch.bfloat16) -> dict:
    """Initial caches for ``batch`` rows of ``max_len`` (zeros; an
    xLSTM's max states at ``M0``); on a mesh this rank's slices of the
    global batch's under ``cache_shardings``, and only those allocated (a
    layer stack split over the data axes: this rank's layers, every row
    of each; ROADMAP fact 21)."""
    _check_family(cfg)
    lay = params.layout
    if lay is None:
        return params.init_caches(cfg, batch, max_len, dtype)
    params.cache_layout(cfg, batch, max_len)        # raises where it must
    _, shs = params.stacked_cache_layout(cfg, batch, max_len)
    return params.init_caches(cfg, batch, max_len, dtype, shardings=shs)


@torch.no_grad()
def shard(params: LMBase, cfg: ModelConfig, mesh: C.Mesh) -> LMBase:
    """Lay ``params`` (full weights, the same on every rank) out on
    ``mesh``: each parameter replaced by its local slice
    (:func:`sharding.local_slice` under :func:`sharding.param_shardings`),
    the modules told their part, and ``params.layout`` set.  A ``model``
    axis over 1 takes every family: the dense and MoE decoders, with GQA
    or MLA (its latent projections ``w_dkv``, ``w_krope``, ``norm_ckv``
    whole), the VLM (``img_proj`` whole, outside the model-parallel
    regions), the hybrid (Mamba2 on local heads, the shared GQA block
    tensor-parallel), the encoder-decoder (its encoder, self- and
    cross-attention on local heads; an odd vocabulary keeps ``embed`` and
    ``head`` whole) and the xLSTM (mLSTM and sLSTM on local heads).
    Where the KV heads do not divide over ``model``, ``wk`` and ``wv``
    stay whole (the rule would split them by columns, through a head) and
    each rank takes the KV heads its query heads read.  Where the
    attention, MLA, Mamba2 SSM, mLSTM or sLSTM heads do not divide, the
    rule splits their projections through a head all the same, and each
    such layer runs every head on every rank (``every_head``: the column
    slices gathered into whole heads, each rank keeping its columns of
    the output; the attention, the SSD and the recurrences replicated
    over ``model``).  ``params.layout.partial`` names the whole tensors
    read inside a model-parallel region, whose gradients are partial over
    ``model``: the MoE routers, whole KV heads, MLA's latent projections
    (and whatever of ``wq`` / ``w_uk`` / ``w_uv`` / ``wo`` the rule keeps
    whole where every rank runs every head), Mamba2's ``in_b`` / ``in_c``
    / ``in_dt`` / ``conv_bc_*`` / ``norm.g`` (and its whole ``A_log`` /
    ``D`` / ``dt_bias`` where every rank runs every head), the mLSTM's
    ``wf`` and ``out_norm.g`` (and its whole ``wi`` where every rank runs
    every head); under
    ``cfg.seq_parallel`` (the
    families of :data:`SEQ_FAMILIES`) also every replicated weight of a
    block that runs on this rank's rows of the sequence, and the dense,
    MoE and VLM models' ``final_norm.g`` (``layout.seq_partial``, partial
    only in a step whose stream was split).

    A MoE model's experts must divide over ``model`` (the reference's
    ``shard_map`` fails otherwise): ``NotImplementedError``.

    The int8 serving weights (buffers: ``w_q`` and ``scale``, an int8
    expert bank and its scales) are laid out by the same rules: a model
    is quantized whole, then laid out.  On
    any mesh every linear's W8A8 activation scale is taken over the data
    axes that split its rows, and a row-parallel one's over ``model``
    too (``NmcLinear.amax_axes``)."""
    _check_family(cfg)
    named = dict(params.named_parameters())
    buffers = dict(params.named_buffers())
    tp = mesh.model_size()
    # where model does not divide the KV heads, the rule would shard wk /
    # wv by columns; the heads need whole ones
    whole_kv = bool(tp > 1 and not cfg.mla and cfg.n_kv_heads % tp)
    shard_of = sharding.tensor_shardings(named, mesh, whole_kv)
    buf_of = sharding.tensor_shardings(buffers, mesh, whole_kv)
    moments = {n: sharding.Sharding(mesh, s) for n, s in
               sharding.moment_specs(
                   named, mesh, {n: sh.spec for n, sh in shard_of.items()}
               ).items()}
    for name, p in named.items():
        p.data = sharding.local_slice(p.data, shard_of[name])
    for name, b in buffers.items():
        mod_name, _, leaf = name.rpartition(".")
        params.get_submodule(mod_name)._buffers[leaf] = \
            sharding.local_slice(b, buf_of[name])
    partial, seq_partial = set(), set()
    if mesh.model_size() > 1:
        partial = _mark_parallel(params, cfg, shard_of | buf_of, mesh)
        if cfg.seq_parallel and cfg.family in SEQ_FAMILIES:
            seq_partial = _seq_partial(params, cfg, shard_of) - partial
    data = mesh.data_axes() if mesh.size(mesh.data_axes()) > 1 else ()
    for mod in params.modules():
        if isinstance(mod, L.NmcLinear):
            mod.amax_axes = data + ((C.MODEL_AXIS,)
                                    if mod.parallel == "row" else ())
            mod.amax_mesh = mesh
        elif isinstance(mod, MOE.MoE):
            mod.mesh = mesh
            bank = mod.wi if mod.bank_keys == MOE.BANKS else mod.wi_q
            if bank.shape[0] != cfg.n_experts:
                mod.expert_offset = mesh.index(C.MODEL_AXIS) * bank.shape[0]
    params.layout = sharding.Layout(mesh, shard_of, moments,
                                    frozenset(partial | seq_partial),
                                    frozenset(seq_partial))
    return params


def _mark_parallel(params: LMBase, cfg: ModelConfig, shard_of: dict,
                   mesh: C.Mesh) -> set:
    """Set each linear's ``parallel`` kind (read from ``w``'s Sharding, or
    ``w_q``'s), the MLPs', attentions', Mamba2, mLSTM and sLSTM blocks' and
    the vocab-parallel embedding's mesh; return the names whose gradient
    is partial over ``model``."""
    model = C.MODEL_AXIS
    partial = set()
    for mname, mod in params.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, L.NmcLinear):
            spec = shard_of[pre + ("w" if mod.w is not None
                                   else "w_q")].spec
            mod.parallel = "col" if spec[-1] == model else \
                "row" if spec[-2] == model else None
            mod.mesh = mesh if mod.parallel else None
        elif isinstance(mod, L.Embedding) and pre == "embed.":
            if shard_of[pre + "table"].spec[0] == model:
                mod.mesh = mesh
                mod.vocab_offset = mesh.index(model) * mod.table.shape[0]
        elif isinstance(mod, MOE.MoE):
            if cfg.n_experts % mesh.model_size():
                # the reference's shard_map splits the banks over model
                # and fails where it does not divide them
                raise NotImplementedError(
                    f"{cfg.name}: {cfg.n_experts} experts over a model "
                    f"axis of {mesh.model_size()}")
            partial |= {pre + "router." + n
                        for n, _ in mod.router.named_parameters()}
    tp = mesh.model_size()
    for mname, mod in params.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, L.MLP) and mod.wi.parallel == "col":
            mod.mesh = mesh
        elif isinstance(mod, A.GQAttention) and mod.wq.parallel == "col":
            mod.mesh = mesh
            # heads, or split KV heads, that model does not divide
            mod.every_head = bool(cfg.n_heads % tp or (
                mod.wk.parallel == "col" and cfg.n_kv_heads % tp))
            if mod.wk.parallel != "col":
                if not mod.every_head:
                    mod.kv_select = _kv_select(cfg, mesh)
                partial |= _names(mod, pre, ("wk", "wv"))
        elif isinstance(mod, A.MLAttention) and any(
                getattr(mod, n).parallel for n in MLA_SPLIT):
            mod.mesh = mesh
            mod.every_head = bool(cfg.n_heads % tp)
            # the latent projections, and under every_head whatever the
            # rule keeps whole, are read inside the region
            whole = [n for n in MLA_SPLIT if getattr(mod, n).parallel is None]
            partial |= _names(mod, pre, ("w_dkv", "w_krope", "norm_ckv",
                                         *whole))
        elif isinstance(mod, SSM.Mamba2) and mod.in_x.parallel == "col":
            mod.mesh = mesh
            mod.every_head = bool(cfg.ssm_heads % tp)
            partial |= _names(mod, pre, ("in_b", "in_c", "in_dt", "norm"))
            partial |= {pre + n for n in ("conv_bc_w", "conv_bc_b")}
            if mod.every_head:     # the head vectors stay whole
                partial |= {pre + n for n in ("A_log", "D", "dt_bias")}
        elif isinstance(mod, XL.MLSTM) and mod.up.parallel == "col":
            mod.mesh = mesh
            mod.every_head = bool(cfg.n_heads % tp)
            # out_norm's gain is read by slices; wf (whole) by local heads,
            # and under every_head wi (whole) by every rank's columns
            partial |= _names(mod, pre, ("out_norm", "wf"))
            if mod.wi.parallel is None:
                partial |= _names(mod, pre, ("wi",))
        elif isinstance(mod, XL.SLSTM) and mod.w_z.parallel == "col":
            mod.mesh = mesh
            mod.every_head = bool(cfg.n_heads % tp)
    return partial


#: MLA's projections that the rule splits where ``model`` divides their
#: widths (the latent ``w_dkv`` / ``w_krope`` stay whole)
MLA_SPLIT = ("wq", "w_uk", "w_uv", "wo")


def _seq_partial(params: LMBase, cfg: ModelConfig, shard_of: dict) -> set:
    """The replicated parameters of the blocks that run on this rank's
    rows of a sequence-split stream (norm gains, row-parallel biases,
    whatever stays whole), and ``final_norm``'s but for the hybrid, whose
    stream is whole outside its shared block."""
    if cfg.family == "hybrid":
        blocks = [("shared_attn.", params.shared_attn)]
    else:
        blocks = [(f"{key}.{i}.", blk) for key, stack in params.stacks()
                  for i, blk in enumerate(stack)]
        blocks.append(("final_norm.", params.final_norm))
    return {pre + n for pre, mod in blocks for n, _ in mod.named_parameters()
            if not sharding.is_model_sharded(shard_of[pre + n])}


def _names(mod: nn.Module, pre: str, children: tuple) -> set:
    """The full names of the parameters of ``mod``'s ``children``."""
    return {f"{pre}{c}.{n}" for c in children
            for n, _ in getattr(mod, c).named_parameters()}


def _kv_select(cfg: ModelConfig, mesh: C.Mesh) -> list:
    """The KV head each of this rank's query heads reads (``model`` does
    not divide the KV heads, so the local query heads never cover whole
    groups: one KV head per query head)."""
    h_loc = cfg.n_heads // mesh.model_size()
    group = cfg.n_heads // cfg.n_kv_heads
    h0 = mesh.index(C.MODEL_AXIS) * h_loc
    return [(h0 + i) // group for i in range(h_loc)]


def cache_batch_axes(cfg: ModelConfig, caches: dict) -> dict:
    """The batch axis of every cache leaf: the same tree (dicts, lists,
    tuples) with an int per leaf.  Leaves stacked with one leading layer
    or group axis carry batch at 1 (every entry of the dense, MoE, VLM and
    encoder-decoder caches, and the hybrid's ``"attn"``); the hybrid's
    Mamba2 states, stacked ``(groups, attn_every, B, ...)``, at 2; the
    xLSTM's per-block states, unstacked, at 0.  Shape sniffing cannot tell
    a size-1 layer axis from a size-1 batch axis."""
    _check_family(cfg)

    def const(tree, ax: int):
        if isinstance(tree, dict):
            return {k: const(v, ax) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(const(v, ax) for v in tree)
        return ax
    if cfg.family == "hybrid":
        return {"mamba": const(caches["mamba"], 2),
                "attn": const(caches["attn"], 1)}
    return const(caches, 0 if cfg.family == "xlstm" else 1)
