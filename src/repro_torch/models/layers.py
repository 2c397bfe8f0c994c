"""Core layers: norms, embeddings, RoPE, (NMC-quantizable) linears, MLPs.

The counterpart of the JAX package's ``models/layers.py``.  Each layer is an
``nn.Module`` holding its float weights (linears, norm gains, biases,
embeddings) as ``nn.Parameter`` s, which the train step differentiates
and updates; the int8 serving form (``w_q`` and its ``scale``) is held as
buffers.  The configuration's run-time knobs (``nmc_mode``) are passed at
call time, as the reference passes them, so one set of weights serves
every mode.

The paper's technique surfaces here as :class:`NmcLinear`'s modes:
  * ``none``  — dense matmul in the activation dtype (baseline)
  * ``w8``    — int8 weights dequantized on the fly
  * ``w8a8``  — int8 x int8 -> int32 with the fused dequant epilogue (the
                NM-Carus vmacc loop; the CUDA ``nmc_matmul`` kernel on the
                card)

Tensor parallelism is written out where the reference leaves it to
GSPMD: :func:`~repro_torch.models.lm.shard` gives a linear its
``parallel`` kind on a mesh with a ``model`` axis, ``"col"`` (the local
slice of the output columns, the bias sliced with them) or ``"row"`` (the
local slice of the input rows; the partial products summed over ``model``,
then the bias added once), an :class:`MLP` its mesh (the region's input
enters through ``copy_to_model``), and an :class:`Embedding` its
vocabulary range (vocab-parallel: the local rows looked up, zero
elsewhere, summed over ``model``).  The reference's ``shard_hidden`` and
``shard_batch_only`` steer GSPMD toward that layout; with the layout
explicit they are no-ops here.

Sequence parallelism (``cfg.seq_parallel``, the reference's
``shard_seq``): where :func:`seq_split` holds, the residual stream between
the model-parallel regions holds this rank's rows of the sequence
(:func:`shard_seq`); with ``sp=True`` a region is entered with
:func:`~repro_torch.distributed.context.gather_from_seq` instead of
``copy_to_model`` (``MLP`` and the attentions) and left with
``reduce_scatter_to_seq`` instead of the all-reduce (a row-parallel
linear; its bias then added once, on the local rows), both chosen by
``context.enter_region`` / ``leave_region``.
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

from repro_torch.distributed import context as C
from repro_torch.kernels import ops
from repro_torch.kernels import ref


def shard_hidden(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """A layout hint to GSPMD in the reference; the port's layout is
    explicit, so ``x`` as it is."""
    return x


def shard_batch_only(x: torch.Tensor) -> torch.Tensor:
    """A layout hint to GSPMD in the reference; ``x`` as it is."""
    return x


def seq_split(x: torch.Tensor, mesh: C.Mesh | None) -> bool:
    """Whether ``shard_seq`` splits ``x`` on ``mesh``: the reference's
    rule, false with no mesh, no ``model`` axis over 1, ``x.ndim < 3`` or
    a sequence (dim 1) that ``model`` does not divide."""
    return mesh is not None and mesh.model_size() > 1 and x.dim() >= 3 \
        and x.shape[1] % mesh.model_size() == 0


def shard_seq(x: torch.Tensor, mesh: C.Mesh | None) -> torch.Tensor:
    """The sequence-parallel residual stream: this rank's rows of ``x`` on
    dim 1 where :func:`seq_split` holds, ``x`` as it is elsewhere."""
    return C.split_to_seq(x, mesh) if seq_split(x, mesh) else x


def param(t: torch.Tensor | None) -> nn.Parameter | None:
    """``t`` as a trainable parameter sharing its storage (None stays
    None, a parameter stays itself: a quantized copy shares the float
    module's biases and gains)."""
    if t is None or isinstance(t, nn.Parameter):
        return t
    return nn.Parameter(t)


def _init_dense(gen: torch.Generator, shape: tuple, device,
                scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * scale


# ---------------------------------------------------------------------------
# Linear (+ NMC quantized execution)
# ---------------------------------------------------------------------------

class NmcLinear(nn.Module):
    """``y = act(x @ W + b)``.  Holds either a float weight ``w`` (d_in,
    d_out) or its int8 serving form ``w_q`` with a per-output-channel
    ``scale``; ``b`` is optional either way.  On a mesh, ``parallel`` is
    ``"col"`` or ``"row"`` (module docstring) and ``mesh`` the mesh;
    ``amax_axes`` the axes over which the W8A8 activation scale's absolute
    maximum is taken, on ``amax_mesh``."""

    parallel: str | None = None
    mesh: C.Mesh | None = None
    amax_axes: tuple = ()
    amax_mesh: C.Mesh | None = None

    def __init__(self, w: torch.Tensor | None = None,
                 b: torch.Tensor | None = None, *,
                 w_q: torch.Tensor | None = None,
                 scale: torch.Tensor | None = None):
        super().__init__()
        if (w is None) == (w_q is None) or (w_q is None) != (scale is None):
            raise ValueError("NmcLinear holds either w, or w_q and scale")
        self.register_parameter("w", param(w))
        self.register_buffer("w_q", w_q)
        self.register_buffer("scale", scale)
        self.register_parameter("b", param(b))

    @classmethod
    def init(cls, gen: torch.Generator, d_in: int, d_out: int,
             bias: bool = False, device=None) -> "NmcLinear":
        b = torch.zeros(d_out, device=device) if bias else None
        return cls(_init_dense(gen, (d_in, d_out), device), b)

    @torch.no_grad()
    def quantized(self) -> "NmcLinear":
        """The NMC (int8) serving form of this linear.  A linear laid out
        on a mesh refuses: its per-output-channel scales span the whole
        input dim, so the full weights are quantized first and then laid
        out (``lm.shard`` slices ``w_q`` and ``scale``)."""
        if self.parallel is not None or self.amax_mesh is not None:
            raise NotImplementedError(
                "quantize the full model, then lm.shard it: a laid-out "
                "linear's per-output-channel scales would cover its slice "
                "only")
        if self.w_q is not None:
            return self
        wq, s = ref.quantize_rowwise(self.w, axis=0)
        return NmcLinear(b=self.b, w_q=wq, scale=s)

    def float_weight(self) -> torch.Tensor:
        """The (d_in, d_out) weight in float32: ``w``, or ``w_q`` times its
        per-output-channel scale (not rounded to an activation dtype; MLA's
        absorbed decode reads ``W_uk`` / ``W_uv`` so)."""
        if self.w_q is None:
            return self.w.float()
        return self.w_q.float() * self.scale.float()[None, :]

    def forward(self, x: torch.Tensor, *, nmc_mode: str = "none",
                act: str = "none", dtype=None,
                sp: bool = False) -> torch.Tensor:
        """Any leading batch dims; contraction over the last.  A
        row-parallel linear with ``sp`` leaves its region onto a
        sequence-split stream: x (B, S, d_in / model) -> (B, S / model,
        d_out)."""
        dtype = dtype or x.dtype
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if self.w_q is not None:
            if nmc_mode == "w8a8":
                return self._w8a8(x2, act, dtype, sp).reshape(*lead, -1)
            # w8: dequantize the weights, matmul in the activation dtype
            w = self.w_q.to(dtype) * self.scale.to(dtype)[None, :]
        else:
            w = self.w.to(dtype)
        y = (x2.to(dtype) @ w).reshape(*lead, -1)
        if self.parallel == "row":
            y = C.leave_region(y, self.mesh, sp)
        if self.b is not None:
            y = y + self.b.to(dtype)
        return ref.apply_act(y, act).to(dtype)

    def _w8a8(self, x2: torch.Tensor, act: str, dtype,
              sp: bool) -> torch.Tensor:
        """x2 (M, d_in) through ``nmc_matmul``.  The activation scale is
        one per tensor, as the reference's over the whole logical x: the
        absolute maximum over ``amax_axes`` (the data axes that split the
        rows, ``model`` where it splits the contraction).  Row-parallel:
        the kernel's raw int32 accumulator over the local K slice, summed
        exactly over ``model`` (the single-rank accumulator bit for bit),
        then the epilogue once, bias and ``act`` included."""
        amax = torch.amax(x2.abs())
        if self.amax_axes:
            amax = C.all_max(amax.float(), self.amax_axes,
                             self.amax_mesh).to(amax.dtype)
        xq, sx = ref.quantize_dynamic(x2, amax)
        if self.parallel != "row":
            return ops.nmc_matmul(xq, self.w_q, self.scale * sx, self.b,
                                  act=act, out_dtype=dtype)
        if sp:
            raise NotImplementedError("a W8A8 row-parallel linear leaves "
                                      "its region onto the whole stream")
        acc = C.sum_exact(ops.nmc_matmul(xq, self.w_q, None,
                                         out_dtype=torch.int32),
                          C.MODEL_AXIS, self.mesh)
        return ref.epilogue(acc, self.scale * sx, self.b, act, dtype)


def quantize_expert_bank(w: torch.Tensor) -> tuple:
    """(..., E, d_in, d_out) expert weights -> int8 + a per-(expert, out)
    scale ``max(amax, 1e-8) / 127``."""
    amax = w.abs().amax(dim=-2)                             # (..., E, d_out)
    s = torch.clamp_min(amax, 1e-8) / 127.0
    wq = torch.clamp(torch.round(w / s[..., None, :]), -127, 127)
    return wq.to(torch.int8), s


@torch.no_grad()
def quantize_tree(module: nn.Module) -> nn.Module:
    """A copy of ``module`` with every :class:`NmcLinear` and every MoE
    expert bank in its int8 NMC form: each module with a ``quantized()``
    method supplies its own (the MoE keeps its router in float, as the
    reference does).  Norm gains, embeddings and biases are shared with
    the original, untouched (the paper never quantizes accumulators or
    normalization state); the original keeps its float weights."""
    if hasattr(module, "quantized"):
        return module.quantized()
    new = copy.copy(module)
    new._buffers = dict(module._buffers)
    new._parameters = dict(module._parameters)
    new._modules = {name: quantize_tree(child)
                    for name, child in module._modules.items()}
    return new


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, g: torch.Tensor, eps: float = 1e-5):
        super().__init__()
        self.register_parameter("g", param(g))
        self.eps = eps

    @classmethod
    def init(cls, d: int, eps: float = 1e-5, device=None) -> "RMSNorm":
        return cls(torch.ones(d, device=device), eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.g).to(x.dtype)


def rms_norm_over_model(u: torch.Tensor, norm: RMSNorm,
                        mesh: C.Mesh) -> torch.Tensor:
    """``norm`` over a feature dim of which this rank holds its contiguous
    slice (``u``'s last dim): the local sums of squares summed over
    ``model`` in the forward and their gradient summed again in the
    backward, divided by the whole width, times this rank's slice of
    ``norm.g`` (whose gradient is then partial over ``model``)."""
    uf = u.float()
    ss = C.copy_to_model(C.reduce_from_model(
        (uf * uf).sum(dim=-1, keepdim=True), mesh), mesh)
    n = u.shape[-1]
    g = norm.g.narrow(0, mesh.index(C.MODEL_AXIS) * n, n)
    return (uf * torch.rsqrt(ss / (n * mesh.model_size()) + norm.eps)
            * g).to(u.dtype)


class LayerNorm(nn.Module):
    """Gain ``g`` and bias ``b``, computed in float32 and cast back."""

    def __init__(self, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
        super().__init__()
        self.register_parameter("g", param(g))
        self.register_parameter("b", param(b))
        self.eps = eps

    @classmethod
    def init(cls, d: int, eps: float = 1e-5, device=None) -> "LayerNorm":
        return cls(torch.ones(d, device=device),
                   torch.zeros(d, device=device), eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        return ((xf - mu) * torch.rsqrt(var + self.eps) * self.g
                + self.b).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_table(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """cos/sin tables for given positions: (..., dim/2)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (S, D/2) or broadcastable."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    if cos.dim() == 2:                      # (S, D/2) -> (S, 1, D/2)
        cos, sin = cos[:, None, :], sin[:, None, :]
    rot1 = x1 * cos - x2 * sin
    rot2 = x2 * cos + x1 * sin
    return torch.cat([rot1, rot2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """A (vocab, d) table; vocab-parallel on a mesh: ``vocab_offset`` is
    the first row of the local slice and ``mesh`` the mesh."""

    vocab_offset: int | None = None
    mesh: C.Mesh | None = None

    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.register_parameter("table", param(table))

    @classmethod
    def init(cls, gen: torch.Generator, vocab: int, d: int,
             device=None) -> "Embedding":
        return cls(_init_dense(gen, (vocab, d), device, scale=0.02))

    def forward(self, ids: torch.Tensor, dtype=torch.bfloat16):
        if self.vocab_offset is None:
            return self.table[ids].to(dtype)
        n = self.table.shape[0]
        local = ids - self.vocab_offset
        hit = (local >= 0) & (local < n)
        rows = self.table[local.clamp(0, n - 1)] * hit[..., None]
        return C.reduce_from_model(rows, self.mesh).to(dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """Gated (SwiGLU, with ``wg``) or plain two-layer MLP; tensor-parallel
    on a mesh (``wi`` / ``wg`` column-, ``wo`` row-parallel)."""

    mesh: C.Mesh | None = None

    def __init__(self, wi: NmcLinear, wo: NmcLinear,
                 wg: NmcLinear | None = None):
        super().__init__()
        self.wi, self.wo, self.wg = wi, wo, wg

    @classmethod
    def init(cls, gen: torch.Generator, d: int, d_ff: int,
             act: str = "silu", device=None) -> "MLP":
        wi = NmcLinear.init(gen, d, d_ff, device=device)
        wg = NmcLinear.init(gen, d, d_ff, device=device) \
            if act == "silu" else None
        return cls(wi, NmcLinear.init(gen, d_ff, d, device=device), wg)

    def forward(self, x: torch.Tensor, act: str = "silu",
                nmc_mode: str = "none", sp: bool = False) -> torch.Tensor:
        """``sp``: x is this rank's rows of a sequence-split stream, and so
        is the output."""
        if self.mesh is not None:
            x = C.enter_region(x, self.mesh, sp)
        if self.wg is not None:
            h = self.wi(x, nmc_mode=nmc_mode) * \
                self.wg(x, nmc_mode=nmc_mode, act="silu")
        else:
            h = self.wi(x, nmc_mode=nmc_mode, act=act)
        return self.wo(h, nmc_mode=nmc_mode, sp=sp)
