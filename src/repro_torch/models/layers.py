"""Core layers: norms, embeddings, RoPE, (NMC-quantizable) linears, MLPs.

The counterpart of the JAX package's ``models/layers.py``.  Each layer is an
``nn.Module`` holding its weights as buffers (the port serves, it does not
train yet); the configuration's run-time knobs (``nmc_mode``) are passed
at call time, as the reference passes them, so one set of weights serves
every mode.

The paper's technique surfaces here as :class:`NmcLinear`'s modes:
  * ``none``  — dense matmul in the activation dtype (baseline)
  * ``w8``    — int8 weights dequantized on the fly
  * ``w8a8``  — int8 x int8 -> int32 with the fused dequant epilogue (the
                NM-Carus vmacc loop; the CUDA ``nmc_matmul`` kernel on the
                card)

The reference's ``shard_*`` helpers are no-ops without a device mesh and
wait for the scale-out slice of the port.
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels import ref


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
    ``scale``; ``b`` is optional either way."""

    def __init__(self, w: torch.Tensor | None = None,
                 b: torch.Tensor | None = None, *,
                 w_q: torch.Tensor | None = None,
                 scale: torch.Tensor | None = None):
        super().__init__()
        if (w is None) == (w_q is None) or (w_q is None) != (scale is None):
            raise ValueError("NmcLinear holds either w, or w_q and scale")
        self.register_buffer("w", w)
        self.register_buffer("w_q", w_q)
        self.register_buffer("scale", scale)
        self.register_buffer("b", b)

    @classmethod
    def init(cls, gen: torch.Generator, d_in: int, d_out: int,
             bias: bool = False, device=None) -> "NmcLinear":
        b = torch.zeros(d_out, device=device) if bias else None
        return cls(_init_dense(gen, (d_in, d_out), device), b)

    def quantized(self) -> "NmcLinear":
        """The NMC (int8) serving form of this linear."""
        if self.w_q is not None:
            return self
        wq, s = ref.quantize_rowwise(self.w, axis=0)
        return NmcLinear(b=self.b, w_q=wq, scale=s)

    def forward(self, x: torch.Tensor, *, nmc_mode: str = "none",
                act: str = "none", dtype=None) -> torch.Tensor:
        """Any leading batch dims; contraction over the last."""
        dtype = dtype or x.dtype
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if self.w_q is not None:
            if nmc_mode == "w8a8":
                xq, sx = ref.quantize_dynamic(x2)
                y = ops.nmc_matmul(xq, self.w_q, self.scale * sx, self.b,
                                   act=act, out_dtype=dtype)
                return y.reshape(*lead, -1)
            # w8: dequantize the weights, matmul in the activation dtype
            w = self.w_q.to(dtype) * self.scale.to(dtype)[None, :]
        else:
            w = self.w.to(dtype)
        y = x2.to(dtype) @ w
        if self.b is not None:
            y = y + self.b.to(dtype)
        return ref.apply_act(y, act).to(dtype).reshape(*lead, -1)


def quantize_tree(module: nn.Module) -> nn.Module:
    """A copy of ``module`` with every :class:`NmcLinear` in its int8 NMC
    form.  Norm gains, embeddings and biases are shared with the original,
    untouched (the paper never quantizes accumulators or normalization
    state); the original keeps its float weights."""
    if isinstance(module, NmcLinear):
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
        self.register_buffer("g", g)
        self.eps = eps

    @classmethod
    def init(cls, d: int, eps: float = 1e-5, device=None) -> "RMSNorm":
        return cls(torch.ones(d, device=device), eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.g).to(x.dtype)


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
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.register_buffer("table", table)

    @classmethod
    def init(cls, gen: torch.Generator, vocab: int, d: int,
             device=None) -> "Embedding":
        return cls(_init_dense(gen, (vocab, d), device, scale=0.02))

    def forward(self, ids: torch.Tensor, dtype=torch.bfloat16):
        return self.table[ids].to(dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """Gated (SwiGLU, with ``wg``) or plain two-layer MLP."""

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
                nmc_mode: str = "none") -> torch.Tensor:
        if self.wg is not None:
            h = self.wi(x, nmc_mode=nmc_mode) * \
                self.wg(x, nmc_mode=nmc_mode, act="silu")
        else:
            h = self.wi(x, nmc_mode=nmc_mode, act=act)
        return self.wo(h, nmc_mode=nmc_mode)
