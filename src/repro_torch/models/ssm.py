"""Mamba2 (SSD) blocks: the chunked matmul formulation.

The counterpart of the JAX package's ``models/ssm.py``.  Prefill runs the
chunked *state-space dual* algorithm: the within-chunk work is batched
einsums (quadratic in the chunk length only), the state carried across
chunks a short loop.  Decode is the O(1) recurrent update of a
(B, H, P, N) state, written in place.

The projections are :class:`~repro_torch.models.layers.NmcLinear` s holding
float weights, and :meth:`Mamba2.quantized` returns the module unchanged:
the reference's ``quantize_tree`` converts a ``{"w": ...}`` of two or three
dims only, and the hybrid LM stacks its Mamba2 weights four deep
``(groups, attn_every, d_in, d_out)``, so they stay float there.  Under
``w8a8`` the projections are therefore matmuls of the float weights in the
activation dtype, as in the reference.

A prompt longer than ``ssm_chunk`` must be a multiple of it: the reference
reshapes the sequence into whole chunks and fails otherwise, and the port
raises instead of padding.

On a mesh with a ``model`` axis (:func:`~repro_torch.models.lm.shard`) a
layer runs the rank's heads, which are independent: ``in_z`` / ``in_x``
column-parallel over the head-major ``d_inner``, ``conv_x`` split over
those channels, ``A_log`` / ``D`` / ``dt_bias`` over heads, ``out_proj``
row-parallel.  ``in_b``, ``in_c``, ``in_dt``, ``conv_bc`` and the gated
norm's gain stay whole: every rank projects B and C (shared by every
head) and all of ``dt``, of which it takes its heads' slice before the
softplus with its own ``dt_bias``.  The gated RMSNorm normalises by the
RMS over the whole ``d_inner``
(:func:`~repro_torch.models.layers.rms_norm_over_model`, which the
mLSTM's ``out_norm`` shares): each rank's sum of squares is summed over
``model`` in the forward and its gradient summed again in the backward
(each rank's output reads the global sum through its own slice only);
each rank scales by its slice of the gain.  The whole tensors read inside
the region (``in_b``, ``in_c``, ``in_dt``, ``conv_bc_*``, ``norm.g``)
get partial gradients, summed over ``model`` by the train step.

Where ``model`` does not divide the SSM heads (zamba2-smoke drawn with one
head of 128 on model 2), the rule still splits ``in_z`` / ``in_x`` /
``conv_x`` over ``d_inner`` and ``out_proj`` by rows, through a head, and
keeps ``A_log`` / ``D`` / ``dt_bias`` whole.  Such a layer runs every
head on every rank (``every_head``), as the mLSTM does: the convolved x
columns gathered into whole heads (``context.gather_to_heads``, whose
backward reduce-scatters), ``dt`` taken whole, the SSD on every head, and
each rank keeping the columns of ``y`` that its ``z`` slice, its slice of
the gated norm and its rows of ``out_proj`` meet; the whole head vectors'
gradients are then partial too.

Serving on such a mesh keeps each layer's state laid out by
``sharding.cache_shardings`` (the rule's longest dim over ``model``:
``conv_x``'s channels and the SSM state's heads at full width, where
they are the rank's own; ``conv_bc``'s channels, which every rank needs
whole; at a batch of one ``conv_x`` over the data axes and ``model``
together).  The decode step gathers each field to the layout it
computes in (:meth:`Mamba2.state_specs`: the SSM state over every head
under ``every_head``), steps it and writes this rank's slice back; the
prefill lays its final state out the same way.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import context as C
from repro_torch.distributed import sharding
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

#: the projections, in the reference's order of keys
PROJ_KEYS = ("in_z", "in_x", "in_b", "in_c", "in_dt")


def conv_full(w: torch.Tensor, b: torch.Tensor, u: torch.Tensor
              ) -> torch.Tensor:
    """Causal depthwise conv over (B, S, C) with taps ``w`` (k, C) and
    bias ``b`` (C,), then silu; in ``u``'s dtype."""
    k, s = w.shape[0], u.shape[1]
    w = w.to(u.dtype)
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu(out + b.to(u.dtype))


def conv_step(w: torch.Tensor, b: torch.Tensor, window: torch.Tensor
              ) -> torch.Tensor:
    """The conv at the newest position: window (B, k, C) -> (B, 1, C)."""
    w = w.to(window.dtype)
    return F.silu((window * w[None]).sum(dim=1, keepdim=True)
                  + b.to(window.dtype))


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int) -> tuple:
    """SSD over chunks.  xh: (B,S,H,P); dt: (B,S,H) (after softplus,
    float32); a: (H,) negative; b, c: (B,S,N) (one group, broadcast over
    heads).  Returns y (B,S,H,P) and the final state (B,H,P,N), both in
    ``xh``'s dtype; the decays and scores are formed in float32 and
    rounded to it, as the reference rounds them.  The gradient is the
    reference's wherever that is finite, and finite where a masked
    segment's exponential overflows (the reference's is NaN there)."""
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(
            f"ssd_chunked: a sequence of {s} is not a whole number of "
            f"chunks of {chunk} (the reference reshapes it into chunks and "
            f"fails the same way; a prompt longer than ssm_chunk must be a "
            f"multiple of it)")
    nc, q = s // chunk, chunk
    f32, dtype = torch.float32, xh.dtype
    xc = xh.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h).to(f32)
    bc = b.reshape(bsz, nc, q, n).to(f32)
    cc = c.reshape(bsz, nc, q, n).to(f32)
    cum = torch.cumsum(dtc * a.to(f32), dim=2)              # (B,nc,q,H)

    # within-chunk ("diagonal") term
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)            # (B,nc,q,q)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,q,q,H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=xh.device))
    # masked before the exp: the reference exponentiates first, and where a
    # masked (i < j) segment overflows its gradient is 0 * inf = NaN; the
    # values are the same bit for bit
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                      float("-inf")))
    scores = (cb[..., None] * decay * dtc[:, :, None, :, :]).to(dtype)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

    # per-chunk final states
    wj = (torch.exp(cum[:, :, -1:, :] - cum) * dtc).to(dtype)
    s_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchpn", wj, bc.to(dtype), xc)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B,nc,H)
    state = torch.zeros((bsz, h, p, n), dtype=dtype, device=xh.device)
    states_in = []
    for i in range(nc):
        states_in.append(state)
        state = state * chunk_decay[:, i, :, None, None].to(dtype) \
            + s_chunk[:, i]
    states_in = torch.stack(states_in, dim=1)               # (B,nc,H,P,N)

    # off-chunk contribution
    y_off = torch.einsum("bcin,bchpn,bcih->bcihp", cc.to(dtype), states_in,
                         torch.exp(cum).to(dtype))
    return (y_diag + y_off).reshape(bsz, s, h, p), state


class Mamba2(sharding.ServedState, nn.Module):
    """One Mamba2 layer: the z / x / B / C / dt projections, the causal
    depthwise convs over x (``conv_x``) and over B and C together
    (``conv_bc``), the SSD, the gated RMSNorm and ``out_proj``.  On a mesh
    ``mesh`` is set and the split tensors hold this rank's heads (module
    docstring)."""

    mesh: C.Mesh | None = None
    #: on a mesh whose ``model`` axis does not divide the SSM heads: every
    #: rank runs every head (module docstring)
    every_head: bool = False

    def __init__(self, proj: dict, conv_x_w: torch.Tensor,
                 conv_x_b: torch.Tensor, conv_bc_w: torch.Tensor,
                 conv_bc_b: torch.Tensor, a_log: torch.Tensor,
                 d: torch.Tensor, dt_bias: torch.Tensor, norm: L.RMSNorm,
                 out_proj: L.NmcLinear):
        super().__init__()
        for key in PROJ_KEYS:
            setattr(self, key, proj[key])
        for name, t in (("conv_x_w", conv_x_w), ("conv_x_b", conv_x_b),
                        ("conv_bc_w", conv_bc_w), ("conv_bc_b", conv_bc_b),
                        ("A_log", a_log), ("D", d), ("dt_bias", dt_bias)):
            self.register_parameter(name, L.param(t))
        # the gated norm takes rmsnorm's default eps, not cfg.norm_eps
        self.norm = norm
        self.out_proj = out_proj

    @classmethod
    def init(cls, gen: torch.Generator, cfg: ModelConfig,
             device=None) -> "Mamba2":
        """The reference's initialisation: normal / sqrt(d_in) linears,
        0.1-normal conv taps with zero biases, ``A_log = log(1..H)``,
        ``D = 1`` and ``dt_bias`` the inverse softplus of a dt drawn
        log-uniform in [0.001, 0.1]."""
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        widths = dict(zip(PROJ_KEYS, (di, di, n, n, h)))
        proj = {key: L.NmcLinear.init(gen, d, w, device=device)
                for key, w in widths.items()}

        def normal(shape, scale):
            return torch.randn(shape, generator=gen, device=device,
                               dtype=torch.float32) * scale
        conv_x_w = normal((cfg.ssm_conv, di), 0.1)
        conv_bc_w = normal((cfg.ssm_conv, 2 * n), 0.1)
        u = torch.rand((h,), generator=gen, device=device,
                       dtype=torch.float32)
        lo, hi = math.log(0.001), math.log(0.1)
        dt_bias = torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo)))
        out_proj = L.NmcLinear.init(gen, di, d, device=device)
        zeros = {"device": device, "dtype": torch.float32}
        return cls(proj, conv_x_w, torch.zeros(di, **zeros), conv_bc_w,
                   torch.zeros(2 * n, **zeros),
                   torch.log(torch.arange(1, h + 1, **zeros)),
                   torch.ones(h, **zeros), dt_bias,
                   L.RMSNorm.init(di, device=device), out_proj)

    def quantized(self) -> "Mamba2":
        """Unchanged: the reference leaves the hybrid's Mamba2 weights
        float (module docstring)."""
        return self

    def _proj(self, x: torch.Tensor, cfg: ModelConfig) -> tuple:
        return tuple(getattr(self, key)(x, nmc_mode=cfg.nmc_mode)
                     for key in PROJ_KEYS)

    def _gated_out(self, y: torch.Tensor, z: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
        """The gated norm and ``out_proj`` of y (..., d_inner); under
        ``every_head`` y holds every head and this rank takes the columns
        of its slice ``z``."""
        if self.every_head:
            n = z.shape[-1]
            y = y.narrow(-1, self.mesh.index(C.MODEL_AXIS) * n, n)
        u = y * F.silu(z)
        # on a mesh, the RMS over the whole d_inner
        normed = self.norm(u) if self.mesh is None \
            else L.rms_norm_over_model(u, self.norm, self.mesh)
        return self.out_proj(normed, nmc_mode=cfg.nmc_mode)

    def _local_heads(self, dt: torch.Tensor) -> torch.Tensor:
        """This rank's heads of the whole ``dt`` projection (all of it off
        a mesh and under ``every_head``)."""
        h = self.A_log.shape[0]
        if self.mesh is None or self.every_head:
            return dt
        return dt.narrow(-1, self.mesh.index(C.MODEL_AXIS) * h, h)

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
        """Full sequence (train / prefill).  x: (B, S, D).  With
        ``return_state`` also the state after the last position:
        ``{"ssm": (B,H,P,N), "conv_x": (B,k-1,d_inner), "conv_bc":
        (B,k-1,2N)}`` (the convs' last k - 1 raw inputs)."""
        bsz, s, _ = x.shape
        n, pdim = cfg.ssm_state, cfg.ssm_head_dim
        if self.mesh is not None:
            x = C.copy_to_model(x, self.mesh)
        z, xs_raw, bm_raw, cm_raw, dt = self._proj(x, cfg)
        bc_raw = torch.cat([bm_raw, cm_raw], dim=-1)
        xs = C.gather_to_heads_if(
            conv_full(self.conv_x_w, self.conv_x_b, xs_raw), self.mesh,
            self.every_head)
        bc = conv_full(self.conv_bc_w, self.conv_bc_b, bc_raw)
        dt = F.softplus(self._local_heads(dt).float() + self.dt_bias)
        xh = xs.reshape(bsz, s, -1, pdim)
        y, state = ssd_chunked(xh, dt, -torch.exp(self.A_log), bc[..., :n],
                               bc[..., n:], min(cfg.ssm_chunk, s))
        y = y + self.D.to(y.dtype)[None, None, :, None] * xh
        out = self._gated_out(y.reshape(bsz, s, -1), z, cfg)
        if not return_state:
            return out
        k = cfg.ssm_conv - 1
        return out, {"ssm": state, "conv_x": xs_raw[:, -k:],
                     "conv_bc": bc_raw[:, -k:]}

    def state_specs(self, batch_part) -> dict:
        """One layer's state as this rank computes it, by field: the SSM
        state over its heads (every head under ``every_head``) and
        ``conv_x`` over its channels on a mesh (tensor parallelism's
        slices), ``conv_bc`` whole (B and C are shared by every head); the
        batch dim as ``batch_part``."""
        split = C.MODEL_AXIS if self.mesh is not None else None
        heads = None if self.every_head else split
        return {"ssm": (batch_part, heads, None, None),
                "conv_x": (batch_part, None, split),
                "conv_bc": (batch_part, None, None)}

    def decode_step(self, x: torch.Tensor, cfg: ModelConfig, state: dict,
                    state_sh: dict | None = None) -> torch.Tensor:
        """One token.  x: (B, 1, D); ``state`` (:func:`state_init`'s
        fields) is updated in place.  ``state_sh``: on a mesh, the
        state's layout ({field: Sharding}): each field is gathered to
        :meth:`state_specs`, stepped, and this rank's slice written back.
        Returns (B, 1, D)."""
        z, xs_raw, bm_raw, cm_raw, dt = self._proj(x, cfg)
        work = self.gathered(state, state_sh)
        y = self.recurrent_step(xs_raw, torch.cat([bm_raw, cm_raw], dim=-1),
                                self._local_heads(dt), cfg, work)
        self.write_back(state, work, state_sh)
        return self._gated_out(y, z, cfg)

    def recurrent_step(self, xs_raw: torch.Tensor, bc_raw: torch.Tensor,
                       dt: torch.Tensor, cfg: ModelConfig,
                       state: dict) -> torch.Tensor:
        """The convs at the newest position and the O(1) SSD update from
        the projections of one token (B, 1, ...): the state and the convs'
        windows written in place; returns y (B, 1, d_inner) before the
        gated norm (this rank's heads and channels on a mesh: ``dt``
        holds its heads; every head under ``every_head``, the convolved x
        gathered)."""
        bsz = xs_raw.shape[0]
        n, pdim = cfg.ssm_state, cfg.ssm_head_dim
        win_x = torch.cat([state["conv_x"].to(xs_raw.dtype), xs_raw], dim=1)
        win_bc = torch.cat([state["conv_bc"].to(bc_raw.dtype), bc_raw],
                           dim=1)
        xs = C.gather_to_heads_if(
            conv_step(self.conv_x_w, self.conv_x_b, win_x), self.mesh,
            self.every_head)
        bc = conv_step(self.conv_bc_w, self.conv_bc_b, win_bc)
        bm, cm = bc[:, 0, :n], bc[:, 0, n:]
        dt = F.softplus(dt.float() + self.dt_bias)[:, 0]          # (B,H)
        da = torch.exp(dt * -torch.exp(self.A_log))               # (B,H)
        xh = xs.reshape(bsz, -1, pdim)
        dbx = torch.einsum("bh,bn,bhp->bhpn", dt.to(xh.dtype), bm, xh)
        ssm = state["ssm"]
        s_new = ssm * da[..., None, None].to(ssm.dtype) + dbx
        y = torch.einsum("bhpn,bn->bhp", s_new, cm)
        y = y + self.D.to(y.dtype)[None, :, None] * xh
        ssm.copy_(s_new)
        state["conv_x"].copy_(win_x[:, 1:])
        state["conv_bc"].copy_(win_bc[:, 1:])
        return y.reshape(bsz, 1, -1)


def state_shapes(cfg: ModelConfig, batch: int,
                 dtype=torch.bfloat16) -> dict:
    """One layer's state fields as ``{field: (shape, dtype)}``: ``ssm``
    (B,H,P,N) and the convs' windows."""
    k = cfg.ssm_conv - 1
    return {"ssm": ((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state), dtype),
            "conv_x": ((batch, k, cfg.d_inner), dtype),
            "conv_bc": ((batch, k, 2 * cfg.ssm_state), dtype)}


def state_init(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """One layer's zero state (:func:`state_shapes`)."""
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in state_shapes(cfg, batch, dtype).items()}
