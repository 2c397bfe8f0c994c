"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar
memory, a loop over time), following Beck et al. 2024 (arXiv:2405.04517).

The counterpart of the JAX package's ``models/xlstm.py``.  mLSTM prefills
in chunks: within a chunk a causal, log-gate-decayed attention (einsums
quadratic in the chunk length), across chunks the carried matrix memory
``(C, n, m)`` in a short loop; decode is one O(1) update.  sLSTM's gates
read the previous hidden state through block-diagonal recurrent weights,
so it runs step by step at prefill too.  Both use exponential gating with
the max-stabilizer state ``m``, and every state is float32 whatever the
activation dtype.

The projections are :class:`~repro_torch.models.layers.NmcLinear` s
holding float weights, and both blocks' ``quantized()`` return the block
unchanged: the reference's ``quantize_tree`` recurses into dicts only and
the xLSTM LM keeps its blocks in a list, so under ``w8a8`` only the LM
head becomes int8 and every block projection is a matmul of the float
weights in the activation dtype, as in the reference.  The gate
projections (mLSTM's ``wi`` / ``wf``, sLSTM's ``w_*``) ignore ``nmc_mode``
there too.

A prompt longer than ``ssm_chunk`` must be a multiple of it: the reference
reshapes the sequence into whole chunks and fails otherwise, and the port
raises instead of padding.

On a mesh with a ``model`` axis (:func:`~repro_torch.models.lm.shard`)
both blocks run the rank's heads, every split tensor holding the rule's
contiguous slice.  mLSTM: ``up`` / ``up_gate`` / ``wq`` / ``wk`` / ``wv``
column-parallel over the head-major ``d_i``, ``wi`` over the heads,
``wf`` whole (the rule replicates it; each rank keeps its heads' gates),
``down`` row-parallel; ``u`` is gathered over ``model`` because the
q / k / v and gate projections contract over the whole ``d_i``, and
``out_norm`` takes the RMS over the whole ``d_i``
(:func:`~repro_torch.models.layers.rms_norm_over_model`).  sLSTM: ``w_*``
column-parallel over the head-major ``d``, ``r_*`` split over heads, the
time loop on the local heads with no collective inside it, its hidden
states gathered before the residual; the FFN follows the layout of its
``up`` and ``down`` (``fix_divisibility`` may keep either whole).

Where ``model`` does not divide the heads (xlstm-125m's 4 on model 8:
half a head a rank), the rule still splits the column-parallel
projections through a head, and keeps ``wi`` and ``r_*`` (split over
heads) whole.  Both blocks then run every head on every rank
(``every_head``).  mLSTM: the column slices of q / k / v are gathered
over ``model`` into whole heads (``context.gather_to_heads``: each rank
keeps other columns of the output, so the gradient is reduce-scattered),
the gates of every head come from the whole ``wi`` / ``wf`` (both
gradients partial), the matrix memory runs on every head, and each rank
keeps its columns of the result for ``out_norm`` and the row-parallel
``down``.  sLSTM: the gates' column slices are gathered into every head
(``context.gather_from_model``: everything after the loop is the same on
every rank, so each rank's gradient is whole) and the time loop runs on
every head with the whole ``r_*``, its hidden states whole on every rank.
Their states are computed whole (``state_specs``).

Serving on such a mesh keeps each block's state laid out by
``sharding.cache_shardings`` (the rule's longest dim over ``model``: an
mLSTM's ``C`` and ``n`` over their first key dim P, not the heads, its
``m`` over the heads; an sLSTM state over its ``d_model`` channels, the
rank's own heads' at a batch over 1; at a batch of one over the data
axes and ``model`` together).  Each block computes in its heads
(:meth:`MLSTM.state_specs`, :meth:`SLSTM.state_specs`): the decode step
gathers each state to that layout, steps it and writes this rank's slice
back, as ``Mamba2`` does; the prefill lays its final state out the same
way (``laid_out``).
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

#: the running max's initial value (the reference's ``m0``)
M0 = -1e30

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_i: torch.Tensor, log_f: torch.Tensor,
                  chunk: int) -> tuple:
    """q, k, v: (B,S,H,P); log_i, log_f: (B,S,H) float32.  The stabilized
    chunkwise mLSTM from a zero state: y (B,S,H,P) in ``q``'s dtype and the
    final ``(C, n, m)``, (B,H,P,P), (B,H,P), (B,H), float32."""
    bsz, s, h, p = q.shape
    if s % chunk:
        raise ValueError(
            f"mlstm_chunked: a sequence of {s} is not a whole number of "
            f"chunks of {chunk} (the reference reshapes it into chunks and "
            f"fails the same way; a prompt longer than ssm_chunk must be a "
            f"multiple of it)")
    nc, f32 = s // chunk, torch.float32
    qc = q.reshape(bsz, nc, chunk, h, p).to(f32)
    kc = k.reshape(bsz, nc, chunk, h, p).to(f32) / math.sqrt(p)
    vc = v.reshape(bsz, nc, chunk, h, p).to(f32)
    li = log_i.reshape(bsz, nc, chunk, h).to(f32)
    cum_f = torch.cumsum(log_f.reshape(bsz, nc, chunk, h).to(f32), dim=2)
    total_f = cum_f[:, :, -1, :]                            # (B,nc,H)
    # within-chunk log weights D[i, j] = cum_f_i - cum_f_j + li_j, j <= i
    dmat = cum_f[:, :, :, None, :] - cum_f[:, :, None, :, :] \
        + li[:, :, None, :, :]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))
    dmat = dmat.masked_fill(~causal[None, None, :, :, None], -math.inf)

    C = torch.zeros((bsz, h, p, p), dtype=f32, device=q.device)
    n = torch.zeros((bsz, h, p), dtype=f32, device=q.device)
    m = torch.full((bsz, h), M0, dtype=f32, device=q.device)
    ys = []
    for c in range(nc):
        qb, kb, vb = qc[:, c], kc[:, c], vc[:, c]
        cfb, tfb = cum_f[:, c], total_f[:, c]
        a_j = tfb[:, None, :] - cfb + li[:, c]              # (B,q,H)
        m_new = torch.maximum(tfb + m, a_j.amax(dim=1))     # (B,H)
        inter_w = torch.exp(cfb + m[:, None, :] - m_new[:, None, :])
        y_inter = torch.einsum("bqhp,bhpo->bqho", qb, C) * inter_w[..., None]
        n_inter = torch.einsum("bqhp,bhp->bqh", qb, n) * inter_w
        w_intra = torch.exp(dmat[:, c] - m_new[:, None, None, :])
        sw = torch.einsum("bqhp,bjhp->bqjh", qb, kb) * w_intra
        y_intra = torch.einsum("bqjh,bjhp->bqhp", sw, vb)
        n_intra = sw.sum(dim=2)
        denom = torch.maximum((n_inter + n_intra).abs(),
                              torch.exp(-m_new)[:, None, :]) + 1e-6
        ys.append((y_inter + y_intra) / denom[..., None])
        # the state carried to the chunk's end
        upd_w = torch.exp(a_j - m_new[:, None, :])          # (B,q,H)
        decay = torch.exp(tfb + m - m_new)                   # (B,H)
        C = C * decay[:, :, None, None] + \
            torch.einsum("bqhp,bqho->bhpo", kb * upd_w[..., None], vb)
        n = n * decay[:, :, None] + torch.einsum("bqh,bqhp->bhp", upd_w, kb)
        m = m_new
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, p)
    return y.to(q.dtype), (C, n, m)


def mlstm_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_i: torch.Tensor, log_f: torch.Tensor,
               state: tuple) -> torch.Tensor:
    """One token.  q, k, v: (B,H,P); gates (B,H) float32; ``state`` ``(C,
    n, m)`` is updated in place.  Returns y (B,H,P) in ``q``'s dtype."""
    C, n, m = state
    f32 = torch.float32
    kf = k.to(f32) / math.sqrt(q.shape[-1])
    qf = q.to(f32)
    m_new = torch.maximum(log_f + m, log_i)
    decay = torch.exp(log_f + m - m_new)
    gain = torch.exp(log_i - m_new)
    C_new = C * decay[..., None, None] + gain[..., None, None] * \
        torch.einsum("bhp,bho->bhpo", kf, v.to(f32))
    n_new = n * decay[..., None] + gain[..., None] * kf
    num = torch.einsum("bhp,bhpo->bho", qf, C_new)
    den = torch.einsum("bhp,bhp->bh", qf, n_new).abs()
    den = torch.maximum(den, torch.exp(-m_new)) + 1e-6
    C.copy_(C_new)
    n.copy_(n_new)
    m.copy_(m_new)
    return (num / den[..., None]).to(q.dtype)


def mlstm_head_dim(cfg: ModelConfig) -> int:
    """P = d_i / n_heads, the same on every rank of a mesh."""
    return int(cfg.d_model * cfg.proj_factor_mlstm) // cfg.n_heads


class MLSTM(sharding.ServedState, nn.Module):
    """One mLSTM block: RMSNorm, the up projection ``up`` and its silu gate
    ``up_gate`` (d -> d_i = d * proj_factor_mlstm), q / k / v (d_i -> d_i),
    the per-head input and forget gates ``wi`` / ``wf`` (d_i -> H), the
    matrix memory, ``out_norm`` and ``down`` (d_i -> d), a residual
    around it all.  On a mesh ``mesh`` is set (module docstring)."""

    KEYS = ("up", "up_gate", "wq", "wk", "wv", "wi", "wf", "down")
    mesh: C.Mesh | None = None
    #: on a mesh whose ``model`` axis does not divide the heads: every
    #: rank runs every head (module docstring)
    every_head: bool = False

    def __init__(self, norm: L.RMSNorm, lin: dict, out_norm: L.RMSNorm):
        super().__init__()
        self.norm = norm
        for key in self.KEYS:
            setattr(self, key, lin[key])
        self.out_norm = out_norm

    @classmethod
    def init(cls, gen: torch.Generator, cfg: ModelConfig,
             device=None) -> "MLSTM":
        d, h = cfg.d_model, cfg.n_heads
        di = int(d * cfg.proj_factor_mlstm)
        widths = {"up": (d, di), "up_gate": (d, di), "wq": (di, di),
                  "wk": (di, di), "wv": (di, di), "wi": (di, h),
                  "wf": (di, h), "down": (di, d)}
        lin = {key: L.NmcLinear.init(gen, *widths[key], device=device)
               for key in cls.KEYS}
        return cls(L.RMSNorm.init(d, cfg.norm_eps, device), lin,
                   L.RMSNorm.init(di, cfg.norm_eps, device))

    def quantized(self) -> "MLSTM":
        """Unchanged: the reference leaves the xLSTM blocks float (module
        docstring)."""
        return self

    def _proj(self, x: torch.Tensor, cfg: ModelConfig) -> tuple:
        """(g, q, k, v, log_i, log_f): the silu gate (B,S,d_i), q / k / v
        (B,S,H,P) in the activation dtype, the gates (B,S,H) float32 (H
        this rank's heads on a mesh, every head under ``every_head``)."""
        b, s, _ = x.shape
        mode, mesh = cfg.nmc_mode, self.mesh
        xn = self.norm(x)
        if mesh is not None:
            xn = C.copy_to_model(xn, mesh)
        u = self.up(xn, nmc_mode=mode)
        g = self.up_gate(xn, nmc_mode=mode, act="silu")
        if mesh is not None:
            # the projections below contract over the whole d_i and give
            # partial gradients of it: summed before the gather narrows
            u = C.copy_to_model(C.gather_from_model(u, mesh), mesh)
        # by the head dim: the local head count follows from the widths
        heads = (b, s, -1, mlstm_head_dim(cfg))
        q, k, v = (C.gather_to_heads_if(lin(u, nmc_mode=mode), mesh,
                                        self.every_head).reshape(heads)
                   for lin in (self.wq, self.wk, self.wv))
        log_i = self.wi(u).float()
        log_f = self.wf(u)
        if mesh is not None and not self.every_head:
            # wf whole: this rank's heads' gates
            h = log_i.shape[-1]
            log_f = log_f.narrow(-1, mesh.index(C.MODEL_AXIS) * h, h)
        return g, q, k, v, log_i, F.logsigmoid(log_f.float())

    def _out(self, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
        """x + down(out_norm(y) * g), y (B,S,H,P); under ``every_head``
        this rank's columns of y (those of its slice of g)."""
        y = y.reshape(g.shape[:-1] + (-1,))
        if self.every_head:
            n = g.shape[-1]
            y = y.narrow(-1, self.mesh.index(C.MODEL_AXIS) * n, n)
        y = self.out_norm(y) if self.mesh is None \
            else L.rms_norm_over_model(y, self.out_norm, self.mesh)
        return x + self.down(y * g, nmc_mode=cfg.nmc_mode)

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
        """Full sequence.  x: (B, S, D).  With ``return_state`` also the
        memory ``(C, n, m)`` after the last position."""
        g, q, k, v, log_i, log_f = self._proj(x, cfg)
        chunk = min(cfg.ssm_chunk or 64, x.shape[1])
        y, state = mlstm_chunked(q, k, v, log_i, log_f, chunk)
        out = self._out(x, y, g, cfg)
        return (out, state) if return_state else out

    def state_specs(self, batch_part) -> tuple:
        """The state ``(C, n, m)`` as this rank computes it: over its
        heads (dim 1) on a mesh, every head under ``every_head``, the batch
        dim as ``batch_part``."""
        heads = C.MODEL_AXIS if self.mesh is not None and \
            not self.every_head else None
        return ((batch_part, heads, None, None), (batch_part, heads, None),
                (batch_part, heads))

    def decode_step(self, x: torch.Tensor, cfg: ModelConfig, state: tuple,
                    state_sh: tuple | None = None) -> torch.Tensor:
        """One token.  x: (B, 1, D); ``state`` is updated in place.
        ``state_sh``: on a mesh, the state's layout: each field is gathered
        to :meth:`state_specs`, stepped, and this rank's slice written
        back."""
        g, q, k, v, log_i, log_f = self._proj(x, cfg)
        work = self.gathered(state, state_sh)
        y = mlstm_step(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0], log_f[:, 0],
                       work)
        self.write_back(state, work, state_sh)
        return self._out(x, y, g, cfg)


def mlstm_state_shapes(cfg: ModelConfig, batch: int) -> tuple:
    """One mLSTM block's state fields ``(C, n, m)`` as
    ``sharding.CacheField`` s: (B,H,P,P), (B,H,P) zeros and (B,H) at
    ``M0``, float32."""
    h, p, f32 = cfg.n_heads, mlstm_head_dim(cfg), torch.float32
    return (sharding.CacheField((batch, h, p, p), f32),
            sharding.CacheField((batch, h, p), f32),
            sharding.CacheField((batch, h), f32, M0))


def mlstm_state_init(cfg: ModelConfig, batch: int, device=None) -> tuple:
    return tuple(f.full(device) for f in mlstm_state_shapes(cfg, batch))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

#: the gates, in the reference's order: cell input z, input, forget, output
GATES = ("z", "i", "f", "o")


class SLSTM(sharding.ServedState, nn.Module):
    """One sLSTM block: RMSNorm, the input projections ``w_z`` / ``w_i`` /
    ``w_f`` / ``w_o`` (d -> d), the block-diagonal recurrent weights
    ``r_z`` ... (H, P, P) float32, the scalar memory, a residual; then
    ``ffn_norm`` and the gated FFN ``up`` (d -> 2 d_f, d_f = d *
    proj_factor_slstm) and ``down`` (d_f -> d), tanh-form gelu on the first
    half times the second, a residual.  On a mesh ``mesh`` is set (module
    docstring)."""

    mesh: C.Mesh | None = None
    #: as :attr:`MLSTM.every_head`
    every_head: bool = False

    def __init__(self, norm: L.RMSNorm, w: dict, r: dict,
                 ffn_norm: L.RMSNorm, up: L.NmcLinear, down: L.NmcLinear):
        super().__init__()
        self.norm = norm
        for gate in GATES:
            setattr(self, f"w_{gate}", w[gate])
            self.register_parameter(f"r_{gate}", L.param(r[gate]))
        self.ffn_norm = ffn_norm
        self.up, self.down = up, down

    @classmethod
    def init(cls, gen: torch.Generator, cfg: ModelConfig,
             device=None) -> "SLSTM":
        """The reference's initialisation: normal / sqrt(d_in) linears,
        0.1-normal recurrent weights."""
        d, h = cfg.d_model, cfg.n_heads
        df = int(d * cfg.proj_factor_slstm)
        w = {g: L.NmcLinear.init(gen, d, d, device=device) for g in GATES}
        r = {g: torch.randn((h, d // h, d // h), generator=gen,
                            device=device, dtype=torch.float32) * 0.1
             for g in GATES}
        up = L.NmcLinear.init(gen, d, 2 * df, device=device)
        down = L.NmcLinear.init(gen, df, d, device=device)
        return cls(L.RMSNorm.init(d, cfg.norm_eps, device), w, r,
                   L.RMSNorm.init(d, cfg.norm_eps, device), up, down)

    def quantized(self) -> "SLSTM":
        """Unchanged, as :meth:`MLSTM.quantized`."""
        return self

    def _proj(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """The gates' input pre-activations (B, S, 4, D) float32, in
        :data:`GATES` order (D this rank's heads' channels on a mesh,
        every head's under ``every_head``)."""
        xn = self.norm(x)
        if self.mesh is not None:
            xn = C.copy_to_model(xn, self.mesh)
        pre = torch.stack([getattr(self, f"w_{g}")(xn).float()
                           for g in GATES], dim=2)
        # every head: the loop and all after it are the same on every rank
        return C.gather_from_model(pre, self.mesh) if self.every_head \
            else pre

    def recurrence(self, pre: torch.Tensor, state: tuple) -> tuple:
        """The time loop over pre (B, S, 4, D) from ``state`` ``(c, n, m,
        h)`` (B, D) float32: the hidden states (B, S, D) float32 and the
        state after the last position (new tensors: ``state`` is read, not
        written, so autograd can differentiate through it)."""
        c, n, m, hprev = state
        bsz, s, _, d = pre.shape
        heads, p = self.r_z.shape[:2]
        # (H, P, 4P): the four gates' recurrent weights side by side, in
        # float32 (bf16 serving weights promote to it, as in the reference)
        r = torch.cat([getattr(self, f"r_{g}") for g in GATES],
                      dim=-1).to(pre.dtype)
        hs = []
        for t in range(s):
            rec = torch.bmm(hprev.reshape(bsz, heads, p).transpose(0, 1), r)
            rec = rec.reshape(heads, bsz, 4, p).permute(1, 2, 0, 3) \
                .reshape(bsz, 4, d)
            g = pre[:, t] + rec
            z = torch.tanh(g[:, 0])
            i_raw = g[:, 1]
            log_f = F.logsigmoid(g[:, 2])
            o = torch.sigmoid(g[:, 3])
            m_new = torch.maximum(log_f + m, i_raw)
            decay = torch.exp(log_f + m - m_new)
            gain = torch.exp(i_raw - m_new)
            c = c * decay + gain * z
            n = n * decay + gain
            m = m_new
            hprev = o * c / torch.clamp_min(n, 1e-6)
            hs.append(hprev)
        return torch.stack(hs, dim=1), (c, n, m, hprev)

    def _ffn(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """x + down(gelu(u[:d_f]) * u[d_f:]), u = up(ffn_norm(x)).  A
        column-parallel ``up`` splits u contiguously, not by halves, so u
        is gathered and the product formed whole; a row-parallel ``down``
        then reads this rank's rows of it, and the gradient of the gathered
        u is partial over ``model``."""
        mode, mesh = cfg.nmc_mode, self.up.mesh
        h = self.ffn_norm(x)
        if self.up.parallel is None:
            u = self.up(h, nmc_mode=mode)
        else:
            u = C.gather_from_model(
                self.up(C.copy_to_model(h, mesh), nmc_mode=mode), mesh)
            if self.down.parallel == "row":
                u = C.copy_to_model(u, mesh)
        df = u.shape[-1] // 2
        h = F.gelu(u[..., :df], approximate="tanh") * u[..., df:]
        if self.down.parallel == "row":
            n = self.down.w.shape[0]
            h = h.narrow(-1, self.down.mesh.index(C.MODEL_AXIS) * n, n)
        return x + self.down(h, nmc_mode=mode)

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False, state: tuple | None = None):
        """x: (B, S, D) from ``state`` (a zero state when None).  With
        ``return_state`` also the state after the last position."""
        if state is None:
            heads, p = self.r_z.shape[:2]
            state = slstm_state_init(cfg, x.shape[0], x.device, heads * p)
        hs, last = self.recurrence(self._proj(x, cfg), state)
        if self.mesh is not None and not self.every_head:
            # what follows reads the whole hidden state on every rank, so
            # its gradient is whole there: a plain gather
            hs = C.gather_from_model(hs, self.mesh)
        out = self._ffn(x + hs.to(x.dtype), cfg)
        return (out, last) if return_state else out

    def state_specs(self, batch_part) -> tuple:
        """The state ``(c, n, m, h)`` as this rank computes it: its
        heads' channels (dim 1) on a mesh, every channel under
        ``every_head``, the batch dim as ``batch_part``."""
        heads = C.MODEL_AXIS if self.mesh is not None and \
            not self.every_head else None
        return ((batch_part, heads),) * 4

    def decode_step(self, x: torch.Tensor, cfg: ModelConfig, state: tuple,
                    state_sh: tuple | None = None) -> torch.Tensor:
        """One token.  x: (B, 1, D); ``state`` is updated in place.
        ``state_sh``: as in :meth:`MLSTM.decode_step`."""
        out, last = self(x, cfg, return_state=True,
                         state=self.gathered(state, state_sh))
        self.write_back(state, last, state_sh)
        return out


def slstm_state_shapes(cfg: ModelConfig, batch: int,
                       width: int | None = None) -> tuple:
    """One sLSTM block's state fields ``(c, n, m, h)`` as
    ``sharding.CacheField`` s: (B, width) float32 each, ``m`` at ``M0``,
    the others zeros; the whole ``d_model`` unless ``width`` (a rank's
    heads) is given."""
    shape, f32 = (batch, width or cfg.d_model), torch.float32
    return tuple(sharding.CacheField(shape, f32, fill)
                 for fill in (0.0, 0.0, M0, 0.0))


def slstm_state_init(cfg: ModelConfig, batch: int, device=None,
                     width: int | None = None) -> tuple:
    """The initial state of :func:`slstm_state_shapes`."""
    return tuple(f.full(device)
                 for f in slstm_state_shapes(cfg, batch, width))
