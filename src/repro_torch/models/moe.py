"""Mixture-of-Experts: top-k routing, capacity-bounded dispatch, SwiGLU
expert banks (float, or int8 per (expert, out-channel)) and shared experts,
with expert parallelism over the ``model`` axis of a mesh.

The counterpart of the JAX package's ``models/moe.py``.  Each token picks
its ``top_k`` experts by a float32 softmax router, renormalised over the
picks.  The ``t * k`` assignments are dispatched token-major: an
assignment's slot is the running count of its expert, and those at or past
the capacity ``max(int(t * k * capacity_factor / E), 1)`` are dropped
(they contribute nothing; the shared experts still apply).  Kept tokens
fill an ``(E, cap, d)`` buffer in the activation dtype, run through every
expert's SwiGLU, and are scatter-added back weighted by their routing
probability.

On a mesh (:func:`~repro_torch.models.lm.shard`), as the reference's
``shard_map`` branch: with a ``model`` axis the tokens enter replicated
over it (``copy_to_model``), each rank owns ``E / model`` experts (the
first at ``expert_offset``) and dispatches only the assignments to them,
the partial outputs are summed over ``model`` and ``aux`` averaged over
it.  The routing, the capacity, the drops and ``aux`` come from the tokens
the rank holds: those of its data shard.  Under sequence parallelism the
tokens enter by a gather of the sequence instead (the same rows) and the
partial outputs leave by a reduce-scatter onto this rank's rows.  With
data axes and no ``model`` axis the reference takes no ``shard_map`` and
routes the global batch (GSPMD), so the port gathers the tokens over the
data axes, routes them all and keeps its rows.

The router, the expert products and the dequantize of int8 banks are plain
PyTorch, as they are XLA (not Pallas) in the reference; the shared experts
are :class:`~repro_torch.models.layers.MLP` projections (tensor-parallel
on a mesh) and follow ``nmc_mode`` (``nmc_matmul`` in ``w8a8``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import context as C
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

BANKS = ("wi", "wg", "wo")
QUANT_BANKS = tuple(f"{k}_{t}" for k in BANKS for t in ("q", "s"))


@dataclasses.dataclass
class Routing:
    """One call's routing: ``probs`` (t, E) f32, ``top_p`` / ``top_e`` (t,
    k), and per assignment (token-major, ``t * k``) its ``slot`` in its
    expert's buffer and whether it is kept (``slot < cap``)."""
    probs: torch.Tensor
    top_p: torch.Tensor
    top_e: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    cap: int


def route(x: torch.Tensor, wr: torch.Tensor, cfg: ModelConfig) -> Routing:
    """x: (t, d) tokens; wr: (d, E) router weight."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = max(int(t * k * cfg.capacity_factor / e), 1)
    probs = torch.softmax(x.float() @ wr.float(), dim=-1)
    # sorted top-k: ties go to the lower expert index, as jax.lax.top_k
    top_p, top_e = torch.topk(probs, k, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(top_e.reshape(-1), e)                  # (t*k, E)
    slot = ((onehot.cumsum(dim=0) - 1) * onehot).sum(dim=-1)
    return Routing(probs, top_p, top_e, slot, slot < cap, cap)


def aux_loss(r: Routing, n_experts: int) -> torch.Tensor:
    """Switch-style load balancing: ``E * sum(f_e * P_e)``, f_e the share
    of tokens whose first pick is e, P_e the mean router probability."""
    frac = F.one_hot(r.top_e[:, 0], n_experts).float().mean(dim=0)
    return n_experts * torch.sum(frac * r.probs.mean(dim=0))


def expert_ffn(buf: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
               wo: torch.Tensor) -> torch.Tensor:
    """buf: (E, cap, d) -> (E, cap, d); SwiGLU per expert in buf's dtype."""
    dt = buf.dtype
    h = torch.bmm(buf, wi.to(dt))
    g = ref.apply_act(torch.bmm(buf, wg.to(dt)), "silu")
    return torch.bmm(h * g, wo.to(dt))


def moe_local(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
              wg: torch.Tensor, wo: torch.Tensor, cfg: ModelConfig,
              e0: int = 0) -> tuple:
    """Dispatch, expert FFN and combine over the ``t`` tokens of x (t, d)
    for the experts ``e0`` to ``e0 + len(wi)`` (every expert unless
    sharded).  Returns (y (t, d): the local experts' part, aux)."""
    t, d = x.shape
    dtype, k, e_loc = x.dtype, cfg.top_k, wi.shape[0]
    r = route(x, wr, cfg)
    flat_e = r.top_e.reshape(-1)
    flat_p = r.top_p.reshape(-1).to(dtype)
    tok_ix = torch.arange(t, device=x.device).repeat_interleave(k)
    slot_c = torch.clamp(r.slot, 0, r.cap - 1)
    keep = r.keep
    le = flat_e
    if e_loc != cfg.n_experts:
        keep = keep & (flat_e >= e0) & (flat_e < e0 + e_loc)
        le = torch.clamp(flat_e - e0, 0, e_loc - 1)
    buf = torch.zeros((e_loc, r.cap, d), dtype=dtype, device=x.device)
    # a dropped assignment adds 0 * x to a clamped slot, as the reference
    buf.index_put_((le, slot_c), keep.to(dtype)[:, None] * x[tok_ix],
                   accumulate=True)
    out = expert_ffn(buf, wi, wg, wo)
    contrib = out[le, slot_c] * torch.where(keep, flat_p, 0.0)[:, None]
    # each token's k contributions added in pick order, one rounding per
    # add as the reference's scatter-add (an atomic index_add_ on the card
    # would add them in any order, and a bf16 sum would then vary by run)
    contrib = contrib.reshape(t, k, d)
    y = torch.zeros((t, d), dtype=dtype, device=x.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y, aux_loss(r, cfg.n_experts)


class MoE(nn.Module):
    """Router (an :class:`~repro_torch.models.layers.NmcLinear` read in
    float32, never quantized by ``quantize_tree``), the expert banks
    ``wi`` / ``wg`` (E, d, f) and ``wo`` (E, f, d) in float or as
    ``wi_q`` / ``wi_s`` ... (int8 with an (E, d_out) scale), and the
    optional shared gated MLP.  On a mesh ``mesh`` is set and the banks
    hold the experts from ``expert_offset`` on (module docstring)."""

    mesh: C.Mesh | None = None
    expert_offset: int = 0

    def __init__(self, router: L.NmcLinear, banks: dict,
                 shared: L.MLP | None = None):
        super().__init__()
        keys = QUANT_BANKS if "wi_q" in banks else BANKS
        if set(banks) != set(keys):
            raise ValueError(f"expert banks {sorted(banks)}: expected "
                             f"{BANKS} or {QUANT_BANKS}")
        self.router = router
        for key in keys:      # float banks train; int8 ones and scales not
            if keys == BANKS:
                self.register_parameter(key, L.param(banks[key]))
            else:
                self.register_buffer(key, banks[key])
        self.bank_keys = keys
        self.shared = shared

    @classmethod
    def init(cls, gen: torch.Generator, cfg: ModelConfig,
             device=None) -> "MoE":
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        router = L.NmcLinear.init(gen, d, e, device=device)

        def normal(shape, scale):
            return torch.randn(shape, generator=gen, device=device,
                               dtype=torch.float32) * scale
        banks = {"wi": normal((e, d, f), 1.0 / math.sqrt(d)),
                 "wg": normal((e, d, f), 1.0 / math.sqrt(d)),
                 "wo": normal((e, f, d), 1.0 / math.sqrt(f))}
        shared = L.MLP.init(gen, d, f * cfg.n_shared_experts, "silu",
                            device) if cfg.n_shared_experts else None
        return cls(router, banks, shared)

    @property
    def quantized_banks(self) -> bool:
        return self.bank_keys == QUANT_BANKS

    @torch.no_grad()
    def quantized(self) -> "MoE":
        """The NMC serving form: int8 expert banks, the shared experts'
        linears quantized, the router left in float (its logit margins
        decide routing).  A MoE laid out on a mesh refuses: the full model
        is quantized first and then laid out (``lm.shard`` slices the
        int8 banks and their scales, which do not depend on the split:
        one per (expert, output channel))."""
        if self.mesh is not None:
            raise NotImplementedError("quantize the full model, then "
                                      "lm.shard it")
        if self.quantized_banks:
            banks = {k: getattr(self, k) for k in QUANT_BANKS}
        else:
            banks = {}
            for key in BANKS:
                banks[f"{key}_q"], banks[f"{key}_s"] = \
                    L.quantize_expert_bank(getattr(self, key))
        shared = None if self.shared is None else L.quantize_tree(self.shared)
        return MoE(self.router, banks, shared)

    def router_weight(self, dtype) -> torch.Tensor:
        r = self.router
        if r.w is not None:
            return r.w
        return r.w_q.to(dtype) * r.scale.to(dtype)[None, :]

    def expert_weights(self, dtype) -> tuple:
        """(wi, wg, wo); int8 banks dequantized in ``dtype`` (the product
        formed in ``dtype``, as the reference rounds it)."""
        if not self.quantized_banks:
            return self.wi, self.wg, self.wo
        return tuple(getattr(self, f"{k}_q").to(dtype)
                     * getattr(self, f"{k}_s").to(dtype)[..., None, :]
                     for k in BANKS)

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                sp: bool = False) -> tuple:
        """x: (B, S, D) -> (y, aux float32): the routed experts over all
        B * S tokens at once (on a mesh: module docstring), plus the
        shared experts.  ``sp``: x and y are this rank's rows of a
        sequence-split stream; the experts route the gathered sequence,
        the rows they would see without it."""
        mesh = self.mesh
        tp = mesh is not None and mesh.model_size() > 1
        h = x
        if tp:
            h = C.enter_region(x, mesh, sp)
        b, s, d = h.shape
        x2 = h.reshape(-1, d)
        gather = mesh is not None and mesh.model_size() == 1 and \
            mesh.size(mesh.data_axes()) > 1
        if gather:
            x2 = C.gather_from_data(x2, mesh)
        y2, aux = moe_local(x2, self.router_weight(x.dtype),
                            *self.expert_weights(x.dtype), cfg,
                            self.expert_offset)
        if gather:
            y2 = y2.narrow(0, mesh.index(mesh.data_axes()) * b * s, b * s)
        y = y2.reshape(b, s, d)
        if tp:
            y = C.leave_region(y, mesh, sp)
            aux = C.mean_over_model(aux, mesh)
        if self.shared is not None:
            y = y + self.shared(x, nmc_mode=cfg.nmc_mode, sp=sp)
        return y, aux.float()
