"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule.

The counterpart of the JAX package's ``optim/adamw.py``, over a name ->
tensor dict (a model's ``dict(named_parameters())``): the state is
``{"m", "v"}``, float32 moments whatever the parameter's dtype, and the
step as an int32 tensor.  The arithmetic is the reference's, in its order:
the schedule in float32, the clip's ``+ 1e-6``, ``mhat / (sqrt(vhat) +
eps)`` and weight decay on every float leaf (norm gains, biases and
embeddings included).  Where the reference donates its buffers,
:func:`apply_updates` writes the parameters and the moments in place.

Given a model's :class:`~repro_torch.distributed.sharding.Layout` (on a
mesh), the gradients are this rank's slices, equal on every data rank:
the global norm sums the squares of the FULL parameters (a model-sharded
gradient's local sum all-reduced over ``model``, a replicated one counted
once), and the update is ZeRO-2: ``m`` and ``v`` hold this data rank's
slice along the moment's data dim (``Layout.moments``), the rank updates
that slice of the parameter and all-gathers it over the data axes.  AdamW
is elementwise, so the update is the unsharded one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.distributed import context as C
from repro_torch.distributed import sharding

FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig) -> Callable:
    """step (a tensor) -> the learning rate, a float32 tensor: linear
    warm-up over ``warmup_steps``, then a cosine down to ``min_lr_ratio``
    of ``lr`` at ``total_steps``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
        prog = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return cfg.lr * warm * (cfg.min_lr_ratio
                                + (1 - cfg.min_lr_ratio) * cos)
    return lr


def _moment_view(t: torch.Tensor, name: str, layout) -> torch.Tensor:
    """``t`` (a parameter's local slice, or its gradient) cut to this data
    rank's slice of the moment under ``layout`` (``t`` itself when the
    moment is not sharded over data)."""
    if layout is None:
        return t
    sh = layout.moments[name]
    dim = sharding.data_dim(sh)
    if dim is None:
        return t
    axes = sh.mesh.data_axes()
    n = t.shape[dim] // sh.mesh.size(axes)
    return t.narrow(dim, sh.mesh.index(axes) * n, n)


def init_state(params: dict, layout=None) -> dict:
    """Zero float32 moments beside every parameter (this data rank's slice
    of each under a ``layout``), step 0 (on the parameters' device)."""
    def zeros():
        return {n: torch.zeros(_moment_view(p, n, layout).shape,
                               dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    device = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict, layout=None) -> torch.Tensor:
    """The L2 norm over every tensor of the dict, in float32; under a
    ``layout``, of the full tensors whose local slices the dict holds."""
    if layout is None or layout.mesh.model_size() == 1:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in tree.values()))
    zero = torch.zeros((), device=next(iter(tree.values())).device)
    split, whole = zero, zero
    for n, g in tree.items():
        sq = torch.sum(torch.square(g.float()))
        if sharding.is_model_sharded(layout.params[n]):
            split = split + sq
        else:
            whole = whole + sq
    return torch.sqrt(C.all_reduce(split, C.MODEL_AXIS, layout.mesh) + whole)


def clip_by_global_norm(grads: dict, max_norm: float,
                        layout=None) -> tuple:
    """(grads scaled to a global norm of at most ``max_norm``, in float32;
    the norm before clipping)."""
    norm = global_norm(grads, layout)
    scale = torch.clamp_max(max_norm / (norm + 1e-6), 1.0)
    return {n: g.float() * scale for n, g in grads.items()}, norm


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict,
                  cfg: AdamWConfig, layout=None) -> tuple:
    """One AdamW step: clip ``grads``, advance ``state["step"]``, update
    ``m``, ``v`` and ``params`` in place (ZeRO-2 under a ``layout``:
    module docstring).  Returns (params, state, metrics ``{"grad_norm",
    "lr"}``), the first two the objects passed in."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, layout)
    step = state["step"] + 1
    lr = cosine_schedule(cfg)(step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1, bc2 = 1 - b1 ** stepf, 1 - b2 ** stepf
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = _moment_view(grads[name], name, layout)
        pv = _moment_view(p, name, layout)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dtype in FLOAT_DTYPES:
            delta = delta + cfg.weight_decay * pv.float()
        new = (pv.float() - lr * delta).to(p.dtype)
        if pv is not p:
            sh = layout.moments[name]
            new = C.all_gather(new, sh.mesh.data_axes(), sh.mesh,
                               sharding.data_dim(sh))
        p.copy_(new)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
