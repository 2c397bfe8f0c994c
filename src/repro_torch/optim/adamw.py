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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

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


def init_state(params: dict) -> dict:
    """Zero float32 moments beside every parameter, step 0 (on the
    parameters' device)."""
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    device = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict) -> torch.Tensor:
    """The L2 norm over every tensor of the dict, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple:
    """(grads scaled to a global norm of at most ``max_norm``, in float32;
    the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / (norm + 1e-6), 1.0)
    return {n: g.float() * scale for n, g in grads.items()}, norm


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict,
                  cfg: AdamWConfig) -> tuple:
    """One AdamW step: clip ``grads``, advance ``state["step"]``, update
    ``m``, ``v`` and ``params`` in place.  Returns (params, state,
    metrics ``{"grad_norm", "lr"}``), the first two the objects passed
    in."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = cosine_schedule(cfg)(step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1, bc2 = 1 - b1 ** stepf, 1 - b2 ** stepf
    for name, p in params.items():
        g, m, v = grads[name], state["m"][name], state["v"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dtype in FLOAT_DTYPES:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
