"""Train / eval step builders: loss -> gradients -> AdamW, with microbatched
gradient accumulation and optional int8 gradient compression.

The counterpart of the JAX package's ``train/step.py``.  The params are the
model itself (an :class:`~repro_torch.models.lm.LMBase` whose float
weights are ``nn.Parameter`` s) and the optimizer state a dict of name ->
tensor dicts keyed as ``named_parameters()``.  Where the reference donates
its buffers to a jitted step, the port's step updates the parameters and
the optimizer state in place under ``torch.no_grad()`` and returns the
same objects.  On the card every layer's attention is the
``flash_attention`` kernel inside its autograd Function
(:mod:`repro_torch.kernels.ops`).
"""

from __future__ import annotations

import torch

from repro_torch.distributed import compress as gc
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


def make_loss(cfg: ModelConfig):
    def loss(model: lm.LMBase, batch: dict) -> tuple:
        return lm.loss_fn(model, batch, cfg)
    return loss


def grads_of(loss_fn, model: lm.LMBase, batch: dict) -> tuple:
    """(loss, metrics, {name: gradient}) of one batch, detached; a
    parameter the loss does not reach gets a zero gradient, as the
    reference's autodiff gives it."""
    params = dict(model.named_parameters())
    with torch.enable_grad():
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    g = {n: torch.zeros_like(p) if d is None else d
         for (n, p), d in zip(params.items(), grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}, g)


def split_batch(batch: dict, n: int) -> list:
    """The batch as ``n`` microbatches, split on axis 0 (rows ``i * B / n``
    to ``(i + 1) * B / n`` in the i-th, as the reference's reshape)."""
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {x.shape[0]} rows, not a "
                             f"multiple of {n} microbatches")
    return [{k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]
             for k, x in batch.items()} for i in range(n)]


def accumulated_grads(loss_fn, model: lm.LMBase, batch: dict,
                      n_microbatches: int = 1) -> tuple:
    """(loss, metrics, {name: float32 gradient}) of the batch: with
    microbatches the gradients summed in float32 and divided by their
    count, the loss likewise, the other metrics the last microbatch's."""
    if n_microbatches == 1:
        return grads_of(loss_fn, model, batch)
    g, total = None, torch.zeros((), device=model.device)
    for mb in split_batch(batch, n_microbatches):
        loss, metrics, gm = grads_of(loss_fn, model, mb)
        if g is None:
            g = {n: x.float() for n, x in gm.items()}
        else:
            for n in g:
                g[n] += gm[n]
        total = total + loss
    g = {n: x / n_microbatches for n, x in g.items()}
    return total / n_microbatches, metrics, g


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    n_microbatches: int = 1, compress_grads: bool = False):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``; ``model`` and ``opt_state`` are updated in place.
    Microbatching: the batch is split on axis 0
    (:func:`accumulated_grads`).  With ``compress_grads`` the
    gradients go through int8 compression with error feedback, the error
    kept in ``opt_state["grad_err"]``.  Metrics: ``loss``, ``nll``,
    ``aux``, ``grad_norm`` and ``lr`` (tensors on the model's device)."""
    loss_fn = make_loss(cfg)

    def train_step(model: lm.LMBase, opt_state: dict, batch: dict) -> tuple:
        loss, metrics, g = accumulated_grads(loss_fn, model, batch,
                                             n_microbatches)
        if compress_grads:
            cg, new_err = gc.compress_tree(g, opt_state["grad_err"])
            g = gc.decompress_tree(cg)
            opt_state["grad_err"] = new_err
        params = dict(model.named_parameters())
        _, _, opt_metrics = adamw.apply_updates(params, g, opt_state,
                                                opt_cfg)
        return model, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     compress_grads: bool = False, device=None) -> tuple:
    """(model with random weights drawn from ``generator`` on ``device``,
    the card when None; its fresh optimizer state)."""
    model = lm.init_params(cfg, generator, device)
    params = dict(model.named_parameters())
    opt_state = adamw.init_state(params)
    if compress_grads:
        opt_state["grad_err"] = gc.init_error_state(params)
    return model, opt_state


def make_eval_step(cfg: ModelConfig):
    loss_fn = make_loss(cfg)

    @torch.no_grad()
    def eval_step(model: lm.LMBase, batch: dict) -> dict:
        loss, metrics = loss_fn(model, batch)
        return dict(metrics, loss=loss)
    return eval_step
