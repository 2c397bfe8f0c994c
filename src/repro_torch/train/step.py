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

A model laid out on a mesh (``model.layout``, :func:`lm.shard`) takes the
mesh-aware step: each data rank keeps its rows of every microbatch of the
global batch (:func:`local_rows`), the gradients of the parameters whose
local gradient is partial over ``model`` (``Layout.partial``) are summed
over it, every gradient is averaged over the data axes, then come
compression, clipping and the ZeRO-2 AdamW update, in the reference's
order (mean, compress, clip, update).  Loss and metrics over the data
ranks: :func:`data_metrics`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import compress as gc
from repro_torch.distributed import context as C
from repro_torch.distributed import sharding
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
                      n_microbatches: int = 1, means: dict | None = None
                      ) -> tuple:
    """(loss, metrics, {name: float32 gradient}) of the batch: with
    microbatches the gradients summed in float32 and divided by their
    count, the loss likewise, the other metrics the last microbatch's
    (``means``, when given, receives each metric's mean over the
    microbatches)."""
    if n_microbatches == 1:
        loss, metrics, g = grads_of(loss_fn, model, batch)
        if means is not None:
            means.update(metrics)
        return loss, metrics, g
    g, total, sums = None, torch.zeros((), device=model.device), {}
    for mb in split_batch(batch, n_microbatches):
        loss, metrics, gm = grads_of(loss_fn, model, mb)
        if g is None:
            g = {n: x.float() for n, x in gm.items()}
        else:
            for n in g:
                g[n] += gm[n]
        total = total + loss
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + v
    g = {n: x / n_microbatches for n, x in g.items()}
    if means is not None:
        means.update({k: v / n_microbatches for k, v in sums.items()})
    return total / n_microbatches, metrics, g


def local_rows(batch: dict, mesh: C.Mesh, n_microbatches: int = 1) -> dict:
    """This data rank's rows of the global batch: its contiguous share of
    each of the ``n_microbatches`` microbatches (so that the data ranks'
    rows of microbatch i, in rank order, are the global microbatch i).  A
    ``"mask"`` is cut like the tokens; ``lm.loss_fn`` takes its kept count
    over the data ranks."""
    axes = mesh.data_axes()
    n, i = mesh.size(axes), mesh.index(axes)
    if n == 1:
        return batch
    out = {}
    for k, x in batch.items():
        if x.shape[0] % (n * n_microbatches):
            raise ValueError(f"batch[{k!r}] has {x.shape[0]} rows, not a "
                             f"multiple of {n_microbatches} microbatches x "
                             f"{n} data ranks")
        parts = x.reshape((n_microbatches, n, -1) + tuple(x.shape[1:]))
        out[k] = parts[:, i].reshape((-1,) + tuple(x.shape[1:]))
    return out


def reduce_grads(grads: dict, layout: sharding.Layout, split: bool) -> dict:
    """Sum the partial gradients over ``model`` (``split``: those of a
    forward that split its stream on the sequence,
    ``Layout.partial_for``), then average all of them over the data axes
    (float32)."""
    mesh, names = layout.mesh, list(grads)
    partial = layout.partial_for(split)
    part = [n for n in names if n in partial]
    if part:
        for n, g in zip(part, C.all_reduce_many([grads[n] for n in part],
                                                C.MODEL_AXIS, mesh)):
            grads[n] = g
    axes = mesh.data_axes()
    if mesh.size(axes) == 1:
        return grads
    return dict(zip(names, C.all_reduce_many(
        [grads[n] for n in names], axes, mesh, 1.0 / mesh.size(axes))))


def data_metrics(loss, metrics: dict, means: dict,
                 mesh: C.Mesh) -> dict:
    """The step's ``loss`` / ``nll`` / ``aux`` over the data ranks, as the
    reference reports them: ``nll`` (the last microbatch's) averaged (a
    masked ``nll`` is each rank's share of the global masked mean,
    ``lm.loss_fn``, so its average is that mean); a
    MoE layer's ``aux``, computed per data shard under expert
    parallelism, as data shard 0 holds it (the reference's ``shard_map``
    returns each shard's own ``aux`` as the "replicated" value and the
    metric reads shard 0's); ``loss`` the mean of the ranks' nll means plus
    shard 0's aux term.  The gradients are the mean of each rank's own."""
    axes = mesh.data_axes()
    n = mesh.size(axes)
    if n == 1:
        return dict(metrics, loss=loss)
    avg = C.all_reduce(torch.stack([metrics["nll"].float(),
                                    means["nll"].float()]),
                       axes, mesh) / n
    first = C.broadcast(torch.stack([metrics["aux"].float(),
                                     (loss - means["nll"]).float()]),
                        axes, mesh)
    return {"nll": avg[0], "aux": first[0], "loss": avg[1] + first[1]}


def _amax_over_model(layout: sharding.Layout):
    def amax_over(names, amax):
        if any(sharding.is_model_sharded(layout.params[n]) for n in names):
            return C.all_reduce(amax, C.MODEL_AXIS, layout.mesh,
                                dist.ReduceOp.MAX)
        return amax
    return amax_over


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    n_microbatches: int = 1, compress_grads: bool = False,
                    local_batch: bool = False):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``; ``model`` and ``opt_state`` are updated in place.
    Microbatching: the batch is split on axis 0
    (:func:`accumulated_grads`).  With ``compress_grads`` the
    gradients go through int8 compression with error feedback, the error
    kept in ``opt_state["grad_err"]``.  On a mesh the batch is the global
    one, of which the step keeps this data rank's rows, or with
    ``local_batch`` those rows already (:func:`local_rows`; the dry run
    hands each rank its shard, as the reference's sharded input).
    Metrics: ``loss``, ``nll``, ``aux``, ``grad_norm`` and ``lr`` (tensors
    on the model's device)."""
    loss_fn = make_loss(cfg)

    def train_step(model: lm.LMBase, opt_state: dict, batch: dict) -> tuple:
        layout = model.layout
        if layout is not None and not local_batch:
            batch = local_rows(batch, layout.mesh, n_microbatches)
        means: dict = {}
        loss, metrics, g = accumulated_grads(loss_fn, model, batch,
                                             n_microbatches, means)
        metrics = dict(metrics, loss=loss)
        amax_over = None
        if layout is not None:
            g = reduce_grads(g, layout, model.splits_rows(batch, cfg))
            metrics = data_metrics(loss, metrics, means, layout.mesh)
            amax_over = _amax_over_model(layout)
        if compress_grads:
            cg, new_err = gc.compress_tree(g, opt_state["grad_err"],
                                           amax_over)
            g = gc.decompress_tree(cg)
            opt_state["grad_err"] = new_err
        params = dict(model.named_parameters())
        _, _, opt_metrics = adamw.apply_updates(params, g, opt_state,
                                                opt_cfg, layout)
        return model, opt_state, dict(metrics, **opt_metrics)

    return train_step


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     compress_grads: bool = False, device=None,
                     mesh: C.Mesh | None = None) -> tuple:
    """(model with random weights drawn from ``generator`` on ``device``,
    the card when None, laid out on ``mesh`` when given (every rank draws
    the same full weights, then keeps its slices); its fresh optimizer
    state)."""
    model = lm.init_params(cfg, generator, device)
    if mesh is not None:
        lm.shard(model, cfg, mesh)
    params = dict(model.named_parameters())
    opt_state = adamw.init_state(params, model.layout)
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
