"""Pipeline parallelism: GPipe-style microbatched stages over a mesh axis.

The counterpart of the JAX package's ``distributed/pipeline.py``: each
rank along ``axis`` holds one stage (a contiguous block of layers), and
microbatches stream through a ring of point-to-point sends (activations
move, weights stay put).  Schedule: GPipe, ``n_microbatches + n_stages -
1`` ticks; at tick t stage 0 injects microbatch t, stage s runs microbatch
t - s on what stage s - 1 sent it, and the last stage emits; bubble
fraction ``(S - 1) / (M + S - 1)``.  The reference computes every stage at
every tick and discards the bubble's results; the port skips those calls
(their outputs are never emitted).  The outputs, zero except on the last
stage, are summed over ``axis`` as the reference's ``psum`` does, so every
rank returns them.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import context


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh: context.Mesh, axis: str,
                   n_microbatches: int) -> torch.Tensor:
    """``y = stage_{S-1}(...stage_0(x))`` as a GPipe pipeline.

    stage_fn(params, h) -> h (one stage's computation, h's shape and
    dtype kept); ``stage_params``: this rank's stage's parameters; x:
    (batch, ...) the global input, the same on every rank, split into
    ``n_microbatches`` on axis 0.  Returns y with x's shape on every
    rank."""
    n_stages, stage = mesh.shape[axis], mesh.coords[axis]
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} is not a multiple of "
                         f"{n_microbatches} microbatches")
    xm = x.reshape((n_microbatches, b // n_microbatches) + x.shape[1:])
    buf = torch.zeros_like(xm[0])
    outs = torch.zeros_like(xm)
    for t in range(n_microbatches + n_stages - 1):
        mb = t - stage
        h_out = buf
        if 0 <= mb < n_microbatches:
            h_out = stage_fn(stage_params, xm[mb] if stage == 0 else buf)
            if stage == n_stages - 1:
                outs[mb] = h_out
        buf = context.send_recv(h_out, axis, mesh)
    outs = context.all_reduce(outs, axis, mesh)
    return outs.reshape(x.shape)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble overhead, for schedule planning and telemetry."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
